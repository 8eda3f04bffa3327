"""Wildcard and mixed-case searches through the port's device route
(``SearchEngine(cfg, device="cpu")``: the kernels' plain versions) against
the JAX package's engine on the same file: offsets, values maps and
previews, and the backend-independent ``SearchStats`` counts.

Keywords: Capitalised ("Princess"), lowercase with a wildcard
("pr*ncess"), Capitalised with one ("Pr*ncess", and "P*incess", whose
case folding leaves two leading wildcards), and ties of the two cases
("PRINcess", "PrInCeSs"), planted with their lowercase and uppercase
letters under independent bases, some wrapping past 255, beside decoys
that break the difference across the wildcard.

Previews at the file's two ends, read from the resident corpus or the
file.  Also the counters a traced run keeps of what the mode adds: per fused
step ``step.prefilter_windows`` / ``step.exact_windows`` (sums of the
steps' ``FusedInfo``), per run ``pattern.wildcards`` /
``pattern.prefilter_checks`` / ``pattern.bridged_checks``; an untraced
run keeps none.

Tolerance: exact equality throughout — every value is an integer or a
string.
"""

import numpy as np
import pytest
import torch

from monkey_moore_tpu.config import SearchConfig
from monkey_moore_tpu.engine import SearchEngine as JaxEngine
from monkey_moore_tpu_torch import carry_over, corpus as tcorpus
from monkey_moore_tpu_torch import engine as port_engine
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.ops.host import prefilter_check_indices
from monkey_moore_tpu_torch.pattern import compile_pattern
from wildcard_plants import COPIES, KEYWORDS, N_BYTES, encode, planted_file

STATS = ("hot_tiles", "candidates", "fused_steps", "fused_fallbacks",
         "device_dispatches", "bytes_scanned", "chunks", "d2h_bytes",
         "h2d_bytes")
def _jax_config(path, keyword):
    return SearchConfig(file_path=path, keyword=keyword, wildcard="*",
                        device_chunk_bytes=16_384,
                        preferred_search_block_size=65_536,
                        host_latency_threshold_bytes=0)


def _tuples(results):
    return [(r.offset, r.values_map, r.preview) for r in results]


@pytest.mark.parametrize("keyword", KEYWORDS)
def test_port_equals_jax_engine(tmp_path, keyword):
    path, real = planted_file(tmp_path, keyword)
    cfg = _jax_config(path, keyword)
    jax_engine = JaxEngine(cfg)
    want = jax_engine.run(generate_previews=True)
    port = SearchEngine(carry_over(cfg), device="cpu")
    got = port.run(generate_previews=True)
    assert _tuples(got) == _tuples(want)
    for name in STATS:
        assert getattr(port.last_stats, name) == getattr(
            jax_engine.last_stats, name), name
    assert not port.last_stats.host_routed
    assert port.last_stats.fused_steps > 1
    offsets = [r.offset for r in got]
    assert set(real) <= set(offsets)
    assert (150_000 in offsets) is (150_000 in real)
    # a mostly-lowercase keyword that mixes cases recovers both bases; a
    # tie's minority case is uppercase but its shift is taken from the
    # first lowercase letter, as is a one-case keyword's
    both = keyword in ("Princess", "Pr*ncess", "P*incess")
    by_offset = {r.offset: r.values_map for r in got}
    for off, (lower, upper, raise_by) in zip(real, COPIES):
        if "*" in keyword:  # every literal of "P*incess" lies past it
            lower = (lower + raise_by) % 256
        assert by_offset[off] == {65: upper if both else (lower - 32) % 256,
                                  97: lower}


def test_case_folding_and_advance_of_the_keywords():
    folded = {kw: "".join(map(chr, compile_pattern(kw, "*").case_normalized))
              for kw in KEYWORDS}
    assert folded == {"Princess": "*rincess", "pr*ncess": "pr*ncess",
                      "Pr*ncess": "*r*ncess", "P*incess": "**incess",
                      "PRINcess": "****cess", "PrInCeSs": "*r*n*e*s"}
    assert compile_pattern("P*incess", "*").advance == 5


def _counts(tmp_path, keyword, monkeypatch, traced):
    path, _ = planted_file(tmp_path, keyword)
    infos = []
    real = port_engine.fused_count_extract_finish

    def finish(pending):
        offs, vals, info = real(pending)
        infos.append(info)
        return offs, vals, info

    monkeypatch.setattr(port_engine, "fused_count_extract_finish", finish)
    engine = SearchEngine(carry_over(_jax_config(path, keyword)),
                          device="cpu")
    if traced:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            engine.run()
    else:
        engine.run()
    return engine.last_stats.record.counters, infos


#: (wildcards, prefilter checks, bridged among them) after case folding
PATTERN_COUNTS = {"Princess": (1, 4, 0), "pr*ncess": (1, 4, 1),
                  "Pr*ncess": (2, 4, 1), "P*incess": (2, 4, 0),
                  "PRINcess": (4, 3, 0), "PrInCeSs": (4, 3, 3),
                  "princess": (0, 4, 0)}


@pytest.mark.parametrize("keyword", list(PATTERN_COUNTS))
def test_traced_run_counts_the_mode(tmp_path, keyword, monkeypatch):
    counters, infos = _counts(tmp_path, keyword, monkeypatch, traced=True)
    assert len(infos) > 1
    assert counters["step.prefilter_windows"] == sum(
        i.prefilter_total for i in infos)
    assert counters["step.exact_windows"] == sum(i.candidates for i in infos)
    assert counters["step.exact_windows"] >= 4
    pat = compile_pattern(keyword, "*")
    keep = prefilter_check_indices(pat)
    gaps = pat.chk_shift_cur[keep] - pat.chk_shift_prev[keep]
    want = (pat.wildcards_count, len(keep), int((gaps > 1).sum()))
    assert want == PATTERN_COUNTS[keyword]
    assert (counters["pattern.wildcards"], counters["pattern.prefilter_checks"],
            counters["pattern.bridged_checks"]) == want


def test_a_repeat_keyword_counts_its_pattern_again(tmp_path, monkeypatch):
    first, _ = _counts(tmp_path, "Pr*ncess", monkeypatch, traced=True)
    again, _ = _counts(tmp_path, "Pr*ncess", monkeypatch, traced=True)
    assert again["pattern.prefilter_checks"] == 4
    assert again == first


def test_untraced_run_counts_nothing(tmp_path, monkeypatch):
    counters, infos = _counts(tmp_path, "Pr*ncess", monkeypatch,
                              traced=False)
    assert infos and counters == {}


@pytest.mark.parametrize("resident", [True, False])
def test_previews_at_the_file_ends(tmp_path, monkeypatch, resident):
    # copies in the file's first and last windows, whose previews are cut
    # and shifted at its ends; a resident run reads every preview window
    # from the corpus in one gather, a streamed one from the file
    path, _ = planted_file(tmp_path, "Pr*ncess")
    data = np.fromfile(path, dtype=np.uint8)
    data[:8] = encode("Pr*ncess", 5, 77)
    data[-8:] = encode("Pr*ncess", 200, 9)
    data.tofile(path)
    gathers = []
    real = tcorpus.ResidentCorpus.windows
    monkeypatch.setattr(tcorpus.ResidentCorpus, "windows",
                        lambda self, *a: gathers.append(a) or real(self, *a))
    cfg = _jax_config(path, "Pr*ncess")
    want = JaxEngine(cfg).run(generate_previews=True)
    tcorpus.clear_corpus_cache()
    port = carry_over(cfg)
    if not resident:
        port.resident_bytes_limit = 0
    got = SearchEngine(port, device="cpu").run(generate_previews=True)
    assert _tuples(got) == _tuples(want)
    assert {0, N_BYTES - 8} <= {r.offset for r in got}
    assert len(gathers) == int(resident)
