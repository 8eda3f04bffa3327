"""The port's benchmark matrix (``monkey_moore_tpu_torch.bench_all``) on the
CPU, against ``tools/bench_all.py``'s artifact and the JAX package:

- ``bench_all --device cpu --mb 1`` writes a record whose key sets equal
  the committed ``BENCH_DETAIL.json``'s, at top level and per suite (less
  ``pct_hbm_roofline``, which needs a known card), with the same suite
  names and sweep sizes, and leaves ``BENCH_DETAIL.json`` byte for byte as
  it was;
- on the suites' corpus with planted keywords (8-bit and 16-bit, at word
  and tile edges), each suite's ``matches_per_step`` equals the match
  count of the port's host scanner on the same bytes and of the JAX
  package's ``dense.fused_count_extract`` on the same words handed over as
  numpy (Pallas in interpret mode);
- the element-array branch, for a pattern that would not take packed
  words, gives the same matches.

Inputs are made with numpy and a seeded ``torch.Generator``.  Tolerance:
exact equality — every count is an integer.
"""

import hashlib
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monkey_moore_tpu import dense as jdense
from monkey_moore_tpu.pattern import compile_pattern as jcompile
from monkey_moore_tpu_torch import bench_all
from monkey_moore_tpu_torch.ops.scan_host import host_candidates_values

ROOT = Path(__file__).resolve().parent.parent
N_BYTES = 1 << 20
#: 8-bit plants (byte offsets) and 16-bit plants (element offsets), apart
PLANTS_8 = [1, 8190, 65_537, 300_001, N_BYTES - 5]
PLANTS_16 = [3, 4_101, 100_001, N_BYTES // 2 - 8]
SUITE_NAMES = [s[0] for s in bench_all.SUITES]
SUITE_CORPUS = bench_all.suite_corpus  # the unpatched corpus


def planted_corpus(n_bytes, device):
    """The suites' corpus with the keyword planted at :data:`PLANTS_8` (as
    bytes) and :data:`PLANTS_16` (as LE u16 elements), each shifted."""
    words = SUITE_CORPUS(n_bytes, device)
    kw = np.array([ord(c) for c in "abcde"])
    raw, elems = words.view(torch.uint8), words.view(torch.int16)
    for i, off in enumerate(PLANTS_8):
        raw[off : off + 5] = torch.tensor((kw + 7 * i) % 256,
                                          dtype=torch.uint8)
    for i, e in enumerate(PLANTS_16):
        elems[e : e + 5] = torch.tensor(kw + 300 + 1000 * i,
                                        dtype=torch.int16)
    return words


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One ``bench_all`` run at ``--mb 1`` on the planted corpus: (record,
    the corpus's bytes, BENCH_DETAIL.json's digest before the run)."""
    out = tmp_path_factory.mktemp("bench_all") / "detail.json"
    detail = ROOT / "BENCH_DETAIL.json"
    digest = hashlib.sha256(detail.read_bytes()).hexdigest()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_all, "suite_corpus", planted_corpus)
        assert bench_all.main(["--device", "cpu", "--mb", "1", "--iters",
                               "1", "--warmup", "0", "--json",
                               str(out)]) == 0
    words = planted_corpus(N_BYTES, "cpu")
    return json.loads(out.read_text()), words, digest


def test_record_keys_are_bench_detail_keys(run):
    record, _, digest = run
    jax_record = json.loads((ROOT / "BENCH_DETAIL.json").read_text())
    assert set(record) == set(jax_record)
    assert list(record["suites"]) == list(jax_record["suites"]) == SUITE_NAMES
    for name, suite in record["suites"].items():
        assert set(suite) == set(jax_record["suites"][name]) - {
            "pct_hbm_roofline"}
        assert suite["pipeline_depth"] == 3
        assert suite["fused_fallbacks"] == 0
        assert suite["reference_bytes_per_s"] == jax_record["suites"][name][
            "reference_bytes_per_s"]
    for key in ("buffer_size_sweep_8bit", "buffer_size_sweep_8bit_detail"):
        assert list(record[key]) == list(jax_record[key])
        assert list(record[key]) == [str(s) for s in bench_all.SWEEP_SIZES]
    assert set(record["buffer_size_sweep_8bit_detail"]["131072"]) == set(
        jax_record["buffer_size_sweep_8bit_detail"]["131072"])
    assert record["data_mb"] == 1 and record["device"] == "cpu"
    assert hashlib.sha256(
        (ROOT / "BENCH_DETAIL.json").read_bytes()).hexdigest() == digest


def _jax_candidates(keyword, wildcard, width, words, n_bytes):
    """The JAX fused step's match count on the same words (interpret mode,
    its smallest interpret tile, zero padding past the bytes)."""
    jte = 32 * 1024
    tile_bytes = jte * width
    padded = np.zeros((-(-n_bytes // tile_bytes) + 1) * tile_bytes // 4,
                      dtype=np.int32)
    padded[: n_bytes // 4] = words.numpy()[: n_bytes // 4]
    jpat = jcompile(keyword, wildcard,
                    dtype=np.uint8 if width == 1 else np.uint16)
    offs, _, info = jdense.fused_count_extract(
        jpat, jnp.asarray(padded), n_bytes // width, interpret=True,
        tile_elems=jte)
    assert info.candidates == len(offs)
    return len(offs)


@pytest.mark.parametrize("suite", bench_all.SUITES, ids=SUITE_NAMES)
def test_matches_per_step_equal_host_scanner_and_jax(run, suite):
    record, words, _ = run
    name, keyword, wildcard, width = suite
    raw = words.numpy().view(np.uint8)[:N_BYTES]
    pat = bench_all.suite_pattern(keyword, wildcard, width)
    host, _ = host_candidates_values(pat, raw.view("<u2") if width == 2
                                     else raw)
    got = record["suites"][name]["matches_per_step"]
    planted = PLANTS_8 if width == 1 else PLANTS_16
    assert set(planted) <= set(host.tolist())
    assert got == len(host)
    assert got == _jax_candidates(keyword, wildcard, width, words, N_BYTES)


def test_element_branch_finds_the_same_matches(monkeypatch):
    """A pattern that does not take packed words scans the seeded host
    bytes uploaded as elements (planted here as in the corpus): the same
    matches as the host scanner on those bytes."""
    n_bytes = 1 << 20
    raw = planted_corpus(n_bytes, "cpu").numpy().view(np.uint8)[:n_bytes]
    monkeypatch.setattr(bench_all, "wants_packed", lambda pat: False)
    monkeypatch.setattr(bench_all, "host_bytes", lambda n: raw[:n].copy())
    words = bench_all.suite_corpus(n_bytes, "cpu")
    _, details = bench_all.run_suites(words, n_bytes, iters=1, warmup=0,
                                      depth=2)
    for name, keyword, wildcard, width in bench_all.SUITES:
        m = details[name]
        assert m["tile_elems"] == bench_all.TILE_ELEMS
        pat = bench_all.suite_pattern(keyword, wildcard, width)
        host, _ = host_candidates_values(pat, raw.view("<u2") if width == 2
                                         else raw)
        assert len(host) >= 3
        assert m["offsets"].tolist() == host.tolist(), name


def test_host_bytes_is_the_tools_draw():
    want = np.random.default_rng(42).integers(0, 256, 4096, dtype=np.uint8)
    assert np.array_equal(bench_all.host_bytes(4096), want)
