"""Keyword batches through the port's ``MultiSearcher`` against the
benchmark's plain batch reference (``benchmark/references/batch.py``), and
what a batch records: its spans, counters and ``last_stats``, and the two
readers that the benchmark's cell ``u8_batch8`` adds.

A seeded 8-bit file of 1 MiB holds two entries of 8 words each, every
word planted under independent bases, some copies as wrap decoys (a shift
that carries the word's top value past 255, which simple mode's signed
comparison rejects), with plants at the file's two ends and one across a
chunk boundary.  The file is kept small because the kernels' plain
versions run on the CPU: kernel L's plain tail costs about a tenth of a
second a keyword and step.

Tolerance: exact equality throughout — offsets, values maps, previews,
span names and counters are integers and strings.  The roofline reader is
compared with ``counts_bench.c_bound`` to float rounding only (the two
divide the same integers by the same peaks in another order).
"""

import subprocess
import sys
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from monkey_moore_tpu_torch import corpus, profiling
from monkey_moore_tpu_torch.config import SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.multi import MultiSearcher
from monkey_moore_tpu_torch.scan_plan import chunk_plan

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import spec, stats, traffic  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]
FILE_BYTES = 1 << 20
CHUNK_BYTES = 1 << 17
ENTRIES = [
    ("sword", "shield", "potion", "castle", "knight", "dragon", "wizard",
     "treasure"),
    ("princess", "village", "forest", "mountain", "river", "kingdom",
     "monster", "battle"),
]
CONFIG = {"search_config": {"element_width": 1, "endianness": "little",
                            "custom_char_seq": "",
                            "preferred_search_block_size": 524288,
                            "preferred_preview_width": 50,
                            "semantics": "greedy"},
          "reference": "batch"}


def _plant(rng, word: str, decoy: bool) -> np.ndarray:
    """One copy of *word*: its code points under a random shift that keeps
    every value in 0-255, or, for a decoy, one that wraps the top value
    and not the bottom one."""
    v = np.array([ord(c) for c in word], dtype=np.int64)
    lo, hi = int(v.min()), int(v.max())
    if decoy:
        shift = int(rng.integers(256 - hi, 256 - lo))
    else:
        shift = int(rng.integers(-lo, 256 - hi))
    return ((v + shift) % 256).astype(np.uint8)


@pytest.fixture(scope="module")
def batch_file(tmp_path_factory):
    """``(path, decoys)``: the seeded file, and the byte offset of each
    decoy by word."""
    rng = np.random.default_rng(2025)
    data = rng.integers(0, 256, FILE_BYTES).astype(np.uint8)
    words = [w for entry in ENTRIES for w in entry]
    # first copies at the file's two ends and across the first chunk
    # boundary; the rest at random, 16 bytes apart from every other
    fixed = {words[0]: 0, words[9]: FILE_BYTES - len(words[9]),
             words[4]: CHUNK_BYTES - 3}
    taken = [(at, at + 16) for at in fixed.values()]
    decoys = {}
    for i, word in enumerate(words):
        for j in range(1 + i % 3 + i % 2):
            at = fixed.get(word) if j == 0 else None
            while at is None:
                at = int(rng.integers(0, FILE_BYTES - 16))
                if not all(at + 16 <= a or at >= b for a, b in taken):
                    at = None
            taken.append((at, at + 16))
            decoy = j % 2 == 1
            data[at : at + len(word)] = _plant(rng, word, decoy)
            if decoy:
                decoys.setdefault(word, []).append(at)
    path = tmp_path_factory.mktemp("batch") / "image.bin"
    path.write_bytes(data.tobytes())
    return str(path), decoys


def _searcher(path):
    return MultiSearcher(path, device="cpu", device_chunk_bytes=CHUNK_BYTES)


@pytest.fixture(scope="module")
def searched(batch_file):
    """Each entry searched once: the first under a profiler, the second
    without; ``[(results, last_stats)]``."""
    path, _ = batch_file
    corpus.clear_corpus_cache()
    out = []
    for i, entry in enumerate(ENTRIES):
        searcher = _searcher(path)
        if i == 0:
            with torch.profiler.profile(activities=CPU):
                results = searcher.search(list(entry), generate_previews=True)
        else:
            results = searcher.search(list(entry), generate_previews=True)
        out.append((results, searcher.last_stats))
    return out


def _reference():
    return spec.module("references", "batch")


def _as_tuples(entry, results):
    """The port's lists as the reference's tuples, through the request's
    ``as_tuples``."""
    pairs = [(kw, r) for kw, rs in zip(entry, results) for r in rs]
    return spec.module("requests", "multi").as_tuples(pairs)


@pytest.mark.parametrize("index", [0, 1], ids=["traced", "untraced"])
def test_batch_equals_the_plain_reference(batch_file, searched, index):
    path, decoys = batch_file
    results, _ = searched[index]
    entry = ENTRIES[index]
    ref = _reference()
    image = np.fromfile(path, dtype=np.uint8)
    want = ref.results(ref.grids(image, CONFIG, "cpu"), CONFIG, entry)
    assert _as_tuples(entry, results) == want
    found = {kw: [r.offset for r in rs] for kw, rs in zip(entry, results)}
    assert all(found[kw] for kw in entry)
    assert all(set(decoys.get(kw, [])).isdisjoint(found[kw]) for kw in entry)
    if index == 0:
        assert found[entry[0]][0] == 0
        assert CHUNK_BYTES - 3 in found[entry[4]]
    else:
        assert found[entry[1]][-1] == FILE_BYTES - len(entry[1])


@pytest.mark.parametrize("index", [0, 1], ids=["traced", "untraced"])
def test_batch_equals_the_engine_per_keyword(batch_file, searched, index):
    path, _ = batch_file
    results, _ = searched[index]
    for kw, got in zip(ENTRIES[index], results):
        engine = SearchEngine(SearchConfig(
            file_path=path, keyword=kw, device_chunk_bytes=CHUNK_BYTES,
            host_latency_threshold_bytes=0), device="cpu")
        want = engine.run(generate_previews=True)
        assert [(r.offset, r.values_map, r.preview) for r in got] == [
            (r.offset, r.values_map, r.preview) for r in want]


def test_the_wrap_control_reports_the_decoys(batch_file):
    path, decoys = batch_file
    ref = _reference()
    image = np.fromfile(path, dtype=np.uint8)
    g = ref.grids(image, CONFIG, "cpu")
    for entry in ENTRIES:
        signed = ref.results(g, CONFIG, entry)
        wrap = ref.results(g, CONFIG, entry, compare="wrap")
        planted = {(kw, at) for kw in entry for at in decoys.get(kw, [])}
        assert planted
        assert planted <= {key for key, _, _ in wrap}
        assert planted.isdisjoint(key for key, _, _ in signed)
        assert wrap != signed
    # the control's results, shaped as one keyword's, read back alike
    control = spec.module("requests", "multi").as_tuples(
        [SimpleNamespace(offset=key, values_map=vmap, preview=preview)
         for key, vmap, preview in wrap])
    assert control == wrap


def _steps(entry):
    plan = chunk_plan(FILE_BYTES, 1, max(map(len, entry)), CHUNK_BYTES)
    return [step for k in range(plan.n_chunks)
            for step in plan.steps(k, min(map(len, entry)))], plan


def test_an_untraced_batch_keeps_stats_and_no_record(searched):
    _, st = searched[1]
    assert st.record.spans == [] and st.record.counters == {}
    steps, _ = _steps(ENTRIES[1])
    assert st.fused_steps == len(steps) * len(ENTRIES[1])
    assert st.fused_fallbacks == 0
    assert st.bytes_scanned == sum(count for _, _, count in steps)
    assert st.results == sum(1 for _ in _as_tuples(ENTRIES[1],
                                                   searched[1][0]))
    assert {"compile_pattern", "corpus_upload", "device_scan",
            "previews"} == set(st.stage_seconds)


def test_a_traced_batch_records_its_spans_and_counters(searched):
    results, st = searched[0]
    entry = ENTRIES[0]
    K = len(entry)
    record = st.record
    spans = record.spans
    steps, plan = _steps(entry)
    names = Counter(s.name for s in spans)
    assert spans[0].name == "mm.multi.search" and spans[0].parent == -1
    assert names["mm.multi.search"] == 1
    assert names["mm.compile_pattern"] == K
    for name in ("mm.device_scan", "mm.step.enqueue", "mm.step.fetch",
                 "mm.step.decode", "mm.engine.record"):
        assert names[name] == len(steps), name
    assert names["mm.engine.finalize"] == 1
    assert names["mm.engine.results"] == names["mm.previews"] == K
    assert "mm.step.fallback" not in names
    for i, s in enumerate(spans):
        assert s.request_id == record.request_id
        if i:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
        if s.name in ("mm.step.enqueue", "mm.step.fetch", "mm.step.decode"):
            assert spans[s.parent].name == "mm.device_scan"
    assert st.fused_steps == len(steps) * K
    n = record.counters
    assert n["multi.keywords"] == K
    assert n["kernel.counts_multi"] == len(steps)
    assert n["kernel.counts_multi_bytes"] == len(steps) * plan.want
    lengths = [len(w) for w in entry]
    assert n["kernel.counts_multi_windows"] == sum(
        count - L + 1 for _, _, count in steps for L in lengths)
    # every keyword of the entry is plain lowercase: one first pair, (1, 0)
    assert n["kernel.counts_multi_first_windows"] == sum(
        count - min(lengths) + 1 for _, _, count in steps)
    assert sum(map(len, results)) == st.results


def _run(records, device_s, width=1):
    done = [SimpleNamespace(stats=SimpleNamespace(record=r))
            for r in records]
    trace = None if device_s is None else stats.TraceSummary(
        window_s=1.0, busy_s=0.5, device_s=device_s)
    return SimpleNamespace(done=done, trace=trace, width=width)


_C = "(anonymous namespace)::swar_counts_kernel<1>(Params)"


@pytest.mark.parametrize("name", ["kernel.multi_counts_roofline",
                                  "step.decode_ms"])
def test_the_batch_readers_find_nothing_without_trace_or_spans(
        searched, name):
    read = spec.reader(name)
    _, untraced = searched[1]
    _, traced = searched[0]
    assert read(_run([untraced.record], {_C: 1e-3})) is None
    assert read(_run([], {_C: 1e-3})) is None
    if name == "kernel.multi_counts_roofline":
        assert read(_run([traced.record], None)) is None
        assert read(_run([traced.record], {"other": 1.0})) is None
        plain = profiling.SpanRecord(1)
        plain.spans.append(profiling.Span("mm.search", 0, -1, 1))
        assert read(_run([plain], {_C: 1e-3})) is None  # no launch of C
    else:
        assert read(_run([traced.record], None)) > 0


def test_the_decode_reader_is_the_median_of_the_decode_spans():
    recs = []
    for ms in (1.0, 4.0, 2.0):
        rec = profiling.SpanRecord(len(recs) + 1)
        rec.spans.append(profiling.Span("mm.multi.search", 0, -1, 1))
        for _ in range(2):
            s = profiling.Span("mm.step.decode", 0, 0, 1)
            s.end_ns = int(ms * 5e5)
            rec.spans.append(s)
        recs.append(rec)
    assert spec.reader("step.decode_ms")(_run(recs, None)) == 2.0


def test_the_batch_roofline_is_c_bound_over_kernel_time():
    """One request of two launches of C over 8 keywords, counters as the
    program counts them, against ``counts_bench.c_bound`` on the same
    operands.  Lengths 5 and 9 and a valid count divisible by 4 keep every
    keyword's window starts a whole number of words, where c_bound rounds
    each keyword up and the reader the sums."""
    from monkey_moore_tpu_torch.counts_bench import c_bound
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.pattern import compile_pattern

    TE, n_tiles = 262_144, 3
    valid = n_tiles * TE - 1236
    batch = [("sword", 0), ("?bcde", "?"), ("adventure", 0),
             ("?rincesss", "?"), ("tower", 0), ("magic", 0),
             ("lance", 0), ("dungeonss", 0)]
    pats = [compile_pattern(kw, wc) for kw, wc in batch]
    assert {p.length for p in pats} == {5, 9}
    _, table, last, (windows, first) = scan_cuda._multi_entry(
        pats, valid, "cpu")
    word_bytes = (n_tiles + 1) * TE
    record = profiling.SpanRecord(1)
    record.spans.append(profiling.Span("mm.multi.search", 0, -1, 1))
    record.counters.update({
        "multi.keywords": len(pats), "kernel.counts_multi": 2,
        "kernel.counts_multi_bytes": 2 * word_bytes,
        "kernel.counts_multi_windows": 2 * windows,
        "kernel.counts_multi_first_windows": 2 * first})
    device_s = 2 * 1.7e-3
    got = spec.reader("kernel.multi_counts_roofline")(
        _run([record], {_C: device_s, "phase2_kernel": 1.0}))
    bound_ms, by = c_bound(word_bytes, n_tiles, table, last)
    assert by == "operations"
    assert got == pytest.approx(100 * 2 * bound_ms / 1e3 / device_s)
    # by hand: 5 ops a word of first-pair starts, 4 a word of keyword
    # starts; two first pairs, (1, 0) and (2, 1)
    starts = [valid - p.length + 1 for p in pats]
    assert windows == sum(starts)
    assert first == max(s for s, p in zip(starts, pats)
                        if p.chk_shift_prev[0] == 0) + max(
        s for s, p in zip(starts, pats) if p.chk_shift_prev[0] == 1)
    ops = 2 * (5 * first // 4 + 4 * windows // 4)
    n_bytes = 2 * (word_bytes + 4 * len(pats) * n_tiles)
    assert got == pytest.approx(
        100 * stats.bound_s(n_bytes, ops)[0] / device_s)
    assert 0 < got < 100


def test_the_generator_groups_the_default_mix_into_entries():
    cell = spec.cell("u8_batch8")
    assert cell.config["reference"] == "batch" and cell.chips == 1
    mix = cell.traffic
    seed = 2**31 + 77
    work = spec.generator(cell)(cell.config, mix, seed, "cpu",
                                n_bytes=4 << 20)
    plain = traffic.make(cell.config, mix, seed, "cpu", n_bytes=4 << 20)
    size = int(mix["batch"])
    assert size == 8
    assert all(len(e) == size == len(set(e)) for e in work.keywords)
    assert len(work.keywords) == -(-len(plain.keywords) // size)
    assert {w for e in work.keywords for w in e} == set(plain.keywords)
    assert work.warm == work.keywords[0]
    assert np.array_equal(work.image, plain.image)
    assert [(p.keyword, p.offset, p.decoy) for p in work.plants] == [
        (p.keyword, p.offset, p.decoy) for p in plain.plants]
    assert any(p.decoy for p in work.plants)
    stream = work.stream()
    first = [next(stream) for _ in range(len(work.keywords))]
    assert sorted(first) == list(range(len(work.keywords)))
    again = spec.generator(cell)(cell.config, mix, seed, "cpu",
                                 n_bytes=4 << 20)
    assert again.keywords == work.keywords


def test_the_reference_path_loads_no_jax(tmp_path):
    """The batch reference, generator, request's ``as_tuples`` and readers
    in a fresh process: no module of JAX or of the JAX package."""
    script = """
import sys
import numpy as np
from benchmark import spec
ref = spec.module("references", "batch")
for kind, name in (("generators", "batch"), ("requests", "multi"),
                   ("metrics", "kernel.multi_counts_roofline"),
                   ("metrics", "step.decode_ms")):
    spec.module(kind, name)
config = {"search_config": {"element_width": 1, "custom_char_seq": "",
          "preferred_search_block_size": 4096,
          "preferred_preview_width": 20}}
image = np.frombuffer(b"xx" + bytes(ord(c) + 3 for c in "sword") + b"yy",
                      dtype=np.uint8)
got = ref.results(ref.grids(image, config, "cpu"), config, ("sword", "word"))
assert [key for key, _, _ in got] == [("sword", 2), ("word", 3)], got
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "monkey_moore_tpu"))
assert not loaded, loaded
print("no-jax ok")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT),
             "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "no-jax ok" in proc.stdout
