"""The port's span recorder (``monkey_moore_tpu_torch.profiling``): what a
``device="cpu"`` engine run records under ``torch.profiler``, and that it
records nothing, and enters no ``record_function``, without one.

A traced run keeps every ``mm.`` span of its path in
``last_stats.record``: one root ``mm.search``, each child inside its
parent, all under the run's request id, and the resident corpus's read,
padded copy and upload with their byte counters.

Tolerance: exact equality throughout — spans are compared by name and
nesting, results by value.
"""

import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from monkey_moore_tpu_torch import corpus, profiling
from monkey_moore_tpu_torch.config import Endianness, SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine

CPU = [torch.profiler.ProfilerActivity.CPU]

#: spans of a resident run that uploads its corpus and finds results
RESIDENT = {"mm.search", "mm.compile_pattern", "mm.engine.plan",
            "mm.corpus_upload", "mm.corpus.read", "mm.corpus.pad",
            "mm.corpus.h2d", "mm.device_scan", "mm.step.enqueue",
            "mm.step.fetch", "mm.engine.record", "mm.engine.progress",
            "mm.engine.finalize", "mm.engine.results", "mm.previews"}


def _file(tmp_path, width, ramp=False):
    if ramp:
        # a byte ramp matches "abcde" at nearly every window: every step
        # overflows its capacities and takes the fallback
        data = (np.arange(8192) & 0xFF).astype(np.uint8)
    else:
        rng = np.random.default_rng(5)
        dtype = np.uint8 if width == 1 else np.uint16
        data = rng.integers(0, 1 << (8 * width), 40_000).astype(dtype)
        enc = np.array([ord(c) + 3 for c in "monkey"], dtype=dtype)
        for pos in (3, 17_001, 39_990):
            data[pos : pos + 6] = enc
        if width == 2:
            data = data.astype(">u2")
    path = tmp_path / "image.bin"
    path.write_bytes(data.tobytes())
    return str(path), len(data.tobytes())


def _config(path, size, width=1, **kw):
    kw.setdefault("keyword", "monkey")
    return SearchConfig(
        file_path=path, element_width=width,
        endianness=Endianness.BIG, device_chunk_bytes=16_384,
        host_latency_threshold_bytes=size // 2, **kw)


def _traced(engine):
    corpus.clear_corpus_cache()
    with torch.profiler.profile(activities=CPU) as prof:
        results = engine.run(generate_previews=True)
    return results, engine.last_stats.record, prof


def _assert_tree(record):
    spans = record.spans
    assert spans[0].name == "mm.search" and spans[0].parent == -1
    for i, s in enumerate(spans):
        assert s.request_id == record.request_id
        assert s.start_ns <= s.end_ns
        if i:
            assert 0 <= s.parent < i
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert 0 <= record.self_ns(i) <= s.duration_ns


@pytest.mark.parametrize("case,want", [
    ("u8", RESIDENT),
    ("u16be", RESIDENT | {"mm.corpus.derive"}),
    ("stream", RESIDENT - {"mm.corpus.read", "mm.corpus.pad", "mm.corpus.h2d"}
     | {"mm.decode"}),
    ("ramp", RESIDENT | {"mm.step.fallback"}),
])
def test_traced_run_records_every_span_of_its_path(tmp_path, case, want):
    width = 2 if case == "u16be" else 1
    path, size = _file(tmp_path, width, ramp=case == "ramp")
    kw = {"keyword": "abcde"} if case == "ramp" else {}
    if case == "stream":
        kw["resident_bytes_limit"] = 0
    engine = SearchEngine(_config(path, size, width, **kw), device="cpu")
    plain = engine.run(generate_previews=True)
    assert engine.last_stats.record.spans == []
    results, record, prof = _traced(engine)
    assert [(r.offset, r.values_map, r.preview) for r in results] == [
        (r.offset, r.values_map, r.preview) for r in plain]
    assert results
    assert {s.name for s in record.spans} == want
    _assert_tree(record)
    # every span is a range of the profiler's trace too
    ranges = {e.name for e in prof.events()}
    assert want <= ranges
    if case == "ramp":
        assert engine.last_stats.fused_fallbacks > 0
    if "mm.corpus.read" in want:
        n = record.counters
        assert n["corpus.read_bytes"] == size
        assert n["corpus.pad_bytes"] == n["corpus.h2d_bytes"] >= size


def test_two_runs_take_two_request_ids(tmp_path):
    path, size = _file(tmp_path, 1)
    engine = SearchEngine(_config(path, size), device="cpu")
    _, first, _ = _traced(engine)
    _, second, _ = _traced(engine)
    assert second.request_id > first.request_id
    assert {s.request_id for s in first.spans} == {first.request_id}
    assert {s.request_id for s in second.spans} == {second.request_id}


def test_untraced_run_keeps_no_span_and_enters_no_range(tmp_path,
                                                         monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Range)
    path, size = _file(tmp_path, 2)
    corpus.clear_corpus_cache()
    engine = SearchEngine(_config(path, size, 2), device="cpu")
    assert engine.run(generate_previews=True)
    assert entered == []
    assert engine.last_stats.record.spans == []
    assert engine.last_stats.record.counters == {}
    assert profiling.span("mm.search") is profiling.span("mm.other")
    profiling.count("corpus.read_bytes", 1)  # no run open: nothing kept


def test_corpus_spans_and_byte_counters():
    data = np.arange(1000, dtype=np.uint8)
    with torch.profiler.profile(activities=CPU), \
            profiling.run_record() as record:
        rc = corpus.ResidentCorpus(data, pad_bytes=24, device="cpu")
        w = rc.grid_chunk(2, Endianness.BIG, 1, 0, 100, packed=True)
        assert rc.grid_chunk(1, Endianness.LITTLE, 0, 0, 64).numel() == 64
    assert [s.name for s in record.spans] == [
        "mm.corpus.pad", "mm.corpus.h2d", "mm.corpus.derive"]
    assert all(s.parent == -1 for s in record.spans)
    assert record.counters == {"corpus.pad_bytes": 1028,
                               "corpus.h2d_bytes": 1028}
    want = data[1:201].view(">u2").astype("<u2").view(np.int32)
    assert w.numpy().tolist() == want.tolist()


def test_stage_opens_its_span_and_self_time_leaves_children_out():
    timer = profiling.StageTimer()
    with torch.profiler.profile(activities=CPU), \
            profiling.run_record() as record:
        with timer.stage("device_scan"):
            with profiling.span("mm.step.enqueue"):
                pass
            with profiling.span("mm.step.fetch"):
                pass
    names = [s.name for s in record.spans]
    assert names == ["mm.device_scan", "mm.step.enqueue", "mm.step.fetch"]
    assert list(timer.stats.stage_seconds) == ["device_scan"]
    outer = record.spans[0]
    assert record.self_ns(0) == outer.duration_ns - sum(
        s.duration_ns for s in record.spans[1:])


def test_a_thread_without_the_profiler_records_nothing(tmp_path):
    # the profiler traces the thread that started it: an engine on another
    # thread (``AsyncSearch``) keeps no span, and the traced run beside it
    # keeps only its own
    path, size = _file(tmp_path, 1)
    traced, other = (SearchEngine(_config(path, size), device="cpu")
                     for _ in range(2))
    errors = []
    started = threading.Event()

    def search():
        try:
            started.set()
            for _ in range(3):
                other.run()
        except Exception as exc:  # reported below
            errors.append(exc)

    with torch.profiler.profile(activities=CPU):
        thread = threading.Thread(target=search)
        thread.start()
        started.wait(timeout=60)
        for _ in range(3):
            traced.run()
        thread.join(timeout=120)
    assert not thread.is_alive() and not errors
    assert other.last_stats.record.spans == []
    record = traced.last_stats.record
    _assert_tree(record)
    assert sum(s.name == "mm.search" for s in record.spans) == 1
    assert record.request_id != other.last_stats.record.request_id


def _derive_roofline():
    """The benchmark's reader of ``kernel.derive_roofline`` and its
    ``stats`` module, imported from the repository's root as
    ``benchmark/run.py`` does."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import spec, stats

    return spec.reader("kernel.derive_roofline"), stats


def _bench_run(records, device_s):
    from benchmark.stats import TraceSummary

    done = [SimpleNamespace(stats=SimpleNamespace(record=r))
            for r in records]
    trace = None if device_s is None else TraceSummary(
        window_s=1.0, busy_s=0.5, device_s=device_s)
    return SimpleNamespace(done=done, trace=trace)


_M = "(anonymous namespace)::derive_words_kernel<true>(unsigned int const*)"


@pytest.mark.parametrize("counted,device_s", [
    (False, {_M: 4e-3, "other": 1.0}),  # the CPU's plain version counts 0
    (True, {"other": 1.0}),  # a program without kernel M
    (True, None),  # an untraced run
])
def test_derive_roofline_finds_nothing_without_kernel_and_bytes(
        tmp_path, counted, device_s):
    read, _ = _derive_roofline()
    path, size = _file(tmp_path, 2)
    engine = SearchEngine(_config(path, size, 2), device="cpu")
    _, record, _ = _traced(engine)
    assert "mm.corpus.derive" in {s.name for s in record.spans}
    assert "corpus.derive_bytes" not in record.counters
    if counted:
        record.counters["corpus.derive_bytes"] = 8 * 2**20
    assert read(_bench_run([record], device_s)) is None


def test_derive_roofline_is_the_counted_bytes_bound_over_kernel_time():
    read, stats = _derive_roofline()
    record = profiling.SpanRecord(1)
    record.spans.append(profiling.Span("mm.search", 0, -1, 1))
    record.counters["corpus.derive_bytes"] = 5_000_000_000
    run = _bench_run([record, record], {_M: 4e-3, "other": 1.0})
    want = 100 * stats.bound_s(10_000_000_000, 0)[0] / 4e-3
    assert read(run) == pytest.approx(want)
    assert 0 < want < 100
