"""The program's spans as the benchmark reads them: the readers of the
``program_span`` metrics on synthetic span records, and
``spans.reduce_spans`` on a hand-built Chrome trace, which leaves
``stats.reduce_trace``'s reading of the same trace as it was."""

from types import SimpleNamespace

import pytest

from benchmark import harness, spans, spec, stats


def x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


HARNESS = [
    x("bench.window", "user_annotation", 1000.0, 1000.0),
    x("bench.search", "user_annotation", 1000.0, 900.0),
    x("aten::copy_", "cpu_op", 1390.0, 70.0),
    x("aten::add", "cpu_op", 1120.0, 5.0),
    x("k_before", "kernel", 900.0, 120.0, 4),
    x("cudaLaunchKernel", "cuda_runtime", 950.0, 5.0, 4),
    x("k_derive", "kernel", 1150.0, 100.0, 1),
    x("cudaLaunchKernel", "cuda_runtime", 1120.0, 5.0, 1),
    x("k_count", "kernel", 1250.0, 100.0, 2),
    x("cudaLaunchKernel", "cuda_runtime", 1180.0, 5.0, 2),
    x("Memcpy DtoH", "gpu_memcpy", 1450.0, 30.0, 3),
    x("cudaMemcpyAsync", "cuda_runtime", 1395.0, 60.0, 3),
    x("k_orphan", "kernel", 1700.0, 20.0),
    x("k_tail", "kernel", 1880.0, 10.0, 5),
    x("cudaLaunchKernel", "cuda_runtime", 1870.0, 5.0, 5),
]
PROGRAM = [
    x("mm.search", "user_annotation", 1090.0, 800.0),
    x("mm.engine.plan", "user_annotation", 1091.0, 3.0),
    x("mm.device_scan", "user_annotation", 1095.0, 405.0),
    x("mm.step.enqueue", "user_annotation", 1100.0, 100.0),
    x("mm.corpus.derive", "user_annotation", 1110.0, 40.0),
    x("mm.step.fetch", "user_annotation", 1390.0, 110.0),
    x("mm.engine.finalize", "user_annotation", 1600.0, 250.0),
]


def test_idle_and_device_time_by_innermost_span():
    got = spans.reduce_spans({"traceEvents": HARNESS + PROGRAM})
    # busy [1000, 1020] [1150, 1350] [1450, 1480] [1700, 1720] [1880, 1890];
    # gaps by their middles: 1085 before mm.search, 1400 in the fetch,
    # 1590 in mm.search alone, 1800 in finalize, 1945 past bench.search
    want_idle = {"none": 240e-6, "mm.step.fetch": 100e-6,
                 "mm.search": 220e-6, "mm.engine.finalize": 160e-6}
    assert got.idle_span_s.keys() == want_idle.keys()
    for k, v in want_idle.items():
        assert got.idle_span_s[k] == pytest.approx(v)
    assert got.search_idle_s == pytest.approx(610e-6)
    assert got.search_none_s == pytest.approx(130e-6)
    # launches: derive's kernel inside mm.corpus.derive, the counts kernel
    # in the enqueue, the copy in the fetch, k_tail in mm.search; k_before
    # (launched before any span, clipped to the window) and k_orphan (no
    # correlation) are "none"
    want_dev = {"none": 40e-6, "mm.corpus.derive": 100e-6,
                "mm.step.enqueue": 100e-6, "mm.step.fetch": 30e-6,
                "mm.search": 10e-6}
    assert got.device_span_s.keys() == want_dev.keys()
    for k, v in want_dev.items():
        assert got.device_span_s[k] == pytest.approx(v)
    assert sum(got.idle_span_s.values()) == pytest.approx(720e-6)


def test_program_spans_leave_the_trace_reduction_as_it_was():
    with_spans = stats.reduce_trace({"traceEvents": HARNESS + PROGRAM})
    without = stats.reduce_trace({"traceEvents": HARNESS})
    assert with_spans == without
    assert with_spans.busy_s == pytest.approx(280e-6)
    assert with_spans.idle_s["search: python"] == pytest.approx(510e-6)
    assert with_spans.idle_s["search: aten::copy_"] == pytest.approx(100e-6)
    assert with_spans.idle_s["harness: python"] == pytest.approx(110e-6)


def test_a_trace_without_program_spans_labels_everything_none():
    got = spans.reduce_spans({"traceEvents": HARNESS})
    assert list(got.idle_span_s) == ["none"]
    assert got.search_none_s == got.search_idle_s
    with pytest.raises(ValueError):
        spans.reduce_spans({"traceEvents": PROGRAM})


MS = 1_000_000


def record(*items, counters=None, request_id=1):
    """A span record: items ``(name, start_ms, end_ms, parent)``."""
    return SimpleNamespace(
        request_id=request_id, counters=dict(counters or {}),
        spans=[SimpleNamespace(name=n, start_ns=int(a * MS),
                               end_ns=int(b * MS), parent=p)
               for n, a, b, p in items])


def request(rec, wall_s=0.02):
    stats_ = SimpleNamespace(stage_seconds={}, fused_steps=1,
                             fused_fallbacks=0, bytes_scanned=0, h2d_bytes=0)
    if rec is not None:
        stats_.record = rec
    return harness.Request("word", wall_s, stats_, 1)


def run_of(recs):
    return harness.Run([request(r) for r in recs], window_s=1.0,
                       setup_s=1.0, setup_parts={}, file_bytes=1 << 30,
                       width=1)


def resident(scale):
    """One resident request's record, its times scaled by *scale*."""
    s = scale
    return record(
        ("mm.search", 0, 20 * s, -1),
        ("mm.compile_pattern", 0, 0.5 * s, 0),
        ("mm.engine.plan", 0.5 * s, 2 * s, 0),
        ("mm.device_scan", 2 * s, 3 * s, 0),
        ("mm.step.enqueue", 2 * s, 3 * s, 3),
        ("mm.device_scan", 3 * s, 8 * s, 0),
        ("mm.step.fetch", 3 * s, 7 * s, 5),
        ("mm.step.fallback", 7 * s, 8 * s, 5),
        ("mm.engine.record", 8 * s, 8.5 * s, 0),
        ("mm.engine.progress", 8.5 * s, 11 * s, 0),
        ("mm.engine.progress", 9 * s, 10 * s, 9),  # nested: counted once
        ("mm.engine.finalize", 11 * s, 13 * s, 0),
        ("mm.engine.results", 13 * s, 13.5 * s, 0),
    )


def read(name, run):
    return spec.reader(name)(run)


def test_span_readers_take_the_median_request():
    run = run_of([resident(1), resident(2), resident(4)])
    assert read("engine.blocks_ms", run) == pytest.approx(2 * (1.5 + 2.5))
    assert read("engine.record_ms", run) == pytest.approx(2 * 0.5)
    assert read("engine.finalize_ms", run) == pytest.approx(2 * 2.5)
    assert read("step.enqueue_ms", run) == pytest.approx(2 * 1)
    assert read("step.fetch_wait_ms", run) == pytest.approx(2 * 4)


def test_corpus_readers_pool_bytes_over_span_time():
    open_ = record(
        ("mm.search", 0, 4000, -1),
        ("mm.corpus_upload", 0, 3000, 0),
        ("mm.corpus.read", 0, 1000, 1),
        ("mm.corpus.pad", 1000, 2500, 1),
        ("mm.corpus.h2d", 2500, 3000, 1),
        counters={"corpus.read_bytes": 4_000_000_000,
                  "corpus.pad_bytes": 4_500_000_000,
                  "corpus.h2d_bytes": 4_500_000_000})
    run = run_of([open_, open_, resident(1)])
    assert read("corpus.read_GBps", run) == pytest.approx(4.0)
    assert read("corpus.pad_GBps", run) == pytest.approx(3.0)
    assert read("corpus.h2d_GBps", run) == pytest.approx(9.0)


NEW = ("engine.blocks_ms", "engine.record_ms", "engine.finalize_ms",
       "step.enqueue_ms", "step.fetch_wait_ms", "corpus.read_GBps",
       "corpus.pad_GBps", "corpus.h2d_GBps")


@pytest.mark.parametrize("name", NEW)
def test_span_readers_find_nothing_without_spans(name):
    # a program without the recorder (no ``record``), an untraced run (an
    # empty one), and a record without the metric's spans
    assert read(name, run_of([None, None])) is None
    assert read(name, run_of([record(), record()])) is None
    assert read(name, run_of([record(("mm.search", 0, 1, -1))])) is None


def test_every_span_metric_is_in_the_benchmark_with_its_cells():
    entries = {m["name"]: m for m in spec.load_spec()["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span"
        want = (["u8_open"] if name.startswith("corpus.")
                else ["u8_sparse", "u16be_kana", "u8_dense"])
        assert m["workloads"] == want
        for cell in want:
            assert name in {x.name for x in spec.cell(cell).per_layer}
