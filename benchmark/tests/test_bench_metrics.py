"""The benchmark's arithmetic on synthetic numbers and traces, the
readers of every metric, and the runs that must print no result."""

import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import harness, spec, stats

ROOT = Path(spec.ROOT)


def test_percentile_is_numpys_linear_percentile():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100, 1001):
        xs = rng.exponential(size=n).tolist()
        for q in (0, 5, 25, 50, 95, 99, 100):
            assert stats.percentile(xs, q) == pytest.approx(
                np.percentile(xs, q), rel=1e-12)


def test_bounds_equal_the_programs_copies():
    from monkey_moore_tpu_torch import bench, counts_bench

    assert stats.HBM_BYTES_PER_S == bench.HBM_BYTES_PER_S
    assert stats.INT_OPS_PER_S == bench.INT_OPS_PER_S
    assert (stats.DIFF_OPS, stats.EQUAL_OPS) == (
        counts_bench.DIFF_OPS, counts_bench.EQUAL_OPS)
    for width in (1, 2):
        valid = (512 << 20) // width
        tiles = valid // 262_144
        n_bytes, n_ops = stats.counts_work(valid * width, width, tiles)
        want_ms, want_by = counts_bench.a_bound(
            n_bytes - 4 * tiles, tiles, valid + 4, 5, width)
        got_s, got_by = stats.bound_s(n_bytes, n_ops)
        assert got_by == want_by
        assert got_s * 1e3 == pytest.approx(want_ms, rel=1e-6)


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    x("bench.window", "user_annotation", 1000.0, 1000.0),
    x("bench.search", "user_annotation", 1000.0, 900.0),
    x("bench.search", "gpu_user_annotation", 1000.0, 900.0),
    x("aten::copy_", "cpu_op", 1400.0, 150.0),
    x("aten::add", "cpu_op", 1420.0, 10.0),
    x("void k1<1>(Args)", "kernel", 1100.0, 100.0),
    x("k2", "kernel", 1150.0, 150.0),
    x("Memcpy HtoD", "gpu_memcpy", 1500.0, 100.0),
    x("k3", "kernel", 900.0, 150.0),  # starts before the window
    x("cudaLaunchKernel", "cuda_runtime", 1100.0, 5.0),
]}


def test_trace_busy_idle_and_gaps():
    t = stats.reduce_trace(TRACE)
    assert t.window_s == pytest.approx(1e-3)
    # busy: [1000, 1050] (k3 clipped), [1100, 1300], [1500, 1600]
    assert t.busy_s == pytest.approx(350e-6)
    assert t.idle_pct == pytest.approx(65.0)
    assert t.device_s["k1<1>(Args)"] == pytest.approx(100e-6)
    assert t.device_s["k3"] == pytest.approx(50e-6)
    # gaps: [1050, 1100] search/python, [1300, 1500] search/aten::copy_
    # (mid 1400), [1600, 2000] mid 1800 search/python
    assert t.idle_s["search: python"] == pytest.approx(450e-6)
    assert t.idle_n["search: python"] == 2
    assert t.idle_s["search: aten::copy_"] == pytest.approx(200e-6)
    gaps = t.idle_gaps()
    assert gaps[0][0] == "search: python (2 gaps)"
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert t.device_ops()[0] == ["k2", pytest.approx(150e-6)]


def test_trace_without_window_span_raises():
    with pytest.raises(ValueError):
        stats.reduce_trace({"traceEvents": TRACE["traceEvents"][1:]})


def stats_of(seconds, steps=2, fallbacks=0, scanned=1 << 30, h2d=0):
    return SimpleNamespace(stage_seconds=seconds, fused_steps=steps,
                           fused_fallbacks=fallbacks, bytes_scanned=scanned,
                           h2d_bytes=h2d)


def run_of(walls, trace=None, **kw):
    reqs = [harness.Request("word", w, stats_of(
        {"device_scan": w / 2, "previews": w / 10}, **kw), 3)
        for w in walls]
    return harness.Run(reqs, window_s=sum(walls), setup_s=12.5,
                       setup_parts={}, file_bytes=1 << 30, width=1,
                       trace=trace)


def read(name, run):
    return spec.reader(name)(run)


def test_end_to_end_readers():
    walls = [0.010, 0.012, 0.011, 0.030, 0.009]
    run = run_of(walls)
    assert read("search_ms_p50", run) == pytest.approx(11.0)
    assert read("search_ms_p95", run) == pytest.approx(
        np.percentile(walls, 95) * 1e3)
    assert read("open_search_ms_p50", run) == pytest.approx(11.0)
    assert read("scan_GBps", run) == pytest.approx(
        5 * (1 << 30) / sum(walls) / 1e9)
    assert read("setup_s", run) == 12.5


def test_per_layer_readers():
    run = run_of([0.010, 0.020, 0.030], fallbacks=1)
    assert read("engine.self_ms", run) == pytest.approx(20 * 0.4)
    assert read("step.device_scan_ms", run) == pytest.approx(10.0)
    assert read("engine.fallback_share", run) == pytest.approx(50.0)
    assert read("corpus.upload_GBps", run) is None
    assert read("kernel.counts_roofline", run) is None
    assert read("device.idle_pct.search", run) is None
    up = run_of([1.0, 1.2], h2d=1 << 30)
    for r in up.requests:
        r.stats.stage_seconds["corpus_upload"] = 0.5
    assert read("corpus.upload_GBps", up) == pytest.approx(
        2 * (1 << 30) / 1.0 / 1e9)


def test_roofline_reader_takes_the_counts_kernel_from_the_trace():
    trace = stats.TraceSummary(window_s=1.0, busy_s=0.5, device_s={
        "(anonymous namespace)::swar_counts_kernel<1>(Args)": 3e-3,
        "other": 1.0})
    run = run_of([0.01], trace=trace, scanned=1 << 30)
    tiles = 2 + (1 << 30) // 262_144
    want = stats.bound_s(*stats.counts_work(1 << 30, 1, tiles))[0] / 3e-3
    assert read("kernel.counts_roofline", run) == pytest.approx(100 * want)
    assert read("device.idle_pct.search", run) == pytest.approx(50.0)
    assert read("device.idle_pct.open", run) == pytest.approx(50.0)


def _run_py(cwd, env_extra=None):
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="",
               **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "u8_sparse",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


def test_no_card_exits_non_zero_and_prints_no_result():
    proc = _run_py(ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_a_directory_with_only_the_benchmark_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_py(tmp_path, {"PYTHONPATH": ""})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
