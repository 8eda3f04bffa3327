"""The PyTorch port's engine (``SearchEngine(cfg, device="cpu")``, which runs
the kernels' plain versions) against the JAX package's engine on the same
small files, forced onto the device route (``host_latency_threshold_bytes
= 0``): identical offsets, values maps and progress callbacks, and the
same backend-independent ``SearchStats`` counts.  Cases follow
``tests/test_engine.py`` (the reference's engine corpora, the ramp that
overflows the fused step, the pipelined resident path).

Also: the port never loads jax, the default (CUDA) device raises without a
card, and ``chip_smoke.py`` fails without one.

Tolerance: exact equality throughout — every value is an integer.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from monkey_moore_tpu.config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
)
from monkey_moore_tpu.engine import SearchEngine as JaxEngine
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import config as tconfig
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.ops.host import TILE_ELEMS
from monkey_moore_tpu_torch.scan_plan import (
    CandidateRecorder,
    chunk_plan,
    mesh_tile_elems,
)
from test_engine import (
    FILE_DATA_8,
    FILE_DATA_16,
    text_u8,
    text_u16,
    write_file,
)

ROOT = Path(__file__).resolve().parent.parent

STATS = ("hot_tiles", "candidates", "fused_steps", "fused_fallbacks",
         "device_dispatches", "bytes_scanned", "chunks", "d2h_bytes",
         "h2d_bytes")


def _run(engine):
    seen = []
    res = engine.run(on_progress=lambda pct, step: seen.append((pct, step)))
    return res, seen


def assert_same_as_jax(cfg):
    """Run both engines on ``cfg``; returns the port's results."""
    jax_engine = JaxEngine(cfg)
    j_res, j_prog = _run(jax_engine)
    port = SearchEngine(carry_over(cfg), device="cpu")
    t_res, t_prog = _run(port)
    assert [r.offset for r in t_res] == [r.offset for r in j_res]
    assert [r.values_map for r in t_res] == [r.values_map for r in j_res]
    assert t_prog == j_prog
    for name in STATS:
        assert getattr(port.last_stats, name) == getattr(
            jax_engine.last_stats, name), name
    assert not port.last_stats.host_routed
    assert port.last_stats.device_dispatches > 0
    return t_res


@pytest.mark.parametrize("chunk", [64, 16_384])
@pytest.mark.parametrize("semantics", [MatchSemantics.GREEDY,
                                       MatchSemantics.ALL])
def test_reference_corpus_8bit(tmp_path, chunk, semantics):
    cfg = SearchConfig(
        file_path=write_file(tmp_path, FILE_DATA_8), keyword="text",
        preferred_search_block_size=23, device_chunk_bytes=chunk,
        semantics=semantics, host_latency_threshold_bytes=0,
    )
    res = assert_same_as_jax(cfg)
    assert [r.offset for r in res] == [0, 9, 27, 50, 60]


@pytest.mark.parametrize("endianness", [Endianness.LITTLE, Endianness.BIG])
@pytest.mark.parametrize("chunk", [64, 16_384])
def test_reference_corpus_16bit(tmp_path, endianness, chunk):
    kind = "<u2" if endianness is Endianness.LITTLE else ">u2"
    cfg = SearchConfig(
        file_path=write_file(tmp_path, FILE_DATA_16.astype(kind)),
        keyword="text", element_width=2, endianness=endianness,
        preferred_search_block_size=47, device_chunk_bytes=chunk,
        host_latency_threshold_bytes=0,
    )
    res = assert_same_as_jax(cfg)
    assert [r.offset for r in res] == [0, 18, 54, 100, 120]


@pytest.mark.parametrize("semantics", [MatchSemantics.ALL,
                                       MatchSemantics.GREEDY])
def test_ramp_overflow_fallback(tmp_path, semantics):
    # ``tests/test_engine.py:403``: a byte ramp matches "abcde" at nearly
    # every window, overflowing p_cap — every chunk takes the fallback
    data = (np.arange(8192) & 0xFF).astype(np.uint8)
    cfg = SearchConfig(
        file_path=write_file(tmp_path, data), keyword="abcde",
        device_chunk_bytes=4096, semantics=semantics,
        host_latency_threshold_bytes=0,
    )
    res = assert_same_as_jax(cfg)
    assert len(res) > 1000
    assert SearchEngine(carry_over(cfg), device="cpu").run() == res


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("resident", [True, False])
def test_pipelined_chunks(tmp_path, width, resident):
    # ``tests/test_engine.py:514``: many 16 KiB chunks, two steps in flight;
    # resident_bytes_limit=0 takes the streaming (per-chunk upload) branch
    rng = np.random.default_rng(11)
    dtype = np.uint8 if width == 1 else np.uint16
    data = rng.integers(0, 1 << (8 * width), 120_000).astype(dtype)
    enc = (text_u8 if width == 1 else text_u16)("monkey", 3)
    for pos in (0, 30_001, 59_999, 90_000, len(data) - 6):
        data[pos : pos + 6] = enc.astype(dtype)
    cfg = SearchConfig(
        file_path=write_file(tmp_path, data.astype(f"<u{width}")),
        keyword="monkey", element_width=width, device_chunk_bytes=16_384,
        host_latency_threshold_bytes=0, pipeline_depth=2,
        resident_bytes_limit=(12 << 30) if resident else 0,
    )
    res = assert_same_as_jax(cfg)
    assert [r.offset for r in res] == [
        0, 30_001 * width, 59_999 * width, 90_000 * width,
        (len(data) - 6) * width,
    ]


@pytest.mark.parametrize("endianness", [Endianness.LITTLE, Endianness.BIG])
@pytest.mark.parametrize("width", [1, 2])
def test_streaming_takes_element_step(tmp_path, monkeypatch, width,
                                      endianness):
    """resident_bytes_limit=0: every chunk is uploaded as elements and runs
    kernels D and L (their plain versions here), never A, B or E."""
    from monkey_moore_tpu_torch.ops import scan_cuda

    calls = {"tile_counts_elems": 0, "hot_combo": 0, "gather_tiles_block": 0,
             "tile_counts": 0, "gather_tiles": 0}

    def spy(name):
        real = getattr(scan_cuda, name)

        def wrapper(data, *args, **kwargs):
            assert data.dtype in (torch.uint8, torch.uint16) or name in (
                "tile_counts", "gather_tiles")
            calls[name] += 1
            return real(data, *args, **kwargs)

        monkeypatch.setattr(scan_cuda, name, wrapper)

    for name in calls:
        spy(name)
    rng = np.random.default_rng(12)
    dtype = np.uint8 if width == 1 else np.uint16
    data = rng.integers(0, 1 << (8 * width), 50_000).astype(dtype)
    enc = (text_u8 if width == 1 else text_u16)("dra*on", 5)
    enc[3] = 77  # wildcard position: arbitrary value
    for pos in (3, 16_380, 33_333, len(data) - 6):
        data[pos : pos + 6] = enc.astype(dtype)
    kind = f"{'<' if endianness is Endianness.LITTLE else '>'}u{width}"
    cfg = SearchConfig(
        file_path=write_file(tmp_path, data.astype(kind).view(np.uint8)),
        keyword="dra*on", wildcard="*", element_width=width,
        endianness=endianness, device_chunk_bytes=8192,
        host_latency_threshold_bytes=0, resident_bytes_limit=0,
    )
    res = assert_same_as_jax(cfg)
    assert [r.offset for r in res] == [
        3 * width, 16_380 * width, 33_333 * width, (len(data) - 6) * width]
    assert calls["tile_counts_elems"] == calls["hot_combo"] > 0
    assert calls["tile_counts"] == calls["gather_tiles"] == 0
    assert calls["gather_tiles_block"] == 0


def test_wildcard_16bit_big_endian(tmp_path):
    rng = np.random.default_rng(6)
    data = rng.integers(0, 65536, 80_000).astype(np.uint16)
    enc = text_u16("dra?on", -16)
    enc[3] = 12345  # wildcard position: arbitrary value
    for pos in (17, 40_000, len(data) - 6):
        data[pos : pos + 6] = enc
    cfg = SearchConfig(
        file_path=write_file(tmp_path, data.astype(">u2").view(np.uint8)),
        keyword="dra?on", wildcard="?", element_width=2,
        endianness=Endianness.BIG, device_chunk_bytes=16_384,
        host_latency_threshold_bytes=0,
    )
    res = assert_same_as_jax(cfg)
    assert 34 in [r.offset for r in res]


def test_all_wildcard_keyword(tmp_path):
    data = np.random.default_rng(7).integers(0, 256, 700).astype(np.uint8)
    cfg = SearchConfig(
        file_path=write_file(tmp_path, data), keyword="a***",
        device_chunk_bytes=256, host_latency_threshold_bytes=0,
    )
    assert len(assert_same_as_jax(cfg)) > 100


def test_abort_mid_pipeline(tmp_path):
    flag = threading.Event()

    def saboteur(pct, step):
        if step is tconfig.SearchStep.SEARCHING and pct >= 40:
            flag.set()

    cfg = tconfig.SearchConfig(
        file_path=write_file(tmp_path, np.zeros(200_000, dtype=np.uint8)),
        keyword="never", device_chunk_bytes=16_384,
        host_latency_threshold_bytes=0, pipeline_depth=3,
    )
    engine = SearchEngine(cfg, device="cpu")
    assert engine.run(on_progress=saboteur, abort_flag=flag) == []


# ---- block progress with and without a listener --------------------------------

#: the engine's four routes over a multi-chunk file: config keywords
ROUTES = {
    "dense": dict(host_latency_threshold_bytes=0, pipeline_depth=2),
    "host": dict(),
    "reference": dict(semantics=tconfig.MatchSemantics.REFERENCE,
                      preferred_num_threads=2),
    "mesh": dict(devices=["cpu"] * 4, host_latency_threshold_bytes=0),
}


def _route_config(tmp_path, route):
    rng = np.random.default_rng(24)
    data = rng.integers(0, 256, 70_000).astype(np.uint8)
    for pos in (5, 16_383, 40_001, 69_990):
        data[pos : pos + 6] = text_u8("monkey", 7)
    return tconfig.SearchConfig(
        file_path=write_file(tmp_path, data), keyword="monkey",
        preferred_search_block_size=1000, device_chunk_bytes=16_384,
        **ROUTES[route])


def _fresh_run(cfg, **kwargs):
    """A run with no corpus held from an earlier one (so both runs upload
    and count the same bytes); returns its results and stats."""
    from monkey_moore_tpu_torch import corpus
    from monkey_moore_tpu_torch.parallel import resident

    corpus.clear_corpus_cache()
    resident.clear_sharded_corpus_cache()
    engine = SearchEngine(cfg, device="cpu")
    return engine.run(**kwargs), engine.last_stats


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_results_and_stats_do_not_depend_on_a_listener(tmp_path, route):
    cfg = _route_config(tmp_path, route)
    seen = []
    quiet, quiet_stats = _fresh_run(cfg)
    heard, heard_stats = _fresh_run(
        cfg, on_progress=lambda pct, step: seen.append((pct, step)))
    assert [(r.offset, r.values_map) for r in quiet] == [
        (r.offset, r.values_map) for r in heard]
    assert [r.offset for r in quiet] == [5, 16_383, 40_001, 69_990]
    for f in dataclasses.fields(quiet_stats):
        if f.name not in ("stage_seconds", "record"):
            assert getattr(quiet_stats, f.name) == getattr(
                heard_stats, f.name), f.name
    assert quiet_stats.host_routed == (route == "host")
    # one SEARCHING callback a block, 70 blocks of 1000 bytes
    searching = [p for p, st in seen if st is tconfig.SearchStep.SEARCHING]
    assert len(searching) == 1 + 70 and searching[-1] == 100


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_abort_without_a_listener_returns_nothing(tmp_path, route):
    checks = []

    def abort_after_first_check():
        checks.append(1)
        return len(checks) > 1

    cfg = _route_config(tmp_path, route)
    size = os.path.getsize(cfg.file_path)
    assert chunk_plan(size, 1, 6, cfg.device_chunk_bytes).n_chunks > 1
    results, _ = _fresh_run(cfg, abort_flag=abort_after_first_check)
    assert results == [] and len(checks) >= 2


def test_no_listener_checks_the_abort_once_a_mark():
    from monkey_moore_tpu_torch.engine import _BlockProgress

    checks = []
    base = 524_288
    tracker = _BlockProgress(8966, base, None,
                             lambda: checks.append(1) is not None)
    for k in range(1, 10):
        assert tracker.advance_to(k * 1000 * base, final=k == 9)
        assert len(checks) <= k
    assert tracker.done == 8966 and tracker.finish()
    assert len(checks) <= 9


@pytest.mark.parametrize("resident", [True, False])
def test_only_a_route_that_reads_the_file_maps_it(tmp_path, monkeypatch,
                                                  resident):
    maps = []
    real = np.memmap

    def counting(*args, **kwargs):
        maps.append(args[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(np, "memmap", counting)
    cfg = _route_config(tmp_path, "dense")
    if not resident:
        cfg = dataclasses.replace(cfg, resident_bytes_limit=0)
    results, _ = _fresh_run(cfg, generate_previews=True)
    assert [r.offset for r in results] == [5, 16_383, 40_001, 69_990]
    assert all(r.preview for r in results)
    assert len(maps) == (0 if resident else 1)


@pytest.mark.parametrize("listener", [False, True])
def test_block_counters_under_a_profiler(tmp_path, listener):
    base = 64
    data = np.random.default_rng(25).integers(0, 256, 8966 * base)
    cfg = tconfig.SearchConfig(
        file_path=write_file(tmp_path, data.astype(np.uint8)),
        keyword="monkey", preferred_search_block_size=base,
        device_chunk_bytes=65_536, host_latency_threshold_bytes=0)
    calls = []
    kwargs = {"on_progress": lambda p, st: calls.append(p)} if listener \
        else {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _, stats = _fresh_run(cfg, **kwargs)
    counters = stats.record.counters
    assert counters["engine.blocks"] == 8966
    assert counters["engine.progress_calls"] == (8966 if listener else 0)
    assert len(calls) == (8966 + 3 if listener else 0)
    assert "mm.engine.progress" in {s.name for s in stats.record.spans}


def _old_chunk_geometry(file_size, s, L, chunk_bytes):
    """The engine's chunk arithmetic and step rules as they were written
    inline before ``scan_plan``: (tile_elems, chunk_elems, want, n_chunks)
    and a function of chunk k giving its (a, e0, count_here) steps."""
    size_bucket = 1 << (max(file_size, 1) - 1).bit_length()
    desired = max(L, min(chunk_bytes, size_bucket) // s)
    tile_elems = min(TILE_ELEMS, 1 << (desired - 1).bit_length())
    tiles_per_chunk = max(1, desired // tile_elems)
    chunk_elems = tiles_per_chunk * tile_elems
    want = (tiles_per_chunk + 1) * tile_elems

    def grid(a):
        return max(0, (file_size - a) // s)

    n_chunks = max(1, -(-max((grid(a) for a in range(s)), default=0)
                        // chunk_elems))

    def steps(k):
        out = []
        e0 = k * chunk_elems
        for a in range(s):
            n_a = grid(a)
            if e0 >= n_a:
                continue
            count_here = min(chunk_elems + L - 1, n_a - e0)
            if count_here < L:
                continue
            out.append((a, e0, count_here))
        return out

    return (tile_elems, chunk_elems, want, n_chunks), steps


def _old_mesh_tile(file_size, n_dev, L):
    per_dev = -(-max(1, file_size) // n_dev)
    return min(TILE_ELEMS, max(64, 1 << (per_dev - 1).bit_length(),
                               1 << (L - 1).bit_length()))


DVD5_BYTES = 4_700_372_992


@pytest.mark.parametrize("chunk_bytes", [16_384, 1 << 20, 512 << 20])
@pytest.mark.parametrize("length", [1, 5, TILE_ELEMS])
@pytest.mark.parametrize("width", [1, 2])
def test_chunk_plan_equals_the_old_arithmetic(width, length, chunk_bytes):
    """``scan_plan.chunk_plan``, ``ChunkPlan.steps`` and
    ``mesh_tile_elems`` against the arithmetic the engine and the batch
    searcher wrote inline, from an empty file to a DVD-5 image (the steps of
    the first 40 and the last 3 chunks of each)."""
    tile = TILE_ELEMS * width
    sizes = (0, 1, length - 1, tile - 1, tile, tile + 1, 2**31 - 3,
             2**31 + 3, DVD5_BYTES)
    for file_size in sorted({max(0, n) for n in sizes}):
        want, old_steps = _old_chunk_geometry(file_size, width, length,
                                              chunk_bytes)
        plan = chunk_plan(file_size, width, length, chunk_bytes)
        assert (plan.tile_elems, plan.chunk_elems, plan.want,
                plan.n_chunks) == want, file_size
        n = plan.n_chunks
        for k in sorted(set(range(min(n, 40))) | {n - 3, n - 2, n - 1}):
            if k >= 0:
                assert list(plan.steps(k, length)) == old_steps(k), (
                    file_size, k)
        for n_dev in (1, 2, 3, 4, 8):
            assert mesh_tile_elems(file_size, n_dev, length) == (
                _old_mesh_tile(file_size, n_dev, length)), (file_size, n_dev)


def _old_record(per_group, info, s, base, a, e0, offs, vals, span_elems,
                own_bytes):
    """The engine's per-step candidate recording as it was written inline
    (``record_step``)."""
    keep = offs < span_elems
    offs, vals = offs[keep], vals[keep]
    kept = 0
    for off, val in zip(offs.tolist(), vals.tolist()):
        e_global = e0 + off
        byte_off = a + e_global * s
        if own_bytes is not None and not (
                own_bytes[0] <= byte_off < own_bytes[1]):
            continue
        kept += 1
        per_group.setdefault((byte_off // base, a), []).append(e_global)
        info[(a, e_global)] = (byte_off, val)
    return kept


def _old_gathered(gather, info_in, s, base):
    """The engine's ``_gathered_groups`` as it was, without the stage."""
    items = sorted(info_in.items())
    offs = np.array([v[0] for _, v in items], dtype=np.int64)
    vals = np.array([list(v[1]) for _, v in items],
                    dtype=np.int64).reshape(-1, 2)
    offs, vals = gather(offs, vals)
    per_group, info = {}, {}
    for byte_off, val in zip(offs.tolist(), vals.tolist()):
        a = byte_off % s
        e_global = (byte_off - a) // s
        per_group.setdefault((byte_off // base, a), []).append(e_global)
        info[(a, e_global)] = (byte_off, val)
    return per_group, info


@pytest.mark.parametrize("own", [None, (3_000, 41_000)],
                         ids=["all", "own-bytes"])
@pytest.mark.parametrize("s", [1, 2])
def test_candidate_recorder_equals_the_old_grouping(s, own):
    """``scan_plan.CandidateRecorder`` against the inline grouping of the
    engine's steps (spans of 4,096 starts with a halo past them), with and
    without a multi-host byte range, and after a gathered rebuild with a
    second process's candidates."""
    from monkey_moore_tpu_torch.profiling import StageTimer

    rng = np.random.default_rng(23 + s)
    base, span_elems = 1_000, 4_096
    rec = CandidateRecorder(s, base, own)
    per_group, info = {}, {}
    for e0 in range(0, 24_000, span_elems):
        for a in range(s):
            offs = np.unique(rng.integers(0, span_elems + 9, 60))
            vals = rng.integers(0, 256, (len(offs), 2))
            want = _old_record(per_group, info, s, base, a, e0, offs, vals,
                               span_elems, own)
            assert rec.add(a, e0, offs, vals, below=span_elems) == want
    assert rec.per_group == per_group and rec.candidate_info == info
    assert info
    if own is not None:
        assert all(own[0] <= b < own[1] for b, _ in info.values())

    other = np.unique(rng.integers(0, 48_000, 50))
    other_vals = rng.integers(0, 256, (len(other), 2))

    def gather(offs, vals):
        return (np.concatenate([offs, other]),
                np.concatenate([vals, other_vals]))

    got = rec.gathered(gather, StageTimer())
    want_groups, want_info = _old_gathered(gather, info, s, base)
    assert got.per_group == want_groups
    assert got.candidate_info == want_info


def test_unported_routes_raise(tmp_path):
    """Meshes and multi-host search are ported: a JAX device in
    ``devices`` raises ``TypeError`` (the port's meshes hold torch
    devices), and a device with no kernels still raises."""
    import jax

    cfg = tconfig.SearchConfig(file_path=write_file(tmp_path, FILE_DATA_8),
                               keyword="text", host_latency_threshold_bytes=0)
    # one process: a distributed run is a plain run
    assert [r.offset for r in SearchEngine(cfg, device="cpu").run(
        distributed=True)] == [0, 9, 27, 50, 60]
    cfg.devices = jax.devices()[:2]
    with pytest.raises(TypeError, match="torch.device"):
        SearchEngine(cfg, device="cpu").run()
    with pytest.raises(TypeError, match="devices"):
        carry_over(SearchConfig(file_path=cfg.file_path, keyword="text",
                                devices=jax.devices()[:2]))
    cfg.devices = ["cpu"] * 2
    assert [r.offset for r in SearchEngine(cfg, device="cpu").run()] == [
        0, 9, 27, 50, 60]
    with pytest.raises(RuntimeError):
        SearchEngine(cfg, device="meta")


def test_device_trace_writes_a_trace(tmp_path, monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MMTPU_TRACE_DIR", str(trace_dir))
    cfg = tconfig.SearchConfig(file_path=write_file(tmp_path, FILE_DATA_8),
                               keyword="text", host_latency_threshold_bytes=0)
    res = SearchEngine(cfg, device="cpu").run()
    assert [r.offset for r in res] == [0, 9, 27, 50, 60]
    assert len(list(trace_dir.glob("trace_*.json"))) == 1


def test_device_trace_inside_a_running_profiler_starts_none(tmp_path,
                                                           monkeypatch):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MMTPU_TRACE_DIR", str(trace_dir))
    cfg = tconfig.SearchConfig(file_path=write_file(tmp_path, FILE_DATA_8),
                               keyword="text", host_latency_threshold_bytes=0)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = SearchEngine(cfg, device="cpu").run()
    assert [r.offset for r in res] == [0, 9, 27, 50, 60]
    assert not trace_dir.exists()  # the running profiler's owner writes
    assert {"mm.search", "mm.engine.finalize"} <= {
        e.name for e in prof.events()}
    # alone, the run's own trace holds the whole run, its tail included
    SearchEngine(cfg, device="cpu").run()
    (path,) = trace_dir.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert {"mm.search", "mm.engine.finalize", "mm.engine.results"} <= names


def test_probe_reports_without_cuda():
    from monkey_moore_tpu_torch.ops.probe import probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    got = probe()
    assert got.cuda is False and got.library is None


def test_probe_runs_no_kernels_without_cuda():
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.ops.probe import probe

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    before = dict(scan_cuda.launch_counts)
    got = probe()
    assert got.kernels == () and got.error is None
    assert scan_cuda.launch_counts == before


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SearchEngine(tconfig.SearchConfig(keyword="text"))


def port_subprocess_env():
    """The environment of a torch process that a port test starts: the repo
    on the path, and one thread.  Each torch process otherwise opens an
    intra-op pool as wide as the machine, and a test run's parallel workers
    with their own children then share the cores many times over."""
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                MKL_NUM_THREADS="1")


#: every no-jax case's first line, and what it asserts after its entry
#: point has run
_NO_JAX_HEAD = "import os, sys\n"
_NO_JAX_TAIL = """
assert "jax" not in sys.modules, "the port loaded jax"
loaded = sorted(m for m in sys.modules if m == "monkey_moore_tpu"
                or m.startswith("monkey_moore_tpu."))
assert not loaded, f"the port loaded the JAX package: {loaded}"
print("no-jax ok")
"""

#: id -> (time limit in s, script run with the 8-bit test file as argv[1]).
#: Each limit is about 20x the case's slowest wall time of three runs alone
#: with one thread on an 8-core x86 host (beside each case), and never under
#: 10x.
_NO_JAX = {
    # alone: 3.7 s; limit 90 s
    "searches": (90, """
import numpy as np
from monkey_moore_tpu_torch.config import SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.multi import MultiSearcher
from monkey_moore_tpu_torch.dense import dense_search
from monkey_moore_tpu_torch.pattern import compile_pattern
cfg = SearchConfig(file_path=sys.argv[1], keyword="text",
                   device_chunk_bytes=64, host_latency_threshold_bytes=0)
offsets = [r.offset for r in SearchEngine(cfg, device="cpu").run()]
assert offsets == [0, 9, 27, 50, 60], offsets
batch = MultiSearcher(sys.argv[1], device="cpu").search(["text", "none"])
assert [r.offset for r in batch[0]] == offsets, batch
data = np.fromfile(sys.argv[1], dtype=np.uint8)
found = dense_search(compile_pattern("text"), data, device="cpu")
assert [o for o, _ in found] == offsets, found
from monkey_moore_tpu_torch.parallel import resident, sharded, multihost
cfg.devices = ["cpu"] * 4
mesh = [r.offset for r in SearchEngine(cfg, device="cpu").run()]
assert mesh == offsets, mesh
batch = MultiSearcher(sys.argv[1], device="cpu", devices=["cpu"] * 2).search(
    ["text", "none"])
assert [r.offset for r in batch[0]] == offsets, batch
"""),
    # alone: 8.6 s; limit 180 s
    "bench_scaling": (180, """
from monkey_moore_tpu_torch import bench_scaling
assert bench_scaling.main(["--device", "cpu", "--mb", "1", "--iters", "1",
                           "--devices", "1", "2"]) == 0
"""),
    # alone: 6.1 s; limit 120 s
    "bench": (120, """
from monkey_moore_tpu_torch import bench
os.environ.update(MMTPU_BENCH_ITERS="3", MMTPU_BENCH_WARMUP="1")
assert bench.main(["--device", "cpu", "--mb", "4"]) == 0
"""),
    # alone: 6.4 s; limit 120 s
    "perf_probe": (120, """
from monkey_moore_tpu_torch import perf_probe
assert perf_probe.main(["--device", "cpu", "--mb", "4", "--iters", "1",
                        "--stage", "sol,fused,ab"]) == 0
"""),
    # alone: 4.4 s; limit 90 s
    "bench_all": (90, """
from monkey_moore_tpu_torch import bench_all
out = os.path.join(os.path.dirname(sys.argv[1]), "harness.json")
assert bench_all.main(["--device", "cpu", "--mb", "1", "--iters", "1",
                       "--warmup", "0", "--no-sweep", "--json", out]) == 0
"""),
    # alone: 14.5 s; limit 300 s
    "bench_baseline_configs": (300, """
from monkey_moore_tpu_torch import bench_baseline_configs
out = os.path.join(os.path.dirname(sys.argv[1]), "harness.json")
assert bench_baseline_configs.main(["--cpu", "--scale", "1024", "--iters",
                                    "1", "--json", out]) == 0
"""),
    # alone: 4.9 s; limit 100 s
    "graft_entry": (100, """
from monkey_moore_tpu_torch import graft_entry
from monkey_moore_tpu_torch.parallel import sharded_candidates
fn, args = graft_entry.entry(device="cpu")
assert int(fn(*args)[0]) == 0
graft_entry.dryrun_multichip(2, device="cpu")
"""),
    # alone: 3.9 s; limit 90 s
    "import_all": (90, """
import importlib, pkgutil
from pathlib import Path
import monkey_moore_tpu_torch as port
names = sorted(m.name for m in pkgutil.walk_packages(
    port.__path__, "monkey_moore_tpu_torch.")
    if m.name != "monkey_moore_tpu_torch.__main__")
root = Path(port.__file__).parent
files = sorted(".".join(("monkey_moore_tpu_torch",) + p.relative_to(
    root).with_suffix("").parts).removesuffix(".__init__")
    for p in root.rglob("*.py") if p.name != "__main__.py")
files.remove("monkey_moore_tpu_torch")
assert names == files, (names, files)
for name in names:
    importlib.import_module(name)
"""),
}


@pytest.mark.parametrize("case", list(_NO_JAX), ids=list(_NO_JAX))
def test_port_never_imports_jax(case, tmp_path):
    """In a fresh single-threaded process, one entry point of the port: the
    engine (on one device and on a mesh), a keyword batch (on one device and
    on a mesh) and ``dense_search``; the mesh-size bench; a CPU bench; a CPU
    perf_probe run (``ab`` among its stages); a small ``bench_all``; a small
    ``bench_baseline_configs`` (its multi-host workers included); the
    graft entry points (``graft_entry.entry`` and ``dryrun_multichip`` on
    two CPU shards); or an import of every module of the package but
    ``__main__`` (which would run the CLI).  None loads jax or any module
    of the JAX package."""
    limit, script = _NO_JAX[case]
    path = write_file(tmp_path, FILE_DATA_8)
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_HEAD + script + _NO_JAX_TAIL,
         str(path)],
        cwd=ROOT, env=port_subprocess_env(), capture_output=True, text=True,
        timeout=limit,
    )
    assert proc.returncode == 0, proc.stderr
    assert "no-jax ok" in proc.stdout


def _foreign_imports(path: Path):
    """(line, module) of every import of jax or of the JAX package in the
    Python file *path*."""
    import ast

    def foreign(name):
        return any(name == root or name.startswith(root + ".")
                   for root in ("jax", "jaxlib", "monkey_moore_tpu"))

    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if foreign(node.module or ""):
                found.append((node.lineno, node.module))
    return found


PORT_FILES = sorted((ROOT / "monkey_moore_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_files_import_no_jax_package(path):
    assert _foreign_imports(path) == []


def test_foreign_import_check_finds_them(tmp_path):
    path = tmp_path / "bad.py"
    path.write_text("import jax.numpy as jnp\nimport os\n"
                    "from monkey_moore_tpu.config import SearchConfig\n"
                    "from monkey_moore_tpu_torch import dense\n"
                    "def f():\n    import monkey_moore_tpu\n")
    assert _foreign_imports(path) == [
        (1, "jax.numpy"), (3, "monkey_moore_tpu.config"),
        (6, "monkey_moore_tpu")]


def test_chip_smoke_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the smoke run would start")
    # alone, one thread: 3.8 s; limit 120 s
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=tmp_path,
        env=port_subprocess_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


_BREAKDOWN = """
import sys
from monkey_moore_tpu_torch import breakdown
rc = breakdown.main([])
assert "jax" not in sys.modules, "the breakdown loaded jax"
sys.exit(rc)
"""


def test_breakdown_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the breakdown would start")
    # alone, one thread: 4.1 s; limit 120 s
    proc = subprocess.run(
        [sys.executable, "-c", _BREAKDOWN], cwd=ROOT,
        env=port_subprocess_env(), capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 1, proc.stderr
    assert "no CUDA device" in proc.stderr and proc.stdout == ""
