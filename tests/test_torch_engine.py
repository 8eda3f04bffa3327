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
    kernels D and E (their plain versions here), never A or B."""
    from monkey_moore_tpu_torch.ops import scan_cuda

    calls = {"tile_counts_elems": 0, "gather_tiles_block": 0,
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
    assert calls["tile_counts_elems"] == calls["gather_tiles_block"] > 0
    assert calls["tile_counts"] == calls["gather_tiles"] == 0


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
    ``bench_baseline_configs`` (its multi-host workers included); or an
    import of every module of the package but ``__main__`` (which would run
    the CLI).  None loads jax or any module of the JAX package."""
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
