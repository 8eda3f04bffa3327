"""The conformance gate on the port (``monkey_moore_tpu_torch.conformance``)
against the JAX package's gate, ``tools/conformance_gate.py``.

- Its trial generator draws the tool's cases: ``_gen_trial`` equals the
  tool's over hundreds of draws on several seeds.
- ``run_gate`` on the CPU (the kernels' plain versions) reports no failure
  at a small trial count, on all three routes (host, forced device and
  the tool's mesh), and reaches the plain versions of kernels A, B and C;
  its streaming pass takes the streaming branch in the mesh's place and
  reaches A, B, D and E.
- Its summary line equals the tool's on the same seed: the same cases,
  checks and known divergences.
- The ``--json`` artifact and the exit without a card.

Tolerance: exact equality — draws, counts and text.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from monkey_moore_tpu_torch import conformance
from monkey_moore_tpu_torch.ops import scan_cuda

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location(
        "_conformance_gate_tool", ROOT / "tools" / "conformance_gate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_modes_equal(tool):
    assert conformance.MODES == tool.MODES
    assert conformance.MODE_WEIGHTS == tool.MODE_WEIGHTS


@pytest.mark.parametrize("seed", [7, 424242, 1, 2026])
@pytest.mark.parametrize("mod", [256, 65536])
def test_gen_trial_draws_the_tools_cases(tool, seed, mod):
    want_rng = np.random.default_rng(seed)
    got_rng = np.random.default_rng(seed)
    for _ in range(300):
        want = tool._gen_trial(want_rng, mod)
        got = conformance._gen_trial(got_rng, mod)
        assert got == want
    # the generators are in the same state afterwards
    assert got_rng.integers(0, 1 << 30) == want_rng.integers(0, 1 << 30)


def _spy_plain(monkeypatch):
    """Count the calls of the plain versions of kernels A-E and L (a
    wrapper calls its plain version for a CPU tensor)."""
    calls = {}
    for name in ("tile_counts_plain", "gather_tiles_plain",
                 "tile_counts_multi_plain", "tile_counts_elems_plain",
                 "gather_tiles_block_plain", "hot_combo_plain"):
        real = getattr(scan_cuda, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*args, **kwargs)

        monkeypatch.setattr(scan_cuda, name, spy)
    return calls


def _spy_routes(monkeypatch):
    """The routes the gate's engine runs take: host, resident, stream or
    mesh."""
    from monkey_moore_tpu_torch import engine

    routes = set()
    real_run = engine.SearchEngine.run

    def run(self, *args, **kwargs):
        out = real_run(self, *args, **kwargs)
        stats = self.last_stats
        if stats.host_routed:
            routes.add("host")
        elif self.config.devices:
            routes.add("mesh")
        elif stats.fused_steps:
            routes.add("stream" if self.config.resident_bytes_limit == 0
                       else "resident")
        return out

    monkeypatch.setattr(engine.SearchEngine, "run", run)
    return routes


def test_run_gate_on_the_cpu_passes_on_every_route(monkeypatch):
    """The streaming pass: the tool's cases with the engine's streaming
    branch in the mesh's place."""
    routes = _spy_routes(monkeypatch)
    calls = _spy_plain(monkeypatch)
    result = conformance.run_gate(trials=12, seed=3, multi_trials=3,
                                  device="cpu", streaming=True)
    assert result["failed"] == 0, result["failures"]
    assert result["passed"] > 30 and result["multi_checked"] > 0
    assert sum(result["mode_counts"].values()) == 12
    assert routes == {"host", "resident", "stream"}
    for name in ("tile_counts_plain", "tile_counts_elems_plain",
                 "hot_combo_plain"):
        assert calls.get(name, 0) > 0, calls
    for name in ("gather_tiles_plain", "gather_tiles_block_plain"):
        assert calls.get(name, 0) == 0, calls


@pytest.mark.parametrize("seed", [3, 8])
def test_run_gate_takes_the_mesh(monkeypatch, seed):
    """The default pass: ``t % 3 == 2`` runs on ``[device] * n`` with the
    tool's draw of n — the resident mesh route, kernels A and L on every
    shard — with no failure."""
    routes = _spy_routes(monkeypatch)
    calls = _spy_plain(monkeypatch)
    result = conformance.run_gate(trials=9, seed=seed, multi_trials=3,
                                  device="cpu")
    assert result["failed"] == 0, result["failures"]
    assert result["multi_checked"] > 0
    assert routes == {"host", "resident", "mesh"}
    for name in ("tile_counts_plain", "hot_combo_plain"):
        assert calls.get(name, 0) > 0, calls
    assert calls.get("tile_counts_elems_plain", 0) == 0, calls
    assert calls.get("gather_tiles_plain", 0) == 0, calls


def test_summary_equals_the_tools(tool, capsys, monkeypatch):
    """Seed 5, 12 trials and 3 batch trials: the tool (JAX on the CPU, its
    mesh route on the virtual devices) and the port (its mesh of the CPU
    repeated the tool's number of times) print the same summary line."""
    monkeypatch.setattr("sys.argv", ["conformance_gate.py", "--cpu",
                                     "--trials", "12", "--multi-trials", "3",
                                     "--seed", "5"])
    assert tool.main() == 0
    want = capsys.readouterr().out.splitlines()[0]
    got = conformance.summary_line(conformance.run_gate(
        trials=12, seed=5, multi_trials=3, device="cpu"))
    assert got == want
    assert "1 known-divergence" in got


def test_json_artifact(tmp_path, capsys):
    out = tmp_path / "gate.json"
    rc = conformance.main(["--cpu", "--trials", "4", "--multi-trials", "1",
                           "--seed", "11", "--json", str(out)])
    text = capsys.readouterr().out
    assert rc == 0 and text.startswith("conformance: ")
    assert f"written: {out}" in text
    record = json.loads(out.read_text())
    assert list(record) == [
        "date", "backend", "device_kind", "n_devices", "trials", "seed",
        "checks_passed", "checks_failed", "known_divergence",
        "pass_rate_pct", "mode_counts", "routes", "failures"]
    assert (record["backend"], record["device_kind"],
            record["n_devices"]) == ("cpu", "cpu", 1)
    assert (record["trials"], record["seed"]) == (4, 11)
    assert record["checks_failed"] == 0 and record["failures"] == []
    assert sum(record["mode_counts"].values()) == 4
    assert "mesh" in record["routes"] and "streaming" in record["routes"]


def test_no_card_exits_1_naming_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the gate would run")
    assert conformance.main(["--trials", "2"]) == 1
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err
    with pytest.raises(RuntimeError, match="CUDA"):
        conformance.run_gate(trials=1)


# ---- faults the gate found on the card ---------------------------------------


class _CudaIndexing(torch.Tensor):
    """A CPU tensor that refuses to index a uint16 tensor, as CUDA does
    ("index_cuda" has no UInt16 kernel)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if (func is torch.Tensor.__getitem__
                and args[0].dtype == torch.uint16
                and isinstance(args[1], torch.Tensor)):
            raise NotImplementedError(
                '"index_cuda" not implemented for \'UInt16\'')
        return super().__torch_function__(func, types, args, kwargs or {})


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_hot_tile_fetch_of_16_bit_elements(dtype):
    """The batch's element route fetches hot tiles from the corpus's u16
    grid on the card (the gate's 16-bit batch trials): the fetch must not
    index a uint16 tensor, and must equal the host extraction."""
    from monkey_moore_tpu_torch.dense import extract_hot_tiles_device
    from monkey_moore_tpu_torch.ops.host import extract_hot_tiles
    from monkey_moore_tpu_torch.pattern import compile_pattern

    pat = compile_pattern("monkey", dtype=dtype)
    te = 64
    arr = np.random.default_rng(9).integers(
        0, np.iinfo(dtype).max + 1, 20 * te).astype(dtype)
    for pos in (5, 3 * te - 2, 17 * te + 40):
        arr[pos : pos + 6] = [ord(c) + 44 for c in "monkey"]
    counts = np.zeros(19, np.int32)
    counts[[0, 2, 17]] = 1
    device_arr = torch.from_numpy(arr).as_subclass(_CudaIndexing)
    got = extract_hot_tiles_device(pat, device_arr, counts, 19 * te, te)
    want = extract_hot_tiles(pat, arr[: 19 * te], counts, te)
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert got[0].tolist() == [5, 3 * te - 2, 17 * te + 40]
