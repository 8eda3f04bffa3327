"""The port's harnesses on the CPU, against the JAX package's tools:

- ``bench_baseline_configs --cpu --scale 64 --iters 1`` against
  ``tools/bench_baseline_configs.py`` with the same arguments (run in a
  subprocess): every row's ``config``, ``size_bytes``, ``route``,
  ``results`` and ``planted_found`` equal, and the five fields of
  ``multi_shard``; the port's ``multi_host`` clause (two gloo workers)
  finds the plants and equals the single-process offsets;
- ``perf_probe --stage ab``: the three gather records of
  ``tools/perf_probe.py``'s part (b), with equal ``hot`` and ``fallback``,
  and the three gathers' combo buffers equal to the default path's (kernel
  B's plain version) at both widths, with hot tiles past ``k_cap`` too;
- ``tui_smoke --cpu`` drives the port's TUI through a pty: exit 0 and its
  eight checks OK (skipped only without a pty or the ``xterm`` terminfo).

Inputs are made with numpy and a seeded ``torch.Generator``.  Tolerance:
exact equality — every value is an integer.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from monkey_moore_tpu_torch import bench, bench_baseline_configs, perf_probe
from monkey_moore_tpu_torch.dense import fused_count_extract_start
from monkey_moore_tpu_torch.ops.host import LANES
from monkey_moore_tpu_torch.ops.scan_cuda import GATHER_MODES
from monkey_moore_tpu_torch.pattern import compile_pattern
from test_torch_engine import port_subprocess_env

ROOT = Path(__file__).resolve().parent.parent
ROW_KEYS = ("config", "size_bytes", "route", "results", "planted_found")
SHARD_KEYS = ("planted_found", "repeat_identical", "device_dispatches",
              "h2d_bytes_repeat", "ici_halo_bytes")


def test_baseline_configs_equal_the_jax_tool(tmp_path):
    args = ["--cpu", "--scale", "64", "--iters", "1"]
    jax_out = tmp_path / "jax.json"
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "bench_baseline_configs.py"),
         *args, "--json", str(jax_out)], cwd=ROOT, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    port_out = tmp_path / "port.json"
    assert bench_baseline_configs.main([*args, "--json", str(port_out)]) == 0
    want, got = (json.loads(p.read_text()) for p in (jax_out, port_out))
    assert len(got["rows"]) == len(want["rows"]) == 6
    for g, w in zip(got["rows"], want["rows"]):
        assert {k: g[k] for k in ROW_KEYS} == {k: w[k] for k in ROW_KEYS}
        assert set(g) - set(w) == {"kernels"} | (
            {"multi_host"} if "multi_shard" in g else set())
    shard, jshard = got["rows"][-1]["multi_shard"], want["rows"][-1][
        "multi_shard"]
    assert {k: shard[k] for k in SHARD_KEYS} == {k: jshard[k]
                                                for k in SHARD_KEYS}
    assert shard["n_devices"] == jshard["n_devices"] == 8
    host = got["rows"][-1]["multi_host"]
    assert host["n_processes"] == 2
    assert host["planted_found"] and host["equals_single_process"]
    assert got["backend"] == "cpu" and got["scale_divisor"] == 64


def test_baseline_configs_need_a_card_or_cpu(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would start")
    out = tmp_path / "x.json"
    assert bench_baseline_configs.main(["--json", str(out)]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_perf_probe_ab_records(capsys):
    assert perf_probe.main(["--device", "cpu", "--mb", "2", "--iters", "1",
                            "--stage", "ab"]) == 0
    records = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    ab = [r for r in records if r["probe"].startswith("ab_")]
    assert [r["probe"] for r in ab] == [
        f"ab_gather_{gm}_fused_wildcard" for gm in ("dma", "block", "take")]
    assert len({(r["hot"], r["fallback"]) for r in ab}) == 1
    assert all(r["ms"] > 0 and r["gbps"] > 0 for r in ab)


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("plants", [5, 400], ids=["few-hot", "past-k_cap"])
def test_gather_modes_give_the_default_combo(width, plants):
    """The three gathers' combo buffers equal the default step's, with hot
    tiles at a word edge, a tile edge and the last window, and with more
    hot tiles than the step's ``k_cap`` (its fallback)."""
    n_bytes = 1 << 20
    te = 8 * LANES
    words = bench.make_corpus(n_bytes, 9, "cpu", halo_bytes=2 * te * width)
    pat = compile_pattern("ab*de", "*",
                          dtype=np.uint8 if width == 1 else np.uint16)
    n = n_bytes // width
    elems = words.view(torch.uint8 if width == 1 else torch.int16)
    rng = np.random.default_rng(plants)
    spots = sorted({1, te - 2, n - 5} | set(
        int(x) for x in rng.integers(0, n - 5, plants - 3)))
    kw = torch.tensor(pat.keyword, dtype=elems.dtype)
    for pos in spots:
        elems[pos : pos + 5] = kw
    data = bench.tile_view(words, n_bytes, te * width)
    pending = fused_count_extract_start(pat, data, n, tile_elems=te)
    default = pending.combo_dev.cpu().numpy()
    combos = perf_probe.gather_combos(pat, data, n, te)
    assert list(combos) == list(GATHER_MODES)
    for gm, combo in combos.items():
        assert np.array_equal(combo, default), gm
    n_hot, _, n_cand = default[:3]
    assert n_hot >= 3 and (n_hot > pending.k_cap) == (plants > 100)
    if n_hot <= pending.k_cap:
        assert n_cand >= len(spots)


def test_gather_selector_rejects_other_operands():
    n_bytes = 1 << 16
    te = 8 * LANES
    words = bench.make_corpus(n_bytes, 1, "cpu", halo_bytes=te)
    pat = compile_pattern("ab*de", "*")
    data = bench.tile_view(words, n_bytes, te)
    with pytest.raises(ValueError, match="gather must be one of"):
        fused_count_extract_start(pat, data, n_bytes, tile_elems=te,
                                  gather="xla")
    elems = data.view(torch.uint8)
    with pytest.raises(ValueError, match="packed step"):
        fused_count_extract_start(pat, elems, n_bytes, tile_elems=te,
                                  gather="take")


@pytest.fixture
def terminal():
    """Skips without a pty or the ``xterm`` terminfo, which the smoke's
    curses sessions need."""
    try:
        import pty

        master, slave = pty.openpty()
        os.close(master)
        os.close(slave)
    except (ImportError, OSError) as e:
        pytest.skip(f"no pty: {e}")
    probe = subprocess.run(
        [sys.executable, "-c", "import curses; curses.setupterm('xterm', 2)"],
        capture_output=True, text=True, timeout=60)
    if probe.returncode != 0:
        pytest.skip(f"no xterm terminfo: {probe.stderr[-300:]}")


def test_tui_smoke_cpu_passes_its_eight_checks(terminal):
    # alone, one thread: 14.1 s; limit 300 s
    proc = subprocess.run(
        [sys.executable, "-m", "monkey_moore_tpu_torch.tui_smoke", "--cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=port_subprocess_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    ok = [line for line in proc.stdout.splitlines()
          if line.startswith("  OK ")]
    assert len(ok) == 8, proc.stdout
    assert "TUI smoke OK" in proc.stdout.splitlines()[-1]
