"""Multi-host search on the port: real worker processes on localhost in a
gloo group, each running ``SearchEngine.run_distributed`` on the CPU (the
kernels' plain versions) over its own byte range of a shared file — the
counterpart of ``tests/test_multihost.py``.

Every worker's gathered result list must equal every other's and the JAX
engine's single-host result on the same file: GREEDY, ALL and REFERENCE
at 2 processes, GREEDY and REFERENCE at 3 (an uneven tail), the streaming
branch, a per-host mesh of ``["cpu"] * 4`` and the abort raised on every
host.  The helpers ``_free_port`` and ``_single_host_expect`` are the JAX
test's.

Tolerance: exact equality — offsets and values maps are integers.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_multihost import _free_port, _single_host_expect

REPO = Path(__file__).resolve().parent.parent

#: seconds each worker may take (start-up, search, gather)
WORKER_TIMEOUT = 120

WORKER_SRC = r"""
import json
import sys

sys.path.insert(0, sys.argv[1])
coord, pid, nproc, path, semantics, mode = (
    sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
    sys.argv[6], sys.argv[7],
)
import torch.distributed as dist

from monkey_moore_tpu_torch.parallel.multihost import (
    initialize_distributed,
    process_count,
)

initialize_distributed(coord, nproc, pid)
assert process_count() == nproc

from monkey_moore_tpu_torch.config import MatchSemantics, SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine

cfg = SearchConfig(
    file_path=path,
    keyword="monkey",
    semantics=MatchSemantics[semantics],
    device_chunk_bytes=8192,
)
if mode == "stream":
    cfg.resident_bytes_limit = 0
    cfg.host_latency_threshold_bytes = 0
if mode == "mesh":
    # each host scans its byte range over its own four-shard mesh
    cfg.devices = ["cpu"] * 4
    cfg.host_latency_threshold_bytes = 0
engine = SearchEngine(cfg, device="cpu")
if mode == "abort":
    # the abort flag is raised on EVERY host (the final gather is a
    # collective): each host stops before the gather
    import threading

    flag = threading.Event()
    res = engine.run_distributed(
        on_progress=lambda pct, step: flag.set(), abort_flag=flag
    )
else:
    res = engine.run_distributed()
stats = engine.last_stats
out = [[r.offset, sorted(r.values_map.items())] for r in res]
print("RESULT:" + json.dumps(out), flush=True)
print("STATS:" + json.dumps([stats.device_dispatches, stats.host_routed]),
      flush=True)
dist.destroy_process_group()
"""


def _run_pod(tmp_path, path, n_proc, semantics, mode="normal"):
    """Launch *n_proc* port workers; returns their (results, stats)
    payloads in process order."""
    coord = f"127.0.0.1:{_free_port()}"
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER_SRC)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(REPO), coord, str(pid),
             str(n_proc), str(path), semantics, mode],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ),
        )
        for pid in range(n_proc)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            lines = dict(
                line.split(":", 1) for line in out.splitlines()
                if line.startswith(("RESULT:", "STATS:"))
            )
            assert "RESULT" in lines, f"no RESULT line:\n{out}\n{err}"
            outs.append((json.loads(lines["RESULT"]),
                         json.loads(lines["STATS"])))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _pod_file(tmp_path, rng, n, plants, name):
    data = rng.integers(0, 256, n).astype(np.uint8)
    enc = np.array([ord(c) + 9 for c in "monkey"], dtype=np.uint8)
    for pos in plants:
        data[pos : pos + 6] = enc
    path = tmp_path / name
    path.write_bytes(data.tobytes())
    return path


PLANTS_2 = [5, 29_997, 45_000, 59_994]


@pytest.mark.parametrize("semantics", ["GREEDY", "ALL", "REFERENCE"])
def test_two_process_run_matches_jax_single_host(tmp_path, rng, semantics):
    path = _pod_file(tmp_path, rng, 60_000, PLANTS_2, "pod.bin")
    outs = _run_pod(tmp_path, path, 2, semantics)
    results = [r for r, _ in outs]
    assert results[0] == results[1]
    assert results[0] == _single_host_expect(path, semantics)
    assert [o for o, _ in results[0]] == PLANTS_2
    if semantics != "REFERENCE":
        # a multi-host run takes the device route on every host
        assert all(dispatches > 0 and not host_routed
                   for _, (dispatches, host_routed) in outs), outs


@pytest.mark.parametrize("semantics", ["GREEDY", "REFERENCE"])
def test_three_process_uneven_tail(tmp_path, rng, semantics):
    """3 hosts over a file whose size is not divisible by 3; matches
    straddle both host boundaries (at ceil(n/3) = 16 667) and sit at
    EOF."""
    n = 50_000
    plants = [5, 16_664, 33_331, n - 6]
    path = _pod_file(tmp_path, rng, n, plants, "pod3.bin")
    outs = _run_pod(tmp_path, path, 3, semantics)
    results = [r for r, _ in outs]
    assert results[0] == results[1] == results[2]
    assert results[0] == _single_host_expect(path, semantics)
    assert [o for o, _ in results[0]] == plants


def test_two_process_streaming_path(tmp_path, rng):
    path = _pod_file(tmp_path, rng, 60_000, PLANTS_2, "stream.bin")
    outs = _run_pod(tmp_path, path, 2, "GREEDY", mode="stream")
    results = [r for r, _ in outs]
    assert results[0] == results[1]
    assert results[0] == _single_host_expect(path, "GREEDY")
    assert [o for o, _ in results[0]] == PLANTS_2


def test_two_process_mesh_per_host(tmp_path, rng):
    """2 hosts × a four-shard mesh each: every host scans its owned chunks
    with the chunked mesh step; the gathered list is the same on both."""
    path = _pod_file(tmp_path, rng, 60_000, PLANTS_2, "podmesh.bin")
    outs = _run_pod(tmp_path, path, 2, "GREEDY", mode="mesh")
    results = [r for r, _ in outs]
    assert results[0] == results[1]
    assert results[0] == _single_host_expect(path, "GREEDY")
    assert [o for o, _ in results[0]] == PLANTS_2
    # host 0 owns bytes [0, 30 000): chunks of 8 192 bytes, 4 of them
    assert outs[0][1][0] == 4


def test_cross_host_abort(tmp_path, rng):
    path = _pod_file(tmp_path, rng, 60_000, [100], "abort.bin")
    outs = _run_pod(tmp_path, path, 2, "GREEDY", mode="abort")
    assert outs[0][0] == outs[1][0] == []
