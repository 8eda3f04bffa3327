"""Headline benchmark of the PyTorch port: 8-bit relative-search scan
throughput on one CUDA card.

The counterpart of the repository's ``bench.py`` (the JAX package's
benchmark, which stays as it is).  It mirrors the reference's benchmark
setup (random data, the 5-character keyword "abcde", bytes per second) on a
corpus resident in device memory: the corpus is generated on the card, in
256 MiB pieces from a ``torch.Generator`` seeded with ``--seed``, as packed
little-endian int32 words plus one halo tile of zeros, and each timed step
runs the production fused step (``dense.fused_count_extract``: kernel A's
counts, kernel L's exact phase 2 over the hot tiles, one result
copy) over all of it.  Beside it, the speed-of-light decomposition: the
pure-load kernel I (``ops.scan_cuda.load_sum``, which only reads and sums
the corpus at the counts kernel's 2 MiB tile geometry) and the counts
kernel A alone at the same tiles.

``python -m monkey_moore_tpu_torch.bench [--mb N] [--seed S]`` runs on the
card; ``--device cpu`` runs the kernels' plain versions, for tests only.
Without a card it exits 1.  Settings come from the environment, with
``bench.py``'s names and defaults: ``MMTPU_BENCH_MB`` (12288),
``MMTPU_BENCH_WARMUP`` (3), ``MMTPU_BENCH_ITERS`` (15),
``MMTPU_BENCH_TILE_ROWS`` (8: 8 Ki-element count tiles),
``MMTPU_BENCH_KCAP`` (0: auto) and ``MMTPU_BENCH_PIPELINE`` (3).

Prints ONE JSON line on stdout with ``bench.py``'s keys: ``metric``,
``value``, ``unit``, ``vs_baseline`` (against the reference C++ core in
``BASELINE_MEASURED.json``), ``pct_hbm_roofline`` (against the card's
published bandwidth, where ``HBM_GBPS`` knows the card) and the
speed-of-light keys.  Every timing ends in a result fetch to the host.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque
from pathlib import Path

import torch

from .dense import (
    fused_count_extract,
    fused_count_extract_finish,
    fused_count_extract_start,
    resolve_device,
    tile_counts,
)
from .ops.host import LANES
from .ops.scan_cuda import load_sum
from .pattern import compile_pattern

__all__ = ["HBM_GBPS", "HBM_BYTES_PER_S", "INT_OPS_PER_S", "bound",
           "measured_baseline", "make_corpus", "tile_view", "back_to_back_ms",
           "sol_times", "measure", "main"]

REPO = Path(__file__).resolve().parent.parent
MIB = 1 << 20

#: the TPU load kernel's block: (2048, 256) int32 words = 2 MiB, the tile
#: kernel A counts at ``tile_elems`` = 2 Mi (8-bit elements)
LOAD_TILE_BYTES = 2048 * LANES
LOAD_TILE_WORDS = LOAD_TILE_BYTES // 4
PIECE_BYTES = 256 * MIB  # corpus generation piece
SLACK_BYTES = 256 * MIB  # working set of the fused step beside the corpus

#: published device-memory bandwidth, GB/s, by ``torch.cuda.get_device_name``
HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}

#: the H100 SXM's peaks, against which every bound of the port is taken:
#: its published device-memory rate (NVIDIA's data sheet, at 700 W) and
#: its 32-bit integer rate, 64 add, logic, compare or shift results per
#: clock per SM (CUDA C++ Programming Guide, arithmetic instruction
#: throughput, compute capability 9.0) on 132 SMs at the 1.98 GHz boost
#: clock behind the data sheet's 67 TFLOP/s of float32
HBM_BYTES_PER_S = HBM_GBPS["NVIDIA H100 80GB HBM3"] * 1e9
INT_OPS_PER_S = 64 * 132 * 1.98e9


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """``(bound_ms, bound_by)``: the least time the card could take, the
    larger of the bytes' time at its memory rate and the 32-bit integer
    operations' time at its integer rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

#: the keyword of the reference benchmark (``bench_search.cpp:29``)
KEYWORD = "abcde"


def measured_baseline(prefix: str) -> dict:
    """The last ``BASELINE_MEASURED.json`` entry whose key starts with
    *prefix* (the reference's rates measured on the development host:
    ``"measured"`` per suite, ``"sweep_8bit"`` per buffer size), or {}."""
    try:
        blob = json.loads((REPO / "BASELINE_MEASURED.json").read_text())
    except (OSError, ValueError):
        return {}
    found = {}
    for key, values in blob.items():
        if key.startswith(prefix):
            found = values
    return found


def reference_baseline() -> float:
    """The reference C++ core's 8-bit rate measured on the development
    host (``BASELINE_MEASURED.json``; ``bench.py:63-72``)."""
    try:
        return float(
            measured_baseline("measured")["BM_Search/Relative/8-Bit"])
    except (KeyError, TypeError, ValueError):
        return 5.881e8


def settings() -> dict:
    """The benchmark's environment settings, with ``bench.py``'s defaults."""
    env = os.environ.get
    return {
        "mb": int(env("MMTPU_BENCH_MB", "12288")),
        "warmup": int(env("MMTPU_BENCH_WARMUP", "3")),
        "iters": int(env("MMTPU_BENCH_ITERS", "15")),
        "tile_rows": int(env("MMTPU_BENCH_TILE_ROWS", "8")),
        "k_cap": int(env("MMTPU_BENCH_KCAP", "0")) or None,
        "depth": max(1, int(env("MMTPU_BENCH_PIPELINE", "3"))),
    }


def make_corpus(n_bytes: int, seed: int, device,
                halo_bytes: int = LOAD_TILE_BYTES) -> torch.Tensor:
    """``n_bytes`` of seeded random bytes as int32 words on *device*,
    followed by ``halo_bytes`` of zeros (the halo tile of the largest count
    tile used).  Filled in place, one 256 MiB piece at a time, from a
    ``torch.Generator`` seeded with *seed*."""
    if n_bytes % 4 or halo_bytes % 4:
        raise ValueError("corpus and halo must be whole int32 words")
    device = torch.device(device)
    words = torch.empty((n_bytes + halo_bytes) // 4, dtype=torch.int32,
                        device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_words, piece = n_bytes // 4, PIECE_BYTES // 4
    for w0 in range(0, n_words, piece):
        words[w0 : min(w0 + piece, n_words)].random_(
            -(2**31), 2**31, generator=gen)
    words[n_words:].zero_()
    return words


def tile_view(words: torch.Tensor, n_bytes: int, tile_bytes: int
              ) -> torch.Tensor:
    """The prefix of *words* that holds the tiles covering ``n_bytes`` plus
    one halo tile, as the count kernels take it (a view, no copy)."""
    n_tiles = -(-n_bytes // tile_bytes) + 1
    if n_tiles * tile_bytes > words.numel() * 4:
        raise ValueError(f"{tile_bytes}-byte tiles need a larger halo")
    return words[: n_tiles * tile_bytes // 4]


def _best(fn, reps: int) -> float:
    """Least host-clock seconds of ``fn()`` over *reps* calls; ``fn`` ends
    in a result fetch, so the device work is inside the time."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


#: outputs kept alive across back-to-back launches, in bytes: twice the
#: H100's 50 MB L2, so no launch writes into lines a recent one left there
ROTATE_BYTES = 100 * 1000 * 1000


def back_to_back_ms(fn, n: int = 100) -> tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn`` over ``n`` launches
    between one pair of CUDA events.

    A spin kernel holds the stream while the host enqueues the ``n`` calls,
    so the device runs them back to back and the device time holds no host
    gap; the host time is the enqueue's, host clock over the ``n`` calls.
    The last results stay referenced until ``ROTATE_BYTES`` of them are
    alive, so each call writes a buffer that the L2 cache no longer holds.
    Raises when the enqueue outlasts every hold tried."""
    out = fn()
    torch.cuda.synchronize()
    parts = out if isinstance(out, tuple) else (out,)
    out_bytes = sum(t.numel() * t.element_size() for t in parts)
    depth = max(1, -(-ROTATE_BYTES // max(1, out_bytes)))
    keep: deque = deque([out])
    hold_s = 0.02
    for _ in range(6):
        held, start, stop = (torch.cuda.Event(enable_timing=True)
                             for _ in range(3))
        held.record()
        torch.cuda._sleep(int(hold_s * 2e9))  # ~hold_s at <= 2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            keep.append(fn())
            if len(keep) > depth:
                keep.popleft()
        host_s = time.perf_counter() - t0
        stop.record()
        stop.synchronize()
        if host_s * 1e3 < held.elapsed_time(start):
            return start.elapsed_time(stop) / n, host_s * 1e3 / n
        hold_s = 2 * host_s + hold_s
    raise RuntimeError(f"back_to_back_ms: {n} enqueues outlasted the hold")


def sol_times(words: torch.Tensor, n: int, pat, reps: int
              ) -> tuple[float, float, int]:
    """The speed-of-light pair, same process: best seconds of the pure load
    (kernel I) over the whole 2 MiB tiles of the first ``n`` bytes of
    *words*, and of the counts kernel A at the same tiles.  Returns
    ``(t_load, t_kernel, load_bytes)``; a failure here raises."""
    load_bytes = n // LOAD_TILE_BYTES * LOAD_TILE_BYTES
    load_words = words[: load_bytes // 4]
    counts_data = tile_view(words, n, LOAD_TILE_BYTES)

    def load():
        return int(load_sum(load_words, LOAD_TILE_WORDS)[1])

    def counts():
        return tile_counts(pat, counts_data, n, tile_elems=LOAD_TILE_BYTES)

    load()
    t_load = _best(load, reps)
    counts()
    t_kernel = _best(counts, reps)
    return t_load, t_kernel, load_bytes


def measure(words: torch.Tensor, n: int, *, warmup: int = 3,
            iters: int = 15, tile_rows: int = 8, k_cap=None,
            depth: int = 3, device_name: str | None = None) -> dict:
    """``bench.py``'s timed paths over the first ``n`` bytes of *words*
    (from :func:`make_corpus`); returns its JSON record.  Progress lines go
    to stderr."""
    pat = compile_pattern(KEYWORD)
    tile_elems = tile_rows * LANES
    if n % tile_elems:
        raise ValueError(f"{n} bytes are not whole {tile_elems}-byte tiles")
    data = tile_view(words, n, tile_elems)

    def step():
        # the production path: counts, hot-tile gather and exact phase 2
        # enqueued, then ONE result copy and the host decode
        return fused_count_extract(pat, data, n, tile_elems=tile_elems,
                                   k_cap=k_cap)[2]

    step()  # first call: uploads the pattern's operands, loads the kernels
    t0 = time.perf_counter()
    for _ in range(warmup):
        step()
    warm_each = (time.perf_counter() - t0) / max(1, warmup)
    # bound the measurement to a ~90 s budget (never fewer than 3 steps)
    iters = max(3, min(iters, int(90.0 / max(warm_each, 1e-9))))
    best = _best(step, iters)

    # pipelined steady state: ``depth`` fused steps in flight, as the
    # engine's pipeline_depth; every step's result is still fetched
    pend: deque = deque()
    t0 = time.perf_counter()
    for _ in range(iters):
        pend.append(fused_count_extract_start(
            pat, data, n, tile_elems=tile_elems, k_cap=k_cap))
        if len(pend) >= depth:
            fused_count_extract_finish(pend.popleft())
    while pend:
        fused_count_extract_finish(pend.popleft())
    piped = (time.perf_counter() - t0) / iters

    sync_value = n / best
    value = max(sync_value, n / piped)
    print(f"sync best {sync_value / 1e9:.1f} GB/s | pipelined x{depth} "
          f"steady-state {n / piped / 1e9:.1f} GB/s over {iters} steps",
          file=sys.stderr)

    # speed-of-light decomposition, same process; a failure here raises
    t_load, t_kernel, load_bytes = sol_times(words, n, pat,
                                             max(3, min(iters, 8)))
    load_words = words[: load_bytes // 4]
    lp: deque = deque()
    t0 = time.perf_counter()
    for _ in range(iters):
        lp.append(load_sum(load_words, LOAD_TILE_WORDS)[1])
        if len(lp) >= depth:
            int(lp.popleft())
    while lp:
        int(lp.popleft())
    t_load_piped = (time.perf_counter() - t0) / iters

    # scale the load times to the full corpus the fused step scans
    t_load_full = t_load * n / load_bytes
    t_lp_full = t_load_piped * n / load_bytes
    sol = {
        "pure_load_bytes_per_s": load_bytes / t_load,
        "pure_load_pipelined_bytes_per_s": load_bytes / t_load_piped,
        "kernel_over_pure_load": t_kernel / t_load,
        "pct_of_pure_load": 100.0 * t_load / t_kernel,
        "pct_of_pipelined_pure_load": 100.0 * t_lp_full / piped,
        "fused_step_over_pure_load": best / t_load_full,
    }
    print(f"pure load {load_bytes / t_load / 1e9:.1f} GB/s sync / "
          f"{load_bytes / t_load_piped / 1e9:.1f} GB/s pipelined | "
          f"counts-kernel/pure-load {t_kernel / t_load:.3f} | "
          f"fused-step/pure-load {best / t_load_full:.3f} | "
          f"piped-fused/piped-load {100.0 * t_lp_full / piped:.1f}% "
          "(same process)", file=sys.stderr)

    baseline = reference_baseline()
    record = {
        "metric": "relative_search_scan_8bit_bytes_per_s",
        "value": value,
        "unit": "bytes/s",
        "vs_baseline": value / baseline,
    }
    roofline = HBM_GBPS.get(device_name)
    if roofline:
        record["pct_hbm_roofline"] = 100.0 * value / (roofline * 1e9)
    record.update(sol)
    return record


def device_name(device: torch.device) -> str | None:
    """The card's name, or None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_name(device)


def check_memory(device: torch.device, n_bytes: int) -> str | None:
    """Why the card cannot hold an ``n_bytes`` corpus plus the step's
    working set, or None when it can (always None on the CPU)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    need = n_bytes + LOAD_TILE_BYTES + SLACK_BYTES
    if need > free:
        return (f"error: a {n_bytes}-byte corpus needs {need} bytes but "
                f"{device_name(device)} has {free} free; lower "
                "MMTPU_BENCH_MB")
    return None


def main(argv=None) -> int:
    conf = settings()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    ap.add_argument("--mb", type=int, default=conf["mb"],
                    help="corpus MiB (default: MMTPU_BENCH_MB or 12288)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        print("bench: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device(args.device, "bench")
    n = args.mb * MIB
    problem = check_memory(device, n)
    if problem:
        print(problem, file=sys.stderr)
        return 1
    words = make_corpus(n, args.seed, device)
    record = measure(
        words, n, warmup=conf["warmup"], iters=conf["iters"],
        tile_rows=conf["tile_rows"], k_cap=conf["k_cap"],
        depth=conf["depth"], device_name=device_name(device),
    )
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
