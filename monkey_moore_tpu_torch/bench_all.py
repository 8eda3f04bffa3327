"""Full benchmark matrix of the PyTorch port on one CUDA card — the
counterpart of the repository's ``tools/bench_all.py`` (the JAX package's
matrix, which stays as it is).

It mirrors the reference's suites (``benchmarks/bench_search.cpp:67-104``):
8/16-bit relative search and wildcard Front/Middle/Back variants, bytes/s
on a corpus resident in device memory.  Every suite runs the production
fused step (``dense.fused_count_extract``: kernel A's counts, kernel L's
exact phase 2 over the hot tiles, one result copy) at 8
Ki-element tiles over ``--mb`` MiB (12 GiB by default, the headline's
scale), timed two ways in one process: ``sync``, the best of ``--iters``
steps, and ``pipelined``, ``--pipeline`` steps kept in flight with every
result still fetched one step late (the engine's chunk loop).

The corpus is generated once on the card in the packed word layout
(``bench.make_corpus``, a seeded ``torch.Generator``) with one halo tile of
the 16-bit suites' tiles, and serves all eight suites: the 16-bit suites
read the same bytes as little-endian u16 elements.  A pattern that does
not take packed words (``dense.wants_packed``: none of the eight) would
scan seeded u8/u16 elements uploaded from the host instead.

The buffer-size ladder (the reference's 128 KiB-16 MiB range,
``bench_search.cpp:70``) runs ``SearchEngine`` end to end on a temporary
file, which rides the host route at these sizes, and the host scanner
``ops.scan_host.host_candidates_values`` as the core scan.

Writes one JSON record with the keys of the JAX artifact
(``BENCH_DETAIL.json``, which stays the JAX package's) to ``--json``,
``BENCH_DETAIL_TORCH.json`` at the repository root by default, and prints
a table with each suite's speedup against the reference C++ core measured
on the development host (``BASELINE_MEASURED.json``).

``python -m monkey_moore_tpu_torch.bench_all [--mb 12288] [--iters 10]``
runs on the card; ``--device cpu`` runs the kernels' plain versions, for
tests only.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from .bench import (
    HBM_GBPS,
    check_memory,
    device_name,
    make_corpus,
    measured_baseline,
    tile_view,
)
from .dense import (
    TILE_ELEMS,
    fused_count_extract,
    fused_count_extract_finish,
    fused_count_extract_start,
    resolve_device,
    upload_elements,
    wants_packed,
)
from .ops import scan_cuda
from .ops.host import LANES
from .pattern import compile_pattern

__all__ = ["SUITES", "SWEEP_SIZES", "SEED", "suite_pattern", "suite_corpus",
           "host_bytes", "measure_suite", "suite_record", "run_suites",
           "sweep", "main"]

REPO = Path(__file__).resolve().parent.parent
MIB = 1 << 20

#: (name, keyword, wildcard, element width) of ``tools/bench_all.py:34-43``
SUITES = [
    ("BM_Search/Relative/8-Bit", "abcde", 0, 1),
    ("BM_Search/Relative/16-Bit", "abcde", 0, 2),
    ("BM_Search/Relative/Wildcard/Front/8-Bit", "*bcde", "*", 1),
    ("BM_Search/Relative/Wildcard/Middle/8-Bit", "ab*de", "*", 1),
    ("BM_Search/Relative/Wildcard/Back/8-Bit", "abcd*", "*", 1),
    ("BM_Search/Relative/Wildcard/Front/16-Bit", "*bcde", "*", 2),
    ("BM_Search/Relative/Wildcard/Middle/16-Bit", "ab*de", "*", 2),
    ("BM_Search/Relative/Wildcard/Back/16-Bit", "abcd*", "*", 2),
]

#: the ladder's sizes: 128 KiB times 4^i, and 16 MiB
SWEEP_SIZES = [128 << 10 << (2 * i) for i in range(4)] + [16 << 20]

SEED = 42  # the corpus's generator seed

#: the packed suites' count tile (elements): ``tools/bench_all.py:217``
SUITE_TILE_ELEMS = 8 * LANES


def suite_pattern(keyword: str, wildcard, width: int):
    return compile_pattern(keyword, wildcard,
                           dtype=np.uint8 if width == 1 else np.uint16)


def suite_corpus(n_bytes: int, device) -> torch.Tensor:
    """The suites' one corpus: ``n_bytes`` of seeded random words on
    *device* plus one halo tile of the widest suite tile (16 KiB)."""
    return make_corpus(n_bytes, SEED, device,
                       halo_bytes=2 * SUITE_TILE_ELEMS)


def host_bytes(n_bytes: int) -> np.ndarray:
    """The seeded host bytes the element-array branch uploads (the tool's
    ``default_rng(42)`` draw)."""
    return np.random.default_rng(SEED).integers(0, 256, n_bytes,
                                                dtype=np.uint8)


def _best(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def measure_suite(pat, data: torch.Tensor, n: int, tile_elems: int, *,
                  iters: int, warmup: int, depth: int) -> dict:
    """``bench_step`` of the tool over ``n`` elements of *data* (packed
    words or u8/u16 elements, T+1 tiles): the best synchronous step, the
    pipelined steady state at *depth*, the first step's info and offsets,
    the fallbacks of the pipelined steps and the kernel launches of the
    whole suite."""
    before = dict(scan_cuda.launch_counts)

    def step():
        # k_cap auto-sizes from the pattern's expected prefilter rate
        return fused_count_extract(pat, data, n, tile_elems=tile_elems)

    offsets, _, info = step()  # first call: uploads operands, loads kernels
    for _ in range(warmup):
        step()
    best = _best(step, iters)

    depth = max(1, depth)
    fallbacks = 0
    pend: deque = deque()
    t0 = time.perf_counter()
    for _ in range(iters):
        pend.append(fused_count_extract_start(pat, data, n,
                                              tile_elems=tile_elems))
        if len(pend) >= depth:
            fallbacks += bool(fused_count_extract_finish(
                pend.popleft())[2].fallback)
    while pend:
        fallbacks += bool(fused_count_extract_finish(
            pend.popleft())[2].fallback)
    piped = (time.perf_counter() - t0) / iters
    return {
        "best": best, "piped": piped, "info": info, "offsets": offsets,
        "fallbacks": fallbacks,
        "launches": {k: v - before[k]
                     for k, v in scan_cuda.launch_counts.items()},
    }


def suite_record(n_bytes: int, m: dict, depth: int, reference,
                 roofline_gbps) -> dict:
    """One suite's entry of the record, with the JAX artifact's keys."""
    bps = n_bytes / min(m["best"], m["piped"])
    rec = {
        "bytes_per_s": bps,
        "sync_bytes_per_s": n_bytes / m["best"],
        "pipelined_bytes_per_s": n_bytes / m["piped"],
        "pipeline_depth": depth,
        "reference_bytes_per_s": reference,
        "speedup": bps / reference if reference else None,
        "matches_per_step": m["info"].candidates,
        "fused_fallbacks": m["fallbacks"],
    }
    if roofline_gbps:
        rec["pct_hbm_roofline"] = 100.0 * bps / (roofline_gbps * 1e9)
    return rec


def run_suites(words: torch.Tensor, n_bytes: int, *, iters: int,
               warmup: int, depth: int) -> tuple:
    """Every suite over the first ``n_bytes`` of *words* (from
    :func:`suite_corpus`); prints the table.  Returns ``(records,
    details)``: the record's ``suites`` entry and, per suite, its
    measurement (:func:`measure_suite`)."""
    roofline = HBM_GBPS.get(device_name(words.device))
    baselines = measured_baseline("measured")
    records, details = {}, {}
    host_raw = None  # seeded host bytes, only for a pattern not packed
    for name, keyword, wildcard, width in SUITES:
        pat = suite_pattern(keyword, wildcard, width)
        n = n_bytes // width
        if wants_packed(pat):
            tile_elems = SUITE_TILE_ELEMS
            data = tile_view(words, n_bytes, tile_elems * width)
        else:
            tile_elems = TILE_ELEMS
            if host_raw is None:
                host_raw = host_bytes(n_bytes)
            data = upload_elements(
                host_raw[: n * width].view("<u2" if width == 2 else np.uint8),
                words.device, (-(-n // tile_elems) + 1) * tile_elems)
        m = measure_suite(pat, data, n, tile_elems, iters=iters,
                          warmup=warmup, depth=depth)
        m["tile_elems"] = tile_elems
        details[name] = m
        rec = records[name] = suite_record(n_bytes, m, depth,
                                           baselines.get(name), roofline)
        sp = f"{rec['speedup']:8.1f}x" if rec["speedup"] else "      n/a"
        rl = (f"  {rec['pct_hbm_roofline']:5.1f}% HBM"
              if "pct_hbm_roofline" in rec else "")
        print(f"{name:<45} {rec['bytes_per_s'] / 1e9:8.2f} GB/s (sync "
              f"{rec['sync_bytes_per_s'] / 1e9:6.2f} | piped "
              f"{rec['pipelined_bytes_per_s'] / 1e9:6.2f})  vs ref {sp}{rl}"
              f"  matches={rec['matches_per_step']} fallbacks="
              f"{rec['fused_fallbacks']}", flush=True)
        del data
    return records, details


def sweep(iters: int, device) -> tuple:
    """The buffer-size ladder: ``SearchEngine`` end to end on a temporary
    file of each size (the host route) and the host scanner alone on the
    same bytes.  Returns the record's ``buffer_size_sweep_8bit`` and
    ``buffer_size_sweep_8bit_detail``."""
    from .config import SearchConfig
    from .engine import SearchEngine
    from .ops.scan_host import host_candidates_values

    ref_sweep = measured_baseline("sweep_8bit")
    pat = compile_pattern("abcde")
    rng = np.random.default_rng(SEED)
    rates, detail = {}, {}
    with tempfile.TemporaryDirectory(prefix="mm_bench_all_") as tmp:
        for size in SWEEP_SIZES:
            buf = rng.integers(0, 256, size, dtype=np.uint8)
            path = Path(tmp) / f"sweep_{size}.bin"
            buf.tofile(path)
            cfg = SearchConfig(file_path=path, keyword="abcde")
            eng = SearchEngine(cfg, device=device)
            eng.run()  # warm: pattern memo, native scanner build
            if not eng.last_stats.host_routed:
                raise RuntimeError(f"sweep: {size} bytes left the host route")
            # sub-millisecond scans need more draws for a stable best
            best = _best(eng.run, max(iters, 30 if size < MIB else iters))
            core = _best(lambda: host_candidates_values(pat, buf), iters)
            path.unlink()
            base = ref_sweep.get(str(size))
            rates[str(size)] = size / best
            detail[str(size)] = {
                "engine_end_to_end_bytes_per_s": size / best,
                "core_scan_bytes_per_s": size / core,
                "reference_core_bytes_per_s": base,
                "speedup_end_to_end": (size / best / base) if base else None,
            }
            sp = f"{size / best / base:6.1f}x" if base else "   n/a"
            print(f"sweep {size >> 10:>6} KiB  engine {size / best / 1e9:6.2f}"
                  f" GB/s (vs ref core {sp})  core {size / core / 1e9:6.2f}"
                  " GB/s", flush=True)
    return rates, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=12288,
                    help="resident corpus MiB (the headline's 12 GiB by "
                         "default)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--pipeline", type=int, default=3,
                    help="fused steps kept in flight (the bench's depth)")
    ap.add_argument("--no-sweep", action="store_true",
                    help="skip the 128 KiB..16 MiB buffer-size ladder")
    ap.add_argument("--sweep-only", action="store_true",
                    help="re-run only the host-route ladder and merge it "
                         "into an existing --json record")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    ap.add_argument("--json", type=Path,
                    default=REPO / "BENCH_DETAIL_TORCH.json",
                    help="output record (default BENCH_DETAIL_TORCH.json)")
    args = ap.parse_args(argv)
    if args.sweep_only and args.no_sweep:
        print("error: --sweep-only and --no-sweep are contradictory",
              file=sys.stderr)
        return 1
    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        print("bench_all: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device(args.device, "bench_all")
    n_bytes = args.mb * MIB

    records = {}
    if not args.sweep_only:
        problem = check_memory(device, n_bytes)
        if problem:
            print(problem, file=sys.stderr)
            return 1
        words = suite_corpus(n_bytes, device)
        records, _ = run_suites(words, n_bytes, iters=args.iters,
                                warmup=args.warmup, depth=args.pipeline)
        del words
    rates, detail = {}, {}
    if not args.no_sweep:
        print()
        rates, detail = sweep(args.iters, device)

    if args.sweep_only and args.json.exists():
        # keep the recorded suites (and device); refresh only the ladder
        blob = json.loads(args.json.read_text())
        blob["buffer_size_sweep_8bit"] = rates
        blob["buffer_size_sweep_8bit_detail"] = detail
    else:
        blob = {
            "data_mb": args.mb,
            "device": device_name(device) or "cpu",
            "suites": records,
            "buffer_size_sweep_8bit": rates,
            "buffer_size_sweep_8bit_detail": detail,
        }
    args.json.write_text(json.dumps(blob, indent=2))
    print(f"\nwritten: {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
