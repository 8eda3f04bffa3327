"""Mesh sizes side by side: the engine's resident mesh route at 1, 2 and 4
shards — the port's counterpart of ``tools/bench_scaling.py``.

Usage::

    python -m monkey_moore_tpu_torch.bench_scaling [--mb 64] [--iters 8]
        [--devices 1 2 4] [--file PATH --keyword KW] [--out OUT.json]
        [--device cuda|cpu]

For each mesh size it searches one file through ``SearchEngine`` with
``devices`` set to the mesh (a first search uploads and derives, then
``--iters`` repeats) and prints the tool's keys: ``device_dispatches``,
the repeat search's ``h2d_bytes_repeat``, ``ici_halo_bytes`` and
``per_shard_candidates``; on the card also the best repeat wall and
``bytes_per_s``, the file's bytes over it.  The last line is one JSON
object.  Without ``--file`` it writes ``--mb`` MiB of seeded random bytes
with 16 evenly spaced plants of ``abcde`` (the tool's corpus) to a
temporary file.

The mesh of d shards takes d distinct cards where the host has them, else
``cuda:0`` d times.  On one card this measures the cost of sharding — the
shard and halo arithmetic and d sets of launches on the same card — not
scaling: the repeat rate at d shards beside 1 shard shows that cost.  Peer
copies between cards and scaling across cards need a host with several
cards.  ``--device cpu`` runs the kernels' plain versions (tests) and
prints no rate: a CPU time is not the card's.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

__all__ = ["mesh_devices", "measure", "main"]

MIB = 1 << 20


def mesh_devices(device: torch.device, d: int) -> list:
    """The mesh of *d* shards on *device*'s type: d distinct cards where
    there are as many, else *device* d times."""
    if device.type == "cuda":
        if torch.cuda.device_count() >= d:
            return [torch.device("cuda", i) for i in range(d)]
        device = torch.device("cuda", torch.cuda.current_device())
    return [device] * d


def measure(path, keyword: str, sizes, iters: int, device) -> dict:
    """One row per mesh size: the tool's keys of the last repeat search,
    and on the card the best repeat wall and the file's bytes over it."""
    from .config import SearchConfig
    from .dense import resolve_device
    from .engine import SearchEngine
    from .parallel.resident import clear_sharded_corpus_cache

    device = resolve_device(device, "bench_scaling")
    n = Path(path).stat().st_size
    rows = {}
    for d in sizes:
        clear_sharded_corpus_cache()
        cfg = SearchConfig(
            file_path=path, keyword=keyword,
            devices=mesh_devices(device, d),
            host_latency_threshold_bytes=0,  # measure the mesh, not host
        )
        SearchEngine(cfg, device=device).run()  # upload + derive
        best = float("inf")
        for _ in range(iters):
            engine = SearchEngine(cfg, device=device)
            t0 = time.perf_counter()
            found = engine.run()  # the result copy waits for the card
            best = min(best, time.perf_counter() - t0)
        stats = engine.last_stats
        row = {
            "mesh": [str(dev) for dev in cfg.devices],
            "results": len(found),
            "device_dispatches": stats.device_dispatches,
            "h2d_bytes_repeat": stats.h2d_bytes,
            "ici_halo_bytes": stats.ici_halo_bytes,
            "per_shard_candidates": stats.per_device_candidates,
        }
        if device.type == "cuda":
            row["repeat_s"] = best
            row["bytes_per_s"] = n / best
        rows[d] = row
    clear_sharded_corpus_cache()
    return rows


def _write_corpus(path: Path, n: int) -> None:
    """The tool's corpus: seeded random bytes, 16 evenly spaced plants."""
    rng = np.random.default_rng(42)
    data = rng.integers(0, 256, n, dtype=np.uint8)
    enc = (np.array([ord(c) for c in "abcde"]) + 11) % 256
    for pos in range(n // 32, n - 5, n // 16):
        data[pos : pos + 5] = enc.astype(np.uint8)
    data.tofile(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4],
                    help="mesh sizes (default: 1 2 4)")
    ap.add_argument("--file", type=Path, default=None,
                    help="search this file (default: the tool's corpus)")
    ap.add_argument("--keyword", default="abcde")
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the JSON record here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_scaling: no CUDA device", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="mm_scaling_") as tmp:
        path = args.file
        if path is None:
            path = Path(tmp) / "scaling.bin"
            _write_corpus(path, args.mb * MIB)
        rows = measure(path, args.keyword, args.devices, args.iters, device)
        n = path.stat().st_size
    for d, row in rows.items():
        rate = (f"{row['bytes_per_s'] / 1e9:.3f} GB/s (repeat "
                f"{row['repeat_s'] * 1e3:.3f} ms), " if "bytes_per_s" in row
                else "")
        print(f"{d} shard(s) on {row['mesh']}: {rate}dispatches="
              f"{row['device_dispatches']}, repeat h2d="
              f"{row['h2d_bytes_repeat']}, ici halo={row['ici_halo_bytes']}, "
              f"per-shard cands={row['per_shard_candidates']}", flush=True)
    record = {
        "data_bytes": n,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "cards": torch.cuda.device_count() if device.type == "cuda" else 0,
        "mesh_sizes": rows,
    }
    if args.out is not None:
        args.out.write_text(json.dumps(record, indent=2))
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
