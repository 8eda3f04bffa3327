"""Time breakdown of the port's in-memory and streaming paths on one card.

``python -m monkey_moore_tpu_torch.breakdown [--reps N] [--out FILE]``
writes 1 GiB of seeded random bytes, with an 8-bit keyword (``monkey``)
and a 16-bit big-endian one (``castle``) planted in it, to a temporary
file, and times on the card (host clock around synchronised calls; each
figure the median, with min and max, over ``--reps`` calls):

1. ``dense_candidates`` on the 1 GiB u8 array, and its parts: the pageable
   upload (``upload_elements``), kernel D plus the counts copy
   (``tile_counts``), the host extraction of the hot tiles
   (``extract_hot_tiles``); beside them a pageable and a pinned 1 GiB
   host-to-device copy;
2. the fused step on one 512 MiB chunk of the same bytes, as packed words
   (kernels A and L, the resident route) and as elements (kernels D and L,
   the streaming route), upload excluded;
3. the two keywords through ``SearchEngine``'s streaming branch
   (``resident_bytes_limit`` below the file size): wall time, the
   ``decode`` and ``device_scan`` stages, and one chunk's host decode.

It prints one line per figure, then one JSON object with every figure and
the card's ``nvidia-smi`` name and power limit; ``--out`` also writes that
object to a file.  Needs a CUDA card; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .pattern import compile_pattern
from .scan_plan import decode_grid

SEED = 20261016
FILE_BYTES = 1 << 30
CHUNK = 512 << 20  # the engine's default device chunk (bytes)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _timed(fn, reps: int) -> dict:
    """Seconds of ``fn()`` ending in a card sync, after one warm-up call:
    ``{"median", "min", "max"}``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times)}


def _corpus(path: Path) -> np.ndarray:
    rng = np.random.default_rng(SEED)
    data = np.frombuffer(rng.bytes(FILE_BYTES), dtype=np.uint8).copy()
    kw8 = (np.array([ord(c) for c in "monkey"]) + 3).astype(np.uint8)
    for off in (4101, 123_456_789, CHUNK - 3, FILE_BYTES - 6):
        data[off : off + len(kw8)] = kw8
    kw16 = (np.array([ord(c) for c in "castle"]) + 0x3000).astype(">u2")
    for off in (2000, 200_000_001, 600_000_000):
        data[off : off + 2 * len(kw16)] = kw16.view(np.uint8)
    data.tofile(path)
    return data


def in_memory(data: np.ndarray, reps: int) -> dict:
    from .dense import (
        TILE_ELEMS,
        dense_candidates,
        extract_hot_tiles,
        tile_counts,
        upload_elements,
    )

    pat = compile_pattern("monkey")
    n = len(data)
    padded = (-(-n // TILE_ELEMS) + 1) * TILE_ELEMS
    arr = upload_elements(data, "cuda", padded)
    counts = tile_counts(pat, arr, n, TILE_ELEMS)
    out = {
        "dense_candidates": _timed(
            lambda: dense_candidates(pat, data, device="cuda"), reps),
        "upload_elements": _timed(
            lambda: upload_elements(data, "cuda", padded), reps),
        "tile_counts": _timed(
            lambda: tile_counts(pat, arr, n, TILE_ELEMS), reps),
        "extract_hot_tiles": _timed(
            lambda: extract_hot_tiles(pat, data, counts, TILE_ELEMS), reps),
    }
    dev = torch.empty(n, dtype=torch.uint8, device="cuda")
    host = torch.from_numpy(data)
    pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(host)
    out["copy_pageable"] = _timed(lambda: dev.copy_(host), reps)
    out["copy_pinned"] = _timed(
        lambda: dev.copy_(pinned, non_blocking=True), reps)
    for key in ("copy_pageable", "copy_pinned"):
        out[key]["gb_per_s"] = n / out[key]["median"] / 1e9
    return out


def fused_step(data: np.ndarray, reps: int) -> dict:
    from .dense import TILE_ELEMS, fused_count_extract, upload_elements

    pat = compile_pattern("monkey")
    want = CHUNK + TILE_ELEMS  # one chunk plus its halo tile
    chunk = data[:want]
    elems = upload_elements(chunk, "cuda")
    words = torch.from_numpy(chunk.view("<i4")).to("cuda")
    count = CHUNK + pat.length - 1
    out = {}
    for key, dev_arr in (("words_A_B", words), ("elements_D_E", elems)):
        out[key] = _timed(
            lambda: fused_count_extract(pat, dev_arr, count), reps)
        out[key]["candidates"] = len(
            fused_count_extract(pat, dev_arr, count)[0])
    return out


def streaming(path: Path, reps: int) -> dict:
    from .config import Endianness, SearchConfig
    from .engine import SearchEngine

    out = {}
    for name, kwargs in (
        ("8-bit monkey", dict(keyword="monkey")),
        ("16-bit BE castle", dict(keyword="castle", element_width=2,
                                  endianness=Endianness.BIG)),
    ):
        engine = SearchEngine(
            SearchConfig(file_path=path, resident_bytes_limit=FILE_BYTES // 2,
                         **kwargs),
            device="cuda",
        )
        runs = []

        def run():
            results = engine.run()
            runs.append((len(results), engine.last_stats.stage_seconds))

        row = _timed(run, reps)
        row["results"] = runs[0][0]
        for stage in ("decode", "device_scan"):
            row[stage] = statistics.median(
                secs.get(stage, 0.0) for _, secs in runs[1:])  # no warm-up
        data = np.memmap(path, dtype=np.uint8, mode="r")
        s = engine.config.element_width
        row["decode_one_chunk"] = _timed(
            lambda: decode_grid(data, s, engine.config.endianness, 0, 0,
                                CHUNK // s + 5), reps
        )["median"]
        out[name] = row
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("breakdown: no CUDA device", file=sys.stderr)
        return 1
    report = {"device": _smi(), "reps": args.reps}
    with tempfile.TemporaryDirectory(prefix="mm_breakdown_") as tmp:
        path = Path(tmp) / "corpus.bin"
        data = _corpus(path)
        report["in_memory"] = in_memory(data, args.reps)
        report["fused_step"] = fused_step(data, args.reps)
        del data
        report["streaming"] = streaming(path, args.reps)
    for section in ("in_memory", "fused_step", "streaming"):
        for key, row in report[section].items():
            print(f"{section} {key}: " + ", ".join(
                f"{k} {v:.6f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
    line = json.dumps(report)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
