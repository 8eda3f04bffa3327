"""Time the hot-tile gathers (kernels B and E) on one CUDA card.

``python -m monkey_moore_tpu_torch.gather_bench [--against CSRC] [--sweep]``

Builds this checkout's ``csrc/gather_tiles.cu`` into a library of its own
and times its two entry points, ``mm_gather_tiles`` (B, on the packed
words) and ``mm_gather_tiles_block`` (E, on the same bytes as u8
elements), beside ``torch.index_select`` of the overlapping tile view (the
PyTorch call that computes the same gather), each by
``bench.back_to_back_ms``: many launches between one pair of CUDA events.
Every output must equal ``index_select``'s.  The regimes, over a 512 MiB
chunk of seeded random words:

- ``main``: the main path's ids at 256 KiB tiles, ``nonzero_capped`` of
  counts with four hot tiles (the rest of the slots repeat tile 0), at
  k_cap 32 and 128;
- ``distinct``: k_cap distinct ids spread evenly over the chunk, at k_cap
  32 and 128;
- ``bench``: the bench's 8 KiB tiles at its k_cap 32, main-path ids.

``--against CSRC`` also builds the gather sources of another checkout's
``csrc/`` directory (e.g. the parent commit's, unpacked with ``git
archive``) and times them in turns with this one: against, this, this,
against.  ``--sweep`` rebuilds this checkout's kernel with other values of
its constants (stage bytes, stages, loads ahead, blocks per SM, and the
largest chunk in which the output is dealt to the blocks and the multiple
at which it is cut) and times each.  Prints
one JSON object per timing, then the card's ``nvidia-smi`` name and power
limit.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .bench import HBM_BYTES_PER_S, back_to_back_ms
from .ops._build import compile_library, open_library
from .ops.scan_torch import nonzero_capped

__all__ = ["REGIMES", "SWEEP", "LAUNCHES", "regime_ids", "bound_ms", "main"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "gather_tiles.cu"
BUILD = _PKG / "_build" / "gather_bench"
ENTRIES = {"B": "mm_gather_tiles", "E": "mm_gather_tiles_block"}
CHUNK_BYTES = 512 << 20
SEED = 20261016
#: launches between one pair of CUDA events
LAUNCHES = 200

#: (name, tile bytes, k_cap, ids)
REGIMES = [
    ("main", 256 << 10, 32, "main"), ("main", 256 << 10, 128, "main"),
    ("distinct", 256 << 10, 32, "distinct"),
    ("distinct", 256 << 10, 128, "distinct"),
    ("bench", 8 << 10, 32, "main"),
]

#: the kernel's constants, in the order of a SWEEP entry
CONSTANTS = ("kStageBytes", "kStages", "kAhead", "kBlocksPerSm",
             "kChunkBytes", "kCutBytes")

#: (stage bytes, stages, loads ahead, blocks per SM, chunk bytes, cut
#: bytes) tried by --sweep
SWEEP = [
    (32768, 3, 2, 2, 65536, 1024), (16384, 4, 2, 2, 16384, 1024),
    (8192, 8, 4, 2, 8192, 1024), (2048, 16, 8, 2, 2048, 1024),
    (65536, 3, 2, 1, 131072, 1024), (32768, 3, 1, 2, 65536, 1024),
    (32768, 3, 2, 2, 1 << 24, 1024), (32768, 3, 2, 2, 65536, 16),
    (32768, 3, 2, 2, 65536, 16384),
]


def variant_source(*values: int) -> str:
    """``gather_tiles.cu`` with its ``CONSTANTS`` replaced by *values*."""
    text = SOURCE.read_text()
    for name, value in zip(CONSTANTS, values, strict=True):
        text, n = re.subn(rf"(constexpr int {name} = )\d+;",
                          rf"\g<1>{value};", text)
        if n != 1:
            raise RuntimeError(f"{SOURCE.name}: no constant {name}")
    return text


def build_all(against: str | None, sweep: bool) -> dict[str, ctypes.CDLL]:
    """``{tag: library}``: this checkout's kernel, the ``--against``
    sources and the sweep's variants, each built by ``ops._build``, all
    started together."""
    jobs = {"this": [SOURCE]}
    if against:
        jobs["against"] = sorted(Path(against).glob("gather_tiles*.cu"))
        if not jobs["against"]:
            raise RuntimeError(f"{against}: no gather_tiles*.cu")
    if sweep:
        src_dir = BUILD / "sweep"
        src_dir.mkdir(parents=True, exist_ok=True)
        for consts in SWEEP:
            tag = "sweep_" + "_".join(map(str, consts))
            path = src_dir / f"{tag}.cu"
            path.write_text(variant_source(*consts))
            jobs[tag] = [path]
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = {tag: pool.submit(compile_library, srcs, BUILD / f"{tag}.so")
                 for tag, srcs in jobs.items()}
        return {tag: open_library(path.result())
                for tag, path in paths.items()}


def regime_ids(kind: str, n_tiles: int, k_cap: int, device) -> torch.Tensor:
    """Tile ids: ``main`` as the fused step picks them from counts with
    four hot tiles; ``distinct`` spread evenly over the tiles."""
    if kind == "main":
        counts = torch.zeros(n_tiles, dtype=torch.int32, device=device)
        counts[[1, n_tiles // 3, n_tiles // 2, n_tiles - 1]] = 1
        return nonzero_capped(counts, k_cap)
    return torch.linspace(0, n_tiles - 1, k_cap, device=device).round().to(
        torch.int32)


def bound_ms(hot: torch.Tensor, n_tiles: int, tile_bytes: int) -> float:
    """Each distinct source tile (ids and their halo tiles) read once,
    every slot written, at the published rate."""
    ids = set(hot.tolist())
    read = len({t for i in ids for t in (i, i + 1) if t <= n_tiles})
    return (read + 2 * hot.numel()) * tile_bytes / HBM_BYTES_PER_S * 1e3


def gather(lib, kernel: str, src: torch.Tensor, hot: torch.Tensor,
           tile_bytes: int) -> torch.Tensor:
    """One launch of *lib*'s entry point of *kernel* (B or E)."""
    out = torch.empty((hot.numel(), 2 * tile_bytes), dtype=torch.uint8,
                      device=src.device)
    rc = getattr(lib, ENTRIES[kernel])(
        src.data_ptr(), src.numel() * src.element_size(), hot.data_ptr(),
        hot.numel(), tile_bytes, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{ENTRIES[kernel]} failed: CUDA error {rc}")
    return out


def time_regimes(libs: dict, order: list[str], words: torch.Tensor) -> None:
    raw = words.view(torch.uint8)
    for name, tile_bytes, k_cap, kind in REGIMES:
        n_tiles = CHUNK_BYTES // tile_bytes - 1  # plus one halo tile
        src = words[: (n_tiles + 1) * tile_bytes // 4]
        hot = regime_ids(kind, n_tiles, k_cap, words.device)
        spans = raw[: src.numel() * 4].unfold(0, 2 * tile_bytes, tile_bytes)
        want = torch.index_select(spans, 0, hot)
        row = dict(regime=name, tile_bytes=tile_bytes, k_cap=k_cap,
                   distinct_ids=len(set(hot.tolist())),
                   bound_ms=bound_ms(hot, n_tiles, tile_bytes))
        ms, host = back_to_back_ms(lambda: torch.index_select(spans, 0, hot),
                                   LAUNCHES)
        print(json.dumps(dict(row, lib="torch", kernel="index_select",
                              ms=ms, host_ms=host,
                              pct_of_bound=100 * row["bound_ms"] / ms)),
              flush=True)
        for tag in order:
            for kernel in ("B", "E"):
                view = src if kernel == "B" else src.view(torch.uint8)

                def run(lib=libs[tag], kernel=kernel, view=view):
                    return gather(lib, kernel, view, hot, tile_bytes)

                if not torch.equal(run(), want):
                    raise RuntimeError(f"{tag} {kernel} differs from "
                                       f"index_select at {row}")
                ms, host = back_to_back_ms(run, LAUNCHES)
                print(json.dumps(dict(row, lib=tag, kernel=kernel, ms=ms,
                                      host_ms=host,
                                      pct_of_bound=100 * row["bound_ms"] / ms
                                      )), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's csrc/ directory")
    ap.add_argument("--sweep", action="store_true",
                    help="also time the kernel at the SWEEP constants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all(args.against, args.sweep)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    words = torch.randint(-(2**31), 2**31, (CHUNK_BYTES // 4,),
                          dtype=torch.int32, device="cuda", generator=gen)
    order = ["this"]
    if args.against:
        order = ["against", "this", "this", "against"]
    time_regimes(libs, order, words)
    sweep = [tag for tag in libs if tag.startswith("sweep_")]
    if sweep:
        time_regimes(libs, sweep, words)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
