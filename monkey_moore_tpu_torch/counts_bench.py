"""Time the counts kernels A and C on one CUDA card.

``python -m monkey_moore_tpu_torch.counts_bench [--against CSRC]``

Builds this checkout's ``csrc/tile_counts.cu`` and ``tile_counts_multi.cu``
into a library of its own and times their entry points, ``mm_tile_counts``
(A) and ``mm_tile_counts_multi`` (C), each by ``bench.back_to_back_ms``:
many launches between one pair of CUDA events.  Every output must equal the
plain version's (``ops.scan_cuda``).  The regimes, over a 512 MiB chunk of
seeded random u8 words:

- A on ``abcde`` at the main path's 256 Ki-element tiles and at the bench
  path's 8 Ki-element tiles;
- C at the main path's tiles on the first K = 3, 8 and 16 keywords of
  :data:`BATCH`.

``--against CSRC`` also builds the ``tile_counts*.cu`` sources of another
checkout's ``csrc/`` directory (e.g. the parent commit's, unpacked with
``git archive``) and times them in turns with this one: against, this,
this, against.  Prints one JSON object per record, then the card's
``nvidia-smi`` name and power limit.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from .bench import back_to_back_ms, bound
from .ops import scan_cuda
from .ops._build import compile_library, open_library
from .pattern import compile_pattern

__all__ = ["BATCH", "A_TILES", "C_KS", "DIFF_OPS", "EQUAL_OPS", "a_bound",
           "first_pairs", "c_bound", "build_all", "main"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = [CSRC / "tile_counts.cu", CSRC / "tile_counts_multi.cu"]
BUILD = _PKG / "_build" / "counts_bench"
CHUNK_BYTES = 512 << 20
SEED = 20261016
#: launches between one pair of CUDA events
LAUNCHES = 50

#: keyword batch of kernel C: canonical plain keywords, a wildcard, a
#: leading wildcard, 12- and 13-letter keywords; ``chip_smoke.py`` phase 3
#: checks the first 8
BATCH = [
    ("monkey", 0), ("dr*gon", "*"), ("?bcde", "?"), ("abcdefghijkl", 0),
    ("sword", 0), ("shield", 0), ("potion", 0), ("castle", 0),
    ("knight", 0), ("b*tter", "*"), ("?rincess", "?"), ("treasurechest", 0),
    ("zyxwv", 0), ("aabcde", 0), ("dungeon", 0), ("wizard", 0),
]
#: kernel A's tiles (u8 elements): the main path's and the bench path's
A_TILES = [262_144, 8_192]
#: kernel C's batch sizes, at the main path's tiles
C_KS = [3, 8, 16]


#: 32-bit instructions per word of window starts (four u8 or two u16
#: windows) in the kernels' SWAR formulation, at u8 and u16 alike: the
#: carry-free diff of a check's two words, and the xor and zero-element
#: detect that compare a diff with the expected value (the SASS counts in
#: ``csrc/swar_counts.cuh``)
DIFF_OPS = 5
EQUAL_OPS = 4


def _words(windows: int) -> int:
    """Words of window starts that hold *windows* u8 windows."""
    return -(-max(0, windows) // 4)


def a_bound(words_bytes: int, n_tiles: int, valid: int, length: int
            ) -> tuple[float, str]:
    """Kernel A's bound on u8 words (``bench.bound``): every byte read once,
    the counts written, and one diff and compare per word of window starts,
    the first check's; the further checks of the one window in 256 that
    passes it are left out."""
    return bound(words_bytes + 4 * n_tiles,
                 (DIFF_OPS + EQUAL_OPS) * _words(valid - length + 1))


def first_pairs(table: torch.Tensor, last_starts: torch.Tensor
                ) -> dict[tuple[int, int], list[int]]:
    """Kernel C's first checks, from its operands
    (``scan_cuda.multi_operand``): ``{(cur, prev): [windows of each pattern
    whose first active check is that pair]}``; a pattern without an active
    check has none."""
    pairs: dict[tuple[int, int], list[int]] = {}
    for (cur, prev, _, active), last in zip(table.tolist(),
                                            last_starts.tolist()):
        j = next((j for j, on in enumerate(active) if on), None)
        if j is not None:
            pairs.setdefault((cur[j], prev[j]), []).append(last + 1)
    return pairs


def c_bound(words_bytes: int, n_tiles: int, table: torch.Tensor,
            last_starts: torch.Tensor) -> tuple[float, str]:
    """Kernel C's bound on u8 words (``bench.bound``): every byte read
    once, K rows of counts written; per word of window starts, one diff for
    each distinct
    first check pair (:func:`first_pairs`) and one compare for each
    pattern, as the kernel shares a diff among the patterns that start with
    its pair; the further checks of the windows that pass the first are left
    out."""
    ops = 0
    for windows in first_pairs(table, last_starts).values():
        words = [_words(w) for w in windows]
        ops += DIFF_OPS * max(words) + EQUAL_OPS * sum(words)
    return bound(words_bytes + 4 * len(last_starts) * n_tiles, ops)


def build_all(against: str | None) -> dict[str, ctypes.CDLL]:
    """``{tag: library}``: this checkout's counts kernels and the
    ``--against`` sources, each built by ``ops._build``, started
    together."""
    jobs = {"this": SOURCES}
    if against:
        jobs["against"] = sorted(Path(against).glob("tile_counts*.cu"))
        if not jobs["against"]:
            raise RuntimeError(f"{against}: no tile_counts*.cu")
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = {tag: pool.submit(compile_library, srcs, BUILD / f"{tag}.so")
                 for tag, srcs in jobs.items()}
        return {tag: open_library(path.result())
                for tag, path in paths.items()}

def count_a(lib, words, checks, tile_elems, length, valid):
    """One launch of *lib*'s kernel A on u8 words."""
    n_tiles = words.numel() * 4 // tile_elems - 1
    out = torch.empty(n_tiles, dtype=torch.int32, device=words.device)
    rc = lib.mm_tile_counts(
        words.data_ptr(), n_tiles, tile_elems, 1, checks.data_ptr(),
        int(checks.shape[1]), valid - length, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mm_tile_counts failed: CUDA error {rc}")
    return out


def count_c(lib, words, table, last_starts, tile_elems):
    """One launch of *lib*'s kernel C on u8 words."""
    n_tiles = words.numel() * 4 // tile_elems - 1
    out = torch.empty((table.shape[0], n_tiles), dtype=torch.int32,
                      device=words.device)
    rc = lib.mm_tile_counts_multi(
        words.data_ptr(), n_tiles, tile_elems, 1, table.data_ptr(),
        int(table.shape[0]), int(table.shape[2]), last_starts.data_ptr(),
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mm_tile_counts_multi failed: CUDA error {rc}")
    return out


def regimes(words: torch.Tensor):
    """``(row, run(lib), plain())`` per regime, on *words* (512 MiB plus
    the largest halo tile)."""
    out = []
    pat = compile_pattern("abcde")
    checks = scan_cuda.prefilter_operand(pat, words.device)
    for te in A_TILES:
        view = words[: (CHUNK_BYTES + te) // 4]
        n_tiles = CHUNK_BYTES // te
        valid = CHUNK_BYTES - 1234
        bound_ms, by = a_bound(view.numel() * 4, n_tiles, valid, pat.length)
        out.append((
            dict(kernel="A", keyword="abcde", tile_elems=te, bound_ms=bound_ms,
                 bound_by=by),
            lambda lib, v=view, te=te, valid=valid: count_a(
                lib, v, checks, te, pat.length, valid),
            lambda v=view, te=te, valid=valid: scan_cuda.tile_counts_plain(
                v, checks, width=1, tile_elems=te, length=pat.length,
                valid_count=valid)))
    te = A_TILES[0]
    view = words[: (CHUNK_BYTES + te) // 4]
    valid = CHUNK_BYTES - 1234
    for k in C_KS:
        pats = [compile_pattern(kw, wc) for kw, wc in BATCH[:k]]
        table, last_starts = scan_cuda.multi_operand(pats, valid,
                                                     words.device)
        bound_ms, by = c_bound(view.numel() * 4, CHUNK_BYTES // te, table,
                               last_starts)
        out.append((
            dict(kernel="C", k=k, tile_elems=te, bound_ms=bound_ms,
                 bound_by=by),
            lambda lib, t=table, ls=last_starts: count_c(lib, view, t, ls,
                                                         te),
            lambda t=table, ls=last_starts: scan_cuda.tile_counts_multi_plain(
                view, t, ls, width=1, tile_elems=te)))
    return out


def time_regimes(libs: dict, order: list[str], words: torch.Tensor) -> None:
    for row, run, plain in regimes(words):
        want = plain()
        for tag in order:
            if not torch.equal(run(libs[tag]), want):
                raise RuntimeError(f"{tag} differs from the plain version at "
                                   f"{row}")
            ms, host = back_to_back_ms(lambda: run(libs[tag]), LAUNCHES)
            print(json.dumps(dict(row, lib=tag, ms=ms, host_ms=host,
                                  pct_of_bound=100 * row["bound_ms"] / ms)),
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's csrc/ directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("counts_bench: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all(args.against)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    words = torch.randint(-(2**31), 2**31,
                          ((CHUNK_BYTES + max(A_TILES)) // 4,),
                          dtype=torch.int32, device="cuda", generator=gen)
    order = ["this"]
    if args.against:
        order = ["against", "this", "this", "against"]
    time_regimes(libs, order, words)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
