"""Time the counts kernels A, C and D on one CUDA card.

``python -m monkey_moore_tpu_torch.counts_bench [--against CSRC]``

Builds this checkout's ``csrc/tile_counts.cu``, ``tile_counts_elems.cu``
and ``tile_counts_multi.cu`` into a library of its own and times their
entry points, ``mm_tile_counts`` (A), ``mm_tile_counts_elems`` (D) and
``mm_tile_counts_multi`` (C), each by ``bench.back_to_back_ms``: many
launches between one pair of CUDA events.  Every output must equal the
plain version's (``ops.scan_cuda``).  The regimes, over a 512 MiB chunk of
seeded random words:

- A on ``abcde`` at u8, at the main path's 256 Ki-element tiles and at the
  bench path's 8 Ki-element tiles, and at u16 at the main path's tiles;
- C at the main path's tiles on the first K = 3, 8 and 16 keywords of
  :data:`BATCH`;
- D on ``abcde`` at the main path's tiles: the u8 and the u16 elements of
  A's bytes, and a copy of the u8 elements 1 byte past a 16-byte
  boundary (:func:`misaligned_copy`).

``--against CSRC`` also builds the ``tile_counts*.cu`` sources of another
checkout's ``csrc/`` directory (e.g. the parent commit's, unpacked with
``git archive``) and times them in turns with this one: against, this,
this, against (an older ``mm_tile_counts_elems`` that still takes the
largest check shift is called with it).  Prints one JSON object per
record, then the card's ``nvidia-smi`` name and power limit.  Without a
card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .bench import back_to_back_ms, bound
from .ops import scan_cuda
from .ops._build import compile_library, open_library
from .pattern import compile_pattern

__all__ = ["BATCH", "KEYWORD", "TE", "A_CASES", "C_KS", "D_CASES",
           "DIFF_OPS", "EQUAL_OPS", "a_bound", "misaligned_copy",
           "first_pairs", "c_bound", "build_all", "regimes", "main"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
SOURCES = [CSRC / "tile_counts.cu", CSRC / "tile_counts_elems.cu",
           CSRC / "tile_counts_multi.cu"]
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
#: the keyword of kernels A and D (the reference benchmark's)
KEYWORD = "abcde"
#: the main path's count tile (elements)
TE = 262_144
#: kernel A's regimes, (element width, tile elements): u8 at the main
#: path's and the bench path's tiles, u16 at the main path's
A_CASES = [(1, TE), (1, 8_192), (2, TE)]
#: kernel C's batch sizes, at the main path's tiles
C_KS = [3, 8, 16]
#: kernel D's regimes at the main path's tiles, (element width, bytes the
#: buffer starts past a 16-byte boundary): A's bytes as u8 and as u16
#: elements, and u8 elements that start inside a word
D_CASES = [(1, 0), (2, 0), (1, 1)]
_DTYPES = {1: np.uint8, 2: np.uint16}
#: the chunk and its largest halo tile (u16)
WORDS_BYTES = CHUNK_BYTES + 2 * TE


#: 32-bit instructions per word of window starts (four u8 or two u16
#: windows) in the kernels' SWAR formulation, at u8 and u16 alike: the
#: carry-free diff of a check's two words, and the xor and zero-element
#: detect that compare a diff with the expected value (the SASS counts in
#: ``csrc/swar_counts.cuh``)
DIFF_OPS = 5
EQUAL_OPS = 4


def _words(windows: int, width: int = 1) -> int:
    """Words of window starts that hold *windows* windows of *width*-byte
    elements (4 u8 or 2 u16 windows a word)."""
    return -(-max(0, windows) * width // 4)


def a_bound(words_bytes: int, n_tiles: int, valid: int, length: int,
            width: int = 1) -> tuple[float, str]:
    """Kernel A's bound (``bench.bound``), and kernel D's on the same
    bytes: every byte read once, the counts written, and one diff and
    compare per word of window starts (4 u8 or 2 u16 windows), the first
    check's; the further checks of the windows that pass it (one in 256 at
    u8, one in 65536 at u16) are left out."""
    return bound(words_bytes + 4 * n_tiles,
                 (DIFF_OPS + EQUAL_OPS) * _words(valid - length + 1, width))


def misaligned_copy(elems: torch.Tensor, offset: int) -> torch.Tensor:
    """A copy of *elems* (u8 or u16) on its device that starts *offset*
    bytes past a 16-byte boundary."""
    n_bytes = elems.numel() * elems.element_size()
    raw = torch.empty(n_bytes + 16, dtype=torch.uint8, device=elems.device)
    if raw.data_ptr() % 16:
        raise RuntimeError("an allocation is not 16-byte aligned")
    view = raw[offset : offset + n_bytes]
    view.copy_(elems.view(torch.uint8))
    return view.view(elems.dtype)


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
        libs = {tag: open_library(path.result())
                for tag, path in paths.items()}
    if against:
        _bind_older_d(libs["against"], Path(against) / "tile_counts_elems.cu")
    return libs


def _bind_older_d(lib, source: Path) -> None:
    """Gives *lib*'s kernel D the argument list of its *source* where that
    is an older one, which held the largest check shift before the limit;
    :func:`count_d` then passes it."""
    if source.exists() and "int max_shift" in source.read_text():
        fn = lib.mm_tile_counts_elems
        fn.argtypes = [*fn.argtypes[:6], ctypes.c_int, *fn.argtypes[6:]]
        lib.d_max_shift = True


def count_a(lib, words, checks, width, tile_elems, length, valid):
    """One launch of *lib*'s kernel A on words of u8 or u16 elements."""
    n_tiles = words.numel() * 4 // (width * tile_elems) - 1
    out = torch.empty(n_tiles, dtype=torch.int32, device=words.device)
    rc = lib.mm_tile_counts(
        words.data_ptr(), n_tiles, tile_elems, width, checks.data_ptr(),
        int(checks.shape[1]), valid - length, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mm_tile_counts failed: CUDA error {rc}")
    return out


def count_d(lib, elems, checks, tile_elems, length, valid):
    """One launch of *lib*'s kernel D on u8 or u16 elements."""
    n_tiles = elems.numel() // tile_elems - 1
    out = torch.empty(n_tiles, dtype=torch.int32, device=elems.device)
    shift = (length - 1,) if getattr(lib, "d_max_shift", False) else ()
    rc = lib.mm_tile_counts_elems(
        elems.data_ptr(), n_tiles, tile_elems, elems.element_size(),
        checks.data_ptr(), int(checks.shape[1]), *shift, valid - length,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mm_tile_counts_elems failed: CUDA error {rc}")
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
    """``(row, run(lib), plain())`` per regime, on *words*
    (:data:`WORDS_BYTES`, from a 16-byte aligned address)."""
    out = []
    raw = words.view(torch.uint8)
    length = len(KEYWORD)  # the pattern's elements, one per letter
    for width, te in A_CASES:
        pat = compile_pattern(KEYWORD, dtype=_DTYPES[width])
        checks = scan_cuda.prefilter_operand(pat, words.device)
        n_tiles = CHUNK_BYTES // (te * width)
        view = words[: (n_tiles + 1) * te * width // 4]
        valid = n_tiles * te - 1234
        bound_ms, by = a_bound(view.numel() * 4, n_tiles, valid, length,
                               width)
        out.append((
            dict(kernel="A", keyword=KEYWORD, width=width, tile_elems=te,
                 bound_ms=bound_ms, bound_by=by),
            lambda lib, v=view, c=checks, w=width, te=te, valid=valid: (
                count_a(lib, v, c, w, te, length, valid)),
            lambda v=view, c=checks, w=width, te=te, valid=valid: (
                scan_cuda.tile_counts_plain(v, c, width=w, tile_elems=te,
                                            length=length,
                                            valid_count=valid))))
    view = words[: (CHUNK_BYTES + TE) // 4]
    valid = CHUNK_BYTES - 1234
    for k in C_KS:
        pats = [compile_pattern(kw, wc) for kw, wc in BATCH[:k]]
        table, last_starts = scan_cuda.multi_operand(pats, valid,
                                                     words.device)
        bound_ms, by = c_bound(view.numel() * 4, CHUNK_BYTES // TE, table,
                               last_starts)
        out.append((
            dict(kernel="C", k=k, tile_elems=TE, bound_ms=bound_ms,
                 bound_by=by),
            lambda lib, t=table, ls=last_starts: count_c(lib, view, t, ls,
                                                         TE),
            lambda t=table, ls=last_starts: scan_cuda.tile_counts_multi_plain(
                view, t, ls, width=1, tile_elems=TE)))
    for width, offset in D_CASES:
        pat = compile_pattern(KEYWORD, dtype=_DTYPES[width])
        checks = scan_cuda.prefilter_operand(pat, words.device)
        n_tiles = CHUNK_BYTES // (TE * width)
        n_bytes = (n_tiles + 1) * TE * width
        elems = raw[:n_bytes]
        elems = elems.view(torch.uint16) if width == 2 else elems
        elems = misaligned_copy(elems, offset) if offset else elems
        valid = n_tiles * TE - 1234
        bound_ms, by = a_bound(n_bytes, n_tiles, valid, length, width)
        out.append((
            dict(kernel="D", keyword=KEYWORD, width=width, offset=offset,
                 tile_elems=TE, bound_ms=bound_ms, bound_by=by),
            lambda lib, e=elems, c=checks, valid=valid: count_d(
                lib, e, c, TE, length, valid),
            lambda e=elems, c=checks, valid=valid: (
                scan_cuda.tile_counts_elems_plain(
                    e, c, tile_elems=TE, length=length,
                    valid_count=valid))))
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
    words = torch.randint(-(2**31), 2**31, (WORDS_BYTES // 4,),
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
