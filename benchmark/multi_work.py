"""The work of the keyword-batch counts kernel (C, ``swar_counts_kernel``
under ``MultiSearcher``): a copy of the program's ``counts_bench.c_bound``
count, kept here so that a change to the program cannot move the
yardstick, fed by the program's counters of a traced run:

- ``kernel.counts_multi``: C's launches;
- ``kernel.counts_multi_bytes``: the bytes of words they read, each once
  (every launch's tiles plus its halo tile);
- ``kernel.counts_multi_windows``: window starts summed over the batch's
  keywords, launch by launch;
- ``kernel.counts_multi_first_windows``: window starts summed over the
  distinct first check pairs, each pair's largest (C computes a pair's
  diff once for the keywords that begin with it);
- ``multi.keywords``: K, once a request.

A launch writes K rows of one int32 count a tile, of
:data:`TILE_ELEMS`-element tiles (the main path's), so its tiles are its
bytes over a tile's bytes less the halo tile.  The operations are
``stats.DIFF_OPS`` per word of first-pair window starts plus
``stats.EQUAL_OPS`` per word of keyword window starts (4 u8 or 2 u16
windows a word); the further checks of the windows that pass the first
(one in 2^(8 x width) on random data) are left out, as ``c_bound`` leaves
them.
"""

from __future__ import annotations

from typing import Optional, Tuple

from benchmark.stats import DIFF_OPS, EQUAL_OPS

#: the main path's count tile (elements)
TILE_ELEMS = 262_144
COUNTERS = ("kernel.counts_multi", "kernel.counts_multi_bytes",
            "kernel.counts_multi_windows", "kernel.counts_multi_first_windows",
            "multi.keywords")


def words(windows: int, width: int) -> int:
    """Words that hold *windows* window starts of *width*-byte elements."""
    return -(-max(0, windows) * width // 4)


def c_work(launches: int, word_bytes: int, windows: int, first_windows: int,
           keywords: int, width: int) -> Tuple[int, int]:
    """``(bytes, operations)`` of *launches* launches of C over
    *word_bytes* bytes of words, for a batch of *keywords* keywords."""
    tiles = word_bytes // (width * TILE_ELEMS) - launches
    n_bytes = word_bytes + 4 * keywords * tiles
    n_ops = (DIFF_OPS * words(first_windows, width)
             + EQUAL_OPS * words(windows, width))
    return n_bytes, n_ops


def record_work(record, width: int) -> Optional[Tuple[int, int]]:
    """``c_work`` of one request's span record, or None where it counted
    no launch of C."""
    counters = record.counters
    if not counters.get("kernel.counts_multi"):
        return None
    launches, word_bytes, windows, first, keywords = (
        int(counters.get(name, 0)) for name in COUNTERS)
    return c_work(launches, word_bytes, windows, first, keywords, width)
