"""The dense scan's chunk geometry and candidate grouping, shared by
``engine.SearchEngine`` and ``multi.MultiSearcher``.

- :func:`chunk_plan` — the count tile, the window starts a chunk owns, the
  chunk array's length (its tiles plus one halo tile) and the chunk count;
  :meth:`ChunkPlan.steps` enumerates one chunk's (alignment, count) steps;
- :func:`mesh_tile_elems` — the count tile of a corpus resident across a
  mesh;
- :func:`decode_grid` — elements of one alignment grid decoded on the host
  (the JAX package's ``_decode_grid`` of its engine and batch searcher);
- :class:`CandidateRecorder` — a keyword's candidates grouped by (block,
  alignment) for ``engine.finalize_candidates``.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import numpy as np

from .ops.host import TILE_ELEMS
from .preview import decode_elements

__all__ = [
    "CandidateRecorder",
    "ChunkPlan",
    "chunk_plan",
    "decode_grid",
    "grid_elems",
    "mesh_tile_elems",
]


def grid_elems(file_size: int, width: int, align: int) -> int:
    """Valid element count of alignment grid *align* (mirrors the
    per-block ``data_count`` trim, ``search_engine.cpp:137-141``)."""
    return max(0, (file_size - align) // width)


class ChunkPlan(NamedTuple):
    """How a dense scan cuts a file into chunks (:func:`chunk_plan`)."""

    file_size: int
    width: int  #: element width in bytes
    l_max: int  #: the longest keyword
    tile_elems: int  #: count tile
    chunk_elems: int  #: window starts each chunk owns
    want: int  #: elements of a chunk array: its tiles and one halo tile
    n_chunks: int

    def steps(self, k: int, l_min: int) -> Iterator[Tuple[int, int, int]]:
        """``(alignment, e0, count_here)`` of chunk *k*'s steps: the chunk
        of each alignment grid that holds a window of the shortest
        keyword, *l_min* elements."""
        e0 = k * self.chunk_elems
        for a in range(self.width):
            n_a = grid_elems(self.file_size, self.width, a)
            if e0 >= n_a:
                continue
            count_here = min(self.chunk_elems + self.l_max - 1, n_a - e0)
            if count_here < l_min:
                continue
            yield a, e0, count_here

    def host_chunk(self, data, endianness, a: int, e0: int,
                   count: int) -> np.ndarray:
        """The chunk array of a step decoded on the host from the file's
        bytes *data*: its *count* elements, padded with zeros to
        ``want``."""
        arr = decode_grid(data, self.width, endianness, a, e0, count)
        if len(arr) < self.want:
            arr = np.pad(arr, (0, self.want - len(arr)))
        return arr


def chunk_plan(file_size: int, width: int, l_max: int,
               chunk_bytes: int) -> ChunkPlan:
    """The chunk geometry of a scan of *file_size* bytes in elements of
    *width* bytes for keywords of at most *l_max* elements."""
    # Chunk span is a whole number of count tiles; each chunk array adds
    # one halo/padding tile so cross-chunk windows read real data.
    # Clamped by the file size, rounded up to a power of two.
    size_bucket = 1 << (max(file_size, 1) - 1).bit_length()
    desired = max(l_max, min(chunk_bytes, size_bucket) // width)
    tile_elems = min(TILE_ELEMS, 1 << (desired - 1).bit_length())
    tiles_per_chunk = max(1, desired // tile_elems)
    chunk_elems = tiles_per_chunk * tile_elems
    n_max = max(grid_elems(file_size, width, a) for a in range(width))
    return ChunkPlan(
        file_size, width, l_max, tile_elems, chunk_elems,
        (tiles_per_chunk + 1) * tile_elems,
        max(1, -(-n_max // chunk_elems)),
    )


def mesh_tile_elems(file_size: int, n_dev: int, l_max: int) -> int:
    """The count tile of a corpus resident across *n_dev* shards: a
    gathered slot spans a tile and ONE halo tile and the shard halo is one
    tile, so the tile must cover the longest window."""
    per_dev = -(-max(1, file_size) // n_dev)
    return min(
        TILE_ELEMS,
        max(64, 1 << (per_dev - 1).bit_length(),
            1 << (l_max - 1).bit_length()),
    )


def decode_grid(data, width: int, endianness, align: int, e_start: int,
                e_count: int) -> np.ndarray:
    """Elements [e_start, e_start+e_count) of an alignment grid of the
    file's bytes *data*."""
    b0 = align + e_start * width
    raw = data[b0 : b0 + e_count * width]
    return decode_elements(raw.tobytes(), width, endianness)


class CandidateRecorder:
    """One keyword's candidates as ``engine.finalize_candidates`` takes
    them: ``per_group`` {(block_id, alignment): [element offsets]} and
    ``candidate_info`` {(alignment, element offset): (byte_offset,
    values)}.  With *own_bytes* (lo, hi), only window starts inside that
    byte interval are kept (a multi-host run's share)."""

    def __init__(self, width: int, base: int, own_bytes=None):
        self.width = width
        self.base = base
        self.own_bytes = own_bytes
        self.per_group: dict = {}
        self.candidate_info: dict = {}

    def add(self, a: int, e0: int, offs: np.ndarray, vals: np.ndarray,
            below: int | None = None) -> int:
        """Record the windows at elements ``e0 + offs`` of grid *a*, with
        their recovery values *vals*; with *below*, only offsets under it
        (a span owns its starts in [0, below)).  Returns how many it
        kept."""
        if below is not None:
            keep = offs < below
            offs, vals = offs[keep], vals[keep]
        s, base, own = self.width, self.base, self.own_bytes
        per_group, info = self.per_group, self.candidate_info
        kept = 0
        for off, val in zip(offs.tolist(), vals.tolist()):
            e_global = e0 + off
            byte_off = a + e_global * s
            if own is not None and not own[0] <= byte_off < own[1]:
                continue
            kept += 1
            per_group.setdefault((byte_off // base, a), []).append(e_global)
            info[(a, e_global)] = (byte_off, val)
        return kept

    def gathered(self, gather, timer) -> "CandidateRecorder":
        """Every process's candidates: this recorder's flattened, passed
        through the collective *gather* and regrouped from their global
        byte offsets."""
        items = sorted(self.candidate_info.items())
        offs = np.array([v[0] for _, v in items], dtype=np.int64)
        vals = np.array(
            [list(v[1]) for _, v in items], dtype=np.int64
        ).reshape(-1, 2)
        with timer.stage("gather"):
            offs, vals = gather(offs, vals)
        out = CandidateRecorder(self.width, self.base)
        for a in range(self.width):
            at = offs % self.width == a
            out.add(a, 0, (offs[at] - a) // self.width, vals[at])
        return out
