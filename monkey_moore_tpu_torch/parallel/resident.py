"""Sharded resident corpus — counterpart of the JAX package's
``parallel/resident.py``: upload once, scan many, across a mesh.

The file's bytes are cut into one run of little-endian int32 words per
shard, each uploaded ONCE to its shard's device.  Every element grid the
engine needs (8 or 16-bit, either endianness, either byte alignment) is
derived on each shard's device with the arithmetic of the single-device
corpus (:func:`..corpus.derive_words`), borrowing the first word of the
next shard (the last shard wraps; padding masks it), so repeat searches
and 16-bit or byte-swapped views upload no corpus bytes.

Each derived shard grid holds ``t_loc + 1`` count tiles: its own
``t_loc`` and, in place, a copy of the next shard's first tile — the halo
that the JAX step ``ppermute``s on every dispatch.  The corpus does not
change, so the port copies it once, when the grid is derived (a peer copy
when the two shards sit on different cards).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..carry import require_own
from ..config import Endianness
from ..corpus import derive_words
from ..ops.scan_cuda import prefilter_operand
from ..ops.scan_torch import as_elements, pattern_device_args
from .mesh import Mesh

__all__ = [
    "ShardedResidentCorpus",
    "get_sharded_corpus",
    "clear_sharded_corpus_cache",
]

_cache: dict = {}
_cache_lock = threading.Lock()

#: derived grids are memoized only below this size (each memoized grid is
#: another corpus-sized set of device buffers; big corpora re-derive per
#: search instead of doubling device memory)
_GRID_MEMO_LIMIT = 512 * 1024 * 1024


def _host_words(chunk: np.ndarray, n_bytes: int) -> np.ndarray:
    """*chunk* as ``n_bytes // 4`` little-endian int32 words, zero-padded,
    in memory torch may alias (a copy where the bytes are read-only or
    short)."""
    if len(chunk) < n_bytes or not chunk.flags.writeable \
            or not chunk.flags.c_contiguous:
        padded = np.zeros(n_bytes, dtype=np.uint8)
        padded[: len(chunk)] = chunk
        chunk = padded
    return chunk.view("<i4").view(np.int32)


class ShardedResidentCorpus:
    """One file resident across a mesh as packed little-endian int32
    words, one word tensor per shard on its device."""

    def __init__(self, data_bytes: np.ndarray, mesh: Mesh, tile_elems: int):
        require_own(mesh, Mesh, "ShardedResidentCorpus: mesh")
        if tile_elems <= 0 or tile_elems % 4:
            raise ValueError(
                f"tile_elems must be a positive multiple of 4: {tile_elems}"
            )
        self.mesh = mesh
        self.tile_elems = tile_elems
        self.n_bytes = len(data_bytes)
        d = len(mesh)
        self.n_devices = d

        # Unit = one 16-bit tile = 2*tile_elems bytes; B (bytes/device) a
        # whole number of units makes every grid's per-device element count
        # a whole number of count tiles (u8: 2 tiles/unit, u16: 1).
        unit = 2 * tile_elems
        units_total = max(1, -(-self.n_bytes // unit))  # ceil(bytes/unit)
        u_loc = -(-units_total // d)  # ceil(units/devices)
        self.bytes_per_device = u_loc * unit
        self.words_per_device = self.bytes_per_device // 4
        b = self.bytes_per_device
        self.device_words = tuple(
            torch.from_numpy(
                _host_words(data_bytes[i * b : (i + 1) * b], b)
            ).to(dev, copy=True)
            for i, dev in enumerate(mesh.devices)
        )
        self.uploaded_bytes = d * b
        #: True until the first engine run accounts the upload in its stats
        self.fresh = True
        self._grids: dict = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def t_loc(self, element_width: int) -> int:
        """Count tiles per device of an ``element_width`` grid."""
        return self.bytes_per_device // element_width // self.tile_elems

    def grid(self, element_width: int, endianness: Endianness, align: int,
             packed: bool = True) -> Tuple[torch.Tensor, ...]:
        """One (width, endianness, alignment) grid, per shard on its
        device: ``(t_loc + 1) * tile_elems`` elements each, the last tile a
        copy of the next shard's first (the last shard's wraps to shard 0).
        ``packed``: the counts kernels' little-endian int32 words;
        otherwise u8/u16 element views of the same buffers.  Memoized for
        corpora under ``_GRID_MEMO_LIMIT``."""
        require_own(endianness, Endianness, "grid: endianness")
        s = element_width
        key = (s, endianness is Endianness.BIG, align)
        with self._lock:
            shards = self._grids.get(key)
        if shards is None:
            shards = self._derive(s, endianness is Endianness.BIG, align)
            if self.n_bytes <= _GRID_MEMO_LIMIT:
                with self._lock:
                    self._grids[key] = shards
        if packed:
            return shards
        return tuple(as_elements(w, s) for w in shards)

    def _derive(self, s: int, big: bool, align: int):
        """Each shard's grid words, then the halo tiles copied in."""
        d = self.n_devices
        wpd = self.words_per_device
        tile_words = self.tile_elems * s // 4
        shards = []
        for i, dev in enumerate(self.mesh.devices):
            borrow = self.device_words[(i + 1) % d][:1].to(dev)
            raw = torch.cat([self.device_words[i], borrow])
            ext = torch.empty(wpd + tile_words, dtype=torch.int32,
                              device=dev)
            ext[:wpd].copy_(derive_words(raw, align, s, big))
            shards.append(ext)
        for i in range(d):
            shards[i][wpd:].copy_(shards[(i + 1) % d][:tile_words])
        return tuple(shards)

    def step_operands(self, pat, valid_count: int,
                      element_width: int) -> np.ndarray:
        """Per-shard valid element counts of one grid
        (:func:`.sharded.sharded_step_operands`); also builds the pattern's
        small device operands on every shard's device, so that the
        dispatch uploads nothing."""
        from .sharded import sharded_step_operands

        for dev in set(self.mesh.devices):
            prefilter_operand(pat, dev)
            pattern_device_args(pat, dev)
        return sharded_step_operands(
            valid_count, self.t_loc(element_width), self.tile_elems,
            self.n_devices,
        )


def get_sharded_corpus(
    path, file_size: int, mesh: Mesh, tile_elems: int, limit_bytes: int
) -> Optional[ShardedResidentCorpus]:
    """Cached sharded corpus for *path* on *mesh* (most recent held), or
    None when over the limit, unreadable, or the devices cannot hold it."""
    if limit_bytes <= 0 or file_size > limit_bytes or file_size == 0:
        return None
    p = Path(path)
    try:
        stat = p.stat()
    except OSError:
        return None
    key = (str(p.resolve()), stat.st_size, stat.st_mtime_ns, mesh.key(),
           tile_elems)
    # miss-check + build under the lock: concurrent searches must not
    # double-upload a multi-GiB corpus
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None:
            return hit
        _cache.clear()
        try:
            corpus = ShardedResidentCorpus(
                np.fromfile(p, dtype=np.uint8), mesh, tile_elems
            )
        except (OSError, torch.cuda.OutOfMemoryError):
            return None
        _cache[key] = corpus
        return corpus


def clear_sharded_corpus_cache() -> None:
    with _cache_lock:
        _cache.clear()
