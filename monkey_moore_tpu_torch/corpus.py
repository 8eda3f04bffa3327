"""Resident device corpus — counterpart of the JAX package's ``corpus.py``.

The interactive workflow uploads a ROM or binary image to the device once
and runs every search against the resident bytes.  The bytes live as a flat
little-endian int32 word tensor; every element grid the engine needs (8 or
16-bit, either endianness, any byte alignment, packed words or elements) is
derived from it on the device with word shifts and byte swaps, one pass of
kernel M (``ops/scan_cuda.derive_words``).  Word offsets are Python ints
(64-bit), so corpora past 2^31 bytes address correctly.

A process-wide cache holds the most recent corpus, keyed by
(path, size, mtime, device).
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from .carry import require_own
from .config import Endianness
from .ops import scan_cuda
from .profiling import count, span

__all__ = [
    "ResidentCorpus",
    "cached_corpus",
    "derive_words",
    "get_resident_corpus",
    "clear_corpus_cache",
]

_cache: dict = {}
_cache_lock = threading.Lock()


def derive_words(raw: torch.Tensor, byte_shift: int, element_width: int,
                 big: bool) -> torch.Tensor:
    """The grid words of ``raw[:-1]`` (int32 words of a little-endian byte
    stream plus one word to borrow from): the stream shifted down by
    ``byte_shift`` bytes, then each 16-bit element byte-swapped when
    ``big``.  A view of ``raw[:-1]`` where there is nothing to derive;
    otherwise one pass of kernel M (``scan_cuda.derive_words``; its plain
    version on the CPU)."""
    swap = element_width == 2 and big
    if not (byte_shift or swap):
        return raw[:-1]  # a view: nothing to derive
    with span("mm.corpus.derive"):
        return scan_cuda.derive_words(raw, byte_shift, element_width, big)


class ResidentCorpus:
    """Device-resident corpus for one file, stored as flat LE int32 words."""

    def __init__(self, data_bytes: np.ndarray, pad_bytes: int, device="cuda"):
        self.n_bytes = len(data_bytes)
        # pad to whole words + one spare word (the byte shift borrows from
        # the next word)
        total = -(-(self.n_bytes + pad_bytes + 4) // 4) * 4
        with span("mm.corpus.pad"):
            padded = np.zeros(total, dtype=np.uint8)
            padded[: self.n_bytes] = data_bytes
        count("corpus.pad_bytes", total)
        self._set_words(padded.view("<i4"), device)

    @classmethod
    def from_words(cls, words: np.ndarray, n_bytes: int,
                   device="cuda") -> "ResidentCorpus":
        """A corpus over an existing little-endian int32 word array (for
        example ``np.asarray(jax_corpus.device_words)``), so two packages
        derive their grids from identical state."""
        self = cls.__new__(cls)
        self.n_bytes = n_bytes
        self._set_words(np.array(words, dtype="<i4"), device)  # own copy
        return self

    def _set_words(self, words: np.ndarray, device) -> None:
        # a synchronous copy: the corpus is on the device on return
        with span("mm.corpus.h2d"):
            self.device_words = torch.from_numpy(
                words.view(np.int32)).to(device)
        count("corpus.h2d_bytes", words.nbytes)
        #: True until the first engine run accounts the upload in its stats
        self.fresh = True

    def __len__(self):
        """Byte capacity of the device buffer."""
        return self.device_words.numel() * 4

    def windows(self, starts: Sequence[int], length: int) -> List[bytes]:
        """The file's bytes ``[start, start + length)`` for each of
        *starts*, cut at the file's end as a slice of the file is: one
        gather on the corpus's device and one copy back."""
        raw = self.device_words.view(torch.uint8)
        first = torch.tensor(list(starts), dtype=torch.int64,
                             device=raw.device)
        index = first[:, None] + torch.arange(length, device=raw.device)
        rows = raw[index.clamp_(max=raw.numel() - 1)].cpu().numpy()
        return [row[: max(0, self.n_bytes - b)].tobytes()
                for row, b in zip(rows, starts)]

    def grid_chunk(
        self,
        element_width: int,
        endianness: Endianness,
        align: int,
        e_start: int,
        want_elems: int,
        packed: bool = False,
    ) -> torch.Tensor:
        """``want_elems`` elements of the (alignment, endianness) grid from
        element ``e_start``, on the corpus's device (a view of the words
        where the grid needs no shift or swap).  Reads past EOF yield
        padding zeros (masked by the caller's valid count).

        ``packed=True`` returns the counts kernel's little-endian int32 word
        layout (4 bytes, so 4 or 2 elements, per word); otherwise u8 or u16
        elements.  ``endianness`` must be the port's ``Endianness``."""
        require_own(endianness, Endianness, "grid_chunk: endianness")
        s = element_width
        b0 = align + e_start * s
        byte_shift = b0 % 4
        n_words = -(-(want_elems * s) // 4)
        words = self.device_words
        # a slice start past the end is clamped back, as a JAX dynamic
        # slice does
        start = max(0, min(b0 // 4, words.numel() - (n_words + 1)))
        w = derive_words(words[start : start + n_words + 1], byte_shift, s,
                         endianness is Endianness.BIG)
        if packed:
            return w
        return w.view(torch.uint8 if s == 1 else torch.uint16)[:want_elems]


def get_resident_corpus(
    path, file_size: int, limit_bytes: int, pad_bytes: int, device="cuda"
) -> Optional[ResidentCorpus]:
    """Cached resident corpus for *path* on *device*, or None when over the
    limit or the device cannot hold it.  Holds one corpus (the most
    recent)."""
    if limit_bytes <= 0 or file_size > limit_bytes or file_size == 0:
        return None
    p = Path(path)
    try:
        key = _key(p, device)
    except OSError:
        return None
    # miss-check + build under the lock: concurrent searches must not
    # double-upload a multi-GiB corpus
    with _cache_lock:
        hit = _cache.get(key)
        if hit is not None and len(hit) >= file_size + pad_bytes:
            return hit
        _cache.clear()
        try:
            with span("mm.corpus.read"):
                data = np.fromfile(p, dtype=np.uint8)
            count("corpus.read_bytes", data.nbytes)
            corpus = ResidentCorpus(data, pad_bytes, device)
        except (OSError, torch.cuda.OutOfMemoryError):
            return None
        _cache[key] = corpus
        return corpus


def _key(path: Path, device) -> tuple:
    stat = path.stat()
    return (str(path.resolve()), stat.st_size, stat.st_mtime_ns,
            str(torch.device(device)))


def cached_corpus(path, device) -> Optional[ResidentCorpus]:
    """The cached resident corpus of *path* as it is now on *device*, or
    None; uploads nothing."""
    try:
        key = _key(Path(path), device)
    except OSError:
        return None
    with _cache_lock:
        return _cache.get(key)


def clear_corpus_cache() -> None:
    with _cache_lock:
        _cache.clear()
