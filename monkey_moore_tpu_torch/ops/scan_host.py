"""Host latency path — full-file dense scan with zero dispatch latency.

The PyTorch port's copy of the JAX package's ``ops/scan_host.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

The reference's entire benchmark range is 128 KiB-16 MiB
(``benchmarks/bench_search.cpp:70``) and its engine default
block is 512 KiB (``include/mmoore/search_engine.hpp:36``).  At those sizes a
TPU dispatch's *fixed* cost (relay round trip, compile-cache lookup, D2H
fetch) dwarfs the scan itself, so the engine routes small searches here: the
C dense scanner (``native/mm_walker.cpp:mm_dense_scan_*``, ~memory-bandwidth
throughput) or the NumPy matcher finds ALL candidate window starts on the
host, and the usual suppress/recover/finalize pipeline runs unchanged.

Semantics are identical to the device path's phase-1+2 result: every
matching window start, exact (``ops/scan_np.match_positions_np`` semantics,
fuzz-checked against the native scanner in tests/test_native.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..config import Endianness
from ..pattern import CompiledPattern
from .recover import recovery_shifts
from .scan_np import match_positions_np

__all__ = [
    "host_candidates",
    "host_candidates_values",
    "decode_grid_host",
    "host_grid_view",
]


def host_candidates(
    pat: CompiledPattern, arr: np.ndarray, bswap: bool = False
) -> np.ndarray:
    """ALL matching window starts in *arr*, ascending — native C scanner
    when available, NumPy matcher otherwise.

    ``bswap``: *arr* is a native-order view of big-endian u16 bytes; the
    C scanner byteswaps on load (zero-copy).  The NumPy fallback pays the
    byteswap copy the native path avoids."""
    from ..native import native_dense_scan

    offs = native_dense_scan(pat, arr, bswap=bswap)
    if offs is None:
        offs = match_positions_np(pat, arr.byteswap() if bswap else arr)
    return offs


def host_candidates_values(
    pat: CompiledPattern, arr: np.ndarray, bswap: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """(offsets, recovery values [M, 2]) — the host twin of the fused
    device step's output."""
    offs = host_candidates(pat, arr, bswap=bswap)
    if len(offs) == 0:
        return offs, np.zeros((0, 2), dtype=np.int64)
    shifts = recovery_shifts(pat)
    n = len(arr)
    v0 = arr[np.minimum(offs + shifts[0], n - 1)]
    v1 = arr[
        np.minimum(offs + (shifts[1] if len(shifts) > 1 else shifts[0]), n - 1)
    ]
    if bswap:
        # the gathered candidates are O(matches) — swap just those
        v0, v1 = v0.byteswap(), v1.byteswap()
    return offs, np.stack(
        [v0.astype(np.int64), v1.astype(np.int64)], axis=1
    )


def host_grid_view(
    data: np.ndarray,
    file_size: int,
    element_width: int,
    endianness: Endianness,
    align: int,
) -> Tuple[np.ndarray, bool]:
    """(element view, needs_bswap) for the host scan path: identical to
    :func:`decode_grid_host` except 16-bit big-endian returns the raw
    native-order view plus ``True`` — the C scanner byteswaps on load, so
    BE searches skip the full-grid decode copy entirely."""
    s = element_width
    if s == 1 or endianness is not Endianness.BIG:
        return decode_grid_host(
            data, file_size, s, endianness, align
        ), False
    count = max(0, (file_size - align) // s)
    return data[align : align + count * s].view(np.uint16), True


def decode_grid_host(
    data: np.ndarray,
    file_size: int,
    element_width: int,
    endianness: Endianness,
    align: int,
) -> np.ndarray:
    """Full element grid of one (alignment, endianness) view, avoiding
    copies where the raw bytes already have the right layout:

    - 8-bit: the memmap itself (zero-copy);
    - 16-bit little-endian: an in-place ``view(uint16)`` of the byte slice
      (NumPy handles the odd-alignment grid without copying);
    - 16-bit big-endian: one ``astype`` byteswap pass (the unavoidable
      analog of ``adjust_endianness``, ``byteswap.hpp:70-79``).
    """
    s = element_width
    count = max(0, (file_size - align) // s)
    raw = data[align : align + count * s]
    if s == 1:
        return raw
    if endianness is Endianness.BIG:
        return raw.view(np.dtype(">u2")).astype(np.uint16)
    return raw.view(np.uint16)
