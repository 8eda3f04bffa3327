"""NumPy dense matcher — host-side phase-2 extraction and CPU fallback.

The PyTorch port's copy of the JAX package's ``ops/scan_np.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

The production scan is two-phase: the device computes per-tile match *counts*
at HBM bandwidth (``scan_pallas.py`` / ``scan_jnp.tile_counts``); the host
then extracts exact offsets only from the rare hot tiles using this
vectorized matcher.  Matches in a 64 KiB tile cost microseconds here, and the
device never materializes a giant offset compaction (which would dominate
compile and runtime).

Same semantics as ``scan_jnp.match_bitmap``: signed adjacent-diff compare for
SIMPLE/VALUE_SCAN (``src/core/monkey_moore.cpp:337-339``), unsigned
element-width wraparound compare for WILDCARD (``:461-464``).
"""

from __future__ import annotations

import numpy as np

from ..pattern import CompiledPattern

__all__ = ["match_positions_np"]


def match_positions_np(pat: CompiledPattern, arr: np.ndarray) -> np.ndarray:
    """All matching window starts in *arr* (1-D element array), ascending."""
    arr = np.asarray(arr, dtype=pat.dtype)
    n = len(arr)
    L = pat.length
    P = n - L + 1
    if P <= 0:
        return np.zeros(0, dtype=np.int64)

    ok = np.ones(P, dtype=bool)
    if pat.signed_compare:
        wide = arr.astype(np.int32)
        d1 = wide[1:] - wide[:-1]
        for c, e in enumerate(pat.chk_expected):
            ok &= d1[c : c + P] == e
    else:
        for cur, prev, e in zip(
            pat.chk_shift_cur, pat.chk_shift_prev, pat.chk_expected
        ):
            # element-dtype subtraction wraps mod 2^w, as the reference's
            # Ty arithmetic does
            ok &= (arr[cur : cur + P] - arr[prev : prev + P]) == e
    return np.nonzero(ok)[0].astype(np.int64)
