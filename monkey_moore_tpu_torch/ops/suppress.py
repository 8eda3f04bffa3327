"""Candidate suppression — reconciling dense scan output with the
reference's sequential match semantics.

The PyTorch port's copy of the JAX package's ``ops/suppress.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

The dense kernels emit *every* matching window (``MatchSemantics.ALL``).  The
reference's walk instead advances the head by ``advance`` after each match
(``src/core/monkey_moore.cpp:398,526-527``), suppressing overlapping matches
closer than ``advance``.  Greedy replay over the sparse candidate list
reproduces that for every case except the rare skip-overshoot quirk (see
``config.MatchSemantics``); it is O(matches) host work.
"""

from __future__ import annotations

import numpy as np

__all__ = ["greedy_suppress"]


def greedy_suppress(offsets: np.ndarray, advance: int) -> np.ndarray:
    """Greedy left-to-right acceptance with a fixed post-match advance.

    ``offsets`` must be sorted ascending.  Accept a candidate iff it is not
    within ``advance - 1`` positions after the previously accepted one —
    exactly the reachability constraint the reference's head movement imposes
    on matches (head can land on any position >= last_match + advance, and
    mismatch jumps are >= 1).
    """
    offsets = np.asarray(offsets, dtype=np.int64)
    if advance <= 1 or len(offsets) <= 1:
        return offsets
    out = []
    head = np.iinfo(np.int64).min
    for c in offsets.tolist():
        if c >= head:
            out.append(c)
            head = c + advance
    return np.asarray(out, dtype=np.int64)
