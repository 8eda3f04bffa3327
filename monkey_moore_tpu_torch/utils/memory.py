"""Alignment helpers (parity with ``src/core/memory_utils.hpp:13-23``).

The PyTorch port's copy of the JAX package's ``utils/memory.py``.
"""

from __future__ import annotations

__all__ = ["align_up"]


def align_up(num: int, alignment: int) -> int:
    """Round *num* up to the next multiple of *alignment* (a power of two).

    Parity: ``align_up<Alignment>`` (``memory_utils.hpp:13-23``).
    """
    if alignment <= 0 or (alignment & (alignment - 1)) != 0:
        raise ValueError("alignment must be a positive power of 2")
    mask = alignment - 1
    return (num + mask) & ~mask
