"""Text/sequence utilities.

The PyTorch port's copy of the JAX package's ``utils/text.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

TPU-native counterpart of ``include/mmoore/text_utils.hpp:14-56``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

__all__ = [
    "find_last_index",
    "count_prefix_length",
    "is_ascii_upper",
    "is_ascii_lower",
    "is_ascii_digit",
    "to_codepoints",
]


def find_last_index(seq: Sequence, value) -> int:
    """Index of the last occurrence of *value* in *seq*, or -1.

    Parity: ``find_last_index`` (``text_utils.hpp:14-23``).
    """
    last = -1
    for i, v in enumerate(seq):
        if v == value:
            last = i
    return last


def count_prefix_length(seq: Iterable, value) -> int:
    """Number of consecutive leading elements equal to *value*.

    Parity: ``count_prefix_length`` (``text_utils.hpp:28-34``).
    """
    n = 0
    for v in seq:
        if v != value:
            break
        n += 1
    return n


def is_ascii_upper(c: int) -> bool:
    """True for ASCII 'A'-'Z' (``text_utils.hpp:39-41``)."""
    return 0x41 <= c <= 0x5A


def is_ascii_lower(c: int) -> bool:
    """True for ASCII 'a'-'z' (``text_utils.hpp:46-48``)."""
    return 0x61 <= c <= 0x7A


def is_ascii_digit(c: int) -> bool:
    """True for ASCII '0'-'9' (``text_utils.hpp:53-55``)."""
    return 0x30 <= c <= 0x39


def to_codepoints(s: Union[str, Sequence[int], None]) -> tuple:
    """Normalize a keyword/sequence argument to a tuple of Unicode code points."""
    if s is None:
        return ()
    if isinstance(s, str):
        return tuple(ord(c) for c in s)
    return tuple(int(c) for c in s)
