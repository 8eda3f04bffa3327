"""Code point → UTF-8 helpers (parity with ``src/core/encoding.hpp:25-28``).

The PyTorch port's copy of the JAX package's ``utils/encoding.py``.
"""

from __future__ import annotations

__all__ = ["to_utf8", "codepoint_to_str"]


def codepoint_to_str(codepoint: int) -> str:
    """Unicode code point → Python str (one character)."""
    return chr(codepoint)


def to_utf8(codepoint: int) -> bytes:
    """Unicode code point → UTF-8 bytes (``encoding.hpp:25-28``)."""
    return chr(codepoint).encode("utf-8")
