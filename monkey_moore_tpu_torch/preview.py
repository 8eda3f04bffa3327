"""Match preview generation.

The PyTorch port's copy of the JAX package's ``preview.py``
(``tests/test_torch_copies.py`` holds it equal to the original).

Builds the human-readable context string shown next to each match, decoding
the surrounding window through the recovered equivalency map.  Byte-exact
port of the reference's preview semantics:

- window placement math     — ``src/core/search_engine.cpp:256-300``
- equivalency-map decoding  — ``src/core/search_engine.cpp:302-348``
  ('a'/'A' expand to 26 letters with element-width wraparound; unmapped
  values render ``"#"``; value-scan previews are uppercase hex dumps)
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .config import Endianness
from .utils.memory import align_up

__all__ = ["preview_window", "decode_raw_data", "generate_preview"]


def preview_window(
    match_offset: int,
    file_size: int,
    keyword_len: int,
    preview_width: int,
    element_size: int,
) -> int:
    """Byte offset where the preview window starts.

    Mirrors ``generate_preview`` (``search_engine.cpp:263-284``): center the
    match, align the backup distance up to the element size, clamp at EOF
    (shift left) and at file start (clamp the seek to 0).
    """
    kw_half = keyword_len // 2
    window_half = preview_width // 2
    positions_to_backup = window_half - kw_half
    bytes_to_backup = positions_to_backup * element_size
    bytes_to_backup = align_up(bytes_to_backup, element_size) if element_size > 1 else bytes_to_backup
    start = match_offset - bytes_to_backup
    end = start + preview_width * element_size
    if end > file_size:
        start -= end - file_size
    return max(0, start)


def decode_elements(raw: bytes, element_size: int, endianness: Endianness) -> np.ndarray:
    """Bytes → element values honoring configured byte order.

    Equivalent to the reference's raw reinterpret + ``adjust_endianness``
    (``search_engine.cpp:286-297``, ``byteswap.hpp:70-79``) but
    platform-independent: elements are decoded explicitly from byte pairs.
    """
    if element_size == 1:
        return np.frombuffer(raw, dtype=np.uint8)
    n = len(raw) // 2
    b = np.frombuffer(raw[: n * 2], dtype=np.uint8).reshape(n, 2).astype(np.uint16)
    if endianness is Endianness.LITTLE:
        return b[:, 0] | (b[:, 1] << 8)
    return (b[:, 0] << 8) | b[:, 1]


def decode_raw_data(
    values_map: Dict[int, int],
    raw_data: np.ndarray,
    is_relative_search: bool,
    is_ascii_search: bool,
    element_size: int,
) -> str:
    """Element values → preview string via the equivalency map.

    Parity: ``decode_raw_data`` (``search_engine.cpp:302-348``).
    """
    if not is_relative_search:
        width = element_size * 2
        return " ".join(f"{int(v):0{width}X}" for v in raw_data)

    mod = 1 << (8 * element_size)
    decoding: Dict[int, str] = {}
    for char, value in values_map.items():
        if is_ascii_search and char in (ord("a"), ord("A")):
            for letter in range(26):
                decoding[(int(value) + letter) % mod] = chr(char + letter)
        else:
            decoding[int(value)] = chr(char)

    return "".join(decoding.get(int(v), "#") for v in raw_data)


def generate_preview(
    file_bytes,
    file_size: int,
    match_offset: int,
    values_map: Dict[int, int],
    keyword_len: int,
    preview_width: int,
    element_size: int,
    endianness: Endianness,
    is_relative_search: bool,
    is_ascii_search: bool,
) -> str:
    """Full preview for one match. ``file_bytes`` is any random-access bytes
    view (memmap / bytes)."""
    start = preview_window(
        match_offset, file_size, keyword_len, preview_width, element_size
    )
    raw = bytes(file_bytes[start : start + preview_width * element_size])
    elements = decode_elements(raw, element_size, endianness)
    return decode_raw_data(
        values_map, elements, is_relative_search, is_ascii_search, element_size
    )
