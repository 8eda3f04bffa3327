"""Plain relative search: the reference that decides ``correct``.

Written from the semantics of the upstream Monkey-Moore engine as the
port's documentation states them, in plain NumPy and PyTorch, with no code
of the program:

- A keyword of L characters becomes L - 1 expected differences between
  successive values: of the code points (ASCII mode) or of the characters'
  indices in the custom sequence (a character missing from it counts as
  index 0).  A window of L elements matches when every difference between
  its successive elements equals the expected one as a signed integer
  (simple mode: no wraparound modulo the element width).
- Elements are 8-bit, or 16-bit in either byte order; a 16-bit search
  scans both byte alignments of the file.
- GREEDY semantics: the file is cut into logical blocks of
  ``preferred_search_block_size`` bytes.  Within each (block, alignment)
  the matching windows, ascending, are accepted greedily, a match
  suppressing every window that starts fewer than L - 1 elements after it.
  At 16 bits the reference reads ``(L - 1) * 2`` bytes past a block's end,
  so a match whose window does not fit in its block's trimmed element
  count is not reported.
- Each match's values map comes from the element at its start: ASCII mode
  maps 'A' and 'a' to their values under the match's shift, a custom
  sequence maps each of its characters.
- A preview is ``preferred_preview_width`` elements around the match,
  centred on the keyword, clamped to the file, decoded through the values
  map ('a'/'A' stand for 26 letters each; an unmapped value is '#').

``compare="wrap"`` compares the differences modulo 2^(8 * width) instead:
the control, which breaks the signed comparison that simple mode
guarantees.  Only keywords of simple mode (no wildcard, one case) are
supported.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["Keyword", "Grids", "search"]

Result = Tuple[int, Dict[int, int], str]


class Keyword:
    """A keyword's code points and the values its characters stand for."""

    def __init__(self, keyword: str, char_seq: str = "", wildcard: str = "*"):
        cps = [ord(c) for c in keyword]
        if len(cps) < 2:
            raise ValueError("a keyword has at least 2 characters")
        if ord(wildcard) in cps:
            raise ValueError("wildcard keywords are not supported")
        self.codepoints = cps
        self.seq = [ord(c) for c in char_seq]
        if not self.seq:
            upper = any(65 <= c <= 90 for c in cps)
            lower = any(97 <= c <= 122 for c in cps)
            if upper and lower:
                raise ValueError("mixed-case keywords are not supported")
            self.values = list(cps)
        else:
            index = {c: i for i, c in enumerate(self.seq)}
            self.index = index
            self.values = [index.get(c, 0) for c in cps]
        self.length = len(cps)
        self.diffs = [b - a for a, b in zip(self.values, self.values[1:])]


class Grids:
    """One file's bytes and, on *device*, the signed differences between
    successive elements of each byte alignment's grid (one grid at 8 bits,
    two at 16), computed once for every keyword."""

    def __init__(self, data: np.ndarray, width: int, big_endian: bool,
                 device="cpu"):
        self.data = data
        self.width = width
        self.big_endian = big_endian
        self.n_bytes = len(data)
        raw = torch.from_numpy(data).to(device)
        self.diffs = [_diffs(raw, a, width, big_endian) for a in range(width)]


def _diffs(raw: torch.Tensor, align: int, width: int,
           big_endian: bool) -> torch.Tensor:
    """int16 (8 bits) or int32 (16 bits) differences of the grid of *raw*
    at byte alignment *align*."""
    if width == 1:
        g = raw.to(torch.int16)
        return g[1:] - g[:-1]
    n = (len(raw) - align) // 2
    hi = raw[align : align + 2 * n : 2].to(torch.int32)
    lo = raw[align + 1 : align + 2 * n : 2].to(torch.int32)
    if not big_endian:
        hi, lo = lo, hi
    g = hi * 256 + lo
    return g[1:] - g[:-1]


def _window_starts(d: torch.Tensor, kw: Keyword, width: int,
                   compare: str) -> np.ndarray:
    """Starts of every window of *kw* over the grid whose differences are
    *d* (ascending element offsets)."""
    n_windows = d.numel() + 1 - kw.length + 1
    if n_windows <= 0:
        return np.zeros(0, dtype=np.int64)
    mask = torch.ones(n_windows, dtype=torch.bool, device=d.device)
    modulus = 1 << (8 * width)
    for k, e in enumerate(kw.diffs):
        dk = d[k : k + n_windows]
        if compare == "signed":
            mask &= dk == e
        elif compare == "wrap":
            mask &= torch.remainder(dk.to(torch.int32) - e, modulus) == 0
        else:
            raise ValueError(f"unknown comparison {compare!r}")
    return torch.nonzero(mask).flatten().cpu().numpy().astype(np.int64)


def _greedy(starts: np.ndarray, advance: int) -> List[int]:
    kept, head = [], None
    for e in starts.tolist():
        if head is None or e >= head:
            kept.append(e)
            head = e + advance
    return kept


def _element(data: np.ndarray, byte_off: int, width: int,
             big_endian: bool) -> int:
    if width == 1:
        return int(data[byte_off])
    a, b = int(data[byte_off]), int(data[byte_off + 1])
    return a * 256 + b if big_endian else b * 256 + a


def _values_map(kw: Keyword, head: int, width: int) -> Dict[int, int]:
    modulus = 1 << (8 * width)
    shift = head - kw.values[0]
    if not kw.seq:
        return {65: (65 + shift) % modulus, 97: (97 + shift) % modulus}
    return {c: (kw.index[c] + shift) % modulus for c in kw.seq}


def _preview(data: np.ndarray, offset: int, kw: Keyword,
             values_map: Dict[int, int], width: int, big_endian: bool,
             preview_width: int) -> str:
    n = len(data)
    before = (preview_width // 2 - kw.length // 2) * width
    start = offset - before
    end = start + preview_width * width
    if end > n:
        start -= end - n
    start = max(0, start)
    raw = data[start : start + preview_width * width]
    if width == 1:
        elements = raw.astype(np.int64).tolist()
    else:
        pairs = raw[: len(raw) // 2 * 2].astype(np.int64).reshape(-1, 2)
        hi, lo = (pairs[:, 0], pairs[:, 1]) if big_endian else (
            pairs[:, 1], pairs[:, 0])
        elements = (hi * 256 + lo).tolist()
    modulus = 1 << (8 * width)
    table: Dict[int, str] = {}
    for char, value in values_map.items():
        if not kw.seq and char in (65, 97):
            for letter in range(26):
                table[(value + letter) % modulus] = chr(char + letter)
        else:
            table[value] = chr(char)
    return "".join(table.get(v, "#") for v in elements)


def search(grids: Grids, keyword: str, char_seq: str, block_bytes: int,
           preview_width: int, compare: str = "signed") -> List[Result]:
    """``[(byte offset, values map, preview)]`` of *keyword* over the file,
    ascending, under GREEDY semantics."""
    kw = Keyword(keyword, char_seq)
    s = grids.width
    n_bytes = grids.n_bytes
    L = kw.length
    found = []
    for align, d in enumerate(grids.diffs):
        starts = _window_starts(d, kw, s, compare)
        byte_offs = align + starts * s
        blocks = byte_offs // block_bytes
        for block in np.unique(blocks).tolist():
            elems = starts[blocks == block]
            if s > 1:
                size = min(block_bytes + (L - 1) * s,
                           n_bytes - block * block_bytes)
                rel = align + elems * s - block * block_bytes
                fits = (rel // s) + L <= (size - rel % s) // s
                elems = elems[fits]
            for e in _greedy(elems, L - 1):
                found.append(align + e * s)
    found.sort()
    out = []
    for off in found:
        vmap = _values_map(kw, _element(grids.data, off, s, grids.big_endian),
                           s)
        out.append((off, vmap, _preview(grids.data, off, kw, vmap, s,
                                        grids.big_endian, preview_width)))
    return out
