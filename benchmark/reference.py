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

The card holds the image's bytes once; each alignment's differences are
made from them one slice of at most :data:`SLICE_ELEMS` window starts at a
time, with a halo of L - 1 elements, so the reference needs the image plus
a few GiB whatever the image's size.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["Keyword", "Grids", "search"]

Result = Tuple[int, Dict[int, int], str]

#: window starts of one slice (tests may lower it): at 16 bits a slice's
#: elements and differences, int32, take 1 GiB each
SLICE_ELEMS = 1 << 28


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
    """One file's bytes, on the host and once on *device*, from which
    :func:`search` makes each alignment's differences slice by slice."""

    def __init__(self, data: np.ndarray, width: int, big_endian: bool,
                 device="cpu"):
        self.data = data
        self.width = width
        self.big_endian = big_endian
        self.n_bytes = len(data)
        self.raw = torch.from_numpy(data).to(device)


def _diffs(raw: torch.Tensor, width: int, big_endian: bool) -> torch.Tensor:
    """int16 (8 bits) or int32 (16 bits) signed differences between the
    successive elements that the bytes *raw* hold."""
    if width == 1:
        g = raw.to(torch.int16)
    else:
        hi, lo = (raw[0::2], raw[1::2]) if big_endian else (raw[1::2],
                                                             raw[0::2])
        g = hi.to(torch.int32)
        g.mul_(256).add_(lo)
    return g[1:] - g[:-1]


def _matches(d: torch.Tensor, kw: Keyword, n_windows: int, width: int,
             compare: str) -> np.ndarray:
    """Starts, ascending, of the windows of *kw* among the first
    *n_windows* of the grid whose differences are *d*."""
    mask = torch.ones(n_windows, dtype=torch.bool, device=d.device)
    modulus = 1 << (8 * width)
    for k, e in enumerate(kw.diffs):
        dk = d[k : k + n_windows]
        if compare == "signed":
            mask &= dk == e
        elif compare == "wrap":
            # |dk| < modulus: dk = e modulo 2^(8 * width) has these two
            # solutions at most
            r = e % modulus
            mask &= (dk == r) | (dk == r - modulus)
        else:
            raise ValueError(f"unknown comparison {compare!r}")
    return torch.nonzero(mask).flatten().cpu().numpy().astype(np.int64)


def _window_starts(grids: Grids, align: int, kw: Keyword,
                   compare: str) -> np.ndarray:
    """Starts of every window of *kw* over the grid at byte alignment
    *align* (ascending element offsets), a slice at a time."""
    s = grids.width
    n_windows = (grids.n_bytes - align) // s - kw.length + 1
    found = [np.zeros(0, dtype=np.int64)]
    for w0 in range(0, max(n_windows, 0), SLICE_ELEMS):
        w1 = min(w0 + SLICE_ELEMS, n_windows)
        # elements [w0, w1 + L - 1): the slice's windows and their halo
        raw = grids.raw[align + w0 * s : align + (w1 + kw.length - 1) * s]
        d = _diffs(raw, s, grids.big_endian)
        found.append(_matches(d, kw, w1 - w0, s, compare) + w0)
        del d
    return np.concatenate(found)


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
    for align in range(s):
        starts = _window_starts(grids, align, kw, compare)
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
