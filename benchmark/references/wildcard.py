"""Plain wildcard and mixed-case relative search: the reference that
decides ``correct`` for a configuration that names it
(``"reference": "wildcard"``).

Written from the semantics of the upstream Monkey-Moore engine's wildcard
mode as the port's documentation states them, in plain NumPy and PyTorch,
with no code of the program.  8-bit elements, ASCII mode (no custom
sequence):

- **Case folding.**  A keyword that holds both upper- and lowercase ASCII
  letters has the letters of its minority case turned into wildcards; on a
  tie the uppercase letters become wildcards.
- **Checks.**  The literals are the positions that are not wildcards.  A
  window of L elements matches when, for each literal after the first,
  (its value - the previous literal's value) mod 256 equals the same
  difference of the folded keyword's code points.  Wildcard positions are
  not read.
- **GREEDY.**  Per block of ``preferred_search_block_size`` bytes the
  matching windows, ascending, are accepted greedily, a match suppressing
  every window that starts fewer than L - 1 - (leading wildcards) elements
  after it.
- **Values map.**  'A' and 'a' map to values under one shift, taken at the
  first literal: value - folded code point.  Where the keyword mixes cases,
  the case that is not the majority (uppercase unless the keyword holds
  more lowercase letters than uppercase ones: on a tie, lowercase) takes
  its own shift, from the element at the first keyword position of that
  case minus its code point.
- **Previews** as ``reference.py`` makes them, through that map.

A keyword with no wildcard and one case is a simple-mode search, and
``reference.search`` answers it.

``compare="wrap"`` is the control: it drops every check whose two literals
lie on either side of a wildcard, and derives the other case from the
majority case at ASCII's distance of 32, so it breaks both guarantees the
mode adds.

The image's bytes are held on the card once, and each slice of at most
``reference.SLICE_ELEMS`` window starts is checked with two 8-bit
temporaries of its size.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark import reference

__all__ = ["Pattern", "grids", "results"]


def _upper(c: int) -> bool:
    return 65 <= c <= 90


def _lower(c: int) -> bool:
    return 97 <= c <= 122


class Pattern:
    """A keyword's literals, checks, advance and recovery positions."""

    def __init__(self, keyword: str, wildcard: str = "*"):
        cps = [ord(c) for c in keyword]
        wc = ord(wildcard)
        n_up = sum(map(_upper, cps))
        n_lo = sum(map(_lower, cps))
        self.mixed = n_up > 0 and n_lo > 0
        self.mostly_lower = n_lo > n_up
        folded = list(cps)
        if self.mixed:
            minority = _lower if n_up > n_lo else _upper
            folded = [wc if minority(c) else c for c in cps]
        self.literals = [i for i, c in enumerate(folded) if c != wc]
        if not self.literals:
            raise ValueError("a keyword has at least one literal")
        self.simple = len(self.literals) == len(cps) and not self.mixed
        self.length = len(cps)
        self.seq: list = []  # ASCII mode, for ``reference._preview``
        self.folded = folded
        self.codepoints = cps
        first = self.literals[0]
        self.advance = self.length - 1 - first
        #: (current, previous, expected difference mod 256) of each check
        self.checks = [(cur, prev, (folded[cur] - folded[prev]) % 256)
                       for prev, cur in zip(self.literals, self.literals[1:])]
        #: first position of the case that takes its own shift
        self.opposing = -1
        if self.mixed:
            other = _upper if self.mostly_lower else _lower
            self.opposing = next(i for i, c in enumerate(cps) if other(c))

    def values_map(self, data: np.ndarray, offset: int,
                   compare: str) -> Dict[int, int]:
        first = self.literals[0]
        shift = int(data[offset + first]) - self.folded[first]
        if not self.mixed or compare == "wrap":
            return {65: (65 + shift) % 256, 97: (97 + shift) % 256}
        other = int(data[offset + self.opposing]) - self.codepoints[
            self.opposing]
        if self.mostly_lower:
            return {65: (65 + other) % 256, 97: (97 + shift) % 256}
        return {65: (65 + shift) % 256, 97: (97 + other) % 256}


def grids(image: np.ndarray, config: dict, device) -> reference.Grids:
    sc = config["search_config"]
    if int(sc["element_width"]) != 1 or sc.get("custom_char_seq", ""):
        raise ValueError("the wildcard reference searches 8-bit ASCII only")
    return reference.Grids(image, 1, False, device)


def _window_starts(g: reference.Grids, pat: Pattern,
                   checks: list) -> np.ndarray:
    """Starts, ascending, of the windows that pass *checks*, a slice of at
    most ``reference.SLICE_ELEMS`` starts at a time."""
    n_windows = g.n_bytes - pat.length + 1
    found = [np.zeros(0, dtype=np.int64)]
    for w0 in range(0, max(n_windows, 0), reference.SLICE_ELEMS):
        n = min(reference.SLICE_ELEMS, n_windows - w0)
        mask = torch.ones(n, dtype=torch.uint8, device=g.raw.device)
        diff = torch.empty_like(mask)
        for cur, prev, expected in checks:
            # uint8 arithmetic wraps modulo 256
            torch.sub(g.raw[w0 + cur : w0 + cur + n],
                      g.raw[w0 + prev : w0 + prev + n], out=diff)
            mask &= diff.eq_(expected)
        found.append(torch.nonzero(mask).flatten().cpu().numpy().astype(
            np.int64) + w0)
        del mask, diff
    return np.concatenate(found)


def results(g: reference.Grids, config: dict, keyword: str,
            compare: str = "signed") -> List[reference.Result]:
    """``[(byte offset, values map, preview)]`` of *keyword* over the
    image, ascending, under GREEDY semantics."""
    sc = config["search_config"]
    block_bytes = int(sc["preferred_search_block_size"])
    preview_width = int(sc["preferred_preview_width"])
    pat = Pattern(keyword, sc.get("wildcard", "*"))
    if pat.simple:
        return reference.search(g, keyword, "", block_bytes, preview_width,
                                compare)
    if compare not in ("signed", "wrap"):
        raise ValueError(f"unknown comparison {compare!r}")
    checks = pat.checks
    if compare == "wrap":
        checks = [c for c in checks if c[0] - c[1] == 1]
    starts = _window_starts(g, pat, checks)
    blocks = starts // block_bytes
    found: List[int] = []
    for block in np.unique(blocks).tolist():
        found += reference._greedy(starts[blocks == block], pat.advance)
    out = []
    for off in found:
        vmap = pat.values_map(g.data, off, compare)
        out.append((off, vmap, reference._preview(
            g.data, off, pat, vmap, 1, False, preview_width)))
    return out
