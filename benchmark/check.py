"""The comparison that decides ``correct``.

A run keeps the returned lists of a sample of its requests, drawn from the
seed as the window runs (a reservoir of :data:`SAMPLE` requests, plus the
request with the most results), and once the window has closed holds each
against the plain reference on the same image (``reference.py``, or the
one the configuration names: ``references/<name>.py``): offsets, values
maps and previews, all of them exactly.  The one number compared is
``requests_wrong``: sampled requests whose list differs from the
reference's in anything, plus every request of the window that raised.
Its limit is 0: the comparison is exact.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from . import reference, spec

#: requests of a window held against the reference, besides the one with
#: the most results
SAMPLE = 24
#: the limit of each number compared
LIMITS = {"requests_wrong": 0}

Result = Tuple[int, Dict[int, int], str]


class Sampler:
    """A seeded reservoir of request result lists, plus the longest list."""

    def __init__(self, seed: int, size: int = SAMPLE):
        self.rng = np.random.default_rng([seed, 2])
        self.size = size
        self.kept: Dict[int, tuple] = {}
        self.longest: Optional[tuple] = None
        self.seen = 0

    def offer(self, index: int, keyword, results) -> None:
        """Consider request *index* (stream entry *keyword*) and its
        *results* (the request's list)."""
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept[index] = (keyword, results)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.size:
                del self.kept[sorted(self.kept)[j]]
                self.kept[index] = (keyword, results)
        if results is not None and (
                self.longest is None or len(results) > len(self.longest[2])):
            self.longest = (index, keyword, results)

    def sample(self) -> Dict[int, tuple]:
        out = dict(self.kept)
        if self.longest is not None:
            out.setdefault(self.longest[0], self.longest[1:])
        return out


def as_tuples(results) -> List[Result]:
    """A program's ``SearchResult`` list as plain tuples."""
    return [(int(r.offset), {int(k): int(v) for k, v in r.values_map.items()},
             str(r.preview)) for r in results]


def first_difference(got: List[Result], want: List[Result]) -> Optional[str]:
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            return f"result {i}: got {g!r}, want {w!r}"
    if len(got) != len(want):
        return f"{len(got)} results, want {len(want)}"
    return None


def reference_grids(image: np.ndarray, config: dict, device,
                    folder: Path = spec.HERE):
    """The reference's state over *image*: ``grids`` of the reference that
    *config* names under *folder*, or ``reference.Grids``."""
    name = config.get("reference")
    if name is not None:
        return spec.module("references", name, folder).grids(
            image, config, device)
    sc = config["search_config"]
    return reference.Grids(image, int(sc["element_width"]),
                           sc.get("endianness", "little") == "big", device)


def reference_results(grids, config: dict, entry, compare: str = "signed",
                      folder: Path = spec.HERE) -> list:
    """The reference's comparable tuples of one stream entry: ``results``
    of the reference that *config* names under *folder*, or
    ``reference.search`` of one keyword."""
    name = config.get("reference")
    if name is not None:
        return spec.module("references", name, folder).results(
            grids, config, entry, compare)
    sc = config["search_config"]
    return reference.search(
        grids, entry, sc.get("custom_char_seq", ""),
        int(sc["preferred_search_block_size"]),
        int(sc["preferred_preview_width"]), compare)


def compare(sample: Dict[int, tuple], failed: int, want: Dict[object, list],
            log=sys.stderr, to_tuples: Callable = as_tuples) -> dict:
    """``{"requests_wrong": {...}}`` of a run: *sample* maps request index
    to (stream entry, program results), *want* entry to the reference's
    tuples, *failed* counts requests that raised; *to_tuples* makes the
    program's results comparable (the request's ``as_tuples``)."""
    wrong = failed
    for index in sorted(sample):
        entry, results = sample[index]
        if results is None:
            continue  # raised: counted in failed
        diff = first_difference(to_tuples(results), want[entry])
        if diff is not None:
            wrong += 1
            print(f"request {index} ({entry!r}) differs: {diff}"[:2000],
                  file=log)
    return {"requests_wrong": {"value": wrong,
                               "limit": LIMITS["requests_wrong"],
                               "compared": len(sample), "failed": failed}}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
