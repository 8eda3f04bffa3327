"""Plain relative search of a keyword batch: the reference that decides
``correct`` for a configuration that names it (``"reference": "batch"``).

A batch is searched keyword by keyword: each keyword of an entry (a tuple
of keywords) goes through ``reference.search`` on the image's grids, and
the entry's results are the keywords' lists one after another, in the
entry's order, each ascending by offset.  Nothing is shared between the
keywords but the image's bytes on the card.

Departures from the single-keyword reference:

- Each result is ``((keyword, byte offset), values map, preview)``: the
  three fields of a single-keyword result, its offset keyed by the
  keyword, so that ``control.py`` can put this reference in the program's
  place (its results are shaped as one keyword's) and
  ``requests/multi.py``'s ``as_tuples`` reads them back.
- ``compare`` passes through to every keyword: ``"wrap"``, the control,
  compares each keyword's differences modulo 2^(8 * width) and reports
  the mix's wrap decoys.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark import reference

__all__ = ["grids", "results"]

Result = Tuple[Tuple[str, int], Dict[int, int], str]


def grids(image: np.ndarray, config: dict, device) -> reference.Grids:
    sc = config["search_config"]
    return reference.Grids(image, int(sc["element_width"]),
                           sc.get("endianness", "little") == "big", device)


def results(g: reference.Grids, config: dict, entry: Sequence[str],
            compare: str = "signed") -> List[Result]:
    """The entry's results, keyword after keyword (see the module's
    docstring)."""
    sc = config["search_config"]
    out: List[Result] = []
    for keyword in entry:
        out += [((keyword, off), vmap, preview)
                for off, vmap, preview in reference.search(
                    g, keyword, sc.get("custom_char_seq", ""),
                    int(sc["preferred_search_block_size"]),
                    int(sc["preferred_preview_width"]), compare)]
    return out
