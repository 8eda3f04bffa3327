"""Keyword batches, as a translator pastes a script's list of names or
menu words: the default generator's image, plants and words
(``traffic.make``), its words grouped into entries of ``batch`` distinct
words, one entry a request.

A mix's parameters are ``traffic.py``'s, plus ``batch``, the words an
entry holds.  The words are grouped in a seeded order; where the last
group is short it is filled up with words drawn, in a seeded order, from
the others, so every word of the mix lies in an entry and every entry
holds ``batch`` distinct words.  Each entry is a tuple of words, searched
by one request; the stream cycles over the entries in seeded
permutations, and ``warm`` is the first entry.  The image, the plants and
their decoys are ``traffic.make``'s for the same seed: ``Plant.keyword``
indexes the word list in ``traffic.make``'s order, not the entries.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from benchmark import traffic


def entries(words: List[str], size: int, rng) -> List[Tuple[str, ...]]:
    """*words* in entries of *size* distinct words, grouped in a seeded
    order, the last one filled up from the other words."""
    if size < 1 or len(set(words)) < size:
        raise ValueError(f"cannot make entries of {size} distinct words "
                         f"from {len(set(words))}")
    order = [words[i] for i in rng.permutation(len(words)).tolist()]
    out = [order[i : i + size] for i in range(0, len(order), size)]
    last = out[-1]
    others = [w for w in order if w not in last]
    fill = rng.permutation(len(others))[: size - len(last)]
    last += [others[i] for i in fill.tolist()]
    return [tuple(e) for e in out]


def make(config: dict, mix: dict, seed: int, device="cpu",
         n_bytes: Optional[int] = None) -> traffic.Traffic:
    """The image and entry stream of *mix* on *config* for *seed*.
    ``n_bytes`` overrides the configuration's image size (for tests)."""
    if mix.get("draw", "uniform") != "uniform":
        raise ValueError("batch draws uniformly")
    if mix.get("warm", "first") != "first":
        raise ValueError("batch warms with the first entry")
    work = traffic.make(config, mix, seed, device, n_bytes=n_bytes)
    rng = np.random.default_rng([traffic.seed_u64(seed), 3])
    work.keywords = entries(list(work.keywords), int(mix["batch"]), rng)
    work.warm = work.keywords[0]
    return work
