"""Wildcard and mixed-case keywords, as translators type on-screen words:
a disc image and a stream of keywords from a configuration, a mix
(``traffic/wild_words.json``) and a seed.

A mix's parameters, besides ``draw``, ``warm`` and ``drop_resident`` as
``traffic.py`` reads them:

- ``keywords``: ``{"from": "word_list", "file", "min_len", "max_len",
  "wildcard"}``: every word of that length in the list, each written in
  one of three forms, rotated over the words in a seeded order:
  Capitalised ("Princess"), lowercase with the wildcard at a seeded
  interior position ("pr*ncess"), and Capitalised with an interior
  wildcard ("Pr*ncess").
- ``plants``: each keyword is written ``min``..``max`` times into the
  image (counts cycling over the keywords in a seeded order).  Each copy
  draws its lowercase base and its uppercase base independently, modulo
  256 (letter i of a case is ``(base + i) mod 256``), so the distance
  between the cases is not ASCII's and values may wrap past 255; a
  wildcard's position gets a random byte.  A copy after the first of a
  keyword with a literal before its wildcard is, with probability
  ``decoy_share``, a decoy: every literal after the wildcard is raised by
  1-255, so each difference between adjacent literals holds and the one
  across the wildcard does not.  ("P*incess" has none: its capital is a
  wildcard once the cases are folded.)

The image's background is ``traffic.random_bytes`` of the seed.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from benchmark import traffic

#: the keyword forms, in the order they are rotated
FORMS = ("capitalised", "lower_wildcard", "capitalised_wildcard")


def keywords(words: List[str], wildcard: str, rng) -> List[str]:
    """Each word in its form: forms rotate over the words in a seeded
    order, and a wildcard takes a seeded interior position."""
    order = rng.permutation(len(words))
    form = np.empty(len(words), dtype=np.int64)
    form[order] = np.arange(len(words)) % len(FORMS)
    out = []
    for word, f in zip(words, form.tolist()):
        chars = list(word)
        if FORMS[f] != "lower_wildcard":
            chars[0] = chars[0].upper()
        if FORMS[f] != "capitalised":
            chars[int(rng.integers(1, len(chars) - 1))] = wildcard
        out.append("".join(chars))
    return out


def bridged(keyword: str, wildcard: str) -> bool:
    """True where a check spans *keyword*'s wildcard: a literal (a
    lowercase letter, the majority case) lies before it."""
    head, star, _ = keyword.partition(wildcard)
    return bool(star) and any(c.islower() for c in head)


def plant_values(keyword: str, wildcard: str, decoy: bool, rng
                 ) -> np.ndarray:
    """The bytes of one copy of *keyword*: each case under its own base,
    a random byte at the wildcard, and past it a raise if *decoy*."""
    lower, upper = (int(b) for b in rng.integers(0, 256, size=2))
    raise_by = int(rng.integers(1, 256)) if decoy else 0
    star = keyword.find(wildcard)
    out = np.empty(len(keyword), dtype=np.int64)
    for i, c in enumerate(keyword):
        if c == wildcard:
            out[i] = rng.integers(0, 256)
        elif c.isupper():
            out[i] = upper + ord(c) - ord("A")
        else:
            out[i] = lower + ord(c) - ord("a")
        if 0 <= star < i:
            out[i] += raise_by
    return out % 256


def make(config: dict, mix: dict, seed: int, device="cpu",
         n_bytes: Optional[int] = None) -> traffic.Traffic:
    """The image and keyword stream of *mix* on *config* for *seed*.
    ``n_bytes`` overrides the configuration's image size (for tests)."""
    if int(config["search_config"]["element_width"]) != 1:
        raise ValueError("wild_words makes 8-bit images only")
    n_bytes = int(config["image_bytes"]) if n_bytes is None else n_bytes
    rng = np.random.default_rng([traffic.seed_u64(seed), 0])
    image = traffic.random_bytes(n_bytes, seed, device)

    spec = mix["keywords"]
    wildcard = spec["wildcard"]
    lo, hi = int(spec["min_len"]), int(spec["max_len"])
    words = [w for w in traffic.word_list(spec) if lo <= len(w) <= hi]
    kws = keywords(words, wildcard, rng)

    pl = mix["plants"]
    lo_n, hi_n = int(pl["min"]), int(pl["max"])
    order = rng.permutation(len(kws))
    n_copies = np.empty(len(kws), dtype=np.int64)
    n_copies[order] = lo_n + np.arange(len(kws)) % (hi_n - lo_n + 1)
    plants: List[traffic.Plant] = []
    encoded: List[np.ndarray] = []
    for k, kw in enumerate(kws):
        for j in range(int(n_copies[k])):
            decoy = j > 0 and bridged(kw, wildcard) and rng.random() < float(
                pl["decoy_share"])
            encoded.append(plant_values(kw, wildcard, decoy, rng))
            plants.append(traffic.Plant(k, 0, decoy))
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    offsets = traffic._place(rng, n_bytes, sizes, [])
    for plant, off, data in zip(plants, offsets.tolist(), encoded):
        plant.offset = off
        image[off : off + len(data)] = data

    if mix.get("draw", "uniform") != "uniform":
        raise ValueError("wild_words draws uniformly")
    if mix.get("warm", "first") != "first":
        raise ValueError("wild_words warms with the first keyword")
    warm = kws[int(rng.integers(len(kws)))]
    return traffic.Traffic(image=image, keywords=kws, plants=plants,
                           weights=None, warm=warm,
                           drop_resident=bool(mix.get("drop_resident",
                                                      False)),
                           seed=traffic.seed_u64(seed), mix=mix)
