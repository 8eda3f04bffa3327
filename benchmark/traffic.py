"""The default traffic generator: a disc image and a stream of keywords
from a configuration, a mix (``traffic/<name>.json``) and a seed.  A mix
that names a ``"generator"`` is made by ``generators/<name>.py`` instead,
which returns a :class:`Traffic` too (``spec.generator``).

A mix's parameters:

- ``keywords``: ``{"from": "word_list", "file": ..., "min_len", "max_len"}``
  (every word of that length in the list, one keyword each) or
  ``{"from": "sequence", "count", "min_len", "max_len"}`` (``count``
  strings of the configuration's custom sequence, lengths cycling from
  ``min_len`` to ``max_len``, characters drawn uniformly).
- ``plants``: each keyword is written ``min``..``max`` times into the
  image (counts cycling over the keywords in a seeded order), every copy
  after the first under a shift that wraps some of its values past the
  top of the element range with probability ``decoy_share``.  Simple mode
  compares signed differences, so such a decoy is no match; a search that
  wraps modulo 2^width would report it.
- ``script`` (optional): ``bytes`` of text whose words are drawn from the
  whole word list of ``keywords`` with Zipf weights ``1 / rank ** zipf_s``
  (rank = line of the list), separated by spaces, encoded under one shift
  that keeps 'a'-'z' inside the byte range, placed inside one
  ``within_bytes`` span of the image.
- ``draw``: ``"uniform"`` (seeded permutations of every keyword, one after
  another) or ``"script_frequency"`` (blocks of ``block`` requests drawn in
  proportion to each keyword's count in the script, stratified within each
  block, so every block asks for about the same work).
- ``warm``: ``"first"`` (the first keyword of a seeded order) or
  ``"most_frequent"`` (the keyword the script holds most often).
- ``drop_resident``: drop the program's resident corpus before each
  request, so every request is a first search of the file.

The image's background is random bytes from a ``torch.Generator`` seeded
with the seed, made on *device*.  The same seed
gives the same image and stream on one kind of device.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Hashable, Iterator, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
#: random bytes are made in pieces of this many, in place
PIECE_BYTES = 256 << 20


@dataclass
class Plant:
    keyword: int  #: index into ``Traffic.keywords``
    offset: int  #: byte offset in the image
    decoy: bool


@dataclass
class Traffic:
    image: np.ndarray  #: the whole disc image (u8)
    #: the stream's entries, each what one request is given: a keyword
    #: here, or what another generator makes (such as a tuple of keywords
    #: for a batch); hashable, and of one kind in one stream
    keywords: List[Hashable]
    plants: List[Plant]
    #: request weights of each keyword (``script_frequency``), or None
    weights: Optional[np.ndarray]
    warm: Hashable  #: the entry of the warm request
    drop_resident: bool
    seed: int
    mix: dict = field(repr=False, default_factory=dict)
    #: (offset, bytes) of the script region, or None
    script: Optional[tuple] = None

    def stream(self) -> Iterator[int]:
        """Keyword indices of the requests, without end."""
        rng = np.random.default_rng([self.seed, 1])
        n = len(self.keywords)
        if self.weights is None:
            while True:
                yield from rng.permutation(n).tolist()
        block = int(self.mix["block"])
        cdf = np.cumsum(self.weights / self.weights.sum())
        cdf[-1] = 1.0
        while True:
            u = (np.arange(block) + rng.random()) / block
            picks = np.searchsorted(cdf, u, side="right")
            yield from rng.permutation(picks).tolist()


def seed_u64(seed: int) -> int:
    return int(seed) % (1 << 63)


def word_list(mix_keywords: dict) -> List[str]:
    text = (HERE / mix_keywords["file"]).read_text()
    return [w for w in text.split() if w]


def random_bytes(n_bytes: int, seed: int, device) -> np.ndarray:
    """*n_bytes* random bytes made on *device* from *seed*, copied out."""
    n_words = -(-n_bytes // 4)
    words = torch.empty(n_words, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_u64(seed))
    piece = PIECE_BYTES // 4
    for w0 in range(0, n_words, piece):
        words[w0 : w0 + piece].random_(-(2**31), 2**31, generator=gen)
    out = words.cpu().numpy().view(np.uint8)[:n_bytes]
    del words
    return out


def encode(values: np.ndarray, width: int, big_endian: bool) -> np.ndarray:
    """Element values (already wrapped to the width) as bytes."""
    v = np.asarray(values, dtype=np.int64)
    if width == 1:
        return v.astype(np.uint8)
    hi, lo = (v >> 8).astype(np.uint8), (v & 0xFF).astype(np.uint8)
    pair = np.stack([hi, lo] if big_endian else [lo, hi], axis=1)
    return pair.reshape(-1)


def keyword_values(keyword: str, char_seq: str) -> np.ndarray:
    """The values a keyword's characters stand for before any shift."""
    if not char_seq:
        return np.array([ord(c) for c in keyword], dtype=np.int64)
    index = {c: i for i, c in enumerate(char_seq)}
    return np.array([index.get(c, 0) for c in keyword], dtype=np.int64)


def _keywords(mix: dict, char_seq: str, rng) -> List[str]:
    spec = mix["keywords"]
    lo, hi = int(spec["min_len"]), int(spec["max_len"])
    if spec["from"] == "word_list":
        return [w for w in word_list(spec) if lo <= len(w) <= hi]
    if spec["from"] == "sequence":
        seq = list(char_seq)
        lengths = [lo + i % (hi - lo + 1) for i in range(int(spec["count"]))]
        return ["".join(rng.choice(seq, size=n)) for n in lengths]
    raise ValueError(f"unknown keyword source {spec['from']!r}")


def _script(mix: dict, n_bytes: int, rng):
    """(text bytes, token counts by word) of the script region."""
    spec = mix["script"]
    words = word_list(mix["keywords"])
    size = min(int(spec["bytes"]), n_bytes)
    ranks = np.arange(1, len(words) + 1, dtype=np.float64)
    p = ranks ** -float(spec["zipf_s"])
    p /= p.sum()
    table = np.frombuffer(" ".join(words).encode() + b" ", dtype=np.uint8)
    lens = np.array([len(w) + 1 for w in words], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    mean = float((lens * p).sum())
    tokens = rng.choice(len(words), size=int(size / mean * 1.1) + 16, p=p)
    tok_lens = lens[tokens]
    ends = np.cumsum(tok_lens)
    n_tok = int(np.searchsorted(ends, size, side="left")) + 1
    tokens, tok_lens = tokens[:n_tok], tok_lens[:n_tok]
    first = np.concatenate([[0], np.cumsum(tok_lens)[:-1]])
    idx = np.repeat(starts[tokens] - first, tok_lens) + np.arange(
        int(tok_lens.sum()))
    text = table[idx][:size]
    counts = np.bincount(tokens[:-1], minlength=len(words))
    return text, dict(zip(words, counts.tolist()))


def _place(rng, n_bytes: int, sizes: np.ndarray, avoid: List[tuple]
           ) -> np.ndarray:
    """Offsets for plants of *sizes* bytes: uniform over the image, apart
    from each other and from the *avoid* ranges."""
    offsets = rng.integers(0, n_bytes - sizes + 1)
    for _ in range(100):
        bad = np.zeros(len(sizes), dtype=bool)
        for lo, hi in avoid:
            bad |= (offsets < hi) & (offsets + sizes > lo)
        order = np.argsort(offsets, kind="stable")
        ends = offsets[order] + sizes[order]
        clash = np.zeros(len(sizes), dtype=bool)
        clash[order[1:]] = offsets[order[1:]] < ends[:-1]
        bad |= clash
        if not bad.any():
            return offsets
        offsets[bad] = rng.integers(0, n_bytes - sizes[bad] + 1)
    raise RuntimeError("could not place the plants apart")


def make(config: dict, mix: dict, seed: int, device="cpu",
         n_bytes: Optional[int] = None) -> Traffic:
    """The image and keyword stream of *mix* on *config* for *seed*.
    ``n_bytes`` overrides the configuration's image size (for tests)."""
    sc = config["search_config"]
    width = int(sc["element_width"])
    big = sc.get("endianness", "little") == "big"
    char_seq = sc.get("custom_char_seq", "")
    n_bytes = int(config["image_bytes"]) if n_bytes is None else n_bytes
    tmax = (1 << (8 * width)) - 1
    rng = np.random.default_rng([seed_u64(seed), 0])

    image = random_bytes(n_bytes, seed, device)
    keywords = _keywords(mix, char_seq, rng)

    avoid, script, weights = [], None, None
    if mix.get("script"):
        text, counts = _script(mix, n_bytes, rng)
        within = min(int(mix["script"]["within_bytes"]), n_bytes)
        span = int(rng.integers(0, max(1, n_bytes // within)))
        lo = span * within
        off = lo + int(rng.integers(0, within - len(text) + 1))
        shift = int(rng.integers(-ord("a"), 256 - ord("z")))
        image[off : off + len(text)] = (text.astype(np.int64) + shift) % 256
        script = (off, len(text))
        avoid.append((off, off + len(text)))
        weights = np.array([counts.get(k, 0) for k in keywords],
                           dtype=np.float64)
    if mix.get("draw", "uniform") == "uniform":
        weights = None
    elif weights is None:
        raise ValueError("draw 'script_frequency' needs a script")

    pl = mix["plants"]
    lo_n, hi_n = int(pl["min"]), int(pl["max"])
    order = rng.permutation(len(keywords))
    n_copies = np.empty(len(keywords), dtype=np.int64)
    n_copies[order] = lo_n + np.arange(len(keywords)) % (hi_n - lo_n + 1)
    plants: List[Plant] = []
    encoded: List[np.ndarray] = []
    for k, word in enumerate(keywords):
        values = keyword_values(word, char_seq)
        vmin, vmax = int(values.min()), int(values.max())
        for j in range(int(n_copies[k])):
            decoy = j > 0 and vmax > vmin and rng.random() < float(
                pl["decoy_share"])
            if decoy:  # the top value wraps, the bottom one does not
                shift = int(rng.integers(tmax + 1 - vmax, tmax + 1 - vmin))
            else:
                shift = int(rng.integers(-vmin, tmax - vmax + 1))
            encoded.append(encode((values + shift) % (tmax + 1), width, big))
            plants.append(Plant(k, 0, decoy))
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    offsets = _place(rng, n_bytes, sizes, avoid)
    for plant, off, data in zip(plants, offsets.tolist(), encoded):
        plant.offset = off
        image[off : off + len(data)] = data

    if mix.get("warm", "first") == "most_frequent":
        warm = keywords[int(np.argmax(weights))]
    else:
        warm = keywords[int(rng.integers(len(keywords)))]
    return Traffic(image=image, keywords=keywords, plants=plants,
                   weights=weights, warm=warm,
                   drop_resident=bool(mix.get("drop_resident", False)),
                   seed=seed_u64(seed), mix=mix, script=script)
