"""Files for the wildcard and mixed-case tests: a seeded random image with
copies of one keyword whose lowercase and uppercase letters lie under
independent bases (``tests/test_torch_wildcard.py`` on the CPU,
``tests/test_torch_wildcard_cuda.py`` on the card)."""

import numpy as np

KEYWORDS = ["Princess", "pr*ncess", "Pr*ncess", "P*incess", "PRINcess",
            "PrInCeSs"]
#: (lowercase base, uppercase base, decoy raise) of each planted copy:
#: bases far from ASCII's distance of 32, two that wrap past 255
COPIES = [(97, 65, 0), (10, 200, 0), (250, 3, 0), (140, 141, 0),
          (30, 240, 77)]
N_BYTES = 200_000


def encode(keyword, lower, upper, raise_by=0, star_byte=0x5A):
    out = []
    star = keyword.find("*")
    for i, c in enumerate(keyword):
        if c == "*":
            v = star_byte
        elif c.isupper():
            v = upper + ord(c) - ord("A")
        else:
            v = lower + ord(c) - ord("a")
        if 0 <= star < i:
            v += raise_by
        out.append(v % 256)
    return np.array(out, dtype=np.uint8)


def planted_file(tmp_path, keyword, n_bytes=N_BYTES):
    """A seeded random file with *keyword*'s copies of :data:`COPIES`,
    one across a 16 KiB chunk's end, the last a decoy where the keyword
    has a literal before a wildcard; returns ``(path, offsets of the copies that are no
    decoy)``."""
    data = np.random.default_rng(21).integers(0, 256, n_bytes).astype(
        np.uint8)
    offsets = [40, 16_380, 70_001, 131_069, 150_000]
    for off, (lo, up, raise_by) in zip(offsets, COPIES):
        data[off : off + len(keyword)] = encode(keyword, lo, up, raise_by)
    path = tmp_path / "image.bin"
    path.write_bytes(data.tobytes())
    # a raise past the wildcard breaks a check only where a literal (a
    # lowercase letter) lies before the wildcard
    decoy = any(c.islower() for c in keyword.partition("*")[0]) and (
        "*" in keyword)
    real = [off for off, c in zip(offsets, COPIES) if not (c[2] and decoy)]
    return str(path), real
