"""The PyTorch port's resident corpus against the JAX package's: the port's
corpus is built with ``ResidentCorpus.from_words`` from the JAX corpus's
word array, and every grid chunk (8 and 16-bit, both endiannesses, every
byte alignment, packed words and elements, including chunks that run past
EOF and a start clamped at the buffer end) must be identical.

Tolerance: exact equality throughout — every value is an integer.
"""

import numpy as np
import pytest

from monkey_moore_tpu import corpus as jcorpus
from monkey_moore_tpu.config import Endianness
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import corpus as tcorpus
from monkey_moore_tpu_torch.config import Endianness as TEndianness


@pytest.fixture(scope="module")
def corpora():
    data = np.random.default_rng(9).integers(0, 256, 4099).astype(np.uint8)
    data[:8] = [0x80, 0xFF, 0x7F, 0x01, 0xFE, 0x80, 0x00, 0xFF]  # sign bits
    jax_corpus = jcorpus.ResidentCorpus(data, pad_bytes=300)
    port = tcorpus.ResidentCorpus.from_words(
        np.asarray(jax_corpus.device_words), len(data), device="cpu"
    )
    return data, jax_corpus, port


@pytest.mark.parametrize("width,endianness", [
    (1, Endianness.LITTLE), (2, Endianness.LITTLE), (2, Endianness.BIG),
])
@pytest.mark.parametrize("packed", [False, True])
def test_grid_chunk_equal(corpora, width, endianness, packed):
    data, jax_corpus, port = corpora
    assert len(port) == len(jax_corpus)
    for align in range(4):
        for e_start, want in [(0, 64), (1, 96), (3, 64), (7, 96),
                              (4000 // width, 96), (4099 // width, 64)]:
            j = np.asarray(jax_corpus.grid_chunk(
                width, endianness, align, e_start, want, packed=packed
            ))
            t = port.grid_chunk(
                width, carry_over(endianness), align, e_start, want,
                packed=packed,
            ).numpy()
            assert t.dtype == j.dtype and t.shape == j.shape
            assert t.tolist() == j.tolist(), (align, e_start, want)


def test_grid_chunk_decodes_file_bytes(corpora):
    data, _, port = corpora
    for align in range(2):
        got = port.grid_chunk(2, TEndianness.BIG, align, 5, 200).numpy()
        want = data[align + 10 : align + 410].view(">u2").astype(np.uint16)
        assert got.tolist() == want.tolist()


def test_resident_cache(tmp_path):
    path = tmp_path / "rom.bin"
    path.write_bytes(bytes(range(256)) * 8)
    tcorpus.clear_corpus_cache()
    try:
        a = tcorpus.get_resident_corpus(path, 2048, 1 << 20, 64, "cpu")
        assert a is not None and a.fresh
        assert tcorpus.get_resident_corpus(path, 2048, 1 << 20, 64,
                                           "cpu") is a
        assert tcorpus.get_resident_corpus(path, 2048, 1024, 64,
                                           "cpu") is None  # over the limit
        b = tcorpus.get_resident_corpus(path, 2048, 1 << 20, 4096, "cpu")
        assert b is not a and len(b) >= 2048 + 4096  # more padding needed
        grid = b.grid_chunk(1, TEndianness.LITTLE, 1, 0, 16).tolist()
        assert grid == list(range(1, 17))
    finally:
        tcorpus.clear_corpus_cache()


def test_windows_are_slices_of_the_file(corpora):
    data, _, port = corpora
    n = len(data)
    starts = [0, 7, 2000, n - 50, n - 3, n]
    assert port.windows(starts, 50) == [
        data[b : b + 50].tobytes() for b in starts]
    assert port.windows([], 50) == []
