"""The PyTorch port's resident corpus against the JAX package's: the port's
corpus is built with ``ResidentCorpus.from_words`` from the JAX corpus's
word array, and every grid chunk (8 and 16-bit, both endiannesses, every
byte alignment, packed words and elements, including chunks that run past
EOF and a start clamped at the buffer end) must be identical.  Kernel M's
wrapper (``scan_cuda.derive_words``) on CPU tensors: its plain version,
against the bytes shifted and swapped; its operand checks; and the view
where nothing is derived.

Tolerance: exact equality throughout — every value is an integer.
"""

import numpy as np
import pytest
import torch

from monkey_moore_tpu import corpus as jcorpus
from monkey_moore_tpu.config import Endianness
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import corpus as tcorpus
from monkey_moore_tpu_torch.config import Endianness as TEndianness
from monkey_moore_tpu_torch.ops import scan_cuda


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


def _derive_reference(raw: np.ndarray, byte_shift: int, swap: bool):
    """The grid words of *raw* (``n + 1`` little-endian int32 words) from
    its bytes: shifted down by *byte_shift*, each 16-bit pair swapped."""
    n = len(raw) - 1
    b = raw.view(np.uint8)[byte_shift : byte_shift + 4 * n]
    if swap:
        b = b.reshape(-1, 2)[:, ::-1].reshape(-1)
    return np.ascontiguousarray(b).view("<i4")


_WIDTH_BIG = [(1, False), (2, False), (2, True)]


@pytest.mark.parametrize("width,big", _WIDTH_BIG)
@pytest.mark.parametrize("byte_shift", range(4))
def test_derive_words_on_cpu_takes_the_plain_version(byte_shift, width,
                                                     big):
    """Kernel M's wrapper on CPU tensors: the plain version, equal to the
    bytes shifted and swapped, and no launch counted."""
    raw_np = np.random.default_rng(byte_shift).integers(
        -(2**31), 2**31, 1031).astype(np.int32)
    raw_np[:3] = [-1, -(2**31), 0x7F80FF01]  # sign bits
    raw = torch.from_numpy(raw_np)
    scan_cuda.reset_launch_counts()
    got = scan_cuda.derive_words(raw, byte_shift, width, big)
    assert scan_cuda.launch_counts["derive_words"] == 0
    plain = scan_cuda.derive_words_plain(raw, byte_shift, width, big)
    want = _derive_reference(raw_np, byte_shift, width == 2 and big)
    assert got.dtype == torch.int32 and got.shape == (1030,)
    assert torch.equal(got, plain)
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("raw,byte_shift,width", [
    (torch.zeros(9, dtype=torch.int64), 1, 2),
    (torch.zeros(9, dtype=torch.uint8), 1, 2),
    (torch.zeros(18, dtype=torch.int32)[::2], 1, 2),
    (torch.zeros((3, 3), dtype=torch.int32), 1, 2),
    (torch.zeros(0, dtype=torch.int32), 1, 2),
    (torch.zeros(9, dtype=torch.int32), 4, 2),
    (torch.zeros(9, dtype=torch.int32), -1, 2),
    (torch.zeros(9, dtype=torch.int32), 1, 4),
])
def test_derive_words_wrapper_refuses_bad_operands(raw, byte_shift, width):
    with pytest.raises(ValueError):
        scan_cuda.derive_words(raw, byte_shift, width, True)


@pytest.mark.parametrize("width,big", [(1, False), (1, True), (2, False)])
def test_corpus_derive_words_is_a_view_where_nothing_is_derived(width,
                                                                big):
    raw = torch.arange(17, dtype=torch.int32)
    scan_cuda.reset_launch_counts()
    got = tcorpus.derive_words(raw, 0, width, big)
    assert got.data_ptr() == raw.data_ptr() and got.shape == (16,)
    assert scan_cuda.launch_counts["derive_words"] == 0
    derived = tcorpus.derive_words(raw, 2, width, big)
    assert derived.data_ptr() != raw.data_ptr()
    assert derived.tolist() == _derive_reference(
        raw.numpy(), 2, False).tolist()
