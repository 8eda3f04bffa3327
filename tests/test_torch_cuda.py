"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card (kernel M, the grid derivation, at every byte shift, width and
byte order, on views off a 16-byte boundary and past 2^31 bytes too).

These tests need a CUDA device and ``nvcc``; without a card they skip.  On
the card, run ``python -m pytest tests/test_torch_cuda.py -m cuda -q``.
Tolerance: exact equality throughout — every value is an integer.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from monkey_moore_tpu_torch.config import Endianness, SearchConfig
from monkey_moore_tpu_torch.counts_bench import misaligned_copy
from monkey_moore_tpu_torch.ops import scan_cuda
from monkey_moore_tpu_torch.ops.host import prefilter_checks, wordcmp_run
from monkey_moore_tpu_torch.pattern import compile_pattern

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _planted_elems(rng, pat, n_tiles, tile_elems, n_valid, plants):
    """``n_tiles + 1`` tiles of the pattern's elements: seeded random up to
    ``n_valid``, zero past it, the keyword (+3 i) at plant i."""
    width = np.dtype(pat.dtype).itemsize
    mod = 1 << (8 * width)
    arr = np.zeros((n_tiles + 1) * tile_elems, dtype=pat.dtype)
    arr[:n_valid] = rng.integers(0, mod, n_valid).astype(pat.dtype)
    kw = np.array(pat.keyword, dtype=np.int64)
    for i, pos in enumerate(plants):
        arr[pos : pos + pat.length] = ((kw + 3 * i) % mod).astype(pat.dtype)
    return arr


def _planted_words(rng, pat, n_tiles, tile_elems, n_valid, plants):
    arr = _planted_elems(rng, pat, n_tiles, tile_elems, n_valid, plants)
    return torch.from_numpy(arr.reshape(-1).view("<i4").copy())


@pytest.mark.parametrize(
    "kw,wc,width",
    [("abcde", 0, 1), ("ab*de", "*", 1), ("abcde", 0, 2), ("ab*de", "*", 2)],
)
@pytest.mark.parametrize("tile_elems", [8, 4096])
def test_tile_counts_kernel_equals_plain(cuda, kw, wc, width, tile_elems):
    rng = np.random.default_rng(1)
    pat = compile_pattern(kw, wc, dtype=np.uint8 if width == 1 else np.uint16)
    pairs, _ = prefilter_checks(pat)
    assert (wordcmp_run(pairs, 4 // width) is None) == (wc != 0)
    n_tiles = 64
    n_valid = n_tiles * tile_elems - 3
    plants = [0, tile_elems - 2, n_valid - pat.length, 5 * tile_elems + 1]
    words = _planted_words(rng, pat, n_tiles, tile_elems, n_valid, plants)
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    kwargs = dict(width=width, tile_elems=tile_elems, length=pat.length,
                  valid_count=n_valid)
    want = scan_cuda.tile_counts(words, checks, **kwargs)
    got = scan_cuda.tile_counts(words.to(cuda), checks.to(cuda), **kwargs)
    assert got.cpu().tolist() == want.tolist()
    assert int(want.sum()) >= len(plants)


@pytest.mark.parametrize("k_cap", [1, 32, 128])
@pytest.mark.parametrize("tile_elems,width", [(8, 1), (4096, 1), (4096, 2)])
def test_gather_tiles_kernel_equals_plain(cuda, k_cap, tile_elems, width):
    rng = np.random.default_rng(2)
    n_tiles = 40
    words = torch.from_numpy(
        rng.integers(-(2**31), 2**31, (n_tiles + 1) * tile_elems * width // 4)
        .astype(np.int32)
    )
    hot = rng.integers(0, n_tiles, k_cap).astype(np.int32)
    hot[k_cap // 2 :] = hot[0]  # duplicate ids, as idle slots repeat
    hot = torch.from_numpy(hot)
    want = scan_cuda.gather_tiles(words, hot, width=width,
                                  tile_elems=tile_elems)
    got = scan_cuda.gather_tiles(words.to(cuda), hot.to(cuda), width=width,
                                 tile_elems=tile_elems)
    assert torch.equal(got.cpu(), want)


#: the gather kernel's stage: a piece of a slot's span per bulk copy
STAGE_BYTES = int(re.search(
    r"constexpr int kStageBytes = (\d+);",
    (Path(scan_cuda.__file__).parents[1] / "csrc" / "gather_tiles.cu")
    .read_text()).group(1))

#: (tile bytes, element width): tiny, unaligned, u16, one stage exactly,
#: one stage + 16 (a 32-byte last piece), the bench's and the main path's
GATHER_SHAPES = [(8, 1), (1000, 1), (2000, 2), (STAGE_BYTES, 1),
                 (STAGE_BYTES + 16, 1), (32 << 10, 1), (256 << 10, 1)]


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("k_cap", [1, 31, 128, 513])
@pytest.mark.parametrize("tile_bytes,width", GATHER_SHAPES)
def test_gather_kernel_b_e_plain_index_select(cuda, tile_bytes, width, k_cap,
                                              offset):
    """B and E (one bulk-copy kernel) against their plain versions, each
    other and ``index_select`` of the zero-padded tile view: duplicate ids,
    an id at the last tile (its halo reads zeros past the end), and at a
    2-byte offset a source that is not 16-byte aligned (the edge copy)."""
    rng = np.random.default_rng(tile_bytes + k_cap + offset)
    te = tile_bytes // width
    n_tiles = max(4, min(40, (16 << 20) // tile_bytes))
    raw = rng.integers(0, 256, offset + (n_tiles + 1) * tile_bytes,
                       dtype=np.uint8)
    src = torch.from_numpy(raw).to(cuda)[offset:]
    elems = src if width == 1 else src.view(torch.uint16)
    hot = rng.integers(0, n_tiles + 1, k_cap).astype(np.int32)
    hot[k_cap // 2 :] = hot[0]  # duplicate ids, as idle slots repeat
    hot[-1] = n_tiles  # the halo tile of the last tile lies past the end
    hot = torch.from_numpy(hot).to(cuda)
    scan_cuda.reset_launch_counts()
    b = scan_cuda.gather_tiles(elems, hot, width=width, tile_elems=te)
    e = scan_cuda.gather_tiles_block(elems, hot, tile_elems=te)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["gather_tiles"] == 1
    assert scan_cuda.launch_counts["gather_tiles_block"] == 1
    aligned = int(offset == 0 and tile_bytes % 16 == 0)
    assert scan_cuda.aligned_launch_counts == {
        "gather_tiles": aligned, "gather_tiles_block": aligned}
    assert e.dtype == elems.dtype and e.shape == (k_cap, 2 * te)
    assert torch.equal(b, scan_cuda.gather_tiles_plain(
        elems, hot, width=width, tile_elems=te))
    assert torch.equal(e, scan_cuda.gather_tiles_block_plain(
        elems, hot, tile_elems=te))
    assert torch.equal(e.view(torch.uint8), b)
    padded = torch.cat([src, torch.zeros(tile_bytes, dtype=torch.uint8,
                                         device=cuda)])
    spans = padded.unfold(0, 2 * tile_bytes, tile_bytes)
    assert torch.equal(torch.index_select(spans, 0, hot), b)
    assert not b[-1, tile_bytes:].any()


@pytest.mark.parametrize(
    "kw,wc,width",
    [("abcde", 0, 1), ("ab*de", "*", 1), ("abcde", 0, 2), ("ab*de", "*", 2)],
)
@pytest.mark.parametrize("tile_elems", [8, 4096, 40_000])
def test_tile_counts_elems_kernel_equals_plain(cuda, kw, wc, width,
                                               tile_elems):
    rng = np.random.default_rng(6)
    pat = compile_pattern(kw, wc, dtype=np.uint8 if width == 1 else np.uint16)
    n_tiles = 12
    n_valid = n_tiles * tile_elems - 3
    plants = [0, tile_elems - 2, n_valid - pat.length, 5 * tile_elems + 1]
    elems = _planted_words(rng, pat, n_tiles, tile_elems, n_valid,
                           plants).view(torch.uint8 if width == 1
                                        else torch.uint16)
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    args = dict(tile_elems=tile_elems, length=pat.length, valid_count=n_valid)
    want = scan_cuda.tile_counts_elems(elems, checks, **args)
    before = scan_cuda.launch_counts["tile_counts_elems"]
    got = scan_cuda.tile_counts_elems(elems.to(cuda), checks.to(cuda), **args)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["tile_counts_elems"] == before + 1
    assert got.cpu().tolist() == want.tolist()
    assert int(want.sum()) >= len(plants)
    words = elems.view(torch.int32).to(cuda)  # kernel A on the same bytes
    assert scan_cuda.tile_counts(words, checks.to(cuda), width=width,
                                 **args).cpu().tolist() == want.tolist()


@pytest.mark.parametrize("k_cap", [1, 32, 128])
@pytest.mark.parametrize("tile_elems,width", [(8, 1), (4096, 1), (4096, 2),
                                              (1000, 2)])
def test_gather_tiles_block_kernel_equals_plain(cuda, k_cap, tile_elems,
                                                width):
    rng = np.random.default_rng(7)
    n_tiles = 40
    dtype = np.uint8 if width == 1 else np.uint16
    arr = rng.integers(0, 1 << (8 * width), (n_tiles + 1) * tile_elems)
    elems = torch.from_numpy(arr.astype(dtype).view(np.int16 if width == 2
                                                     else np.uint8))
    elems = elems.view(torch.uint16) if width == 2 else elems
    hot = rng.integers(0, n_tiles + 1, k_cap).astype(np.int32)
    hot[k_cap // 2 :] = hot[0]  # duplicate ids, as idle slots repeat
    hot = torch.from_numpy(hot)
    want = scan_cuda.gather_tiles_block(elems, hot, tile_elems=tile_elems)
    got = scan_cuda.gather_tiles_block(elems.to(cuda), hot.to(cuda),
                                       tile_elems=tile_elems)
    assert torch.equal(got.cpu(), want)
    via_b = scan_cuda.gather_tiles(elems.to(cuda), hot.to(cuda), width=width,
                                   tile_elems=tile_elems)
    assert torch.equal(via_b.cpu(), want.view(torch.uint8))


@pytest.mark.parametrize("width", [1, 2])
def test_fused_step_elements_cuda_equals_fused_body(cuda, width):
    from monkey_moore_tpu_torch.ops.host import prefilter_checks as sel
    from monkey_moore_tpu_torch.ops.scan_torch import (
        fused_body,
        pattern_device_args,
    )

    rng = np.random.default_rng(8)
    pat = compile_pattern("dr*gon", "*",
                          dtype=np.uint8 if width == 1 else np.uint16)
    te, n_tiles = 65_536, 9
    n_valid = n_tiles * te - 11
    plants = [4, te - 3, 4 * te + 17, n_valid - pat.length]
    elems = _planted_words(rng, pat, n_tiles, te, n_valid, plants).view(
        torch.uint8 if width == 1 else torch.uint16).to(cuda)
    pairs, exp = sel(pat)
    _, _, exp_exact, recovery = pattern_device_args(pat, cuda)
    want = fused_body(
        elems, n_valid, [int(e) for e in exp], pairs, exp_exact, recovery,
        length=pat.length, tile_elems=te, k_cap=8, p_cap=16,
        signed_compare=pat.signed_compare,
        pairs_exact=tuple(zip(map(int, pat.chk_shift_cur),
                              map(int, pat.chk_shift_prev))),
    )
    scan_cuda.reset_launch_counts()
    got = scan_cuda.tile_counts_gather_elems(pat, elems, n_valid, te, 8, 16)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["tile_counts_elems"] == 1
    assert scan_cuda.launch_counts["hot_combo"] == 1
    assert scan_cuda.launch_counts["gather_tiles_block"] == 0
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_probe_matches_every_kernel(cuda):
    from monkey_moore_tpu_torch.ops.probe import probe

    got = probe()
    assert got.library is not None and got.error is None
    assert [k.name for k in got.kernels] == [
        "tile_counts", "tile_counts_elems", "gather_tiles_block",
        "gather_tiles"]
    assert all(k.launched and k.matched for k in got.kernels), got.kernels


def test_dense_search_cuda_equals_cpu(cuda):
    from monkey_moore_tpu_torch.config import MatchSemantics
    from monkey_moore_tpu_torch.dense import dense_search

    rng = np.random.default_rng(9)
    data = rng.integers(0, 65536, 300_000).astype(np.uint16)
    for pos in (0, 262_142, 299_994):
        data[pos : pos + 6] = [ord(c) + 400 for c in "castle"]
    pat = compile_pattern("castle", dtype=np.uint16)
    for semantics in MatchSemantics:
        scan_cuda.reset_launch_counts()
        got = dense_search(pat, data, semantics, device="cuda")
        if semantics is not MatchSemantics.REFERENCE:
            assert scan_cuda.launch_counts["tile_counts_elems"] == 1
        assert got == dense_search(pat, data, semantics, device="cpu")
        assert [o for o, _ in got] == [0, 262_142, 299_994]


MULTI_KEYWORDS = [
    "monkey", "dr*gon", "?bcde", "abcdefghijkl", "sword", "castle", "ab*de",
    "zyxwv", "?rincess", "treasurechest", "shield", "potion", "b*tter",
    "knight", "aabcde", "ab",
]


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("tile_elems,n_tiles", [(64, 40), (262_144, 6)])
def test_tile_counts_multi_kernel_equals_plain(cuda, k, width, tile_elems,
                                               n_tiles):
    rng = np.random.default_rng(4 + k)
    dtype = np.uint8 if width == 1 else np.uint16
    pats = [
        compile_pattern(kw, next((c for c in "?*" if c in kw), 0),
                        dtype=dtype)
        for kw in MULTI_KEYWORDS[:k]
    ]
    mod = 1 << (8 * width)
    n_valid = n_tiles * tile_elems - 5
    arr = np.zeros((n_tiles + 1) * tile_elems, dtype=dtype)
    arr[:n_valid] = rng.integers(0, mod, n_valid).astype(dtype)
    for i, pat in enumerate(pats):
        kw = (np.array(pat.keyword, dtype=np.int64) + i) % mod
        for pos in (3 * i, (i % (n_tiles - 1) + 1) * tile_elems - 2):
            arr[pos : pos + pat.length] = kw.astype(dtype)
    last = pats[-1]
    arr[n_valid - last.length : n_valid] = (
        np.array(last.keyword, dtype=np.int64) % mod).astype(dtype)
    words = torch.from_numpy(arr.view("<i4").copy())
    table, last_starts = scan_cuda.multi_operand(pats, n_valid, "cpu")
    args = dict(width=width, tile_elems=tile_elems)
    want = scan_cuda.tile_counts_multi(words, table, last_starts, **args)
    before = scan_cuda.launch_counts["tile_counts_multi"]
    got = scan_cuda.tile_counts_multi(
        words.to(cuda), table.to(cuda), last_starts.to(cuda), **args)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["tile_counts_multi"] == before + 1
    assert got.shape == (k, n_tiles)
    assert got.cpu().tolist() == want.tolist()
    assert int(want[-1, -1]) > 0  # the last pattern at its last window


def test_engine_cuda_equals_cpu(cuda, tmp_path):
    from monkey_moore_tpu_torch.engine import SearchEngine

    rng = np.random.default_rng(3)
    data = rng.integers(0, 65536, 60_000).astype(np.uint16)
    enc = (np.array([ord(c) for c in "dragon"]) - 16).astype(np.uint16)
    for pos in (17, 30_000, len(data) - 6):
        data[pos : pos + 6] = enc
    path = tmp_path / "be16.bin"
    path.write_bytes(data.astype(">u2").tobytes())
    cfg = SearchConfig(
        file_path=path, keyword="dragon", element_width=2,
        endianness=Endianness.BIG, device_chunk_bytes=16_384,
        host_latency_threshold_bytes=0,
    )
    scan_cuda.reset_launch_counts()
    res_gpu = SearchEngine(cfg, device="cuda").run()
    assert scan_cuda.launch_counts["tile_counts"] > 0
    assert scan_cuda.launch_counts["hot_combo"] > 0
    assert scan_cuda.launch_counts["gather_tiles"] == 0
    res_cpu = SearchEngine(cfg, device="cpu").run()
    assert [r.offset for r in res_gpu] == [r.offset for r in res_cpu]
    assert [r.values_map for r in res_gpu] == [r.values_map for r in res_cpu]
    assert [r.offset for r in res_gpu] == [34, 60_000, 2 * (len(data) - 6)]


def test_multi_searcher_cuda_equals_cpu(cuda, tmp_path):
    from monkey_moore_tpu_torch.multi import MultiSearcher

    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 300_000).astype(np.uint8)
    for word, pos in (("sword", 17), ("shield", 150_000),
                      ("potion", len(data) - 6)):
        data[pos : pos + len(word)] = [ord(c) + 7 for c in word]
    path = tmp_path / "rom8.bin"
    path.write_bytes(data.tobytes())
    specs = ["sword", {"keyword": "sh*eld", "wildcard": "*"}, "potion",
             "missing"]
    scan_cuda.reset_launch_counts()
    got = MultiSearcher(path, device="cuda").search(specs)
    assert scan_cuda.launch_counts["tile_counts_multi"] > 0
    assert scan_cuda.launch_counts["tile_counts"] == 0
    want = MultiSearcher(path, device="cpu").search(specs)
    assert [[(r.offset, r.values_map) for r in g] for g in got] == [
        [(r.offset, r.values_map) for r in g] for g in want]
    assert [[r.offset for r in g] for g in got] == [
        [17], [150_000], [len(data) - 6], []]


@pytest.mark.parametrize("n_words,tile_words,offset", [
    (64 * 524_288, 524_288, 0),  # tail-free: 64 whole 2 MiB tiles
    (5 * 524_288 + 777, 524_288, 0),  # ragged: a partial tile left unread
    (40_000 + 3, 1_001, 1),  # tiles not 16-byte aligned, ragged
])
def test_load_sum_kernel_equals_plain_and_torch_sum(cuda, n_words,
                                                    tile_words, offset):
    rng = np.random.default_rng(n_words)
    host = rng.integers(-(2**31), 2**31, n_words + offset).astype(np.int32)
    words = torch.from_numpy(host).to(cuda)[offset:]
    before = scan_cuda.launch_counts["load_sum"]
    sums, total = scan_cuda.load_sum(words, tile_words)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["load_sum"] == before + 1
    p_sums, p_total = scan_cuda.load_sum_plain(words, tile_words)
    n_tiles = n_words // tile_words
    assert sums.shape == (n_tiles,) and sums.dtype == torch.int32
    assert torch.equal(sums, p_sums) and int(total) == int(p_total)
    body = words[: n_tiles * tile_words]
    assert int(total) == int(torch.sum(body, dtype=torch.int32))


def _words_at(arr, offset_words=0, device="cpu"):
    """*arr*'s bytes as int32 words, ``offset_words`` words into a longer
    buffer (a view whose data pointer is not 16-byte aligned)."""
    words = arr.reshape(-1).view("<i4")
    raw = np.zeros(len(words) + offset_words + 4, dtype=np.int32)
    raw[offset_words : offset_words + len(words)] = words
    return torch.from_numpy(raw).to(device)[
        offset_words : offset_words + len(words)]


def _elems_at(arr, offset=0, device="cpu"):
    """*arr* as a u8 or u16 tensor on *device* that starts ``offset`` bytes
    past a 16-byte boundary (``counts_bench.misaligned_copy``)."""
    t = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy()).to(device)
    t = t.view(torch.uint16) if arr.dtype == np.uint16 else t
    return misaligned_copy(t, offset)


def _counts(kernel, arr, checks, offset, device, **args):
    """Kernel A on *arr*'s packed words or kernel D on its elements (the
    plain version on the CPU), ``offset`` bytes into a longer buffer."""
    if kernel == "A":
        assert offset % 4 == 0
        return scan_cuda.tile_counts(
            _words_at(arr, offset // 4, device), checks.to(device),
            width=arr.dtype.itemsize, **args)
    return scan_cuda.tile_counts_elems(_elems_at(arr, offset, device),
                                       checks.to(device), **args)


def _checks(pairs, exps):
    table = np.zeros((3, len(pairs)), dtype=np.int64)
    table[0], table[1] = zip(*pairs)
    table[2] = exps
    return torch.tensor(table, dtype=torch.int32)


@pytest.mark.parametrize("kernel", ["A", "D"])
@pytest.mark.parametrize("width", [1, 2])
def test_tile_counts_every_shift_offset(cuda, width, kernel):
    """Kernels A and D at check shifts of every byte offset mod 4 and
    across the 16-byte group edge (cur 0-20 against prev 0, cur - 1 and
    17), one and two checks, with windows planted to match, against the
    plain version; D on elements that start inside a word (1 or 2 bytes
    past a 16-byte boundary)."""
    rng = np.random.default_rng(11)
    dtype = np.uint8 if width == 1 else np.uint16
    mod = 1 << (8 * width)
    te, n_tiles = 64, 20
    for cur in range(21):
        for prev in sorted({0, max(cur - 1, 0), 17}):
            second = ((cur * 7 + 3) % 23, 0)
            for pairs in ([(cur, prev)], [(cur, prev), second]):
                # a pair (c, c) holds only for expected 0
                exps = [int(e) if c != p_ else 0 for (c, p_), e in
                        zip(pairs, rng.integers(0, mod, len(pairs)))]
                length = max(max(p) for p in pairs) + 1
                arr = rng.integers(0, mod, (n_tiles + 1) * te).astype(dtype)
                for e in rng.integers(0, n_tiles * te - length, 12):
                    for (c, p), x in zip(pairs, exps):
                        arr[e + c] = (int(arr[e + p]) + x) % mod
                checks = _checks(pairs, exps)
                args = dict(tile_elems=te, length=length,
                            valid_count=n_tiles * te - 5)
                offset = 0 if kernel == "A" else width
                want = _counts(kernel, arr, checks, offset, "cpu", **args)
                got = _counts(kernel, arr, checks, offset, cuda, **args)
                assert got.cpu().tolist() == want.tolist(), (pairs, exps)
                if len(pairs) == 1:  # two checks may undo each other's plants
                    assert int(want.sum()) > 0


@pytest.mark.parametrize("kernel,te,n_tiles,offsets", [
    ("A", 4096, 6, (0, 1)),  # words 0 and 1 in
    # elements 1 and 3 in; 81 tiles of 309, the longest shift: the last
    # counted window is the buffer's last
    ("D", 309, 80, (1, 3)),
])
@pytest.mark.parametrize("width", [1, 2])
def test_tile_counts_long_keyword_every_check(cuda, width, kernel, te,
                                              n_tiles, offsets, monkeypatch):
    """A 310-element keyword under ``MMTPU_PREFILTER_CHECKS=0``: 309
    checks, shifts past the staged overhang, read from device memory.
    Kernel A with the limit 3 short of the counted tiles; kernel D on a
    buffer that starts inside a word and whose byte length is not a
    multiple of 4, with the limit at the buffer's end and a plant at its
    last window, so that the reads of the last counted window reach the
    buffer's last byte."""
    monkeypatch.setenv("MMTPU_PREFILTER_CHECKS", "0")
    rng = np.random.default_rng(12)
    word = "".join(chr(97 + (i * 7 + width) % 26) for i in range(310))
    pat = compile_pattern(word, dtype=np.uint8 if width == 1 else np.uint16)
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    assert checks.shape == (3, 309)
    valid = n_tiles * te - 3 if kernel == "A" else (n_tiles + 1) * te
    plants = [5, 2 * te - 100, 3 * te + 1, valid - pat.length]
    assert plants[-1] < n_tiles * te  # counted
    for offset in offsets:
        arr = _planted_elems(rng, pat, n_tiles, te, valid, plants)
        args = dict(tile_elems=te, length=pat.length, valid_count=valid)
        shift = 4 * offset if kernel == "A" else width * offset  # bytes
        want = _counts(kernel, arr, checks, shift, "cpu", **args)
        got = _counts(kernel, arr, checks, shift, cuda, **args)
        assert got.cpu().tolist() == want.tolist()
        assert int(want.sum()) >= len(plants)


@pytest.mark.parametrize("kernel,offset", [
    ("A", 0), ("A", 4), ("A", 12), ("D", 0), ("D", 2), ("D", 6),
    ("D", 14)])
@pytest.mark.parametrize("tile_elems", [8, 12, 1001, 8192, 262_144])
@pytest.mark.parametrize("kw,wc,width", [("abcde", 0, 1), ("ab*de", "*", 1),
                                         ("abcde", 0, 2), ("?bcde", "?", 2)])
def test_tile_counts_tile_sizes(cuda, kw, wc, width, tile_elems, kernel,
                                offset):
    """Kernels A and D at tiles of 8, 12, 1001, 8192 and 262144 elements
    (several tiles to a block's unit, one tile to a unit), on buffers
    *offset* bytes past a 16-byte boundary: A's words 0, 4 and 12 bytes
    in, D's elements also 2, 6 and 14 bytes in (inside a word).  D's
    1001-element tiles end the buffer inside a word; A's buffer has a
    whole number of words."""
    rng = np.random.default_rng(tile_elems + offset)
    pat = compile_pattern(kw, wc, dtype=np.uint8 if width == 1 else np.uint16)
    te = tile_elems
    n_tiles = max(3, min(4096, (4 << 20) // (te * width)))
    while kernel == "A" and (n_tiles + 1) * te * width % 4:
        n_tiles += 1
    valid = n_tiles * te - 3
    plants = [0, te + 1, (n_tiles // 2) * te - 2, valid - pat.length]
    arr = _planted_elems(rng, pat, n_tiles, te, valid, plants)
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    args = dict(tile_elems=te, length=pat.length, valid_count=valid)
    want = _counts(kernel, arr, checks, offset, "cpu", **args)
    got = _counts(kernel, arr, checks, offset, cuda, **args)
    assert got.cpu().tolist() == want.tolist()
    assert int(want.sum()) >= len(plants)


@pytest.mark.parametrize("n_tiles", [5, 6])
@pytest.mark.parametrize("tile_elems", [1001, 4096])
@pytest.mark.parametrize("width,offset", [(1, o) for o in range(16)]
                         + [(2, o) for o in range(0, 16, 2)])
def test_tile_counts_elems_every_offset(cuda, width, offset, tile_elems,
                                        n_tiles):
    """Kernel D on u8 elements at every start 0-15 bytes past a 16-byte
    boundary and on u16 elements at every even one, with buffers whose
    byte length is a multiple of 4 and ones whose length is not (u8 tiles
    of 1001 elements, an odd number of u16 tiles of 1001), against its
    plain version and, on the same bytes where they are whole aligned
    words, against kernel A."""
    rng = np.random.default_rng(100 * offset + tile_elems + n_tiles)
    dtype = np.uint8 if width == 1 else np.uint16
    pat = compile_pattern("ab*de", "*", dtype=dtype)
    te = tile_elems
    valid = n_tiles * te - 2
    plants = [0, te - 2, 3 * te + 7, valid - pat.length]
    arr = _planted_elems(rng, pat, n_tiles, te, valid, plants)
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    args = dict(tile_elems=te, length=pat.length, valid_count=valid)
    scan_cuda.reset_launch_counts()
    got = _counts("D", arr, checks, offset, cuda, **args)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["tile_counts_elems"] == 1
    want = _counts("D", arr, checks, offset, "cpu", **args)
    assert got.cpu().tolist() == want.tolist()
    assert int(want.sum()) >= len(plants)
    if arr.nbytes % 4 == 0 and offset % 4 == 0:
        got_a = _counts("A", arr, checks, offset, cuda, **args)
        assert got_a.cpu().tolist() == want.tolist()


@pytest.mark.parametrize("width", [1, 2])
def test_counts_valid_count_at_a_tile_end(cuda, width):
    """``valid_count`` at each of the last 32 positions of a tile, on data
    where every window matches (zeros, a keyword of equal letters) and on
    random data: kernel A, kernel D (on the same elements, starting inside
    a word), and kernel C with two keywords of different lengths, against
    their plain versions."""
    rng = np.random.default_rng(13)
    dtype = np.uint8 if width == 1 else np.uint16
    mod = 1 << (8 * width)
    te, n_tiles = 4096, 4
    same = compile_pattern("aaaaa", dtype=dtype)
    pats = [same, compile_pattern("aaaaaaaaa", dtype=dtype)]
    for arr in (np.zeros((n_tiles + 1) * te, dtype=dtype),
                rng.integers(0, mod, (n_tiles + 1) * te).astype(dtype)):
        words = _words_at(arr)
        gpu = words.to(cuda)
        elems = _elems_at(arr, width, cuda)
        checks = scan_cuda.prefilter_operand(same, "cpu")
        for valid in range(3 * te - 32, 3 * te):
            args = dict(width=width, tile_elems=te, length=same.length,
                        valid_count=valid)
            want = scan_cuda.tile_counts(words, checks, **args)
            got = scan_cuda.tile_counts(gpu, checks.to(cuda), **args)
            assert got.cpu().tolist() == want.tolist(), valid
            del args["width"]
            want_d = scan_cuda.tile_counts_elems(_elems_at(arr), checks,
                                                 **args)
            got_d = scan_cuda.tile_counts_elems(elems, checks.to(cuda),
                                                **args)
            assert got_d.cpu().tolist() == want_d.tolist() == want.tolist()
            table, last_starts = scan_cuda.multi_operand(pats, valid, "cpu")
            cargs = dict(width=width, tile_elems=te)
            want_c = scan_cuda.tile_counts_multi(words, table, last_starts,
                                                 **cargs)
            got_c = scan_cuda.tile_counts_multi(gpu, table.to(cuda),
                                                last_starts.to(cuda), **cargs)
            assert got_c.cpu().tolist() == want_c.tolist(), valid
        if not arr.any():
            assert int(want.sum()) == 3 * te - 1 - same.length + 1


@pytest.mark.parametrize("k", [1, 3, 8, 16])
@pytest.mark.parametrize("width", [1, 2])
def test_tile_counts_multi_padding_and_limits(cuda, k, width):
    """Kernel C at 8192-element tiles with the phase 3 batch's keywords
    (leading wildcard, wildcard, canonical ones whose padding checks are
    inactive), per-pattern limits that differ (cut short, negative, past
    the buffer) and a data pointer 4 bytes past a 16-byte boundary."""
    from monkey_moore_tpu_torch.counts_bench import BATCH

    rng = np.random.default_rng(14 + k)
    dtype = np.uint8 if width == 1 else np.uint16
    mod = 1 << (8 * width)
    pats = [compile_pattern(kw, wc, dtype=dtype) for kw, wc in BATCH[:k]]
    te, n_tiles = 8192, 9
    valid = n_tiles * te - 7
    arr = rng.integers(0, mod, (n_tiles + 1) * te).astype(dtype)
    for i, pat in enumerate(pats):
        kw = (np.array(pat.keyword, dtype=np.int64) + i) % mod
        for pos in (3 + 40 * i, (i % (n_tiles - 1) + 1) * te - 2,
                    valid - pat.length):
            arr[pos : pos + pat.length] = kw.astype(dtype)
    words = _words_at(arr, 1)
    table, last_starts = scan_cuda.multi_operand(pats, valid, "cpu")
    assert not bool(table[:, 3].all()) or k == 1  # padding checks present
    cuts = [valid - p.length - 5000 * (i % 3) for i, p in enumerate(pats)]
    if k > 2:
        cuts[1], cuts[2] = -1, 10 * n_tiles * te
    for limits in (last_starts, torch.tensor(cuts, dtype=torch.int64)):
        args = dict(width=width, tile_elems=te)
        want = scan_cuda.tile_counts_multi(words, table, limits, **args)
        got = scan_cuda.tile_counts_multi(words.to(cuda), table.to(cuda),
                                          limits.to(cuda), **args)
        assert got.cpu().tolist() == want.tolist()
    assert int(want.sum()) > 0


@pytest.mark.parametrize("k,length,n_checks", [(3058, 5, 4), (5282, 3, 2)])
def test_tile_counts_multi_batch_past_one_block(cuda, k, length, n_checks):
    """Kernel C at the main path's tiles on batches as large as the scalar
    kernel it replaced took there (3058 keywords of 4 checks, 5282 of 2):
    their tables outgrow one block's shared memory, so the batch runs as
    groups of patterns, each writing its own rows of counts."""
    rng = np.random.default_rng(k)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    pats = [compile_pattern("".join(rng.choice(letters, length)))
            for _ in range(k)]
    te, n_tiles = 262_144, 2
    valid = n_tiles * te - 3
    arr = rng.integers(0, 256, (n_tiles + 1) * te).astype(np.uint8)
    for i in range(0, k, 97):
        kw = (np.array(pats[i].keyword, dtype=np.int64) + i) % 256
        pos = int(rng.integers(0, valid - length))
        arr[pos : pos + length] = kw.astype(np.uint8)
    words = torch.from_numpy(arr.view("<i4").copy()).to(cuda)
    table, last_starts = scan_cuda.multi_operand(pats, valid, cuda)
    assert not bool(table[:, 3, n_checks:].any())  # only padding cut away
    table = table[:, :, :n_checks].contiguous()
    args = dict(width=1, tile_elems=te)
    got = scan_cuda.tile_counts_multi(words, table, last_starts, **args)
    want = scan_cuda.tile_counts_multi_plain(words, table, last_starts,
                                             **args)
    assert torch.equal(got, want) and int(want.sum()) > 0


# ---- meshes on the card ---------------------------------------------------------


def _mesh_corpus(tmp_path, n_bytes=300_000):
    """Seeded bytes with "monkey" (+3) at shard and tile boundaries of a
    four-shard mesh, 1 100 "dr?gon" (+7) plants that overflow a step, and
    16-bit big-endian "monkey" (+0x3000) at both byte alignments."""
    rng = np.random.default_rng(9)
    data = rng.integers(0, 256, n_bytes).astype(np.uint8)
    kw = (np.array([ord(c) for c in "monkey"]) + 3).astype(np.uint8)
    for pos in (0, 65_533, 131_070, 200_001, n_bytes - 6):
        data[pos : pos + 6] = kw
    kw2 = (np.array([ord(c) for c in "dragon"]) + 7).astype(np.uint8)
    for i in range(1100):
        kw2[2] = i % 251
        data[70_003 + 8 * i : 70_009 + 8 * i] = kw2
    kw3 = (np.array([ord(c) for c in "monkey"]) + 0x3000).astype(">u2")
    for pos in (2_000, 150_001, n_bytes - 31):  # both byte alignments
        data[pos : pos + 12] = kw3.view(np.uint8)
    path = tmp_path / "mesh.bin"
    path.write_bytes(data.tobytes())
    return path


MESH_STATS = ("hot_tiles", "candidates", "fused_steps", "fused_fallbacks",
              "device_dispatches", "bytes_scanned", "chunks", "d2h_bytes",
              "h2d_bytes", "ici_halo_bytes", "per_device_candidates")


@pytest.mark.parametrize("kwargs", [
    dict(keyword="monkey"),
    dict(keyword="dr*gon", wildcard="*"),
    dict(keyword="m**", wildcard="*"),
    dict(keyword="monkey", element_width=2, endianness=Endianness.BIG),
    dict(keyword="monkey", resident_bytes_limit=0, device_chunk_bytes=65_536),
])
def test_mesh_engine_equals_cpu_mesh(cuda, tmp_path, kwargs):
    """The engine on ``["cuda:0"] * 4`` (kernels A and L on every shard)
    against the same mesh of CPU shards (the plain versions): results and
    stats, first search and repeat."""
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.parallel.resident import (
        clear_sharded_corpus_cache,
    )

    path = _mesh_corpus(tmp_path)
    runs = {}
    for dev in ("cuda:0", "cpu"):
        clear_sharded_corpus_cache()
        cfg = SearchConfig(file_path=path, devices=[dev] * 4, **kwargs)
        scan_cuda.reset_launch_counts()
        for _ in range(2):
            engine = SearchEngine(cfg, device=dev)
            got = [(r.offset, r.values_map) for r in engine.run()]
            runs.setdefault(dev, []).append(
                (got, [getattr(engine.last_stats, k) for k in MESH_STATS]))
        launches = dict(scan_cuda.launch_counts)
        if dev == "cuda:0":
            assert launches["hot_combo"] > 0, launches
            assert launches["gather_tiles"] == 0, launches
            assert launches["tile_counts_elems"] == 0, launches
            assert launches["gather_tiles_block"] == 0, launches
    clear_sharded_corpus_cache()
    assert runs["cuda:0"] == runs["cpu"]
    assert runs["cpu"][0][0]


def test_mesh_batch_equals_cpu_mesh(cuda, tmp_path):
    from monkey_moore_tpu_torch.multi import MultiSearcher

    path = _mesh_corpus(tmp_path)
    specs = ["monkey", {"keyword": "dr*gon", "wildcard": "*"}, "zzzzz"]
    scan_cuda.reset_launch_counts()
    got = MultiSearcher(path, devices=["cuda:0"] * 4,
                        device="cuda").search(specs)
    assert scan_cuda.launch_counts["tile_counts_multi"] == 4
    assert scan_cuda.launch_counts["tile_counts"] == 0
    want = MultiSearcher(path, devices=["cpu"] * 4,
                         device="cpu").search(specs)
    assert [[(r.offset, r.values_map) for r in g] for g in got] == [
        [(r.offset, r.values_map) for r in g] for g in want]
    assert len(got[0]) == 5 and len(got[1]) == 1100


@pytest.mark.parametrize("tile_elems", [2, 256, 8192])
def test_sharded_fused_step_equals_cpu(cuda, tile_elems):
    """The chunk step's shards on the card (tiles of 2 bytes travel as
    elements: kernels D and E) against CPU shards."""
    from monkey_moore_tpu_torch.parallel.mesh import make_mesh
    from monkey_moore_tpu_torch.parallel.sharded import sharded_fused_step

    rng = np.random.default_rng(4)
    count = 50_001 if tile_elems > 2 else 301
    data = rng.integers(0, 256, count).astype(np.uint8)
    for pos in range(3, count - 4, 97):
        data[pos : pos + 4] = [97, 98, 97, 98]
    pat = compile_pattern("ab" if tile_elems == 2 else "abab")
    got = sharded_fused_step(pat, data, make_mesh(["cuda:0"] * 3), count,
                             tile_elems)
    want = sharded_fused_step(pat, data, make_mesh(["cpu"] * 3), count,
                              tile_elems)
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
    assert got[2] == want[2] and (got[3] is None) == (want[3] is None)


@pytest.mark.parametrize("width", [1, 2])
def test_gather_modes_give_equal_combos(cuda, width):
    """``perf_probe``'s ``ab`` tails on the card (kernel L; the plain tail
    after kernel E's entry on the same bytes or ``index_select`` of the
    tile view): the same combo buffer, equal to the CPU step's, with more
    hot tiles than the step's ``k_cap`` in one case."""
    from monkey_moore_tpu_torch import bench, perf_probe
    from monkey_moore_tpu_torch.dense import fused_count_extract_start
    from monkey_moore_tpu_torch.ops.host import LANES
    from monkey_moore_tpu_torch.perf_probe import GATHER_MODES

    te = 8 * LANES
    n_bytes = 64 * te * width
    pat = compile_pattern("ab*de", "*",
                          dtype=np.uint8 if width == 1 else np.uint16)
    n = n_bytes // width
    for plants in (5, 60):
        words = bench.make_corpus(n_bytes, plants, "cpu",
                                  halo_bytes=te * width)
        elems = words.view(torch.uint8 if width == 1 else torch.int16)
        kw = torch.tensor(pat.keyword, dtype=elems.dtype)
        for pos in np.linspace(1, n - 5, plants).astype(int):
            elems[pos : pos + 5] = kw
        data = bench.tile_view(words, n_bytes, te * width)
        pending = fused_count_extract_start(pat, data, n, tile_elems=te)
        want = pending.combo_dev.numpy()
        assert (want[0] > pending.k_cap) == (plants == 60)
        scan_cuda.reset_launch_counts()
        combos = perf_probe.gather_combos(pat, data.to(cuda), n, te)
        assert list(combos) == list(GATHER_MODES)
        assert scan_cuda.launch_counts["hot_combo"] == 1
        assert scan_cuda.launch_counts["gather_tiles"] == 0
        assert scan_cuda.launch_counts["gather_tiles_block"] == 1
        for gm, combo in combos.items():
            assert np.array_equal(combo, want), (gm, plants)


def _tail_cases(te):
    """Kernel L's cases at tiles of *te* elements (the CPU cases of
    ``tests/test_torch_elems.py``): name -> ``(keyword, wildcard, dtype,
    tiles T, valid count, plants, background)``."""
    return {
        "no-hot-tile": ("abcde", 0, np.uint8, 4, 4 * te, [], "zeros"),
        "wild-one-hot-partial": ("ab*de", "*", np.uint8, 4, 4 * te - 5,
                                 [te + 7], "random"),
        "u16-n-hot-at-k-cap": ("abcde", 0, np.uint16, 6, 6 * te,
                               [3, 2 * te + 9, 3 * te + 30, 5 * te + 50],
                               "random"),
        "u16-wild-n-hot-over-k-cap": ("ab*de", "*", np.uint16, 6, 6 * te,
                                      [t * te + 11 for t in range(5)],
                                      "random"),
        "n-cand-over-p-cap": ("abcde", 0, np.uint8, 3, 3 * te - 1, [],
                              "ramp"),
        "partial-last-tile": ("abcde", 0, np.uint8, 4, 3 * te + 17,
                              [1, 3 * te + 12, 3 * te + 19], "random"),
        "last-tile-halo-padding": ("abcde", 0, np.uint8, 3, 3 * te,
                                   [3 * te - 9, 3 * te - 2], "random"),
        "u16-wild-recovery-at-limit": ("??cde", "?", np.uint16, 3,
                                       2 * te + 9, [2 * te + 4], "random"),
        "wild-recovery-clamped": ("?bcdE", "?", np.uint8, 3, 3 * te, [],
                                  "zeros"),
    }


def _tail_operands(name, te, seed=0):
    """A case's elements (numpy), its counts (kernel D's plain version) and
    its pattern."""
    kw, wc, dtype, n_tiles, n, plants, background = _tail_cases(te)[name]
    pat = compile_pattern(kw, wc, dtype=dtype)
    mod = 1 << (8 * np.dtype(dtype).itemsize)
    rng = np.random.default_rng(seed)
    arr = np.zeros((n_tiles + 1) * te, dtype=dtype)
    if background == "random":
        arr[:n] = rng.integers(0, mod, n)
    elif background == "ramp":
        arr[:n] = np.arange(n) % mod
    arr[n:] = rng.integers(0, mod, len(arr) - n)
    kwv = ((np.array(pat.keyword, dtype=np.int64) + 7) % mod).astype(dtype)
    arr[n_tiles * te + 3 : n_tiles * te + 3 + pat.length] = kwv
    for pos in plants:
        arr[pos : pos + pat.length] = kwv
    counts = scan_cuda.tile_counts_elems(
        torch.from_numpy(arr), scan_cuda.prefilter_operand(pat, "cpu"),
        tile_elems=te, length=pat.length, valid_count=n)
    return pat, arr, counts, n


def _hot_combo_both(pat, elems_cpu, elems_dev, counts, n, te, k_cap, p_cap):
    """Kernel L on *elems_dev* and its plain version on *elems_cpu*: the
    two combo buffers, the kernel's launched once and synchronised."""
    from monkey_moore_tpu_torch.ops.scan_torch import pattern_device_args

    args = dict(tile_elems=te, length=pat.length,
                signed_compare=pat.signed_compare, k_cap=k_cap, p_cap=p_cap)
    want = scan_cuda.hot_combo_plain(
        elems_cpu, counts, n, *pattern_device_args(pat, "cpu"), **args)
    before = scan_cuda.launch_counts["hot_combo"]
    got = scan_cuda.hot_combo(
        elems_dev, counts.to(elems_dev.device), n,
        *pattern_device_args(pat, elems_dev.device), **args)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["hot_combo"] == before + 1
    return got.cpu(), want


TAIL_NAMES = list(_tail_cases(1))


@pytest.mark.parametrize("te", [64, 65_536])
@pytest.mark.parametrize("name", TAIL_NAMES)
def test_hot_combo_kernel_equals_plain(cuda, name, te):
    """Kernel L against its plain version, every entry of the combo
    buffer (fillers included), k_cap 4 and p_cap 8: tiles of 64 elements
    (one unit a slot) and of 64 Ki (4 units a slot at u8, 8 at u16)."""
    pat, arr, counts, n = _tail_operands(name, te)
    got, want = _hot_combo_both(pat, torch.from_numpy(arr),
                                torch.from_numpy(arr).to(cuda), counts, n,
                                te, 4, 8)
    assert torch.equal(got, want)
    n_hot, n_cand = int(want[0]), int(want[2])
    assert (n_hot == 0) == name.endswith(("no-hot-tile", "clamped"))
    assert (n_hot > 4) == ("over-k-cap" in name)
    assert (n_cand > 8) == ("over-p-cap" in name)


@pytest.mark.parametrize("k_cap", [4, 64])
@pytest.mark.parametrize("n_tiles", [5_000, 1_100_000])
def test_hot_combo_kernel_over_many_select_blocks(cuda, n_tiles, k_cap):
    """Kernel L with its counts spread over many select blocks (1024
    counts a block up to 2^20 tiles, 2048 past that): hot tiles on both
    sides of block edges, blocks with none between them, fewer and more
    hot tiles than k_cap; equal to the plain version, every entry."""
    te = 8
    pat = compile_pattern("abcde")
    rng = np.random.default_rng(n_tiles + k_cap)
    arr = rng.integers(0, 256, (n_tiles + 1) * te).astype(np.uint8)
    hot = sorted({0, 1023, 1024, 2047, 2048, 4095, n_tiles // 2,
                  n_tiles - 1} | set(rng.choice(n_tiles, 40,
                                                replace=False).tolist()))
    kwv = ((np.array(pat.keyword, dtype=np.int64) + 7) % 256).astype(
        np.uint8)
    for t in hot:
        arr[t * te + 1 : t * te + 1 + pat.length] = kwv
    counts = torch.zeros(n_tiles, dtype=torch.int32)
    counts[torch.tensor(hot)] = torch.from_numpy(
        rng.integers(1, 4, len(hot)).astype(np.int32))
    got, want = _hot_combo_both(pat, torch.from_numpy(arr),
                                torch.from_numpy(arr).to(cuda), counts,
                                n_tiles * te, te, k_cap, 64)
    assert torch.equal(got, want)
    assert int(want[0]) == len(hot) and int(want[2]) >= min(len(hot), k_cap)


@pytest.mark.parametrize("width,offset", [(1, 1), (1, 7), (2, 2), (2, 14)])
def test_hot_combo_kernel_on_a_view_inside_a_word(cuda, width, offset):
    """Kernel L on elements *offset* bytes into a larger buffer, so that
    its first and last words hold bytes of no element (the Reader's
    masks), with hot tiles at both ends: equal to the plain version."""
    name = "wild-one-hot-partial" if width == 1 else "u16-n-hot-at-k-cap"
    pat, arr, counts, n = _tail_operands(name, 4096, seed=offset)
    counts[0] = max(int(counts[0]), 1)  # the first tile is hot too
    raw = torch.zeros(arr.nbytes + offset + 16, dtype=torch.uint8)
    raw[offset : offset + arr.nbytes] = torch.from_numpy(arr.view(np.uint8))
    view = raw.to(cuda)[offset : offset + arr.nbytes]
    elems = view.view(torch.uint16) if width == 2 else view
    got, want = _hot_combo_both(pat, torch.from_numpy(arr), elems, counts,
                                n, 4096, 8, 16)
    assert torch.equal(got, want)
    assert int(want[0]) >= 2


def test_resident_search_runs_the_tail_kernel(cuda, tmp_path, monkeypatch):
    """One resident engine search on the card under a profiler: kernel L
    once per fused step, its counter ``step.tail_kernel`` in the run's
    record once per step too, and ``exact_phase2`` on no CUDA tensor."""
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.ops import scan_torch

    on_cuda = []

    def spy(real):
        def wrapper(slots, *args, **kwargs):
            on_cuda.append(slots.is_cuda)
            return real(slots, *args, **kwargs)
        return wrapper

    monkeypatch.setattr(scan_torch, "exact_phase2",
                        spy(scan_torch.exact_phase2))
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 3_000_000).astype(np.uint8)
    for pos in (5, 1_048_570, 2_999_990):
        data[pos : pos + 6] = [ord(c) + 9 for c in "dragon"]
    path = tmp_path / "rom.bin"
    path.write_bytes(data.tobytes())
    cfg = SearchConfig(file_path=path, keyword="dragon",
                       device_chunk_bytes=1 << 20,
                       host_latency_threshold_bytes=0)
    scan_cuda.reset_launch_counts()
    engine = SearchEngine(cfg, device="cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got = engine.run()
    steps = engine.last_stats.fused_steps
    assert steps >= 3
    assert scan_cuda.launch_counts["hot_combo"] == steps
    assert engine.last_stats.record.counters["step.tail_kernel"] == steps
    assert scan_cuda.launch_counts["tile_counts"] == steps
    assert scan_cuda.launch_counts["gather_tiles"] == 0
    assert not any(on_cuda)
    assert [r.offset for r in got] == [5, 1_048_570, 2_999_990]


_DERIVE_KINDS = [(1, False), (2, False), (2, True)]  # (width, big)


def _derive_both(raw, byte_shift, width, big):
    """Kernel M and its plain version on the same CUDA words; the kernel's
    launch counted once."""
    before = scan_cuda.launch_counts["derive_words"]
    got = scan_cuda.derive_words(raw, byte_shift, width, big)
    torch.cuda.synchronize()
    assert scan_cuda.launch_counts["derive_words"] == before + 1
    return got, scan_cuda.derive_words_plain(raw, byte_shift, width, big)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4097, 2**20 + 3])
@pytest.mark.parametrize("width,big", _DERIVE_KINDS)
@pytest.mark.parametrize("byte_shift", range(4))
def test_derive_words_kernel_equals_plain(cuda, byte_shift, width, big, n):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + byte_shift)
    raw = torch.randint(-(2**31), 2**31, (n + 1,), dtype=torch.int32,
                        device=cuda, generator=gen)
    got, want = _derive_both(raw, byte_shift, width, big)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, want)


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("width,big", _DERIVE_KINDS)
@pytest.mark.parametrize("byte_shift", range(4))
def test_derive_words_kernel_on_a_view(cuda, byte_shift, width, big,
                                       offset):
    """Kernel M on words *offset* words into a larger buffer, so that the
    view does not start on a 16-byte boundary: the word path."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(offset)
    base = torch.randint(-(2**31), 2**31, (2**20 + 16,), dtype=torch.int32,
                         device=cuda, generator=gen)
    raw = base[offset : offset + 2**20 + 4]
    assert raw.data_ptr() % 16 != 0
    got, want = _derive_both(raw, byte_shift, width, big)
    assert torch.equal(got, want)


def test_derive_words_kernel_past_2_31_bytes(cuda):
    """Kernel M over 2^31 + 20 bytes of output: 64-bit indices."""
    n = 2**29 + 5
    raw = torch.empty(n + 1, dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(31)
    raw.random_(-(2**31), 2**31, generator=gen)
    got, want = _derive_both(raw, 3, 2, True)
    assert torch.equal(got, want)
    lo, hi = (int(x) & 0xFFFFFFFF for x in raw[-2:].cpu())
    w = ((lo | hi << 32) >> 24) & 0xFFFFFFFF
    w = ((w >> 8) & 0x00FF00FF) | ((w << 8) & 0xFF00FF00)
    assert int(got[-1]) & 0xFFFFFFFF == w


def test_resident_search_counts_the_derive_kernel(cuda, tmp_path):
    """Resident engine searches on the card under a profiler: a 16-bit
    big-endian search launches kernel M on every step (each of its grids
    swaps) and counts it in the run's record; an 8-bit search derives
    nothing, launches nothing and counts nothing."""
    from monkey_moore_tpu_torch.engine import SearchEngine

    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, 3_000_000).astype(np.uint8)
    enc = (np.array([ord(c) for c in "dragon"]) + 300).astype(">u2")
    plants = [6, 1_500_001, 2_999_000]  # both alignments
    for pos in plants:
        data[pos : pos + 12] = enc.view(np.uint8)
    path = tmp_path / "be16.bin"
    path.write_bytes(data.tobytes())
    common = dict(file_path=path, keyword="dragon",
                  device_chunk_bytes=1 << 20, host_latency_threshold_bytes=0)
    for cfg, derives in (
        (SearchConfig(element_width=2, endianness=Endianness.BIG, **common),
         True),
        (SearchConfig(**common), False),
    ):
        scan_cuda.reset_launch_counts()
        engine = SearchEngine(cfg, device="cuda")
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = engine.run()
        steps = engine.last_stats.fused_steps
        counters = engine.last_stats.record.counters
        assert steps >= 3
        if derives:
            assert scan_cuda.launch_counts["derive_words"] == steps
            assert counters["corpus.derive_kernel"] == steps
            assert counters["corpus.derive_bytes"] >= 8 * steps * (
                (1 << 20) // 4)
            assert [r.offset for r in got] == plants
        else:
            assert scan_cuda.launch_counts["derive_words"] == 0
            assert "corpus.derive_kernel" not in counters
            assert "corpus.derive_bytes" not in counters
