"""The PyTorch port's element-array path against the JAX package, on the
same u8/u16 element arrays made with numpy from a fixed seed:

- kernel D's plain version (``scan_cuda.tile_counts_elems_plain``, and the
  wrapper on CPU tensors) against the Pallas ``_tile_counts_call`` in
  interpret mode (``tile_counts_pallas(mode="native")``) and against
  ``scan_jnp.tile_counts_xla``;
- kernel E's plain version against the Pallas ``_gather_tiles_call`` in
  interpret mode and against kernel B's plain version; across the card
  tests' gather shapes, B's and E's plain versions against a numpy slice
  and, where the tile is whole 128-lane rows, against
  ``_gather_tiles_dma_call`` and ``_gather_tiles_call`` in interpret mode;
- the element-array fused step (``dense.fused_count_extract_start`` on
  element tensors, and the plain twin ``scan_torch.fused_body``) against
  ``_native_counts_gather_call`` (interpret) and
  ``scan_jnp.tile_counts_gather_xla``, combo field by combo field;
- kernel L's plain version (``scan_cuda.hot_combo_plain``) on the counts
  and elements of ``scan_jnp.tile_counts_gather_xla``, combo field by combo
  field: no hot tile, one, k_cap and more, more matches than p_cap, a
  partial last tile, the last tile's halo in the padding tile, and a
  recovery shift at and past the slot's valid limit;
- ``dense_search`` / ``dense_candidates`` / ``two_phase_candidates``
  against the JAX functions on the named corpora of ``tests/test_scan.py``
  and its width-1/width-2 fuzz.

Tolerance: exact equality throughout — every value is an integer.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monkey_moore_tpu import dense as jdense
from monkey_moore_tpu.config import MatchSemantics
from monkey_moore_tpu.ops.scan_jnp import (
    pattern_device_args,
    prefilter_checks,
    tile_counts_gather_xla,
    tile_counts_xla,
)
from monkey_moore_tpu.ops.scan_pallas import (
    LANES,
    _gather_tiles_call,
    _gather_tiles_dma_call,
    tile_counts_pallas,
)
from monkey_moore_tpu.pattern import compile_pattern
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import dense as tdense
from monkey_moore_tpu_torch.ops import scan_cuda, scan_torch
from monkey_moore_tpu_torch.ops.host import combo_fields
from test_scan import CORPORA
from test_torch_dense import _assert_same_step

TE = 32 * 1024  # smallest count tile the interpret-mode Pallas path takes

CASES = [("abcde", 0, np.uint8), ("ab*de", "*", np.uint8),
         ("abcde", 0, np.uint16), ("But**er", "*", np.uint16)]


def _elements(pat, n_tiles, n, plants, seed):
    """``n_tiles + 1`` tiles of elements: seeded random up to ``n``, zero
    past it, the keyword (+3) at each plant."""
    mod = 1 << (8 * np.dtype(pat.dtype).itemsize)
    arr = np.zeros((n_tiles + 1) * TE, dtype=pat.dtype)
    arr[:n] = np.random.default_rng(seed).integers(0, mod, n)
    kw = ((np.array(pat.keyword, dtype=np.int64) + 3) % mod).astype(pat.dtype)
    for pos in plants:
        arr[pos : pos + len(kw)] = kw
    return arr


@pytest.mark.parametrize("kw,wc,dtype", CASES)
def test_tile_counts_elems_equal(kw, wc, dtype):
    pat = compile_pattern(kw, wc, dtype=dtype)
    L = pat.length
    n = 3 * TE - 1234  # ragged valid limit
    plants = [5, TE - 2, 2 * TE + 100, n - L]  # start, straddle, last
    arr = _elements(pat, 3, n, plants + [n + 10], seed=1)  # + past limit
    want = np.asarray(tile_counts_pallas(
        pat, jnp.asarray(arr).reshape(-1, LANES), n, tile_rows=TE // LANES,
        interpret=True, mode="native",
    ))
    pairs, exp = prefilter_checks(pat)
    xla = np.asarray(tile_counts_xla(
        jnp.asarray(arr), jnp.int32(n), jnp.asarray(exp), pairs=pairs,
        length=L, tile_elems=TE,
    ))
    elems = torch.from_numpy(arr)
    tpat = carry_over(pat)
    checks = scan_cuda.prefilter_operand(tpat, "cpu")
    args = dict(tile_elems=TE, length=L, valid_count=n)
    plain = scan_cuda.tile_counts_elems_plain(elems, checks, **args)
    wrapped = scan_cuda.tile_counts_elems(elems, checks, **args)
    port = tdense.tile_counts(tpat, elems, n, tile_elems=TE)
    assert plain.tolist() == want.tolist() == xla.tolist()
    assert wrapped.tolist() == port.tolist() == want.tolist()
    assert want[0] >= 2 and want[2] >= 2


#: kernel D's operand as a view into a larger tensor: u8 elements 1-15
#: bytes in, u16 elements 2-14 (even) bytes in
VIEW_OFFSETS = ([(np.uint8, o) for o in range(1, 16)]
                + [(np.uint16, o) for o in range(2, 16, 2)])


@pytest.mark.parametrize("tile_elems", [1001, 4096])
@pytest.mark.parametrize("dtype,offset", VIEW_OFFSETS)
def test_tile_counts_elems_views_equal(dtype, offset, tile_elems):
    """Kernel D's plain version, through the wrapper on CPU tensors, on a
    view *offset* bytes into a larger tensor, against
    ``scan_jnp.tile_counts_xla`` on the same elements: 7 tiles of 1001
    elements (a byte length that is not a multiple of 4, u8 and u16) and
    of 4096, a whole number of the Pallas kernel's 32-row x 128-lane
    tiles, where ``_tile_counts_call`` in interpret mode is held to them
    too."""
    kw, wc = ("abcde", 0) if dtype == np.uint8 else ("ab*de", "*")
    pat = compile_pattern(kw, wc, dtype=dtype)
    L, te, n_tiles = pat.length, tile_elems, 6
    n = n_tiles * te - 3 - offset  # a ragged limit, a different one a view
    mod = 1 << (8 * np.dtype(dtype).itemsize)
    arr = np.zeros((n_tiles + 1) * te, dtype=dtype)
    arr[:n] = np.random.default_rng(offset).integers(0, mod, n)
    kwv = ((np.array(pat.keyword, dtype=np.int64) + 3) % mod).astype(dtype)
    plants = [offset, te - 2, 4 * te + 1, n - L]  # start, straddle, last
    for pos in plants:
        arr[pos : pos + L] = kwv
    raw = np.zeros(arr.nbytes + offset + 16, dtype=np.uint8)
    raw[offset : offset + arr.nbytes] = arr.view(np.uint8)
    view = torch.from_numpy(raw)[offset : offset + arr.nbytes]
    elems = view.view(torch.uint16) if dtype == np.uint16 else view
    assert elems.storage_offset() * elems.element_size() == offset
    pairs, exp = prefilter_checks(pat)
    xla = np.asarray(tile_counts_xla(
        jnp.asarray(arr), jnp.int32(n), jnp.asarray(exp), pairs=pairs,
        length=L, tile_elems=te,
    ))
    checks = scan_cuda.prefilter_operand(carry_over(pat), "cpu")
    got = scan_cuda.tile_counts_elems(elems, checks, tile_elems=te,
                                      length=L, valid_count=n)
    assert got.tolist() == xla.tolist()
    assert int(got.sum()) >= len(plants)
    if te % (32 * LANES) == 0:
        want = np.asarray(tile_counts_pallas(
            pat, jnp.asarray(arr).reshape(-1, LANES), n,
            tile_rows=te // LANES, interpret=True, mode="native",
        ))
        assert got.tolist() == want.tolist()


def test_tile_counts_elems_rejects_bad_operands():
    pat = carry_over(compile_pattern("abcde"))
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    args = dict(tile_elems=64, length=5, valid_count=100)
    with pytest.raises(ValueError):  # packed words are kernel A's operand
        scan_cuda.tile_counts_elems(torch.zeros(64, dtype=torch.int32),
                                    checks, **args)
    with pytest.raises(ValueError):  # not T+1 whole tiles
        scan_cuda.tile_counts_elems(torch.zeros(100, dtype=torch.uint8),
                                    checks, **args)
    with pytest.raises(ValueError):  # a u8 pattern on u16 elements
        tdense.tile_counts(pat, torch.zeros(128, dtype=torch.uint16), 100,
                           tile_elems=64)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("k_cap", [1, 2, 8])
def test_gather_tiles_block_equal(k_cap, dtype, rng):
    rows_per_tile = 8
    te = rows_per_tile * 128
    data = rng.integers(0, np.iinfo(dtype).max + 1, (80, 128)).astype(dtype)
    hot = rng.integers(0, 80 // rows_per_tile - 1, k_cap).astype(np.int32)
    hot[k_cap // 2 :] = hot[0]  # duplicate ids, as idle slots repeat
    want = np.asarray(_gather_tiles_call(
        jnp.asarray(data), jnp.asarray(hot), k_cap=k_cap,
        rows_per_tile=rows_per_tile, interpret=True,
    )).reshape(k_cap, -1)
    elems = torch.from_numpy(data.reshape(-1))
    hot_t = torch.from_numpy(hot)
    plain = scan_cuda.gather_tiles_block_plain(elems, hot_t, tile_elems=te)
    wrapped = scan_cuda.gather_tiles_block(elems, hot_t, tile_elems=te)
    width = np.dtype(dtype).itemsize
    via_b = scan_cuda.gather_tiles_plain(elems, hot_t, width=width,
                                         tile_elems=te)
    assert plain.dtype == elems.dtype and plain.shape == (k_cap, 2 * te)
    assert np.array_equal(plain.numpy(), want)
    assert torch.equal(wrapped, plain)
    assert np.array_equal(via_b.numpy().view(dtype), want)


def test_gather_tiles_block_past_the_end_reads_zero():
    elems = torch.arange(1, 41, dtype=torch.uint8)  # 5 tiles of 8
    got = scan_cuda.gather_tiles_block(
        elems, torch.tensor([3, 4], dtype=torch.int32), tile_elems=8)
    assert got[0].tolist() == list(range(25, 41))
    assert got[1].tolist() == list(range(33, 41)) + [0] * 8


#: (tile bytes, element width, k_cap): the card tests' shapes of the
#: gather kernel (tiny, unaligned, u16, 8 KiB stage, stage + 16, the
#: bench's and the main path's tiles) at the k_caps whose plain gathers
#: stay small on the CPU
GATHER_CASES = [
    (tb, w, k) for tb, w, caps in (
        (8, 1, (1, 31, 128, 513)), (1000, 1, (1, 31, 128, 513)),
        (2000, 2, (1, 31, 128, 513)), (8192, 1, (1, 31, 128)),
        (8208, 1, (1, 31, 128)), (32 << 10, 1, (1, 31)),
        (256 << 10, 1, (1, 4)),
    ) for k in caps
]


@pytest.mark.parametrize("offset", [0, 2])
@pytest.mark.parametrize("tile_bytes,width,k_cap", GATHER_CASES)
def test_gather_plain_b_equals_e_across_shapes(tile_bytes, width, k_cap,
                                               offset):
    """B's and E's plain versions (and their wrappers on CPU tensors) give
    the same bytes as a numpy slice of the zero-padded source, at a source
    offset that is not 16-byte aligned too: duplicate ids and an id at the
    last tile, whose halo tile lies past the end.  Where the tile is whole
    rows of 128 int32 lanes, the slice is also held to the Pallas gathers
    in interpret mode (``_gather_tiles_dma_call`` on the padded source's
    words, ``_gather_tiles_call`` on its elements)."""
    rng = np.random.default_rng(tile_bytes + k_cap + offset)
    te = tile_bytes // width
    n_tiles = 5
    raw = rng.integers(0, 256, offset + (n_tiles + 1) * tile_bytes,
                       dtype=np.uint8)
    hot = rng.integers(0, n_tiles + 1, k_cap).astype(np.int32)
    hot[k_cap // 2 :] = hot[0]  # duplicate ids, as idle slots repeat
    hot[-1] = n_tiles
    padded = np.concatenate([raw[offset:], np.zeros(tile_bytes, np.uint8)])
    want = np.stack([padded[h * tile_bytes : (h + 2) * tile_bytes]
                     for h in hot])
    if tile_bytes % (LANES * 4) == 0:
        dma = np.asarray(_gather_tiles_dma_call(
            jnp.asarray(padded.view(np.int32).reshape(-1, LANES)),
            jnp.asarray(hot), k_cap=k_cap,
            rows_per_tile=tile_bytes // (LANES * 4), interpret=True))
        blk = np.asarray(_gather_tiles_call(
            jnp.asarray(padded.view(f"u{width}").reshape(-1, LANES)),
            jnp.asarray(hot), k_cap=k_cap, rows_per_tile=te // LANES,
            interpret=True))
        assert np.array_equal(dma.view(np.uint8).reshape(k_cap, -1), want)
        assert np.array_equal(blk.view(np.uint8).reshape(k_cap, -1), want)
    src = torch.from_numpy(raw)[offset:]
    elems = src if width == 1 else src.view(torch.uint16)
    hot_t = torch.from_numpy(hot)
    b = scan_cuda.gather_tiles_plain(elems, hot_t, width=width,
                                     tile_elems=te)
    e = scan_cuda.gather_tiles_block_plain(elems, hot_t, tile_elems=te)
    assert e.dtype == elems.dtype and e.shape == (k_cap, 2 * te)
    assert np.array_equal(b.numpy(), want)
    assert np.array_equal(e.view(torch.uint8).numpy(), want)
    assert torch.equal(scan_cuda.gather_tiles(elems, hot_t, width=width,
                                              tile_elems=te), b)
    assert torch.equal(scan_cuda.gather_tiles_block(elems, hot_t,
                                                    tile_elems=te), e)


def _jax_steps(pat, arr, n, **kw):
    """The JAX fused step on the element array: native Pallas kernels in
    interpret mode, and the XLA body."""
    return [
        jdense.fused_count_extract_start(
            pat, jnp.asarray(arr), n, use_pallas=use_pallas,
            interpret=use_pallas, tile_elems=TE, **kw,
        )
        for use_pallas in (True, False)
    ]


def _assert_step_equal(pat, arr, n, **kw):
    tp = tdense.fused_count_extract_start(
        carry_over(pat), torch.from_numpy(arr.copy()), n, tile_elems=TE, **kw
    )
    assert tp.combo_dev is not None  # the fused step, not a host branch
    for jp in _jax_steps(pat, arr, n, **kw):
        offs, info = _assert_same_step(jp, tp)
    return offs, info


@pytest.mark.parametrize("kw,wc,dtype", CASES)
def test_fused_step_elements_equal(kw, wc, dtype):
    pat = compile_pattern(kw, wc, dtype=dtype)
    L = pat.length
    n = 3 * TE - 77
    plants = [10, TE - 2, 2 * TE + 50, n - L]
    arr = _elements(pat, 3, n, plants, seed=2)
    arr[n + 8 : n + 8 + L] = arr[10 : 10 + L]  # past the valid limit
    offs, info = _assert_step_equal(pat, arr, n)
    assert set(plants) <= set(offs.tolist())
    assert not info.fallback


def test_fused_step_elements_grid_offset_and_false_positives():
    pat = compile_pattern("abcdefgh")  # 7 checks, 4 on the prefilter
    arr = _elements(pat, 3, 3 * TE, [500, TE + 9], seed=3)
    arr[100:106] = [10, 11, 12, 13, 14, 99]  # passes the prefilter only
    offs, info = _assert_step_equal(pat, arr, 3 * TE, grid_offset=1000)
    assert offs.tolist()[:2] == [1500, TE + 1009]
    assert info.prefilter_total > info.candidates


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_fused_step_elements_k_cap_overflow(dtype):
    pat = compile_pattern("abcde", dtype=dtype)
    plants = [t * TE + 13 for t in range(4)]
    arr = _elements(pat, 4, 0, plants, seed=0)
    offs, info = _assert_step_equal(pat, arr, 4 * TE, k_cap=2)
    assert info.fallback and info.hot_tiles == 4
    assert offs.tolist() == plants


def test_fused_step_elements_p_cap_overflow():
    pat = compile_pattern("abcde", dtype=np.uint16)
    n = 2 * TE
    arr = np.zeros(3 * TE, dtype=np.uint16)
    arr[:n] = np.arange(n) & 0xFFFF  # a ramp matches nearly every window
    offs, info = _assert_step_equal(pat, arr, n, p_cap=16)
    assert info.fallback and len(offs) > 16


@pytest.mark.parametrize("kw,wc,dtype", CASES)
def test_fused_body_equals_xla(kw, wc, dtype):
    """The plain twin of the element step against ``fused_body_xla``."""
    pat = compile_pattern(kw, wc, dtype=dtype)
    te, n = 256, 5 * 256 - 9
    mod = 1 << (8 * np.dtype(dtype).itemsize)
    arr = np.random.default_rng(4).integers(0, mod, 6 * te).astype(dtype)
    arr[n:] = 0
    kwv = ((np.array(pat.keyword, dtype=np.int64) + 7) % mod).astype(dtype)
    for pos in (3, te - 2, 3 * te + 1, n - pat.length):
        arr[pos : pos + pat.length] = kwv
    pairs, exp = prefilter_checks(pat)
    pairs_exact = tuple(
        (int(c), int(p)) for c, p in zip(pat.chk_shift_cur,
                                         pat.chk_shift_prev))
    _, _, j_exp, j_rec = pattern_device_args(pat)
    statics = dict(length=pat.length, tile_elems=te, k_cap=4, p_cap=8,
                   signed_compare=pat.signed_compare, pairs_exact=pairs_exact)
    j_counts, j_combo = tile_counts_gather_xla(
        jnp.asarray(arr), jnp.int32(n), jnp.asarray(exp),
        jnp.asarray([n // te, n % te], dtype=jnp.int32), j_exp, j_rec,
        pairs=pairs, span=te + pat.length - 1, **statics,
    )
    _, _, t_exp, t_rec = scan_torch.pattern_device_args(carry_over(pat),
                                                       "cpu")
    t_counts, t_combo = scan_torch.fused_body(
        torch.from_numpy(arr), n, [int(e) for e in exp], pairs, t_exp,
        t_rec, **statics,
    )
    assert t_counts.tolist() == np.asarray(j_counts).tolist()
    jf = combo_fields(np.asarray(j_combo), 4, 8)
    tf = combo_fields(t_combo.numpy(), 4, 8)
    assert tf[:3] == jf[:3]
    m = min(jf[0], 4)
    assert tf[3][:m].tolist() == jf[3][:m].tolist()
    for g, w in zip(tf[4:], jf[4:]):
        assert g.tolist() == w.tolist()
    step = scan_cuda.tile_counts_gather_elems(
        carry_over(pat), torch.from_numpy(arr), n, te, 4, 8)
    assert torch.equal(step[1], t_combo)


TAIL_TE = 64

#: kernel L's cases: (keyword, wildcard, dtype, tiles T, valid count,
#: plants, background, what the case must show); the buffer holds T + 1
#: tiles of TAIL_TE, its padding tile junk with a keyword copy inside
TAIL_CASES = {
    "u8-no-hot-tile": ("abcde", 0, np.uint8, 4, 4 * TAIL_TE, [], "zeros",
                       dict(n_hot=0)),
    "u8-wild-one-hot-partial": ("ab*de", "*", np.uint8, 4, 4 * TAIL_TE - 5,
                                [TAIL_TE + 7], "random", dict(n_hot=1)),
    "u16-n-hot-at-k-cap": ("abcde", 0, np.uint16, 6, 6 * TAIL_TE,
                           [3, 2 * TAIL_TE + 9, 3 * TAIL_TE + 30,
                            5 * TAIL_TE + 50], "random", dict(n_hot=4)),
    "u16-wild-n-hot-over-k-cap": ("ab*de", "*", np.uint16, 6, 6 * TAIL_TE,
                                  [t * TAIL_TE + 11 for t in range(5)],
                                  "random", dict(n_hot=5)),
    "u8-n-cand-over-p-cap": ("abcde", 0, np.uint8, 3, 3 * TAIL_TE - 1, [],
                             "ramp", dict(n_cand_over=True)),
    "u8-partial-last-tile": ("abcde", 0, np.uint8, 4, 3 * TAIL_TE + 17,
                             [1, 3 * TAIL_TE + 12, 3 * TAIL_TE + 19],
                             "random", dict(n_cand=2)),
    "u8-last-tile-halo-padding": ("abcde", 0, np.uint8, 3, 3 * TAIL_TE,
                                  [3 * TAIL_TE - 9, 3 * TAIL_TE - 2],
                                  "random", dict(n_cand=1)),
    "u16-wild-recovery-at-limit": ("??cde", "?", np.uint16, 3,
                                   2 * TAIL_TE + 9, [2 * TAIL_TE + 4],
                                   "random", dict(n_cand=1)),
    "u8-wild-recovery-clamped": ("?bcdE", "?", np.uint8, 3, 3 * TAIL_TE, [],
                                 "zeros", dict(n_hot=0)),
}


@pytest.mark.parametrize("case", list(TAIL_CASES))
def test_hot_combo_plain_equals_xla(case):
    """Kernel L's plain version (``scan_cuda.hot_combo_plain``, and the
    wrapper on CPU tensors) on the counts and elements of
    ``scan_jnp.tile_counts_gather_xla``, the JAX reference's fused step:
    every field ``combo_fields`` reads equal, and the hot tiles' counts,
    with k_cap 4 and p_cap 8 over tiles of 64 elements."""
    kw, wc, dtype, n_tiles, n, plants, background, shows = TAIL_CASES[case]
    pat = compile_pattern(kw, wc, dtype=dtype)
    te, k_cap, p_cap, L = TAIL_TE, 4, 8, pat.length
    mod = 1 << (8 * np.dtype(dtype).itemsize)
    rng = np.random.default_rng(len(case))
    arr = np.zeros((n_tiles + 1) * te, dtype=dtype)
    if background == "random":
        arr[:n] = rng.integers(0, mod, n)
    elif background == "ramp":  # every window of "abcde" matches
        arr[:n] = np.arange(n) % mod
    arr[n:] = rng.integers(0, mod, len(arr) - n)  # junk past the limit
    kwv = ((np.array(pat.keyword, dtype=np.int64) + 7) % mod).astype(dtype)
    arr[n_tiles * te + 3 : n_tiles * te + 3 + L] = kwv  # in the padding
    for pos in plants:
        arr[pos : pos + L] = kwv
    pairs, exp = prefilter_checks(pat)
    pairs_exact = tuple(
        (int(c), int(p)) for c, p in zip(pat.chk_shift_cur,
                                         pat.chk_shift_prev))
    _, _, j_exp, j_rec = pattern_device_args(pat)
    j_counts, j_combo = tile_counts_gather_xla(
        jnp.asarray(arr), jnp.int32(n), jnp.asarray(exp),
        jnp.asarray([n // te, n % te], dtype=jnp.int32), j_exp, j_rec,
        pairs=pairs, span=te + L - 1, length=L, tile_elems=te, k_cap=k_cap,
        p_cap=p_cap, signed_compare=pat.signed_compare,
        pairs_exact=pairs_exact,
    )
    j_combo = np.asarray(j_combo)
    tables = scan_torch.pattern_device_args(carry_over(pat), "cpu")
    elems = torch.from_numpy(arr)
    counts = torch.from_numpy(np.asarray(j_counts).astype(np.int32))
    args = dict(tile_elems=te, length=L, signed_compare=pat.signed_compare,
                k_cap=k_cap, p_cap=p_cap)
    got = scan_cuda.hot_combo_plain(elems, counts, n, *tables, **args)
    assert torch.equal(scan_cuda.hot_combo(elems, counts, n, *tables, **args),
                       got)
    jf = combo_fields(j_combo, k_cap, p_cap)
    tf = combo_fields(got.numpy(), k_cap, p_cap)
    assert tf[:3] == jf[:3]
    m = min(jf[0], k_cap)
    assert tf[3][:m].tolist() == jf[3][:m].tolist()
    counts_at = slice(3 + k_cap, 3 + k_cap + m)
    assert got.numpy()[counts_at].tolist() == j_combo[counts_at].tolist()
    for g, w in zip(tf[4:], jf[4:]):
        assert g.tolist() == w.tolist()
    n_hot, _, n_cand = jf[:3]
    assert n_hot == shows.get("n_hot", n_hot)
    assert n_cand == shows.get("n_cand", n_cand)
    assert (n_cand > p_cap) == shows.get("n_cand_over", False)
    assert len(got) == 3 + 2 * k_cap + 3 * p_cap


def _results(res):
    return [(o, dict(m)) for o, m in res]


@pytest.mark.parametrize("name,make", CORPORA, ids=[n for n, _ in CORPORA])
@pytest.mark.parametrize("semantics", list(MatchSemantics),
                         ids=lambda s: s.name)
def test_dense_search_corpora_equal(name, make, semantics):
    pat, data = make()
    want = jdense.dense_search(pat, data, semantics)
    got = tdense.dense_search(carry_over(pat), data, carry_over(semantics),
                              device="cpu")
    assert _results(got) == _results(want)
    j_offs, j_vals = jdense.dense_candidates(pat, data)
    t_offs, t_vals = tdense.dense_candidates(carry_over(pat), data,
                                             device="cpu")
    assert t_offs.tolist() == j_offs.tolist()
    assert t_vals.tolist() == j_vals.tolist()


@pytest.mark.parametrize("name", ["wildcard-16", "value-scan-8"])
def test_dense_search_equals_interpret(name):
    """A few corpora against the JAX native Pallas kernel (interpret)."""
    pat, data = dict(CORPORA)[name]()
    want = jdense.dense_search(pat, data, MatchSemantics.ALL,
                               interpret=True)
    got = tdense.dense_search(carry_over(pat), data,
                              carry_over(MatchSemantics.ALL), device="cpu")
    assert _results(got) == _results(want) and got


@pytest.mark.parametrize("width", [1, 2])
def test_dense_candidates_fuzz_equal(rng, width):
    """``tests/test_scan.py``'s planted fuzz, port against JAX."""
    dtype = np.uint8 if width == 1 else np.uint16
    mod = 256 if width == 1 else 65536
    letters = np.arange(97, 123)
    for _ in range(25):
        n = int(rng.integers(20, 3000))
        data = rng.integers(0, mod, n)
        kw_len = int(rng.integers(2, 8))
        kw = rng.choice(letters, kw_len).tolist()
        use_wc = rng.random() < 0.5
        if use_wc:
            for i in range(1, kw_len):  # keep position 0 literal
                if rng.random() < 0.25:
                    kw[i] = ord("*")
        for _ in range(int(rng.integers(0, 5))):
            pos = int(rng.integers(0, max(1, n - kw_len)))
            shift = int(rng.integers(-40, 40))
            data[pos : pos + kw_len] = (np.array(kw) + shift) % mod
        pat = compile_pattern(kw, ord("*") if use_wc else 0, dtype=dtype)
        arr = data.astype(dtype)
        j_offs, j_vals = jdense.dense_candidates(pat, arr)
        t_offs, t_vals = tdense.dense_candidates(carry_over(pat), arr,
                                                 device="cpu")
        assert t_offs.tolist() == j_offs.tolist(), f"kw={kw} n={n}"
        assert t_vals.tolist() == j_vals.tolist(), f"kw={kw} n={n}"
        assert (_results(tdense.dense_search(carry_over(pat), arr,
                                             device="cpu"))
                == _results(jdense.dense_search(pat, arr)))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_two_phase_candidates_small_tiles_equal(dtype):
    """Several count tiles, a tile-straddling match and a ragged end."""
    pat = compile_pattern("b*tter", "*", dtype=dtype)
    te = 64
    mod = 1 << (8 * np.dtype(dtype).itemsize)
    data = np.random.default_rng(5).integers(0, mod, 1000).astype(dtype)
    kw = ((np.array(pat.keyword, dtype=np.int64) + 9) % mod).astype(dtype)
    for pos in (0, te - 3, 500, 1000 - 6):
        data[pos : pos + 6] = kw
    j_offs, j_vals = jdense.two_phase_candidates(pat, data, tile_elems=te)
    t_offs, t_vals = tdense.two_phase_candidates(carry_over(pat), data,
                                                 tile_elems=te, device="cpu")
    assert t_offs.tolist() == j_offs.tolist()
    assert t_vals.tolist() == j_vals.tolist()
    assert {0, te - 3, 500, 994} <= set(t_offs.tolist())


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_upload_elements_read_only(tmp_path, dtype):
    """A read-only host array (a memmap) uploads quietly, padded with zeros,
    and the call leaves the process's warning filters as they were."""
    path = tmp_path / "arr.bin"
    want = np.random.default_rng(6).integers(0, 60000, 100).astype(dtype)
    want.tofile(path)
    arr = np.memmap(path, dtype=dtype, mode="r")
    filters = list(warnings.filters)
    with warnings.catch_warnings(record=True) as caught:
        got = tdense.upload_elements(arr, "cpu", 128)
    assert not caught and warnings.filters == filters
    assert got.dtype == (torch.uint8 if dtype == np.uint8 else torch.uint16)
    widened = scan_torch.widen(got).tolist()
    assert widened == want.tolist() + [0] * 28


def test_dense_search_edges():
    pat = carry_over(compile_pattern("catch"))
    assert tdense.dense_search(pat, np.zeros(3, dtype=np.uint8),
                               device="cpu") == []
    offs, vals = tdense.dense_candidates(pat, np.zeros(4, dtype=np.uint8),
                                         device="cpu")
    assert offs.shape == (0,) and vals.shape == (0, 2)
    with pytest.raises(ValueError, match=">= 2"):
        tdense.dense_search(carry_over(compile_pattern("a")),
                            np.zeros(9, np.uint8), device="cpu")
    with pytest.raises(RuntimeError):
        tdense.dense_search(pat, np.zeros(9, np.uint8), device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdense.dense_search(pat, np.zeros(9, np.uint8))
