"""The PyTorch port's scan operations (``ops/scan_cuda.py`` wrappers on CPU
tensors, which run the kernels' plain versions, and ``ops/scan_torch.py``)
against the JAX package: the Pallas kernels in interpret mode and the XLA
helpers of ``ops/scan_jnp.py``, on identical inputs made with numpy from a
fixed seed.

Tolerance: exact equality throughout — every value is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monkey_moore_tpu.ops import scan_jnp
from monkey_moore_tpu.ops.scan_pallas import (
    LANES,
    _gather_tiles_dma_call,
    dispatch_grouping,
    tile_counts_pallas,
)
from monkey_moore_tpu.pattern import compile_pattern
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch.ops import scan_cuda, scan_torch
from monkey_moore_tpu_torch.ops.host import prefilter_checks, wordcmp_run


def _planted(rng, pat, n_elems, plants):
    width = np.dtype(pat.dtype).itemsize
    mod = 1 << (8 * width)
    arr = rng.integers(0, mod, n_elems).astype(pat.dtype)
    kv = np.array(pat.keyword, dtype=np.int64)
    for i, pos in enumerate(plants):
        arr[pos : pos + pat.length] = ((kv + 7 * i) % mod).astype(pat.dtype)
    return arr


# word-compare (v3) eligible check sets, and v2 (wildcard bridge) sets
WORD_COMPARE = [("abcde", 1), ("aabcde", 1), ("abcd", 1), ("abcde", 2)]
SPLAT = [("ab*de", 1), ("ab*de", 2), ("b*tter", 1)]


@pytest.mark.parametrize(
    "kw,width", WORD_COMPARE + SPLAT,
    ids=[f"{k}-u{8 * w}" for k, w in WORD_COMPARE + SPLAT],
)
@pytest.mark.parametrize("n_tiles", [3, 8])
def test_counts_equal_pallas_swar_interpret(kw, width, n_tiles):
    """Kernel A's plain version vs ``tile_counts_pallas(mode="swar")`` in
    interpret mode; 8 tiles engage the grouped dispatch (several fine tiles
    per grid step), 3 do not; the valid limit is ragged."""
    dtype = np.uint8 if width == 1 else np.uint16
    pat = compile_pattern(kw, "*" if "*" in kw else 0, dtype=dtype)
    pairs, _ = prefilter_checks(carry_over(pat))
    assert (wordcmp_run(pairs, 4 // width) is not None) == (
        (kw, width) in WORD_COMPARE
    )
    tile_rows = 8
    tile_elems = tile_rows * LANES
    if n_tiles == 8:
        assert dispatch_grouping(n_tiles, tile_rows, width)[1] > 1
    rng = np.random.default_rng(n_tiles * 10 + width)
    n = n_tiles * tile_elems - 57
    arr = np.zeros((n_tiles + 1) * tile_elems, dtype=dtype)
    plants = [5, 33, 34, 35, tile_elems - 2, n - pat.length]
    arr[:n] = _planted(rng, pat, n, plants)
    want = tile_counts_pallas(
        pat, jnp.asarray(arr).reshape(-1, LANES), n, tile_rows=tile_rows,
        interpret=True, mode="swar",
    )
    got = scan_cuda.tile_counts(
        torch.from_numpy(arr.view("<i4").copy()),
        scan_cuda.prefilter_operand(carry_over(pat), "cpu"),
        width=width, tile_elems=tile_elems, length=pat.length, valid_count=n,
    )
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    assert int(got.sum()) > 0


@pytest.mark.parametrize("tile_elems", [8, 64])
def test_count_body_equals_xla_small_tiles(tile_elems):
    """Tiny tiles (forced-device tests run them): the plain counts vs the
    XLA prefilter body ``scan_jnp.tile_counts_xla``."""
    rng = np.random.default_rng(3)
    for kw in ("abcde", "ab*de"):
        pat = compile_pattern(kw, "*" if "*" in kw else 0)
        n_tiles = 40
        n = n_tiles * tile_elems - 3
        arr = np.zeros((n_tiles + 1) * tile_elems, dtype=np.uint8)
        arr[:n] = _planted(rng, pat, n, [0, 2 * tile_elems - 2, n - 5])
        pairs, exp = prefilter_checks(carry_over(pat))
        want = scan_jnp.tile_counts_xla(
            jnp.asarray(arr), jnp.int32(n), jnp.asarray(exp), pairs=pairs,
            length=pat.length, tile_elems=tile_elems,
        )
        got = scan_torch.count_body(
            scan_torch.widen(torch.from_numpy(arr)), n, exp.tolist(), pairs,
            pat.length, tile_elems, 1,
        )
        assert got.tolist() == np.asarray(want).tolist()


@pytest.mark.parametrize("k_cap", [1, 2, 8, 32])
@pytest.mark.parametrize("width", [1, 2])
def test_gather_equals_pallas_dma_interpret(k_cap, width):
    """Kernel B's plain version vs ``_gather_tiles_dma_call`` in interpret
    mode, duplicates included (idle slots repeat a tile)."""
    rng = np.random.default_rng(k_cap)
    rows_per_tile, lanes32 = 8, 128
    data = rng.integers(-(2**31), 2**31, (80, lanes32)).astype(np.int32)
    hot = rng.integers(0, 80 // rows_per_tile - 1, k_cap).astype(np.int32)
    hot[k_cap // 2 :] = hot[0]
    want = np.asarray(_gather_tiles_dma_call(
        jnp.asarray(data), jnp.asarray(hot), k_cap=k_cap,
        rows_per_tile=rows_per_tile, interpret=True,
    ))
    tile_elems = rows_per_tile * lanes32 * 4 // width
    got = scan_cuda.gather_tiles(
        torch.from_numpy(data.reshape(-1)), torch.from_numpy(hot),
        width=width, tile_elems=tile_elems,
    )
    assert got.dtype == torch.uint8
    assert got.shape == (k_cap, 2 * tile_elems * width)
    assert got.numpy().tolist() == want.view(np.uint8).reshape(
        k_cap, -1).tolist()


@pytest.mark.parametrize(
    "positions",
    [[], [0], [0, 1, 2, 127, 128, 129], [5000], [0, 5000, 19999],
     list(range(0, 2000, 7)), list(range(300, 428))],
)
@pytest.mark.parametrize("cap", [4, 512])  # two-level and plain
def test_nonzero_capped_equal(positions, cap):
    flat = np.zeros(20000, dtype=bool)
    flat[positions] = True
    want = np.asarray(scan_jnp.nonzero_capped(jnp.asarray(flat), cap))
    got = scan_torch.nonzero_capped(torch.from_numpy(flat), cap)
    k = min(len(positions), cap)
    assert got.dtype == torch.int32 and got.shape == (cap,)
    assert got[:k].tolist() == want[:k].tolist() == positions[:k]


def test_nonzero_capped_int_counts_equal():
    rng = np.random.default_rng(4)
    counts = np.zeros(3000, dtype=np.int32)
    hot = np.sort(rng.choice(3000, size=37, replace=False))
    counts[hot] = rng.integers(1, 100, size=37)
    want = np.asarray(scan_jnp.nonzero_capped(jnp.asarray(counts), 64, blk=16))
    got = scan_torch.nonzero_capped(torch.from_numpy(counts), 64)
    assert got[:37].tolist() == want[:37].tolist() == hot.tolist()


EXACT = [
    ("abcdefgh", 0, np.uint8),  # signed adjacent diffs
    ("abcde", 0, np.uint16),
    ("b*tter", "*", np.uint8),  # unsigned bridged diffs
    ("But**er", "*", np.uint16),
]


@pytest.mark.parametrize("kw,wc,dtype", EXACT, ids=[e[0] for e in EXACT])
@pytest.mark.parametrize("p_cap", [4, 1024])
def test_exact_phase2_equal(kw, wc, dtype, p_cap):
    """``exact_phase2`` on the same gathered slots, hot ids and valid
    limit: candidate count, and the first ``min(n_cand, p_cap)`` offsets
    and recovery values."""
    pat = compile_pattern(kw, wc, dtype=dtype)
    rng = np.random.default_rng(5)
    tile_elems, k_cap, n_tiles = 256, 6, 9
    L = pat.length
    n = n_tiles * tile_elems - 40
    corpus = np.zeros((n_tiles + 1) * tile_elems, dtype=dtype)
    plants = [3, tile_elems - 2, 3 * tile_elems + 100, n - L, n - L + 9]
    corpus[:n] = _planted(rng, pat, n, plants[:-1])
    corpus[n - L + 9 : n + 9] = corpus[n - L : n]  # past valid: dropped
    hot = np.array([0, 3, n_tiles - 1, 0, 0, 0], dtype=np.int32)
    nhot = 3
    slots = np.stack([corpus[h * tile_elems : h * tile_elems + tile_elems
                             + L - 1] for h in hot])
    pairs_exact = tuple(
        (int(c), int(p)) for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)
    )
    _, _, exp_j, rec_j = scan_jnp.pattern_device_args(pat)
    want = scan_jnp.exact_phase2(
        jnp.asarray(slots), jnp.asarray(hot), jnp.int32(nhot),
        jnp.int32(n // tile_elems), jnp.int32(n % tile_elems),
        tile_elems=tile_elems, length=L, pairs_exact=pairs_exact,
        expected=exp_j, signed_compare=pat.signed_compare, recovery=rec_j,
        p_cap=p_cap,
    )
    _, _, exp_t, rec_t = scan_torch.pattern_device_args(carry_over(pat),
                                                       "cpu")
    got = scan_torch.exact_phase2(
        torch.from_numpy(slots), torch.from_numpy(hot),
        torch.tensor(nhot, dtype=torch.int32), n // tile_elems,
        n % tile_elems, tile_elems=tile_elems, length=L,
        pairs_exact=pairs_exact, expected=exp_t,
        signed_compare=pat.signed_compare, recovery=rec_t, p_cap=p_cap,
    )
    n_cand = int(want[0])
    assert int(got[0]) == n_cand and n_cand >= 3
    m = min(n_cand, p_cap)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.int32 and g.shape == (p_cap,)
        assert g[:m].tolist() == np.asarray(w)[:m].tolist()


def test_pattern_device_args_equal():
    for kw, wc, dtype in EXACT + [("a*b*cD", "*", np.uint8)]:
        pat = compile_pattern(kw, wc, dtype=dtype)
        got = scan_torch.pattern_device_args(carry_over(pat), "cpu")
        want = scan_jnp.pattern_device_args(pat)
        for g, w in zip(got, want):
            assert g.tolist() == np.asarray(w).astype(np.int64).tolist()


def test_wrappers_reject_bad_operands():
    pat = carry_over(compile_pattern("abcde"))
    checks = scan_cuda.prefilter_operand(pat, "cpu")
    words = torch.zeros(3 * 64 // 4, dtype=torch.int32)  # 3 tiles of 64
    args = dict(width=1, tile_elems=64, length=5, valid_count=100)
    assert scan_cuda.tile_counts(words, checks, **args).shape == (2,)
    with pytest.raises(ValueError):  # not a whole number of tiles
        scan_cuda.tile_counts(words[:-1], checks, **args)
    with pytest.raises(ValueError):  # reads past the buffer
        scan_cuda.tile_counts(words, checks, **dict(args, valid_count=193))
    with pytest.raises(ValueError):
        scan_cuda.tile_counts(words.to(torch.int64), checks, **args)
    with pytest.raises(RuntimeError):  # no kernel and no plain version
        scan_cuda.tile_counts(words.to("meta"), checks.to("meta"), **args)
    hot = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        scan_cuda.gather_tiles(words, hot, width=1, tile_elems=64)


def test_gather_wrappers_launch_or_raise_off_the_cpu():
    """Both gathers launch their kernel or raise for a tensor that is not
    on the CPU: no plain version behind a device tensor."""
    hot = torch.zeros(2, dtype=torch.int32, device="meta")
    src = torch.zeros(3 * 64, dtype=torch.uint8, device="meta")
    with pytest.raises(RuntimeError):
        scan_cuda.gather_tiles(src, hot, width=1, tile_elems=64)
    with pytest.raises(RuntimeError):
        scan_cuda.gather_tiles_block(src, hot, tile_elems=64)


def test_reset_launch_counts_clears_the_aligned_counts():
    scan_cuda.launch_counts["gather_tiles"] += 3
    scan_cuda.aligned_launch_counts["gather_tiles_block"] += 2
    scan_cuda.reset_launch_counts()
    assert set(scan_cuda.aligned_launch_counts) == {"gather_tiles",
                                                    "gather_tiles_block"}
    assert not any(scan_cuda.launch_counts.values())
    assert not any(scan_cuda.aligned_launch_counts.values())
