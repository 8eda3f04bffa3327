"""The PyTorch port's fused step (``monkey_moore_tpu_torch.dense``) against
the JAX package's ``dense.fused_count_extract`` with the Pallas kernels in
interpret mode, on the same packed words (``swar_host_view``) made with
numpy from a fixed seed: offsets, recovery values, ``FusedInfo`` and the
decoded result-buffer fields (hot ids and counts trimmed to ``n_hot``,
candidates trimmed to ``n_cand``).  Also the all-wildcard branch and the
capacity-overflow fallback.

Tolerance: exact equality throughout — every value is an integer.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monkey_moore_tpu import dense as jdense
from monkey_moore_tpu.ops.scan_pallas import swar_host_view
from monkey_moore_tpu.pattern import compile_pattern
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch import dense as tdense
from monkey_moore_tpu_torch.ops.host import COMBO_HEADER, combo_fields

TE = 32 * 1024  # smallest count tile the interpret-mode Pallas path takes


def _corpus(pat, n_tiles, plants, seed=0, n=None):
    """T counted tiles + one halo tile of seeded random elements with the
    keyword planted (+3); elements past ``n`` stay 0 except plants."""
    width = np.dtype(pat.dtype).itemsize
    mod = 1 << (8 * width)
    n = n_tiles * TE + 77 if n is None else n
    arr = np.zeros((n_tiles + 2) * TE, dtype=pat.dtype)
    arr[:n] = np.random.default_rng(seed).integers(0, mod, n)
    kw = ((np.array(pat.keyword, dtype=np.int64) + 3) % mod).astype(pat.dtype)
    for pos in plants:
        arr[pos : pos + len(kw)] = kw
    return arr, n


def _both(pat, arr, n, **kw):
    """(JAX pending, port pending) of one fused step on the same words."""
    words = swar_host_view(arr)
    jp = jdense.fused_count_extract_start(
        pat, jnp.asarray(words), n, use_pallas=True, interpret=True,
        tile_elems=TE, **kw,
    )
    tp = tdense.fused_count_extract_start(
        carry_over(pat), torch.from_numpy(words.copy()), n, tile_elems=TE,
        **kw,
    )
    return jp, tp


def _assert_same_step(jp, tp):
    assert (tp.k_cap, tp.p_cap) == (jp.k_cap, jp.p_cap)
    j_combo = np.asarray(jp.combo_dev)
    t_combo = tp.combo_dev.numpy()
    assert t_combo.dtype == j_combo.dtype and t_combo.shape == j_combo.shape
    jf = combo_fields(j_combo, jp.k_cap, jp.p_cap)
    tf = combo_fields(t_combo, tp.k_cap, tp.p_cap)
    assert tf[:3] == jf[:3]  # n_hot, prefilter total, n_cand
    m = min(jf[0], jp.k_cap)
    assert tf[3][:m].tolist() == jf[3][:m].tolist()  # hot ids
    counts_at = slice(COMBO_HEADER + jp.k_cap, COMBO_HEADER + 2 * jp.k_cap)
    assert (t_combo[counts_at][:m].tolist()
            == j_combo[counts_at][:m].tolist())  # hot counts
    for g, w in zip(tf[4:], jf[4:]):  # flat_idx, v0, v1 (trimmed)
        assert g.tolist() == w.tolist()
    assert tp.counts_dev.tolist() == np.asarray(jp.counts_dev).tolist()
    j_offs, j_vals, j_info = jdense.fused_count_extract_finish(jp)
    t_offs, t_vals, t_info = tdense.fused_count_extract_finish(tp)
    assert t_offs.tolist() == j_offs.tolist()
    assert t_vals.tolist() == j_vals.tolist()
    assert tuple(t_info) == tuple(j_info)
    return t_offs, t_info


@pytest.mark.parametrize(
    "kw,wc,dtype",
    [("abcde", 0, np.uint8), ("ab*de", "*", np.uint8),
     ("abcde", 0, np.uint16), ("But**er", "*", np.uint16)],
)
def test_fused_step_equal(kw, wc, dtype):
    pat = compile_pattern(kw, wc, dtype=dtype)
    L = pat.length
    plants = [10, TE - 2, 2 * TE + 50]
    arr, n = _corpus(pat, 2, plants + [2 * TE + 77 - L], seed=1)
    arr[n + 8 : n + 8 + L] = arr[10 : 10 + L]  # past the valid limit
    jp, tp = _both(pat, arr, n)
    offs, info = _assert_same_step(jp, tp)
    assert set(plants + [n - L]) <= set(offs.tolist())
    assert not info.fallback


def test_grid_offset_and_prefilter_false_positives():
    pat = compile_pattern("abcdefgh")  # 7 checks, 4 on the prefilter
    arr, n = _corpus(pat, 3, [500, TE + 9], seed=2)
    arr[100:106] = [10, 11, 12, 13, 14, 99]  # passes the prefilter only
    jp, tp = _both(pat, arr, n, grid_offset=1000)
    offs, info = _assert_same_step(jp, tp)
    assert offs.tolist()[:2] == [1500, TE + 1009]
    assert info.prefilter_total > info.candidates


def test_no_hot_tiles():
    pat = compile_pattern("abcde")
    arr = np.zeros(4 * TE, dtype=np.uint8)
    jp, tp = _both(pat, arr, 2 * TE)
    offs, info = _assert_same_step(jp, tp)
    assert info.hot_tiles == 0 and len(offs) == 0


def test_overflow_k_cap_fallback():
    """More hot tiles than k_cap: counts fetch + batched host extraction."""
    pat = compile_pattern("abcde")
    plants = [t * TE + 13 for t in range(6)]
    arr = np.zeros(8 * TE, dtype=np.uint8)
    kw = (np.array(pat.keyword) + 3).astype(np.uint8)
    for p in plants:
        arr[p : p + 5] = kw
    jp, tp = _both(pat, arr, 6 * TE, k_cap=2)
    offs, info = _assert_same_step(jp, tp)
    assert info.fallback and info.hot_tiles == 6
    assert offs.tolist() == plants


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_overflow_p_cap_fallback(dtype):
    """A byte ramp matches at nearly every window: n_cand > p_cap."""
    pat = compile_pattern("abcde", dtype=dtype)
    n = 3 * TE
    arr = np.zeros(5 * TE, dtype=dtype)
    arr[:n] = (np.arange(n) & (0xFF if dtype == np.uint8 else 0xFFFF))
    jp, tp = _both(pat, arr, n, p_cap=16)
    offs, info = _assert_same_step(jp, tp)
    assert info.fallback and len(offs) > 16


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_all_wildcard_branch_equal(dtype):
    """No prefilter checks: counts on the host, every tile extracted."""
    pat = compile_pattern("a***", "*", dtype=dtype)
    te = 64
    arr = np.random.default_rng(3).integers(0, 200, 6 * te).astype(dtype)
    n = 5 * te - 9
    j_offs, j_vals, j_info = jdense.fused_count_extract(
        pat, jnp.asarray(arr), n, use_pallas=False, tile_elems=te
    )
    t_offs, t_vals, t_info = tdense.fused_count_extract(
        carry_over(pat), torch.from_numpy(arr), n, tile_elems=te
    )
    assert t_offs.tolist() == j_offs.tolist() == list(range(n - 3))
    assert t_vals.tolist() == j_vals.tolist()
    assert tuple(t_info) == tuple(j_info) and t_info.fallback


@pytest.mark.parametrize(
    "kw,wc", [("abcde", 0), ("ab*de", "*"), ("a***", "*")]
)
def test_tile_counts_equal(kw, wc):
    pat = compile_pattern(kw, wc)
    arr, n = _corpus(pat, 3, [7, TE - 1, 3 * TE], seed=4)
    want = jdense.tile_counts(pat, jnp.asarray(arr), n, use_pallas=False,
                              tile_elems=TE)
    words = torch.from_numpy(swar_host_view(arr).copy())
    got = tdense.tile_counts(carry_over(pat), words, n, tile_elems=TE)
    assert got.tolist() == want.tolist()
