"""The PyTorch port's copies of the JAX package's host-side numpy helpers
(``monkey_moore_tpu_torch/ops/host.py``) against the originals.

Count parity between the two packages depends on selecting exactly the
same prefilter checks, sizing the same capacities and decoding the same
result buffer, so every comparison is exact equality.
"""

import numpy as np
import pytest

from monkey_moore_tpu import dense as jdense
from monkey_moore_tpu.ops import scan_jnp, scan_pallas
from monkey_moore_tpu.pattern import compile_pattern
from monkey_moore_tpu_torch import carry_over
from monkey_moore_tpu_torch.ops import host
from common import HIRAGANA_SEQ
from test_scan import CORPORA

EXTRA = [
    ("long-8", lambda: compile_pattern("abcdefghijkl")),
    ("zero-diff-8", lambda: compile_pattern("aabcdefgh")),
    ("short-8", lambda: compile_pattern("abcd")),
    ("pair-8", lambda: compile_pattern("ab")),
    ("wildcard-16", lambda: compile_pattern("ab*de", "*", dtype=np.uint16)),
    ("lead-wildcard-8", lambda: compile_pattern("?bcde", "?")),
    ("all-wildcard-8", lambda: compile_pattern("a***", "*")),
    ("seq-16", lambda: compile_pattern(
        "わたしたちは", 0, HIRAGANA_SEQ, dtype=np.uint16)),
    ("value-scan-16", lambda: compile_pattern(
        reference_values=[105, 106, 107, 108, 109, 116], dtype=np.uint16)),
]
PATTERNS = [(n, lambda m=m: m()[0]) for n, m in CORPORA] + EXTRA


@pytest.mark.parametrize("name,make", PATTERNS, ids=[n for n, _ in PATTERNS])
@pytest.mark.parametrize("env", [None, "0", "2"])
def test_prefilter_selection_equal(name, make, env, monkeypatch):
    if env is None:
        monkeypatch.delenv("MMTPU_PREFILTER_CHECKS", raising=False)
    else:
        monkeypatch.setenv("MMTPU_PREFILTER_CHECKS", env)
    pat = make()
    tpat = carry_over(pat)
    assert host.prefilter_cap(tpat.dtype) == scan_jnp.prefilter_cap(pat.dtype)
    assert (host.prefilter_expected(tpat).tolist()
            == scan_jnp.prefilter_expected(pat).tolist())
    assert (host.prefilter_check_indices(tpat).tolist()
            == scan_jnp.prefilter_check_indices(pat).tolist())
    pairs, exp = host.prefilter_checks(tpat)
    ref_pairs, ref_exp = scan_jnp.prefilter_checks(pat)
    assert pairs == ref_pairs
    assert exp.dtype == ref_exp.dtype and exp.tolist() == ref_exp.tolist()
    assert host._prefilter_sel(tpat)[0] == jdense._prefilter_sel(pat)[0]
    assert host._prefilter_sel(tpat)[2] == jdense._prefilter_sel(pat)[2]
    for k_per_word in (1, 2, 4):
        assert (host.wordcmp_run(pairs, k_per_word)
                == scan_pallas.wordcmp_run(pairs, k_per_word))


def test_wordcmp_switch_equal(monkeypatch):
    pairs, _ = host.prefilter_checks(carry_over(compile_pattern("abcde")))
    monkeypatch.setenv("MMTPU_WORDCMP", "0")
    assert host.wordcmp_run(pairs, 4) is None
    assert scan_pallas.wordcmp_run(pairs, 4) is None


def test_constants_equal():
    assert host.LANES == scan_pallas.LANES
    assert host.DEFAULT_TILE_ROWS == scan_pallas.DEFAULT_TILE_ROWS
    assert host._ROW_ELEMS == scan_jnp._ROW_ELEMS
    assert host.TILE_ELEMS == jdense.TILE_ELEMS
    assert host.COMBO_HEADER == jdense.COMBO_HEADER
    assert host.FusedInfo._fields == jdense.FusedInfo._fields
    assert host.FusedInfo._field_defaults == jdense.FusedInfo._field_defaults


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_auto_k_cap_and_fallback_bytes_equal(dtype):
    for kw in ("abcde", "ab*de", "abcdefghijkl"):
        pat = compile_pattern(kw, "*" if "*" in kw else 0, dtype=dtype)
        for n_pairs in (0, 1, 2, 3, 4):
            for tile_elems in (8, 8192, 32768, 262144):
                for valid in (5, 10_000, 2**27, 2**29 + 3, 2**33):
                    assert host.auto_k_cap(
                        carry_over(pat), valid, tile_elems, n_pairs
                    ) == jdense.auto_k_cap(pat, valid, tile_elems, n_pairs)
                for n_hot in (0, 1, 3, 64, 1000):
                    assert host._gather_fallback_bytes(
                        carry_over(pat), n_hot, tile_elems
                    ) == jdense._gather_fallback_bytes(pat, n_hot, tile_elems)


@pytest.mark.parametrize("k_cap,p_cap", [(1, 1), (8, 16), (32, 1024)])
def test_combo_codec_equal(k_cap, p_cap):
    rng = np.random.default_rng(7)
    tile_elems = 4096
    for n_hot, n_cand in [(0, 0), (1, 1), (k_cap, p_cap), (k_cap + 1, 3),
                          (2, p_cap + 5)]:
        combo = rng.integers(0, k_cap * tile_elems,
                             host.COMBO_HEADER + 2 * k_cap + 3 * p_cap)
        combo = combo.astype(np.int32)
        combo[0], combo[1], combo[2] = n_hot, rng.integers(0, 2**31), n_cand
        hot_end = host.COMBO_HEADER + k_cap
        combo[host.COMBO_HEADER : hot_end] %= 50
        got = host.combo_fields(combo, k_cap, p_cap)
        want = jdense.combo_fields(combo, k_cap, p_cap)
        assert got[:3] == want[:3]
        for g, w in zip(got[3:], want[3:]):
            assert g.dtype == w.dtype and g.tolist() == w.tolist()
        assert (host._combo_info(combo, k_cap, p_cap)
                == tuple(jdense._combo_info(combo, k_cap, p_cap)))
        if n_cand <= p_cap:
            offs, vals = host._parse_combo(combo, k_cap, p_cap, tile_elems, 9)
            r_offs, r_vals = jdense._parse_combo(
                combo, k_cap, p_cap, tile_elems, 9
            )
            assert offs.tolist() == r_offs.tolist()
            assert vals.dtype == r_vals.dtype
            assert vals.tolist() == r_vals.tolist()


BATCHES = [
    ("plain-8", ["abcde", "zyxwv", "sword"], 0, np.uint8),
    ("mixed-8", ["abcde", "zyxwv", "?bcde", "abcdefghijkl"], "?", np.uint8),
    ("wild-8", ["dr*gon", "ab*de", "monkey", "a***"], "*", np.uint8),
    ("zero-diff-8", ["aabcdefgh", "abcd", "ab"], 0, np.uint8),
    ("mixed-16", ["abcde", "ab*de", "?bcd", "castle"], "*?", np.uint16),
]


def _batch(kws, wc, dtype):
    def wildcard(kw):
        return next((c for c in str(wc) if c in kw), 0)

    return [compile_pattern(k, wildcard(k), dtype=dtype) for k in kws]


@pytest.mark.parametrize("name,kws,wc,dtype", BATCHES,
                         ids=[b[0] for b in BATCHES])
@pytest.mark.parametrize("env", [None, "0"])
def test_multi_tables_equal(name, kws, wc, dtype, env, monkeypatch):
    """``canonical_check_tables`` and the numpy part of
    ``multi_pattern_tables``: the padded pair sets, the expected values
    (the reference splats them to words) and the active masks (the
    reference's -1/0 words)."""
    if env is None:
        monkeypatch.delenv("MMTPU_PREFILTER_CHECKS", raising=False)
    else:
        monkeypatch.setenv("MMTPU_PREFILTER_CHECKS", env)
    pats = _batch(kws, wc, dtype)
    got = host.canonical_check_tables(carry_over(pats))
    want = scan_jnp.canonical_check_tables(pats)
    assert got[0] == want[0]
    for g_list, w_list in zip(got[1:], want[1:]):
        for g, w in zip(g_list, w_list):
            assert g.dtype == w.dtype and g.tolist() == w.tolist()
    width = np.dtype(dtype).itemsize
    pairs, exp, act = host.multi_pattern_tables(*got)
    r_pairs, r_exp, r_act = jdense.multi_pattern_tables(*want, width)
    assert pairs == r_pairs
    assert exp.dtype == np.int64 and act.dtype == bool
    ones = 0x01010101 if width == 1 else 0x00010001
    splat = ((exp * ones) & 0xFFFFFFFF).astype(np.uint32)
    assert splat.view(np.int32).tolist() == np.asarray(r_exp).tolist()
    assert np.where(act, -1, 0).tolist() == np.asarray(r_act).tolist()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("grid_offset", [0, 1000])
def test_extract_hot_tiles_equal(dtype, grid_offset):
    rng = np.random.default_rng(9)
    te = 256
    for kw, wc in (("abcde", 0), ("ab*de", "*"), ("?bcd", "?")):
        pat = compile_pattern(kw, wc, dtype=dtype)
        data = rng.integers(0, 200, 10 * te - 3).astype(dtype)
        kv = (np.array(pat.keyword, dtype=np.int64) + 3).astype(dtype)
        for pos in (0, te - 2, 4 * te + 9, len(data) - pat.length):
            data[pos : pos + pat.length] = kv
        counts = rng.integers(0, 2, 10).astype(np.int32)
        counts[[0, 4, 9]] = 1
        got = host.extract_hot_tiles(carry_over(pat), data, counts, te,
                                     grid_offset)
        want = jdense.extract_hot_tiles(pat, data, counts, te, grid_offset)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tolist() == w.tolist()
        assert len(got[0]) >= 4


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_swar_host_view_equal(dtype):
    arr = np.random.default_rng(8).integers(0, 60000, 4096).astype(dtype)
    got = host.swar_host_view(arr)
    want = scan_pallas.swar_host_view(arr)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()
