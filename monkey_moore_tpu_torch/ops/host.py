"""Host-side numpy helpers of the device route, copied from the JAX package.

The reference keeps these in modules that load jax at import
(``ops/scan_jnp.py``, ``ops/scan_pallas.py``, ``dense.py``), so the port
carries its own copies under the same names.  They must stay equivalent to
the originals: count parity between the two packages depends on selecting
exactly the same prefilter checks, sizing the same capacities and decoding
the same result-buffer layout.  ``tests/test_torch_host.py`` holds each copy
equal to its original.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..pattern import CompiledPattern
from .recover import recovery_shifts
from .scan_np import match_positions_np

__all__ = [
    "LANES",
    "DEFAULT_TILE_ROWS",
    "TILE_ELEMS",
    "COMBO_HEADER",
    "FusedInfo",
    "prefilter_expected",
    "prefilter_cap",
    "prefilter_checks",
    "prefilter_check_indices",
    "canonical_check_tables",
    "wordcmp_run",
    "swar_host_view",
    "auto_k_cap",
    "combo_fields",
    "multi_pattern_tables",
    "extract_hot_tiles",
]

# ---- from ops/scan_pallas.py ------------------------------------------------

LANES = 1024  # elements per kernel row of the reference tiling
DEFAULT_TILE_ROWS = 256

# ---- from ops/scan_jnp.py ---------------------------------------------------

#: Row bound of the check-selection heuristic; equals ``LANES``.
_ROW_ELEMS = 1024


def prefilter_expected(pat) -> np.ndarray:
    """Expected diffs wrapped to the element dtype for the device prefilter
    (mod-2^width compare: may overcount, never undercounts)."""
    return np.asarray(
        pat.chk_expected.astype(np.int64).astype(pat.dtype)
    )


def prefilter_cap(dtype) -> int:
    """Default number of checks the device prefilter evaluates;
    ``MMTPU_PREFILTER_CHECKS`` overrides (0 = evaluate every check)."""
    env = os.environ.get("MMTPU_PREFILTER_CHECKS")
    if env is not None:
        v = int(env)
        return v if v > 0 else 1 << 30
    return 4 if np.dtype(dtype).itemsize == 1 else 2


def prefilter_checks(pat, cap: int | None = None):
    """Check subset the device prefilter evaluates: ``(pairs, expected)``."""
    keep = prefilter_check_indices(pat, cap)
    cur = pat.chk_shift_cur[keep]
    prev = pat.chk_shift_prev[keep]
    exp = prefilter_expected(pat)[keep]
    pairs = tuple((int(c), int(p)) for c, p in zip(cur, prev))
    return pairs, exp


def prefilter_check_indices(pat, cap: int | None = None) -> np.ndarray:
    """Indices (ascending) of the checks :func:`prefilter_checks` selects:
    nonzero expected diffs first, then sub-row shifts, then table order."""
    cur = pat.chk_shift_cur
    exp = prefilter_expected(pat)
    if cap is None:
        cap = prefilter_cap(pat.dtype)
    n = len(cur)
    if n <= cap:
        return np.arange(n)
    order = sorted(
        range(n),
        key=lambda i: (exp[i] == 0, int(cur[i]) >= _ROW_ELEMS, i),
    )
    return np.asarray(sorted(order[:cap]))


def canonical_check_tables(pats):
    """Selected prefilter checks for a batch of patterns, with simple-mode
    patterns padded to one canonical shape: ``(pair_sets, exp_list,
    active_list)`` — pair tuples, element-dtype expected arrays and bool
    active masks, one per pattern.

    Canonicalizable = the check table is dense from zero (check j uses
    pair (j+1, j)).  Adjacency alone is NOT enough: a leading-wildcard
    keyword like "?bcde" compiles to adjacent checks starting at (2, 1),
    and remapping those onto the canonical table would test windows
    shifted by the leading-wildcard count."""
    sel_idx = [prefilter_check_indices(pat) for pat in pats]
    full_exp = [prefilter_expected(pat) for pat in pats]
    full_simple = [
        len(pat.chk_shift_cur) > 0
        and all(
            int(c) == j + 1 and int(p) == j
            for j, (c, p) in enumerate(
                zip(pat.chk_shift_cur, pat.chk_shift_prev)
            )
        )
        for pat in pats
    ]
    # canonical width: smallest pow2 (>=4) covering every simple pattern's
    # highest selected check position
    c_max = max(
        (
            int(idx[-1]) + 1
            for idx, is_s in zip(sel_idx, full_simple)
            if is_s and len(idx)
        ),
        default=0,
    )
    if c_max:
        c_max = max(4, 1 << (c_max - 1).bit_length())
    raw_pairs, raw_exp, raw_active = [], [], []
    for pat, idx, fexp, is_s in zip(pats, sel_idx, full_exp, full_simple):
        if is_s:
            exp = np.zeros(c_max, dtype=fexp.dtype)
            act = np.zeros(c_max, dtype=bool)
            exp[idx] = fexp[idx]
            act[idx] = True
            raw_pairs.append(tuple((k + 1, k) for k in range(c_max)))
            raw_exp.append(exp)
            raw_active.append(act)
        else:
            raw_pairs.append(
                tuple(
                    (int(pat.chk_shift_cur[j]), int(pat.chk_shift_prev[j]))
                    for j in idx
                )
            )
            raw_exp.append(fexp[idx])
            raw_active.append(np.ones(len(idx), dtype=bool))
    return tuple(raw_pairs), raw_exp, raw_active


# ---- from ops/scan_pallas.py ------------------------------------------------


def wordcmp_run(pairs, k_per_word: int):
    """``(m, C)`` when the selected checks form ONE consecutive distance-1
    run (``ps = m, ..., m+C-1``) with ``C <=`` elements per word, else None.
    Classifies a check set as the TPU kernel's word-compare formulation (v3)
    or its splat formulation (v2); the CUDA counts kernel takes both."""
    if os.environ.get("MMTPU_WORDCMP", "").strip() == "0":
        return None
    if not pairs or len(pairs) > k_per_word:
        return None
    if any(c != p + 1 for c, p in pairs):
        return None
    ps = [p for _, p in pairs]
    if any(b != a + 1 for a, b in zip(ps, ps[1:])):
        return None
    return ps[0], len(ps)


def swar_host_view(arr: np.ndarray) -> np.ndarray:
    """Free reinterpretation of a host element buffer as packed
    little-endian int32 words (the counts kernel's operand layout)."""
    assert arr.dtype.itemsize in (1, 2)
    assert arr.nbytes % 4 == 0
    return arr.reshape(-1).view("<i4")


# ---- from dense.py ----------------------------------------------------------

TILE_ELEMS = DEFAULT_TILE_ROWS * LANES  # 262144 elements per counted tile

_EMPTY = (
    np.zeros(0, dtype=np.int64),
    np.zeros((0, 2), dtype=np.int64),
)


def _prefilter_sel(pat):
    """Selected prefilter checks + the max window shift among them."""
    pairs, exp = prefilter_checks(pat)
    return pairs, exp, max((c for c, _ in pairs), default=0)


def auto_k_cap(
    pat: CompiledPattern, valid_count: int, tile_elems: int, n_pairs: int
) -> int:
    """Hot-tile gather capacity for the fused step: twice the expected
    prefilter false positives on random data plus slack, bounded by a
    64 MiB budget of gathered ``2 * tile_elems``-element slots."""
    bits = 8 * np.dtype(pat.dtype).itemsize
    exp_fp = valid_count * (2.0 ** (-bits * max(1, n_pairs)))
    k_cap = int(min(2048, 1 << int(2 * exp_fp + 16).bit_length()))
    slot_bytes = 2 * tile_elems * np.dtype(pat.dtype).itemsize
    budget_slots = max(8, (64 * 1024 * 1024) // slot_bytes)
    if k_cap > budget_slots:
        k_cap = 1 << (budget_slots.bit_length() - 1)
    return k_cap


def _gather_fallback_bytes(pat: CompiledPattern, n_hot: int,
                           tile_elems: int) -> int:
    """Approximate D2H bytes of ``extract_hot_tiles_device``'s batched
    fetch: ``n_hot`` padded to a power of two, one tile+halo span each."""
    if n_hot <= 0:
        return 0
    n_pad = 1 << (n_hot - 1).bit_length()
    span = tile_elems + pat.length - 1
    return n_pad * span * np.dtype(pat.dtype).itemsize


class FusedInfo(NamedTuple):
    """Stats sidecar of ``fused_count_extract`` (device-computed)."""

    hot_tiles: int  #: tiles with a nonzero prefilter count
    prefilter_total: int  #: sum of prefilter counts (int32 stats field)
    candidates: int = 0  #: exact candidates extracted this step
    fallback: bool = False  #: capacity overflow → counts fetch + gather
    d2h_bytes: int = 0  #: bytes this step shipped device→host
    #: per-shard exact candidate counts (mesh paths only)
    per_device: tuple = None


#: fused result-buffer layout (``dense.py:459-465`` of the JAX package):
#: ``[n_hot, prefilter_total, n_cand, hot_ids[k_cap], hot_counts[k_cap],
#:   flat_idx[p_cap], v0[p_cap], v1[p_cap]]``
COMBO_HEADER = 3


def combo_fields(combo: np.ndarray, k_cap: int, p_cap: int):
    """Decode one packed result buffer into its raw fields:
    ``(n_hot, prefilter_total, n_cand, hot_ids, flat_idx, v0, v1)``
    (candidate arrays trimmed to ``n_cand``)."""
    n_hot, total, n_cand = int(combo[0]), int(combo[1]), int(combo[2])
    hot = combo[COMBO_HEADER : COMBO_HEADER + k_cap].astype(np.int64)
    base = COMBO_HEADER + 2 * k_cap
    m = min(n_cand, p_cap)
    flat_idx = combo[base : base + p_cap][:m].astype(np.int64)
    v0 = combo[base + p_cap : base + 2 * p_cap][:m]
    v1 = combo[base + 2 * p_cap : base + 3 * p_cap][:m]
    return n_hot, total, n_cand, hot, flat_idx, v0, v1


def _combo_info(combo: np.ndarray, k_cap: int, p_cap: int) -> FusedInfo:
    n_hot, total, n_cand = int(combo[0]), int(combo[1]), int(combo[2])
    return FusedInfo(
        n_hot, total, candidates=n_cand, d2h_bytes=combo.nbytes,
        fallback=n_hot > k_cap or n_cand > p_cap,
    )


def _parse_combo(combo, k_cap, p_cap, tile_elems, grid_offset):
    """Decode one fused result buffer → (offsets, values)."""
    _, _, n_cand, hot, flat_idx, v0, v1 = combo_fields(combo, k_cap, p_cap)
    if n_cand == 0:
        return _EMPTY
    slot, rel = flat_idx // tile_elems, flat_idx % tile_elems
    offsets = hot[slot] * tile_elems + rel + grid_offset
    values = np.stack([v0, v1], axis=1).astype(np.int64)
    return offsets, values


def multi_pattern_tables(pair_sets, exp_list, active_list):
    """Rectangular multi-pattern operands from the canonical check tables:
    ``(pair_sets_padded, expected (K, C) int64, active (K, C) bool)``,
    padded with inactive ``(1, 0)`` checks.  The numpy part of the
    reference function: its splat of each expected value to a
    ``0x01010101`` word and its -1/0 word masks are TPU layout only."""
    K = len(pair_sets)
    c_pad = max(len(e) for e in exp_list)
    exp_mat = np.zeros((K, c_pad), dtype=np.int64)
    act_mat = np.zeros((K, c_pad), dtype=bool)
    pair_sets_padded = []
    for k, (prs, e, a) in enumerate(zip(pair_sets, exp_list, active_list)):
        exp_mat[k, : len(e)] = e
        act_mat[k, : len(a)] = a
        pair_sets_padded.append(
            tuple(prs) + tuple((1, 0) for _ in range(c_pad - len(prs)))
        )
    return pair_sets_padded, exp_mat, act_mat


def extract_hot_tiles(
    pat: CompiledPattern,
    data: np.ndarray,
    counts: np.ndarray,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
):
    """Phase 2 on the host: exact offsets + recovery values from the tiles
    with count > 0 of the host element buffer ``data``."""
    n = len(data)
    L = pat.length
    shifts = recovery_shifts(pat)
    hot = np.nonzero(counts)[0]
    all_offsets = []
    for t in hot.tolist():
        s0 = t * tile_elems
        sl = data[s0 : min(n, s0 + tile_elems + L - 1)]
        pos = match_positions_np(pat, sl)
        pos = pos[pos < tile_elems] + s0
        all_offsets.append(pos)
    if not all_offsets:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)
    offsets = np.concatenate(all_offsets)
    values = np.stack(
        [
            data[np.minimum(offsets + shifts[0], n - 1)].astype(np.int64),
            data[
                np.minimum(
                    offsets + (shifts[1] if len(shifts) > 1 else shifts[0]),
                    n - 1,
                )
            ].astype(np.int64),
        ],
        axis=1,
    )
    return offsets + grid_offset, values
