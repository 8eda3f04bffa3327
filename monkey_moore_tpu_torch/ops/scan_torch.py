"""Plain tensor code of the fused device step — counterpart of the JAX
package's ``ops/scan_jnp.py``.

The JAX package computes these pieces with XLA, outside any Pallas kernel;
the port keeps them as plain PyTorch, on the card where no kernel takes
their place (``scan_cuda.all_windows_counts``, ``perf_probe``'s ``ab``
tails).  They enqueue work and never synchronise with the host (no
``torch.nonzero``, boolean-mask indexing, ``.item()`` or host uploads), so
``dense.fused_count_extract_start`` returns as soon as the step is queued.
The exact match-and-compact scan (:func:`match_bitmap`,
:func:`compact_matches`, :func:`scan_chunk`) is the plain version of kernel
K (``ops/scan_cuda.scan_chunk``), and the step's tail (:func:`hot_tail`:
:func:`nonzero_capped`, then :func:`slots_combo`) that of kernel L
(``ops/scan_cuda.hot_combo``), which run them on the card; like the other
kernels' plain versions, they read check tables back to the host.

Element values travel as int32 tensors holding the unsigned element value:
torch has no uint16 arithmetic on the CPU, and ``>>`` on int32 is
arithmetic, so narrow buffers are widened with a mask before any math.
"""

from __future__ import annotations

import threading
from typing import Sequence, Tuple

import numpy as np
import torch

from ..carry import require_own
from ..pattern import CompiledPattern
from .recover import recovery_shifts

__all__ = [
    "operand_cache",
    "pattern_device_args",
    "as_elements",
    "widen",
    "count_body",
    "tile_counts_multi",
    "nonzero_capped",
    "match_bitmap",
    "compact_matches",
    "scan_chunk",
    "exact_phase2",
    "fused_body",
    "hot_tail",
    "slots_combo",
    "pack_combo",
]

_operand_cache_lock = threading.Lock()


def operand_cache(pat: CompiledPattern) -> dict:
    """Per-pattern memo of small device operands.  Building one uploads it
    (a host sync), so each search step reuses the copy made by the first.
    *pat* must be the port's ``CompiledPattern`` (``TypeError`` otherwise):
    every device operand of a pattern is built here."""
    require_own(pat, CompiledPattern, "pattern")
    with _operand_cache_lock:
        cache = getattr(pat, "_torch_operands", None)
        if cache is None:
            cache = {}
            object.__setattr__(pat, "_torch_operands", cache)
        return cache


def pattern_device_args(
    pat: CompiledPattern, device
) -> Tuple[torch.Tensor, ...]:
    """``(shift_cur, shift_prev, expected, recovery)`` int32 tensors on
    *device*: the exact check tables and the two recovery shifts (the
    second may repeat the first), as ``scan_jnp.pattern_device_args``."""
    cache = operand_cache(pat)
    key = ("args", str(torch.device(device)))
    if key not in cache:
        shifts = recovery_shifts(pat)
        s1 = shifts[1] if len(shifts) > 1 else shifts[0]
        host = [
            np.asarray(pat.chk_shift_cur, dtype=np.int64),
            np.asarray(pat.chk_shift_prev, dtype=np.int64),
            np.asarray(pat.chk_expected).astype(np.int64),
            np.asarray([shifts[0], s1], dtype=np.int64),
        ]
        cache[key] = tuple(
            torch.tensor(a, dtype=torch.int32, device=device) for a in host
        )
    return cache[key]


def as_elements(words: torch.Tensor, width: int) -> torch.Tensor:
    """Zero-copy view of a packed little-endian word buffer as its u8 or
    u16 elements (memory order is little-endian on the host and the card)."""
    return words.view(torch.uint8 if width == 1 else torch.uint16)


def widen(elems: torch.Tensor) -> torch.Tensor:
    """u8/u16 elements → int32 tensor of the unsigned values."""
    if elems.dtype == torch.uint16:
        return elems.view(torch.int16).to(torch.int32) & 0xFFFF
    return elems.to(torch.int32)


def count_body(
    x: torch.Tensor,
    valid_count: int,
    expected: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    length: int,
    tile_elems: int,
    width: int,
    active: Sequence[bool] | None = None,
) -> torch.Tensor:
    """Per-tile prefilter counts, int32[T] (``scan_jnp._count_body``).

    ``x``: int32 element values, ``(T+1) * tile_elems`` of them (T counted
    tiles plus one halo tile).  A window start ``e`` counts when
    ``e <= valid_count - length`` and, for every check, ``(x[e+c] - x[e+p])
    mod 2^(8*width) == expected``.  ``active`` (one bool per check) skips
    the padding checks of a canonical multi-pattern table."""
    counted = x.shape[0] - tile_elems
    mask = (1 << (8 * width)) - 1
    if active is None:
        active = [True] * len(pairs)
    ok = torch.ones(counted, dtype=torch.bool, device=x.device)
    for (c, p), e, live in zip(pairs, expected, active):
        if live:
            ok &= ((x[c : c + counted] - x[p : p + counted]) & mask) == int(e)
    idx = torch.arange(counted, dtype=torch.int64, device=x.device)
    ok &= idx <= valid_count - length
    return ok.view(-1, tile_elems).sum(dim=1, dtype=torch.int32)


def tile_counts_multi(
    elems: torch.Tensor,
    valid_count: int,
    expected_list: Sequence[Sequence[int]],
    active_list: Sequence[Sequence[bool]],
    lengths: Sequence[int],
    *,
    pair_sets: Sequence[Sequence[Tuple[int, int]]],
    tile_elems: int,
) -> Tuple[torch.Tensor, ...]:
    """Per-tile prefilter counts for MANY patterns
    (``scan_jnp.tile_counts_multi_xla``): one int32[T] per pattern.

    ``elems``: u8/u16 elements, ``(T+1) * tile_elems`` of them; the
    per-pattern tables are :func:`host.canonical_check_tables`'."""
    width = elems.element_size()
    x = widen(elems)
    return tuple(
        count_body(x, valid_count, exp, pairs, length, tile_elems, width, act)
        for pairs, exp, act, length in zip(
            pair_sets, expected_list, active_list, lengths
        )
    )


def nonzero_capped(flat: torch.Tensor, cap: int) -> torch.Tensor:
    """First ``cap`` indices where ``flat != 0``, ascending, as int32
    (``scan_jnp.nonzero_capped``) — with no host sync: a cumulative count
    and a binary search for each rank 1..cap.  Entries past the true count
    are 0 (unspecified in the reference)."""
    n = flat.shape[0]
    if n >= 2**31:
        raise ValueError(f"nonzero_capped: {n} elements exceed int32 indices")
    csum = torch.cumsum(flat != 0, 0, dtype=torch.int32)
    ranks = torch.arange(1, cap + 1, dtype=torch.int32, device=flat.device)
    idx = torch.searchsorted(csum, ranks, out_int32=True)
    return torch.where(idx < n, idx, 0)


def match_bitmap(
    data: torch.Tensor,
    valid_count: int,
    length: int,
    shift_cur: torch.Tensor,
    shift_prev: torch.Tensor,
    expected: torch.Tensor,
    signed_compare: bool,
) -> torch.Tensor:
    """Exact match flag for every window start in ``[0, N - L]``, bool[N-L+1]
    (``scan_jnp.match_bitmap``; reads the check tables back to the host).

    ``data``: u8/u16 elements; ``shift_cur``, ``shift_prev``, ``expected``:
    :func:`pattern_device_args`' tables.  The signed branch (patterns
    without wildcards) ignores the shift tables: check ``c`` compares the
    adjacent difference ``x[p+c+1] - x[p+c]`` of the widened values with
    ``expected[c]`` exactly.  The unsigned branch (wildcards) compares
    ``x[p+cur] - x[p+prev]`` with ``expected`` mod 2^(8*width).  Both clamp
    a slice start as ``dynamic_slice`` does.  Windows past ``valid_count -
    length`` are off."""
    n = data.shape[0]
    positions = n - length + 1
    if positions <= 0:
        return torch.zeros(0, dtype=torch.bool, device=data.device)
    x = widen(data)
    exp = expected.tolist()
    ok = torch.ones(positions, dtype=torch.bool, device=data.device)
    if signed_compare:
        d1 = x[1:] - x[:-1]
        for c, e in enumerate(exp):
            s = min(c, n - 1 - positions)
            ok &= d1[s : s + positions] == e
    else:
        mask = (1 << (8 * data.element_size())) - 1
        top = n - positions
        for cur, prev, e in zip(shift_cur.tolist(), shift_prev.tolist(), exp):
            cur, prev = min(max(cur, 0), top), min(max(prev, 0), top)
            diff = x[cur : cur + positions] - x[prev : prev + positions]
            ok &= (diff & mask) == (e & mask)
    idx = torch.arange(positions, dtype=torch.int64, device=data.device)
    return ok & (idx <= valid_count - length)


def compact_matches(
    bitmap: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(count, offsets[capacity])`` int32 (``scan_jnp.compact_matches``):
    ``count`` is the true number of set flags, which may exceed
    ``capacity``; ``offsets`` the first ``capacity`` set positions in
    ascending order, -1 at every slot at or past ``count``."""
    count = bitmap.sum(dtype=torch.int32)
    idx = nonzero_capped(bitmap, capacity)
    pos = torch.arange(capacity, dtype=torch.int32, device=bitmap.device)
    return count, torch.where(pos < count, idx, -1)


def scan_chunk(
    data: torch.Tensor,
    valid_count: int,
    shift_cur: torch.Tensor,
    shift_prev: torch.Tensor,
    expected: torch.Tensor,
    recovery: torch.Tensor,
    *,
    length: int,
    signed_compare: bool,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense scan of an element array (``scan_jnp.scan_chunk``):
    ``(count, offsets[capacity], values[capacity, 2])``, the match count and
    offsets of :func:`compact_matches` over :func:`match_bitmap`, and for
    every slot the elements at ``clip(max(offset, 0) + recovery, 0, N -
    1)`` in the data's dtype (filler slots hold those of offset 0)."""
    bitmap = match_bitmap(data, valid_count, length, shift_cur, shift_prev,
                          expected, signed_compare)
    count, offsets = compact_matches(bitmap, capacity)
    safe = torch.clamp(offsets, min=0).to(torch.int64)
    idx = torch.clamp(safe[:, None] + recovery.to(torch.int64)[None, :], 0,
                      data.shape[0] - 1)
    if data.dtype == torch.uint16:
        return count, offsets, data.view(torch.int16)[idx].view(torch.uint16)
    return count, offsets, data[idx]


def exact_phase2(
    slots: torch.Tensor,
    hot: torch.Tensor,
    nhot: torch.Tensor,
    vt2: int,
    vr2: int,
    *,
    tile_elems: int,
    length: int,
    pairs_exact: Sequence[Tuple[int, int]],
    expected: torch.Tensor,
    signed_compare: bool,
    recovery: torch.Tensor,
    p_cap: int,
):
    """EXACT phase 2 over gathered hot-tile slots (``scan_jnp.exact_phase2``).

    ``slots``: ``(K, span)`` u8/u16 elements, slot i covering tile
    ``hot[i]``'s ``tile_elems + length - 1`` elements; the valid element
    count is ``vt2 * tile_elems + vr2``.  Every check of the pattern runs,
    signed where the mode requires, so prefilter false positives die here.
    Returns int32 ``(n_cand, flat_idx[p_cap], v0[p_cap], v1[p_cap])`` with
    ``flat_idx = slot * tile_elems + rel`` ascending.  Slots at or past
    ``nhot`` get a valid count of 0."""
    K, span = slots.shape
    positions = span - length + 1  # == tile_elems by construction
    dev = slots.device
    vals = widen(slots)
    mask = (1 << (8 * slots.element_size())) - 1
    dt = torch.clamp(vt2 - hot.to(torch.int64), -1, 2)
    valid_slot = torch.clamp(dt * tile_elems + vr2, 0, span)
    slot_ids = torch.arange(K, dtype=torch.int64, device=dev)
    valid_slot = torch.where(slot_ids < nhot, valid_slot, 0)
    ok = torch.ones((K, positions), dtype=torch.bool, device=dev)
    for i, (c, p) in enumerate(pairs_exact):
        diff = vals[:, c : c + positions] - vals[:, p : p + positions]
        if not signed_compare:
            diff = diff & mask
        ok &= diff == expected[i]
    pos_idx = torch.arange(positions, dtype=torch.int64, device=dev)
    ok &= pos_idx[None, :] <= valid_slot[:, None] - length
    flat = ok.view(-1)
    n_cand = flat.sum(dtype=torch.int32)
    idx = nonzero_capped(flat, p_cap)
    slot = (idx // positions).to(torch.int64)
    rel = (idx % positions).to(torch.int64)
    lim = torch.clamp(valid_slot[slot] - 1, min=0)
    r0 = torch.minimum(torch.clamp(rel + recovery[0], min=0), lim)
    r1 = torch.minimum(torch.clamp(rel + recovery[1], min=0), lim)
    return n_cand, idx, vals[slot, r0], vals[slot, r1]


def fused_body(
    elems: torch.Tensor,
    valid_count: int,
    expected: Sequence[int],
    pairs: Sequence[Tuple[int, int]],
    expected_exact: torch.Tensor,
    recovery: torch.Tensor,
    *,
    length: int,
    tile_elems: int,
    k_cap: int,
    p_cap: int,
    signed_compare: bool,
    pairs_exact: Sequence[Tuple[int, int]],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The whole fused step on an unpacked element buffer in plain tensor
    code (``scan_jnp.fused_body_xla``): :func:`count_body`, then
    :func:`hot_tail`.  Returns ``(counts, combo)``.

    ``elems``: ``(T+1) * tile_elems`` u8/u16 elements; ``expected`` and
    ``pairs``: the selected prefilter checks; ``expected_exact`` and
    ``recovery``: :func:`pattern_device_args`."""
    width = elems.element_size()
    counts = count_body(widen(elems), valid_count, expected, pairs, length,
                        tile_elems, width)
    return counts, hot_tail(
        elems, counts, valid_count, pairs_exact, expected_exact, recovery,
        tile_elems=tile_elems, length=length, signed_compare=signed_compare,
        k_cap=k_cap, p_cap=p_cap,
    )


def hot_tail(
    elems: torch.Tensor,
    counts: torch.Tensor,
    valid_count: int,
    pairs_exact: Sequence[Tuple[int, int]],
    expected: torch.Tensor,
    recovery: torch.Tensor,
    *,
    tile_elems: int,
    length: int,
    signed_compare: bool,
    k_cap: int,
    p_cap: int,
) -> torch.Tensor:
    """The fused step's tail after the counts in plain tensor code, the
    plain version of kernel L (``ops/scan_cuda.hot_combo``): the first
    ``k_cap`` hot tiles of ``counts``, each sliced out of ``elems`` with the
    next ``length - 1`` elements, then :func:`slots_combo`."""
    hot = nonzero_capped(counts, k_cap)
    # hot ids are below T and the buffer holds T+1 tiles: no slice reads
    # past the end
    idx = hot.to(torch.int64)[:, None] * tile_elems + torch.arange(
        tile_elems + length - 1, dtype=torch.int64, device=elems.device
    )
    src = elems.view(torch.int16) if elems.dtype == torch.uint16 else elems
    return slots_combo(
        src[idx].view(elems.dtype), counts, hot, valid_count, pairs_exact,
        expected, recovery, tile_elems=tile_elems, length=length,
        signed_compare=signed_compare, p_cap=p_cap,
    )


def slots_combo(
    slots: torch.Tensor,
    counts: torch.Tensor,
    hot: torch.Tensor,
    valid_count: int,
    pairs_exact: Sequence[Tuple[int, int]],
    expected: torch.Tensor,
    recovery: torch.Tensor,
    *,
    tile_elems: int,
    length: int,
    signed_compare: bool,
    p_cap: int,
) -> torch.Tensor:
    """:func:`exact_phase2` over the hot tiles' ``slots`` (each ``tile_elems
    + length - 1`` elements of tile ``hot[i]``) and the combo buffer
    (:func:`pack_combo`)."""
    nhot = (counts > 0).sum(dtype=torch.int32)
    n_cand, flat_idx, v0, v1 = exact_phase2(
        slots, hot, nhot, valid_count // tile_elems, valid_count % tile_elems,
        tile_elems=tile_elems, length=length, pairs_exact=pairs_exact,
        expected=expected, signed_compare=signed_compare,
        recovery=recovery, p_cap=p_cap,
    )
    return pack_combo(counts, hot, nhot, n_cand, flat_idx, v0, v1)


def pack_combo(counts, hot, nhot, n_cand, flat_idx, v0, v1) -> torch.Tensor:
    """The step's single device→host buffer, int32 (layout:
    ``host.COMBO_HEADER``): ``[n_hot, total, n_cand, hot_ids, hot_counts,
    flat_idx, v0, v1]``.  ``total`` wraps like the reference's int32 sum."""
    total = counts.sum().to(torch.int32)
    header = torch.stack([nhot.to(torch.int32), total, n_cand.to(torch.int32)])
    return torch.cat(
        [header, hot, counts[hot.to(torch.int64)], flat_idx, v0, v1]
    )
