"""Sharded scans over a mesh — counterpart of the JAX package's
``parallel/sharded.py``.

The reference's block/thread-pool runtime (``src/core/search_engine.cpp:
82-175``) becomes a grid cut into one run of whole count tiles per shard.
Each shard scans its own tiles plus ONE halo tile, a copy of the next
shard's first tile (the last shard's wraps to shard 0, where the valid
count masks it) — the port's counterpart of the JAX step's one-hop
``ppermute``: a ``copy_`` from the next shard's device, a peer copy when
the two sit on different cards.  Every match is found by exactly one
shard (the one whose tiles contain its start), so no dedup is needed.

Each jitted ``shard_map`` body of the JAX module is a loop over the
shards here, which enqueues every shard's work before any result is
fetched: :func:`sharded_fused_dispatch` launches the port's fused step on
each shard's device (kernel A and then the hot-tile tail, kernel L, on
packed words; the all-wildcard body, :func:`..ops.scan_cuda.
all_windows_gather`, when the pattern has no prefilter check), and
:func:`sharded_fused_multi_step` the keyword-batch step (kernel C, then
L).  On CPU tensors they run the kernels' plain versions, as everywhere in
the port.  :func:`parse_sharded_combos` copies the per-shard result
buffers back and decodes them; on capacity overflow it returns the global
counts for the host extraction, as the JAX module does.

:func:`sharded_scan_fn` is the mesh form of the exact match-and-compact
scan (kernel K, ``ops/scan_cuda.scan_chunk``): each shard holds its
elements plus a halo of ``L - 1`` copied from the next shard, and returns
its count and its first ``capacity`` offsets, made global.
:func:`sharded_candidates` is its host-facing front: it retries at four
times the capacity when a shard overflows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..carry import require_own
from ..dense import fused_multi_eligible
from ..ops.host import (
    _EMPTY,
    LANES,
    FusedInfo,
    _parse_combo,
    _prefilter_sel,
    auto_k_cap,
    canonical_check_tables,
)
from ..ops.scan_cuda import (
    all_windows_counts,
    all_windows_gather,
    prefilter_operand,
    tile_counts,
    tile_counts_elems,
    tile_counts_gather,
    tile_counts_gather_elems,
    tile_counts_multi_gather,
    scan_chunk,
)
from ..ops.scan_torch import pattern_device_args
from ..pattern import CompiledPattern
from .mesh import Mesh

__all__ = [
    "sharded_scan_fn",
    "sharded_candidates",
    "shard_grid",
    "sharded_tile_counts",
    "sharded_step_operands",
    "sharded_fused_dispatch",
    "sharded_fused_step",
    "sharded_fused_step_start",
    "sharded_fused_step_finish",
    "ShardedPending",
    "parse_sharded_combos",
    "sharded_fused_multi_step",
]


def _place_halo(data, mesh: Mesh, halo: int) -> List[torch.Tensor]:
    """A host element array, ``len(mesh)`` shards long, → one element buffer
    per shard on its device: the shard, then a copy of the first ``halo``
    elements of the next shard (the last shard's wraps to shard 0), cut to
    the shard's length as the JAX step's ``d_local[:halo]`` is."""
    arr = np.ascontiguousarray(data)
    if not arr.flags.writeable:
        arr = arr.copy()  # torch aliases only writable memory
    wide = arr.dtype.itemsize == 2
    host = torch.from_numpy(arr.view(np.int16) if wide else arr)
    d = len(mesh)
    shard = len(arr) // d
    h = min(halo, shard)
    exts = []
    for i, dev in enumerate(mesh.devices):
        ext = torch.empty(shard + h, dtype=host.dtype, device=dev)
        ext[:shard].copy_(host[i * shard : (i + 1) * shard])
        exts.append(ext)
    for i in range(d):
        exts[i][shard:].copy_(exts[(i + 1) % d][:h])
    return [e.view(torch.uint16) if wide else e for e in exts]


def sharded_scan_fn(mesh: Mesh, length: int, signed_compare: bool,
                    capacity: int):
    """The mesh scan step for a pattern shape: ``fn(data, valid, shift_cur,
    shift_prev, expected, recovery)`` with ``data`` a host u8/u16 element
    array whose length the mesh size divides, ``valid`` its valid element
    count (int) and the tables of :func:`..ops.scan_torch.
    pattern_device_args` (moved to each shard's device).  Every shard's
    scan (kernel K on a card, its plain version on the CPU) is enqueued
    before any result is fetched.  Returns the per-shard results stacked on
    the first shard's device: counts int32[D], offsets int32[D, capacity]
    (global element offsets, -1 fill) and values [D, capacity, 2]."""
    require_own(mesh, Mesh, "sharded_scan_fn: mesh")
    halo = length - 1

    def fn(data, valid, shift_cur, shift_prev, expected, recovery):
        exts = _place_halo(data, mesh, halo)
        shard = len(data) // len(mesh)
        counts, offsets, values = [], [], []
        for i, ext in enumerate(exts):
            base = i * shard
            valid_local = min(max(int(valid) - base, 0), shard + halo)
            tables = [t.to(ext.device) for t in
                      (shift_cur, shift_prev, expected, recovery)]
            count, offs, vals = scan_chunk(
                ext, valid_local, *tables, length=length,
                signed_compare=signed_compare, capacity=capacity,
            )
            counts.append(count)
            offsets.append(torch.where(offs >= 0, offs + base, -1))
            values.append(vals)
        first = mesh.devices[0]
        return tuple(
            torch.stack([t.to(first) for t in parts])
            for parts in (counts, offsets, values)
        )

    return fn


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A device tensor as a numpy array (u16 through an int16 view)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def sharded_candidates(
    pat: CompiledPattern,
    data: np.ndarray,
    mesh: Mesh,
    capacity_per_shard: int = 16384,
) -> Tuple[np.ndarray, np.ndarray]:
    """All matching offsets of *data* scanned across *mesh*, with their
    recovery values ``[M, 2]``, both int64.

    Pads *data* to a whole number of shards, runs the
    :func:`sharded_scan_fn` step and keeps every shard's offsets in order;
    when a shard finds more matches than ``capacity_per_shard``, runs again
    at four times the capacity."""
    require_own(pat, CompiledPattern, "sharded_candidates")
    require_own(mesh, Mesh, "sharded_candidates: mesh")
    data = np.ascontiguousarray(data, dtype=pat.dtype)
    n = len(data)
    if n >= 2**31:
        raise ValueError(
            "sharded_candidates is int32-indexed (< 2^31 elements); use "
            "the engine's chunked paths for larger inputs"
        )
    if n < pat.length:
        return np.zeros(0, dtype=np.int64), np.zeros((0, 2), dtype=np.int64)
    d = len(mesh)
    shard = -(-n // d)
    padded = shard * d
    if padded != n:
        data = np.pad(data, (0, padded - n))

    fn = sharded_scan_fn(mesh, pat.length, pat.signed_compare,
                         capacity_per_shard)
    counts, offsets, values = fn(
        data, n, *pattern_device_args(pat, mesh.devices[0])
    )
    if int(counts.max()) > capacity_per_shard:
        return sharded_candidates(
            pat, data[:n], mesh, capacity_per_shard * 4
        )
    offs = _to_host(offsets).reshape(-1)
    vals = _to_host(values).reshape(-1, 2)
    keep = offs >= 0
    offs, vals = offs[keep].astype(np.int64), vals[keep].astype(np.int64)
    order = np.argsort(offs, kind="stable")
    return offs[order], vals[order]


def _fused_mode(use_pallas: bool, tile_elems: int, max_shift: int) -> str:
    """The body the JAX mesh step would take on the TPU: ``"swar"`` (its
    Pallas kernel) or ``"xla"`` (when the tile is not a multiple of
    ``8 * LANES`` rows, a selected shift reaches past one kernel row, or
    Pallas is off).  The port's kernels take any tile and any shift, so
    the port reads this only where the choice changes the engine's counts:
    an XLA-body shard past 2^31 elements makes the JAX engine take the
    chunked mesh step.  The JAX test of the TPU's compute mode has no
    counterpart: the CUDA counts kernel is SWAR on every card."""
    if tile_elems % (8 * LANES) != 0 or max_shift >= LANES:
        return "xla"
    return "swar" if use_pallas else "xla"


def _words_fit(tile_elems: int, width: int) -> bool:
    """True when a tile is whole int32 words (so shards are packed words,
    kernels A and L); tinier tiles travel as elements (kernels D and L)."""
    return (tile_elems * width) % 4 == 0


def _place(arr: np.ndarray, mesh: Mesh, tile_elems: int,
           t_loc: int) -> Tuple[torch.Tensor, ...]:
    """Host elements (at least ``len(mesh) * t_loc * tile_elems`` of them)
    → one buffer per shard on its device: the shard's ``t_loc`` tiles,
    then a copy of the next shard's first tile.  Packed int32 words where
    a tile is whole words, else u8/u16 elements."""
    width = arr.dtype.itemsize
    e_loc = t_loc * tile_elems
    n_elems = e_loc + tile_elems
    # the copies run through byte and int16 views: u16 has no copy kernel
    # on every build
    host = arr.view(np.int16) if width == 2 else arr
    el_dtype = torch.int16 if width == 2 else torch.uint8
    words = _words_fit(tile_elems, width)
    bases = []
    for i, dev in enumerate(mesh.devices):
        if words:
            base = torch.empty(n_elems * width // 4, dtype=torch.int32,
                               device=dev)
            view = base.view(el_dtype)
        else:
            base = view = torch.empty(n_elems, dtype=el_dtype, device=dev)
        view[:e_loc].copy_(
            torch.from_numpy(host[i * e_loc : (i + 1) * e_loc])
        )
        bases.append((base, view))
    d = len(mesh)
    for i in range(d):
        bases[i][1][e_loc:].copy_(bases[(i + 1) % d][1][:tile_elems])
    if words:
        return tuple(base for base, _ in bases)
    return tuple(view.view(torch.uint16) if width == 2 else view
                 for _, view in bases)


def shard_grid(arr: np.ndarray, mesh: Mesh, tile_elems: int):
    """Pad a host element array to whole per-shard tile spans and place it
    across the mesh (:func:`_place`).  Returns ``(shards, T)``, T the
    number of counted tiles covering ``len(arr)`` elements."""
    require_own(mesh, Mesh, "shard_grid: mesh")
    n = len(arr)
    d = len(mesh)
    t_total = max(1, -(-n // tile_elems))
    t_loc = -(-t_total // d)
    padded = d * t_loc * tile_elems
    arr = np.ascontiguousarray(arr)
    if padded != n:
        arr = np.pad(arr, (0, padded - n))
    elif not arr.flags.writeable:
        arr = arr.copy()  # torch aliases only writable memory
    return _place(arr, mesh, tile_elems, t_loc), t_total


def _shard_tiles(shard: torch.Tensor, width: int, tile_elems: int) -> int:
    """Counted tiles of one shard buffer (its tiles less the halo tile)."""
    per_elem = 4 // width if shard.dtype == torch.int32 else 1
    return shard.numel() * per_elem // tile_elems - 1


def sharded_step_operands(valid_count: int, t_loc: int, tile_elems: int,
                          d: int) -> np.ndarray:
    """Per-shard valid element counts, int64[d], relative to each shard's
    base: ``clip(valid_count - i * t_loc * tile_elems, 0, (t_loc + 1) *
    tile_elems)`` — the JAX module's phase-2 ``vtvr2`` count, which the
    port's kernels take as one integer per launch."""
    e_loc = t_loc * tile_elems
    bases = np.arange(d, dtype=np.int64) * e_loc
    return np.clip(valid_count - bases, 0, e_loc + tile_elems)


def sharded_tile_counts(
    pat: CompiledPattern,
    data,
    mesh: Mesh,
    valid_count: int,
    tile_elems: int,
) -> np.ndarray:
    """Phase 1 across a mesh: int32[T] per-tile prefilter match counts for
    the whole corpus, every shard's counts enqueued before any is fetched.

    ``data`` is a host element array (placed across the mesh first) or
    the shards :func:`shard_grid` returned.  Same count contract as
    ``dense.tile_counts``."""
    require_own(pat, CompiledPattern, "sharded_tile_counts")
    if isinstance(data, np.ndarray):
        shards, t_total = shard_grid(
            np.ascontiguousarray(data, dtype=pat.dtype), mesh, tile_elems
        )
    else:
        shards, t_total = data, max(1, -(-valid_count // tile_elems))
    width = np.dtype(pat.dtype).itemsize
    t_loc = _shard_tiles(shards[0], width, tile_elems)
    valid_loc = sharded_step_operands(valid_count, t_loc, tile_elems,
                                      len(shards))
    pairs, _, _ = _prefilter_sel(pat)
    counts = []
    for shard, valid in zip(shards, valid_loc.tolist()):
        args = dict(tile_elems=tile_elems, length=pat.length,
                    valid_count=valid)
        if not pairs:
            counts.append(all_windows_counts(pat, shard, valid, tile_elems))
        elif shard.dtype == torch.int32:
            counts.append(tile_counts(
                shard, prefilter_operand(pat, shard.device), width=width,
                **args))
        else:
            counts.append(tile_counts_elems(
                shard, prefilter_operand(pat, shard.device), **args))
    return np.concatenate([c.cpu().numpy() for c in counts])[:t_total]


def sharded_fused_dispatch(
    pat: CompiledPattern,
    shards: Sequence[torch.Tensor],
    valid_loc: np.ndarray,
    tile_elems: int,
    k_cap: int,
    p_cap: int,
) -> Tuple[Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Enqueue the fused step on every shard (the loop that replaces the
    JAX ``shard_map`` body), fetching nothing: returns the per-shard
    ``(counts, combos)`` device tensors.  A pattern with no prefilter
    check takes the all-wildcard body (no counts kernel), packed words
    kernels A and L, element buffers D and L."""
    pairs, _, _ = _prefilter_sel(pat)
    counts, combos = [], []
    for shard, valid in zip(shards, valid_loc.tolist()):
        if not pairs:
            step = all_windows_gather
        elif shard.dtype == torch.int32:
            step = tile_counts_gather
        else:
            step = tile_counts_gather_elems
        c, combo = step(pat, shard, valid, tile_elems, k_cap, p_cap)
        counts.append(c)
        combos.append(combo)
    return tuple(counts), tuple(combos)


class ShardedPending(NamedTuple):
    """An in-flight fused mesh step: the per-shard device result tensors
    plus the geometry :func:`sharded_fused_step_finish` needs to fetch and
    decode them (mesh twin of ``dense.FusedPending``)."""

    counts: tuple
    combos: tuple
    d: int
    t_loc: int
    t_total: int
    k_cap: int
    p_cap: int
    tile_elems: int
    grid_offset: int


def sharded_fused_step(
    pat: CompiledPattern,
    arr: np.ndarray,
    mesh: Mesh,
    valid_count: int,
    tile_elems: int,
    k_cap: int | None = None,
    p_cap: int = 1024,
    grid_offset: int = 0,
):
    """Fused phases 1 + 2 of one host chunk across a mesh: per-shard
    prefilter counts, the halo tile, the hot-tile gather and the EXACT
    phase 2 on every shard, then one small result buffer per shard copied
    back.  The mesh twin of ``dense.fused_count_extract``.

    Returns ``(offsets, values, info, overflow_counts)``.  When any shard
    overflows ``k_cap`` hot tiles or ``p_cap`` candidates,
    ``overflow_counts`` is the global int32[T] count array (offsets and
    values empty) and the caller runs host extraction."""
    return sharded_fused_step_finish(
        sharded_fused_step_start(
            pat, arr, mesh, valid_count, tile_elems, k_cap=k_cap,
            p_cap=p_cap, grid_offset=grid_offset,
        )
    )


def sharded_fused_step_start(
    pat: CompiledPattern,
    arr: np.ndarray,
    mesh: Mesh,
    valid_count: int,
    tile_elems: int,
    k_cap: int | None = None,
    p_cap: int = 1024,
    grid_offset: int = 0,
) -> ShardedPending:
    """Upload the chunk's shards and enqueue the fused step on each
    WITHOUT fetching the result, so a chunked caller keeps
    ``pipeline_depth`` mesh steps in flight."""
    require_own(pat, CompiledPattern, "sharded_fused_step_start")
    require_own(mesh, Mesh, "sharded_fused_step_start: mesh")
    d = len(mesh)
    pairs, _, _ = _prefilter_sel(pat)
    if k_cap is None:
        k_cap = auto_k_cap(pat, valid_count, tile_elems, len(pairs))
    arr = np.ascontiguousarray(arr, dtype=pat.dtype)
    t_total = max(1, -(-valid_count // tile_elems))
    t_loc = -(-t_total // d)
    total = d * t_loc * tile_elems
    if len(arr) < total:
        arr = np.pad(arr, (0, total - len(arr)))
    elif not arr.flags.writeable:
        arr = arr.copy()  # torch aliases only writable memory
    shards = _place(arr, mesh, tile_elems, t_loc)
    valid_loc = sharded_step_operands(valid_count, t_loc, tile_elems, d)
    counts, combos = sharded_fused_dispatch(
        pat, shards, valid_loc, tile_elems, k_cap, p_cap
    )
    return ShardedPending(counts, combos, d, t_loc, t_total, k_cap, p_cap,
                          tile_elems, grid_offset)


def sharded_fused_step_finish(pending: ShardedPending):
    """Fetch and decode an in-flight mesh step (the blocking half of
    :func:`sharded_fused_step`)."""
    return parse_sharded_combos(
        pending.counts, pending.combos, pending.d, pending.t_loc,
        pending.t_total, pending.k_cap, pending.p_cap, pending.tile_elems,
        pending.grid_offset,
    )


def parse_sharded_combos(
    counts, combos, d, t_loc, t_total, k_cap, p_cap, tile_elems,
    grid_offset,
):
    """Copy the per-shard result buffers back (device tensors, or rows
    already fetched) and decode them into global offsets and values —
    shared by the chunked and resident mesh routes.  Returns ``(offsets,
    values, info, overflow_counts)`` as :func:`sharded_fused_step`."""
    combos = np.stack([
        c.cpu().numpy() if isinstance(c, torch.Tensor) else c
        for c in combos
    ])  # (D, 3 + 2k + 3p)
    n_hot = combos[:, 0]
    n_cand = combos[:, 2]
    info = FusedInfo(
        int(n_hot.sum()), int(combos[:, 1].sum()),
        candidates=int(n_cand.sum()), d2h_bytes=combos.nbytes,
        per_device=tuple(int(c) for c in n_cand),
    )
    if (n_hot > k_cap).any() or (n_cand > p_cap).any():
        over = np.concatenate([c.cpu().numpy() for c in counts])[:t_total]
        # the capped gather's per-shard counts undercount on overflow —
        # not meaningful as balance evidence
        info = info._replace(
            fallback=True, d2h_bytes=info.d2h_bytes + over.nbytes,
            per_device=None,
        )
        return (*_EMPTY, info, over)

    all_offs, all_vals = [], []
    for dev in range(d):
        if int(n_cand[dev]) == 0:
            continue
        # the shared decoder with the shard's global tile base folded into
        # grid_offset
        offs, vals = _parse_combo(
            combos[dev], k_cap, p_cap, tile_elems,
            grid_offset + dev * t_loc * tile_elems,
        )
        all_offs.append(offs)
        all_vals.append(vals)
    if not all_offs:
        return (*_EMPTY, info, None)
    return np.concatenate(all_offs), np.concatenate(all_vals), info, None


def sharded_fused_multi_step(
    pats: List[CompiledPattern],
    shards: Sequence[torch.Tensor],
    valid_count: int,
    tile_elems: int,
    t_loc: int,
    k_cap: int | None = None,
    p_cap: int = 1024,
    grid_offset: int = 0,
):
    """K patterns × one sharded grid: kernel C counts every pattern on
    each shard in one pass, then each pattern's hot tiles are exactly
    re-checked (kernel L), every shard enqueued before the
    per-shard result buffers come back.

    ``shards`` are the packed word grids of ``ShardedResidentCorpus.grid``
    (``t_loc`` counted tiles each).  Returns a list of ``(offsets, values,
    FusedInfo, overflow_counts)`` per pattern with the per-pattern
    contract of :func:`sharded_fused_step`, or ``None`` when the batch is
    not eligible (``dense.fused_multi_eligible``) or the grid is not
    packed."""
    if not fused_multi_eligible(pats, tile_elems):
        return None
    if shards[0].dtype != torch.int32:
        return None
    d = len(shards)
    K = len(pats)
    if k_cap is None:
        _, _, active_list = canonical_check_tables(pats)
        k_cap = max(
            auto_k_cap(pat, valid_count, tile_elems,
                       int(np.count_nonzero(act)))
            for pat, act in zip(pats, active_list)
        )
    valid_loc = sharded_step_operands(valid_count, t_loc, tile_elems, d)
    launched = [
        tile_counts_multi_gather(pats, shard, valid, tile_elems, k_cap,
                                 p_cap)
        for shard, valid in zip(shards, valid_loc.tolist())
    ]
    # (D, K, combo length): every shard's K buffers, fetched once
    combos = np.stack([c.cpu().numpy().reshape(K, -1) for _, c in launched])
    t_total = max(1, -(-valid_count // tile_elems))
    return [
        parse_sharded_combos(
            [counts[k] for counts, _ in launched], combos[:, k, :], d,
            t_loc, t_total, k_cap, p_cap, tile_elems, grid_offset,
        )
        for k in range(K)
    ]
