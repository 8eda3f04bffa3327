"""The fused device step's kernels — counterpart of the JAX package's
``ops/scan_pallas.py`` (the single-device part of it).

The wrappers of the kernels, hand-written in CUDA C++ for Hopper
(``csrc/``):

- :func:`tile_counts` (kernel A, ``csrc/tile_counts.cu``) replaces
  ``scan_pallas._tile_counts_swar_call``;
- :func:`gather_tiles` (kernel B, ``csrc/gather_tiles.cu``) replaces
  ``scan_pallas._gather_tiles_dma_call``;
- :func:`tile_counts_multi` (kernel C, ``csrc/tile_counts_multi.cu``)
  replaces ``scan_pallas._tile_counts_swar_multi_call``;
- :func:`tile_counts_elems` (kernel D, ``csrc/tile_counts_elems.cu``)
  replaces ``scan_pallas._tile_counts_call``; A, C and D are the entry
  points of one SWAR counts kernel, ``csrc/swar_counts.cuh``;
- :func:`gather_tiles_block` (kernel E) replaces
  ``scan_pallas._gather_tiles_call``: the same bulk-copy kernel as B
  (``csrc/gather_tiles.cu``) on an element buffer;
- :func:`load_sum` (kernels I and J, ``csrc/load_sum.cu``) replaces the
  speed-of-light load kernel of ``bench.py`` and ``tools/perf_probe.py``
  (``load_kernel`` / ``load_call``);
- :func:`scan_chunk` (kernel K, ``csrc/match_compact.cu``) computes
  ``scan_jnp.scan_chunk``, the exact match-and-compact scan that XLA fuses
  for the JAX package (no Pallas kernel there);
- :func:`hot_combo` (kernel L, ``csrc/hot_combo.cu``) replaces the fused
  step's tail, ``scan_pallas._hot_slots_and_combo``: hot-tile choice, the
  exact phase 2 read straight from the chunk, and the combo buffer;
- :func:`derive_words` (kernel M, ``csrc/derive_words.cu``) derives a
  grid's packed words from the resident corpus's words: the jnp
  derivation of the JAX package's ``corpus.grid_chunk`` (no Pallas
  kernel there).

Each wrapper checks its operands, allocates its output, and launches its
kernel on the current stream for a CUDA tensor, or runs its plain PyTorch
version (``*_plain``, same module) for a CPU tensor; any other device
raises.  :data:`launch_counts` counts kernel launches, so a run can show
that it went through the kernels; :data:`aligned_launch_counts` counts the
gathers' launches whose pointers and tile size are all 16-byte aligned,
where every slot inside the source moves by bulk copy.

:func:`tile_counts_gather` is the counterpart of ``tile_counts_gather_pallas``
with ``_swar_counts_gather_call`` and ``_hot_slots_and_combo``: kernel A's
counts, then kernel L's hot-tile selection, exact phase 2 and combo buffer,
all enqueued with no host sync.  :func:`tile_counts_gather_elems` is its
element-array twin (``_native_counts_gather_call``: kernels D and L), and
:func:`tile_counts_multi_gather` the keyword-batch twin
(``_swar_multi_gather_call``: kernel C, then L per keyword).
"""

from __future__ import annotations

import threading
from typing import List, Tuple

import numpy as np
import torch

from .. import profiling
from ..pattern import CompiledPattern
from .host import (
    COMBO_HEADER,
    canonical_check_tables,
    multi_pattern_tables,
    prefilter_checks,
)
from . import scan_torch
from .scan_torch import (
    as_elements,
    count_body,
    operand_cache,
    pattern_device_args,
    widen,
)

__all__ = [
    "launch_counts",
    "aligned_launch_counts",
    "reset_launch_counts",
    "prefilter_operand",
    "tile_counts",
    "tile_counts_plain",
    "gather_tiles",
    "gather_tiles_plain",
    "tile_counts_gather",
    "all_windows_gather",
    "all_windows_counts",
    "multi_operand",
    "tile_counts_multi",
    "tile_counts_multi_plain",
    "tile_counts_multi_gather",
    "tile_counts_elems",
    "tile_counts_elems_plain",
    "gather_tiles_block",
    "gather_tiles_block_plain",
    "tile_counts_gather_elems",
    "load_sum",
    "load_sum_plain",
    "MATCH_SPAN",
    "MATCH_LIST",
    "match_spans",
    "scan_chunk",
    "launch_match_compact",
    "scan_chunk_plain",
    "hot_combo",
    "hot_combo_plain",
    "derive_words",
    "derive_words_plain",
]

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
launch_counts = {"tile_counts": 0, "gather_tiles": 0, "tile_counts_multi": 0,
                 "tile_counts_elems": 0, "gather_tiles_block": 0,
                 "load_sum": 0, "scan_chunk": 0, "hot_combo": 0,
                 "derive_words": 0}

#: the gathers' launches with 16-byte aligned source, output and tile size
aligned_launch_counts = {"gather_tiles": 0, "gather_tiles_block": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, aligned_launch_counts):
        for name in counts:
            counts[name] = 0


def _kernel_device(t: torch.Tensor) -> bool:
    """True: launch the kernel; False: run the plain version (CPU)."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no kernel for device {t.device}")


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise ValueError(msg)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def prefilter_operand(pat: CompiledPattern, device) -> torch.Tensor:
    """The pattern's selected prefilter checks as an int32 ``(3, C)``
    tensor on *device*: rows ``cur``, ``prev`` and ``expected`` (element
    dtype, mod 2^width) — the check operand of kernels A and D.  Memoized
    per pattern."""
    cache = operand_cache(pat)
    key = ("prefilter", str(torch.device(device)))
    if key not in cache:
        pairs, exp = prefilter_checks(pat)
        table = np.zeros((3, len(pairs)), dtype=np.int64)
        if pairs:
            table[0], table[1] = zip(*pairs)
            table[2] = exp.astype(np.int64)
        cache[key] = torch.tensor(table, dtype=torch.int32, device=device)
    return cache[key]


def _tile_geometry(words, width, tile_elems) -> int:
    """Checks a packed word buffer of T+1 tiles; returns T."""
    _check(words.dtype == torch.int32 and words.dim() == 1
           and words.is_contiguous(),
           "words must be a contiguous 1-D int32 tensor")
    _check(width in (1, 2), f"width must be 1 or 2, got {width}")
    n_elems = words.numel() * 4 // width
    _check(tile_elems > 0 and n_elems % tile_elems == 0
           and n_elems >= 2 * tile_elems,
           f"{n_elems} elements are not T+1 >= 2 tiles of {tile_elems}")
    return n_elems // tile_elems - 1


def _counts_geometry(words, checks, width, tile_elems, valid_count):
    n_tiles = _tile_geometry(words, width, tile_elems)
    _check(checks.dtype == torch.int32 and checks.dim() == 2
           and checks.shape[0] == 3 and checks.is_contiguous()
           and checks.device == words.device,
           "checks must be a contiguous (3, C) int32 tensor beside words")
    _check(valid_count <= (n_tiles + 1) * tile_elems,
           "valid_count exceeds the buffer")
    return n_tiles


def tile_counts(
    words: torch.Tensor,
    checks: torch.Tensor,
    *,
    width: int,
    tile_elems: int,
    length: int,
    valid_count: int,
) -> torch.Tensor:
    """Kernel A: int32[T] prefilter match counts per tile.

    ``words``: packed little-endian words holding ``(T+1) * tile_elems``
    u8 (``width`` 1) or u16 (``width`` 2) elements — T counted tiles plus
    one halo tile.  ``checks``: :func:`prefilter_operand`.  Window start
    ``e`` of tile ``t`` counts when ``e <= valid_count - length`` and every
    check holds mod 2^(8*width)."""
    n_tiles = _counts_geometry(words, checks, width, tile_elems, valid_count)
    if not _kernel_device(words):
        return tile_counts_plain(
            words, checks, width=width, tile_elems=tile_elems,
            length=length, valid_count=valid_count,
        )
    from ._build import load_library

    lib = load_library()
    out = torch.empty(n_tiles, dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_tile_counts(
            words.data_ptr(), n_tiles, tile_elems, width,
            checks.data_ptr(), int(checks.shape[1]),
            valid_count - length, out.data_ptr(), stream,
        )
    _raise_on(rc, "tile_counts")
    launch_counts["tile_counts"] += 1
    return out


def tile_counts_plain(
    words, checks, *, width, tile_elems, length, valid_count
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tile_counts` (reads the check table
    back to the host)."""
    cur, prev, exp = checks.tolist()
    return count_body(
        widen(as_elements(words, width)), valid_count, exp,
        list(zip(cur, prev)), length, tile_elems, width,
    )


def gather_tiles(
    words: torch.Tensor, hot: torch.Tensor, *, width: int, tile_elems: int
) -> torch.Tensor:
    """Kernel B: slot ``i`` receives elements ``[hot[i] * tile_elems,
    (hot[i] + 2) * tile_elems)`` of the element buffer ``words`` holds —
    tile ``hot[i]`` and its halo tile.  Returns ``(len(hot), 2 * tile_elems
    * width)`` uint8; bytes past the buffer end read as 0."""
    _check(words.is_contiguous() and words.dim() == 1,
           "words must be a contiguous 1-D tensor")
    _check(hot.dtype == torch.int32 and hot.dim() == 1
           and hot.is_contiguous() and hot.device == words.device,
           "hot must be a contiguous 1-D int32 tensor beside words")
    _check(width in (1, 2) and tile_elems > 0, "bad width or tile_elems")
    tile_bytes = tile_elems * width
    if not _kernel_device(words):
        return gather_tiles_plain(
            words, hot, width=width, tile_elems=tile_elems
        )
    out = torch.empty((hot.shape[0], 2 * tile_bytes), dtype=torch.uint8,
                      device=words.device)
    return _launch_gather("gather_tiles", words, hot, tile_bytes, out)


def gather_tiles_plain(words, hot, *, width, tile_elems) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_tiles`."""
    src = words.view(torch.uint8)
    span = 2 * tile_elems * width
    idx = hot.to(torch.int64)[:, None] * (tile_elems * width) + torch.arange(
        span, dtype=torch.int64, device=words.device
    )
    inside = (idx >= 0) & (idx < src.numel())
    got = src[torch.clamp(idx, 0, max(src.numel() - 1, 0))]
    return torch.where(inside, got, 0).to(torch.uint8)


def _elems_geometry(elems, tile_elems) -> int:
    """Checks an element buffer of T+1 tiles; returns T."""
    _check(elems.dtype in (torch.uint8, torch.uint16) and elems.dim() == 1
           and elems.is_contiguous(),
           "elems must be a contiguous 1-D uint8 or uint16 tensor")
    n_elems = elems.numel()
    _check(tile_elems > 0 and n_elems % tile_elems == 0
           and n_elems >= 2 * tile_elems,
           f"{n_elems} elements are not T+1 >= 2 tiles of {tile_elems}")
    return n_elems // tile_elems - 1


def tile_counts_elems(
    elems: torch.Tensor,
    checks: torch.Tensor,
    *,
    tile_elems: int,
    length: int,
    valid_count: int,
) -> torch.Tensor:
    """Kernel D: int32[T] prefilter match counts per tile of an unpacked
    element buffer.

    ``elems``: ``(T+1) * tile_elems`` u8 or u16 elements — T counted tiles
    plus one halo tile.  ``checks``: :func:`prefilter_operand`, every shift
    below ``length``.  Window start ``e`` of tile ``t`` counts when ``e <=
    valid_count - length`` and every check holds mod 2^(8*width): kernel
    A's contract on elements instead of packed words."""
    n_tiles = _elems_geometry(elems, tile_elems)
    _check(checks.dtype == torch.int32 and checks.dim() == 2
           and checks.shape[0] == 3 and checks.is_contiguous()
           and checks.device == elems.device,
           "checks must be a contiguous (3, C) int32 tensor beside elems")
    _check(valid_count <= elems.numel(), "valid_count exceeds the buffer")
    _check(length >= 1, "length must be positive")
    if not _kernel_device(elems):
        return tile_counts_elems_plain(
            elems, checks, tile_elems=tile_elems, length=length,
            valid_count=valid_count,
        )
    from ._build import load_library

    lib = load_library()
    out = torch.empty(n_tiles, dtype=torch.int32, device=elems.device)
    with torch.cuda.device(elems.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_tile_counts_elems(
            elems.data_ptr(), n_tiles, tile_elems, elems.element_size(),
            checks.data_ptr(), int(checks.shape[1]), valid_count - length,
            out.data_ptr(), stream,
        )
    _raise_on(rc, "tile_counts_elems")
    launch_counts["tile_counts_elems"] += 1
    return out


def tile_counts_elems_plain(
    elems, checks, *, tile_elems, length, valid_count
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tile_counts_elems`
    (``scan_jnp.tile_counts_xla``: ``count_body`` on the widened elements;
    reads the check table back to the host)."""
    cur, prev, exp = checks.tolist()
    return count_body(
        widen(elems), valid_count, exp, list(zip(cur, prev)), length,
        tile_elems, elems.element_size(),
    )


def gather_tiles_block(
    elems: torch.Tensor, hot: torch.Tensor, *, tile_elems: int
) -> torch.Tensor:
    """Kernel E: slot ``i`` receives elements ``[hot[i] * tile_elems,
    (hot[i] + 2) * tile_elems)`` of ``elems`` — tile ``hot[i]`` and its
    halo tile, by kernel B's bulk copy.  Returns ``(len(hot), 2 *
    tile_elems)`` in the element dtype; elements past the buffer end read
    as 0.  Kernel B's contract on an element buffer."""
    _check(elems.dtype in (torch.uint8, torch.uint16) and elems.dim() == 1
           and elems.is_contiguous(),
           "elems must be a contiguous 1-D uint8 or uint16 tensor")
    _check(hot.dtype == torch.int32 and hot.dim() == 1
           and hot.is_contiguous() and hot.device == elems.device,
           "hot must be a contiguous 1-D int32 tensor beside elems")
    _check(tile_elems > 0, "tile_elems must be positive")
    if not _kernel_device(elems):
        return gather_tiles_block_plain(elems, hot, tile_elems=tile_elems)
    out = torch.empty((hot.shape[0], 2 * tile_elems), dtype=elems.dtype,
                      device=elems.device)
    return _launch_gather("gather_tiles_block", elems, hot,
                          tile_elems * elems.element_size(), out)


def _launch_gather(name, src, hot, tile_bytes, out) -> torch.Tensor:
    """Launches the gather kernel (``csrc/gather_tiles.cu``) through the
    entry point of wrapper *name* (``mm_gather_tiles`` for B,
    ``mm_gather_tiles_block`` for E) and counts the launch."""
    from ._build import load_library

    entry = getattr(load_library(), "mm_" + name)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = entry(src.data_ptr(), src.numel() * src.element_size(),
                   hot.data_ptr(), hot.shape[0], tile_bytes, out.data_ptr(),
                   stream)
    _raise_on(rc, name)
    launch_counts[name] += 1
    if (src.data_ptr() | out.data_ptr() | tile_bytes) % 16 == 0:
        aligned_launch_counts[name] += 1
    return out


def gather_tiles_block_plain(elems, hot, *, tile_elems) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_tiles_block`: an element
    index take (u16 through an int16 view)."""
    src = elems.view(torch.int16) if elems.dtype == torch.uint16 else elems
    idx = hot.to(torch.int64)[:, None] * tile_elems + torch.arange(
        2 * tile_elems, dtype=torch.int64, device=elems.device
    )
    inside = (idx >= 0) & (idx < src.numel())
    got = src[torch.clamp(idx, 0, max(src.numel() - 1, 0))]
    return torch.where(inside, got, 0).view(elems.dtype)


def tile_counts_gather(
    pat: CompiledPattern,
    words: torch.Tensor,
    valid_count: int,
    tile_elems: int,
    k_cap: int,
    p_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused phases 1 + 2 for one grid chunk, enqueued on the current
    stream with no host sync.

    ``words``: the chunk's packed words, ``(T+1) * tile_elems`` elements.
    Returns device tensors ``(counts int32[T], combo int32)``: kernel A's
    counts, then kernel L picks the first ``k_cap`` hot tiles, re-checks
    every window of each with the full check tables, reading the tile and
    its halo straight from ``words``, and packs header, hot ids and counts,
    candidate offsets and recovery values (layout ``host.COMBO_HEADER``)."""
    counts = tile_counts(
        words, prefilter_operand(pat, words.device),
        width=np.dtype(pat.dtype).itemsize, tile_elems=tile_elems,
        length=pat.length, valid_count=valid_count,
    )
    return counts, _fused_tail(pat, words, counts, valid_count, tile_elems,
                               k_cap, p_cap)


def tile_counts_gather_elems(
    pat: CompiledPattern,
    elems: torch.Tensor,
    valid_count: int,
    tile_elems: int,
    k_cap: int,
    p_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tile_counts_gather` on an unpacked u8/u16 element buffer
    (``_native_counts_gather_call``): kernel D's counts, then kernel L's
    tail, in the same layout, enqueued with no host sync."""
    counts = tile_counts_elems(
        elems, prefilter_operand(pat, elems.device), tile_elems=tile_elems,
        length=pat.length, valid_count=valid_count,
    )
    return counts, _fused_tail(
        pat, elems, counts, valid_count, tile_elems, k_cap, p_cap
    )


def all_windows_gather(
    pat: CompiledPattern,
    data: torch.Tensor,
    valid_count: int,
    tile_elems: int,
    k_cap: int,
    p_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`tile_counts_gather` for a pattern with no prefilter check (an
    all-wildcard keyword; ``fused_body_xla`` with no pairs): every window
    start ``e <= valid_count - length`` counts, so the counts come from the
    geometry, with no counts kernel; then kernel L's tail over packed words
    or elements, enqueued with no host sync."""
    counts = all_windows_counts(pat, data, valid_count, tile_elems)
    return counts, _fused_tail(
        pat, data, counts, valid_count, tile_elems, k_cap, p_cap
    )


def all_windows_counts(pat: CompiledPattern, data: torch.Tensor,
                       valid_count: int, tile_elems: int) -> torch.Tensor:
    """int32[T] counts of a pattern with no prefilter check over ``data``
    (packed words or u8/u16 elements, T+1 tiles): the valid window starts
    of each tile, computed on ``data``'s device from the geometry alone."""
    width = np.dtype(pat.dtype).itemsize
    per_elem = 4 // width if data.dtype == torch.int32 else 1
    n_tiles = data.numel() * per_elem // tile_elems - 1
    starts = torch.arange(n_tiles, dtype=torch.int64,
                          device=data.device) * tile_elems
    return torch.clamp(valid_count - pat.length + 1 - starts, 0,
                       tile_elems).to(torch.int32)


def _fused_tail(pat, data, counts, valid_count, tile_elems, k_cap,
                p_cap) -> torch.Tensor:
    """The fused step's tail after the counts: :func:`hot_combo` over the
    chunk ``data`` (packed int32 words or u8/u16 elements) with the
    pattern's memoized exact tables."""
    cur, prev, exp, rec = pattern_device_args(pat, data.device)
    if data.dtype == torch.int32:
        data = as_elements(data, np.dtype(pat.dtype).itemsize)
    return hot_combo(
        data, counts, valid_count, cur, prev, exp, rec,
        tile_elems=tile_elems, length=pat.length,
        signed_compare=pat.signed_compare, k_cap=k_cap, p_cap=p_cap,
    )


def hot_combo(
    elems: torch.Tensor,
    counts: torch.Tensor,
    valid_count: int,
    shift_cur: torch.Tensor,
    shift_prev: torch.Tensor,
    expected: torch.Tensor,
    recovery: torch.Tensor,
    *,
    tile_elems: int,
    length: int,
    signed_compare: bool,
    k_cap: int,
    p_cap: int,
) -> torch.Tensor:
    """Kernel L: the fused step's int32 combo buffer (layout
    ``host.COMBO_HEADER``, ``3 + 2 k_cap + 3 p_cap`` entries) from the
    chunk's u8/u16 ``elems`` (``(T+1) * tile_elems`` of them) and their
    counts ``int32[T]``: ``n_hot`` (tiles with a count above 0), the
    counts' int32 sum, the exact match count, the first ``k_cap`` hot ids
    and their counts, the first ``p_cap`` matches of the exact phase 2 over
    those tiles as ``slot * tile_elems + rel`` and their two recovery
    values (``scan_torch.exact_phase2``; fillers as its plain version
    writes them).  The tables are :func:`scan_torch.pattern_device_args`'
    int32 tensors beside ``elems``; ``valid_count`` is a host int, so
    nothing waits on the card.  Two launches on the current stream."""
    n_tiles = _elems_geometry(elems, tile_elems)
    dev = elems.device
    _check(counts.dtype == torch.int32 and counts.shape == (n_tiles,)
           and counts.is_contiguous() and counts.device == dev,
           "counts must be a contiguous int32[T] tensor beside elems")
    checks = (shift_cur, shift_prev, expected)
    _check(all(t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous()
               and t.device == dev and t.shape == shift_cur.shape
               for t in checks),
           "the check tables must be contiguous int32[C] tensors beside "
           "elems")
    _check(recovery.dtype == torch.int32 and recovery.shape == (2,)
           and recovery.is_contiguous() and recovery.device == dev,
           "recovery must be a contiguous int32[2] tensor beside elems")
    _check(1 <= length <= tile_elems + 1,
           "a slot holds its tile and at most one tile more: length - 1 "
           "must not exceed tile_elems")
    _check(k_cap >= 1 and p_cap >= 0 and k_cap * tile_elems < 2**31,
           "bad k_cap or p_cap")
    valid_count = int(valid_count)
    if not _kernel_device(elems):
        return hot_combo_plain(
            elems, counts, valid_count, shift_cur, shift_prev, expected,
            recovery, tile_elems=tile_elems, length=length,
            signed_compare=signed_compare, k_cap=k_cap, p_cap=p_cap,
        )
    from ._build import load_library

    lib = load_library()
    width = elems.element_size()
    n_combo = COMBO_HEADER + 2 * k_cap + 3 * p_cap
    scratch = lib.mm_hot_combo_scratch_words(k_cap, p_cap, tile_elems,
                                             width, n_tiles)
    buf = torch.empty(n_combo + scratch, dtype=torch.int32, device=dev)
    vt2, vr2 = divmod(valid_count, tile_elems)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_hot_combo(
            elems.data_ptr(), elems.numel() * width, width,
            counts.data_ptr(), n_tiles, tile_elems, length, vt2, vr2,
            shift_cur.data_ptr(), shift_prev.data_ptr(), expected.data_ptr(),
            int(shift_cur.shape[0]), int(bool(signed_compare)),
            recovery.data_ptr(), k_cap, p_cap, buf.data_ptr(),
            buf.data_ptr() + 4 * n_combo, stream,
        )
    _raise_on(rc, "hot_combo")
    launch_counts["hot_combo"] += 1
    profiling.count("step.tail_kernel", 1)
    return buf[:n_combo]


def hot_combo_plain(
    elems, counts, valid_count, shift_cur, shift_prev, expected, recovery,
    *, tile_elems, length, signed_compare, k_cap, p_cap,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`hot_combo`
    (:func:`scan_torch.hot_tail`; reads the shift tables back to the
    host)."""
    return scan_torch.hot_tail(
        elems, counts, valid_count,
        tuple(zip(shift_cur.tolist(), shift_prev.tolist())), expected,
        recovery, tile_elems=tile_elems, length=length,
        signed_compare=signed_compare, k_cap=k_cap, p_cap=p_cap,
    )


def derive_words(raw: torch.Tensor, byte_shift: int, element_width: int,
                 big: bool) -> torch.Tensor:
    """Kernel M: ``int32[n]`` grid words from ``raw``, the ``n + 1``
    little-endian int32 words of a byte stream (the last one only borrowed
    from): word ``i`` is ``raw[i]`` and ``raw[i + 1]`` shifted right
    together by ``8 * byte_shift`` bits, then, when ``element_width`` is 2
    and ``big``, byte-swapped within each 16-bit half.  One launch on the
    current stream; under a profiler it counts ``corpus.derive_kernel``
    and ``corpus.derive_bytes`` (``8 n``: every word read once and written
    once)."""
    _check(raw.dtype == torch.int32 and raw.dim() == 1
           and raw.is_contiguous() and raw.numel() >= 1,
           "raw must be a contiguous 1-D int32 tensor of at least 1 word")
    _check(byte_shift in (0, 1, 2, 3),
           f"byte_shift must be 0 to 3, got {byte_shift}")
    _check(element_width in (1, 2),
           f"element_width must be 1 or 2, got {element_width}")
    if not _kernel_device(raw):
        return derive_words_plain(raw, byte_shift, element_width, big)
    from ._build import load_library

    lib = load_library()
    n = raw.numel() - 1
    out = torch.empty(n, dtype=torch.int32, device=raw.device)
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_derive_words(raw.data_ptr(), n, byte_shift,
                                 int(element_width == 2 and big),
                                 out.data_ptr(), stream)
    _raise_on(rc, "derive_words")
    launch_counts["derive_words"] += 1
    profiling.count("corpus.derive_kernel", 1)
    profiling.count("corpus.derive_bytes", 8 * n)
    return out


def derive_words_plain(raw, byte_shift, element_width, big) -> torch.Tensor:
    """Plain PyTorch version of :func:`derive_words` (a view of
    ``raw[:-1]`` where there is no shift and no swap).  Torch's ``>>`` on
    int32 is arithmetic, so every right shift is masked."""
    swap = element_width == 2 and big
    w = raw[:-1]
    if byte_shift:
        k = 8 * byte_shift
        low = (w >> k) & ((1 << (32 - k)) - 1)
        w = low | (raw[1:] << (32 - k))
    if swap:
        # byte swap within each 16-bit element
        high = (w << 8) & (0xFF00FF00 - (1 << 32))  # as signed int32
        w = ((w >> 8) & 0x00FF00FF) | high
    return w


_multi_memo: dict = {}
_multi_memo_lock = threading.Lock()


def multi_operand(
    pats: List[CompiledPattern], valid_count: int, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel C's operands for a keyword batch on *device*: the ``(K, 4, C)``
    int32 check table (rows ``cur``, ``prev``, ``expected`` in the element
    dtype, ``active`` 1/0, from :func:`host.canonical_check_tables` padded
    by :func:`host.multi_pattern_tables`) and ``last_start = valid_count -
    length`` as int64[K].  Memoized per (batch, valid count, device) as the
    reference's ``_MULTI_MEMO``: a batch re-scanned chunk after chunk
    uploads its operands once (``compile_pattern`` memoizes, so identical
    keywords give identical pattern objects; the memo holds them, so ids
    stay stable)."""
    return _multi_entry(pats, valid_count, device)[1:3]


def _multi_entry(pats, valid_count: int, device) -> tuple:
    """The memo entry of :func:`multi_operand`: ``(pats, table,
    last_starts, (windows, first_windows))``, the last two C's window
    starts by :func:`_window_counts`."""
    key = (tuple(id(p) for p in pats), valid_count, str(torch.device(device)))
    with _multi_memo_lock:
        hit = _multi_memo.get(key)
    if hit is not None:
        return hit
    pair_sets, exp_list, active_list = canonical_check_tables(pats)
    pairs_padded, exp_mat, act_mat = multi_pattern_tables(
        pair_sets, exp_list, active_list
    )
    table = np.zeros((len(pats), 4, exp_mat.shape[1]), dtype=np.int64)
    table[:, 0] = [[c for c, _ in prs] for prs in pairs_padded]
    table[:, 1] = [[p for _, p in prs] for prs in pairs_padded]
    table[:, 2] = exp_mat
    table[:, 3] = act_mat
    last_starts = [valid_count - p.length for p in pats]
    entry = (
        tuple(pats),
        torch.tensor(table, dtype=torch.int32, device=device),
        torch.tensor(last_starts, dtype=torch.int64, device=device),
        _window_counts(table, last_starts),
    )
    with _multi_memo_lock:
        if len(_multi_memo) >= 64:
            _multi_memo.clear()
        _multi_memo[key] = entry
    return entry


def _window_counts(table: np.ndarray, last_starts: List[int]
                   ) -> Tuple[int, int]:
    """``(windows, first_windows)`` of one launch of kernel C: the window
    starts of every pattern with an active check, summed, and those of
    each distinct first check pair, the largest of the patterns that begin
    with it, summed (``counts_bench.first_pairs``: C computes a pair's
    diff once for the patterns that share it)."""
    windows, firsts = 0, {}
    for (cur, prev, _, active), last in zip(table, last_starts):
        on = np.flatnonzero(active)
        if len(on):
            n = max(0, last + 1)
            pair = (int(cur[on[0]]), int(prev[on[0]]))
            windows += n
            firsts[pair] = max(firsts.get(pair, 0), n)
    return windows, sum(firsts.values())


def tile_counts_multi(
    words: torch.Tensor,
    table: torch.Tensor,
    last_starts: torch.Tensor,
    *,
    width: int,
    tile_elems: int,
) -> torch.Tensor:
    """Kernel C: ``(K, T)`` int32 prefilter match counts per pattern and
    tile, in one pass over ``words`` (packed little-endian words holding
    ``(T+1) * tile_elems`` u8 or u16 elements).  ``table`` and
    ``last_starts``: :func:`multi_operand`.  Window start ``e`` of tile
    ``t`` counts for pattern ``k`` when ``e <= last_starts[k]`` and every
    active check of row ``k`` holds mod 2^(8*width)."""
    n_tiles = _tile_geometry(words, width, tile_elems)
    _check(table.dtype == torch.int32 and table.dim() == 3
           and table.shape[1] == 4 and table.is_contiguous()
           and table.device == words.device,
           "table must be a contiguous (K, 4, C) int32 tensor beside words")
    K = table.shape[0]
    _check(last_starts.dtype == torch.int64 and last_starts.shape == (K,)
           and last_starts.device == words.device,
           "last_starts must be int64[K] beside words")
    if not _kernel_device(words):
        return tile_counts_multi_plain(
            words, table, last_starts, width=width, tile_elems=tile_elems
        )
    from ._build import load_library

    lib = load_library()
    out = torch.empty((K, n_tiles), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_tile_counts_multi(
            words.data_ptr(), n_tiles, tile_elems, width, table.data_ptr(),
            K, int(table.shape[2]), last_starts.data_ptr(), out.data_ptr(),
            stream,
        )
    _raise_on(rc, "tile_counts_multi")
    launch_counts["tile_counts_multi"] += 1
    return out


def tile_counts_multi_plain(
    words, table, last_starts, *, width, tile_elems
) -> torch.Tensor:
    """Plain PyTorch version of :func:`tile_counts_multi` (reads the table
    and the limits back to the host)."""
    x = widen(as_elements(words, width))
    rows = []
    for (cur, prev, exp, act), last in zip(table.tolist(),
                                           last_starts.tolist()):
        # count_body's limit is valid_count - length: pass last_start, 0
        rows.append(count_body(x, last, exp, list(zip(cur, prev)), 0,
                               tile_elems, width, act))
    return torch.stack(rows)


def tile_counts_multi_gather(
    pats: List[CompiledPattern],
    words: torch.Tensor,
    valid_count: int,
    tile_elems: int,
    k_cap: int,
    p_cap: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused phases 1 + 2 for a keyword batch over one grid chunk
    (``_swar_multi_gather_call``), enqueued with no host sync: kernel C
    counts every pattern in one pass, then kernel L re-checks each
    pattern's hot tiles exactly.  Returns device tensors
    ``(counts (K, T) int32, combos int32)``: the K per-pattern combo
    buffers concatenated, the batch's one device→host copy.

    Under a profiler it counts, for C's call (a launch on the card, the
    plain version on the CPU), ``kernel.counts_multi`` (1),
    ``kernel.counts_multi_bytes`` (the words' bytes, read once) and the
    window starts of :func:`_window_counts`: ``kernel.counts_multi_windows``
    and ``kernel.counts_multi_first_windows``."""
    _, table, last_starts, (windows, first_windows) = _multi_entry(
        pats, valid_count, words.device)
    profiling.count("kernel.counts_multi", 1)
    profiling.count("kernel.counts_multi_bytes", 4 * words.numel())
    profiling.count("kernel.counts_multi_windows", windows)
    profiling.count("kernel.counts_multi_first_windows", first_windows)
    counts = tile_counts_multi(
        words, table, last_starts, width=np.dtype(pats[0].dtype).itemsize,
        tile_elems=tile_elems,
    )
    return counts, torch.cat([
        _fused_tail(pat, words, counts[k], valid_count, tile_elems, k_cap,
                    p_cap)
        for k, pat in enumerate(pats)
    ])


def load_sum(
    words: torch.Tensor, tile_words: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernels I and J, the speed-of-light load: ``(sums, total)``, the
    int32 sum of each of the ``NT = words.numel() // tile_words`` whole
    tiles of ``tile_words`` words and the 0-d int32 total of those sums,
    both with int32 wraparound (the TPU kernel's ``jnp.sum`` of each
    ``(2048, 256)`` block and ``load_call``'s sum of the block sums).
    Words past the last whole tile are not read."""
    _check(words.dtype == torch.int32 and words.dim() == 1
           and words.is_contiguous(),
           "words must be a contiguous 1-D int32 tensor")
    _check(tile_words > 0, "tile_words must be positive")
    if not _kernel_device(words):
        return load_sum_plain(words, tile_words)
    from ._build import load_library

    lib = load_library()
    n_tiles = words.numel() // tile_words
    sums = torch.empty(n_tiles, dtype=torch.int32, device=words.device)
    total = torch.empty((), dtype=torch.int32, device=words.device)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_load_sum(words.data_ptr(), n_tiles, tile_words,
                             sums.data_ptr(), total.data_ptr(), stream)
    _raise_on(rc, "load_sum")
    launch_counts["load_sum"] += 1
    return sums, total


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced mod 2^32 into int32's range."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def load_sum_plain(words, tile_words) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`load_sum`: the tiles summed in int64
    and wrapped to int32."""
    n_tiles = words.numel() // tile_words
    sums = _wrap_int32(words[: n_tiles * tile_words].view(
        n_tiles, tile_words).sum(1, dtype=torch.int64))
    return sums, _wrap_int32(sums.sum(dtype=torch.int64))


#: window starts per span of kernel K (``kSpan`` in
#: ``csrc/match_compact.cu``, which refuses a scratch size computed with
#: another): the unit of its per-span counts, of the one-block scan of their
#: first ranks, and of its ordered emit
MATCH_SPAN = 65536

#: hits kernel K keeps per span in its scratch (``kList``): the emit writes
#: a span of no more hits from its list, and tests a denser one again
MATCH_LIST = 64


def match_spans(n: int, valid_count: int, length: int) -> int:
    """Spans of kernel K over ``n`` elements: ``ceil(W / MATCH_SPAN)`` for
    the ``W`` window starts at or below ``min(valid_count, n) - length``."""
    windows = max(0, min(valid_count, n) - length + 1)
    return -(-windows // MATCH_SPAN)


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
    """Kernel K: ``(count, offsets[capacity], values[capacity, 2])`` of the
    exact scan of a u8/u16 element array (``scan_jnp.scan_chunk``; the
    contract of :func:`scan_torch.scan_chunk`): the true match count, the
    first ``capacity`` window starts that match every check, ascending, -1
    past the count, and each slot's two recovery elements.  The tables are
    :func:`scan_torch.pattern_device_args`' int32 tensors beside ``data``;
    ``valid_count`` is a host int, so nothing waits on the card.  Offsets
    are int32, so ``data`` holds fewer than 2^31 elements."""
    _check(data.dtype in (torch.uint8, torch.uint16) and data.dim() == 1
           and data.is_contiguous(),
           "data must be a contiguous 1-D uint8 or uint16 tensor")
    n = data.numel()
    _check(0 < n < 2**31, f"{n} elements: scan_chunk takes 1 to 2^31 - 1")
    checks = (shift_cur, shift_prev, expected)
    _check(all(t.dtype == torch.int32 and t.dim() == 1 and t.is_contiguous()
               and t.device == data.device
               and t.shape == shift_cur.shape for t in checks),
           "the check tables must be contiguous int32[C] tensors beside data")
    _check(recovery.dtype == torch.int32 and recovery.shape == (2,)
           and recovery.is_contiguous() and recovery.device == data.device,
           "recovery must be a contiguous int32[2] tensor beside data")
    _check(length >= 1 and capacity >= 0, "bad length or capacity")
    valid_count = int(valid_count)
    if not _kernel_device(data):
        return scan_chunk_plain(
            data, valid_count, shift_cur, shift_prev, expected, recovery,
            length=length, signed_compare=signed_compare, capacity=capacity,
        )
    from ._build import load_library

    out = launch_match_compact(
        load_library(), data, valid_count, shift_cur, shift_prev, expected,
        recovery, length=length, signed_compare=signed_compare,
        capacity=capacity,
    )
    launch_counts["scan_chunk"] += 1
    return out


def launch_match_compact(
    lib, data, valid_count, shift_cur, shift_prev, expected, recovery, *,
    length, signed_compare, capacity,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of *lib*'s kernel K (``mm_match_compact``) on operands
    that :func:`scan_chunk` has checked; returns ``(count, offsets,
    values)``.  Raises on a CUDA error."""
    n = data.numel()
    n_spans = match_spans(n, valid_count, length)
    dev = data.device
    scratch = torch.empty(max(1, n_spans * (2 + MATCH_LIST)),
                          dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    offsets = torch.empty(capacity, dtype=torch.int32, device=dev)
    values = torch.empty((capacity, 2), dtype=data.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_match_compact(
            data.data_ptr(), n, data.element_size(), valid_count - length,
            length, shift_cur.data_ptr(), shift_prev.data_ptr(),
            expected.data_ptr(), int(shift_cur.shape[0]),
            int(bool(signed_compare)), recovery.data_ptr(), capacity,
            n_spans, scratch.data_ptr(), count.data_ptr(),
            offsets.data_ptr(), values.data_ptr(), stream,
        )
    _raise_on(rc, "scan_chunk")
    return count, offsets, values


def scan_chunk_plain(
    data, valid_count, shift_cur, shift_prev, expected, recovery, *, length,
    signed_compare, capacity,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`scan_chunk`
    (:func:`scan_torch.scan_chunk`)."""
    return scan_torch.scan_chunk(
        data, valid_count, shift_cur, shift_prev, expected, recovery,
        length=length, signed_compare=signed_compare, capacity=capacity,
    )
