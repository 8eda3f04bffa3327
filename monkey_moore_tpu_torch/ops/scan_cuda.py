"""The fused device step's kernels — counterpart of the JAX package's
``ops/scan_pallas.py`` (the main path's part of it).

Two kernels, hand-written in CUDA C++ for Hopper (``csrc/``):

- :func:`tile_counts` (kernel A, ``csrc/tile_counts.cu``) replaces
  ``scan_pallas._tile_counts_swar_call``;
- :func:`gather_tiles` (kernel B, ``csrc/gather_tiles.cu``) replaces
  ``scan_pallas._gather_tiles_dma_call``.

Each wrapper checks its operands, allocates its output, and launches its
kernel on the current stream for a CUDA tensor, or runs its plain PyTorch
version (``*_plain``, same module) for a CPU tensor; any other device
raises.  :data:`launch_counts` counts kernel launches, so a run can show
that it went through the kernels.

:func:`tile_counts_gather` is the counterpart of ``tile_counts_gather_pallas``
with ``_swar_counts_gather_call`` and ``_hot_slots_and_combo``: counts,
hot-tile selection, gather, unpack, exact phase 2 and the combo buffer,
all enqueued with no host sync.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from monkey_moore_tpu.pattern import CompiledPattern

from .host import prefilter_checks
from .scan_torch import (
    as_elements,
    count_body,
    exact_phase2,
    nonzero_capped,
    operand_cache,
    pack_combo,
    pattern_device_args,
    widen,
)

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "prefilter_operand",
    "tile_counts",
    "tile_counts_plain",
    "gather_tiles",
    "gather_tiles_plain",
    "tile_counts_gather",
]

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
launch_counts = {"tile_counts": 0, "gather_tiles": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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
    dtype, mod 2^width) — kernel A's check operand.  Memoized per pattern."""
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


def _counts_geometry(words, checks, width, tile_elems, valid_count):
    _check(words.dtype == torch.int32 and words.dim() == 1
           and words.is_contiguous(),
           "words must be a contiguous 1-D int32 tensor")
    _check(width in (1, 2), f"width must be 1 or 2, got {width}")
    _check(checks.dtype == torch.int32 and checks.dim() == 2
           and checks.shape[0] == 3 and checks.is_contiguous()
           and checks.device == words.device,
           "checks must be a contiguous (3, C) int32 tensor beside words")
    n_elems = words.numel() * 4 // width
    _check(tile_elems > 0 and n_elems % tile_elems == 0
           and n_elems >= 2 * tile_elems,
           f"{n_elems} elements are not T+1 >= 2 tiles of {tile_elems}")
    _check(valid_count <= n_elems, "valid_count exceeds the buffer")
    return n_elems // tile_elems - 1


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
    from ._build import load_library

    lib = load_library()
    k_cap = hot.shape[0]
    out = torch.empty(
        (k_cap, 2 * tile_bytes), dtype=torch.uint8, device=words.device
    )
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.mm_gather_tiles(
            words.data_ptr(), words.numel() * words.element_size(),
            hot.data_ptr(), k_cap, tile_bytes, out.data_ptr(), stream,
        )
    _raise_on(rc, "gather_tiles")
    launch_counts["gather_tiles"] += 1
    return out


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
    counts, then ``nonzero_capped`` picks the first ``k_cap`` hot tiles,
    kernel B gathers each with its halo tile, the exact phase 2 re-checks
    every window of the slots with the full check tables, and the combo
    buffer packs header, hot ids and counts, candidate offsets and recovery
    values (layout ``host.COMBO_HEADER``)."""
    width = np.dtype(pat.dtype).itemsize
    L = pat.length
    counts = tile_counts(
        words, prefilter_operand(pat, words.device), width=width,
        tile_elems=tile_elems, length=L, valid_count=valid_count,
    )
    hot = nonzero_capped(counts, k_cap)
    nhot = (counts > 0).sum(dtype=torch.int32)
    raw = gather_tiles(words, hot, width=width, tile_elems=tile_elems)
    slots = raw.view(torch.uint8 if width == 1 else torch.uint16)
    _, _, exp_exact, recovery = pattern_device_args(pat, words.device)
    n_cand, flat_idx, v0, v1 = exact_phase2(
        slots[:, : tile_elems + L - 1], hot, nhot,
        valid_count // tile_elems, valid_count % tile_elems,
        tile_elems=tile_elems, length=L,
        pairs_exact=tuple(
            (int(c), int(p))
            for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)
        ),
        expected=exp_exact, signed_compare=pat.signed_compare,
        recovery=recovery, p_cap=p_cap,
    )
    return counts, pack_combo(counts, hot, nhot, n_cand, flat_idx, v0, v1)
