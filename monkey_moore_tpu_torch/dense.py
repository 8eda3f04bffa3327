"""Single-device dense search — counterpart of the JAX package's
``dense.py``.

**In-memory search.** :func:`dense_search` is the equivalent of the
reference's ``MonkeyMoore<Ty>::search``: a u8/u16 element array in memory
goes in, ``(offset, equivalency map)`` pairs come out, with GREEDY, ALL or
REFERENCE semantics.  :func:`two_phase_candidates` (and its alias
:func:`dense_candidates`) pads the array to whole count tiles, uploads it
to ``device``, counts per tile on the device (kernel D) and extracts the
exact offsets of the hot tiles on the host.

**The fused step.** One step scans one grid chunk:
:func:`fused_count_extract_start` enqueues the per-tile prefilter counts,
the hot-tile gather and the exact phase 2 on the device and returns at
once; :func:`fused_count_extract_finish` copies the step's combo buffer to
the host — the step's only sync point — and decodes offsets and recovery
values.  When more than ``k_cap`` tiles are hot or more than ``p_cap``
candidates match, the finish fetches the full counts and runs the batched
host extraction instead (:func:`extract_hot_tiles_device`).

**Route rule.** The operand picks the kernels, never a probe: packed int32
words (the resident corpus) go through kernels A and B; any u8/u16 element
tensor of a pattern with at least one check goes through kernels D and E
(in-memory arrays, the engine's streaming chunks), whatever its check
shifts — D stages a whole halo tile, so unlike the TPU kernel it takes
every shift below the pattern length.  All-wildcard patterns (no check)
count on the host.

:func:`fused_count_extract_multi` is the keyword-batch step of
``multi.MultiSearcher``: one pass of kernel C counts every keyword, then
each keyword's hot tiles take the same gather and exact phase 2.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .carry import require_own
from .config import MatchSemantics
from .ops.host import (
    _EMPTY,
    LANES,
    TILE_ELEMS,
    FusedInfo,
    _combo_info,
    _gather_fallback_bytes,
    _parse_combo,
    _prefilter_sel,
    auto_k_cap,
    canonical_check_tables,
    extract_hot_tiles,
)
from .ops.scan_cuda import (
    prefilter_operand,
    tile_counts_elems,
    tile_counts_gather,
    tile_counts_gather_elems,
    tile_counts_multi_gather,
)
from .ops.scan_cuda import tile_counts as _kernel_tile_counts
from .ops.recover import recover_from_values, recovery_shifts
from .ops.scan_np import match_positions_np
from .ops.suppress import greedy_suppress
from .oracle import oracle_search
from .pattern import CompiledPattern

__all__ = [
    "TILE_ELEMS",
    "FusedInfo",
    "FusedPending",
    "resolve_device",
    "upload_elements",
    "wants_packed",
    "tile_counts",
    "fused_count_extract_start",
    "fused_count_extract_finish",
    "fused_count_extract",
    "fused_multi_eligible",
    "fused_count_extract_multi",
    "extract_hot_tiles_device",
    "two_phase_candidates",
    "dense_candidates",
    "dense_search",
]

Result = Tuple[int, Dict[int, int]]


def resolve_device(device, owner: str) -> torch.device:
    """*device* as a ``torch.device``: ``"cuda"`` (the card's kernels; needs
    a card) or ``"cpu"`` (the kernels' plain versions); anything else
    raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{owner}: CUDA is not available")
    elif device.type != "cpu":
        raise RuntimeError(f"{owner}: no kernels for {device}")
    return device


def upload_elements(arr: np.ndarray, device, n_elems: int | None = None
                    ) -> torch.Tensor:
    """A host u8/u16 element array as a 1-D element tensor of ``n_elems``
    (default ``len(arr)``) elements on *device*, zero past ``len(arr)``.
    u16 travels through an int16 view, as ``scan_torch.widen`` reads it."""
    arr = np.ascontiguousarray(arr)
    n = len(arr)
    n_elems = n if n_elems is None else n_elems
    wide = arr.dtype.itemsize == 2
    out = torch.empty(n_elems, dtype=torch.int16 if wide else torch.uint8,
                      device=device)
    out[n:].zero_()
    src = arr
    if n and not arr.flags.writeable:
        # a read-only array (a memmap, a decoded chunk): torch.from_numpy
        # warns on it, so alias its memory writably (``arr`` stays alive
        # and owns it); the copy only reads it
        alias = (ctypes.c_char * arr.nbytes).from_address(arr.ctypes.data)
        src = np.frombuffer(alias, dtype=arr.dtype)
    out[:n].copy_(torch.from_numpy(src.view(np.int16) if wide else src))
    return out.view(torch.uint16) if wide else out


def _own(pat, what: str) -> CompiledPattern:
    """*pat* if it is the port's ``CompiledPattern``, else ``TypeError``:
    a JAX-package pattern would match none of the port's ``SearchMode``
    branches."""
    return require_own(pat, CompiledPattern, what)


def _packed(pat: CompiledPattern, arr: torch.Tensor) -> bool:
    return arr.dtype == torch.int32 and np.dtype(pat.dtype).itemsize < 4


def _check_elements(pat: CompiledPattern, arr: torch.Tensor) -> None:
    if arr.element_size() != np.dtype(pat.dtype).itemsize:
        raise ValueError(
            f"a {np.dtype(pat.dtype).name} pattern cannot scan {arr.dtype}"
        )


def wants_packed(pat: CompiledPattern) -> bool:
    """True when a resident grid should be derived as packed little-endian
    int32 words (kernels A and B: every pattern with at least one check);
    all-wildcard patterns take element arrays."""
    pairs, _, _ = _prefilter_sel(pat)
    return bool(pairs)


def tile_counts(
    pat: CompiledPattern,
    arr_device: torch.Tensor,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
) -> np.ndarray:
    """Phase 1 alone: int32[T] prefilter counts per tile, on the host.

    ``arr_device`` holds ``(T+1) * tile_elems`` elements (T counted tiles
    plus one halo tile): packed words (kernel A) or u8/u16 elements
    (kernel D)."""
    _own(pat, "tile_counts")
    width = np.dtype(pat.dtype).itemsize
    packed = _packed(pat, arr_device)
    if not packed:
        _check_elements(pat, arr_device)
    n_elems = arr_device.numel() * (4 // width if packed else 1)
    num_tiles = n_elems // tile_elems - 1
    pairs, _, _ = _prefilter_sel(pat)
    if not pairs:
        # no literal checks (all-wildcard keyword): every valid window
        # matches; count directly
        starts = np.arange(num_tiles) * tile_elems
        last_valid = valid_count - pat.length  # inclusive
        return np.clip(last_valid + 1 - starts, 0, tile_elems).astype(
            np.int32
        )
    checks = prefilter_operand(pat, arr_device.device)
    if packed:
        counts = _kernel_tile_counts(
            arr_device, checks, width=width, tile_elems=tile_elems,
            length=pat.length, valid_count=valid_count,
        )
    else:
        counts = tile_counts_elems(
            arr_device, checks, tile_elems=tile_elems, length=pat.length,
            valid_count=valid_count,
        )
    return counts.cpu().numpy()


class FusedPending(NamedTuple):
    """An in-flight fused step: device tensors whose computation may still
    be running, plus what :func:`fused_count_extract_finish` needs to fetch
    and decode them.  ``eager`` holds an already-final result for the
    all-wildcard branch, which cannot pipeline."""

    counts_dev: object
    combo_dev: object
    pat: object
    arr_device: object
    valid_count: int
    tile_elems: int
    grid_offset: int
    k_cap: int
    p_cap: int
    eager: tuple = None


def fused_count_extract_start(
    pat: CompiledPattern,
    arr_device: torch.Tensor,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
    k_cap: int | None = None,
    p_cap: int = 1024,
) -> FusedPending:
    """Enqueue phases 1 + 2 of one step WITHOUT fetching the result, so the
    caller can enqueue the next chunk first.  ``arr_device``: the chunk's
    ``(T+1) * tile_elems`` elements, as packed words (kernels A and B) or
    u8/u16 elements (kernels D and E)."""
    _own(pat, "fused_count_extract_start")
    pairs, _, _ = _prefilter_sel(pat)
    if k_cap is None:
        k_cap = auto_k_cap(pat, valid_count, tile_elems, len(pairs))
    if not pairs:
        # all-wildcard keywords match every window — every tile is hot, so
        # fusion buys nothing: count on the host, extract every tile
        counts = tile_counts(pat, arr_device, valid_count, tile_elems)
        offs, vals = extract_hot_tiles_device(
            pat, arr_device, counts, valid_count, tile_elems, grid_offset
        )
        n_hot = int((counts > 0).sum())
        info = FusedInfo(
            n_hot, int(counts.sum()), candidates=len(offs), fallback=True,
            d2h_bytes=counts.nbytes + _gather_fallback_bytes(
                pat, n_hot, tile_elems
            ),
        )
        return FusedPending(
            None, None, pat, arr_device, valid_count, tile_elems,
            grid_offset, k_cap, p_cap, eager=(offs, vals, info),
        )
    if _packed(pat, arr_device):
        step = tile_counts_gather
    else:
        _check_elements(pat, arr_device)
        step = tile_counts_gather_elems
    counts_dev, combo_dev = step(
        pat, arr_device, valid_count, tile_elems, k_cap, p_cap
    )
    return FusedPending(
        counts_dev, combo_dev, pat, arr_device, valid_count, tile_elems,
        grid_offset, k_cap, p_cap,
    )


def fused_count_extract_finish(
    pending: FusedPending,
) -> Tuple[np.ndarray, np.ndarray, FusedInfo]:
    """Fetch and decode an in-flight step (the blocking half): ONE
    device→host copy of the combo buffer, or on capacity overflow the full
    counts and the batched hot-tile fetch."""
    if pending.eager is not None:
        return pending.eager
    return _decode_step(
        pending.pat, pending.combo_dev.cpu().numpy(), pending.counts_dev,
        pending.arr_device, pending.valid_count, pending.tile_elems,
        pending.grid_offset, pending.k_cap, pending.p_cap,
    )


def _decode_step(pat, combo, counts_dev, arr_device, valid_count,
                 tile_elems, grid_offset, k_cap, p_cap):
    """One pattern's fetched combo buffer → ``(offsets, values, info)``; on
    capacity overflow, fetch its counts and extract on the host."""
    info = _combo_info(combo, k_cap, p_cap)
    if info.hot_tiles == 0:
        return *_EMPTY, info
    if info.fallback:
        counts_np = counts_dev.cpu().numpy()
        offs, vals = extract_hot_tiles_device(
            pat, arr_device, counts_np, valid_count, tile_elems, grid_offset,
        )
        info = info._replace(
            candidates=len(offs),
            d2h_bytes=info.d2h_bytes + counts_np.nbytes
            + _gather_fallback_bytes(
                pat, int((counts_np > 0).sum()), tile_elems
            ),
        )
        return offs, vals, info
    offsets, values = _parse_combo(
        combo, k_cap, p_cap, tile_elems, grid_offset
    )
    return offsets, values, info


def fused_count_extract(
    pat: CompiledPattern,
    arr_device: torch.Tensor,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
    k_cap: int | None = None,
    p_cap: int = 1024,
) -> Tuple[np.ndarray, np.ndarray, FusedInfo]:
    """Phases 1 + 2 for one device-resident chunk: ``(offsets, values,
    info)``, offsets ascending, values the two recovery values per match."""
    return fused_count_extract_finish(
        fused_count_extract_start(
            pat, arr_device, valid_count, tile_elems=tile_elems,
            grid_offset=grid_offset, k_cap=k_cap, p_cap=p_cap,
        )
    )


def fused_multi_eligible(
    pats: List[CompiledPattern], tile_elems: int = TILE_ELEMS
) -> bool:
    """True when :func:`fused_count_extract_multi` runs this batch: the
    reference's rules (one element width, ``tile_elems`` a multiple of
    ``8 * LANES``, every pattern with a check, every check shift below
    ``LANES``), so the port takes the fused route for exactly the batches
    the TPU does.  The reference's Mosaic compute-mode test has no
    counterpart here."""
    for pat in pats:
        _own(pat, "fused_multi_eligible")
    width = np.dtype(pats[0].dtype).itemsize
    if any(np.dtype(p.dtype).itemsize != width for p in pats):
        return False
    if tile_elems % (8 * LANES) != 0:
        return False
    pair_sets, _, _ = canonical_check_tables(pats)
    if any(len(prs) == 0 for prs in pair_sets):
        return False
    if any(cs >= LANES for prs in pair_sets for cs, _ in prs):
        return False
    return True


def fused_count_extract_multi(
    pats: List[CompiledPattern],
    arr_device: torch.Tensor,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    k_cap: int | None = None,
    p_cap: int = 1024,
    grid_offset: int = 0,
) -> List[Tuple[np.ndarray, np.ndarray, FusedInfo]] | None:
    """Fused phases 1 + 2 for MANY patterns over one chunk of packed words:
    kernel C counts every pattern in one pass, each pattern's hot tiles are
    gathered and exactly re-checked on the device, and the K result buffers
    come back in ONE device→host copy.  Returns ``(offsets, values, info)``
    per pattern, or None when the batch is not eligible or the chunk is not
    packed (callers take the element-wise multi count instead).  A pattern
    whose capacities overflow fetches its counts and runs
    :func:`extract_hot_tiles_device`."""
    if not fused_multi_eligible(pats, tile_elems):
        return None
    if arr_device.dtype != torch.int32:
        return None
    if k_cap is None:
        _, _, active_list = canonical_check_tables(pats)
        k_cap = max(
            auto_k_cap(pat, valid_count, tile_elems,
                       int(np.count_nonzero(act)))
            for pat, act in zip(pats, active_list)
        )
    counts_dev, combos_dev = tile_counts_multi_gather(
        pats, arr_device, valid_count, tile_elems, k_cap, p_cap
    )
    combos = combos_dev.cpu().numpy().reshape(len(pats), -1)
    return [
        _decode_step(pat, combos[k], counts_dev[k], arr_device, valid_count,
                     tile_elems, grid_offset, k_cap, p_cap)
        for k, pat in enumerate(pats)
    ]


def extract_hot_tiles_device(
    pat: CompiledPattern,
    arr_device: torch.Tensor,
    counts: np.ndarray,
    valid_count: int,
    tile_elems: int = TILE_ELEMS,
    grid_offset: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Phase 2 on the host for the degraded steps: fetch only the hot
    tiles' spans (``tile_elems + L - 1`` elements each) in ONE batched
    device→host copy and run the exact matcher on them.  ``arr_device`` is
    the step's buffer, packed words or u8/u16 elements."""
    _own(pat, "extract_hot_tiles_device")
    L = pat.length
    itemsize = np.dtype(pat.dtype).itemsize
    packed = _packed(pat, arr_device)
    elems_per_word = 4 // itemsize
    total = arr_device.numel() * (elems_per_word if packed else 1)
    shifts = recovery_shifts(pat)
    hot = np.nonzero(counts)[0]
    if len(hot) == 0:
        return _EMPTY

    # the hot count is padded to the next power of two (duplicated last
    # tile), as in the reference, so its d2h accounting matches
    span_elems = tile_elems + L - 1
    if packed:
        span_w = span_elems // elems_per_word + 2
        w0s = hot * (tile_elems // elems_per_word)
    else:
        span_w = span_elems
        w0s = hot * tile_elems
    n_pad = 1 << int(len(hot) - 1).bit_length()
    w0s_pad = np.concatenate(
        [w0s, np.repeat(w0s[-1:], n_pad - len(w0s))]
    ).astype(np.int64)
    idx = np.clip(
        w0s_pad[:, None] + np.arange(span_w)[None, :],
        0, arr_device.shape[0] - 1,
    )
    index = torch.from_numpy(idx).to(arr_device.device)
    if arr_device.dtype == torch.uint16:
        # CUDA has no uint16 indexing: gather the same bits as int16
        fetched = arr_device.view(torch.int16)[index].cpu().numpy()
        fetched = fetched.view(np.uint16)
    else:
        fetched = arr_device[index].cpu().numpy()

    all_offsets = []
    all_values = []
    for i, t in enumerate(hot.tolist()):
        s0 = t * tile_elems
        s1 = min(total, s0 + tile_elems + L - 1)
        if packed:
            w0, w1 = s0 // elems_per_word, -(-s1 // elems_per_word)
            sl = fetched[i][w0 - w0s_pad[i] : w1 - w0s_pad[i]]
            sl = sl.view(pat.dtype)[s0 - w0 * elems_per_word :][: s1 - s0]
        else:
            sl = fetched[i][s0 - w0s_pad[i] : s1 - w0s_pad[i]]
        # trim device padding past the valid element count
        sl = sl[: max(0, valid_count - s0)]
        pos = match_positions_np(pat, sl)
        pos = pos[pos < tile_elems]
        if len(pos):
            v0 = sl[np.minimum(pos + shifts[0], len(sl) - 1)].astype(np.int64)
            v1 = sl[
                np.minimum(
                    pos + (shifts[1] if len(shifts) > 1 else shifts[0]),
                    len(sl) - 1,
                )
            ].astype(np.int64)
            all_offsets.append(pos + s0)
            all_values.append(np.stack([v0, v1], axis=1))
    if not all_offsets:
        return _EMPTY
    return (
        np.concatenate(all_offsets) + grid_offset,
        np.concatenate(all_values),
    )


def two_phase_candidates(
    pat: CompiledPattern,
    data: np.ndarray,
    tile_elems: int = TILE_ELEMS,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """All matching window offsets in the host element array *data*, plus
    the recovery values ``[M, 2]`` read from the host buffer.

    As the reference: *data* is padded with zeros to ``T+1`` whole count
    tiles (T = its tiles, rounded up; the padding happens on *device*),
    counted per tile on *device* (kernel D, or its plain version on
    ``"cpu"``), and the hot tiles are matched exactly on the host."""
    _own(pat, "two_phase_candidates")
    device = resolve_device(device, "two_phase_candidates")
    data = np.ascontiguousarray(data, dtype=pat.dtype)
    n = len(data)
    if n < pat.length:
        return _EMPTY
    t_count = -(-n // tile_elems)
    arr = upload_elements(data, device, (t_count + 1) * tile_elems)
    counts = tile_counts(pat, arr, n, tile_elems)
    return extract_hot_tiles(pat, data, counts, tile_elems)


def dense_candidates(
    pat: CompiledPattern, data: np.ndarray, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """All matching window offsets in *data*, plus recovery values
    ``[M, 2]``."""
    return two_phase_candidates(pat, data, device=device)


def dense_search(
    pat: CompiledPattern,
    data: np.ndarray,
    semantics: MatchSemantics = MatchSemantics.GREEDY,
    device="cuda",
) -> List[Result]:
    """Search an in-memory element array on *device*; returns
    ``[(offset, values_map), ...]``.

    ``semantics``: ALL (every match), GREEDY (every match, then the
    reference's advance replay; the default) or REFERENCE (the exact
    sequential walker, on the host).  ``device``: ``"cuda"`` or ``"cpu"``
    (the kernels' plain versions); anything else raises."""
    _own(pat, "dense_search")
    require_own(semantics, MatchSemantics, "dense_search: semantics")
    if pat.length < 2:
        raise ValueError("pattern length must be >= 2")
    device = resolve_device(device, "dense_search")
    if semantics is MatchSemantics.REFERENCE:
        return oracle_search(pat, data)
    offsets, values = two_phase_candidates(pat, data, device=device)
    if semantics is MatchSemantics.GREEDY and len(offsets) > 1:
        kept = greedy_suppress(offsets, pat.advance)
        keep_mask = np.isin(offsets, kept)
        offsets = offsets[keep_mask]
        values = values[keep_mask]
    return [
        (int(o), recover_from_values(pat, values[i]))
        for i, o in enumerate(offsets)
    ]
