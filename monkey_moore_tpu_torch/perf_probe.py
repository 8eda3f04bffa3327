"""Roofline and breakdown probe of the PyTorch port's scan on one CUDA card.

The counterpart of the repository's ``tools/perf_probe.py`` (the JAX
package's probe, which stays as it is), with its arguments and its
``emit`` records: one JSON object per line, ``{"probe": name, "ms": ...,
"gbps": ...}``.  Every timing ends in a result fetch to the host (a
scalar, the counts, or the fused step's result buffer), so the device work
is inside it.  The corpus is ``--mb`` MiB of seeded random words generated
on the card (``bench.make_corpus``).

Stages (``--stage``, comma-separated; default ``floor,roofline,kernel``):

  floor     a trivial reduction with a scalar fetch, and the copy of a
            counts-sized array to the host
  roofline  device-memory read speed of light: ``torch.sum`` over the
            corpus, single pass and two passes in one call
  kernel    counts kernel A across ``--tile-rows`` heights (1024 8-bit
            elements per row), counts fetched each iteration
  variants  wildcard ("ab*de"), 16-bit and 12-character-keyword counts
  e2e       the two-call step at 64 KiB count tiles: counts only, hot-tile
            extraction only, full step
  fused     the production fused step (``dense.fused_count_extract``) at
            8 KiB count tiles, "abcde" and "ab*de"
  sol       speed-of-light ratio: counts kernel A against the pure-load
            kernel J (``ops.scan_cuda.load_sum``) at the same 2 MiB tiles
  ab        same-process A/B of the step's tail under the fused
            wildcard step ("ab*de", 8 KiB tiles, the high hot-tile regime):
            kernel L, which reads the hot tiles straight from the chunk
            (``fused``, the default), and the plain tail after kernel E's
            entry on the same bytes (``block``) or ``index_select`` of the
            tile view (``take``, the counterpart of the XLA take); the
            three combo buffers must be equal before any record is
            printed.  Older ``ab_gather_dma_fused_wildcard`` records timed
            kernel B's gather and the plain tail, which no step runs now:
            they do not compare with ``ab_gather_fused_fused_wildcard``

The JAX probe's ``ab`` part (a), its counts-kernel formulation switch, has
no counterpart: the CUDA kernels have one formulation.

``python -m monkey_moore_tpu_torch.perf_probe --mb 4096 --stage all`` runs
on the card; ``--device cpu`` runs the kernels' plain versions, for tests
only.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .bench import make_corpus, sol_times, tile_view
from .dense import (
    FusedPending,
    extract_hot_tiles_device,
    fused_count_extract,
    fused_count_extract_finish,
    fused_count_extract_start,
    resolve_device,
    tile_counts,
)
from .ops import scan_cuda, scan_torch
from .ops.host import LANES, _prefilter_sel, auto_k_cap
from .ops.scan_cuda import launch_counts, reset_launch_counts
from .pattern import compile_pattern

__all__ = ["GATHER_MODES", "STAGES", "emit", "gather_combos", "gather_step",
           "main"]

STAGES = ("floor", "roofline", "kernel", "variants", "e2e", "fused", "sol",
          "ab")
SEED = 0  # the corpus's generator seed

#: the ``ab`` stage's tails of a fused step on packed words: kernel L's,
#: straight from the chunk (``fused``, every search's), and kernel E's
#: entry on the same bytes (``block``) or ``index_select`` of the
#: overlapping tile view (``take``, the counterpart of the JAX step's XLA
#: take), each followed by the plain tail
GATHER_MODES = ("fused", "block", "take")


def emit(name, seconds, nbytes=None, **extra):
    rec = {"probe": name, "ms": seconds * 1e3}
    if nbytes:
        rec["gbps"] = nbytes / seconds / 1e9
    rec.update(extra)
    print(json.dumps(rec), flush=True)


def make_timeit(iters):
    def timeit(fn):
        fn()  # first call / warm
        fn()
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best

    return timeit


def _gathered_tail(pat, words, counts, valid_count, tile_elems, k_cap,
                   p_cap, *, gather: str) -> torch.Tensor:
    """The plain tail after another gather of packed words
    (``_hot_slots_and_combo`` with ``gather_kernel`` "block" or falsy):
    the first ``k_cap`` hot tiles gathered with their halo tiles by kernel
    E's entry on the same bytes (``"block"``) or ``index_select`` of the
    overlapping tile view (``"take"``), then ``scan_torch.slots_combo``."""
    width = np.dtype(pat.dtype).itemsize
    hot = scan_torch.nonzero_capped(counts, k_cap)
    if gather == "block":
        slots = scan_cuda.gather_tiles_block(
            scan_torch.as_elements(words, width), hot, tile_elems=tile_elems)
    else:  # "take": tile t and its halo tile are row t of the view
        tile_bytes = tile_elems * width
        view = words.view(torch.uint8).unfold(0, 2 * tile_bytes, tile_bytes)
        slots = scan_torch.as_elements(torch.index_select(view, 0, hot),
                                       width)
    _, _, exp_exact, recovery = scan_torch.pattern_device_args(
        pat, words.device)
    return scan_torch.slots_combo(
        slots[:, : tile_elems + pat.length - 1], counts, hot, valid_count,
        tuple((int(c), int(p))
              for c, p in zip(pat.chk_shift_cur, pat.chk_shift_prev)),
        exp_exact, recovery, tile_elems=tile_elems, length=pat.length,
        signed_compare=pat.signed_compare, p_cap=p_cap,
    )


def gather_step(pat, words, n: int, tile_elems: int,
                gather: str) -> FusedPending:
    """One fused step in flight with the tail *gather* of
    :data:`GATHER_MODES`: the search's step for ``fused``; otherwise
    kernel A's counts, then :func:`_gathered_tail`.  Only a packed step
    with a check takes another tail than kernel L."""
    if gather == "fused":
        return fused_count_extract_start(pat, words, n, tile_elems=tile_elems)
    if gather not in GATHER_MODES:
        raise ValueError(f"gather must be one of {GATHER_MODES}")
    pairs, _, _ = _prefilter_sel(pat)
    if not pairs or words.dtype != torch.int32:
        raise ValueError("only a packed step with a check takes another "
                         "tail than kernel L")
    k_cap, p_cap = auto_k_cap(pat, n, tile_elems, len(pairs)), 1024
    counts = scan_cuda.tile_counts(
        words, scan_cuda.prefilter_operand(pat, words.device),
        width=np.dtype(pat.dtype).itemsize, tile_elems=tile_elems,
        length=pat.length, valid_count=n,
    )
    tail = _gathered_tail(pat, words, counts, n, tile_elems, k_cap, p_cap,
                          gather=gather)
    return FusedPending(counts, tail, pat, words, n, tile_elems, 0, k_cap,
                        p_cap)


def gather_combos(pat, data, n: int, tile_elems: int) -> dict:
    """The fused step's combo buffer (host int32 array) with each tail of
    :data:`GATHER_MODES` on the same words (:func:`gather_step`)."""
    return {gm: gather_step(pat, data, n, tile_elems,
                            gm).combo_dev.cpu().numpy()
            for gm in GATHER_MODES}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mb", type=int, default=4096, help="corpus MiB (u8)")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument(
        "--stage", default="floor,roofline,kernel",
        help="comma list: " + ",".join(STAGES) + ",all",
    )
    ap.add_argument(
        "--tile-rows", default="256,1024,2048",
        help="comma list of kernel tile heights for the kernel stage",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (plain versions, tests)")
    args = ap.parse_args(argv)
    stages = set(args.stage.split(","))
    if "all" in stages:
        stages = set(STAGES)
    unknown = stages - set(STAGES)
    if unknown:
        print(f"perf_probe: unknown stages: {sorted(unknown)}",
              file=sys.stderr)
        return 2
    if torch.device(args.device).type == "cuda" and not (
            torch.cuda.is_available()):
        print("perf_probe: no CUDA device", file=sys.stderr)
        return 1
    device = resolve_device(args.device, "perf_probe")
    timeit = make_timeit(args.iters)
    on_card = device.type == "cuda"
    print(json.dumps({
        "probe": "device",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "mode": "cuda" if on_card else "plain",
        "mb": args.mb,
    }), flush=True)

    n = args.mb * 1024 * 1024
    tile_rows_list = [int(t) for t in args.tile_rows.split(",")]
    halo = max(tile_rows_list + [2048]) * LANES  # the largest count tile
    t0 = time.perf_counter()
    words = make_corpus(n, SEED, device, halo_bytes=halo)
    int(words[-1])  # the fill is done
    emit("corpus_fill", time.perf_counter() - t0, n)
    flat = words[: n // 4]

    pat = compile_pattern("abcde")  # the reference benchmark keyword

    if "floor" in stages:
        one = torch.ones((8, 128), dtype=torch.int32, device=device)
        emit("dispatch_floor_scalar_fetch",
             timeit(lambda: int(torch.sum(one))))
        counts_sized = torch.zeros(n // (64 * 1024), dtype=torch.int32,
                                   device=device)
        emit("counts_d2h_only", timeit(lambda: counts_sized.cpu()))

    if "roofline" in stages:
        emit("hbm_read_sum",
             timeit(lambda: int(torch.sum(flat, dtype=torch.int32))), n)
        # two passes in one call; the reversed copy is corpus-sized, so it
        # only runs where half the device memory is free
        try:
            emit("hbm_read_sum_x2", timeit(lambda: int(
                torch.sum(flat, dtype=torch.int32)
                + torch.sum(flat.flip(0), dtype=torch.int32))), 2 * n)
        except torch.cuda.OutOfMemoryError as e:
            print(json.dumps({"probe": "hbm_read_sum_x2",
                              "skipped": str(e)[:120]}), flush=True)

    if "kernel" in stages:
        for tile_rows in tile_rows_list:
            te = tile_rows * LANES
            data = tile_view(words, n, te)

            def step(data=data, te=te):
                return tile_counts(pat, data, n, tile_elems=te)

            emit(f"swar_counts_tile_rows_{tile_rows}", timeit(step), n)
            print(json.dumps({"probe": f"counts_sum_{tile_rows}",
                              "sum": int(step().sum())}), flush=True)

    if "variants" in stages:
        cases = [
            ("wildcard_ab*de", compile_pattern("ab*de", "*"), n),
            ("16bit", compile_pattern("abcde", dtype=np.uint16), n // 2),
            ("L12", compile_pattern("abcdefghijkl"), n),
        ]
        tile_bytes = 1024 * LANES
        data = tile_view(words, n, tile_bytes)
        for name, p, valid in cases:
            te = tile_bytes // np.dtype(p.dtype).itemsize

            def step(p=p, valid=valid, te=te):
                return tile_counts(p, data, valid, tile_elems=te)

            emit(f"swar_{name}_tile_rows_1024", timeit(step), n)

    if "e2e" in stages:
        # the two-call step: 64 KiB count tiles, hot tiles fetched in one
        # batched gather
        te = 64 * LANES
        data = tile_view(words, n, te)

        def counts_only():
            return tile_counts(pat, data, n, tile_elems=te)

        emit("e2e_counts_only_64k_tiles", timeit(counts_only), n)
        counts = counts_only()
        hot = np.nonzero(counts)[0]
        print(json.dumps({"probe": "hot_tiles", "n": int(len(hot)),
                          "sum": int(counts.sum())}), flush=True)
        if len(hot):
            emit("e2e_extract_only", timeit(
                lambda: extract_hot_tiles_device(pat, data, counts, n, te)))

        def full_step():
            c = tile_counts(pat, data, n, tile_elems=te)
            if c.any():
                extract_hot_tiles_device(pat, data, c, n, te)
            return c

        emit("e2e_full_step", timeit(full_step), n)

    if "fused" in stages:
        te = 8 * LANES
        data = tile_view(words, n, te)
        for kw in ("abcde", "ab*de"):
            p = compile_pattern(kw, "*" if "*" in kw else 0)

            def fstep(p=p):
                return fused_count_extract(p, data, n, tile_elems=te)[2]

            info = fstep()
            emit(f"fused_step_{kw.replace('*', 'W')}", timeit(fstep), n,
                 hot=info.hot_tiles)

    if "sol" in stages:
        # the counts kernel against a pure load+sum kernel (J) with exactly
        # its tile geometry, same process: kernel_time / pure_load_time is
        # how close the scan runs to its own memory pipeline's speed of
        # light
        reset_launch_counts()
        t_load, t_kernel, _ = sol_times(words, n, pat, args.iters)
        emit("sol_pure_load_sum", t_load, n)
        emit("sol_counts_kernel", t_kernel, n)
        print(json.dumps({
            "probe": "sol_ratio",
            "kernel_over_pure_load": t_kernel / t_load,
            "launches": launch_counts["load_sum"],
            "note": "1.0 = scan at its memory pipeline's speed of light",
        }), flush=True)

    if "ab" in stages:
        # gathers under the fused wildcard step, same process (the JAX
        # probe's part (b)); the three must agree before any is timed
        te = 8 * LANES
        data = tile_view(words, n, te)
        pw = compile_pattern("ab*de", "*")
        combos = gather_combos(pw, data, n, te)
        if any(not np.array_equal(c, combos["fused"]) for c in combos.values()):
            print("perf_probe: the gathers' combo buffers differ",
                  file=sys.stderr)
            return 1
        for gm in GATHER_MODES:
            def gstep(gm=gm):
                return fused_count_extract_finish(
                    gather_step(pw, data, n, te, gm))[2]

            info = gstep()
            emit(f"ab_gather_{gm}_fused_wildcard", timeit(gstep), n,
                 hot=info.hot_tiles, fallback=info.fallback)
    return 0


if __name__ == "__main__":
    sys.exit(main())
