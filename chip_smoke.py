#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

``python3 chip_smoke.py`` from the repository root:

1. prints the environment (torch, the card, its power limit);
2. builds the CUDA kernels from ``monkey_moore_tpu_torch/csrc/`` and runs
   the backend probe, which launches kernels A, D, E and B once each at
   tiny shapes against their plain versions;
3. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at a tiny tile, exactly (all values are
   integers), and times both (the word counts kernel A at the main path's
   tiles and at the bench path's 8 Ki-element tiles, and the keyword-batch
   kernel C at K = 3, 8 and 16, by back-to-back launches, each with its
   bound; the element counts kernel D, the same SWAR kernel, also on
   copies of each buffer that start inside a word, and timed beside A on
   the same bytes at u8 and u16 and on a u8 copy 1 byte past a 16-byte
   boundary; the gathers B and E, one bulk-copy kernel, on the same ids
   beside ``index_select`` of the tile view, at k_cap 32 and 128 with the
   main path's ids and with distinct ids, and at the bench path's 8 KiB
   tiles and k_cap 32, by back-to-back launches with each call's host
   enqueue time);
4. writes a 1 GiB file of seeded random bytes with planted keywords and
   searches it through ``monkey_moore_tpu_torch.engine.SearchEngine`` with
   default settings (the resident device route): an 8-bit keyword, an
   8-bit wildcard keyword planted often enough to overflow the fused step,
   and a 16-bit big-endian keyword.  Every planted offset must be found,
   and results must equal the same engine's host route;
5. searches the same file for two keyword batches through
   ``monkey_moore_tpu_torch.multi.MultiSearcher``: 8 8-bit keywords (the
   overflowing wildcard keyword among them) and 3 16-bit big-endian ones.
   Every planted offset must be found, each keyword's results must equal
   those of ``SearchEngine`` (phase 4's entry point) run on that keyword
   alone, and the batches must go through the keyword-batch kernel and
   never the single-keyword one;
6. runs the in-memory API, ``dense_search`` and ``dense_candidates`` of
   ``monkey_moore_tpu_torch.dense`` on the card, over the file as a 1 GiB
   u8 array (phase 4's 8-bit keywords) and as its 512 Mi-element 16-bit
   big-endian grid (the 16-bit keyword): every plant found, candidates
   equal to the C host scanner's, GREEDY results equal to its candidates
   after suppression and recovery, through kernel D and never kernel A;
7. repeats phase 4's searches through the engine's streaming branch (the
   residency limit below the file size): each chunk is uploaded as
   elements and scanned by kernels D and E, never A or B, and the results
   must equal phase 4's;
8. runs the benchmark path of ``monkey_moore_tpu_torch.bench`` in-process
   at its full size (``MMTPU_BENCH_MB``, 12 GiB by default): the corpus is
   generated on the card, the keyword is planted at two byte offsets that
   are not word-aligned, just past 2^31 and 2^32, the fused step must find
   both and every offset it reports must hold the keyword (checked on the
   host from the bytes there), then the bench's timed paths run (fused
   step, pure-load kernel I, counts kernel A at I's tiles) and its JSON
   record is printed.  Kernel I must equal its plain version and
   ``torch.sum`` on the whole corpus, and no share of the published
   bandwidth may read over 105%;
9. drives the user's entry points over phase 4's file on the card: the
   CLI in-process (``search`` of phase 4's 8-bit and 16-bit BE keywords,
   first and repeat, equal to phase 4's resident results through kernels
   A and B and never D or E; ``multi-search`` of phase 5's 8-bit batch,
   equal to phase 5 through kernel C and never A; ``value-scan`` of the
   8-bit plants' bytes, every plant found; ``export-tbl``, the file equal
   to ``tables.build_table_data`` of phase 4's first result), one
   ``python -m monkey_moore_tpu_torch search`` in a subprocess (stdout
   equal to the in-process run), a scripted ``Repl(device="cuda")``
   session (two searches, the second on the same resident corpus, a
   batch, a value scan, ``about`` naming the card) and an ``AsyncSearch``
   aborted after its first chunk (ABORTED, no results) followed by one
   equal to phase 4; it prints the walls of the first and repeat searches;
10. runs the conformance gate's streaming pass on the card at two seeds,
   ``conformance.run_gate(trials=150, seed=424242 and then 2024,
   multi_trials=37, device="cuda", streaming=True)`` (the engine's
   streaming branch where the JAX gate takes a mesh): at each seed no
   failed check and the JAX gate's passed and known-divergence counts
   there (547 and 3, 559 and 5), with kernels A, B, D and E launched at
   its odd geometries (64-byte blocks, 4 KiB chunks, odd 16-bit tails);
11. drives the meshes and the multi-host search over phase 4's file:
   (a) phase 4's three searches through ``SearchEngine`` with
   ``devices=["cuda:0"] * 4`` (and with every card, where there are more
   than one), first and repeat, each equal to phase 4's results with every
   plant found, through kernels A and B only (never C, D or E), with the
   mesh stats printed; then the 8-bit search with ``resident_bytes_limit=0``
   (the chunked mesh step), equal again; (b) phase 5's 8-bit batch through
   ``MultiSearcher(..., devices=["cuda:0"] * 4)``, equal to phase 5,
   through kernel C and never A; (c) two worker processes on the card in a
   gloo group on a free localhost port, each running ``run_distributed``
   for phase 4's 8-bit keyword on ``cuda:0`` (the streaming branch,
   kernels D and E) and on a mesh of two shards (the chunked mesh step,
   kernels A and B), every result equal to phase 4's; (d) the gate's mesh
   pass, ``run_gate(150, 424242, 37, "cuda")`` with ``[device] * n`` on
   ``t % 3 == 2``: the JAX gate's summary, 547/550 with 3 known
   divergences; (e) ``bench_scaling`` over the file at mesh sizes 1, 2
   and 4 (on one card: the cost of sharding, not scaling);
12. drives the harnesses that have no earlier phase: (a) ``bench_all``'s
   eight suites in-process on one 12 GiB corpus generated on the card,
   with the keyword planted at unaligned byte offsets past 2^31 and 2^32
   and as u16 elements past 2^31 and 2^32 bytes: every plant found by its
   suites, every reported offset holding the keyword (checked on the host
   from the bytes there), every suite through kernels A and B and never C,
   D or E, and the 8-bit suite's rate printed beside phase 8's; then
   its 128 KiB-16 MiB ladder, every size on the host route; (b)
   ``bench_baseline_configs`` at full size (``--scale 1 --iters 2``): every
   configuration's plants found, the 1 GB row on the resident device
   route, its four-shard mesh and two gloo worker processes equal to it;
   (c) ``perf_probe --stage ab --mb 4096``: the three gathers give equal
   combo buffers; (d) ``tui_smoke`` on the card (its 50 KB ROM rides the
   host route and launches no kernel); (e) the host/device crossover: one
   8-bit search at 4, 16 and 64 MiB on the host route and on the device
   route (``host_latency_threshold_bytes=0``), first and best repeat.

Phases 9-11 run after phase 7, while phase 4's file exists; phase 8 runs
after them and phase 12 last.

Phase 3 also holds kernel I against its plain version and ``torch.sum`` on
the 512 MiB chunk buffer; phase 8 times it on the first 4 GiB as well
(kernel J's shape).  Kernels that take about a millisecond or less (the
counts kernels A, C and D, the gathers, and kernel I beside ``torch.sum``)
are timed by ``bench.back_to_back_ms``: many launches between one pair of
CUDA events, enqueued while a spin kernel holds the stream.  Each path runs with the
launch counts set to 0 just before it and read just after, and every
gather launch on phases 4-9 must have 16-byte aligned pointers and tile
size (the bulk route; the gate's tiny chunks may take the edge copy).  The last line is ``{"ok": true,
"device": {...}}``; the line before it is the card's ``nvidia-smi`` name
and power limit, and before that a JSON object with each kernel's launches
on its paths, its largest difference from the plain version, its time, its
plain version's time, the bound (the least time the card could take:
bytes over 3.35 TB/s or 32-bit integer operations over 16.7 T/s, whichever
is larger, by ``bench.bound``) and the time
of one PyTorch call computing the same function, where there is one.  Any
failure exits non-zero before those lines.  Without a CUDA card it exits 1
at once.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 20261016
MIB = 1 << 20
FILE_BYTES = 1 << 30
CHUNK = 512 * MIB  # the engine's default device chunk (bytes)
TE = 262_144  # the main path's count tile (elements)
BENCH_TE = 8_192  # the bench path's count tile (elements)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def nvcc_release(nvcc) -> str:
    """The release line of ``nvcc --version``, or "not found"."""
    if nvcc is None:
        return "not found"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60, check=True)
    lines = [s for s in out.stdout.splitlines() if "release" in s]
    return (lines or out.stdout.strip().splitlines() or ["?"])[-1].strip()


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def path_launches(scan_cuda, phase: str) -> dict:
    """The launch counts since the last reset; fails unless every gather
    launch of the path had 16-byte aligned pointers and tile size, so that
    it moved every slot inside its source by bulk copy."""
    launches = dict(scan_cuda.launch_counts)
    aligned = dict(scan_cuda.aligned_launch_counts)
    check(all(aligned[k] == launches[k] for k in aligned),
          f"{phase}: gathers off the bulk route: {aligned} aligned of "
          f"{launches}")
    print(f"{phase} gathers on the bulk route (16-byte aligned): {aligned}",
          flush=True)
    return launches


def random_words(torch, gen, n_bytes: int):
    return torch.randint(
        -(2**31), 2**31, (n_bytes // 4,), dtype=torch.int32,
        device="cuda", generator=gen,
    )


def plant_words(torch, words, pat, positions, shift):
    """Write the keyword (shifted by ``shift``) at element positions."""
    import numpy as np

    width = np.dtype(pat.dtype).itemsize
    elems = words.view(torch.uint8 if width == 1 else torch.int16)
    kw = (np.array(pat.keyword, dtype=np.int64) + shift) % (1 << (8 * width))
    kw_t = torch.tensor(kw.astype(np.int64), device="cuda").to(elems.dtype)
    for pos in positions:
        elems[pos : pos + pat.length] = kw_t


def kernel_phase(torch):
    """Phase 3: each kernel against its plain version; returns the rows of
    the kernels line without launch counts."""
    import numpy as np

    from monkey_moore_tpu_torch.counts_bench import a_bound, misaligned_copy
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.ops.scan_torch import nonzero_capped
    from monkey_moore_tpu_torch.pattern import compile_pattern

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    err = {"A": 0, "B": 0, "D": 0, "E": 0, "I": 0}
    ms = {"D regimes": []}
    work = {}  # kernel -> (bound_ms, bound_by) at the timed shape
    for width in (1, 2):
        dtype = np.uint8 if width == 1 else np.uint16
        elem_dtype = torch.uint8 if width == 1 else torch.uint16
        for kw, wc in (("abcde", 0), ("ab*de", "*")):
            pat = compile_pattern(kw, wc, dtype=dtype)
            checks = scan_cuda.prefilter_operand(pat, "cuda")
            for te, n_tiles in ((TE, CHUNK // (TE * width)), (8, 4096)):
                words = random_words(torch, gen, (n_tiles + 1) * te * width)
                elems = words.view(elem_dtype)  # the same allocation
                valid = n_tiles * te - (1234 % te)
                plants = [1, 2 * te - 2, (n_tiles // 2) * te + 7,
                          valid - pat.length]
                plant_words(torch, words, pat, plants, 3)
                args = dict(tile_elems=te, length=pat.length,
                            valid_count=valid)
                got = scan_cuda.tile_counts(words, checks, width=width,
                                            **args)
                want = scan_cuda.tile_counts_plain(words, checks,
                                                   width=width, **args)
                check(got.shape == want.shape, "kernel A shape")
                err["A"] = max(err["A"], int((got - want).abs().max()))
                check(int(want.sum()) >= len(plants), "kernel A plants")
                got_d = scan_cuda.tile_counts_elems(elems, checks, **args)
                want_d = scan_cuda.tile_counts_elems_plain(elems, checks,
                                                           **args)
                check(got_d.shape == want.shape, "kernel D shape")
                err["D"] = max(err["D"], int((got_d - want_d).abs().max()))
                check(torch.equal(want_d, want),
                      "the plain versions of kernels A and D differ")
                # D on a copy of the same elements that starts inside a word
                shifted = misaligned_copy(elems, width)
                got_m = scan_cuda.tile_counts_elems(shifted, checks, **args)
                err["D"] = max(err["D"], int((got_m - want_d).abs().max()))
                del shifted, got_m
                if te == TE and kw == "abcde":
                    ms["D regimes"] += elems_regimes(
                        torch, scan_cuda, words, elems, checks, pat, valid,
                        width, want_d, err)
                if te == TE and width == 1 and kw == "abcde":
                    # A and D on the same bytes: word view, element view
                    ms["A plain"] = time_ms(
                        torch, lambda: scan_cuda.tile_counts_plain(
                            words, checks, width=1, **args), 5)
                    ms["D plain"] = time_ms(
                        torch, lambda: scan_cuda.tile_counts_elems_plain(
                            elems, checks, **args), 5)
                    work["A"] = work["D"] = a_bound(
                        words.numel() * 4, n_tiles, valid, pat.length)
                    ms["A regimes"] = counts_regimes(
                        torch, scan_cuda, words, checks, pat, valid, err)
                    ms["A"] = ms["A regimes"][0]["ms"]
                    load_checks(torch, scan_cuda, words, err, ms)
                if te == TE and kw == "abcde":
                    gather_checks(torch, scan_cuda, nonzero_capped, words,
                                  elems, got, width, te, err, ms, work)
                del words, elems, got, want, got_d, want_d
                torch.cuda.empty_cache()
    for name in err:
        check(err[name] == 0,
              f"kernel {name} differs from its plain version by {err[name]}")
    ms["D"] = ms["D regimes"][0]["ms"]  # u8, 16-byte aligned
    print(f"phase 3 kernels: A == D == plain (u8/u16, abcde/ab*de, te={TE} "
          f"over {CHUNK // MIB} MiB and te=8; D also on copies that start "
          f"inside a word): A {ms['A']:.4f} ms vs {ms['A plain']:.4f} ms "
          f"plain, D {ms['D']:.4f} ms vs {ms['D plain']:.4f} ms plain on "
          f"the same u8 buffer (back to back); B == E == "
          f"plain == index_select (k_cap 1/32/128): B {ms['B']:.4f} ms vs "
          f"{ms['B plain']:.4f} ms plain, E {ms['E']:.4f} ms vs "
          f"{ms['E plain']:.4f} ms plain at k_cap=32, main-path ids "
          f"(index_select of the tile view {ms['B library']:.4f} ms); I == "
          f"plain == torch.sum on the {CHUNK // MIB} MiB buffer: I "
          f"{ms['I chunk']:.4f} ms (host {ms['I chunk host']:.4f}) vs "
          f"{ms['I chunk plain']:.4f} ms plain, torch.sum "
          f"{ms['I chunk library']:.4f} ms (host "
          f"{ms['I chunk library host']:.4f})", flush=True)
    err_c, c_plain_ms, work["C"], c_regimes = multi_kernel_phase(torch, gen)
    src = "monkey_moore_tpu_torch/csrc/"
    tpu = "monkey_moore_tpu/ops/scan_pallas.py:"

    def row(name, source, replaces, key, max_err, kms, plain, library,
            **extra):
        bound_ms, bound_by = work[key]
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "max_abs_err": max_err, "ms": kms,
                "plain_ms": plain, "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library, **extra}

    return [
        row("tile_counts", "tile_counts.cu", tpu + "612", "A", err["A"],
            ms["A"], ms["A plain"], None, regimes=ms["A regimes"]),
        row("gather_tiles", "gather_tiles.cu", tpu + "245", "B", err["B"],
            ms["B"], ms["B plain"], ms["B library"],
            regimes=ms["gather regimes"]),
        row("tile_counts_multi", "tile_counts_multi.cu", tpu + "838", "C",
            err_c, next(r["ms"] for r in c_regimes if r["k"] == 8),
            c_plain_ms, None, regimes=c_regimes),
        row("tile_counts_elems", "tile_counts_elems.cu", tpu + "373", "D",
            err["D"], ms["D"], ms["D plain"], None,
            regimes=ms["D regimes"]),
        row("gather_tiles_block", "gather_tiles.cu", tpu + "315", "E",
            err["E"], ms["E"], ms["E plain"], ms["B library"],
            regimes=ms["gather regimes"]),
    ], err["I"]


def counts_regimes(torch, scan_cuda, words, checks, pat, valid, err):
    """Phase 3, kernel A on the u8 512 MiB chunk buffer at the main path's
    tiles and, on the same bytes, the bench path's 8 Ki-element tiles (the
    shape of phase 8's A launches): each against its plain version and
    timed by back-to-back launches; returns a row per tile size with its
    bound (``counts_bench.a_bound``)."""
    from monkey_moore_tpu_torch.bench import back_to_back_ms
    from monkey_moore_tpu_torch.counts_bench import LAUNCHES, a_bound

    rows = []
    for te in (TE, BENCH_TE):
        args = dict(width=1, tile_elems=te, length=pat.length,
                    valid_count=valid)
        got = scan_cuda.tile_counts(words, checks, **args)
        want = scan_cuda.tile_counts_plain(words, checks, **args)
        err["A"] = max(err["A"], int((got - want).abs().max()))
        kms, host = back_to_back_ms(
            lambda: scan_cuda.tile_counts(words, checks, **args), LAUNCHES)
        bound_ms, bound_by = a_bound(words.numel() * 4, got.numel(), valid,
                                     pat.length)
        rows.append({"tile_elems": te, "ms": kms, "host_ms": host,
                     "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"phase 3 kernel A, {te}-element tiles over {CHUNK // MIB} "
              f"MiB: {kms:.4f} ms (host {host:.4f}), bound {bound_ms:.4f} "
              f"ms ({bound_by}); back to back, {LAUNCHES} launches",
              flush=True)
    return rows


def elems_regimes(torch, scan_cuda, words, elems, checks, pat, valid,
                  width, want, err):
    """Phase 3, kernel D on the 512 MiB chunk buffer at the main path's
    tiles, beside kernel A on the same bytes (the word view), both timed by
    back-to-back launches; at u8 also on a copy 1 byte past a 16-byte
    boundary.  Each launch is held to *want*, the plain counts of those
    bytes; returns a row per regime with A's time and the bound
    (``counts_bench.a_bound`` at the element width)."""
    from monkey_moore_tpu_torch.bench import back_to_back_ms
    from monkey_moore_tpu_torch.counts_bench import (
        LAUNCHES, a_bound, misaligned_copy)

    args = dict(tile_elems=TE, length=pat.length, valid_count=valid)
    a_ms, a_host = back_to_back_ms(
        lambda: scan_cuda.tile_counts(words, checks, width=width, **args),
        LAUNCHES)
    bound_ms, bound_by = a_bound(words.numel() * 4, want.numel(), valid,
                                 pat.length, width)
    rows = []
    for offset in (0, 1) if width == 1 else (0,):
        view = elems if offset == 0 else misaligned_copy(elems, offset)
        got = scan_cuda.tile_counts_elems(view, checks, **args)
        err["D"] = max(err["D"], int((got - want).abs().max()))
        kms, host = back_to_back_ms(
            lambda: scan_cuda.tile_counts_elems(view, checks, **args),
            LAUNCHES)
        rows.append({"width": width, "offset": offset, "tile_elems": TE,
                     "ms": kms, "host_ms": host, "a_ms": a_ms,
                     "a_host_ms": a_host, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        print(f"phase 3 kernel D, u{8 * width} elements {offset} bytes past "
              f"a 16-byte boundary, {TE}-element tiles over {CHUNK // MIB} "
              f"MiB: {kms:.4f} ms (host {host:.4f}), A on the same bytes "
              f"{a_ms:.4f} ms (host {a_host:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}); back to back, {LAUNCHES} launches", flush=True)
        del view, got
    return rows


def load_checks(torch, scan_cuda, words, err, ms):
    """Phase 3, kernel I on the 512 MiB chunk buffer: its per-tile sums
    (2 MiB tiles, the TPU load kernel's block) and total against its plain
    version, and the total against ``torch.sum``, exactly; I and
    ``torch.sum`` timed by back-to-back launches, the plain version by
    CUDA-event medians."""
    from monkey_moore_tpu_torch.bench import LOAD_TILE_WORDS, back_to_back_ms

    n_tiles = words.numel() // LOAD_TILE_WORDS
    body = words[: n_tiles * LOAD_TILE_WORDS]
    sums, total = scan_cuda.load_sum(words, LOAD_TILE_WORDS)
    p_sums, p_total = scan_cuda.load_sum_plain(words, LOAD_TILE_WORDS)
    library = torch.sum(body, dtype=torch.int32)
    err["I"] = max(err["I"], int((sums.long() - p_sums.long()).abs().max()),
                   abs(int(total) - int(p_total)),
                   abs(int(total) - int(library)))
    ms["I chunk"], ms["I chunk host"] = back_to_back_ms(
        lambda: scan_cuda.load_sum(words, LOAD_TILE_WORDS), 100)
    ms["I chunk plain"] = time_ms(
        torch, lambda: scan_cuda.load_sum_plain(words, LOAD_TILE_WORDS), 5)
    ms["I chunk library"], ms["I chunk library host"] = back_to_back_ms(
        lambda: torch.sum(body, dtype=torch.int32), 100)


def gather_checks(torch, scan_cuda, nonzero_capped, words, elems, counts,
                  width, te, err, ms, work):
    """Phase 3, the gathers: B on the word view and E on the element view
    against their plain versions, each other and one ``index_select`` of
    the overlapping tile view (the library call that computes the same
    gather), byte for byte, at k_cap 1, 32 and 128 with duplicate ids.  On
    the u8 buffer, times B, E and ``index_select`` by back-to-back launches
    in two id regimes at k_cap 32 and 128: the main path's ids
    (``nonzero_capped`` of kernel A's counts) and distinct ids spread over
    the chunk; and at the bench path's 8 KiB tiles and k_cap 32 with four
    hot tiles; each with its host enqueue time and its bound
    (``gather_bench.bound_ms``).  The kernels line takes the main-path ids
    at k_cap 32."""
    from monkey_moore_tpu_torch.bench import back_to_back_ms
    from monkey_moore_tpu_torch.gather_bench import (
        LAUNCHES,
        bound_ms,
        regime_ids,
    )

    n_tiles = counts.numel()
    # tile t and its halo tile are row t of the overlapping view
    spans = words.view(torch.uint8).unfold(0, 2 * te * width, te * width)
    for k_cap in (1, 32, 128):
        hot = nonzero_capped(counts, k_cap)
        hot[k_cap // 2 :] = hot[0].clone()  # duplicate ids
        b = scan_cuda.gather_tiles(words, hot, width=width, tile_elems=te)
        b_plain = scan_cuda.gather_tiles_plain(words, hot, width=width,
                                               tile_elems=te)
        e = scan_cuda.gather_tiles_block(elems, hot, tile_elems=te)
        e_plain = scan_cuda.gather_tiles_block_plain(elems, hot,
                                                     tile_elems=te)
        e_bytes = e.view(torch.uint8)
        err["B"] = max(err["B"], int((b.to(torch.int16)
                                      - b_plain.to(torch.int16)).abs().max()))
        err["E"] = max(err["E"], int((e_bytes.to(torch.int16)
                                      - e_plain.view(torch.uint8)
                                      .to(torch.int16)).abs().max()))
        check(torch.equal(e_bytes, b), "kernel E differs from kernel B")
        check(torch.equal(torch.index_select(spans, 0, hot), b),
              "index_select of the tile view differs from kernel B")
    if width != 1:
        return
    regimes = []
    bench_te = 8 << 10  # the bench path's tiles (8 Ki u8 elements)
    for kind, tile, k_cap in (("main", te, 32), ("main", te, 128),
                              ("distinct", te, 32), ("distinct", te, 128),
                              ("bench", bench_te, 32)):
        tiles = words.numel() * 4 // tile - 1  # plus one halo tile
        if kind == "main":
            hot = nonzero_capped(counts, k_cap)
        else:
            hot = regime_ids("main" if kind == "bench" else kind, tiles,
                             k_cap, "cuda")
        view = (spans if tile == te else words.view(torch.uint8)
                .unfold(0, 2 * tile, tile))
        row = {"ids": kind, "tile_bytes": tile, "k_cap": k_cap,
               "distinct_ids": len(set(hot.tolist())),
               "bound_ms": bound_ms(hot, tiles, tile)}
        for name, fn in (
            ("B", lambda: scan_cuda.gather_tiles(
                words, hot, width=1, tile_elems=tile)),
            ("E", lambda: scan_cuda.gather_tiles_block(
                elems, hot, tile_elems=tile)),
            ("library", lambda: torch.index_select(view, 0, hot)),
        ):
            row[f"{name} ms"], row[f"{name} host ms"] = (
                back_to_back_ms(fn, LAUNCHES))
        regimes.append(row)
        if kind == "main" and k_cap == 32:
            ms["B"], ms["E"] = row["B ms"], row["E ms"]
            ms["B library"] = row["library ms"]
            work["B"] = work["E"] = (row["bound_ms"], "bytes")
            ms["B plain"] = time_ms(torch, lambda: scan_cuda
                                    .gather_tiles_plain(
                                        words, hot, width=1,
                                        tile_elems=te), 10)
            ms["E plain"] = time_ms(torch, lambda: scan_cuda
                                    .gather_tiles_block_plain(
                                        elems, hot, tile_elems=te), 10)
    ms["gather regimes"] = regimes
    for row in regimes:
        print(f"phase 3 gathers, {row['ids']} ids, {row['tile_bytes']}-byte "
              f"tiles, k_cap {row['k_cap']} ({row['distinct_ids']} "
              f"distinct): B {row['B ms']:.4f} ms (host "
              f"{row['B host ms']:.4f}), E {row['E ms']:.4f} ms (host "
              f"{row['E host ms']:.4f}), index_select "
              f"{row['library ms']:.4f} ms (host "
              f"{row['library host ms']:.4f}), bound {row['bound_ms']:.4f} "
              f"ms; back to back, {LAUNCHES} launches", flush=True)


def multi_kernel_phase(torch, gen):
    """Phase 3, keyword-batch kernel (C) against its plain version at
    K = 8 (``counts_bench.BATCH[:8]``: canonical plain keywords, a
    wildcard, a leading wildcard and a 12-character keyword): u8 and u16, a
    512 MiB chunk at the main path's tile and ten 8192-element tiles; each
    keyword planted at the start and across a tile edge, the eighth also at
    its last valid window.  On the u8 chunk also K = 3 and 16 (every
    keyword of the 16 planted), and each K timed by back-to-back launches.
    Returns (largest difference, plain ms at K = 8, (bound ms, bound by) at
    K = 8, a row per K with its bound)."""
    import numpy as np

    from monkey_moore_tpu_torch.bench import back_to_back_ms
    from monkey_moore_tpu_torch.counts_bench import (
        BATCH,
        C_KS,
        LAUNCHES,
        c_bound,
    )
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.pattern import compile_pattern

    err = 0
    regimes = []
    for width in (1, 2):
        dtype = np.uint8 if width == 1 else np.uint16
        batch = [compile_pattern(kw, wc, dtype=dtype) for kw, wc in BATCH]
        for te, n_tiles in ((TE, CHUNK // (TE * width)), (8192, 10)):
            words = random_words(torch, gen, (n_tiles + 1) * te * width)
            valid = n_tiles * te - (1234 % te)
            timed = te == TE and width == 1
            planted = batch if timed else batch[:8]
            plants = [[1 + 64 * i, (i + 1) * te - 2]
                      for i in range(len(planted))]
            plants[7].append(valid - batch[7].length)
            for i, (pat, pos) in enumerate(zip(planted, plants)):
                plant_words(torch, words, pat, pos, 3 + i)
            for k in C_KS if timed else [8]:
                table, last_starts = scan_cuda.multi_operand(
                    batch[:k], valid, "cuda")
                args = dict(width=width, tile_elems=te)
                got = scan_cuda.tile_counts_multi(words, table, last_starts,
                                                  **args)
                want = scan_cuda.tile_counts_multi_plain(words, table,
                                                         last_starts, **args)
                check(got.shape == want.shape == (k, n_tiles),
                      "kernel C shape")
                err = max(err, int((got - want).abs().max()))
                hit = want.cpu().numpy()
                check(all(hit[i, p // te] > 0
                          for i, pos in enumerate(plants[:k]) for p in pos),
                      "kernel C plants")
                if not timed:
                    continue
                kms, host = back_to_back_ms(
                    lambda: scan_cuda.tile_counts_multi(
                        words, table, last_starts, **args), LAUNCHES)
                work = c_bound(words.numel() * 4, n_tiles, table,
                               last_starts)
                regimes.append({"k": k, "ms": kms, "host_ms": host,
                                "bound_ms": work[0], "bound_by": work[1]})
                if k == 8:
                    c_work = work
                    c_plain_ms = time_ms(
                        torch, lambda: scan_cuda.tile_counts_multi_plain(
                            words, table, last_starts, **args), 5)
                del got, want
            del words
            torch.cuda.empty_cache()
    check(err == 0, f"kernel C differs from its plain version by {err}")
    print(f"phase 3 kernels: C == plain (K=8 u8/u16, te={TE} over "
          f"{CHUNK // MIB} MiB and te=8192; K={'/'.join(map(str, C_KS))} u8 "
          f"over {CHUNK // MIB} MiB): " + ", ".join(
              f"K={r['k']} {r['ms']:.4f} ms (host {r['host_ms']:.4f}, bound "
              f"{r['bound_ms']:.4f} {r['bound_by']})" for r in regimes)
          + f", back to back, {LAUNCHES} launches; plain {c_plain_ms:.4f} "
          "ms at K=8", flush=True)
    return err, c_plain_ms, c_work, regimes


def write_corpus(path: Path):
    """1 GiB of seeded random bytes with the plants of phase 4's three
    searches and of phase 5's batches; returns phase 4's searches,
    {name: (config kwargs, planted byte offsets)}, and phase 5's batches,
    {name: (MultiSearcher kwargs, [(spec, planted byte offsets)])}."""
    import numpy as np

    from monkey_moore_tpu_torch.config import Endianness

    rng = np.random.default_rng(SEED)
    data = np.frombuffer(rng.bytes(FILE_BYTES), dtype=np.uint8).copy()
    n = FILE_BYTES

    def put(offset, values):
        data[offset : offset + len(values)] = values

    kw1 = (np.array([ord(c) for c in "monkey"]) + 3).astype(np.uint8)
    plain8 = [4101, 123_456_789, CHUNK - 3, CHUNK + 1_000_001, n - 6]
    for off in plain8:
        put(off, kw1)

    kw2 = (np.array([ord(c) for c in "dragon"]) + 7).astype(np.uint8)
    dense = [7 * MIB + 3 + 8 * i for i in range(1100)]  # > p_cap in a chunk
    wild8 = dense + [900_000_003, 1_000_000_007]
    for i, off in enumerate(wild8):
        kw2[2] = i % 251  # the wildcard position holds anything
        put(off, kw2)

    kw3 = (np.array([ord(c) for c in "castle"]) + 0x3000).astype(">u2")
    be16 = [2000, 200_000_001, 600_000_000, 800_000_001, n - 40, n - 27]
    for off in be16:
        put(off, kw3.view(np.uint8))

    # phase 5's other keywords, away from the plants above
    batch8 = [("monkey", plain8),
              ({"keyword": "dr*gon", "wildcard": "*"}, wild8)]
    for i, (word, offs) in enumerate((
        ("sword", [50_000, 333_333_333, 1_073_000_000]),
        ("shield", [60_000, 444_444_444]),
        ("potion", [70_000, 555_555_555, 1_070_000_003]),
        ("?rincess", [80_000, 666_666_666]),
        ("treasurechest", [90_000, 777_777_777]),
        ("wizard", []),
    )):
        kw = (np.array([ord(c) for c in word]) + 11 + i).astype(np.uint8)
        lead = word[0] == "?"
        for off in offs:
            if lead:
                kw[0] = off % 251  # the leading wildcard holds anything
            put(off, kw)
        spec = {"keyword": word, "wildcard": "?"} if lead else word
        batch8.append((spec, offs))
    kw4 = (np.array([ord(c) for c in "knight"]) + 0x4100).astype(">u2")
    knight = [3000, 300_000_001, 700_000_000, 1_000_000_101]
    for off in knight:
        put(off, kw4.view(np.uint8))
    batch16 = [("castle", be16), ("knight", knight), ("dungeon", [])]

    data.tofile(path)
    return {
        "8-bit": (dict(keyword="monkey"), plain8),
        "8-bit wildcard": (dict(keyword="dr*gon", wildcard="*"), wild8),
        "16-bit BE": (dict(keyword="castle", element_width=2,
                           endianness=Endianness.BIG), be16),
    }, {
        "8-bit batch": ({}, batch8),
        "16-bit BE batch": (dict(element_width=2,
                                 endianness=Endianness.BIG), batch16),
    }


def slice_phase(torch, workdir: Path):
    """Phase 4: the three searches through the port's entry point."""
    from monkey_moore_tpu_torch.config import SearchConfig
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.ops import scan_cuda

    path = workdir / "corpus.bin"
    t0 = time.perf_counter()
    searches, batches = write_corpus(path)
    print(f"phase 4 corpus: {FILE_BYTES // MIB} MiB written in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    device_results = {}
    scan_cuda.reset_launch_counts()
    for name, (kwargs, planted) in searches.items():
        engine = SearchEngine(SearchConfig(file_path=path, **kwargs),
                              device="cuda")
        times = []
        for _ in range(2):  # first search, then a repeat on the resident file
            t0 = time.perf_counter()
            results = engine.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        stats = engine.last_stats
        check(not stats.host_routed and stats.fused_steps > 0,
              f"{name}: did not take the device route")
        device_results[name] = (results, stats, times)
    launches = path_launches(scan_cuda, "phase 4")

    for name, (kwargs, planted) in searches.items():
        results, stats, times = device_results[name]
        offsets = [r.offset for r in results]
        missing = sorted(set(planted) - set(offsets))
        check(not missing, f"{name}: planted offsets not found: {missing}")
        host = SearchEngine(
            SearchConfig(file_path=path,
                         host_latency_threshold_bytes=FILE_BYTES + 1,
                         **kwargs),
            device="cuda",
        )
        host_results = host.run()
        check(host.last_stats.host_routed, f"{name}: host route not taken")
        check(offsets == [r.offset for r in host_results],
              f"{name}: offsets differ from the host route")
        check([r.values_map for r in results]
              == [r.values_map for r in host_results],
              f"{name}: values maps differ from the host route")
        if name == "8-bit wildcard":
            check(stats.fused_fallbacks > 0,
                  "the overflow keyword did not take the fallback")
        print(f"phase 4 search {name!r}: {len(results)} results "
              f"(= host route), first {times[0]:.3f} s, repeat "
              f"{times[1]:.3f} s | {stats.summary()}", flush=True)
    check(launches["tile_counts"] > 0 and launches["gather_tiles"] > 0,
          f"kernels not launched on the main path: {launches}")
    print(f"phase 4 launches on the main path: {launches}", flush=True)
    resident = {name: [(r.offset, r.values_map) for r in results]
                for name, (results, _, _) in device_results.items()}
    return launches, path, searches, resident, batches


def batch_phase(torch, path: Path, batches):
    """Phase 5: the keyword batches through ``MultiSearcher``, each run
    twice (the first search uploads the file), then every keyword through
    the engine alone for comparison.  Returns the path's launch counts and
    each batch's results, {name: [[(offset, values map)] per keyword]}."""
    from monkey_moore_tpu_torch.corpus import clear_corpus_cache
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.multi import MultiSearcher
    from monkey_moore_tpu_torch.ops import scan_cuda

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    clear_corpus_cache()
    batch_results = {}
    scan_cuda.reset_launch_counts()
    for name, (kwargs, planted) in batches.items():
        ms = MultiSearcher(path, device="cuda", **kwargs)
        specs = [spec for spec, _ in planted]
        runs = [timed(lambda: ms.search(specs)) for _ in range(2)]
        check(runs[0][0] == runs[1][0], f"{name}: repeat differs")
        batch_results[name] = (ms, runs[0][0], [t for _, t in runs])
    launches = path_launches(scan_cuda, "phase 5")
    check(launches["tile_counts_multi"] > 0 and launches["gather_tiles"] > 0,
          f"kernels not launched on the batch path: {launches}")
    check(launches["tile_counts"] == 0,
          f"the batch path launched the single-keyword kernel: {launches}")
    print(f"phase 5 launches on the batch path: {launches}", flush=True)

    for name, (kwargs, planted) in batches.items():
        ms, results, times = batch_results[name]
        single_times = []
        for (spec, offs), got in zip(planted, results):
            label = spec if isinstance(spec, str) else spec["keyword"]
            found = [r.offset for r in got]
            missing = sorted(set(offs) - set(found))
            check(not missing, f"{name} {label!r}: not found: {missing}")
            engine = SearchEngine(ms._config(spec), device="cuda")
            (single, t_first), (_, t_repeat) = (
                timed(engine.run), timed(engine.run))
            single_times.append((t_first, t_repeat))
            check([(r.offset, r.values_map) for r in got]
                  == [(r.offset, r.values_map) for r in single],
                  f"{name} {label!r}: differs from the engine alone")
        counts = [len(g) for g in results]
        print(f"phase 5 {name!r}: K={len(results)}, results {counts} "
              f"(= engine per keyword), batch first {times[0]:.3f} s, "
              f"repeat {times[1]:.3f} s; K single searches first "
              f"{sum(t for t, _ in single_times):.3f} s, repeat "
              f"{sum(t for _, t in single_times):.3f} s", flush=True)
    return launches, {
        name: [[(r.offset, r.values_map) for r in got] for got in results]
        for name, (_, results, _) in batch_results.items()}


def memory_phase(torch, path: Path, searches):
    """Phase 6: the in-memory API (``dense_search`` / ``dense_candidates``
    on the card) over the 1 GiB file as a u8 array, for phase 4's 8-bit
    keywords, and over its 16-bit big-endian grid (alignment 0, 512 Mi
    elements decoded on the host) for the 16-bit keyword.  Candidates must
    equal the C host scanner's, and GREEDY results its candidates after
    greedy suppression and recovery."""
    import numpy as np

    from monkey_moore_tpu_torch.config import Endianness, MatchSemantics
    from monkey_moore_tpu_torch.dense import dense_candidates, dense_search
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.ops.recover import recover_from_values
    from monkey_moore_tpu_torch.ops.scan_host import (
        decode_grid_host,
        host_candidates_values,
    )
    from monkey_moore_tpu_torch.ops.suppress import greedy_suppress
    from monkey_moore_tpu_torch.pattern import compile_pattern

    data = np.fromfile(path, dtype=np.uint8)
    grid16 = decode_grid_host(data, len(data), 2, Endianness.BIG, 0)
    cases = []
    for name, (kwargs, planted) in searches.items():
        if kwargs.get("element_width", 1) == 1:
            pat = compile_pattern(kwargs["keyword"], kwargs.get("wildcard", 0))
            cases.append((name, pat, data, planted))
        else:
            pat = compile_pattern(kwargs["keyword"], dtype=np.uint16)
            cases.append((name, pat, grid16,
                          [off // 2 for off in planted if off % 2 == 0]))

    scan_cuda.reset_launch_counts()
    found = {}
    for name, pat, arr, _ in cases:
        t0 = time.perf_counter()
        offs, vals = dense_candidates(pat, arr, device="cuda")
        t_cand = time.perf_counter() - t0
        t0 = time.perf_counter()
        greedy = dense_search(pat, arr, MatchSemantics.GREEDY, device="cuda")
        t_search = time.perf_counter() - t0
        found[name] = (offs, vals, greedy, t_cand, t_search)
    launches = path_launches(scan_cuda, "phase 6")
    check(launches["tile_counts_elems"] > 0,
          f"kernel D not launched on the in-memory path: {launches}")
    check(launches["tile_counts"] == 0,
          f"the in-memory path launched kernel A: {launches}")
    print(f"phase 6 launches on the in-memory path: {launches}", flush=True)

    for name, pat, arr, planted in cases:
        offs, vals, greedy, t_cand, t_search = found[name]
        missing = sorted(set(planted) - {o for o, _ in greedy})
        check(not missing, f"memory {name}: planted not found: {missing}")
        t0 = time.perf_counter()
        h_offs, h_vals = host_candidates_values(pat, arr)
        t_host = time.perf_counter() - t0
        check(offs.tolist() == h_offs.tolist(),
              f"memory {name}: candidates differ from the host scanner")
        check(vals.tolist() == h_vals.tolist(),
              f"memory {name}: recovery values differ from the host scanner")
        keep = np.isin(h_offs, greedy_suppress(h_offs, pat.advance))
        want = [(int(o), recover_from_values(pat, v))
                for o, v in zip(h_offs[keep], h_vals[keep])]
        check(greedy == want,
              f"memory {name}: GREEDY differs from the host scanner's")
        print(f"phase 6 memory {name!r} over {len(arr)} elements: "
              f"{len(offs)} candidates, {len(greedy)} GREEDY results "
              f"(= host scanner); dense_candidates {t_cand:.3f} s, "
              f"dense_search {t_search:.3f} s, host scanner {t_host:.3f} s",
              flush=True)
    return launches


def stream_phase(torch, path: Path, searches, resident):
    """Phase 7: phase 4's searches through the engine's streaming branch
    (``resident_bytes_limit`` below the file size): each chunk is decoded
    on the host, uploaded as elements and scanned by kernels D and E.
    Results must equal phase 4's resident results."""
    from monkey_moore_tpu_torch.config import SearchConfig
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.ops import scan_cuda

    scan_cuda.reset_launch_counts()
    runs = {}
    for name, (kwargs, _) in searches.items():
        engine = SearchEngine(
            SearchConfig(file_path=path, resident_bytes_limit=FILE_BYTES // 2,
                         **kwargs),
            device="cuda",
        )
        t0 = time.perf_counter()
        results = engine.run()
        torch.cuda.synchronize()
        runs[name] = (results, engine.last_stats, time.perf_counter() - t0)
    launches = path_launches(scan_cuda, "phase 7")
    check(launches["tile_counts_elems"] > 0
          and launches["gather_tiles_block"] > 0,
          f"kernels D and E not launched on the streaming path: {launches}")
    check(launches["tile_counts"] == 0 and launches["gather_tiles"] == 0,
          f"the streaming path launched kernel A or B: {launches}")
    print(f"phase 7 launches on the streaming path: {launches}", flush=True)

    for name, (results, stats, secs) in runs.items():
        check(not stats.host_routed and stats.fused_steps > 0
              and stats.h2d_bytes > 0,
              f"stream {name}: did not take the streaming device route")
        check([(r.offset, r.values_map) for r in results] == resident[name],
              f"stream {name}: results differ from the resident search")
        print(f"phase 7 stream {name!r}: {len(results)} results (= resident "
              f"search) in {secs:.3f} s | {stats.summary()}", flush=True)
    return launches

def run_cli(argv):
    """(return code, stdout, stderr, wall s) of one in-process call of the
    port's CLI."""
    import contextlib
    import io

    from monkey_moore_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = cli.main([str(a) for a in argv])
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def result_lines(found, width, endianness) -> str:
    """The CLI's result lines for [(offset, values map)]."""
    from monkey_moore_tpu_torch.tui import format_values

    return "".join(f"0x{off:X}\t{format_values(m, width, endianness)}\n"
                   for off, m in found)


def frontend_phase(torch, workdir: Path, path: Path, searches, resident,
                   batches, batch_found):
    """Phase 9: the user's entry points on the card over phase 4's file.
    The CLI in-process: ``search`` of phase 4's 8-bit and 16-bit BE
    keywords, each twice (output equal to phase 4's resident results,
    kernels A and B, never D or E), ``multi-search`` of phase 5's 8-bit
    batch (equal to phase 5, kernel C, never A), ``value-scan`` of the
    8-bit plant's byte values (every plant found) and ``export-tbl`` (the
    file equal to ``tables`` of phase 4's first result); one ``python -m
    monkey_moore_tpu_torch search`` in a subprocess (stdout equal to the
    in-process run); a ``Repl(device="cuda")`` session (two single
    searches, the second on the same resident corpus, a batch, a value
    scan, ``about`` naming the card); and an ``AsyncSearch`` aborted
    after its first chunk, then one that must equal phase 4.  Returns the
    launch counts of the in-process steps."""
    import io
    import os
    import shlex

    from monkey_moore_tpu_torch.async_search import (
        AsyncSearch,
        SearchEvent,
        step_message,
    )
    from monkey_moore_tpu_torch.config import (
        Endianness,
        SearchConfig,
        SearchStep,
    )
    from monkey_moore_tpu_torch.corpus import _cache, clear_corpus_cache
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.repl import Repl
    from monkey_moore_tpu_torch.tables import build_table_data, format_tbl

    total: dict = {}

    def read(step):
        launches = path_launches(scan_cuda, f"phase 9 {step}")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        scan_cuda.reset_launch_counts()
        print(f"phase 9 launches of {step}: {launches}", flush=True)
        return launches

    walls = {}
    little = Endianness.LITTLE
    clear_corpus_cache()  # the first search uploads the file
    scan_cuda.reset_launch_counts()
    outputs = {}
    for name, extra in (("8-bit", ["monkey"]),
                        ("16-bit BE", ["castle", "--width", "16",
                                       "--endian", "big"])):
        kwargs, _ = searches[name]
        want = result_lines(resident[name], kwargs.get("element_width", 1),
                            kwargs.get("endianness", little))
        for attempt in ("first", "repeat"):
            rc, out, err, wall = run_cli(["search", path, *extra,
                                          "--no-progress"])
            check(rc == 0 and out == want
                  and err == f"{len(resident[name])} result(s)\n",
                  f"phase 9 cli search {name!r} ({attempt}): rc {rc}, "
                  f"{err!r}, output differs from phase 4's")
            walls[f"cli search {name} {attempt}"] = wall
        outputs[name] = out
    launches = read("cli search")
    check(launches["tile_counts"] > 0 and launches["gather_tiles"] > 0
          and launches["tile_counts_elems"] == 0
          and launches["gather_tiles_block"] == 0,
          f"cli search: not kernels A and B alone: {launches}")

    words = [(spec if isinstance(spec, str) else spec["keyword"])
             .replace("*", "?") for spec, _ in batches["8-bit batch"][1]]
    rc, out, err, wall = run_cli(["multi-search", path, *words,
                                  "--wildcard", "?", "--no-progress"])
    want = "".join(f"# {kw}\n" + result_lines(found, 1, little)
                   for kw, found in zip(words, batch_found["8-bit batch"]))
    check(rc == 0 and out == want,
          f"phase 9 cli multi-search: rc {rc}, {err!r}, output differs "
          "from phase 5's")
    walls["cli multi-search K=8"] = wall
    launches = read("cli multi-search")
    check(launches["tile_counts_multi"] > 0 and launches["tile_counts"] == 0,
          f"cli multi-search: not kernel C alone: {launches}")

    planted8 = searches["8-bit"][1]
    values = [ord(c) + 3 for c in "monkey"]  # the 8-bit plants' bytes
    rc, out, err, wall = run_cli(["value-scan", path, *values,
                                  "--no-progress"])
    found = [int(line.split("\t")[0], 16) for line in out.splitlines()]
    check(rc == 0 and set(planted8) <= set(found),
          f"phase 9 cli value-scan: rc {rc}, {err!r}, plants "
          f"{sorted(set(planted8) - set(found))} not found")
    walls["cli value-scan"] = wall
    tbl = workdir / "monkey.tbl"
    rc, out, err, wall = run_cli(["export-tbl", path, "monkey", "-o", tbl,
                                  "--no-progress"])
    want_tbl = format_tbl(build_table_data(resident["8-bit"][0][1], 1,
                                           little)).encode("utf-8")
    check(rc == 0 and tbl.read_bytes() == want_tbl,
          f"phase 9 cli export-tbl: rc {rc}, {err!r}, table differs")
    launches = read("cli value-scan and export-tbl")
    check(launches["tile_counts"] > 0 and launches["tile_counts_elems"] == 0,
          f"cli value-scan / export-tbl: not kernel A: {launches}")

    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "monkey_moore_tpu_torch", "search", str(path),
         "monkey", "--no-progress"], cwd=root, capture_output=True,
        text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(root)))
    walls["python -m search (process)"] = time.perf_counter() - t0
    check(proc.returncode == 0 and proc.stdout == outputs["8-bit"],
          f"phase 9 python -m: rc {proc.returncode}, output differs from "
          f"the in-process run: {proc.stderr[-2000:]}")

    clear_corpus_cache()  # the session's first search uploads the file
    text = io.StringIO()
    repl = Repl(out=text, device="cuda")
    repl.execute(f"open {shlex.quote(str(path))}")
    for attempt in ("first", "repeat"):
        t0 = time.perf_counter()
        repl.execute("search monkey")
        walls[f"repl search 8-bit {attempt}"] = time.perf_counter() - t0
        check([(r.offset, r.values_map) for r in repl.last_results]
              == resident["8-bit"],
              f"phase 9 repl search ({attempt}) differs from phase 4's")
        if attempt == "first":
            check(len(_cache) == 1, "phase 9 repl: no resident corpus")
            corpus = next(iter(_cache.values()))
    check(len(_cache) == 1 and next(iter(_cache.values())) is corpus,
          "phase 9 repl: the repeat search did not reuse the corpus")
    t0 = time.perf_counter()
    repl.execute("search monkey sword potion")
    walls["repl batch K=3"] = time.perf_counter() - t0
    check([(r.offset, r.values_map) for r in repl.last_results]
          == [hit for i in (0, 2, 4) for hit in batch_found["8-bit batch"][i]],
          "phase 9 repl batch differs from phase 5's")
    repl.execute("value " + " ".join(map(str, values)))
    check(set(planted8) <= {r.offset for r in repl.last_results},
          "phase 9 repl value scan: plants not found")
    repl.execute("about")
    check(torch.cuda.get_device_name(0) in text.getvalue(),
          "phase 9 repl about does not name the card")
    read("repl")

    clear_corpus_cache()  # the aborted search uploads, then stops
    holder = {}
    searching = step_message(SearchStep.SEARCHING)

    def on_update(msg, pct):
        if msg == searching and 0 < pct < 100:  # past the first chunk
            holder["search"].abort()

    holder["search"] = aborted = AsyncSearch(
        SearchConfig(file_path=path, keyword="monkey"), on_update=on_update,
        device="cuda")
    t0 = time.perf_counter()
    aborted.start()
    check(aborted.join(timeout=600), "phase 9: the aborted search hung")
    walls["async aborted"] = time.perf_counter() - t0
    check(aborted.outcome is SearchEvent.ABORTED and aborted.results == [],
          f"phase 9 async: {aborted.outcome} {aborted.error}, not ABORTED")
    after = AsyncSearch(SearchConfig(file_path=path, keyword="monkey"),
                        device="cuda").start()
    check(after.join(timeout=600) and after.outcome is SearchEvent.COMPLETED
          and [(r.offset, r.values_map) for r in after.results]
          == resident["8-bit"],
          f"phase 9 async after the abort: {after.outcome} {after.error}")
    read("async")
    print("phase 9 walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()), flush=True)
    print(f"phase 9 frontends: cli search/multi-search/value-scan/export-tbl "
          f"equal to phases 4-5, python -m equal, repl and aborted "
          f"AsyncSearch checked; launches {total}", flush=True)
    return total


#: phases 10 and 11's gate: the JAX gate's seed and trial counts of
#: ``VERDICT.md``, which found 3 known divergences there (547/550)
GATE_SEED, GATE_TRIALS, GATE_MULTI, GATE_JAX_KNOWN = 424242, 150, 37, 3
GATE_JAX_PASSED = 547
#: phase 10's second seed, and what ``tools/conformance_gate.py --cpu
#: --trials 150 --seed 2024 --multi-trials 37`` prints there: 559/564 passed
#: with 5 known divergences
GATE_SEED_2, GATE_JAX_PASSED_2, GATE_JAX_KNOWN_2 = 2024, 559, 5


def gate_phase(torch):
    """Phase 10: the conformance gate's streaming pass on the card,
    ``conformance.run_gate(150, seed, 37, "cuda", streaming=True)`` at
    seeds 424242 and 2024: at each no failed check and the JAX gate's
    passed and known-divergence counts, and over both kernels A, B, D and
    E launched at its odd geometries (64-byte blocks, 4 KiB chunks, odd
    16-bit tails).  Returns their launch counts."""
    from monkey_moore_tpu_torch.conformance import run_gate, summary_line
    from monkey_moore_tpu_torch.ops import scan_cuda

    scan_cuda.reset_launch_counts()
    for seed, passed, known in ((GATE_SEED, GATE_JAX_PASSED, GATE_JAX_KNOWN),
                                (GATE_SEED_2, GATE_JAX_PASSED_2,
                                 GATE_JAX_KNOWN_2)):
        t0 = time.perf_counter()
        result = run_gate(GATE_TRIALS, seed, GATE_MULTI, device="cuda",
                          streaming=True)
        secs = time.perf_counter() - t0
        print(f"phase 10 gate (streaming pass), seed {seed}, {GATE_TRIALS} "
              f"trials and {GATE_MULTI} batch trials on the card in "
              f"{secs:.1f} s: {summary_line(result)}; the JAX gate on this "
              f"seed: {passed} passed, {known} known divergences", flush=True)
        for failure in result["failures"]:
            print("phase 10 FAIL:", failure, flush=True)
        check(result["failed"] == 0 and result["passed"] == passed
              and result["known_divergence"] == known,
              f"phase 10 gate, seed {seed}: not the JAX gate's {passed} "
              f"passed and {known} known divergences: "
              f"{summary_line(result)}")
    launches = dict(scan_cuda.launch_counts)
    aligned = dict(scan_cuda.aligned_launch_counts)
    check(all(launches[k] > 0 for k in ("tile_counts", "gather_tiles",
                                        "tile_counts_elems",
                                        "gather_tiles_block")),
          f"gate: kernels A, B, D and E not all launched: {launches}")
    print(f"phase 10 launches on the gate path: {launches}; gathers on the "
          f"bulk route: {aligned}", flush=True)
    return launches


#: phase 11 (c)'s worker: joins the gloo group, runs ``run_distributed``
#: for one keyword on ``cuda:0`` and on a two-shard mesh of it, and prints
#: the results, stats, walls and launch counts of both as one JSON line
MULTIHOST_WORKER = r"""
import json, sys, time
coord, pid, nproc, path, keyword = (sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4],
                                    sys.argv[5])
import torch
import torch.distributed as dist
from monkey_moore_tpu_torch.config import SearchConfig
from monkey_moore_tpu_torch.engine import SearchEngine
from monkey_moore_tpu_torch.ops import scan_cuda
from monkey_moore_tpu_torch.parallel.multihost import (
    initialize_distributed, process_count)

initialize_distributed(coord, nproc, pid)
assert process_count() == nproc
out = {}
for mode, devices in (("device", None), ("mesh", ["cuda:0"] * 2)):
    cfg = SearchConfig(file_path=path, keyword=keyword, devices=devices)
    engine = SearchEngine(cfg, device="cuda")
    scan_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    res = engine.run_distributed()
    torch.cuda.synchronize()
    st = engine.last_stats
    out[mode] = {
        "wall": time.perf_counter() - t0,
        "results": [[r.offset, sorted(r.values_map.items())] for r in res],
        "launches": dict(scan_cuda.launch_counts),
        "dispatches": st.device_dispatches, "chunks": st.chunks,
        "h2d_bytes": st.h2d_bytes, "ici_halo_bytes": st.ici_halo_bytes,
    }
print("RESULT:" + json.dumps(out), flush=True)
dist.destroy_process_group()
"""


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_phase(torch, path: Path, searches, resident, batches, batch_found):
    """Phase 11: the meshes and the multi-host search over phase 4's file
    (see the module docstring).  Returns the launch counts of the
    in-process mesh runs and of the two workers."""
    import os

    from monkey_moore_tpu_torch import bench_scaling
    from monkey_moore_tpu_torch.config import SearchConfig
    from monkey_moore_tpu_torch.conformance import run_gate, summary_line
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.multi import MultiSearcher
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.parallel.resident import (
        clear_sharded_corpus_cache,
    )

    t_phase = time.perf_counter()
    total: dict = {}

    def read(step, want, never, aligned=True):
        """The launch counts since the last reset, added to the mesh
        total: every kernel of *want* launched, none of *never*."""
        launches = (path_launches(scan_cuda, f"phase 11 {step}") if aligned
                    else dict(scan_cuda.launch_counts))
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        check(all(launches[k] > 0 for k in want)
              and all(launches[k] == 0 for k in never),
              f"phase 11 {step}: launches {launches}, want {want} and never "
              f"{never}")
        print(f"phase 11 launches of {step}: {launches}", flush=True)
        scan_cuda.reset_launch_counts()

    a_b = ("tile_counts", "gather_tiles")
    no_c_d_e = ("tile_counts_multi", "tile_counts_elems",
                "gather_tiles_block")
    cards = torch.cuda.device_count()
    meshes = [["cuda:0"] * 4]
    if cards > 1:
        meshes.append([f"cuda:{i}" for i in range(cards)])
    scan_cuda.reset_launch_counts()
    for devices in meshes:
        clear_sharded_corpus_cache()  # the first search uploads the file
        for name, (kwargs, planted) in searches.items():
            engine = SearchEngine(
                SearchConfig(file_path=path, devices=devices, **kwargs),
                device="cuda")
            walls = []
            for attempt in ("first", "repeat"):
                t0 = time.perf_counter()
                results = engine.run()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                found = [(r.offset, r.values_map) for r in results]
                check(found == resident[name],
                      f"phase 11 mesh {name!r} ({attempt}, {len(devices)} "
                      "shards): differs from phase 4's results")
            stats = engine.last_stats
            missing = sorted(set(planted) - {o for o, _ in found})
            check(not missing, f"phase 11 mesh {name!r}: not found {missing}")
            check(not stats.host_routed and stats.h2d_bytes == 0
                  and stats.device_dispatches
                  == kwargs.get("element_width", 1)
                  and len(stats.per_device_candidates or devices)
                  == len(devices),
                  f"phase 11 mesh {name!r}: not one resident mesh step per "
                  f"alignment: {stats.summary()}")
            if name == "8-bit wildcard":
                check(stats.fused_fallbacks > 0,
                      "phase 11: the overflow keyword did not fall back")
            print(f"phase 11 mesh {name!r} on {len(devices)} shards "
                  f"({devices[0]}...): {len(results)} results (= phase 4), "
                  f"first {walls[0]:.3f} s, repeat {walls[1]:.3f} s; "
                  f"device_dispatches {stats.device_dispatches}, "
                  f"ici_halo_bytes {stats.ici_halo_bytes}, "
                  f"per_device_candidates {stats.per_device_candidates}, "
                  f"fused_fallbacks {stats.fused_fallbacks}", flush=True)
    read("the resident mesh route", a_b, no_c_d_e)

    kwargs, _ = searches["8-bit"]
    engine = SearchEngine(SearchConfig(
        file_path=path, devices=meshes[0], resident_bytes_limit=0,
        **kwargs), device="cuda")
    t0 = time.perf_counter()
    results = engine.run()
    wall = time.perf_counter() - t0
    check([(r.offset, r.values_map) for r in results] == resident["8-bit"],
          "phase 11 chunked mesh step: differs from phase 4's results")
    print(f"phase 11 chunked mesh step '8-bit' on 4 shards: "
          f"{len(results)} results (= phase 4) in {wall:.3f} s | "
          f"{engine.last_stats.summary()}", flush=True)
    read("the chunked mesh step", a_b, no_c_d_e)

    mkwargs, planted = batches["8-bit batch"]
    specs = [spec for spec, _ in planted]
    ms = MultiSearcher(path, devices=meshes[0], device="cuda", **mkwargs)
    t0 = time.perf_counter()
    groups = ms.search(specs)
    wall = time.perf_counter() - t0
    check([[(r.offset, r.values_map) for r in g] for g in groups]
          == batch_found["8-bit batch"],
          "phase 11 mesh batch: differs from phase 5's results")
    print(f"phase 11 mesh batch K={len(specs)} on 4 shards: "
          f"{[len(g) for g in groups]} results (= phase 5) in {wall:.3f} s",
          flush=True)
    read("the mesh batch", ("tile_counts_multi", "gather_tiles"),
         ("tile_counts", "tile_counts_elems", "gather_tiles_block"))
    clear_sharded_corpus_cache()

    # (c) two processes on the one card, in a gloo group
    root = Path(__file__).resolve().parent
    coord = f"127.0.0.1:{free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, coord, str(pid), "2",
         str(path), kwargs["keyword"]],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(root))) for pid in range(2)]
    outs = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            check(proc.returncode == 0 and "RESULT:" in out,
                  f"phase 11 multi-host worker failed ({proc.returncode}): "
                  f"{err[-3000:]}")
            line = next(x for x in out.splitlines() if x.startswith("RESULT:"))
            outs.append(json.loads(line[len("RESULT:"):]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    want = json.loads(json.dumps(
        [[o, sorted(m.items())] for o, m in resident["8-bit"]]))
    hosts: dict = {}
    for pid, out in enumerate(outs):
        for mode, run in out.items():
            check(run["results"] == want,
                  f"phase 11 multi-host worker {pid} ({mode}): differs "
                  "from phase 4's results")
            launches = run["launches"]
            want_k, never_k = ((("tile_counts_elems", "gather_tiles_block"),
                                ("tile_counts", "gather_tiles"))
                               if mode == "device" else (a_b, no_c_d_e))
            check(all(launches[k] > 0 for k in want_k)
                  and all(launches[k] == 0 for k in never_k),
                  f"phase 11 multi-host worker {pid} ({mode}): launches "
                  f"{launches}")
            for name, n in launches.items():
                hosts[name] = hosts.get(name, 0) + n
            print(f"phase 11 multi-host worker {pid} ({mode}): "
                  f"{len(run['results'])} results (= phase 4) in "
                  f"{run['wall']:.3f} s; dispatches {run['dispatches']}, "
                  f"chunks {run['chunks']}, h2d_bytes {run['h2d_bytes']}, "
                  f"ici_halo_bytes {run['ici_halo_bytes']}; launches "
                  f"{launches}", flush=True)
    print(f"phase 11 multi-host: 2 processes x 2 runs in {wall:.1f} s "
          f"(process start-up included); launches {hosts}", flush=True)

    # (d) the gate's mesh pass
    scan_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_gate(GATE_TRIALS, GATE_SEED, GATE_MULTI, device="cuda")
    secs = time.perf_counter() - t0
    print(f"phase 11 gate (mesh pass), seed {GATE_SEED}, {GATE_TRIALS} "
          f"trials and {GATE_MULTI} batch trials on the card in "
          f"{secs:.1f} s: {summary_line(result)}", flush=True)
    for failure in result["failures"]:
        print("phase 11 FAIL:", failure, flush=True)
    check(result["failed"] == 0 and result["passed"] == GATE_JAX_PASSED
          and result["known_divergence"] == GATE_JAX_KNOWN,
          f"phase 11 gate: not the JAX gate's {GATE_JAX_PASSED} passed and "
          f"{GATE_JAX_KNOWN} known divergences: {summary_line(result)}")
    # the gate's tiny chunks may take the gathers' edge copy
    read("the gate's mesh pass", a_b, ("tile_counts_elems",
                                        "gather_tiles_block"), aligned=False)

    # (e) mesh sizes side by side over the file
    t0 = time.perf_counter()
    rows = bench_scaling.measure(path, kwargs["keyword"], (1, 2, 4), 3,
                                 "cuda")
    for d, row in rows.items():
        check(row["results"] == len(resident["8-bit"])
              and row["device_dispatches"] == 1
              and row["h2d_bytes_repeat"] == 0,
              f"phase 11 bench_scaling at {d} shards: {row}")
    print(f"phase 11 bench_scaling over {FILE_BYTES // MIB} MiB in "
          f"{time.perf_counter() - t0:.1f} s: {json.dumps(rows)}", flush=True)
    read("bench_scaling", a_b, no_c_d_e)
    print(f"phase 11 wall: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return total, hosts


def bench_phase(torch, err_i: int):
    """Phase 8: the benchmark path of ``monkey_moore_tpu_torch.bench`` at
    its full size, in-process.  The keyword is planted at two byte offsets
    that are not word-aligned, just past 2^31 and 2^32; the fused step must
    find both, and every offset it reports must hold the keyword (its
    adjacent differences, checked on the host from the bytes there).  Then
    the bench's timed paths run and its record is printed on a line of its
    own.  Kernel I is then held against its plain version and ``torch.sum``
    on the whole corpus and timed (after the launch counts are read), and
    timed again on the first 4 GiB, ``perf_probe``'s shape (kernel J): the
    kernel and ``torch.sum`` by back-to-back launches, the plain version by
    CUDA-event medians.  Returns the path's launch counts, kernel I's row
    of the kernels line, with J's figures under ``"j_4gib"``, and the
    bench's record; ``err_i`` is phase 3's largest difference of kernel
    I."""
    import numpy as np

    from monkey_moore_tpu_torch import bench
    from monkey_moore_tpu_torch.bench import (
        HBM_BYTES_PER_S,
        back_to_back_ms,
        bound,
    )
    from monkey_moore_tpu_torch.corpus import clear_corpus_cache
    from monkey_moore_tpu_torch.dense import fused_count_extract
    from monkey_moore_tpu_torch.ops import scan_cuda
    from monkey_moore_tpu_torch.ops.host import LANES
    from monkey_moore_tpu_torch.pattern import compile_pattern

    clear_corpus_cache()
    torch.cuda.empty_cache()
    conf = bench.settings()
    n = conf.pop("mb") * MIB
    device = torch.device("cuda")
    problem = bench.check_memory(device, n)
    check(problem is None, str(problem))
    pat = compile_pattern(bench.KEYWORD)
    plants = [2**31 + 1, 2**32 + 3]
    check(plants[-1] + pat.length <= n, f"a {n}-byte corpus is too small")

    scan_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    words = bench.make_corpus(n, SEED, device)
    raw = words.view(torch.uint8)
    kw = (np.array(pat.keyword, dtype=np.int64) + 7) % 256
    for off in plants:
        raw[off : off + pat.length] = torch.tensor(kw, dtype=torch.uint8,
                                                  device=device)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    te = conf["tile_rows"] * LANES
    offs, _, info = fused_count_extract(
        pat, bench.tile_view(words, n, te), n, tile_elems=te,
        k_cap=conf["k_cap"])
    found = offs.tolist()
    missing = sorted(set(plants) - set(found))
    check(not missing, f"bench: planted offsets not found: {missing}")
    want = np.diff(np.array(pat.keyword, dtype=np.int64)) % 256
    for off in found:
        check(0 <= off and off + pat.length <= n,
              f"bench: offset {off} outside the corpus")
        got = raw[off : off + pat.length].cpu().numpy().astype(np.int64)
        check(bool((np.diff(got) % 256 == want).all()),
              f"bench: offset {off} does not hold the keyword: {got}")
    name = torch.cuda.get_device_name(device)
    record = bench.measure(words, n, device_name=name, **conf)
    launches = path_launches(scan_cuda, "phase 8")
    check(launches["load_sum"] >= 1 and launches["tile_counts"] >= 1
          and launches["gather_tiles"] >= 1,
          f"kernels not launched on the bench path: {launches}")
    print(json.dumps(record), flush=True)
    shares = {"pct_hbm_roofline": record.get("pct_hbm_roofline", 0.0),
              "pure load % of 3.35 TB/s":
                  100.0 * record["pure_load_bytes_per_s"] / HBM_BYTES_PER_S}
    check(all(v <= 105.0 for v in shares.values()),
          f"bench: a share over 105% means broken timing: {shares}")

    tw = bench.LOAD_TILE_WORDS
    n_load = n // bench.LOAD_TILE_BYTES
    body = words[: n_load * tw]
    sums, total = scan_cuda.load_sum(body, tw)
    p_sums, p_total = scan_cuda.load_sum_plain(body, tw)
    library = torch.sum(body, dtype=torch.int32)
    err = max(err_i, int((sums.long() - p_sums.long()).abs().max()),
              abs(int(total) - int(p_total)), abs(int(total) - int(library)))
    check(err == 0, f"kernel I differs from its plain version by {err}")

    def load_times(words_in, reps):
        """(kernel ms, plain ms, torch.sum ms, bound ms, bound by)"""
        tiles = words_in.numel() // tw
        # read every word once, write the sums and the total; one add per
        # word
        return (back_to_back_ms(lambda: scan_cuda.load_sum(words_in, tw),
                                reps)[0],
                time_ms(torch, lambda: scan_cuda.load_sum_plain(words_in, tw),
                        3),
                back_to_back_ms(lambda: torch.sum(words_in,
                                                  dtype=torch.int32),
                                reps)[0],
                *bound(tiles * bench.LOAD_TILE_BYTES + tiles * 4 + 4,
                       tiles * tw))

    i_ms, i_plain, i_library, bound_ms, bound_by = load_times(body, 50)
    j_words = min(n_load, (4 << 30) // bench.LOAD_TILE_BYTES) * tw
    j = dict(zip(("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                 load_times(body[:j_words], 100)), bytes=j_words * 4)
    print(f"phase 8 bench: {n // MIB} MiB generated and planted in "
          f"{t_fill:.3f} s; plants at {plants} found among {len(found)} "
          f"offsets, each holding the keyword (hot tiles "
          f"{info.hot_tiles}); shares {shares}; I == plain == torch.sum on "
          f"{n_load} tiles: I {i_ms:.4f} ms vs {i_plain:.4f} ms plain, "
          f"torch.sum {i_library:.4f} ms, bound {bound_ms:.4f} ms; on the "
          f"first {j['bytes'] // MIB} MiB (J): {j['ms']:.4f} ms vs "
          f"{j['plain_ms']:.4f} ms plain, torch.sum {j['library_ms']:.4f} "
          f"ms, bound {j['bound_ms']:.4f} ms", flush=True)
    print(f"phase 8 launches on the bench path: {launches}", flush=True)
    del words, raw, body, sums, p_sums
    torch.cuda.empty_cache()
    return launches, {
        "name": "load_sum", "route": "cuda",
        "source": "monkey_moore_tpu_torch/csrc/load_sum.cu",
        "replaces": "bench.py:241", "max_abs_err": err, "ms": i_ms,
        "plain_ms": i_plain, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": i_library, "j_4gib": j,
    }, record


#: phase 12's sizes: ``bench_all``'s corpus (the headline's 12 GiB), the
#: ``ab`` probe's corpus, the baseline configurations' divisor and the
#: crossover's file sizes
HARNESS_BENCH_MB, HARNESS_PROBE_MB, HARNESS_SCALE = 12288, 4096, 1
CROSSOVER_MIB = (4, 16, 64)


def holds_keyword(torch, raw, pat, width: int, offsets, what: str) -> None:
    """Fails unless every element offset in *offsets* starts a window of
    the u8 buffer *raw* (the elements' bytes, LE) that matches *pat*:
    the windows' bytes are gathered on the card, copied in one piece and
    matched on the host."""
    import numpy as np

    from monkey_moore_tpu_torch.ops.scan_np import match_positions_np

    if len(offsets) == 0:
        return
    span = pat.length * width
    start = torch.as_tensor(np.asarray(offsets, dtype=np.int64) * width,
                            device=raw.device)
    check(int(start.min()) >= 0 and int(start.max()) + span <= raw.numel(),
          f"{what}: an offset outside the corpus")
    idx = start[:, None] + torch.arange(span, device=raw.device)
    segs = raw[idx].cpu().numpy()
    if width == 2:
        segs = segs.view("<u2")
    bad = [int(o) for o, seg in zip(offsets, segs)
           if 0 not in match_positions_np(pat, seg)]
    check(not bad, f"{what}: offsets not holding the keyword: {bad[:10]}")


def suites_phase(torch, bench_record):
    """Phase 12 (a): ``bench_all``'s suites in-process at 12 GiB with
    plants; returns the path's launch counts."""
    import numpy as np

    from monkey_moore_tpu_torch import bench_all
    from monkey_moore_tpu_torch.bench import check_memory
    from monkey_moore_tpu_torch.ops import scan_cuda

    torch.cuda.empty_cache()
    n = HARNESS_BENCH_MB * MIB
    device = torch.device("cuda")
    problem = check_memory(device, n)
    check(problem is None, str(problem))
    kw = np.array([ord(c) for c in "abcde"], dtype=np.int64)
    plants8 = [2**31 + 1, 2**32 + 3]  # byte offsets, not word-aligned
    plants16 = [2**30 + 1001, 2**31 + 3001]  # element offsets
    check(2 * (plants16[-1] + 5) <= n, f"a {n}-byte corpus is too small")

    scan_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    words = bench_all.suite_corpus(n, device)
    raw = words.view(torch.uint8)
    for i, off in enumerate(plants8):
        raw[off : off + 5] = torch.tensor((kw + 9 * i) % 256,
                                          dtype=torch.uint8, device=device)
    elems = words.view(torch.int16)
    for i, e in enumerate(plants16):
        elems[e : e + 5] = torch.tensor(kw + 0x3000 + 0x100 * i,
                                        dtype=torch.int16, device=device)
    torch.cuda.synchronize()
    t_fill = time.perf_counter() - t0
    records, details = bench_all.run_suites(words, n, iters=3, warmup=3,
                                            depth=3)
    launches = path_launches(scan_cuda, "phase 12 bench_all")
    for name, keyword, wildcard, width in bench_all.SUITES:
        m = details[name]
        got = m["launches"]
        check(got["tile_counts"] > 0 and got["gather_tiles"] > 0
              and got["tile_counts_multi"] == got["tile_counts_elems"]
              == got["gather_tiles_block"] == 0,
              f"phase 12 suite {name}: not kernels A and B alone: {got}")
        found = m["offsets"].tolist()
        planted = plants8 if width == 1 else plants16
        missing = sorted(set(planted) - set(found))
        check(not missing, f"phase 12 suite {name}: not found {missing}")
        holds_keyword(torch, raw, bench_all.suite_pattern(
            keyword, wildcard, width), width, found, f"phase 12 {name}")
        print(f"phase 12 suite {name}: {len(found)} offsets, each holding "
              f"the keyword, plants found; hot tiles {m['info'].hot_tiles}, "
              f"k_cap fallbacks {m['fallbacks']}, launches {got}",
              flush=True)
    print(json.dumps({"bench_all_suites": records}), flush=True)
    rate8 = records["BM_Search/Relative/8-Bit"]["bytes_per_s"]
    print(f"phase 12 bench_all: {n // MIB} MiB generated and planted in "
          f"{t_fill:.3f} s; 8-bit suite {rate8 / 1e9:.1f} GB/s beside phase "
          f"8's fused step {bench_record['value'] / 1e9:.1f} GB/s "
          f"({100.0 * rate8 / bench_record['value']:.1f}%)", flush=True)
    del words, raw, elems
    torch.cuda.empty_cache()
    rates, _ = bench_all.sweep(3, "cuda")
    check(list(rates) == [str(size) for size in bench_all.SWEEP_SIZES],
          f"phase 12 bench_all ladder: {rates}")
    return launches


def baseline_phase(torch):
    """Phase 12 (b): the five baseline configurations at full size;
    returns the path's launch counts (the worker processes' not
    included)."""
    from monkey_moore_tpu_torch import bench_baseline_configs
    from monkey_moore_tpu_torch.ops import scan_cuda

    with tempfile.TemporaryDirectory(prefix="mm_chip_baseline_") as tmp:
        out = Path(tmp) / "baseline.json"
        scan_cuda.reset_launch_counts()
        t0 = time.perf_counter()
        rc = bench_baseline_configs.main(["--scale", str(HARNESS_SCALE),
                                          "--iters", "2", "--json",
                                          str(out)])
        wall = time.perf_counter() - t0
        launches = path_launches(scan_cuda, "phase 12 baseline")
        check(rc == 0, f"phase 12 baseline configs: rc {rc}")
        blob = json.loads(out.read_text())
    rows = blob["rows"]
    check(len(rows) == 6 and all(r["planted_found"] for r in rows),
          "phase 12 baseline: not six rows with their plants found")
    check(rows[-1]["route"] == "device"
          and rows[-1]["first_run_includes_upload"],
          f"phase 12 baseline: the 1 GB row took {rows[-1]['route']}")
    check(launches["tile_counts"] > 0 and launches["gather_tiles"] > 0,
          f"phase 12 baseline: kernels A and B not launched: {launches}")
    for r in rows:
        print(f"phase 12 baseline {r['config'][:40]!r}: {r['size_bytes']} "
              f"bytes [{r['route']}] {r['bytes_per_s'] / 1e9:.3f} GB/s "
              f"repeat, first {r['first_run_s']:.3f} s, {r['results']} "
              f"results, kernels {r['kernels']}", flush=True)
    print(f"phase 12 baseline multi_shard {rows[-1]['multi_shard']}; "
          f"multi_host {rows[-1]['multi_host']}; {wall:.1f} s", flush=True)
    return launches


def probe_ab_phase(torch):
    """Phase 12 (c): ``perf_probe --stage ab``; returns its launches."""
    import contextlib
    import io

    from monkey_moore_tpu_torch import perf_probe
    from monkey_moore_tpu_torch.ops import scan_cuda

    torch.cuda.empty_cache()
    out = io.StringIO()
    scan_cuda.reset_launch_counts()
    with contextlib.redirect_stdout(out):
        rc = perf_probe.main(["--stage", "ab", "--mb",
                              str(HARNESS_PROBE_MB)])
    launches = path_launches(scan_cuda, "phase 12 probe_ab")
    print(out.getvalue(), end="", flush=True)
    check(rc == 0, f"phase 12 perf_probe ab: rc {rc} (the gathers' combo "
          "buffers differ, or a failure)")
    ab = [json.loads(x) for x in out.getvalue().splitlines()
          if x.startswith('{"probe": "ab_')]
    check(len(ab) == 3 and len({(r["hot"], r["fallback"]) for r in ab}) == 1,
          f"phase 12 perf_probe ab: records {ab}")
    check(launches["gather_tiles"] > 0 and launches["gather_tiles_block"] > 0,
          f"phase 12 perf_probe ab: B and E not both launched: {launches}")
    return launches


def tui_phase() -> None:
    """Phase 12 (d): ``tui_smoke`` on the card, in its own processes."""
    import os

    root = Path(__file__).resolve().parent
    proc = subprocess.run(
        [sys.executable, "-m", "monkey_moore_tpu_torch.tui_smoke"],
        cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root)))
    check(proc.returncode == 0,
          f"phase 12 tui_smoke: rc {proc.returncode}: {proc.stdout[-2000:]}"
          f"{proc.stderr[-2000:]}")
    print(f"phase 12 tui_smoke on the card: {proc.stdout.strip()!r} (its "
          "50 KB ROM rides the host route: no kernel launch)", flush=True)


def crossover_phase(torch):
    """Phase 12 (e): one 8-bit search at each of :data:`CROSSOVER_MIB` on
    the host route (the default threshold, 64 MiB, keeps them there) and
    on the device route (``host_latency_threshold_bytes=0``): the first
    search and the best of three repeats, results equal.  Returns the
    device route's launch counts."""
    import numpy as np

    from monkey_moore_tpu_torch.config import SearchConfig
    from monkey_moore_tpu_torch.corpus import clear_corpus_cache
    from monkey_moore_tpu_torch.engine import SearchEngine
    from monkey_moore_tpu_torch.ops import scan_cuda

    rng = np.random.default_rng(SEED + 12)
    kw = (np.array([ord(c) for c in "monkey"]) + 3).astype(np.uint8)
    rows = {}
    total: dict = {}
    with tempfile.TemporaryDirectory(prefix="mm_chip_crossover_") as tmp:
        for mib in CROSSOVER_MIB:
            n = mib * MIB
            data = np.frombuffer(rng.bytes(n), dtype=np.uint8).copy()
            plants = [11, n // 2 + 1, n - 6]
            for off in plants:
                data[off : off + 6] = kw
            path = Path(tmp) / f"x{mib}.bin"
            data.tofile(path)
            row = {}
            for route, threshold in (("host", None), ("device", 0)):
                extra = ({} if threshold is None
                         else {"host_latency_threshold_bytes": threshold})
                cfg = SearchConfig(file_path=path, keyword="monkey", **extra)
                clear_corpus_cache()
                scan_cuda.reset_launch_counts()
                times = []
                for _ in range(4):  # the first search, then three repeats
                    engine = SearchEngine(cfg, device="cuda")
                    t0 = time.perf_counter()
                    found = engine.run()
                    torch.cuda.synchronize()
                    times.append(time.perf_counter() - t0)
                launches = path_launches(scan_cuda, f"phase 12 crossover "
                                                    f"{mib} MiB {route}")
                check(engine.last_stats.host_routed == (route == "host"),
                      f"phase 12 crossover {mib} MiB: not the {route} route")
                offs = [r.offset for r in found]
                check(set(plants) <= set(offs),
                      f"phase 12 crossover {mib} MiB {route}: plants missing")
                row[route] = {"first_s": times[0],
                              "repeat_s": min(times[1:]), "offsets": offs}
                if route == "device":
                    check(launches["tile_counts"] > 0,
                          "phase 12 crossover: kernel A not launched")
                    for name, k in launches.items():
                        total[name] = total.get(name, 0) + k
            check(row["host"]["offsets"] == row["device"]["offsets"],
                  f"phase 12 crossover {mib} MiB: the routes differ")
            rows[mib] = {route: {k: v for k, v in r.items() if k != "offsets"}
                         for route, r in row.items()}
            path.unlink()
    clear_corpus_cache()
    print(f"phase 12 crossover (8-bit 'monkey', seconds): {json.dumps(rows)}",
          flush=True)
    return total


def harness_phase(torch, bench_record) -> dict:
    """Phase 12: the harnesses (see the module docstring); returns the
    launch counts of its paths."""
    t0 = time.perf_counter()
    launches = {"bench_all": suites_phase(torch, bench_record),
                "baseline": baseline_phase(torch),
                "probe_ab": probe_ab_phase(torch)}
    tui_phase()
    launches["crossover"] = crossover_phase(torch)
    print(f"phase 12 wall: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from monkey_moore_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"phase 1 env: torch {torch.__version__} (CUDA "
          f"{torch.version.cuda}), device {name!r}, nvidia-smi: {smi}, "
          f"nvcc: {nvcc_release(_build.find_nvcc())}", flush=True)

    from monkey_moore_tpu_torch.ops.probe import probe

    t0 = time.perf_counter()
    lib = _build.build_library()
    _build.load_library()
    print(f"phase 2 build: {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    report = probe()
    check(report.library is not None and len(report.kernels) == 4
          and all(k.launched and k.matched for k in report.kernels),
          f"probe: {report}")
    print("phase 2 probe: " + ", ".join(
        f"{k.name} launched and matched" for k in report.kernels),
        flush=True)

    kernels, err_i = kernel_phase(torch)
    with tempfile.TemporaryDirectory(prefix="mm_chip_smoke_") as tmp:
        launches = {}
        launches["search"], path, searches, resident, batches = slice_phase(
            torch, Path(tmp))
        launches["batch"], batch_found = batch_phase(torch, path, batches)
        launches["memory"] = memory_phase(torch, path, searches)
        launches["stream"] = stream_phase(torch, path, searches, resident)
        launches["cli"] = frontend_phase(torch, Path(tmp), path, searches,
                                         resident, batches, batch_found)
        launches["gate"] = gate_phase(torch)
        launches["mesh"], launches["multihost"] = mesh_phase(
            torch, path, searches, resident, batches, batch_found)
    launches["bench"], load_row, bench_record = bench_phase(torch, err_i)
    kernels.append(load_row)
    launches.update(harness_phase(torch, bench_record))
    for row in kernels:
        by_path = {name: counts[row["name"]]
                   for name, counts in launches.items()}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
