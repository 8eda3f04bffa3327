"""Time kernel K, the exact match-and-compact scan, on one CUDA card.

``python -m monkey_moore_tpu_torch.compact_bench [--against CSRC]``

Builds this checkout's ``csrc/match_compact.cu`` into a library of its own
and times its entry point ``mm_match_compact`` on the regimes of
``chip_smoke.py`` phase 13 (:data:`CASES`, over a 512 MiB chunk), each by
``bench.back_to_back_ms``: many launches between one pair of CUDA events.
Every output (count, offsets, values) must equal the plain version's
(``ops.scan_cuda.scan_chunk_plain``).  Each record of this checkout's
kernel also holds ``kernels_ms``, the device time per call of each of its
launches (count, scan, emit) from a ``torch.profiler`` trace, ``{}`` when
the trace records no device time.

``--against CSRC`` also builds another checkout's ``match_compact.cu``
(e.g. the parent commit's, unpacked with ``git archive``), whose entry
point must take the same arguments, and times it in turns with this one:
against, this, this, against.  Prints one JSON object per record, then the
card's ``nvidia-smi`` name and power limit.  Without a card it exits 1.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .bench import back_to_back_ms, bound
from .ops import scan_cuda
from .ops._build import compile_library, open_library
from .ops.scan_torch import pattern_device_args
from .pattern import compile_pattern

__all__ = ["CASES", "CAPACITY", "ramp_words", "ramp_count", "case_data",
           "k_bound", "build_all", "run_k", "kernel_ms", "main"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "match_compact.cu"
BUILD = _PKG / "_build" / "compact_bench"
CHUNK_BYTES = 512 << 20
SEED = 20261016 + 13
#: launches between one pair of CUDA events
LAUNCHES = 50
#: offsets kept per call in every regime
CAPACITY = 4096
#: calls traced for :func:`kernel_ms`
TRACED = 10

#: phase 13's regimes, (element width, keyword, wildcard, plants, data):
#: seeded random words with the keyword planted (shifted by 5) for the
#: signed branch ("abcde") and the unsigned one ("ab*de"), at u8 and u16,
#: then with more plants than :data:`CAPACITY`; and a ramp
#: (:func:`ramp_words`) at u8 and u16
CASES = [
    (1, "abcde", 0, 64, "random"), (1, "ab*de", "*", 64, "random"),
    (2, "abcde", 0, 64, "random"), (2, "ab*de", "*", 64, "random"),
    (1, "abcde", 0, CAPACITY + 904, "random"),
    (1, "abcde", 0, 0, "ramp"), (2, "abcde", 0, 0, "ramp"),
]


def ramp_words(n: int, width: int, device) -> torch.Tensor:
    """``n`` elements ``x[i] = i mod 2^(8 * width)`` as int32 words: every
    window of a keyword of adjacent differences +1 passes the test mod
    2^(8 * width), and the exact test fails the windows that cross the
    wrap from 2^(8 * width) - 1 to 0 (a difference of 1 - 2^(8 * width))."""
    idx = torch.arange(n, dtype=torch.int32, device=device)
    if width == 1:
        elems = (idx & 0xFF).to(torch.uint8)
    else:  # the u16 value's int16 bits, converted exactly
        elems = (((idx & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.int16)
    return elems.view(torch.int32)


def ramp_count(windows: int, width: int, length: int) -> int:
    """Windows ``e < windows`` of a ramp whose ``length`` elements do not
    cross the wrap: ``e mod 2^(8 * width) <= 2^(8 * width) - length``."""
    m = 1 << (8 * width)
    keep = m - length + 1
    return windows // m * keep + min(windows % m, keep)


def case_data(case, gen: torch.Generator, device="cuda",
              chunk_bytes: int = CHUNK_BYTES):
    """``(data, valid, pat, plants)`` of one of :data:`CASES`: the u8 or
    u16 elements of ``chunk_bytes`` (random words from *gen*, or a ramp),
    the valid count (1234 elements short of the end) and the planted
    element offsets."""
    width, keyword, wildcard, n_plants, kind = case
    dtype = np.uint8 if width == 1 else np.uint16
    pat = compile_pattern(keyword, wildcard, dtype=dtype)
    n = chunk_bytes // width
    valid = n - 1234
    plants = []
    if kind == "ramp":
        words = ramp_words(n, width, device)
    else:
        words = torch.randint(-(2**31), 2**31, (chunk_bytes // 4,),
                              dtype=torch.int32, device=device,
                              generator=gen)
        step = (valid - pat.length) // n_plants
        plants = [1 + i * step + (i % 3) for i in range(n_plants)]
        elems = words.view(torch.uint8 if width == 1 else torch.int16)
        kv = (np.array(pat.keyword, dtype=np.int64) + 5) % (1 << (8 * width))
        kv_t = torch.tensor(kv.astype(np.int64), device=device).to(
            elems.dtype)
        for pos in plants:
            elems[pos : pos + pat.length] = kv_t
    return (words.view(torch.uint8 if width == 1 else torch.uint16), valid,
            pat, plants)


def k_bound(n: int, width: int, valid: int, length: int,
            capacity: int) -> tuple[float, str]:
    """``bench.bound`` of one call of K: the array read once and the
    outputs written once; every window start needs the first check's
    difference and compare."""
    return bound(n * width + 4 + capacity * (4 + 2 * width),
                 2 * (valid - length + 1))


def build_all(against: str | None) -> dict[str, ctypes.CDLL]:
    """``{tag: library}``: this checkout's ``match_compact.cu`` and the
    ``--against`` one, each built by ``ops._build``, started together."""
    jobs = {"this": SOURCE}
    if against:
        jobs["against"] = Path(against) / "match_compact.cu"
        if not jobs["against"].exists():
            raise RuntimeError(f"{against}: no match_compact.cu")
    with ThreadPoolExecutor(len(jobs)) as pool:
        paths = {tag: pool.submit(compile_library, [src], BUILD / f"{tag}.so")
                 for tag, src in jobs.items()}
        return {tag: open_library(path.result())
                for tag, path in paths.items()}


def run_k(lib, data, valid, tables, pat, capacity):
    """One launch of *lib*'s kernel K: ``(count, offsets, values)``."""
    return scan_cuda.launch_match_compact(
        lib, data, valid, *tables, length=pat.length,
        signed_compare=pat.signed_compare, capacity=capacity)


def kernel_ms(call) -> dict[str, float]:
    """``{kernel: device ms per call}`` of the CUDA kernels that
    :data:`TRACED` calls of *call* launch, from a ``torch.profiler`` trace
    (a kernel's name is its identifier and template argument); ``{}``
    when the trace
    records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACED):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0)
        if us > 0:
            found = re.search(r"\w+_kernel(<\d+>)?", ev.key)
            name = found.group(0) if found else ev.key
            out[name] = out.get(name, 0.0) + us / 1000 / TRACED
    return out


def _same(got, want) -> bool:
    return all(torch.equal(g.view(torch.int16) if g.dtype == torch.uint16
                           else g,
                           w.view(torch.int16) if w.dtype == torch.uint16
                           else w)
               for g, w in zip(got, want))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", help="another checkout's csrc/ directory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compact_bench: no CUDA device", file=sys.stderr)
        return 1
    libs = build_all(args.against)
    order = ["against", "this", "this", "against"] if args.against else [
        "this"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for case in CASES:
        data, valid, pat, plants = case_data(case, gen)
        tables = pattern_device_args(pat, "cuda")
        want = scan_cuda.scan_chunk_plain(
            data, valid, *tables, length=pat.length,
            signed_compare=pat.signed_compare, capacity=CAPACITY)
        width, keyword, _, _, kind = case
        bound_ms, by = k_bound(data.numel(), width, valid, pat.length,
                               CAPACITY)
        for turn, tag in enumerate(order):
            def call(lib=libs[tag]):
                return run_k(lib, data, valid, tables, pat, CAPACITY)

            if not _same(call(), want):
                raise RuntimeError(f"{tag} differs from the plain version on "
                                   f"{case}")
            ms, host = back_to_back_ms(call, LAUNCHES)
            record = dict(
                keyword=keyword, width=width, data=kind, planted=len(plants),
                count=int(want[0]), capacity=CAPACITY, lib=tag, ms=ms,
                host_ms=host, bound_ms=bound_ms, bound_by=by,
                pct_of_bound=100 * bound_ms / ms)
            if tag == "this" and order.index("this") == turn:
                record["kernels_ms"] = kernel_ms(call)
            print(json.dumps(record), flush=True)
        del data, tables, want
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
