"""Backend probe: what this process can run the CUDA kernels with.

The counterpart of the JAX package's ``scan_pallas.pallas_compute_mode``
and ``pallas_gather_mode`` with their probe kernels
(``_run_probe_kernel``, ``_run_probe_gather``, ``_run_probe_gather_dma``).
It reports; it does not choose a route.  A CUDA tensor always goes through
the kernels, and a missing piece raises there.

Where the TPU probes compile a throwaway kernel, :func:`probe` launches the
port's own kernels once each at the probes' tiny shapes — the counts
kernels A and D (the ``(8, 128)`` int32 and ``(32, 128)`` u8 / ``(16,
128)`` u16 probes), the block gather E (``(24, 128)`` int32, two ids) and
the gather B (same, ``k_cap`` 2) — and holds each output against its plain
version.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple, Optional, Tuple

__all__ = ["KernelProbe", "Probe", "probe"]


class KernelProbe(NamedTuple):
    name: str  #: the wrapper's name in ``scan_cuda.launch_counts``
    launched: bool  #: the wrapper launched its kernel
    matched: bool  #: the output equals the plain version's
    error: Optional[str] = None  #: why the launch failed


class Probe(NamedTuple):
    cuda: bool  #: torch sees a CUDA device
    nvcc: Optional[str]  #: path of the CUDA compiler, or None
    library: Optional[str]  #: path of the built and loaded kernel library
    error: Optional[str] = None  #: why the library did not build or load
    #: one entry per kernel launched (none without a card and a library)
    kernels: Tuple[KernelProbe, ...] = ()


def probe() -> Probe:
    """Report CUDA, nvcc and the kernel library, and launch kernels A, D, E
    and B once each.  Builds the library when CUDA and nvcc are both
    present (the first call takes the build time)."""
    import torch

    from ._build import build_library, find_nvcc, load_library

    cuda = torch.cuda.is_available()
    nvcc = find_nvcc()
    if not (cuda and nvcc):
        return Probe(cuda, nvcc, None)
    try:
        load_library()
    except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
        return Probe(cuda, nvcc, None, str(exc))
    return Probe(cuda, nvcc, str(build_library()),
                 kernels=tuple(_probe_kernels(torch, torch.device("cuda"))))


def _probe_cases(torch, dev):
    """``(name, kernel call, plain call)`` per probe launch, on *dev*."""
    import numpy as np

    from ..pattern import compile_pattern
    from . import scan_cuda

    # byte ramps: "abcde" (diffs of 1) matches almost every window
    ramp = (torch.arange(24 * 128 * 4, device=dev) % 251).to(torch.uint8)
    words = ramp[: 8 * 128 * 4].view(torch.int32)
    u8 = ramp[: 32 * 128]
    u16 = (torch.arange(16 * 128, device=dev) % 4093).to(torch.int16).view(
        torch.uint16)
    cases = []
    pat8 = compile_pattern("abcde")
    chk8 = scan_cuda.prefilter_operand(pat8, dev)
    args = dict(tile_elems=1024, length=5, valid_count=4 * 1024 - 3)
    cases.append(("tile_counts",
                  lambda: scan_cuda.tile_counts(words, chk8, width=1, **args),
                  lambda: scan_cuda.tile_counts_plain(words, chk8, width=1,
                                                      **args)))
    for elems, dtype in ((u8, np.uint8), (u16, np.uint16)):
        chk = scan_cuda.prefilter_operand(
            compile_pattern("abcde", dtype=dtype), dev)
        eargs = dict(tile_elems=512, length=5,
                     valid_count=elems.numel() - 3)
        cases.append((
            "tile_counts_elems",
            lambda e=elems, c=chk, a=eargs: scan_cuda.tile_counts_elems(
                e, c, **a),
            lambda e=elems, c=chk, a=eargs: scan_cuda.tile_counts_elems_plain(
                e, c, **a)))
    hot = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    tile = 8 * 128 * 4  # the probes' 8 rows of 128 int32 lanes, in bytes
    cases.append(("gather_tiles_block",
                  lambda: scan_cuda.gather_tiles_block(ramp, hot,
                                                       tile_elems=tile),
                  lambda: scan_cuda.gather_tiles_block_plain(
                      ramp, hot, tile_elems=tile)))
    cases.append(("gather_tiles",
                  lambda: scan_cuda.gather_tiles(ramp, hot, width=1,
                                                 tile_elems=tile),
                  lambda: scan_cuda.gather_tiles_plain(ramp, hot, width=1,
                                                       tile_elems=tile)))
    return cases


def _probe_kernels(torch, dev):
    from . import scan_cuda

    results = {}
    for name, run, plain in _probe_cases(torch, dev):
        before = scan_cuda.launch_counts[name]
        try:
            got = run()
            torch.cuda.synchronize(dev)
        except RuntimeError as exc:  # a failed build, launch or run
            results[name] = KernelProbe(name, False, False, str(exc))
            continue
        launched = scan_cuda.launch_counts[name] > before
        matched = torch.equal(got, plain())
        prior = results.get(name, KernelProbe(name, True, True))
        results[name] = prior._replace(
            launched=prior.launched and launched,
            matched=prior.matched and matched,
        )
    return list(results.values())
