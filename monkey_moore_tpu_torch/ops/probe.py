"""Backend probe: what this process can run the CUDA kernels with.

The counterpart of the JAX package's ``scan_pallas.pallas_compute_mode``
and ``pallas_gather_mode``.  It reports; it does not choose a fallback.  A
CUDA tensor always goes through the kernels, and a missing piece raises
there.
"""

from __future__ import annotations

import subprocess
from typing import NamedTuple, Optional

__all__ = ["Probe", "probe"]


class Probe(NamedTuple):
    cuda: bool  #: torch sees a CUDA device
    nvcc: Optional[str]  #: path of the CUDA compiler, or None
    library: Optional[str]  #: path of the built and loaded kernel library
    error: Optional[str] = None  #: why the library did not build or load


def probe() -> Probe:
    """Report CUDA, nvcc and the kernel library.  Builds the library when
    CUDA and nvcc are both present (the first call takes the build time)."""
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
    return Probe(cuda, nvcc, str(build_library()))
