"""Device tracing for the PyTorch port.

The counterpart of the JAX package's ``profiling.device_trace``: with
``MMTPU_TRACE_DIR`` set (or a directory given), a search runs under
``torch.profiler`` and writes a Chrome trace there.  The stage timer and
stats are the JAX package's own (``monkey_moore_tpu.profiling``), which
load no jax.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Iterator, Optional

from monkey_moore_tpu.profiling import SearchStats, StageTimer

__all__ = ["SearchStats", "StageTimer", "device_trace"]


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` wrapper; no-op when no directory is given and
    ``MMTPU_TRACE_DIR`` is unset."""
    log_dir = log_dir or os.environ.get("MMTPU_TRACE_DIR")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(
        str(out / f"trace_{os.getpid()}_{time.time_ns()}.json")
    )
