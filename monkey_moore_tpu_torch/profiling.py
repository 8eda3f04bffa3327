"""Stage timing and device tracing for the PyTorch port.

:class:`SearchStats` and :class:`StageTimer` are copies of the JAX
package's ``profiling`` classes (``tests/test_torch_copies.py`` holds the
stats' fields equal).  :func:`device_trace` is the counterpart of its
``device_trace``: with ``MMTPU_TRACE_DIR`` set (or a directory given), a
search runs under ``torch.profiler`` and writes a Chrome trace there.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, Optional

__all__ = ["SearchStats", "StageTimer", "device_trace"]


@dataclass
class SearchStats:
    """Timing + volume summary of one engine run."""

    stage_seconds: Dict[str, float] = field(default_factory=dict)
    bytes_scanned: int = 0
    chunks: int = 0
    device_dispatches: int = 0
    hot_tiles: int = 0
    candidates: int = 0
    results: int = 0
    #: fused steps that overflowed k_cap/p_cap and fell back to the
    #: counts-fetch path — surfaced so slow searches are explainable
    fused_fallbacks: int = 0
    fused_steps: int = 0
    d2h_bytes: int = 0
    #: True when the whole search ran on the host latency path (small
    #: inputs, where a device dispatch's fixed cost exceeds the scan)
    host_routed: bool = False
    #: host→device bytes uploaded
    h2d_bytes: int = 0
    #: halo bytes of the mesh paths, counted as the JAX engine counts its
    #: ``ppermute``s (one tile per shard per mesh step); the port copies
    #: each resident grid's halo tiles once, when the grid is derived
    ici_halo_bytes: int = 0
    #: per-shard exact candidate counts of the mesh paths
    per_device_candidates: Optional[list] = None

    @property
    def total_seconds(self) -> float:
        return sum(self.stage_seconds.values())

    @property
    def scan_bytes_per_second(self) -> float:
        t = self.stage_seconds.get("device_scan", 0.0) + self.stage_seconds.get(
            "host_scan", 0.0
        )
        return self.bytes_scanned / t if t > 0 else 0.0

    def summary(self) -> str:
        parts = [
            f"{name}={sec * 1000:.1f}ms"
            for name, sec in sorted(self.stage_seconds.items())
        ]
        rate = self.scan_bytes_per_second / 1e9
        degraded = (
            f" | DEGRADED {self.fused_fallbacks}/{self.fused_steps} fused "
            "steps overflowed to the counts-fetch path"
            if self.fused_fallbacks
            else ""
        )
        return (
            f"scanned {self.bytes_scanned / 1e6:.1f} MB in "
            f"{self.total_seconds:.3f}s ({rate:.2f} GB/s scan) | "
            + " ".join(parts)
            + degraded
        )


class StageTimer:
    """Accumulating per-stage timer: ``with timer.stage("device_scan"): ...``"""

    def __init__(self, stats: Optional[SearchStats] = None):
        self.stats = stats or SearchStats()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stats.stage_seconds[name] = (
                self.stats.stage_seconds.get(name, 0.0)
                + time.perf_counter()
                - t0
            )


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
