"""Stage timing, spans and device tracing for the PyTorch port.

:class:`SearchStats` and :class:`StageTimer` are copies of the JAX
package's ``profiling`` classes (``tests/test_torch_copies.py`` holds the
stats' fields equal).  :func:`device_trace` is the counterpart of its
``device_trace``: with ``MMTPU_TRACE_DIR`` set (or a directory given), a
search runs under ``torch.profiler`` and writes a Chrome trace there.

**Spans.** :func:`span` opens a named interval of the current run, and
:func:`count` adds to one of its counters; both act on the
:class:`SpanRecord` of the engine run on this thread (:func:`run_record`).
Tracing is on only while a ``torch.profiler`` runs on the run's thread
(the profiler records the thread that started it), checked once per run:
then each span is kept in the record, with its parent and the run's
request id, and is also a ``record_function`` range, so that it lies in the
profiler's trace beside the kernels and copies it launched.  Off, a span is
a shared no-op context and a count returns at once.  :meth:`StageTimer.
stage` opens a span ``mm.<stage>`` as well, so every stage is in the tree.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional

__all__ = [
    "SearchStats",
    "StageTimer",
    "Span",
    "SpanRecord",
    "count",
    "counting",
    "device_trace",
    "run_record",
    "span",
    "tracing_enabled",
]


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
    """Accumulating per-stage timer: ``with timer.stage("device_scan"): ...``
    (also the span ``mm.device_scan`` of the current run)."""

    def __init__(self, stats: Optional[SearchStats] = None):
        self.stats = stats or SearchStats()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("mm." + name):
                yield
        finally:
            self.stats.stage_seconds[name] = (
                self.stats.stage_seconds.get(name, 0.0)
                + time.perf_counter()
                - t0
            )


class Span:
    """One closed or open interval of a run: ``perf_counter_ns`` start and
    end (0 while open), the index of the span that holds it in the record's
    ``spans`` (-1 for a root) and the run's request id."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "request_id")

    def __init__(self, name: str, start_ns: int, parent: int,
                 request_id: int):
        self.name = name
        self.start_ns = start_ns
        self.end_ns = 0
        self.parent = parent
        self.request_id = request_id

    @property
    def duration_ns(self) -> int:
        return self.end_ns - self.start_ns


class SpanRecord:
    """The spans and counters of one engine run, in memory.  Empty when the
    run was not traced."""

    def __init__(self, request_id: int):
        self.request_id = request_id
        #: every span of the run, in the order they opened
        self.spans: List[Span] = []
        #: ``count(name, n)`` sums by name
        self.counters: Dict[str, int] = {}
        self._open = -1  # index of the innermost open span

    def self_ns(self, index: int) -> int:
        """Span *index*'s duration minus the part its children cover."""
        children = sum(s.duration_ns for s in self.spans
                       if s.parent == index)
        return self.spans[index].duration_ns - children


class _OpenSpan:
    """A span of a traced run while it is open."""

    __slots__ = ("_record", "_name", "_index", "_range")

    def __init__(self, record: SpanRecord, name: str):
        self._record = record
        self._name = name

    def __enter__(self):
        import torch

        rec = self._record
        self._range = torch.autograd.profiler.record_function(self._name)
        self._range.__enter__()
        self._index = len(rec.spans)
        rec.spans.append(Span(self._name, time.perf_counter_ns(), rec._open,
                              rec.request_id))
        rec._open = self._index

    def __exit__(self, *exc):
        rec = self._record
        s = rec.spans[self._index]
        s.end_ns = time.perf_counter_ns()
        rec._open = s.parent
        self._range.__exit__(*exc)
        return False


class _Current(threading.local):
    #: the record spans go to on this thread (None: not tracing)
    record: Optional[SpanRecord] = None


_NO_SPAN = contextlib.nullcontext()
_current = _Current()
#: process-wide request ids, one per engine run
_request_ids = itertools.count(1)


def tracing_enabled() -> bool:
    """True while a ``torch.profiler`` records this thread."""
    import torch

    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """Context of a span *name* in the current run's record; a shared no-op
    context when the run is not traced (or no run is open)."""
    record = _current.record
    if record is None:
        return _NO_SPAN
    return _OpenSpan(record, name)


def count(name: str, n: int) -> None:
    """Add *n* to the current run's counter *name* (nothing when the run
    is not traced)."""
    record = _current.record
    if record is not None:
        record.counters[name] = record.counters.get(name, 0) + n


def counting() -> bool:
    """True while the current run keeps its counters (a traced run): a
    count whose value costs work to compute asks first."""
    return _current.record is not None


@contextlib.contextmanager
def run_record() -> Iterator[SpanRecord]:
    """The record of one run on this thread, under a new request id: spans
    and counts go to it while a profiler runs, checked once here."""
    record = SpanRecord(next(_request_ids))
    outer = _current.record
    _current.record = record if tracing_enabled() else None
    try:
        yield record
    finally:
        _current.record = outer


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` wrapper; no-op when no directory is given and
    ``MMTPU_TRACE_DIR`` is unset, or when a profiler already runs (its
    owner writes the trace)."""
    log_dir = log_dir or os.environ.get("MMTPU_TRACE_DIR")
    if not log_dir or tracing_enabled():
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
