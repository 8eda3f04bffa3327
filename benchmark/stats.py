"""The benchmark's arithmetic: percentiles over all requests, the card's
peaks and the least time a kernel could take, and the reduction of a
``torch.profiler`` Chrome trace to busy time, idle gaps and time by device
operation.

The peaks and the counts kernel's work are copies of the program's
``bench.HBM_BYTES_PER_S`` / ``INT_OPS_PER_S`` / ``bound`` and
``counts_bench.DIFF_OPS`` / ``EQUAL_OPS`` / ``a_bound``, kept here so that
a change to the program cannot move the yardstick.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the H100 SXM's published device-memory rate (NVIDIA's data sheet, at
#: 700 W), bytes/s
HBM_BYTES_PER_S = 3350.0e9
#: its 32-bit integer rate: 64 add, logic, compare or shift results per
#: clock per SM (CUDA C++ Programming Guide, compute capability 9.0) on
#: 132 SMs at the 1.98 GHz boost clock
INT_OPS_PER_S = 64 * 132 * 1.98e9
#: 32-bit instructions per word of window starts in the counts kernel's
#: SWAR formulation: the carry-free diff of a check's two words, and the
#: xor and zero-element detect that compare it with the expected value
DIFF_OPS = 5
EQUAL_OPS = 4


def percentile(values: Sequence[float], q: float) -> float:
    """The *q*-th percentile (0-100) of all *values*, interpolated linearly
    between the closest ranks (numpy's default method)."""
    if not values:
        raise ValueError("percentile of no values")
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def bound_s(n_bytes: float, n_ops: float) -> Tuple[float, str]:
    """``(seconds, by)``: the least time the card could take, the larger of
    the bytes' time at its memory rate and the integer operations' time at
    its integer rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def counts_work(scanned_bytes: int, width: int, tiles: int
                ) -> Tuple[int, int]:
    """``(bytes, operations)`` of the counts kernel over *scanned_bytes* of
    one grid's elements (each read once) in *tiles* count tiles (one int32
    count written each): the first check's diff and compare per word of
    window starts (4 u8 or 2 u16 windows a word).  The further checks of
    the windows that pass it (one in 2^(8 * width) on random data) are left
    out."""
    windows = scanned_bytes // width
    words = -(-windows * width // 4)
    return scanned_bytes + 4 * tiles, (DIFF_OPS + EQUAL_OPS) * words


# ---------------------------------------------------------------------------
# profiler traces

#: Chrome-trace categories of work on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: the harness's span around the whole measured window
WINDOW_SPAN = "bench.window"
#: prefix of the harness's own spans
SPAN_PREFIX = "bench."


@dataclass
class TraceSummary:
    """What the per-layer readers and the result's ``breakdown`` take from
    one traced window."""

    window_s: float
    busy_s: float
    #: device seconds by operation name, every operation in the window
    device_s: Dict[str, float] = field(default_factory=dict)
    #: idle seconds by what the host was doing, with the gap counts
    idle_s: Dict[str, float] = field(default_factory=dict)
    idle_n: Dict[str, int] = field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.device_s.items(), key=lambda kv: -kv[1])[:n]
        return [[name, sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        top = sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:n]
        return [[f"{label} ({self.idle_n[label]} gaps)", sec]
                for label, sec in top]


def _cat(event: dict) -> str:
    return str(event.get("cat", "")).lower()


def _short(name: str, limit: int = 96) -> str:
    name = name.replace("void ", "", 1) if name.startswith("void ") else name
    return name if len(name) <= limit else name[: limit - 3] + "..."


def merge_intervals(spans: Iterable[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(s, e) for s, e in merged]


def top_level(intervals: Iterable[Tuple[float, float, str]]
              ) -> List[Tuple[float, float, str]]:
    """The intervals that no earlier-starting one holds, by start: the
    outermost spans or host operations."""
    out: List[Tuple[float, float, str]] = []
    for start, end, name in sorted(intervals, key=lambda x: (x[0], -x[1])):
        if out and end <= out[-1][1]:
            continue
        out.append((start, end, name))
    return out


def at(intervals: List[Tuple[float, float, str]], starts: List[float],
       t: float) -> Optional[str]:
    """Name of the top-level interval holding *t* (``starts`` are the
    intervals' starts, ascending), or None."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and intervals[i][0] <= t <= intervals[i][1]:
        return intervals[i][2]
    return None


def reduce_trace(trace: dict) -> TraceSummary:
    """Busy time, time by device operation and idle time by host activity
    within the harness's ``bench.window`` span of a Chrome trace
    (``torch.profiler``'s ``export_chrome_trace``; times in microseconds).

    Busy time is the union of every kernel, copy and set on the device.
    An idle gap is labelled by the harness span (``bench.*``) and the
    outermost host operation running at its middle (``python``
    where none is: the program's own Python)."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events
              if e.get("name") == WINDOW_SPAN and _cat(e) == "user_annotation"]
    if not window:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])

    device = []
    device_s: Dict[str, float] = defaultdict(float)
    spans, host_ops = [], []
    for e in events:
        start = float(e["ts"])
        end = start + float(e["dur"])
        cat = _cat(e)
        if cat in DEVICE_CATS:
            start, end = max(start, w0), min(end, w1)
            if end > start:
                device.append((start, end))
                device_s[_short(str(e.get("name", cat)))] += (end - start) / 1e6
        elif cat == "user_annotation":
            name = str(e.get("name", ""))
            if name.startswith(SPAN_PREFIX) and name != WINDOW_SPAN:
                spans.append((start, end, name[len(SPAN_PREFIX):]))
        elif cat == "cpu_op":
            host_ops.append((start, end, str(e.get("name", "op"))))

    busy = merge_intervals(device)
    busy_us = sum(e - s for s, e in busy)
    idle_s: Dict[str, float] = defaultdict(float)
    idle_n: Dict[str, int] = defaultdict(int)
    edge = w0
    gaps = []
    for start, end in busy + [(w1, w1)]:
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    spans, host_ops = top_level(spans), top_level(host_ops)
    span_starts = [s for s, _, _ in spans]
    op_starts = [s for s, _, _ in host_ops]
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        span = at(spans, span_starts, mid) or "harness"
        op = at(host_ops, op_starts, mid) or "python"
        label = f"{span}: {op}"
        idle_s[label] += (g1 - g0) / 1e6
        idle_n[label] += 1
    return TraceSummary(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                        device_s=dict(device_s), idle_s=dict(idle_s),
                        idle_n=dict(idle_n))
