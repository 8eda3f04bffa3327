"""The program's own spans, read two ways.

- From the engine's record of each request (``last_stats.record``, the
  port's ``profiling.SpanRecord``: spans with a name, ``perf_counter_ns``
  start and end and the index of their parent, and counters by name).  The
  readers of the ``program_span`` metrics use :func:`median_ms` and
  :func:`rate_GBps`.
- From a ``torch.profiler`` Chrome trace, where each ``mm.`` span is a
  ``record_function`` range: :func:`reduce_spans` puts the window's idle
  gaps and its device time down to the innermost span open at each.

Both find nothing where the program records no span: a program without
the recorder, or a run that was not traced.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark.stats import (
    DEVICE_CATS,
    WINDOW_SPAN,
    merge_intervals,
    percentile,
)

#: prefix of the program's spans
SPAN_PREFIX = "mm."
#: the harness's span around one request
SEARCH_SPAN = "bench.search"
#: label of a gap or a launch with no program span open
NONE = "none"


# ---------------------------------------------------------------------------
# the engine's records


def records(run) -> list:
    """The span records of the window's completed requests that hold
    spans."""
    out = []
    for r in run.done:
        rec = getattr(r.stats, "record", None)
        if rec is not None and rec.spans:
            out.append(rec)
    return out


def outer_ns(record, names: Iterable[str]) -> int:
    """Nanoseconds of *record* in spans named in *names*, each moment
    counted once: a span held by another span of these names is left
    out."""
    names = set(names)
    spans = record.spans
    total = 0
    for s in spans:
        if s.name not in names:
            continue
        p = s.parent
        while p >= 0 and spans[p].name not in names:
            p = spans[p].parent
        if p < 0:
            total += s.end_ns - s.start_ns
    return total


def median_ms(run, names: Sequence[str]) -> Optional[float]:
    """Median over the window's traced requests of the ms each spent in
    spans named in *names*; None where no request has such a span."""
    recs = records(run)
    if not any(s.name in names for rec in recs for s in rec.spans):
        return None
    return percentile([outer_ns(rec, names) / 1e6 for rec in recs], 50)


def rate_GBps(run, name: str, counter: str) -> Optional[float]:
    """Counter *counter* over the seconds in spans *name*, summed over the
    window's requests that counted it, in 1e9 per second."""
    recs = [rec for rec in records(run) if rec.counters.get(counter)]
    secs = sum(outer_ns(rec, (name,)) for rec in recs) / 1e9
    if not recs or secs <= 0:
        return None
    return sum(rec.counters[counter] for rec in recs) / secs / 1e9


# ---------------------------------------------------------------------------
# the profiler's trace


@dataclass
class SpanSummary:
    """Idle and device time of a traced window by program span."""

    #: idle seconds by the innermost ``mm.`` span open at each gap's middle
    idle_span_s: Dict[str, float] = field(default_factory=dict)
    #: device seconds by the innermost ``mm.`` span open when each kernel,
    #: copy or set was launched
    device_span_s: Dict[str, float] = field(default_factory=dict)
    #: idle seconds whose gap's middle lies in a ``bench.search`` span, and
    #: the part of them with no program span open
    search_idle_s: float = 0.0
    search_none_s: float = 0.0


def innermost(spans: List[Tuple[float, float, str]],
              points: Sequence[float]) -> List[str]:
    """The name of the innermost span open at each of *points*, or
    :data:`NONE`.  *spans* must nest (one thread's spans)."""
    spans = sorted(spans, key=lambda x: (x[0], -x[1]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out = [NONE] * len(points)
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for i in order:
        t = points[i]
        while j < len(spans) and spans[j][0] <= t:
            while stack and stack[-1][1] < spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def _inside(intervals: List[Tuple[float, float]], starts: List[float],
            t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def reduce_spans(trace: dict) -> SpanSummary:
    """Idle and device time of the harness's ``bench.window`` by the
    program's innermost ``mm.`` span (Chrome trace of ``torch.profiler``;
    times in microseconds).  Busy time and its gaps are those of
    ``stats.reduce_trace``: the union of every kernel, copy and set clipped
    to the window.  A device operation's launch is its ``cuda_runtime``
    event of the same ``correlation``; one without is labelled
    :data:`NONE`."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("name") == WINDOW_SPAN
              and str(e.get("cat", "")).lower() == "user_annotation"]
    if not window:
        raise ValueError(f"the trace has no {WINDOW_SPAN} span")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])

    spans, searches, device, launch_at = [], [], [], {}
    for e in events:
        start = float(e["ts"])
        end = start + float(e["dur"])
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        corr = (e.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            start, end = max(start, w0), min(end, w1)
            if end > start:
                device.append((start, end, corr))
        elif cat == "cuda_runtime" and corr is not None:
            launch_at[corr] = start
        elif cat == "user_annotation":
            if name.startswith(SPAN_PREFIX):
                spans.append((start, end, name))
            elif name == SEARCH_SPAN:
                searches.append((start, end))

    out = SpanSummary()
    busy = merge_intervals((s, e) for s, e, _ in device)
    gaps, edge = [], w0
    for start, end in busy + [(w1, w1)]:
        if start > edge:
            gaps.append((edge, start))
        edge = max(edge, end)
    mids = [0.5 * (g0 + g1) for g0, g1 in gaps]
    idle = defaultdict(float)
    searches = merge_intervals(searches)
    search_starts = [s for s, _ in searches]
    for (g0, g1), mid, label in zip(gaps, mids, innermost(spans, mids)):
        idle[label] += (g1 - g0) / 1e6
        if _inside(searches, search_starts, mid):
            out.search_idle_s += (g1 - g0) / 1e6
            if label == NONE:
                out.search_none_s += (g1 - g0) / 1e6
    out.idle_span_s = dict(idle)

    dev = defaultdict(float)
    launched = [i for i, (_, _, c) in enumerate(device) if c in launch_at]
    labels = innermost(spans, [launch_at[device[i][2]] for i in launched])
    by_op = dict(zip(launched, labels))
    for i, (start, end, _) in enumerate(device):
        dev[by_op.get(i, NONE)] += (end - start) / 1e6
    out.device_span_s = dict(dev)
    return out
