"""Median per request, in ms, of the fused steps' blocking result copies
(the host waits there for the step's kernels), the spans ``mm.step.fetch``
of the request's record."""

from benchmark.spans import median_ms


def read(run):
    return median_ms(run, ("mm.step.fetch",))
