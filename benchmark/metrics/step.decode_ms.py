"""Median per request, in ms, of the keyword-batch step's host decode:
after the one copy of the K combo buffers, each keyword's buffer decoded
(and, on a keyword's overflow, its fallback), the spans
``mm.step.decode`` of the request's record."""

from benchmark.spans import median_ms


def read(run):
    return median_ms(run, ("mm.step.decode",))
