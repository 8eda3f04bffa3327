"""Median per request, in ms, of the host's enqueue of the fused steps:
the grid chunk's derivation and ``fused_count_extract_start``, the spans
``mm.step.enqueue`` of the request's record."""

from benchmark.spans import median_ms


def read(run):
    return median_ms(run, ("mm.step.enqueue",))
