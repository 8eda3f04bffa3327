"""Median per request, in ms, of the engine's candidate recording after
each fused step, the spans ``mm.engine.record`` of the request's
record."""

from benchmark.spans import median_ms


def read(run):
    return median_ms(run, ("mm.engine.record",))
