"""Median per request, in ms, of the engine's per-block work: its plan
(file stat, ``compute_search_blocks``, the file's map) and its progress
calls (one callback and abort check for each block), the spans
``mm.engine.plan`` and ``mm.engine.progress`` of the request's record."""

from benchmark.spans import median_ms


def read(run):
    return median_ms(run, ("mm.engine.plan", "mm.engine.progress"))
