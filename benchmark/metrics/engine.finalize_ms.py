"""Median per request, in ms, of the engine's tail: ``finalize_candidates``
(block-fit filter, suppression, recovery) and the sorted result list, the
spans ``mm.engine.finalize`` and ``mm.engine.results`` of the request's
record."""

from benchmark.spans import median_ms


def read(run):
    return median_ms(run, ("mm.engine.finalize", "mm.engine.results"))
