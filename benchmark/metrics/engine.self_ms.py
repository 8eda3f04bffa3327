"""Median per request, in ms, of the engine's time outside its own stage
spans: the request's wall minus the sum of ``last_stats.stage_seconds``
(candidate recording, finalize, the sort and the result objects)."""

from benchmark.stats import percentile


def read(run):
    own = [r.wall_s - sum(r.stats.stage_seconds.values()) for r in run.done]
    return percentile(own, 50) * 1e3 if own else None
