"""Median wall time, in ms, of every request completed in the window."""

from benchmark.stats import percentile


def read(run):
    walls = [r.wall_s for r in run.done]
    return percentile(walls, 50) * 1e3 if walls else None
