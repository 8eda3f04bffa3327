"""95th percentile of the wall times, in ms, of every request completed in
the window (over all of them, not a median of chunks)."""

from benchmark.stats import percentile


def read(run):
    walls = [r.wall_s for r in run.done]
    return percentile(walls, 95) * 1e3 if walls else None
