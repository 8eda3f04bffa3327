"""Median wall time, in ms, of the window's requests in a cell whose every
request is a first search of the file (no resident corpus: read, upload,
scan and results)."""

from benchmark.stats import percentile


def read(run):
    walls = [r.wall_s for r in run.done]
    return percentile(walls, 50) * 1e3 if walls else None
