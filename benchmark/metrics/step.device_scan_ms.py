"""Median per request, in ms, of the engine's ``device_scan`` stage: grid
derivation, the fused steps' enqueue and their result fetches."""

from benchmark.stats import percentile


def read(run):
    scan = [r.stats.stage_seconds.get("device_scan", 0.0) for r in run.done]
    return percentile(scan, 50) * 1e3 if scan else None
