"""Share, in %, of the window's fused steps that overflowed their
capacities and took the counts-fetch fallback (``fused_fallbacks`` over
``fused_steps``, the engine's counters)."""


def read(run):
    steps = sum(r.stats.fused_steps for r in run.done)
    if not steps:
        return None
    return 100.0 * sum(r.stats.fused_fallbacks for r in run.done) / steps
