"""Share, in %, of the windows that passed the device prefilter (kernel
A's counts) and that the exact check of the fused step's tail then
rejected: 100 x (prefilter windows - exact windows) / prefilter windows,
summed over the window's traced requests (the program's counters
``step.prefilter_windows`` and ``step.exact_windows``, one addition a
fused step)."""

from benchmark.spans import records


def read(run):
    recs = records(run)
    passed = sum(r.counters.get("step.prefilter_windows", 0) for r in recs)
    if not passed:
        return None
    exact = sum(r.counters.get("step.exact_windows", 0) for r in recs)
    return 100.0 * (passed - exact) / passed
