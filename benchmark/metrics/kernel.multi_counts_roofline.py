"""Share, in %, of the keyword-batch counts kernel's (C,
``swar_counts_kernel``) device time in the traced window that the least
time for its work would take: every launch reads its words once and writes
K rows of counts, or its SWAR operations (``multi_work.c_work``, a copy of
``counts_bench.c_bound``'s count from the program's ``kernel.counts_multi*``
counters), the larger at the card's peaks (``stats.bound_s``), summed over
the window's traced requests.  A cell whose requests are batches runs no
other ``swar_counts_kernel``.  Nothing where the program counts no launch
of C."""

from benchmark.multi_work import record_work
from benchmark.spans import records
from benchmark.stats import bound_s

KERNEL = "swar_counts_kernel"


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace.device_s.items()
                   if KERNEL in name)
    work = [w for w in (record_work(rec, run.width) for rec in records(run))
            if w is not None]
    if device_s <= 0 or not work:
        return None
    n_bytes = sum(b for b, _ in work)
    n_ops = sum(o for _, o in work)
    return 100.0 * bound_s(n_bytes, n_ops)[0] / device_s
