"""Share, in %, of the grid derivation kernel's (M, ``derive_words_kernel``)
device time in the traced window that the least time for its work would
take: every launch reads its grid's words once and writes them once, the
program's counter ``corpus.derive_bytes`` summed over the window's traced
requests, at the card's memory rate (``stats.bound_s``).  Nothing where the
program has no such kernel or counter."""

from benchmark.spans import records
from benchmark.stats import bound_s

KERNEL = "derive_words_kernel"


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace.device_s.items()
                   if KERNEL in name)
    n_bytes = sum(rec.counters.get("corpus.derive_bytes", 0)
                  for rec in records(run))
    if device_s <= 0 or n_bytes <= 0:
        return None
    return 100.0 * bound_s(n_bytes, 0)[0] / device_s
