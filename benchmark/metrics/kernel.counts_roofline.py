"""Share, in %, of the counts kernel's (A, ``swar_counts_kernel``) device
time in the traced window that the least time for its work would take:
every launch reads its step's scanned bytes once and writes one int32
count per tile (``stats.counts_work``), at the card's peaks
(``stats.bound_s``).  The bytes are the engine's ``bytes_scanned``
counter, summed over the window's requests."""

from benchmark.stats import bound_s, counts_work

#: the engine's count tile at the main path's sizes (elements)
TILE_ELEMS = 262_144
KERNEL = "swar_counts_kernel"


def read(run):
    if run.trace is None:
        return None
    device_s = sum(s for name, s in run.trace.device_s.items()
                   if KERNEL in name)
    if device_s <= 0:
        return None
    n_bytes = n_ops = 0
    for r in run.done:
        tiles = r.stats.fused_steps + r.stats.bytes_scanned // (
            run.width * TILE_ELEMS)
        b, o = counts_work(r.stats.bytes_scanned, run.width, tiles)
        n_bytes += b
        n_ops += o
    return 100.0 * bound_s(n_bytes, n_ops)[0] / device_s
