"""Share, in %, of the traced window of resident repeat searches in which
no kernel, copy or set ran on the card."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None  # nothing ran on a card
    return run.trace.idle_pct
