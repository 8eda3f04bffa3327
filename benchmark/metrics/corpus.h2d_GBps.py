"""Bytes copied to the card (the padded words' ``.to(device)``) over the
spans ``mm.corpus.h2d``, summed over the window's requests that uploaded
(counter ``corpus.h2d_bytes``), in 1e9 bytes/s."""

from benchmark.spans import rate_GBps


def read(run):
    return rate_GBps(run, "mm.corpus.h2d", "corpus.h2d_bytes")
