"""Bytes of the padded host copy of the file over the spans
``mm.corpus.pad``, summed over the window's requests that made one
(counter ``corpus.pad_bytes``), in 1e9 bytes/s."""

from benchmark.spans import rate_GBps


def read(run):
    return rate_GBps(run, "mm.corpus.pad", "corpus.pad_bytes")
