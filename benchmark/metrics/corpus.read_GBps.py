"""File bytes read into host memory (``np.fromfile``) over the spans
``mm.corpus.read``, summed over the window's requests that read the file
(counter ``corpus.read_bytes``), in 1e9 bytes/s."""

from benchmark.spans import rate_GBps


def read(run):
    return rate_GBps(run, "mm.corpus.read", "corpus.read_bytes")
