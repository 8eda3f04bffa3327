"""Bytes uploaded to the card over the engine's ``corpus_upload`` stage
(the file's read, its padded copy and the copy to the card), summed over
the window's requests that uploaded, in 1e9 bytes/s."""


def read(run):
    ups = [r for r in run.done if r.stats.h2d_bytes]
    secs = sum(r.stats.stage_seconds.get("corpus_upload", 0.0) for r in ups)
    if not ups or secs <= 0:
        return None
    return sum(r.stats.h2d_bytes for r in ups) / secs / 1e9
