"""File bytes searched per second of the window: the image's size times
the requests completed, over the window's length, in 1e9 bytes/s."""


def read(run):
    if not run.done or run.window_s <= 0:
        return None
    return run.file_bytes * len(run.done) / run.window_s / 1e9
