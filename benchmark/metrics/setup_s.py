"""Seconds from the process's start to the window's: imports, CUDA start,
the kernel library (its build, where it is not built yet), the image, its
file and the one warm search."""


def read(run):
    return run.setup_s
