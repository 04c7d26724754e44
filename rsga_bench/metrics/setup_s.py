"""Seconds from the process's start to the window's: imports, the data
from the seed, the index, the kernels' load (and build, in a checkout's
first run), the warm-up pass."""


def read(ctx):
    return ctx["setup_s"]
