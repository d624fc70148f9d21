"""Seconds from the process's start to the window's: imports, the kernel
library, each card's warm-up, the circuits, one warm request."""


def read(run):
    return run.setup_s
