"""Seconds from the process's start to the window's start: imports, weights
made on the card, the kernels loaded (built on a checkout's first run),
the image pool, the warm-up burst or the closed loop's ramp."""


def read(run):
    return run.setup_s
