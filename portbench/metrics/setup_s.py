"""Seconds from the process's start to the window's first call: imports,
the card's start, the kernels' libraries built or loaded, the inputs made
and uploaded, every shape warmed (host clock)."""


def read(run):
    return run.setup_s
