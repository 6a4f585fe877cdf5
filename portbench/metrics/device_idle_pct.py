"""The share of the traced window in which no kernel and no copy ran on the
card, in % (device trace)."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.window_s > 0 else None
