"""Host milliseconds inside the entry's call until it returns, the mean over
the traced window's calls: the wrappers' dispatch (the benchmark's own
spans, host clock)."""


def read(run):
    host = run.window.host_s
    return 1e3 * sum(host) / len(host) if host and run.trace else None
