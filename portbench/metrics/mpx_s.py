"""Input megapixels a second: the image pixels of every call completed in the
window over the window's seconds, from its start to the completion of the
last call dispatched in it (host clock)."""


def read(run):
    w = run.window
    return w.calls * run.mpx_per_call / w.seconds if w.calls else None
