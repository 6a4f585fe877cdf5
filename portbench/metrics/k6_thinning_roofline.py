"""The share of its roofline that k6_thinning reached over the traced window, in %:
its least time (``roofline/k6_thinning.py``, summed over the window's calls) over
its device time in the trace."""

from portbench.harness import roofline_share


def read(run):
    return roofline_share(run, "k6_thinning")
