"""The share of its roofline that k34_edges reached over the traced window, in %:
its least time (``roofline/k34_edges.py``, summed over the window's calls) over
its device time in the trace."""

from portbench.harness import roofline_share


def read(run):
    return roofline_share(run, "k34_edges")
