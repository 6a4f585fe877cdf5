"""Grouping of the batch runner's chain calls (``batchrun.py``)."""
