"""The port's pipeline stages.

Stages 01–04 are ported (02 runs the raster chain on the raster device);
07, 08 and 12 are shims over the shared host code that keep it off the JAX
device paths.  Stages 05, 06, 09, 10, 11, 13 and 14 are ``plotweave.stages``
as they are (``plotweave_torch/pipeline.py`` picks each step's module).
"""
