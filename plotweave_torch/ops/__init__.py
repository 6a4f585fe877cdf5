"""Raster ops of the stage 02→04 chain as tensor functions.

Modules are imported by name (``plotweave_torch.ops.thinning``); this package
file imports nothing, so loading one op never loads the others.
"""
