"""plotweave_torch — the PyTorch / CUDA port of plotweave for NVIDIA Hopper.

The JAX package ``plotweave`` stays the reference.  This package mirrors its
module names (``plotweave_torch/ops/thinning.py`` ↔ ``plotweave/ops/thinning.py``)
and stands alone: it imports neither jax nor anything of ``plotweave``, and
carries its own copies of the host code it needs (``config``, ``utils/io``,
the native C++ library in ``native/``, ``stream``, ``vector``, ``viz`` and
the host stages).

It runs the main path, image → ``plot_stream.bin``, in every mode of stage 02
(row sharding on one device only), for one image or a directory of them, and
the vector entry point, SVG or G-code → stream:

- ``ops``      — the stage 02→04 raster chain, the fused raster front-end
  (``ops/frontend.py``), the device k-means (``ops/kmeans.py``) and the gray
  morphology as plain tensor functions, with hand-written CUDA kernels
  (``ops/kernels.py``, ``csrc/``) for the layout conversions, the packed and
  the gray morphology, the blur and Canny, the two bit-packed fixpoints
  (Canny hysteresis, Zhang–Suen thinning), the fused Lab + nearest-centre
  assign with its counts, the k-means sampler, seeding and fit, the
  dense, bit-sliced Zhang–Suen, the INTER_AREA resize (``ops/resize.py``)
  and the Bézier sampler (``ops/bezier.py``).
- ``stages``   — all 14 stages: 01–04 the port's own, 05–14 copies of the
  JAX package's host stages.
- ``parallel`` — the batch runner's grouping of concurrent images' chain calls.
- ``pipeline`` — the in-process runner, the batch runner and the CLI
  (``python -m plotweave_torch``).
- ``frontends``— the SVG and G-code inputs (``python -m
  plotweave_torch.frontends.svg2stream``), their curve sampling on the card
  with ``--sampling-backend torch`` (``ops/bezier.py``).
- ``demo``     — procedural demo streams.
- ``tools``    — the colour analysis and layer-splitting tools.
- ``entry``    — the front-end's entry point, ``entry(device) → (fn, args)``.
"""

__version__ = "0.1.0"
