"""plotweave_torch — the PyTorch / CUDA port of plotweave for NVIDIA Hopper.

The JAX package ``plotweave`` stays the reference.  This package mirrors its
module names (``plotweave_torch/ops/thinning.py`` ↔ ``plotweave/ops/thinning.py``)
and imports its jax-free host code (config, artifact I/O, the native C++
library, vector, stream and preview stages) directly; it never imports jax.

Slice one is the default main path, image → ``plot_stream.bin``:

- ``ops``      — the stage 02→04 raster chain and the fused raster front-end
  (``ops/frontend.py``) as plain tensor functions, with hand-written CUDA
  kernels (``ops/kernels.py``, ``csrc/``) for the packed morphology, the two
  bit-packed fixpoints (Canny hysteresis, Zhang–Suen thinning), the fused
  Lab + nearest-centre assign and the dense tile-halo Zhang–Suen.
- ``stages``   — stages 01–04 plus shims for 07, 08 and 12; the other stages
  are ``plotweave.stages`` as they are.
- ``pipeline`` — the in-process runner and CLI (``python -m plotweave_torch``).
- ``entry``    — the front-end's entry point, ``entry(device) → (fn, args)``.
"""

__version__ = "0.1.0"
