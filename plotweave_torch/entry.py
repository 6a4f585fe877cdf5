"""The fused front-end's entry point (twin of ``__graft_entry__.py::entry``).

``entry(device)`` returns ``(fn, example_args)``: ``fn(image, centers)`` is
:func:`plotweave_torch.ops.frontend.raster_frontend` with k=4, and the
arguments are the JAX entry's seeded 512×512 BGR image and its example
centres, as tensors on ``device``.  ``"auto"`` is the CUDA card or raises;
``"cpu"`` runs the plain versions.  Run it with ``python -m plotweave_torch.entry``.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.frontend import raster_frontend
from .utils.devices import device_for


def _example_centers(k: int = 4) -> np.ndarray:
    """Dark→light Lab centres in the pipeline's 8-bit scaling (copied from
    ``__graft_entry__.py``, whose package imports jax)."""
    return np.array(
        [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]],
        dtype=np.float32,
    )[:k]


def entry(device: str = "auto"):
    """(fn, example_args): one image → per-layer edges + skeletons on ``device``."""
    dev = device_for(device)

    def forward(image, centers):
        return raster_frontend(image, centers, k=4)

    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (512, 512, 3)).astype(np.uint8)
    return forward, (torch.from_numpy(image).to(dev), torch.from_numpy(_example_centers()).to(dev))


if __name__ == "__main__":
    import sys

    fn, args = entry(sys.argv[1] if len(sys.argv) > 1 else "auto")
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
