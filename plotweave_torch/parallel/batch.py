"""Image-batch data parallelism: a batch of images split over the mesh
(twin of ``plotweave/parallel/batch.py``).

Each device runs its share of the batch through the natively batched fused
front-end (``ops.frontend.raster_frontend``: on a card its kernels); images
are independent, so the only data movement is the split and the gather.
"""

from __future__ import annotations

import torch

from ..ops.frontend import raster_frontend
from .mesh import Mesh, data_sharding


def frontend_batch(mesh: Mesh, images, centers, *, axis: str = "data", **kw):
    """(B, H, W, 3) uint8 + shared (k, 3) centres → (B, k, H, W) edges,
    skeletons, gathered by copies onto the first device along ``axis``.

    B must divide by the mesh axis size; each device runs one
    ``raster_frontend`` call over its sub-batch (no collectives)."""
    sharding = data_sharding(mesh, axis)
    if len(images) % len(sharding.devices):
        raise ValueError(f"frontend_batch: a batch of {len(images)} does not split over "
                         f"{len(sharding.devices)} devices")
    outs = [raster_frontend(part, centers.to(dev) if isinstance(centers, torch.Tensor) else centers, **kw)
            for dev, part in sharding.split(images)]
    return sharding.gather([e for e, _ in outs]), sharding.gather([s for _, s in outs])
