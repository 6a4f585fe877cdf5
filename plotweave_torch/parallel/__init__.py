"""Device meshes (twin of ``plotweave/parallel/``).

- a batch of images → split over a ``data`` mesh axis (``batch.py``): each
  device runs its share through the fused front-end's kernels;
- one large image → row slabs over a ``space`` axis with halo rows copied
  between neighbours (``spatial.py``): one schedule, the kernels' slab
  modes on cards and their plain versions on CPU meshes;
- the batch runner's grouped chain calls → split over the ``data`` axis
  (``batchrun.py``).
"""

from .mesh import data_sharding, make_mesh
from .batch import frontend_batch
from .spatial import fit_shard_rows, sharded_chain, spatial_frontend

__all__ = [
    "make_mesh",
    "data_sharding",
    "frontend_batch",
    "fit_shard_rows",
    "sharded_chain",
    "spatial_frontend",
]
