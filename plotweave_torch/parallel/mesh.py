"""Device meshes (twin of ``plotweave/parallel/mesh.py``).

A :class:`Mesh` is an array of ``torch.device`` s with axis names, the
single-controller counterpart of ``jax.sharding.Mesh``: one process holds one
tensor per shard, each on its mesh device, and moves data between shards by
copies (across cards, peer-to-peer copies; no process group).  An explicit
device list may name a device more than once, which puts N shards on one
device; a default list never repeats a CUDA card.

The CPU pool has :func:`cpu_device_count` entries of the host: the count the
JAX package's CPU backend reads from ``--xla_force_host_platform_device_count=N``
in ``XLA_FLAGS`` (else 1), so that one environment gives both packages the
same shard count.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

_CPU_COUNT_FLAG = re.compile(r"--xla_force_host_platform_device_count=(\d+)")


def cpu_device_count() -> int:
    """The size of the CPU pool: the last ``--xla_force_host_platform_device_count=N``
    in ``XLA_FLAGS``, else 1."""
    found = _CPU_COUNT_FLAG.findall(os.environ.get("XLA_FLAGS", ""))
    return max(1, int(found[-1])) if found else 1


def default_devices(platform: str = "cuda") -> List[torch.device]:
    """``jax.devices(platform)``'s counterpart: every CUDA card once, or the
    CPU pool (``cpu_device_count()`` entries of the host)."""
    if platform == "cpu":
        return [torch.device("cpu")] * cpu_device_count()
    if platform != "cuda":
        raise ValueError(f"platform must be 'cuda' or 'cpu', got {platform!r}")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Mesh:
    """An array of devices with one name per axis, all of one platform."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-D device array for axes {self.axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx in np.ndindex(grid.shape):
            self.devices[idx] = torch.device(grid[idx])
        platforms = {d.type for d in self.devices.flat}
        if len(platforms) > 1:
            raise ValueError(f"a mesh holds devices of one platform, got {sorted(platforms)}")
        self.platform = platforms.pop() if platforms else "cpu"

    @property
    def shape(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self, *axes: str) -> np.ndarray:
        """The device array with its axes in the order ``axes``."""
        return np.transpose(self.devices, [self.axis_names.index(a) for a in axes])

    def along(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, at index 0 of every other axis."""
        grid = self.grid(axis, *(a for a in self.axis_names if a != axis))
        return list(grid.reshape(grid.shape[0], -1)[:, 0])


def make_mesh(
    axis_sizes: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data",),
    devices=None,
) -> Mesh:
    """Build a Mesh over the first ``prod(axis_sizes)`` devices.

    Default: the CUDA cards on one ``data`` axis.  Pass e.g.
    ``axis_sizes=(2, 4), axis_names=("data", "space")`` for a 2-D mesh.
    Raises when the mesh needs more devices than there are."""
    devices = list(devices if devices is not None else default_devices("cuda"))
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(grid.reshape(axis_sizes), axis_names)


def shard_bounds(n_items: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous (start, stop) of each shard's items, sizes differing by at
    most one, the larger first (``np.array_split``'s)."""
    size, extra = divmod(int(n_items), int(n_shards))
    bounds, start = [], 0
    for i in range(int(n_shards)):
        stop = start + size + (i < extra)
        bounds.append((start, stop))
        start = stop
    return bounds


class DataSharding:
    """The leading dim split over one mesh axis, ``P(axis)``: contiguous
    parts, one a device along the axis, sizes differing by at most one."""

    def __init__(self, mesh: Mesh, axis: str = "data"):
        self.devices = mesh.along(axis)

    def split(self, x) -> List[Tuple[torch.device, torch.Tensor]]:
        """(device, part) of each non-empty part of ``x`` (a tensor or an
        array), the part placed on its device (a view where it is there)."""
        parts = []
        for dev, (a, b) in zip(self.devices, shard_bounds(len(x), len(self.devices))):
            if b > a:
                part = x[a:b] if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x[a:b]))
                parts.append((dev, part.to(dev)))
        return parts

    def gather(self, parts: Sequence[torch.Tensor], device=None) -> torch.Tensor:
        """The parts, in order, as one tensor on ``device`` (the first part's
        by default), filled by copies: on a card, memcpys, no kernel."""
        device = parts[0].device if device is None else torch.device(device)
        out = torch.empty((sum(len(p) for p in parts), *parts[0].shape[1:]), dtype=parts[0].dtype, device=device)
        start = 0
        for p in parts:
            out[start : start + len(p)].copy_(p)
            start += len(p)
        return out


def data_sharding(mesh: Mesh, axis: str = "data") -> DataSharding:
    """Shard the leading (batch) dimension across ``axis``."""
    return DataSharding(mesh, axis)
