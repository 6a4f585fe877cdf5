"""Stage 07's greedy planner on the card: K9 and its plain version.

Counterpart of ``plotweave/vector/planner_device.py`` (its
``_greedy_device_impl``); the port imports nothing of ``plotweave``.

Selection semantics replicate 07_sort_contours.py:50-87 bit for bit:
float32 squared distances, the first minimum (== the ascending strict-<
scan), closed contours always join at their start, open contours prefer
their start when d²(start) ≤ d²(end).

Float caveat: d² = dx·dx + dy·dy must be rounded after each product and the
sum, as the host planner (``native/encoder.cpp``, built with
``-ffp-contract=off``) rounds it.  A fused multiply-add can flip an ulp of d²
once squared coordinates exceed float32's 2²⁴ integer range.  K9 is compiled
with ``--fmad=false`` and rounds each operation on its own; the plain version
computes each product as a tensor of its own, which PyTorch does not fuse.
So both give the host planner's order and flips exactly, at every n.

Unlike the JAX package, nothing is padded to a bucket: PyTorch compiles
nothing per shape.  The limits stay the JAX package's: a plan of fewer than
2 or more than :data:`MAX_N` contours is not taken (``None``), and its caller
runs the host planner.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

MAX_N = 65536  # the JAX package's largest bucket


def on_cuda(device) -> bool:
    """Whether ``device`` (a torch.device or its name) is a CUDA device."""
    return device is not None and torch.device(device).type == "cuda"


def to_device(device, *arrays: np.ndarray) -> list:
    """The arrays as tensors on ``device``; raises for a CUDA device where
    there is no card (nothing runs on the CPU in its place)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the device planner and refiner were asked for {device}, and "
                           "torch.cuda.is_available() is false")
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def greedy_order_plain(starts: torch.Tensor, ends: torch.Tensor, closed: torch.Tensor, closed_aware: bool,
                       seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K9: (order (n,) int32, flips (n,) bool) of the
    greedy tour over (n, 2) float32 ``starts`` and ``ends`` and (n,) bool
    ``closed``, from contour ``seed``; n - 1 steps of the JAX body, on the
    tensors' device, with no host read."""
    n = starts.shape[0]
    dev = starts.device
    closed_f = closed if closed_aware else torch.zeros_like(closed)
    sx, sy, ex, ey = starts[:, 0], starts[:, 1], ends[:, 0], ends[:, 1]
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=dev)
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    used[seed] = True
    cur = torch.where(closed_f[seed], starts[seed], ends[seed])
    order = torch.zeros(n, dtype=torch.int32, device=dev)
    order[0] = seed
    flips = torch.zeros(n, dtype=torch.bool, device=dev)
    for i in range(1, n):
        dsx, dsy = sx - cur[0], sy - cur[1]
        dex, dey = ex - cur[0], ey - cur[1]
        d2s = dsx * dsx + dsy * dsy
        d2e = dex * dex + dey * dey
        prefer_start = closed_f | (d2s <= d2e)
        cand = torch.where(prefer_start, d2s, d2e).masked_fill(used, inf)
        best = torch.argmin(cand)  # the first minimum == the ascending strict-< scan
        flip = ~prefer_start[best]
        cur = torch.where(closed_f[best] | flip, starts[best], ends[best])
        used[best] = True
        order[i] = best
        flips[i] = flip
    return order, flips


def greedy_order_device(
    starts: np.ndarray,
    ends: np.ndarray,
    closed,
    closed_aware: bool,
    seed: int,
    device,
) -> Optional[Tuple[List[int], List[bool]]]:
    """(order, flips) of the greedy tour on ``device``: K9 on a CUDA device,
    the plain version on the CPU; None for fewer than 2 or more than
    :data:`MAX_N` contours (the caller runs the host planner)."""
    n = len(starts)
    if n < 2 or n > MAX_N:
        return None
    s, e, cl = to_device(device, np.asarray(starts, np.float32).reshape(n, 2),
                         np.asarray(ends, np.float32).reshape(n, 2), np.asarray(closed, bool).reshape(n))
    if s.is_cuda:
        from ..ops.kernels import greedy_order_cuda  # noqa: PLC0415

        order, flips = greedy_order_cuda(s, e, cl, closed_aware, int(seed))
    else:
        order, flips = greedy_order_plain(s, e, cl, closed_aware, int(seed))
    return order.tolist(), flips.tolist()
