"""Batched Bézier sampling on a torch device (kernel K14).

The port's counterpart of the JAX package's ``--sampling-backend jax``
(``plotweave/frontends/svg.py::sample_cubics_batched`` and
``sample_quads_batched`` with ``xp=jax.numpy``): every cubic (or quadratic)
segment of one path at the same ``n`` parameters ``t = i / (n - 1)``, the
Bernstein basis and a contraction over the control points, in float32.

- :func:`sample_bezier` runs on the device of its tensor: on a CUDA tensor
  one launch of K14 (``kernels.bezier_sample_cuda``), on a CPU tensor
  :func:`sample_bezier_plain`.
- :class:`BezierSampler` is the ``xp`` that ``frontends/svg.py`` takes in
  place of numpy (``--sampling-backend torch``): control points up as
  float32, the points back as a float32 ndarray.

numpy float64 stays the byte contract of the front-ends; this path agrees
with it within rtol 1e-4 and atol 1e-3 (``tests/test_torch_frontends.py``).
Importing this module builds nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.devices import device_for


def bernstein_basis(n: int, k: int, device=None) -> torch.Tensor:
    """(n, k) float32: the cubic (k = 4) or quadratic (k = 3) Bernstein basis
    at ``t = i / (n - 1)``, as ``linspace(0, 1, n)`` gives it."""
    t = (torch.arange(n, dtype=torch.float32, device=device) / max(n - 1, 1))[:, None]
    u = 1.0 - t
    if k == 4:
        return torch.cat([u**3, 3 * u**2 * t, 3 * u * t**2, t**3], dim=1)
    if k == 3:
        return torch.cat([u**2, 2 * u * t, t**2], dim=1)
    raise ValueError(f"expected 3 or 4 control points, got {k}")


def sample_bezier_plain(ctrl: torch.Tensor, n: int) -> torch.Tensor:
    """(S, K, 2) float32 control points → (S, n, 2) float32 points: the
    basis, then ``einsum("nk,skc->snc")``, on the tensor's device."""
    return torch.einsum("nk,skc->snc", bernstein_basis(n, ctrl.shape[1], ctrl.device), ctrl)


def sample_bezier(ctrl: torch.Tensor, n: int) -> torch.Tensor:
    """K14 on a CUDA tensor, the plain version on a CPU tensor."""
    if ctrl.is_cuda:
        from .kernels import bezier_sample_cuda  # noqa: PLC0415

        return bezier_sample_cuda(ctrl.contiguous(), n)
    return sample_bezier_plain(ctrl, n)


class BezierSampler:
    """``frontends/svg.py``'s ``xp`` for sampling on a torch device:
    ``sample(ctrl, n)`` takes one curve family of a path, (S, K, 2) float64
    control points, to float32 on ``device`` (``"auto"``: the CUDA card, or
    an error; ``"cpu"``: the plain version), samples it and returns the
    (S, n, 2) float32 points as an ndarray.  ``seconds`` adds up the time
    of the upload and the sampling (``"sample"``, the card synchronised) and
    of the copy back (``"copy"``); ``calls`` counts the families."""

    def __init__(self, device: str = "auto"):
        if str(device).lower() == "auto" and not torch.cuda.is_available():
            raise RuntimeError("the torch sampling backend runs on a CUDA device (--sampling-device auto), and "
                               "torch.cuda.is_available() is false; pass --sampling-device cpu to run the plain "
                               "version on the host")
        self.device = device_for(device)
        self.seconds = {"sample": 0.0, "copy": 0.0}
        self.calls = 0

    def sample(self, ctrl: np.ndarray, n: int) -> np.ndarray:
        t0 = time.perf_counter()
        c = torch.from_numpy(np.ascontiguousarray(ctrl, dtype=np.float32)).to(self.device)
        pts = sample_bezier(c, n)
        if pts.is_cuda:
            torch.cuda.synchronize(pts.device)
        t1 = time.perf_counter()
        out = pts.cpu().numpy()
        self.seconds["sample"] += t1 - t0
        self.seconds["copy"] += time.perf_counter() - t1
        self.calls += 1
        return out
