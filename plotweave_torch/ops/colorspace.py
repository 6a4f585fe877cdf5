"""BGR → Lab in OpenCV's 8-bit scaling (twin of ``plotweave/ops/colorspace.py``).

Float sRGB → XYZ (D65) → L*a*b*, packed as L·255/100, a+128, b+128.  Every
step is one float32 operation in a fixed order, so the same arithmetic runs
in kernel K7 (``csrc/assign_nearest.cu``):

- the 3×3 product is written out as multiply-adds in the einsum's row order
  (no ``torch.matmul``, so TF32 never enters);
- each division by a constant divides by a 0-dim tensor: on CUDA, PyTorch
  turns division by a Python scalar into multiplication by its reciprocal,
  which rounds differently;
- ``torch.pow(t, 1/3)`` stands in for ``jnp.cbrt``; the branch takes it only
  for ``t > (6/29)^3 > 0``.
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB → XYZ (D65) and the white point; copied from plotweave/ops/colorspace.py
# because importing that module loads jax
_M = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)

_D = 6.0 / 29.0


def _div(x: torch.Tensor, v: float) -> torch.Tensor:
    """``x / float32(v)``, correctly rounded on every device."""
    return x / torch.tensor(v, dtype=torch.float32, device=x.device)


def _srgb_gamma_inv(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u <= 0.04045, _div(u, 12.92), _div(u + 0.055, 1.055) ** 2.4)


def _f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _D**3, torch.pow(t, 1.0 / 3.0), _div(t, 3 * _D * _D) + 4.0 / 29.0)


def bgr_to_lab_u8(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR → (..., 3) float32 Lab in 8-bit scaling (0..255)."""
    bgr = _div(img.to(torch.float32), 255.0)
    lin = [_srgb_gamma_inv(bgr[..., 2 - c]) for c in range(3)]  # R, G, B
    fx, fy, fz = (
        _f(_div(float(m[0]) * lin[0] + float(m[1]) * lin[1] + float(m[2]) * lin[2], float(white)))
        for m, white in zip(_M, _WHITE)
    )
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([_div(L * 255.0, 100.0), a + 128.0, b + 128.0], dim=-1)
