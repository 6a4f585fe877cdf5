"""Area-average (INTER_AREA) downscale on a torch device (twin of
``plotweave/ops/resize.py``).

Rounding contracts (reference behaviour: 01_resize.py:7-23 via cv2.resize),
as the JAX package's:

- integer scale ratio: the box sum; 2×2 as ``(sum + 2) >> 2``, every other
  ratio ``rint(sum / area)`` in float32 (the JAX package spells that float64,
  but it never enables x64) — bit-exact with OpenCV's fast path.
- fractional ratio: OpenCV's ``resizeArea``: ``computeResizeAreaTab``'s tap
  table (:func:`_resize_area_tab`, a copy of the JAX package's), a
  horizontal then a vertical float32 pass, each summing its taps in table
  order with every product rounded before its add, half-to-even rounding —
  bit-exact with OpenCV.

On a CUDA tensor each route is one launch of kernel K13
(``kernels.area_resize_frac_cuda``, ``area_resize_int_cuda``); on a CPU
tensor the plain versions below run.  Importing this module builds nothing.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..utils.devices import device_for


@lru_cache(maxsize=64)
def _resize_area_tab(ssize: int, dsize: int):
    """OpenCV ``computeResizeAreaTab`` replica (resize.cpp): per destination
    index, the ordered (source index, float32 alpha) taps.  Returned padded
    to the max tap count with alpha=0 (adding ``0.0`` is exact, so padding
    preserves the float32 accumulation order of the real taps)."""
    scale = ssize / dsize
    ent = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cw = min(scale, ssize - fsx1)
        sx1 = math.ceil(fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(sx1, sx2)
        e = []
        if sx1 - fsx1 > 1e-3:
            e.append((sx1 - 1, np.float32((sx1 - fsx1) / cw)))
        inv = np.float32(1.0 / cw)
        for sx in range(sx1, sx2):
            e.append((sx, inv))
        if fsx2 - sx2 > 1e-3:
            e.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), cw) / cw)))
        ent.append(e)
    taps = max(len(e) for e in ent)
    si = np.zeros((dsize, taps), np.int32)
    al = np.zeros((dsize, taps), np.float32)
    for d, e in enumerate(ent):
        for t, (s, a) in enumerate(e):
            si[d, t] = s
            al[d, t] = a
    return si, al


def area_resize_frac_plain(x: torch.Tensor, new_w: int, new_h: int) -> torch.Tensor:
    """(H, W, C) uint8 → (new_h, new_w, C) uint8 by the tap tables: each pass
    a product per tap, materialised before it is added, so no multiply-add
    is contracted."""
    xsi, xal = (torch.from_numpy(a).to(x.device) for a in _resize_area_tab(x.shape[1], new_w))
    ysi, yal = (torch.from_numpy(a).to(x.device) for a in _resize_area_tab(x.shape[0], new_h))
    xf = x.float()
    hb = None
    for t in range(xsi.shape[1]):
        p = xf[:, xsi[:, t].long(), :] * xal[None, :, t, None]
        hb = p if hb is None else hb + p
    acc = None
    for t in range(ysi.shape[1]):
        p = hb[ysi[:, t].long(), :, :] * yal[:, t, None, None]
        acc = p if acc is None else acc + p
    return torch.round(acc).clamp_(0, 255).to(torch.uint8)


def area_resize_int_plain(x: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """(H, W, C) uint8 whose sides ``sy`` and ``sx`` divide → the box means
    (H/sy, W/sx, C) uint8, rounded as OpenCV's integer-ratio fast path."""
    h, w, c = x.shape
    s = x.to(torch.int32).reshape(h // sy, sy, w // sx, sx, c).sum(dim=(1, 3), dtype=torch.int32)
    if (sy, sx) == (2, 2):
        return ((s + 2) >> 2).to(torch.uint8)
    return torch.round(s.float() / (sy * sx)).clamp_(0, 255).to(torch.uint8)


def area_resize(img, new_w: int, new_h: int) -> torch.Tensor:
    """Downscale a (H, W) or (H, W, C) uint8 image with area averaging; picks
    the bit-exact route for the ratio.  A tensor is resized on its device; an
    ndarray is uploaded to the CUDA card first (an error without one)."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img)).to(device_for("auto"))
    h, w = img.shape[:2]
    if (new_w, new_h) == (w, h):
        return img
    x = (img if img.dim() == 3 else img[:, :, None]).contiguous()
    if h % new_h == 0 and w % new_w == 0:
        if x.is_cuda:
            from .kernels import area_resize_int_cuda  # noqa: PLC0415

            o = area_resize_int_cuda(x, h // new_h, w // new_w)
        else:
            o = area_resize_int_plain(x, h // new_h, w // new_w)
    elif x.is_cuda:
        from .kernels import area_resize_frac_cuda  # noqa: PLC0415

        o = area_resize_frac_cuda(x, new_w, new_h)
    else:
        o = area_resize_frac_plain(x, new_w, new_h)
    return o if img.dim() == 3 else o[:, :, 0]


def resize_if_needed(img, max_dimension: int):
    """Cap the longest side at ``max_dimension`` (reference 01_resize.py:7-23)
    → (image, resized?); the input itself where no resize is needed."""
    h, w = img.shape[:2]
    m = max(h, w)
    if m <= max_dimension:
        return img, False  # no upload for a no-op
    scale = max_dimension / m
    return area_resize(img, int(w * scale), int(h * scale)), True
