"""Separable Q8 Gaussian blur for uint8 images (twin of ``plotweave/ops/filters.py``).

The taps are OpenCV's fixed-point kernel (sum 256); one ``(acc + 2^15) >> 16``
rounding after both passes makes it bit-identical to cv2 for ksize ≤ 7.  The
row pass runs in int32 (PyTorch has no uint16 ``+`` on the CPU); its values
are the JAX uint16 pass's, at most 256·255 = 65280.  On a CUDA tensor the
blur runs in kernel K3+K4 (``csrc/edge_candidates.cu``): alone through
:func:`gaussian_blur_u8`, or fused with Canny's first half through
``ops.canny.edge_candidates``.
"""

from __future__ import annotations

import numpy as np
import torch

# canonical sigma=0 small kernels (Q8 numerators over 256)
_SMALL_TAB = {
    1: [256],
    3: [64, 128, 64],
    5: [16, 64, 96, 64, 16],
    7: [8, 28, 56, 72, 56, 28, 8],
}


def gaussian_kernel_q8(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """Q8 integer Gaussian taps (sum 256)."""
    if sigma <= 0 and ksize in _SMALL_TAB:
        return np.asarray(_SMALL_TAB[ksize], dtype=np.int32)
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x * x) / (2.0 * s * s))
    k /= k.sum()
    q = np.rint(k * 256.0).astype(np.int32)
    q[ksize // 2] += 256 - q.sum()
    return q


def reflect101_index(n: int, r: int, device=None) -> torch.Tensor:
    """Indices of a length-n axis padded by r on both sides with the
    reflect-101 border (numpy's ``mode="reflect"``, repeated for any r)."""
    i = np.arange(-r, n + r)
    if n == 1:
        return torch.zeros(i.size, dtype=torch.long, device=device)
    period = 2 * (n - 1)
    i = np.abs(i) % period
    i = np.where(i >= n, period - i, i)
    return torch.from_numpy(i).to(device)


def slab_rows(name: str, h: int, top: int, bottom: int, halo: int) -> int:
    """The own rows of a slab of ``h`` rows: a shard's own rows widened by
    ``top`` and ``bottom`` rows copied from its neighbours (row sharding,
    ``parallel/spatial.py``).  Each side has either no halo rows (the
    image's border, where a stencil applies its border rule) or at least
    ``halo``, the rows its stencil reads beyond an own row; raises
    otherwise."""
    for side, n in (("top", top), ("bottom", bottom)):
        if n < 0 or 0 < n < halo:
            raise ValueError(f"{name}: a {side} halo of {n} rows; the stencil needs 0 (the image's border) or at "
                             f"least {halo}")
    if h - top - bottom < 1:
        raise ValueError(f"{name}: a slab of {h} rows has no own rows inside halos of {top} and {bottom}")
    return h - top - bottom


def gaussian_blur_u8_plain(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Blur (..., H, W) uint8 with a reflect-101 border; bit-exact for ksize ≤ 7."""
    kq = gaussian_kernel_q8(ksize, sigma)
    r = ksize // 2
    if r == 0:
        return img
    h, w = img.shape[-2], img.shape[-1]
    p = img.to(torch.int32).index_select(-1, reflect101_index(w, r, img.device))
    tmp = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    for i in range(ksize):
        tmp = tmp + int(kq[i]) * p[..., :, i : i + w]
    p = tmp.index_select(-2, reflect101_index(h, r, img.device))
    acc = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    for i in range(ksize):
        acc = acc + int(kq[i]) * p[..., i : i + h, :]
    return ((acc + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def gaussian_blur_u8(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """:func:`gaussian_blur_u8_plain` on the image's device: the blur-only
    mode of kernel K3+K4 (``ops/kernels.py``) for a CUDA tensor, the plain
    version for a CPU tensor, else raise."""
    if ksize // 2 == 0:
        return img
    if img.is_cuda:
        from .kernels import gaussian_blur_cuda  # noqa: PLC0415

        return gaussian_blur_cuda(img, ksize, sigma)
    if img.device.type != "cpu":
        raise ValueError(f"gaussian_blur_u8: no kernel for device {img.device}")
    return gaussian_blur_u8_plain(img, ksize, sigma)


def gaussian_blur_slab_plain(x: torch.Tensor, ksize: int, top: int, bottom: int, w: int | None = None,
                             sigma: float = 0.0) -> torch.Tensor:
    """The blur of a slab's own rows (the plain version of K3+K4's blur-only
    slab mode): ``x`` is a uint8 slab (..., top + rows + bottom, W), or an
    int32 bitboard slab of width ``w`` whose set bits read as 255, and each
    side has 0 or at least ``ksize // 2`` halo rows → (..., rows, W) uint8.
    The halo rows are image rows, a side without them the image's border:
    the unsharded blur of the slab, its own rows kept."""
    own = slab_rows("gaussian_blur_slab", x.shape[-2], top, bottom, ksize // 2)
    if x.dtype == torch.int32:
        from .thinning import dense_from_boards_plain  # noqa: PLC0415 (thinning imports nothing of this module)

        x = dense_from_boards_plain(x, w, 255)
    return gaussian_blur_u8_plain(x, ksize, sigma)[..., top : top + own, :]


def gaussian_blur_slab(x: torch.Tensor, ksize: int, top: int, bottom: int, w: int | None = None,
                       sigma: float = 0.0) -> torch.Tensor:
    """:func:`gaussian_blur_slab_plain` on the slab's device: K3+K4's
    blur-only slab mode for a CUDA tensor, the plain version for a CPU
    tensor, else raise."""
    if x.is_cuda:
        from .kernels import gaussian_blur_slab_cuda  # noqa: PLC0415

        return gaussian_blur_slab_cuda(x, ksize, top, bottom, w, sigma)
    if x.device.type != "cpu":
        raise ValueError(f"gaussian_blur_slab: no kernel for device {x.device}")
    return gaussian_blur_slab_plain(x, ksize, top, bottom, w, sigma)
