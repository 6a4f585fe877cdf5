"""Canny edge detection, bit-compatible with OpenCV's L1 path (twin of
``plotweave/ops/canny.py``).

3×3 Sobel (replicate border) → L1 magnitude → Q15 sector non-maximum
suppression with OpenCV's strict / non-strict comparisons per sector →
double threshold → hysteresis.  The hysteresis grows the strong pixels
through the candidates, ``edges = cand & dilate8(edges)``, until nothing
changes, on the int32 bitboards of ``ops/thinning.py``.  Growth is monotone
and bounded by ``cand``, so the fixpoint is unique and any sweep schedule run
to "no change" gives it: :func:`hysteresis` runs kernel K5 on a CUDA tensor
and :func:`hysteresis_plain` on a CPU tensor.  Everything before the
hysteresis, with the Q8 blur in front of it, is one kernel on the card
(K3+K4, :func:`edge_candidates`) and :func:`edge_candidates_plain` on the CPU.
"""

from __future__ import annotations

import torch

from .filters import gaussian_blur_u8_plain, slab_rows
from .thinning import _nbr_bits, _shift_rows, dense_from_boards, dense_from_boards_plain, pack_bitboards_plain

_TG22 = 13573  # tan(22.5°) in Q15
_SHIFT = 15


def _nbr(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., i, j] = x[..., i+dy, j+dx]; reads beyond the border are 0."""
    h, w = x.shape[-2], x.shape[-1]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]


def _sobel_pair(img: torch.Tensor):
    """3×3 Sobel dx, dy with a replicate border, int16 (|g| ≤ 1020)."""
    x = img.to(torch.int16)
    h, w = img.shape[-2], img.shape[-1]
    rows = torch.arange(-1, h + 1, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=img.device).clamp(0, w - 1)
    p = x.index_select(-2, rows).index_select(-1, cols)

    def at(dy, dx):
        return p[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))
    gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
    return gx, gy


def _dilate8(e: torch.Tensor) -> torch.Tensor:
    row = e | _nbr_bits(e, 1) | _nbr_bits(e, -1)
    return row | _shift_rows(row, 1) | _shift_rows(row, -1)


def hysteresis_plain(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """Plain fixpoint of ``edges = cand & dilate8(edges)`` from ``strong``."""
    edges = strong
    while True:
        new = cand & _dilate8(cand & _dilate8(edges))
        if not bool((new != edges).any()):
            return new
        edges = new


def hysteresis(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """Hysteresis on (..., H, NW) int32 bitboards: kernel K5 for CUDA
    tensors, :func:`hysteresis_plain` for CPU tensors, else raise."""
    if cand.is_cuda:
        from .kernels import hysteresis_cuda  # noqa: PLC0415

        return hysteresis_cuda(cand, strong)
    if cand.device.type != "cpu":
        raise ValueError(f"hysteresis: no kernel for device {cand.device}")
    return hysteresis_plain(cand, strong)


def canny_candidates_plain(img: torch.Tensor, low: int, high: int):
    """Sobel, sector NMS and the double threshold of (..., H, W) uint8 →
    (candidate, strong) int32 bitboards: the hysteresis inputs."""
    gx, gy = _sobel_pair(img)
    cand, strong = nms_thresholds(gx, gy, gx.abs() + gy.abs(), low, high)
    return pack_bitboards_plain(cand), pack_bitboards_plain(strong)


def nms_thresholds(gx: torch.Tensor, gy: torch.Tensor, mag: torch.Tensor, low: int, high: int):
    """Q15 sector NMS of the L1 magnitude ``mag`` and the double threshold →
    (candidate, strong) bool pixels; ``mag`` beyond the border reads as 0."""
    if low > high:
        low, high = high, low
    # L1 magnitude ≤ 2040, so the thresholds clamp into int16 range losslessly
    low, high = min(low, 2041), min(high, 2041)

    # sector NMS; magnitude beyond the border reads as 0
    m_l, m_r = _nbr(mag, 0, -1), _nbr(mag, 0, 1)
    m_u, m_d = _nbr(mag, -1, 0), _nbr(mag, 1, 0)
    m_ul, m_ur = _nbr(mag, -1, -1), _nbr(mag, -1, 1)
    m_dl, m_dr = _nbr(mag, 1, -1), _nbr(mag, 1, 1)

    # the Q15 sector products need 32 bits; everything else stays int16
    ax = gx.abs().to(torch.int32)
    ay = gy.abs().to(torch.int32) << _SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_SHIFT + 1))

    horiz = ay < tg22x
    vert = ay > tg67x
    sign_neg = (gx ^ gy) < 0  # gradient along the anti-diagonal

    keep_h = (mag > m_l) & (mag >= m_r)
    keep_v = (mag > m_u) & (mag >= m_d)
    keep_d = torch.where(sign_neg, (mag > m_ur) & (mag > m_dl), (mag > m_ul) & (mag > m_dr))
    keep = torch.where(horiz, keep_h, torch.where(vert, keep_v, keep_d))

    cand = (mag > low) & keep
    return cand, cand & (mag > high)


def edge_candidates_plain(x: torch.Tensor, w: int, ksize: int, low: int, high: int, sigma: float = 0.0):
    """The plain version of kernel K3+K4: the Q8 blur, then
    :func:`canny_candidates_plain`.  ``x`` is an int32 bitboard (..., H,
    ceil(w/32)), a set bit reading as 255, or a uint8 image (..., H, w) →
    (candidate, strong) int32 bitboards."""
    img = dense_from_boards_plain(x, w, 255) if x.dtype == torch.int32 else x
    return canny_candidates_plain(gaussian_blur_u8_plain(img, ksize, sigma), low, high)


def edge_candidates(x: torch.Tensor, w: int, ksize: int, low: int, high: int, sigma: float = 0.0):
    """:func:`edge_candidates_plain` on the tensor's device: one launch of
    kernel K3+K4 (``ops/kernels.py``) for a CUDA tensor, the plain version
    for a CPU tensor, else raise."""
    if x.is_cuda:
        from .kernels import edge_candidates_cuda  # noqa: PLC0415

        return edge_candidates_cuda(x, w, ksize, low, high, sigma)
    if x.device.type != "cpu":
        raise ValueError(f"edge_candidates: no kernel for device {x.device}")
    return edge_candidates_plain(x, w, ksize, low, high, sigma)


def canny_candidates(img: torch.Tensor, low: int, high: int):
    """:func:`canny_candidates_plain` on the image's device (kernel K3+K4
    with ``ksize`` 1, which blurs nothing, for a CUDA image)."""
    return edge_candidates(img, img.shape[-1], 1, low, high)


def canny_boards(x: torch.Tensor, w: int, ksize: int, low: int, high: int) -> torch.Tensor:
    """Blur, Canny and hysteresis of a bitboard mask or a uint8 image → the
    edges as an int32 bitboard (K3+K4, then K5 on the card)."""
    return hysteresis(*edge_candidates(x, w, ksize, low, high))


def canny(img: torch.Tensor, low: int, high: int) -> torch.Tensor:
    """Binary edge map (uint8 0/255) of a (..., H, W) uint8 image (K3+K4, K5
    and K1 on the card); leading dims are batched."""
    return canny_packed(img, low, high)[0]


def canny_packed(img: torch.Tensor, low: int, high: int):
    """(..., H, W) uint8 → (dense uint8 0/255 edges, int32 bitboard edges)."""
    edges_b = hysteresis(*canny_candidates(img, low, high))
    return dense_from_boards(edges_b, img.shape[-1], 255), edges_b


def edge_candidates_slab_plain(x: torch.Tensor, w: int, ksize: int, low: int, high: int, top: int, bottom: int,
                               sigma: float = 0.0):
    """The plain version of K3+K4's slab mode: ``x`` is a slab of ``top`` +
    rows + ``bottom`` rows (a bitboard or a uint8 image, as
    :func:`edge_candidates_plain` takes), each side with 0 halo rows (the
    image's border) or at least ``ksize // 2 + 2`` (the blur's radius, then
    Sobel's and the NMS's row) → the (candidate, strong) bitboards of the
    own rows: the unsharded function of the slab, its own rows kept, which
    read no row that a border rule changes unless that side is the image's
    border."""
    own = slab_rows("edge_candidates_slab", x.shape[-2], top, bottom, ksize // 2 + 2)
    cand, strong = edge_candidates_plain(x, w, ksize, low, high, sigma)
    return cand[..., top : top + own, :], strong[..., top : top + own, :]


def edge_candidates_slab(x: torch.Tensor, w: int, ksize: int, low: int, high: int, top: int, bottom: int,
                         sigma: float = 0.0):
    """:func:`edge_candidates_slab_plain` on the slab's device: K3+K4's slab
    mode for a CUDA tensor, the plain version for a CPU tensor, else raise."""
    if x.is_cuda:
        from .kernels import edge_candidates_slab_cuda  # noqa: PLC0415

        return edge_candidates_slab_cuda(x, w, ksize, low, high, top, bottom, sigma)
    if x.device.type != "cpu":
        raise ValueError(f"edge_candidates_slab: no kernel for device {x.device}")
    return edge_candidates_slab_plain(x, w, ksize, low, high, top, bottom, sigma)


def hysteresis_slab_plain(cand: torch.Tensor, edges: torch.Tensor, top: int, bottom: int,
                          changed: torch.Tensor) -> torch.Tensor:
    """The plain version of K5's slab mode.  ``edges`` is a slab of ``top``
    + rows + ``bottom`` rows of int32 bitboards (each side 0 or at least 1
    halo row), ``cand`` the own rows' candidates → the hysteresis fixpoint
    of the own rows, the halo rows seeds that cannot grow (their candidates
    are their edges; a side without them reads zero rows).  ``changed``, a
    (1,) int32 tensor, gets 1 where an own row gained a bit over its edges,
    else 0."""
    own = slab_rows("hysteresis_slab", edges.shape[-2], top, bottom, 1)
    if cand.shape[-2] != own or cand.shape[:-2] != edges.shape[:-2] or cand.shape[-1] != edges.shape[-1]:
        raise ValueError(f"hysteresis_slab: candidates {tuple(cand.shape)} are not the own rows of edges "
                         f"{tuple(edges.shape)} with halos {top}, {bottom}")
    cand_h = torch.cat([edges[..., :top, :], cand, edges[..., top + own :, :]], dim=-2)
    out = hysteresis_plain(cand_h, edges)[..., top : top + own, :]
    changed.fill_(int(bool((out != edges[..., top : top + own, :]).any())))
    return out


def hysteresis_slab(cand: torch.Tensor, edges: torch.Tensor, top: int, bottom: int,
                    changed: torch.Tensor) -> torch.Tensor:
    """:func:`hysteresis_slab_plain` on the boards' device: K5's slab mode
    for a CUDA tensor, the plain version for a CPU tensor, else raise."""
    if cand.is_cuda:
        from .kernels import hysteresis_slab_cuda  # noqa: PLC0415

        return hysteresis_slab_cuda(cand, edges, top, bottom, changed)
    if cand.device.type != "cpu":
        raise ValueError(f"hysteresis_slab: no kernel for device {cand.device}")
    return hysteresis_slab_plain(cand, edges, top, bottom, changed)
