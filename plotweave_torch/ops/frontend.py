"""Fused raster front-end: image → per-layer edges + skeletons (twin of
``plotweave/ops/frontend.py``).

Lab conversion and the nearest of k centres as one-hot bitboards (kernel K7
on the card: no labels reach device memory), four packed morphology programs
as one step list (kernel K2, one launch), the Q8 blur with Canny's Sobel, NMS
and thresholds (kernel K3+K4, one launch), the hysteresis (kernel K5) and
Zhang–Suen thinning: the packed fixpoint K6 by default, whose stores write
both dense outputs, or the dense kernel K12 with ``pallas_thinning=True``,
where kernel K1 turns the boards into dense bytes and back.  Leading batch
dims are allowed on both routes.  Everything runs on the device of the
image: on the card every step is a kernel of ``csrc/``, on the CPU its plain
version.  After the labels the chain is
integer, so from the same labels its bytes are the same on either device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .canny import canny_boards
from .colorspace import _M, _WHITE, bgr_to_lab_u8
from .morphology import _valid_bits, morph_program, morph_steps
from .thinning import (
    _on_card, dense_from_boards, pack_bitboards, pack_bitboards_plain, zhang_suen_dense, zhang_suen_into)


def _centers_on(centers, device: torch.device, k: int) -> torch.Tensor:
    """(k, 3) float32 centres on ``device``: arrays are placed there, a tensor
    must already be there."""
    if isinstance(centers, torch.Tensor):
        if centers.device != device:
            raise ValueError(f"centers are on {centers.device}, the image on {device}")
        c = centers.to(torch.float32)
    else:
        c = torch.as_tensor(centers, dtype=torch.float32, device=device)
    if c.dim() != 2 or c.shape[1] != 3 or c.shape[0] < k:
        raise ValueError(f"expected at least {k} centers of shape (k, 3), got {tuple(c.shape)}")
    return c[:k].contiguous()


def nearest_of_lab(lab: torch.Tensor, centers: torch.Tensor, k: int) -> torch.Tensor:
    """(..., 3) float32 Lab + (k, 3) float32 → (...) int32, the centre of least
    ``(d0² + d1²) + d2²``: a running (best, argbest) pair with strict ``<``,
    so the first minimum wins (== argmin).  Kernel K7's distance, operation
    for operation."""
    c = [[float(v) for v in row] for row in centers.cpu().tolist()]

    def dist(i):
        d0, d1, d2 = lab[..., 0] - c[i][0], lab[..., 1] - c[i][1], lab[..., 2] - c[i][2]
        return d0 * d0 + d1 * d1 + d2 * d2

    best_d = dist(0)
    best = torch.zeros(lab.shape[:-1], dtype=torch.int32, device=lab.device)
    for i in range(1, k):
        d = dist(i)
        best = torch.where(d < best_d, i, best)
        best_d = torch.minimum(best_d, d)
    return best


def assign_nearest_plain(image: torch.Tensor, centers: torch.Tensor, k: int) -> torch.Tensor:
    """Nearest-Lab-centre label per pixel: (..., H, W, 3) uint8 + (k, 3)
    float32 → (..., H, W) int32 (:func:`nearest_of_lab` of the float Lab)."""
    return nearest_of_lab(bgr_to_lab_u8(image), centers, k)


def nearest_gaps(pixels: np.ndarray, centers) -> np.ndarray:
    """(n, 3) uint8 BGR → the float64 gap between the squared Lab distances
    of each pixel's two nearest centres.  Labels from float32 arithmetic may
    differ between devices or packages only where this gap is tiny (the
    near-tie rule of the tests and ``chip_smoke.py``)."""
    rgb = pixels[..., ::-1].astype(np.float64) / 255.0
    lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _M.astype(np.float64).T / _WHITE.astype(np.float64)
    d = 6.0 / 29.0
    f = np.where(xyz > d**3, np.cbrt(xyz), xyz / (3 * d * d) + 4.0 / 29.0)
    lab = np.stack([(116.0 * f[..., 1] - 16.0) * 255.0 / 100.0, 500.0 * (f[..., 0] - f[..., 1]) + 128.0,
                    200.0 * (f[..., 1] - f[..., 2]) + 128.0], axis=-1)
    dist = np.sort(((lab[:, None, :] - np.asarray(centers, np.float64)) ** 2).sum(-1), axis=-1)
    return dist[:, 1] - dist[:, 0]


def onehot_boards_plain(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) int32 labels → the ``k`` one-hot int32 bitboards (..., k,
    H, ceil(W/32)): bit x of layer c is set where the label is c."""
    return pack_bitboards_plain(labels[..., None, :, :] == torch.arange(k, device=labels.device)[:, None, None])


def assign_boards_plain(image: torch.Tensor, centers: torch.Tensor, k: int) -> torch.Tensor:
    """The one-hot bitboards of :func:`assign_nearest_plain`'s labels: the
    plain version of kernel K7's boards."""
    return onehot_boards_plain(assign_nearest_plain(image, centers, k), k)


def assign_nearest(image: torch.Tensor, centers, k: int) -> torch.Tensor:
    """:func:`assign_nearest_plain` on the image's device: kernel K7 for a
    CUDA image, the plain version for a CPU image, else raise."""
    c = _centers_on(centers, image.device, k)
    if _on_card("assign_nearest", image):
        from .kernels import assign_nearest_cuda  # noqa: PLC0415

        return assign_nearest_cuda(image, c)
    return assign_nearest_plain(image, c, k)


def assign_boards(image: torch.Tensor, centers, k: int) -> torch.Tensor:
    """(..., H, W, 3) uint8 BGR → the one-hot int32 bitboards (..., k, H,
    ceil(W/32)) of each pixel's nearest centre: kernel K7 for a CUDA image
    (it writes the boards directly), :func:`assign_boards_plain` for a CPU
    image, else raise."""
    c = _centers_on(centers, image.device, k)
    if _on_card("assign_boards", image):
        from .kernels import assign_boards_cuda  # noqa: PLC0415

        return assign_boards_cuda(image, c)
    return assign_boards_plain(image, c, k)


def assign_boards_counts_plain(image: torch.Tensor, centers: torch.Tensor, k: int):
    """:func:`assign_boards_plain`'s boards of one (H, W, 3) image and the
    pixels of each centre, (k,) int32: the plain version of kernel K7 with
    counts."""
    labels = assign_nearest_plain(image, centers, k)
    counts = torch.bincount(labels.reshape(-1).long(), minlength=k).to(torch.int32)
    return onehot_boards_plain(labels, k), counts


def assign_boards_counts(image: torch.Tensor, centers, k: int, counts: torch.Tensor | None = None):
    """One (H, W, 3) uint8 BGR image → (the one-hot int32 bitboards (k, H,
    ceil(W/32)) of each pixel's nearest centre, the pixels of each centre (k,)
    int32): stage 02's argmin and ``sel.sum``.  Kernel K7 for a CUDA image
    (one launch; exact integer counts), :func:`assign_boards_counts_plain` for
    a CPU image, else raise.  ``counts`` (a contiguous (k,) int32 tensor on
    the image's device) receives the counts when given."""
    if image.dim() != 3:
        raise ValueError(f"assign_boards_counts: expected one (H, W, 3) image, got {tuple(image.shape)}")
    c = _centers_on(centers, image.device, k)
    if _on_card("assign_boards_counts", image):
        from .kernels import assign_boards_cuda  # noqa: PLC0415

        if counts is None:
            counts = torch.empty(k, dtype=torch.int32, device=image.device)
        return assign_boards_cuda(image, c, counts), counts
    boards, n = assign_boards_counts_plain(image, c, k)
    return boards, n if counts is None else counts.copy_(n)


def onehot_boards(labels: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`onehot_boards_plain` on the labels' device (kernel K1 on the card)."""
    if _on_card("onehot_boards", labels):
        from .kernels import labels_to_boards_cuda  # noqa: PLC0415

        return labels_to_boards_cuda(labels, k)
    return onehot_boards_plain(labels, k)


def frontend_steps(extract_iters: int = 1, edge_kernel: int = 3, edge_iters: int = 1) -> tuple:
    """The front-end's four morphology programs (the JAX package's four
    ``morph_bits`` calls), rect open and close, then ellipse open and close,
    as one step list."""
    return (morph_program("rect", 3, extract_iters, "ed") + morph_program("rect", 3, extract_iters, "de")
            + morph_program("ellipse", edge_kernel, edge_iters, "ed")
            + morph_program("ellipse", edge_kernel, edge_iters, "de"))


def frontend_from_boards(
    masks_b: torch.Tensor,  # (..., k, H, ceil(W/32)) int32 one-hot bitboards
    w: int,
    *,
    extract_iters: int = 1,
    edge_kernel: int = 3,
    edge_iters: int = 1,
    blur_kernel: int = 7,
    low: int = 22,
    high: int = 70,
    thin_iters: int = 120,
    pallas_thinning: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The front-end after the assignment, over bitboards → (edges,
    skeletons), each (..., k, H, W) uint8; see :func:`raster_frontend` for
    the parameters.  On the card: K2, K3+K4, K5, then K6 writing both outputs
    (a layer too large for K6's resident route: K6's launches, then K1's), or
    K1, K12 and K1."""
    steps = frontend_steps(extract_iters, edge_kernel, edge_iters)
    masks_b = morph_steps(masks_b, _valid_bits(w, masks_b.device), steps)
    # the hysteresis board feeds the packed thinner in the same encoding
    edges_b = canny_boards(masks_b, w, blur_kernel, low, high)
    h = edges_b.shape[-2]
    if pallas_thinning:
        edges = dense_from_boards(edges_b, w, 255)
        # the images of a batch are more planes to K12
        skel_b = pack_bitboards(zhang_suen_dense(edges.view(-1, h, w), max_iter=thin_iters, rotated=True))
        return edges, dense_from_boards(skel_b, w, 1).view(edges.shape)
    edges = torch.empty((*edges_b.shape[:-1], w), dtype=torch.uint8, device=edges_b.device)
    skels = torch.empty_like(edges)
    zhang_suen_into(edges_b, w, edges.view(-1, 1, h, w), skels.view(-1, 1, h, w), "dense", thin_iters, True)
    return edges, skels


def frontend_from_labels(labels: torch.Tensor, k: int, **params) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`frontend_from_boards` from (..., H, W) int32 labels."""
    return frontend_from_boards(onehot_boards(labels, k), labels.shape[-1], **params)


def raster_frontend(
    image: torch.Tensor,  # (..., H, W, 3) uint8 BGR; leading batch dims allowed
    centers,  # (k, 3) float32 Lab centres: an array, or a tensor on the image's device
    *,
    k: int = 4,
    extract_iters: int = 1,
    edge_kernel: int = 3,
    edge_iters: int = 1,
    blur_kernel: int = 7,
    low: int = 22,
    high: int = 70,
    thin_iters: int = 120,
    pallas_thinning: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (edges (..., k, H, W) uint8 0/255, skeletons (..., k, H, W)
    uint8 0/1), on the image's device.

    ``pallas_thinning=True`` thins with the dense fixpoint
    (:func:`ops.thinning.zhang_suen_dense`, kernel K12, the port of
    ``zhang_suen_pallas``) instead of the packed one; the skeletons are the
    same.  A batch's images are more planes to it, where the JAX kernel
    takes no batch dims (so ``frontend_batch`` runs this route too).  The
    keyword keeps its JAX name so a call site ports by its import alone."""
    return frontend_from_boards(
        assign_boards(image, centers, k), image.shape[-2], extract_iters=extract_iters, edge_kernel=edge_kernel,
        edge_iters=edge_iters, blur_kernel=blur_kernel, low=low, high=high, thin_iters=thin_iters,
        pallas_thinning=pallas_thinning,
    )
