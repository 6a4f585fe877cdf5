"""Deterministic k-means for colour-layer extraction (twin of
``plotweave/ops/kmeans.py``).

The clustering procedure is the JAX package's: a seeded uniform subsample,
k-means++ seeds, Lloyd iterations that stop when no centre moves more than
0.5, several attempts of which the first of least compactness wins, then an
all-point nearest-centre assignment.  Distances are ``|x|² − 2·x·cᵀ + |c|²``
in float32, as ``_lloyd`` phrases them; here every product and sum is written
out in a fixed order (no ``torch.matmul``, so TF32 never enters), each
three-term sum as ``(a + b) + c``, which kernel K8 (``csrc/kmeans.cu``)
repeats operation for operation.

Two entries:

- :func:`kmeans` (the tools' entry): the subsample and the k-means++ seeds on
  the host from numpy's Generator, the stream of the JAX package's
  ``kmeans``, then the Lloyd fits and the assignment on ``device``.
- :func:`kmeans_fit_device` (stage 02 with ``kmeans_init: "device"``): seeds
  drawn on the device from host-drawn random numbers, and the fits.

**The seed stream of the device mode.**  ``jax.random`` cannot be reproduced,
so the port defines its own, from CPU ``torch.Generator`` objects seeded as the
JAX package seeds its keys: ``seed`` for the subsample
(:func:`subsample_indices`: the first ``limit`` entries of
``torch.randperm(n)``), ``seed + 1000·a`` for attempt ``a``
(:func:`seed_stream`: one ``torch.randint`` index, then k − 1 ``torch.rand``
float32 uniforms).  The numbers are drawn on the host, so the stream is the
same for the card and for ``raster_device: "cpu"``.  A draw picks the first
index whose running sum of ``max(d², 1e-12)`` exceeds ``u · total``, the
running sum taken in the fixed order :func:`kpp_init_plain` spells out.  The
result is deterministic per seed; it is not the JAX stream and not numpy's.

On a CUDA tensor every function here runs its kernel (K8; 3-column data and
at most 8 centres), on a CPU tensor its plain version, and raises for any
other device.
"""

from __future__ import annotations

import numpy as np
import torch

from .colorspace import bgr_to_lab_u8
from .kernels import KPP_LANES
from .thinning import _on_card

KPP_WARP = 32  # lanes whose totals are summed in order before the warps' totals are


def _sum_cols(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim, left to right: ``((x0 + x1) + x2) + ...``."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _expanded_d2(data: torch.Tensor, sq: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, k) distances ``(|x|² − 2·x·c) + |c|²``, the dot product left to right."""
    dot = _sum_cols(data[:, None, :] * centers[None, :, :])
    return (sq[:, None] - 2.0 * dot) + _sum_cols(centers * centers)[None, :]


def lloyd_plain(data: torch.Tensor, init: torch.Tensor, iters: int, eps: float = 0.5):
    """One attempt's Lloyd loop, ``_lloyd`` line by line: assign by the
    expanded distance (first minimum), an empty cluster keeps its centre,
    shift = the largest centre movement, loop while ``shift > eps and it <
    iters``, then one more assignment → (centres (k, D), compactness = Σ min
    d², a 0-dim tensor that the expanded form can make slightly negative,
    iterations run)."""
    k = init.shape[0]
    sq = _sum_cols(data * data)
    centers, shift, it = init, float("inf"), 0
    while shift > eps and it < iters:
        labels = _expanded_d2(data, sq, centers).argmin(dim=1)
        counts = torch.bincount(labels, minlength=k)
        sums = torch.stack([(data * (labels == c)[:, None].to(data.dtype)).sum(dim=0) for c in range(k)])
        new = torch.where(counts[:, None] > 0, sums / counts.clamp(min=1)[:, None].to(data.dtype), centers)
        move = new - centers
        shift = float(torch.sqrt(_sum_cols(move * move)).max())
        centers, it = new, it + 1
    return centers, _expanded_d2(data, sq, centers).min(dim=1).values.sum(), it


def lloyd_fits_plain(data: torch.Tensor, inits: torch.Tensor, iters: int, eps: float = 0.5):
    """:func:`lloyd_plain` from each of ``inits``'s (attempts, k, D) seeds and
    the first attempt of least compactness (strict ``<`` from infinity, zeros
    where none is below it) → (best centres (k, D), centres (attempts, k, D),
    compactness (attempts,), iterations (attempts,) int32): the plain version
    of kernel K8's fit."""
    fits = [lloyd_plain(data, init, iters, eps) for init in inits]
    comp = torch.stack([f[1] for f in fits])
    best, best_comp = torch.zeros_like(inits[0]), float("inf")
    for centers, c, _ in fits:
        if float(c) < best_comp:
            best, best_comp = centers, float(c)
    return (best, torch.stack([f[0] for f in fits]), comp,
            torch.tensor([f[2] for f in fits], dtype=torch.int32, device=data.device))


def lloyd_fits(data: torch.Tensor, inits: torch.Tensor, iters: int, eps: float = 0.5, out: torch.Tensor | None = None):
    """:func:`lloyd_fits_plain` on the data's device: kernel K8 for a CUDA
    tensor (every attempt and the choice in one launch, nothing read back),
    the plain version for a CPU tensor, else raise.  ``out`` (3 k float32
    elements on that device) receives the best centres when given."""
    if _on_card("lloyd_fits", data):
        from .kernels import lloyd_fit_cuda  # noqa: PLC0415

        return lloyd_fit_cuda(data, inits.contiguous(), iters, eps, out)
    fit = lloyd_fits_plain(data, inits, iters, eps)
    if out is not None:
        out.view(fit[0].shape).copy_(fit[0])
        return (out.view(fit[0].shape), *fit[1:])
    return fit


def kpp_init_plain(sample: torch.Tensor, k: int, first: int, uniforms):
    """k-means++ seeds of one attempt: the first centre is row ``first``, each
    further one the first row, in index order, whose running sum ``R(i)`` of
    ``w = max(d², 1e-12)`` exceeds ``u · total`` (the last row if none does),
    where d² is the squared distance to the nearest centre so far, ``(e0² +
    e1²) + e2²``, updated by ``min`` after each draw.  The running sum has the
    kernel's fixed order: lane t of :data:`KPP_LANES` owns rows ``[t·L, (t +
    1)·L)``, ``L = ⌈n / KPP_LANES⌉``, and sums them from 0 in index order; the
    lanes' totals are summed in order within each warp of 32 lanes and the
    warps' totals in order; ``R(i) = (warp offset + lane offset) + (the
    chunk's sum up to and including i)`` and ``total`` is the warps' sum.
    → (centres (k, D), picked rows (k,) int32): the plain version of kernel
    K8's seeding."""
    n = sample.shape[0]
    length = -(-n // KPP_LANES)
    idx, picks, d2 = int(first), [], None
    for j in range(k):
        picks.append(idx)
        if j == k - 1:
            break
        e = sample - sample[idx]
        d = _sum_cols(e * e)
        d2 = d if d2 is None else torch.minimum(d2, d)
        w = torch.zeros(KPP_LANES * length, dtype=sample.dtype, device=sample.device)
        w[:n] = d2.clamp(min=1e-12)
        w = w.view(KPP_LANES, length)
        run, cols = torch.zeros(KPP_LANES, dtype=sample.dtype, device=sample.device), []
        for c in range(length):
            run = run + w[:, c]
            cols.append(run)
        chunk = torch.stack(cols, dim=1)  # (lanes, L): each chunk's inclusive running sum
        lane_tot = run.view(-1, KPP_WARP)
        acc, offs = torch.zeros(lane_tot.shape[0], dtype=sample.dtype, device=sample.device), []
        for lane in range(KPP_WARP):
            offs.append(acc)
            acc = acc + lane_tot[:, lane]
        lane_off = torch.stack(offs, dim=1)  # (warps, 32), exclusive within the warp
        total, warp_off = torch.zeros((), dtype=sample.dtype, device=sample.device), []
        for v in range(acc.shape[0]):
            warp_off.append(total)
            total = total + acc[v]
        base = (torch.stack(warp_off)[:, None] + lane_off).view(-1)
        target = torch.as_tensor(uniforms[j], dtype=sample.dtype).to(sample.device) * total
        hits = ((base[:, None] + chunk) > target).view(-1)[:n].nonzero()
        idx = int(hits[0]) if hits.numel() else n - 1
    picks_t = torch.tensor(picks, dtype=torch.int32, device=sample.device)
    return sample[picks_t.long()], picks_t


def kpp_init(sample: torch.Tensor, k: int, first: torch.Tensor, uniforms: torch.Tensor):
    """:func:`kpp_init_plain` for every attempt: ``first`` (attempts,) int32
    and ``uniforms`` (attempts, k − 1) float32, CPU tensors as
    :func:`seed_stream` draws them → (centres (attempts, k, D), picked rows
    (attempts, k) int32) on the sample's device: kernel K8 (one launch) for a
    CUDA sample, the plain version for a CPU sample, else raise."""
    n = sample.shape[0]
    if first.numel() and not 0 <= int(first.min()) <= int(first.max()) < n:
        raise ValueError(f"kpp_init: first indices outside the sample's {n} rows")
    if _on_card("kpp_init", sample):
        from .kernels import kpp_init_cuda  # noqa: PLC0415

        return kpp_init_cuda(sample, k, first.to(sample.device), uniforms.to(sample.device))
    fits = [kpp_init_plain(sample, k, int(f), u) for f, u in zip(first.tolist(), uniforms)]
    return torch.stack([f[0] for f in fits]), torch.stack([f[1] for f in fits])


def subsample_indices(seed: int, n: int, limit: int) -> torch.Tensor:
    """The device mode's subsample: ``limit`` of ``n`` indices without
    replacement, int32 on the CPU (see the module docstring)."""
    g = torch.Generator(device="cpu")
    g.manual_seed(int(seed))
    return torch.randperm(n, generator=g)[:limit].to(torch.int32)


def seed_stream(seed: int, attempts: int, k: int, n: int):
    """The device mode's random numbers: per attempt ``a`` a generator seeded
    ``seed + 1000·a`` gives one index below ``n`` and k − 1 float32 uniforms
    in [0, 1) → (first (attempts,) int32, uniforms (attempts, k − 1) float32),
    CPU tensors."""
    first, uniforms = [], []
    for a in range(attempts):
        g = torch.Generator(device="cpu")
        g.manual_seed(int(seed) + 1000 * a)
        first.append(torch.randint(n, (1,), generator=g, dtype=torch.int64))
        uniforms.append(torch.rand(k - 1, generator=g, dtype=torch.float32))
    return torch.cat(first).to(torch.int32), torch.stack(uniforms)


def kmeans_fit_device(sample: torch.Tensor, k: int, attempts: int, iters: int, seed: int,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """The device mode's fit (twin of the JAX package's
    ``kmeans_fit_device``): k-means++ seeds from :func:`seed_stream`, the
    Lloyd fit of each attempt, the first of least compactness → the winning
    (k, D) centres on the sample's device (in ``out`` when given).  On the
    card two launches of K8 and no read back."""
    first, uniforms = seed_stream(seed, attempts, k, sample.shape[0])
    inits, _ = kpp_init(sample, k, first, uniforms)
    return lloyd_fits(sample, inits, iters, out=out)[0]


def lab_sample(image: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
    """The float Lab of the pixels ``idx`` (a CPU integer tensor of indices
    into the flattened pixels, checked here; every pixel where None) of a
    (..., 3) uint8 BGR image → (n, 3) float32 on the image's device: kernel
    K8's sampler for a CUDA image, ``bgr_to_lab_u8`` of the gathered pixels
    for a CPU image, else raise."""
    px = image.numel() // 3
    if idx is not None and idx.numel() and not 0 <= int(idx.min()) <= int(idx.max()) < px:
        raise ValueError(f"lab_sample: indices outside the image's {px} pixels")
    if _on_card("lab_sample", image):
        from .kernels import lab_sample_cuda  # noqa: PLC0415

        return lab_sample_cuda(image, None if idx is None else idx.to(torch.int32).to(image.device))
    flat = image.reshape(-1, 3)
    return bgr_to_lab_u8(flat if idx is None else flat[idx.long()])


def assign_points_plain(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(n, D) points → the int32 index of each one's nearest centre by the
    expanded distance, first minimum."""
    return _expanded_d2(data, _sum_cols(data * data), centers).argmin(dim=1).to(torch.int32)


def assign_points(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """:func:`assign_points_plain` on the data's device (kernel K8's
    assignment for a CUDA tensor)."""
    if _on_card("assign_points", data):
        from .kernels import assign_points_cuda  # noqa: PLC0415

        return assign_points_cuda(data, centers.contiguous())
    return assign_points_plain(data, centers)


def _kpp_init(data: np.ndarray, k: int, rng: np.random.Generator) -> np.ndarray:
    """k-means++ seeding on the host (tiny: k passes over the sample)."""
    n = data.shape[0]
    centers = np.empty((k, data.shape[1]), dtype=data.dtype)
    centers[0] = data[rng.integers(n)]
    d2 = np.sum((data.astype(np.float64) - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        total = d2.sum()
        if total <= 0:  # degenerate: all points coincide with chosen centers
            centers[i] = data[rng.integers(n)]
            continue
        probs = d2 / total
        probs /= probs.sum()  # exact renormalization for rng.choice
        centers[i] = data[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, np.sum((data.astype(np.float64) - centers[i]) ** 2, axis=1))
    return centers


def kmeans(
    data: np.ndarray,
    k: int,
    sample_limit: int = 200_000,
    attempts: int = 3,
    iters: int = 40,
    seed: int = 42,
    assign: bool = True,
    device: str = "auto",
):
    """Cluster (N, D) float32 data; returns (centers [k,D], labels [N] or None
    when ``assign=False``), numpy arrays.

    The subsample index stream replicates the reference's
    ``np.random.default_rng(42).choice`` (02:41) so the fitted sample is
    identical; attempts use derived seeds for the ++ init (:func:`_kpp_init`,
    on the host).  The fits and the assignment run on ``device``: ``"auto"``
    is the CUDA card (kernel K8; raises without one, and for data that is not
    3 columns wide or more than 8 centres), ``"cpu"`` the plain versions."""
    from ..utils.devices import device_for  # noqa: PLC0415

    dev = device_for(device)
    data = np.ascontiguousarray(data, dtype=np.float32)
    n = data.shape[0]
    if n > sample_limit:
        idx = np.random.default_rng(seed).choice(n, size=sample_limit, replace=False)
        sample = data[idx]
    else:
        sample = data

    inits = np.stack([_kpp_init(sample, k, np.random.default_rng(seed + 1000 * a)) for a in range(attempts)])
    centers = lloyd_fits(torch.from_numpy(sample).to(dev), torch.from_numpy(inits).to(dev), iters)[0]
    if not assign:
        return centers.cpu().numpy(), None
    labels = assign_points(torch.from_numpy(data).to(dev), centers)
    return centers.cpu().numpy(), labels.cpu().numpy()
