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
  drawn on the device from host-drawn random numbers, and the fits, in one
  launch of K8 on the card (:func:`kmeans_fits`).

**The random numbers of the device mode.**  ``jax.random`` cannot be
reproduced, so the port defines its own, the same for the card and for
``raster_device: "cpu"``.  The subsample (:func:`subsample_indices`) is drawn
on the image's device: pixel i gets the 32-bit key ``fmix32(i·a + b mod
2³²)`` (murmur3's finalizer; ``a`` odd and ``b`` two words of
``splitmix64(seed)``, :func:`draw_words`; a bijection of i, so no two keys
are equal), and the subsample is the ``limit`` pixels of least key, in
increasing index order.  Only the seeds'
k + 1 numbers per attempt come from host generators, a few bytes:
:func:`seed_stream` seeds a CPU ``torch.Generator`` with ``seed + 1000·a``
for attempt ``a`` (as the JAX package seeds its keys) and draws one
``torch.randint`` index, then k − 1 ``torch.rand`` float32 uniforms.  A draw
of the seeding picks the first row whose running sum of the integer weights
``max(⌊d²·2¹⁶⌋, 1)`` exceeds ``⌊total·u⌋`` (:func:`kpp_init_plain`); integer
sums are exact in any order.  The result is deterministic per seed; it is not
the JAX stream and not numpy's.

On a CUDA tensor every function here runs its kernel (K8; 3-column data and
at most 8 centres), on a CPU tensor its plain version, and raises for any
other device.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import torch

from .colorspace import bgr_to_lab_u8
from .kernels import KPP_MAX_N, KPP_SCALE_BITS, KPP_WEIGHT_CAP
from .thinning import _on_card

_M32, _M64 = 0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF


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


def kpp_weights(d2: torch.Tensor) -> torch.Tensor:
    """The seeding's int64 weights of float32 squared distances:
    ``max(⌊d²·2¹⁶⌋, 1)``, at most :data:`KPP_WEIGHT_CAP` (finite d²)."""
    scaled = (d2 * float(1 << KPP_SCALE_BITS)).clamp(max=float(KPP_WEIGHT_CAP))
    return scaled.to(torch.int64).clamp(min=1)


def kpp_target(total: int, u: float) -> int:
    """``⌊total·u⌋`` exactly, ``u`` (a float32 value) clamped to [0, 1]."""
    return math.floor(Fraction(min(max(float(u), 0.0), 1.0)) * total)


def kpp_init_plain(sample: torch.Tensor, k: int, first: int, uniforms):
    """k-means++ seeds of one attempt: the first centre is row ``first``, each
    further one the first row, in index order, whose running sum ``R(i)`` of
    the integer weights :func:`kpp_weights` of d² exceeds ``⌊total·u⌋``
    (:func:`kpp_target`; the last row if none does, which is ``u = 1``), where
    d² is the squared distance to the nearest centre so far, ``(e0² + e1²) +
    e2²`` in float32, updated by ``min`` after each draw.  Integer sums are
    exact, so the picks depend on no order of additions.  → (centres (k, D),
    picked rows (k,) int32): the plain version of kernel K8's seeding."""
    n = sample.shape[0]
    idx, picks, d2 = int(first), [], None
    for j in range(k):
        picks.append(idx)
        if j == k - 1:
            break
        e = sample - sample[idx]
        d = _sum_cols(e * e)
        d2 = d if d2 is None else torch.minimum(d2, d)
        run = torch.cumsum(kpp_weights(d2), 0)
        target = kpp_target(int(run[-1]), float(uniforms[j]))
        hit = int(torch.searchsorted(run, torch.tensor([target], device=run.device), right=True))
        idx = min(hit, n - 1)
    picks_t = torch.tensor(picks, dtype=torch.int32, device=sample.device)
    return sample[picks_t.long()], picks_t


def kpp_init(sample: torch.Tensor, k: int, first: torch.Tensor, uniforms: torch.Tensor):
    """:func:`kpp_init_plain` for every attempt: ``first`` (attempts,) int32
    and ``uniforms`` (attempts, k − 1) float32, CPU tensors as
    :func:`seed_stream` draws them → (centres (attempts, k, D), picked rows
    (attempts, k) int32) on the sample's device: kernel K8's seeds-and-fits
    launch with no iteration (Lloyd from zero iterations returns the seeds)
    for a CUDA sample, the plain version for a CPU sample, else raise.  A
    sample of :data:`KPP_MAX_N` rows or more is refused: its weights' sum
    could overflow 63 bits."""
    _check_seeds(sample, first)
    if _on_card("kpp_init", sample):
        from .kernels import kmeans_fit_cuda  # noqa: PLC0415

        fit = kmeans_fit_cuda(sample, seed_draws(first, uniforms).to(sample.device), 0)
        return fit[1], fit[4]
    fits = [kpp_init_plain(sample, k, int(f), u) for f, u in zip(first.tolist(), uniforms)]
    return torch.stack([f[0] for f in fits]), torch.stack([f[1] for f in fits])


def _check_seeds(sample: torch.Tensor, first: torch.Tensor) -> None:
    n = sample.shape[0]
    if not 0 < n < KPP_MAX_N:
        raise ValueError(f"kpp_init: {n} rows; the seeding takes 1 to {KPP_MAX_N - 1}")
    if first.numel() and not 0 <= int(first.min()) <= int(first.max()) < n:
        raise ValueError(f"kpp_init: first indices outside the sample's {n} rows")


def seed_draws(first: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """The seeding's random numbers packed as K8 takes them, one upload:
    (attempts, k) float32, each attempt's ``first`` index as int32 bits, then
    its k − 1 ``uniforms``."""
    return torch.cat([first.to(torch.int32)[:, None], uniforms.to(torch.float32).view(torch.int32)], 1).view(
        torch.float32)


def kmeans_fit_plain(sample: torch.Tensor, k: int, first: torch.Tensor, uniforms: torch.Tensor, iters: int,
                     eps: float = 0.5):
    """:func:`kpp_init_plain` for every attempt, then :func:`lloyd_fits_plain`
    from its seeds → (best centres (k, D), centres (attempts, k, D),
    compactness (attempts,), iterations (attempts,) int32, the seeds' rows
    (attempts, k) int32): the plain version of kernel K8's seeds-and-fits
    launch."""
    seeds = [kpp_init_plain(sample, k, int(f), u) for f, u in zip(first.tolist(), uniforms)]
    return (*lloyd_fits_plain(sample, torch.stack([s[0] for s in seeds]), iters, eps),
            torch.stack([s[1] for s in seeds]))


def kmeans_fits(sample: torch.Tensor, k: int, first: torch.Tensor, uniforms: torch.Tensor, iters: int,
                eps: float = 0.5, out: torch.Tensor | None = None):
    """:func:`kmeans_fit_plain` on the sample's device: kernel K8's
    seeds-and-fits launch for a CUDA sample (the random numbers uploaded in
    one copy, nothing read back), the plain version for a CPU sample, else
    raise.  ``first`` (attempts,) int32 and ``uniforms`` (attempts, k − 1)
    float32 as :func:`seed_stream` draws them; ``out`` (3 k float32 elements
    on the sample's device) receives the best centres when given."""
    _check_seeds(sample, first)
    if _on_card("kmeans_fits", sample):
        from .kernels import kmeans_fit_cuda  # noqa: PLC0415

        return kmeans_fit_cuda(sample, seed_draws(first, uniforms).to(sample.device), iters, eps, out)
    fit = kmeans_fit_plain(sample, k, first, uniforms, iters, eps)
    if out is not None:
        out.view(fit[0].shape).copy_(fit[0])
        return (out.view(fit[0].shape), *fit[1:])
    return fit


def draw_words(seed: int) -> tuple:
    """The draw's two key words of ``seed``: ``z = splitmix64(seed)``, ``a =
    (z >> 32) | 1`` (odd, so ``i·a + b`` is a bijection mod 2³²) and ``b = z
    mod 2³²``."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    z ^= z >> 31
    return (z >> 32) | 1, z & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x·c mod 2³²`` for int64 ``x`` in [0, 2³²): the product in 16-bit
    halves of ``c``, so nothing exceeds 2⁴⁹."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def draw_keys(seed: int, n: int, device="cpu") -> torch.Tensor:
    """The draw's key of every pixel ``i < n``: ``fmix32(i·a + b mod 2³²)``,
    as int64; distinct, since both steps are bijections of ``i``."""
    a, b = draw_words(seed)
    h = (torch.arange(n, dtype=torch.int64, device=device) * a + b) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def subsample_indices_plain(seed: int, n: int, limit: int, device="cpu") -> torch.Tensor:
    """The ``limit`` indices below ``n`` of least key (:func:`draw_keys`),
    increasing, int32 on ``device``; every index in order where ``n ≤
    limit``."""
    if n <= limit:
        return torch.arange(n, dtype=torch.int32, device=device)
    keys = draw_keys(seed, n, device)
    return torch.nonzero(keys <= torch.kthvalue(keys, limit).values).flatten().to(torch.int32)


def subsample_indices(seed: int, n: int, limit: int, device="cpu") -> torch.Tensor:
    """The device mode's subsample (see the module docstring): ``limit`` of
    ``n`` indices without replacement, increasing, int32 on ``device``:
    kernel K8's draw for a CUDA device (nothing read back), the plain version
    for the CPU, else raise; every index in order where ``n ≤ limit``."""
    device = torch.device(device)
    if limit < 1 or not 0 < n < 2**31:
        raise ValueError(f"subsample_indices: expected 0 < n < 2^31 and limit >= 1, got n = {n}, limit = {limit}")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"subsample_indices: no kernel for device {device}")
    if device.type == "cuda" and n > limit:
        from .kernels import subsample_cuda  # noqa: PLC0415

        return subsample_cuda(draw_words(seed), n, limit, device)
    return subsample_indices_plain(seed, n, limit, device)


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
    card one launch of K8 for seeds and fits, one upload of the seeds' k
    numbers per attempt, and no read back."""
    first, uniforms = seed_stream(seed, attempts, k, sample.shape[0])
    return kmeans_fits(sample, k, first, uniforms, iters, out=out)[0]


def lab_sample(image: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
    """The float Lab of the pixels ``idx`` (an integer tensor of indices into
    the flattened pixels, checked here wherever it lies, which reads a CUDA
    tensor's least and greatest back; every pixel where None) of a (..., 3)
    uint8 BGR image → (n, 3) float32 on the image's device: kernel K8's
    sampler for a CUDA image, ``bgr_to_lab_u8`` of the gathered pixels for a
    CPU image, else raise."""
    px = image.numel() // 3
    if idx is not None and idx.numel() and not 0 <= int(idx.min()) <= int(idx.max()) < px:
        raise ValueError(f"lab_sample: indices outside the image's {px} pixels")
    if _on_card("lab_sample", image):
        from .kernels import lab_sample_cuda  # noqa: PLC0415

        return lab_sample_cuda(image, None if idx is None else idx.to(torch.int32).to(image.device))
    flat = image.reshape(-1, 3)
    return bgr_to_lab_u8(flat if idx is None else flat[idx.long()])


def subsample_lab(image: torch.Tensor, seed: int, limit: int) -> torch.Tensor:
    """The device mode's sample: the float Lab (:func:`lab_sample`) of the
    pixels :func:`subsample_indices` draws from a (..., 3) uint8 BGR image on
    its device, every pixel in order where it has no more than ``limit`` →
    (n, 3) float32.  The indices are drawn below the pixel count, so on the
    card they go to the sampler as they are and nothing is read back."""
    px = image.numel() // 3
    if px <= limit:
        return lab_sample(image)
    idx = subsample_indices(seed, px, limit, image.device)
    if _on_card("lab_sample", image):
        from .kernels import lab_sample_cuda  # noqa: PLC0415

        return lab_sample_cuda(image, idx)
    return lab_sample(image, idx)


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
