"""Batched Bézier sampling on a torch device (kernel K14).

The port's counterpart of the JAX package's ``--sampling-backend jax``
(``plotweave/frontends/svg.py::sample_cubics_batched`` and
``sample_quads_batched`` with ``xp=jax.numpy``): every cubic (or quadratic)
segment of one path at the same ``n`` parameters ``t = i / (n - 1)``, the
Bernstein basis and a contraction over the control points, in float32.  Such
a set of segments is a curve family.

- :func:`sample_bezier_plain` is the plain version of one family; on the
  card ``kernels.bezier_sample_cuda`` runs one family as a table of one.
- :func:`pack_families` packs a document's families into one int32 buffer
  (control points, the family table, K14's start table), which
  ``kernels.bezier_families_cuda`` samples in one launch of K14 on the card,
  and :func:`sample_families_plain` family by family.
- :class:`BezierSampler` is the ``xp`` that ``frontends/svg.py`` takes in
  place of numpy (``--sampling-backend torch``): ``svg_to_polylines`` hands
  it the whole document's families at once (:meth:`BezierSampler.sample_families`:
  one upload, one launch, one copy back, one synchronisation), and
  ``parse_path_data`` alone one family at a time (:meth:`BezierSampler.sample`).

numpy float64 stays the byte contract of the front-ends; this path agrees
with it within rtol 1e-4 and atol 1e-3 (``tests/test_torch_frontends.py``).
Importing this module builds nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.devices import device_for
from .kernels import BEZIER_THREADS, bezier_families_cuda, bezier_layout


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


def pack_families(families, pin: bool = False):
    """A document's curve families ``[(ctrl (S, K, 2), n), ...]`` (K = 3 or
    4, n >= 1, any float dtype) → (words, table, n_points): one int32 buffer
    (pinned where ``pin``) that holds the non-empty families' control points
    as float32 back to back, padded to 4 words, then their (F, 4) table
    {control offset in floats, output offset in points, n, K}, then the start
    table of K14's CTAs (the family of each CTA's first point, then F − 1);
    ``table`` as an ndarray with a row for every family given, -1 where it
    has no point; the points of all the families."""
    table = np.full((len(families), 4), -1, np.int64)
    kept = []
    floats = points = 0
    for j, (ctrl, n) in enumerate(families):
        s, k = np.shape(ctrl)[:2]
        if k not in (3, 4) or n < 1:
            raise ValueError(f"pack_families: expected (S, 3 or 4, 2) control points and n >= 1, got K = {k}, n = {n}")
        if s:
            table[j] = floats, points, n, k
            kept.append(j)
            floats, points = floats + s * k * 2, points + s * n
    if floats >= 2**31 or points >= 2**31:
        raise ValueError(f"pack_families: {points} points of {floats} control floats exceed K14's int32 range")
    entries = table[kept]
    table_off = -(-floats // 4) * 4
    first_off = table_off + 4 * len(kept)
    ctas = -(-points // BEZIER_THREADS)
    words = torch.empty(first_off + ctas + 1, dtype=torch.int32, pin_memory=pin)
    w = words.numpy()
    if kept:
        w[:floats].view(np.float32)[:] = np.concatenate(
            [np.asarray(families[j][0], dtype=np.float32).reshape(-1) for j in kept])
    w[floats:table_off] = 0
    w[table_off:first_off] = entries.reshape(-1)
    starts = np.arange(ctas + 1) * BEZIER_THREADS
    w[first_off:] = np.minimum(np.searchsorted(entries[:, 1], starts, side="right") - 1, max(len(kept) - 1, 0))
    return words, table, points


def sample_families_plain(words: torch.Tensor, n_fam: int, n_points: int) -> torch.Tensor:
    """The plain version of K14 on a document: :func:`sample_bezier_plain`
    of each of the ``n_fam`` families of a :func:`pack_families` buffer, in
    table order, on the buffer's device → (n_points, 2) float32, every
    family's points back to back."""
    table_off, _ = bezier_layout(words.numel(), n_fam, n_points)
    ctrl = words[:table_off].view(torch.float32)
    out = torch.empty((n_points, 2), dtype=torch.float32, device=words.device)
    entries = words[table_off: table_off + 4 * n_fam].view(n_fam, 4).tolist()
    for j, (c0, o0, n, k) in enumerate(entries):
        o1 = entries[j + 1][1] if j + 1 < n_fam else n_points
        s = (o1 - o0) // n
        out[o0:o1] = sample_bezier_plain(ctrl[c0: c0 + s * k * 2].view(s, k, 2), n).reshape(-1, 2)
    return out


class BezierSampler:
    """``frontends/svg.py``'s ``xp`` for sampling on a torch device
    (``"auto"``: the CUDA card, or an error; ``"cpu"``: the plain version),
    in float32.  :meth:`sample_families` takes a whole document's curve
    families, each (S, K, 2) float64 control points and its n, and returns
    each family's (S, n, 2) float32 points as an ndarray: on the card one
    pinned staging buffer (:func:`pack_families`), one upload, one launch of
    K14, one copy back into pinned memory and one synchronisation, each
    family a view of that copy.  :meth:`sample` takes one family the same
    way.  ``seconds`` adds up the time of the packing, the upload and the
    sampling (``"sample"``: the host's wall time less the copy's) and of the
    copy back (``"copy"``: its device time, by CUDA events); ``calls``
    counts the families, ``documents`` the calls of :meth:`sample_families`
    that had a point to sample."""

    def __init__(self, device: str = "auto"):
        if str(device).lower() == "auto" and not torch.cuda.is_available():
            raise RuntimeError("the torch sampling backend runs on a CUDA device (--sampling-device auto), and "
                               "torch.cuda.is_available() is false; pass --sampling-device cpu to run the plain "
                               "version on the host")
        self.device = device_for(device)
        self.seconds = {"sample": 0.0, "copy": 0.0}
        self.calls = 0
        self.documents = 0

    def sample(self, ctrl: np.ndarray, n: int) -> np.ndarray:
        """One family: (S, n, 2) float32 points."""
        return self.sample_families([(ctrl, n)])[0]

    def sample_families(self, families) -> list:
        """``[(ctrl (S, K, 2), n), ...]`` → ``[(S, n, 2) float32 ndarray,
        ...]``, in the order given."""
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        words, table, n_points = pack_families(families, pin=cuda)
        n_fam = int((table[:, 0] >= 0).sum())
        copy_s = 0.0
        if not n_points:
            pts = np.empty((0, 2), np.float32)
        elif cuda:
            with torch.cuda.device(self.device):
                out = bezier_families_cuda(words.to(self.device, non_blocking=True), n_fam, n_points)
                host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                host.copy_(out, non_blocking=True)
                end.record()
                end.synchronize()
                copy_s = start.elapsed_time(end) / 1e3
            pts = host.numpy()
        else:
            pts = sample_families_plain(words, n_fam, n_points).numpy()
        views = [pts[o: o + len(c) * n].reshape(len(c), n, 2) if o >= 0 else np.empty((0, n, 2), np.float32)
                 for (c, n), (_, o, _, _) in zip(families, table.tolist())]
        self.seconds["sample"] += time.perf_counter() - t0 - copy_s
        self.seconds["copy"] += copy_s
        self.calls += len(families)
        self.documents += n_points > 0
        return views
