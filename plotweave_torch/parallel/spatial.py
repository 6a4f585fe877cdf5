"""Row sharding: one large image split into row slabs over a ``space`` mesh
(twin of ``plotweave/parallel/spatial.py``).

Single controller, as in the JAX package's one ``shard_map`` program: one
process holds one slab per shard, each on its mesh device.  Every sharded
program runs one schedule on every device.  A stencil step widens each slab
by the rows it reads beyond its own, copied from its neighbours into a new
buffer (:func:`widen`: ``copy_`` only, across cards a peer copy, which
PyTorch orders against both cards' streams),
and runs its kernel's slab mode on the buffer, which writes only the own
rows; a side without halo rows is the image's border, where the step applies
its border rule.  On a card the steps are kernels (``ops/kernels.py``), on a
CPU slab their plain slab versions (``ops.canny.edge_candidates_slab_plain``,
``hysteresis_slab_plain``, ``ops.filters.gaussian_blur_slab_plain``,
``ops.thinning.zhang_suen_slab_plain``), so the CPU tests run the card's
schedule.  One shard is the unsharded program (the JAX package's contract
for its 1-device mesh), run by the kernels on a card.

- The morphology has no slab mode: K2 (bitboards) and K11 (gray) read a row
  outside their layer as the neutral value, which gives the bytes of the JAX
  program's replicate halo wherever the structuring element's rows narrow
  away from its centre (rect, ellipse, cross).  So a step list runs on a slab
  widened by its steps' summed row radius, one exchange for all of them, its
  own rows exact; a list whose radius passes a shard's rows is cut into
  segments (:func:`_segments`).  Stage 03's blur and Canny (K3+K4, halo
  ``ksize // 2 + 2``) ride in the same exchange where the rows allow.
- Hysteresis is monotone: a round widens the edges by one row, each slab runs
  its own fixpoint with its halo rows as seeds that cannot grow (K5), and the
  rounds end when no slab's own rows grew: the shard crossings of the longest
  chain plus two, where the JAX loop takes one sweep a round.
- Zhang–Suen is not: a round of m iterations runs on slabs widened by 2 m
  rows (exact own rows, as a subpass reads one row), the last round cut so
  that the total never passes ``max_iter``, and the rounds end after the
  first whose last iteration changed no slab's own rows: the JAX loop's
  global flag, since iterations past the global fixpoint change nothing
  (``ops.kernels.thinning_round`` picks m).  K6 stores each round's own rows
  into the unsharded outputs at the slab's first row.

Each round's changed flags are one int32 a shard, in one tensor a device,
read by the host with one copy a device (:class:`RoundFlags`, the single
controller's ``psum``).  The rounds the last program's fixpoints took are in
``ops.kernels.STATS`` (``hysteresis_rounds``, ``thinning_rounds``).
"""

from __future__ import annotations

from collections import Counter
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.canny import edge_candidates_slab, hysteresis_slab
from ..ops.filters import gaussian_blur_slab
from ..ops.frontend import assign_boards, frontend_steps, raster_frontend
from ..ops.kernels import STATS, thinning_round
from ..ops.morphology import _valid_bits, morph_dense, morph_program, morph_steps
from ..ops.thinning import dense_from_boards, pack_bitboards, unpack_bitboards, zhang_suen_slab
from .mesh import Mesh, data_sharding, shard_bounds

AXIS = "space"

# The JAX package's floor of rows a shard (its halo helpers exchange or build
# at most 3 rows and its reflect fill reads rows [1 : h+1]); here also the
# rows of the front-end's eight 3 x 3 morphology steps in one exchange.
MIN_ROWS_PER_SHARD = 8


def fit_shard_rows(h: int, requested: int, n_devices: int, max_radius: int = 0) -> int:
    """Largest shard count ≤ min(requested, n_devices) that divides ``h``
    evenly and leaves at least max(MIN_ROWS_PER_SHARD, ``max_radius`` + 1)
    rows per shard, ``max_radius`` being the largest stencil radius the
    sharded program runs (a copy of the JAX package's)."""
    min_rows = max(MIN_ROWS_PER_SHARD, int(max_radius) + 1)
    cap = max(1, min(int(requested), int(n_devices), int(h) // min_rows or 1))
    for n in range(cap, 0, -1):
        if h % n == 0:
            return n
    return 1


# --- slabs, copies and the halo exchange ----------------------------------------------


def split_rows(x, devices: Sequence[torch.device], axis: int = -2) -> List[torch.Tensor]:
    """``x`` (a tensor or an array) cut along ``axis`` into one slab of equal
    rows per device, each placed on its device (``P(..., "space", ...)``)."""
    h = x.shape[axis]
    n = len(devices)
    if h % n:
        raise ValueError(f"{h} rows do not split evenly over {n} shards")
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return [part.new_empty(part.shape, device=d).copy_(part)
            for part, d in zip(torch.tensor_split(x, n, dim=axis), devices)]


def widen(slabs: Sequence[torch.Tensor], halo: int) -> List[Tuple[torch.Tensor, int, int]]:
    """The halo exchange of the card's schedule: each (..., rows, W) slab
    copied into a new buffer between ``halo`` rows of each neighbour, on the
    slab's device → (buffer, top, bottom), the halo rows above and below its
    own.  An edge shard has none on its outer side: there the slab mode
    applies the image's border rule."""
    n = len(slabs)
    out = []
    for i, x in enumerate(slabs):
        top, bottom = (halo if i > 0 else 0), (halo if i < n - 1 else 0)
        for j, side in ((i - 1, top), (i + 1, bottom)):
            if side and slabs[j].shape[-2] < side:
                raise ValueError(f"widen: a slab of {slabs[j].shape[-2]} rows cannot give {side} halo rows")
        rows = x.shape[-2]
        buf = x.new_empty((*x.shape[:-2], top + rows + bottom, x.shape[-1]))
        buf[..., top : top + rows, :].copy_(x)
        if top:
            buf[..., :top, :].copy_(slabs[i - 1][..., -top:, :])
        if bottom:
            buf[..., top + rows :, :].copy_(slabs[i + 1][..., :bottom, :])
        out.append((buf, top, bottom))
    return out


class RoundFlags:
    """A round's changed flags: one int32 slot a slab, in one tensor a
    device, which each slab-mode call writes; :meth:`any` reads them with one
    copy a device."""

    def __init__(self, slabs: Sequence[torch.Tensor]):
        counts = Counter(s.device for s in slabs)
        first = {s.device: s for s in reversed(slabs)}
        self.tensors = {d: first[d].new_empty(n, dtype=torch.int32) for d, n in counts.items()}
        taken = dict.fromkeys(counts, 0)
        self.slots = []
        for s in slabs:
            self.slots.append(self.tensors[s.device][taken[s.device] : taken[s.device] + 1])
            taken[s.device] += 1

    def any(self) -> bool:
        return any(bool(t.cpu().any()) for t in self.tensors.values())


def _segments(radii: Sequence[int], cap: int) -> List[Tuple[int, int, int]]:
    """Consecutive stencil steps of row ``radii`` grouped while their summed
    radius fits ``cap`` (a neighbour's rows) → (first, end, summed radius),
    one exchange each.  Raises for a step wider than ``cap``."""
    segments, start = [], 0
    while start < len(radii):
        stop, total = start, 0
        while stop < len(radii) and total + radii[stop] <= cap:
            total, stop = total + radii[stop], stop + 1
        if stop == start:
            raise ValueError(f"a stencil of row radius {radii[start]} needs more than the {cap} rows a shard holds")
        segments.append((start, stop, total))
        start = stop
    return segments


# --- the per-shard programs -------------------------------------------------------------


def morph_prog_halo(slabs: Sequence[torch.Tensor], shape: str, ksize: int, iterations: int,
                    program: str) -> List[torch.Tensor]:
    """A gray morphology program ('e' erode, 'd' dilate, each repeated
    ``iterations`` times) over uint8 (..., rows, W) slabs (twin of
    ``_morph_prog_halo``): each segment of steps on slabs widened by its
    summed radius, by K11 on a card, its plain version on the CPU."""
    if any(s.dtype != torch.uint8 for s in slabs):
        raise TypeError("morph_prog_halo: expected uint8 slabs")
    steps = morph_program(shape, ksize, iterations, program)
    slabs = list(slabs)
    for start, stop, halo in _segments([ksize // 2] * len(steps), slabs[0].shape[-2]):
        slabs = [morph_dense(buf, steps[start:stop])[..., top : buf.shape[-2] - bottom, :]
                 for buf, top, bottom in widen(slabs, halo)]
    return slabs


def blur_halo(slabs: Sequence[torch.Tensor], ksize: int) -> List[torch.Tensor]:
    """The Q8 Gaussian of uint8 (..., rows, W) slabs (twin of
    ``_blur_halo_b``): slabs widened by ``ksize // 2`` rows, K3+K4's
    blur-only slab mode."""
    return [gaussian_blur_slab(buf, ksize, top, bottom) for buf, top, bottom in widen(slabs, ksize // 2)]


def _candidates(slabs: Sequence[torch.Tensor], w: int, steps: tuple, ksize: int, low: int, high: int,
                packed_rows: bool = False):
    """Stage 03 over slabs: the packed morphology's step list (K2, on
    bitboards, or on packed rows that its load converts), the blur and
    Canny's NMS and thresholds (K3+K4) → the own rows' (candidate, strong)
    bitboards.  Each segment of steps is one exchange; the edge step joins
    the last where the rows allow (halo ``ksize // 2 + 2``), else it is one
    of its own, or where even that passes a shard's rows, a blur (``ksize //
    2``) and then Canny on the blurred slabs (2)."""
    n, r = len(steps), ksize // 2
    cap = slabs[0].shape[-2]
    tail = [r + 2] if r + 2 <= cap else [r, 2]
    radii = [ks // 2 for _, ks, _ in steps] + tail
    x = list(slabs)
    for start, stop, halo in _segments(radii, cap):
        last, out = stop - 1, []
        for buf, top, bottom in widen(x, halo):
            if start < n or packed_rows:  # K2: one launch a segment (none of its steps: a load that converts)
                buf = morph_steps(buf, _valid_bits(w, buf.device), steps[start : min(stop, n)], w)
            if last < n:
                out.append(buf[..., top : buf.shape[-2] - bottom, :])
            elif len(tail) == 1:
                out.append(edge_candidates_slab(buf, w, ksize, low, high, top, bottom))
            elif last == n:
                out.append(gaussian_blur_slab(buf, ksize, top, bottom, w))
            else:
                out.append(edge_candidates_slab(buf, w, 1, low, high, top, bottom))
        x, packed_rows = out, False
    return [c for c, _ in x], [s for _, s in x]


def _hysteresis_rounds(cand: Sequence[torch.Tensor], strong: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The global hysteresis fixpoint over slabs of int32 bitboards: each
    round the edges widened by one row, each slab's own fixpoint with its
    halo rows as seeds (K5's slab mode), one read of the flags; until no
    slab's own rows grew."""
    flags = RoundFlags(cand)
    edges, rounds = list(strong), 0
    while True:
        edges = [hysteresis_slab(c, buf, top, bottom, flag)
                 for c, (buf, top, bottom), flag in zip(cand, widen(edges, 1), flags.slots)]
        rounds += 1
        if not flags.any():
            STATS["hysteresis_rounds"] = rounds
            return edges


def _thin_rounds(boards: Sequence[torch.Tensor], max_iter: int = 120, store: tuple | None = None,
                 rotated: bool = True) -> List[torch.Tensor]:
    """Zhang–Suen over slabs of int32 bitboards (K6's slab mode): rounds of m
    iterations on slabs widened by 2 m rows, the last cut at ``max_iter``,
    until a round's last iteration changes no slab's own rows.  ``store`` =
    (w, edges, skels, layout): the unsharded outputs (B, group, H, row
    bytes), into which each slab's edges (its first round's input) and
    skeletons (each round's result) go at its first row; a slab on another
    device than the outputs stores into its own and is copied over at the
    end.  Returns the own rows' skeleton boards."""
    rows, nw = boards[0].shape[-2], boards[0].shape[-1]
    m = thinning_round(rows, nw, max_iter)
    targets = []
    if store is not None:
        w, edges, skels, layout = store
        for i, b in enumerate(boards):
            if b.device == skels.device:
                targets.append((edges, skels, i * rows))
            else:
                local = b.new_empty((2, *skels.shape[:2], rows, skels.shape[-1]), dtype=torch.uint8)
                targets.append((local[0], local[1], 0))
    flags = RoundFlags(boards)
    x, done, rounds = list(boards), 0, 0
    while True:
        n = min(m, max_iter - done)
        nxt = []
        for i, ((buf, top, bottom), flag) in enumerate(zip(widen(x, 2 * m), flags.slots)):
            if store is None:
                nxt.append(zhang_suen_slab(buf, top, bottom, n, flag, rotated=rotated))
            else:
                e, s, row0 = targets[i]
                nxt.append(zhang_suen_slab(buf, top, bottom, n, flag, w, e if rounds == 0 else None, s, layout, row0,
                                           rotated))
        x, done, rounds = nxt, done + n, rounds + 1
        if done >= max_iter or not flags.any():
            break
    STATS["thinning_rounds"] = rounds
    if store is not None:
        for i, (e, s, row0) in enumerate(targets):
            if e is not edges:  # a slab on another device: its rows copied into the outputs
                for dst, src in ((edges, e), (skels, s)):
                    dst[:, :, i * rows : (i + 1) * rows, :].copy_(src)
    return x


def canny_halo(slabs: Sequence[torch.Tensor], low: int, high: int) -> List[torch.Tensor]:
    """Canny of uint8 (..., rows, W) slabs → uint8 0/255 edges (twin of
    ``_canny_halo_b``): slabs widened by 2 rows, K3+K4's slab mode with no
    blur, then the hysteresis rounds."""
    w = slabs[0].shape[-1]
    edges = _hysteresis_rounds(*_candidates(slabs, w, (), 1, low, high))
    return [dense_from_boards(b, w, 255) for b in edges]


def thin_halo(slabs: Sequence[torch.Tensor], max_iter: int = 120) -> List[torch.Tensor]:
    """Zhang–Suen thinning of 0/nonzero (..., rows, W) slabs → int32 0/1
    skeletons (twin of ``_thin_halo_b``)."""
    w = slabs[0].shape[-1]
    return [unpack_bitboards(b, w) for b in _thin_rounds([pack_bitboards(s) for s in slabs], max_iter)]


# --- the sharded programs ---------------------------------------------------------------


def sharded_chain(mesh: Mesh, packed_clean, w: int, mk: int, oi: int, ci: int, bk: int, lo: int,
                  hi: int) -> torch.Tensor:
    """Row-sharded twin of stage 02's ``chain_from_clean``: the cleaned
    masks, packed (k, H, ⌈W/8⌉) uint8, with H split over the mesh's
    ``space`` axis → the unsharded flat uint8 blob [packed edges][packed
    skeletons] on the first shard's device.  Each shard's rows: the masks'
    open and close from packed rows (K2), the blur and Canny's candidates
    (K3+K4), the hysteresis rounds (K5), the thinning rounds (K6, storing
    both halves of the blob).  One shard is ``chain_from_clean`` on its
    device."""
    devices = mesh.along(AXIS)
    if len(devices) == 1:
        from ..stages.s02_color_extract import chain_from_clean  # noqa: PLC0415 (stage 02 imports this module)

        return chain_from_clean(packed_clean, w, mk, oi, ci, bk, lo, hi, device=devices[0])
    k, h, rb = packed_clean.shape
    steps = morph_program("ellipse", mk, oi, "ed") + morph_program("ellipse", mk, ci, "de")
    edges = _hysteresis_rounds(*_candidates(split_rows(packed_clean, devices), w, steps, bk, lo, hi,
                                            packed_rows=True))
    blob = edges[0].new_empty((2, 1, k, h, rb), dtype=torch.uint8)  # on the first shard's device
    _thin_rounds(edges, 120, (w, blob[0], blob[1], "rows"))
    return blob.reshape(-1)


def _frontend_slabs(slabs, centers, k: int, edge_kernel: int, blur_kernel: int, low: int, high: int):
    """Per shard (twin of ``make_local_frontend``): the pointwise Lab assign
    as one-hot bitboards (K7), rect-3 open and close, edge open and close
    (K2), blur and Canny (K3+K4, K5) and thinning (K6) of (..., rows, W, 3)
    image slabs → the (edges, skeletons) (..., k, H, W) uint8 on the first
    slab's device."""
    w = slabs[0].shape[-2]
    boards = [assign_boards(x, centers.to(x.device) if isinstance(centers, torch.Tensor) else centers, k)
              for x in slabs]
    edges = _hysteresis_rounds(*_candidates(boards, w, frontend_steps(1, edge_kernel, 1), blur_kernel, low, high))
    shape = (*slabs[0].shape[:-3], k, sum(s.shape[-3] for s in slabs), w)
    both = edges[0].new_empty((2, *shape), dtype=torch.uint8)
    _thin_rounds(edges, 120, (w, both[0].view(-1, *shape[-3:]), both[1].view(-1, *shape[-3:]), "dense"))
    return both[0], both[1]


def _frontend_group(devices, images, centers, params: dict):
    """One group's front-end, its images' rows over ``devices``: the slab
    programs, or ``raster_frontend`` on a single device."""
    if len(devices) == 1:
        dev = devices[0]
        img = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.array(images))
        return raster_frontend(img.to(dev), centers.to(dev) if isinstance(centers, torch.Tensor) else centers,
                               **params)
    return _frontend_slabs(split_rows(images, devices, axis=-3), centers, **params)


def spatial_frontend(mesh: Mesh, image, centers, *, k: int = 4, edge_kernel: int = 3, blur_kernel: int = 7,
                     low: int = 22, high: int = 70):
    """Row-sharded front-end over one image: (H, W, 3) uint8 + (k, 3)
    centres → (k, H, W) edges, (k, H, W) skeletons on the first shard's
    device, H split over the ``space`` axis."""
    params = dict(k=k, edge_kernel=edge_kernel, blur_kernel=blur_kernel, low=low, high=high)
    return _frontend_group(mesh.along(AXIS), image, centers, params)


def grid_frontend(mesh: Mesh, images, centers, *, k: int = 4, edge_kernel: int = 3, blur_kernel: int = 7,
                  low: int = 22, high: int = 70, data_axis: str = "data"):
    """2-D mesh: (B, H, W, 3) images + (k, 3) shared centres → (B, k, H, W)
    edges and skeletons, B split over ``data`` and H over ``space``.

    Each data group runs its own fixpoints and stops on its own changed
    flag.  The JAX package reduces the flag over the whole mesh; that only
    adds sweeps that change nothing, so the bytes are the same."""
    grid = mesh.grid(data_axis, AXIS)
    if len(images) % grid.shape[0]:
        raise ValueError(f"grid_frontend: a batch of {len(images)} does not split over {grid.shape[0]} groups")
    params = dict(k=k, edge_kernel=edge_kernel, blur_kernel=blur_kernel, low=low, high=high)
    outs = [_frontend_group(list(grid[g]), images[a:b], centers, params)
            for g, (a, b) in enumerate(shard_bounds(len(images), grid.shape[0]))]
    sharding = data_sharding(mesh, data_axis)
    return sharding.gather([e for e, _ in outs]), sharding.gather([s for _, s in outs])
