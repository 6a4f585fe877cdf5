"""Row sharding: one large image split into row slabs over a ``space`` mesh
(twin of ``plotweave/parallel/spatial.py``).

Single controller, as in the JAX package's one ``shard_map`` program: one
process holds one slab per shard, each on its mesh device.  The stencil
stages widen each slab by 1 to 3 halo rows copied from its neighbours
(:func:`with_halo`, the twin of ``ppermute``), and the fixpoints reduce a
changed flag over the shards on the host.  Edge shards build the image's
border instead of a halo, so every program here gives the bytes of its
unsharded counterpart.

The per-shard programs are plain PyTorch and run on CPU meshes (the pool of
``mesh.cpu_device_count()`` entries).  Over several CUDA devices they raise:
on the card they need slab modes of kernels K2, K3+K4, K5 and K6 (ROADMAP.md,
Queue 1, Item 10b), and no plain op runs on the card.  One shard is the
unsharded program (the JAX package's contract for its 1-device mesh), run
by the kernels on a card.

Two fixpoints are scheduled differently from the JAX package, with the same
bytes:

- Hysteresis is monotone: between two exchanges each slab runs its own
  fixpoint on bitboards (``ops.canny.hysteresis_plain``) with its halo rows
  held as seeds, so the rounds are the shard crossings of the longest chain
  plus two, not one sweep a round.
- Zhang–Suen is not: every iteration exchanges a 2-row zero halo and runs
  both subpasses on bitboards; after the second, the slab's own rows are
  exact.  The changed flag and the iteration count are global.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops.bitpack import bitunpack_rows_plain, boards_to_rows_plain
from ..ops.canny import _sobel_pair, hysteresis_plain, nms_thresholds
from ..ops.filters import gaussian_kernel_q8, reflect101_index
from ..ops.frontend import assign_nearest, raster_frontend
from ..ops.morphology import _window_reduce, morph_program, structuring_element
from ..ops.thinning import _subpass_bits, dense_from_boards_plain, pack_bitboards_plain, unpack_bitboards_plain
from ..utils.devices import not_ported
from .mesh import Mesh, data_sharding, shard_bounds

AXIS = "space"
BORDERS = ("zero", "reflect", "edge")

# The halo helpers exchange or build at most 3 rows (blur k=7) and the
# reflect fill reads rows [1 : h+1], so each shard must hold a safe margin of
# rows.
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


# --- slabs and the halo exchange -------------------------------------------------------


def _space_devices(mesh: Mesh, what: str) -> List[torch.device]:
    """The devices along ``space``; several CUDA devices raise (Item 10b)."""
    devices = mesh.along(AXIS)
    if mesh.platform != "cpu" and len(devices) > 1:
        raise not_ported(f"{what} over {len(devices)} CUDA devices", "Queue 1, Item 10b")
    return devices


def split_rows(x, devices: Sequence[torch.device], axis: int = -2) -> List[torch.Tensor]:
    """``x`` (a tensor or an array) cut along ``axis`` into one slab of equal
    rows per device, each placed on its device (``P(..., "space", ...)``)."""
    h = x.shape[axis]
    n = len(devices)
    if h % n:
        raise ValueError(f"{h} rows do not split evenly over {n} shards")
    x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return [s.contiguous().to(d) for s, d in zip(torch.tensor_split(x, n, dim=axis), devices)]


def gather_rows(slabs: Sequence[torch.Tensor], axis: int = -2) -> torch.Tensor:
    """The slabs joined along ``axis`` on the host."""
    return torch.cat([s.cpu() for s in slabs], dim=axis)


def _on_host(slabs: Sequence[torch.Tensor], what: str) -> None:
    dev = next((s.device for s in slabs if s.device.type != "cpu"), None)
    if dev is not None:
        raise not_ported(f"{what} on {dev}", "Queue 1, Item 10b")


def with_halo(slabs: Sequence[torch.Tensor], h: int, border: str) -> List[torch.Tensor]:
    """Halo exchange on axis -2 of each (..., rows, W) slab: ``h`` rows from
    each neighbour, copied onto the slab's device; the edge shards build the
    image's border instead (``zero``, ``reflect``: reflect-101, which reads
    rows [1 : h+1], or ``edge``: the edge row repeated).  One slab is both the
    top and the bottom shard.  ``h`` = 0 adds nothing."""
    if border not in BORDERS:
        raise ValueError(f"border must be one of {BORDERS}, got {border!r}")
    _on_host(slabs, "the halo exchange")
    if h == 0:
        return list(slabs)
    n = len(slabs)
    out = []
    for i, x in enumerate(slabs):
        rows = x.shape[-2]
        if border == "reflect" and rows < h + 1 and i in (0, n - 1):
            raise ValueError(f"with_halo: a slab of {rows} rows cannot reflect {h} rows")
        for j in (i - 1, i + 1):
            if 0 <= j < n and slabs[j].shape[-2] < h:
                raise ValueError(f"with_halo: a slab of {slabs[j].shape[-2]} rows cannot give {h} halo rows")
        fill_shape = (*x.shape[:-2], h, x.shape[-1])
        if i > 0:
            top = slabs[i - 1][..., -h:, :].to(x.device)
        elif border == "zero":
            top = x.new_zeros(fill_shape)
        elif border == "reflect":
            top = x[..., 1 : h + 1, :].flip(-2)
        else:
            top = x[..., :1, :].expand(fill_shape)
        if i < n - 1:
            bot = slabs[i + 1][..., :h, :].to(x.device)
        elif border == "zero":
            bot = x.new_zeros(fill_shape)
        elif border == "reflect":
            bot = x[..., -h - 1 : -1, :].flip(-2)
        else:
            bot = x[..., -1:, :].expand(fill_shape)
        out.append(torch.cat([top, x, bot], dim=-2))
    return out


def _changed(new: Sequence[torch.Tensor], old: Sequence[torch.Tensor]) -> bool:
    """The changed flag, reduced over every shard."""
    return not all(torch.equal(a, b) for a, b in zip(new, old))


# --- the per-shard programs -------------------------------------------------------------


def morph_halo(slabs: Sequence[torch.Tensor], se: np.ndarray, is_max: bool) -> List[torch.Tensor]:
    """Gray erosion (min) or dilation (``is_max``) of uint8 (..., rows, W)
    slabs by the element ``se`` after an r-row replicate halo, the columns
    padded with the neutral value (twin of ``_morph_halo_b``)."""
    if any(s.dtype != torch.uint8 for s in slabs):
        raise TypeError("morph_halo: expected uint8 slabs")
    r = se.shape[0] // 2
    # the window reduce pads rows with the neutral value too; the rows it
    # keeps read only the halo-widened slab
    return [_window_reduce(xp, se, is_max)[..., r : xp.shape[-2] - r, :] for xp in with_halo(slabs, r, "edge")]


def morph_prog_halo(slabs: Sequence[torch.Tensor], shape: str, ksize: int, iterations: int,
                    program: str) -> List[torch.Tensor]:
    """A morphology program ('e' erode, 'd' dilate, each repeated
    ``iterations`` times) over slabs (twin of ``_morph_prog_halo``)."""
    se = structuring_element(shape, ksize)
    slabs = list(slabs)
    for _, _, op in morph_program(shape, ksize, iterations, program):
        slabs = morph_halo(slabs, se, op == "d")
    return slabs


def blur_halo(slabs: Sequence[torch.Tensor], ksize: int) -> List[torch.Tensor]:
    """The Q8 Gaussian of uint8 slabs: the horizontal pass in int32 with
    reflect-101 columns, a reflect-101 halo of its row sums, the vertical
    pass, ``(acc + 2^15) >> 16``, clip (twin of ``_blur_halo_b``)."""
    _on_host(slabs, "the blur")
    kq = [int(v) for v in gaussian_kernel_q8(ksize)]
    r = ksize // 2
    sums = []
    for x in slabs:
        w = x.shape[-1]
        p = x.to(torch.int32).index_select(-1, reflect101_index(w, r, x.device))
        sums.append(sum(kq[i] * p[..., i : i + w] for i in range(ksize)))
    out = []
    for tp in with_halo(sums, r, "reflect"):
        rows = tp.shape[-2] - 2 * r
        acc = sum(kq[i] * tp[..., i : i + rows, :] for i in range(ksize))
        out.append(((acc + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8))
    return out


def _hysteresis_boards(cand: List[torch.Tensor], strong: List[torch.Tensor]) -> List[torch.Tensor]:
    """The global hysteresis fixpoint over slabs of int32 bitboards: each
    round, a 1-row zero halo of the edges, then each slab's own fixpoint
    with its halo rows as seeds that cannot grow; until no slab grows."""
    edges = strong
    while True:
        new = []
        for c, e in zip(cand, with_halo(edges, 1, "zero")):
            cand_h = torch.cat([e[..., :1, :], c, e[..., -1:, :]], dim=-2)
            new.append(hysteresis_plain(cand_h, e)[..., 1:-1, :])
        if not _changed(new, edges):
            return new
        edges = new


def _edge_boards(slabs: Sequence[torch.Tensor], low: int, high: int) -> List[torch.Tensor]:
    """Canny of uint8 slabs → the edges as int32 bitboards, one a slab."""
    n = len(slabs)
    cand, strong = [], []
    for i, x2 in enumerate(with_halo(slabs, 2, "edge")):
        gx, gy = _sobel_pair(x2)
        mag = gx.abs() + gy.abs()
        # the two rows outside the image read as magnitude 0
        if i == 0:
            mag[..., :2, :] = 0
        if i == n - 1:
            mag[..., -2:, :] = 0
        c, s = nms_thresholds(gx, gy, mag, low, high)
        cand.append(pack_bitboards_plain(c[..., 2:-2, :]))
        strong.append(pack_bitboards_plain(s[..., 2:-2, :]))
    return _hysteresis_boards(cand, strong)


def canny_halo(slabs: Sequence[torch.Tensor], low: int, high: int) -> List[torch.Tensor]:
    """Canny of uint8 (..., rows, W) slabs → uint8 0/255 edges: a 2-row
    replicate halo, int16 Sobel, magnitudes 0 on the two rows outside the
    image, Q15 sector NMS, the double threshold, then the hysteresis
    fixpoint (twin of ``_canny_halo_b``)."""
    return [dense_from_boards_plain(b, s.shape[-1], 255) for b, s in zip(_edge_boards(slabs, low, high), slabs)]


def _thin_boards(boards: Sequence[torch.Tensor], max_iter: int = 120) -> List[torch.Tensor]:
    """Zhang–Suen on the rotated ring over slabs of int32 bitboards: at most
    ``max_iter`` iterations, stopping after the first that changes no
    shard."""
    x = list(boards)
    for _ in range(max_iter):
        x2 = [_subpass_bits(_subpass_bits(xp, True, True), False, True)[..., 2:-2, :]
              for xp in with_halo(x, 2, "zero")]
        changed = _changed(x2, x)
        x = x2
        if not changed:
            break
    return x


def thin_halo(slabs: Sequence[torch.Tensor], max_iter: int = 120) -> List[torch.Tensor]:
    """Zhang–Suen thinning of 0/nonzero (..., rows, W) slabs → int32 0/1
    skeletons (twin of ``_thin_halo_b``)."""
    _on_host(slabs, "thinning")
    skels = _thin_boards([pack_bitboards_plain(s) for s in slabs], max_iter)
    return [unpack_bitboards_plain(b, s.shape[-1]) for b, s in zip(skels, slabs)]


# --- the sharded programs ---------------------------------------------------------------


def sharded_chain(mesh: Mesh, packed_clean, w: int, mk: int, oi: int, ci: int, bk: int, lo: int,
                  hi: int) -> torch.Tensor:
    """Row-sharded twin of stage 02's ``chain_from_clean``: the cleaned
    masks, packed (k, H, ⌈W/8⌉) uint8, with H split over the mesh's
    ``space`` axis → the unsharded flat uint8 blob [packed edges][packed
    skeletons].  Each shard unpacks its rows and runs the masks' open and
    close, the blur, Canny and thinning, and packs.  One shard is
    ``chain_from_clean`` on its device."""
    devices = _space_devices(mesh, "sharded_chain")
    if len(devices) == 1:
        from ..stages.s02_color_extract import chain_from_clean  # noqa: PLC0415 (stage 02 imports this module)

        return chain_from_clean(packed_clean, w, mk, oi, ci, bk, lo, hi, device=devices[0])
    m = [bitunpack_rows_plain(p, w) * 255 for p in split_rows(packed_clean, devices)]
    m = morph_prog_halo(morph_prog_halo(m, "ellipse", mk, oi, "ed"), "ellipse", mk, ci, "de")
    edges = _edge_boards(blur_halo(m, bk), lo, hi)
    skels = _thin_boards(edges)
    halves = [gather_rows([boards_to_rows_plain(b, w) for b in part]) for part in (edges, skels)]
    return torch.cat([half.reshape(-1) for half in halves])


def _frontend_slabs(slabs, centers, k: int, edge_kernel: int, blur_kernel: int, low: int, high: int):
    """Per shard (twin of ``make_local_frontend``): the pointwise Lab assign,
    rect-3 open and close, edge open and close, blur, Canny and thinning of
    (..., rows, W, 3) image slabs → (edges, skeletons) slabs (..., k, rows, W)."""
    masks = []
    for x in slabs:
        labels = assign_nearest(x, centers, k)
        layers = torch.arange(k, dtype=labels.dtype, device=labels.device)[:, None, None]
        masks.append((labels[..., None, :, :] == layers).to(torch.uint8) * 255)
    for shape, ksize in (("rect", 3), ("ellipse", edge_kernel)):
        masks = morph_prog_halo(morph_prog_halo(masks, shape, ksize, 1, "ed"), shape, ksize, 1, "de")
    edges = _edge_boards(blur_halo(masks, blur_kernel), low, high)
    w = masks[0].shape[-1]
    return ([dense_from_boards_plain(b, w, 255) for b in edges],
            [dense_from_boards_plain(b, w, 1) for b in _thin_boards(edges)])


def _frontend_group(devices, images, centers, params: dict):
    """One group's front-end, its images' rows over ``devices``: the slab
    programs on the host, or ``raster_frontend`` on a single device."""
    if len(devices) == 1:
        dev = devices[0]
        img = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.array(images))
        return raster_frontend(img.to(dev), centers.to(dev) if isinstance(centers, torch.Tensor) else centers,
                               **params)
    edges, skels = _frontend_slabs(split_rows(images, devices, axis=-3), centers, **params)
    return gather_rows(edges), gather_rows(skels)


def spatial_frontend(mesh: Mesh, image, centers, *, k: int = 4, edge_kernel: int = 3, blur_kernel: int = 7,
                     low: int = 22, high: int = 70):
    """Row-sharded front-end over one image: (H, W, 3) uint8 + (k, 3)
    centres → (k, H, W) edges, (k, H, W) skeletons, H split over the
    ``space`` axis (the slabs joined on the host)."""
    params = dict(k=k, edge_kernel=edge_kernel, blur_kernel=blur_kernel, low=low, high=high)
    return _frontend_group(_space_devices(mesh, "spatial_frontend"), image, centers, params)


def grid_frontend(mesh: Mesh, images, centers, *, k: int = 4, edge_kernel: int = 3, blur_kernel: int = 7,
                  low: int = 22, high: int = 70, data_axis: str = "data"):
    """2-D mesh: (B, H, W, 3) images + (k, 3) shared centres → (B, k, H, W)
    edges and skeletons, B split over ``data`` and H over ``space``.

    Each data group runs its own fixpoints and stops on its own changed
    flag.  The JAX package reduces the flag over the whole mesh; that only
    adds sweeps that change nothing, so the bytes are the same."""
    grid = mesh.grid(data_axis, AXIS)
    if mesh.platform != "cpu" and grid.shape[1] > 1:
        raise not_ported(f"grid_frontend over {grid.shape[1]} CUDA devices a group", "Queue 1, Item 10b")
    if len(images) % grid.shape[0]:
        raise ValueError(f"grid_frontend: a batch of {len(images)} does not split over {grid.shape[0]} groups")
    params = dict(k=k, edge_kernel=edge_kernel, blur_kernel=blur_kernel, low=low, high=high)
    outs = [_frontend_group(list(grid[g]), images[a:b], centers, params)
            for g, (a, b) in enumerate(shard_bounds(len(images), grid.shape[0]))]
    sharding = data_sharding(mesh, data_axis)
    return sharding.gather([e for e, _ in outs]), sharding.gather([s for _, s in outs])
