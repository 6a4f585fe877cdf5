"""[02] Color-layer extraction → <layer>/mask.png + palette_by_name.json
(twin of ``plotweave/stages/s02_color_extract.py``).

Default mode clusters pixels in Lab with k-means and maps clusters to layer
names by darkness; swatch mode thresholds around configured swatches.

``kmeans_init: "host-exact"`` (the default) is the host-exact path of the JAX
package, unchanged: cv2's fixed-point Lab, the ``rng(seed).choice``
subsample, the bit-exact ``cv2.kmeans`` replica (``ops/cvkmeans.py``), the
native assignment and the cv2 mask refine.  When the runner chains stages 03
and 04, the cleaned masks, packed 8 px per byte, go through
:func:`chain_from_clean` on the raster device, on a side thread so the mask
PNG writes overlap it (in a batch run through the active
``parallel.batchrun.DeviceBatcher``, one chain call per group of images);
stages 03 and 04 take its blob from the derived-artifact registry.

``kmeans_init: "device"`` runs the whole stage on the raster device
(:func:`device_init_stage`): the float Lab of a subsample, k-means++ seeds
and the Lloyd fits (kernel K8), the all-pixel assignment with its counts
(K7), the masks' open and close with their packed rows (K2) and, when
fused, the chain, all into one blob and one download.  Its random numbers are the
port's own (``ops/kmeans.py``): the subsample drawn on the raster device by
hashed keys, and only the seeds' k + 1 numbers per attempt from host
generators; deterministic per seed, the same on the card and on the CPU, not
the JAX package's and not cv2-compatible.

``extraction_mode: "swatch"`` thresholds on the host and cleans each mask
with the gray morphology (kernel K11) on the raster device.

``shard_rows`` / ``shard_auto_mpx`` resolve the shard count as the JAX
package does (:func:`resolve_shard_n`), over ``torch.cuda.device_count()``
cards, or with ``raster_device: "cpu"`` over the CPU pool
(``parallel.mesh.cpu_device_count()``, read from ``XLA_FLAGS`` as the JAX
package's CPU backend reads it).  The fused chain then runs
``parallel.spatial.sharded_chain`` over a ``space`` mesh of that many
devices, each card once: one shard is the unsharded chain (on a card, its
kernels), several shards the row-sharded schedule, on cards through the slab
modes of its kernels, on CPU shards through their plain versions.
"""

from __future__ import annotations

import os
import threading
from typing import List

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.canny import canny_boards
from ..ops.cvkmeans import assign_labels, cv_kmeans
from ..ops.frontend import assign_boards_counts
from ..ops.kmeans import kmeans_fit_device, subsample_lab
from ..ops.morphology import _valid_bits, morph_dense, morph_program, morph_steps
from ..ops.thinning import zhang_suen_into
from ..parallel.mesh import cpu_device_count, default_devices, make_mesh
from ..parallel.spatial import fit_shard_rows, sharded_chain
from ..utils import (fetch_device_artifact, read_image, register_derived_artifact, register_device_artifact,
                     save_json, thread_map, write_image)
from ..utils.devices import raster_device
from .common import chain_key, darkness_rank, edge_params, layer_dir


def open_close_boards(masks: torch.Tensor, w: int, open_iters: int, close_iters: int, shape: str = "rect",
                      ksize: int = 3, rows_out: torch.Tensor | None = None) -> torch.Tensor:
    """Open, then close, binary masks held as bitboards or as packed rows
    (uint8, ⌈w/8⌉ bytes a row), as one step list of the packed morphology →
    the result's bitboards, its packed rows also into ``rows_out`` when given
    (K2: one launch on the card, whose load and store convert)."""
    steps = morph_program(shape, ksize, open_iters, "ed") + morph_program(shape, ksize, close_iters, "de")
    return morph_steps(masks, _valid_bits(w, masks.device), steps, w, rows_out)


def edges_from_boards(masks: torch.Tensor, w: int, mk: int, oi: int, ci: int, bk: int, lo: int,
                      hi: int) -> torch.Tensor:
    """Stage 03 over bitboards or packed rows: the masks' open and close, the
    blur and Canny → the edges as bitboards (K2, K3+K4 and K5 on the card)."""
    return canny_boards(open_close_boards(masks, w, oi, ci, "ellipse", mk), w, bk, lo, hi)


def chain_tail(masks: torch.Tensor, w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """Stage 03's morphology, blur and Canny and stage 04's thinning over the
    cleaned masks as (..., k, H, ⌈W/32⌉) bitboards or (..., k, H, ⌈W/8⌉)
    packed rows → packed (..., 2, k, H, ⌈W/8⌉) edges, then skeletons, in one
    tensor (written into ``out``, a contiguous uint8 tensor of that many
    bytes on that device, when given).  Leading dims are images: the kernels
    take them as more layers, and each image's two halves are written in
    place, so image b's part, flattened, is the solo call's blob.  On the
    card: K2, K3+K4, K5 and K6, whose stores write both halves (a layer too
    large for K6's resident route takes its banded route, which stores them
    too; K1 follows only the named ``route="multi"``)."""
    # the hysteresis board feeds the thinner in the same encoding
    edges_b = edges_from_boards(masks, w, mk, oi, ci, bk, lo, hi)
    *lead, k, h, _ = masks.shape
    shape = (*lead, 2, k, h, -(-w // 8))
    blob = torch.empty(shape, dtype=torch.uint8, device=masks.device) if out is None else out.view(shape)
    halves = blob.view(-1, 2, k, h, shape[-1])
    zhang_suen_into(edges_b, w, halves[:, 0], halves[:, 1], "rows", max_iter=120, rotated=True)
    return blob


def chain_from_clean(packed_clean, w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int,
                     device) -> torch.Tensor:
    """The fused 03→04 chain over stage 02's cleaned masks, packed
    (k, H, ⌈W/8⌉) uint8, on ``device`` → one flat uint8 blob
    [packed edges (k·H·⌈W/8⌉)][packed skeletons], in cluster order.  On the
    card every step between the upload and the blob is a kernel, four
    launches: K2 (loading the packed rows), K3+K4, K5, K6 (storing the
    blob)."""
    packed = torch.as_tensor(packed_clean, dtype=torch.uint8, device=device)
    return chain_tail(packed, w, mk, oi, ci, bk, lo, hi).reshape(-1)


def chain_blob_batch(packed_clean, w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int,
                     device) -> torch.Tensor:
    """Batched twin of :func:`chain_from_clean`: (B, k, H, ⌈W/8⌉) packed
    cleaned masks → (B, L) blobs [packed edges][packed skeletons] on
    ``device``.  Every op takes the images as more layers and is integer, so
    row b is byte-equal to the solo call's blob of image b (the batch runner
    relies on this: ``parallel/batchrun.py``).  One upload; the caller makes
    the one download."""
    packed = torch.as_tensor(packed_clean, dtype=torch.uint8, device=device)
    return chain_tail(packed, w, mk, oi, ci, bk, lo, hi).reshape(packed.shape[0], -1)


def assign_tail(img: torch.Tensor, centers: torch.Tensor, k: int, open_iters: int, close_iters: int,
                counts: torch.Tensor | None = None, out: torch.Tensor | None = None):
    """All-pixel nearest-centre assignment of one (H, W, 3) uint8 BGR image →
    (counts (k,) int32, the cleaned masks packed (k, H, ⌈W/8⌉) uint8, the
    cleaned masks as bitboards); twin of the JAX stage's ``_assign_tail``.  On
    the card K7 with counts and K2 (3×3 rect open, then close, its store
    writing the packed rows too); ``counts`` and ``out`` receive the counts
    and the packed rows when given (views into the stage's blob).  K7 takes
    ``Σ (lab − c)²``, not the fit's expanded form, so a label may differ from
    the JAX stage's at a near tie only."""
    h, w = img.shape[:2]
    boards, counts = assign_boards_counts(img, centers, k, counts)
    rows = torch.empty((k, h, -(-w // 8)), dtype=torch.uint8, device=img.device) if out is None else out
    masks_b = open_close_boards(boards, w, open_iters, close_iters, "rect", 3, rows_out=rows)
    return counts, rows, masks_b


def device_init_stage(img: torch.Tensor, k: int, iters: int, attempts: int, limit: int, seed: int, fuse: bool,
                      mk: int = 0, oi: int = 0, ci: int = 0, bk: int = 3, lo: int = 0, hi: int = 0,
                      open_iters: int = 1, close_iters: int = 1):
    """``kmeans_init: "device"``: the whole stage (and, when fused, stages
    03/04's raster work) on the device of ``img`` (one (H, W, 3) uint8 BGR
    tensor) → (one flat uint8 blob on that device: the winning centres (k, 3)
    float32, the counts (k,) int32, the cleaned masks packed (k, H, ⌈W/8⌉)
    and, when fused, the chain's [packed edges][packed skeletons]; the cleaned
    masks as bitboards).  On the card: K8 (the subsample's draw, sampler,
    seeds, fits), K7 with counts, K2 and the chain's kernels, every one
    writing its part of the blob in place; nothing is read back here.  The
    subsample is drawn on the image's device; only the seeds' k + 1 numbers
    per attempt come from host generators, a few bytes (``ops/kmeans.py``).
    So the result is deterministic per seed on either device; float sums
    differ between the card and the CPU only in their last digits."""
    h, w = img.shape[:2]
    w8 = -(-w // 8)
    n_masks = k * h * w8
    blob = torch.empty(16 * k + (3 if fuse else 1) * n_masks, dtype=torch.uint8, device=img.device)
    centers = blob[: 12 * k].view(torch.float32).view(k, 3)
    sample = subsample_lab(img, seed, limit)
    kmeans_fit_device(sample, k, attempts, iters, seed, out=centers)
    _, _, masks_b = assign_tail(img, centers, k, open_iters, close_iters,
                                counts=blob[12 * k : 16 * k].view(torch.int32),
                                out=blob[16 * k : 16 * k + n_masks].view(k, h, w8))
    if fuse:
        chain_tail(masks_b, w, mk, oi, ci, bk, lo, hi, out=blob[16 * k + n_masks :])
    return blob, masks_b


def _host_clean_masks(labels: np.ndarray, k: int, open_iters: int, close_iters: int):
    """The reference's per-cluster mask refine, verbatim cv2 ops (02:150-154):
    one-hot 0/255 uint8 → 3×3-rect open then close."""
    import cv2  # noqa: PLC0415

    kernel = cv2.getStructuringElement(cv2.MORPH_RECT, (3, 3))
    out = []
    for kk in range(k):
        m = (labels == kk).astype(np.uint8) * 255
        if open_iters > 0:
            m = cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel, iterations=open_iters)
        if close_iters > 0:
            m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel, iterations=close_iters)
        out.append(m)
    return out


class _BgFetch:
    """Runs ``fn`` on a daemon thread now.  Calling the object joins and
    returns its value or re-raises its error; :meth:`wait` only joins, so a
    caller that failed first never leaves the thread running behind it."""

    def __init__(self, fn):
        self._box: dict = {}
        self._thread = threading.Thread(target=self._work, args=(fn,), name="pw-chain-fetch",
                                        daemon=True)
        self._thread.start()

    def _work(self, fn) -> None:
        try:
            self._box["v"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised at join
            self._box["e"] = e

    def wait(self) -> None:
        self._thread.join()

    def __call__(self):
        self._thread.join()
        if "e" in self._box:
            raise self._box["e"]
        return self._box["v"]


def _on_cpu(cfg: PipelineConfig) -> bool:
    return str(getattr(cfg, "raster_device", "auto")).lower() == "cpu"


def resolve_shard_n(cfg: PipelineConfig, h: int, w: int) -> int:
    """Row-shard count for the fused raster chain: 0 = unsharded (twin of
    the JAX package's ``_resolve_shard_n``).

    ``shard_rows`` N>0 fits N to the largest row-divisor ≤ min(N, device
    count); ``shard_auto_mpx`` engages over all devices when the image
    exceeds that many megapixels.  The devices are the CUDA cards, or the
    CPU pool with ``raster_device: "cpu"``."""
    req = int(getattr(cfg, "shard_rows", 0) or 0)
    auto = float(getattr(cfg, "shard_auto_mpx", 0) or 0)
    if req <= 0 and auto <= 0:
        return 0
    # the largest stencil radius of the chain: outsized configured kernels
    # shrink the shard count
    mk, _oi, _ci, bk, _lo, _hi = edge_params(cfg)
    max_radius = max(2, mk // 2, bk // 2)
    ndev = cpu_device_count() if _on_cpu(cfg) else torch.cuda.device_count()
    if req > 0:
        n = fit_shard_rows(h, req, ndev, max_radius)
        if n < min(req, ndev) and max_radius * 2 + 1 > 17:
            print(
                f"[shard] note: stencil radius {max_radius} (configured edge "
                f"kernels) caps shards at {n} for H={h} (needs ≥{max_radius + 1} "
                "rows/shard)"
            )
        return n
    if h * w / 1e6 > auto:
        n = fit_shard_rows(h, ndev, ndev, max_radius)
        if n > 1:
            return n
    return 0


def swatch_mode(cfg: PipelineConfig, img: np.ndarray) -> None:
    """Threshold ±tolerance around each swatch, trying both channel orders and
    keeping the better-covered mask (02:82-109); the masks, stacked, are
    opened and closed (3×3 rect) by the gray morphology on the raster device
    in one call (K11: one launch of four steps), one upload and one download."""
    device = raster_device(cfg)
    tol = int(cfg.color_tolerance)
    names: List[str] = list(cfg.color_names)
    colors = list(cfg.colors)
    if not colors or len(colors) < len(names):
        raise RuntimeError("swatch mode: 'colors' must have ≥ len(color_names) entries.")
    masks = []
    for i in range(len(names)):
        raw = tuple(int(v) for v in colors[i])
        for candidate in ((raw[2], raw[1], raw[0]), raw):  # RGB→BGR first, then as-is
            lo = np.maximum(np.array(candidate) - tol, 0).astype(np.uint8)
            hi = np.minimum(np.array(candidate) + tol, 255).astype(np.uint8)
            m = (np.all(img >= lo, axis=2) & np.all(img <= hi, axis=2)).astype(np.uint8) * 255
            if candidate == (raw[2], raw[1], raw[0]):
                best = m
            elif int(np.count_nonzero(m)) > int(np.count_nonzero(best)):
                best = m
        masks.append(best)
    if masks:
        steps = morph_program("rect", 3, 1, "ed") + morph_program("rect", 3, 1, "de")  # open, then close
        masks = morph_dense(torch.from_numpy(np.stack(masks)).to(device), steps).cpu().numpy()
    for name, mask in zip(names, masks):
        write_image(os.path.join(layer_dir(cfg, name), "mask.png"), mask)
        print(f"Extracted (swatch): {name} | nz={int(np.count_nonzero(mask))}")
    print("Color extraction: done.")


def _run_device_init(cfg: PipelineConfig, names: List[str], k: int, fuse: bool, resized_path: str) -> None:
    """``kmeans_init: "device"``: :func:`device_init_stage` on the raster
    device, one download, then the shared tail."""
    device = raster_device(cfg)
    # stage 01's upload when this process made one for this device; the file otherwise
    img = fetch_device_artifact(resized_path)
    if not isinstance(img, torch.Tensor) or img.device.type != device.type:
        img = torch.from_numpy(read_image(resized_path)).to(device)
    if device.type == "cpu":
        print("[raster-device] note: kmeans_init='device' on the CPU runs the plain versions; its float "
              "k-means may differ from the card's at near ties (the seed stream is the same)")
    h, w = img.shape[:2]
    w8 = (w + 7) // 8
    blob_dev, masks_b = device_init_stage(
        img.contiguous(), k, int(cfg.kmeans_iters), int(cfg.kmeans_attempts), int(cfg.kmeans_sample_limit),
        int(cfg.kmeans_seed), fuse, *(edge_params(cfg) if fuse else (1, 0, 0, 3, 0, 0)),
        open_iters=int(cfg.extract_open_iters), close_iters=int(cfg.extract_close_iters),
    )
    blob = blob_dev.cpu().numpy()
    centers = np.ascontiguousarray(blob[: 12 * k]).view(np.float32).reshape(k, 3)
    counts0 = np.ascontiguousarray(blob[12 * k : 16 * k]).view(np.int32)
    packed = blob[16 * k : 16 * k + k * h * w8].reshape(k, h, w8)
    chain_packed = blob[16 * k + k * h * w8 :].reshape(2 * k, h, w8) if fuse else None

    def mask_of(cluster_idx: int) -> np.ndarray:
        m = np.unpackbits(packed[cluster_idx], axis=-1)[..., :w]
        m *= np.uint8(255)
        return m

    _finish_kmeans(cfg, names, k, w, centers, counts0, mask_of, (lambda: chain_packed) if fuse else None, masks_b)


def run(cfg: PipelineConfig) -> None:
    os.makedirs(cfg.output_dir, exist_ok=True)
    resized_path = os.path.join(cfg.output_dir, "resized.png")
    if cfg.extraction_mode.lower() == "swatch":
        swatch_mode(cfg, read_image(resized_path))
        return

    from ..pipeline import chain_hint  # noqa: PLC0415

    names = list(cfg.color_names)
    k = cfg.resolve_cluster_k()
    fuse = {3, 4} <= chain_hint() and k == len(names)
    if (int(cfg.shard_rows or 0) > 0 or float(cfg.shard_auto_mpx or 0) > 0) and (
            cfg.kmeans_init.lower() == "device" or not fuse):
        print(
            "[shard] note: row sharding applies to the fused host-exact 02-04 "
            f"chain; this run (kmeans_init={cfg.kmeans_init!r}, fused={fuse}) "
            "uses the unsharded device programs"
        )
    if cfg.kmeans_init.lower() == "device":
        return _run_device_init(cfg, names, k, fuse, resized_path)

    import cv2  # noqa: PLC0415

    img = read_image(resized_path)
    h, w = img.shape[:2]
    n = h * w
    seed = int(cfg.kmeans_seed)
    limit = int(cfg.kmeans_sample_limit)

    # cv2's fixed-point uint8 Lab, the reference's subsample index stream
    # (rng(seed).choice, 02:41), the cv2.kmeans replica and the reference's
    # numpy assignment — byte-identical to the reference on any input
    lab = cv2.cvtColor(img, cv2.COLOR_BGR2LAB)
    flat = lab.reshape(-1, 3)
    if n > limit:
        idx = np.random.default_rng(seed).choice(n, size=limit, replace=False)
        sample = flat[idx].astype(np.float32)
    else:
        sample = flat.astype(np.float32)
    _, _, centers = cv_kmeans(
        sample, k, max_count=int(cfg.kmeans_iters), epsilon=0.5, attempts=int(cfg.kmeans_attempts)
    )
    labels = assign_labels(flat, centers).reshape(h, w)
    counts0 = np.bincount(labels.ravel(), minlength=k).astype(np.int64)
    masks8 = _host_clean_masks(labels, k, int(cfg.extract_open_iters), int(cfg.extract_close_iters))

    if not fuse:
        # stage 02 alone (resumed or partial runs): host only
        return _finish_kmeans(cfg, names, k, w, centers, counts0, lambda ci: masks8[ci], None)

    shard_n = resolve_shard_n(cfg, h, w)
    device = raster_device(cfg)
    if shard_n >= 1:
        mesh = make_mesh((shard_n,), ("space",), devices=default_devices(device.type))
        print(f"[shard] raster chain row-sharded over {shard_n} device(s)")
    packed_np = np.stack([np.packbits(m > 0, axis=-1) for m in masks8])
    w8 = (w + 7) // 8
    from ..parallel.batchrun import active_batcher  # noqa: PLC0415

    # a batch run's, which this image's fused chain call joins unless sharding was asked for or the
    # batcher's mesh is on another platform than this image's raster device
    batcher = active_batcher() if shard_n < 1 else None
    if batcher is not None and batcher.mesh.platform != device.type:
        batcher = None

    def chain():
        if batcher is not None:
            # a batch run: this image's chain call joins its siblings' in one grouped call
            return batcher.run_chain(packed_np, w, edge_params(cfg)).reshape(2 * k, h, w8)
        if shard_n >= 1:
            blob = sharded_chain(mesh, packed_np, w, *edge_params(cfg))
        else:
            blob = chain_from_clean(packed_np, w, *edge_params(cfg), device=device)
        return blob.cpu().numpy().reshape(2 * k, h, w8)

    fetch = _BgFetch(chain)
    try:
        return _finish_kmeans(cfg, names, k, w, centers, counts0, lambda ci: masks8[ci], fetch)
    finally:
        fetch.wait()


def _finish_kmeans(cfg, names: List[str], k: int, w: int, centers, counts0, mask_of, chain_fetch, masks_dev=None):
    """Dark→light relabel, mask PNG writes, chain artifact registration and
    the palette JSON.  ``mask_of(cluster_idx)`` is the cleaned 0/255 mask of
    an original cluster; ``chain_fetch`` (when fused) joins the chain →
    (2k, H, ⌈W/8⌉) packed, called after the PNG writes.  ``masks_dev`` (the
    device mode's cleaned masks as (k, H, ⌈W/32⌉) bitboards on the raster
    device, else None) is handed to stage 03 through the device-artifact
    registry, keyed to the mask files."""
    import cv2  # noqa: PLC0415

    # relabel dark→light by the L channel (reference 02:120-127)
    order = np.argsort(centers[:, 0])
    counts = [int(c) for c in counts0[order]]
    centers = centers[order]
    names_sorted = sorted(names, key=darkness_rank)

    def write_mask(cluster_idx: int, name: str):
        mask = mask_of(int(order[cluster_idx]))
        mask_path = os.path.join(layer_dir(cfg, name), "mask.png")
        write_image(mask_path, mask)
        return mask_path, int(np.count_nonzero(mask))

    written = thread_map(lambda t: write_mask(*t), list(enumerate(names_sorted[:k])))

    if chain_fetch is not None:
        # stage 03/04 outputs, permuted from cluster order to cfg.color_names
        # order and keyed to the mask files just written
        ch = chain_fetch()
        name_to_cluster = {nm: int(order[j]) for j, nm in enumerate(names_sorted[:k])}
        perm = [name_to_cluster[nm] for nm in names]
        mask_paths = [os.path.join(layer_dir(cfg, nm), "mask.png") for nm in names]
        register_derived_artifact(
            chain_key(cfg, "edges+skels"),
            mask_paths,
            (np.ascontiguousarray(ch[:k][perm]), np.ascontiguousarray(ch[k:][perm]), w),
        )

    palette = {}
    for cluster_idx, name in enumerate(names_sorted[:k]):
        mask_path, nz = written[cluster_idx]
        if masks_dev is not None:
            # the device copy for stage 03 (the values of the PNG), as (bitboard, width)
            register_device_artifact(mask_path, (masks_dev[int(order[cluster_idx])], w))
        # reference truncates: centers_lab[k].astype(np.uint8) → cv2 Lab2BGR
        # on the 1×1 uint8 image (02:58-61,159)
        center_lab = centers[cluster_idx].astype(np.uint8)
        bgr_px = cv2.cvtColor(center_lab.reshape(1, 1, 3), cv2.COLOR_LAB2BGR)[0, 0]
        palette[name] = {
            "mode": "kmeans",
            "cluster_index": int(cluster_idx),
            "cluster_lab": [int(v) for v in center_lab],
            "approx_bgr": [int(bgr_px[0]), int(bgr_px[1]), int(bgr_px[2])],
            "pixels": counts[cluster_idx],
            "mask_nonzero": nz,
        }
        print(
            f"Extracted (kmeans): {name} | cluster={cluster_idx} | "
            f"L*={centers[cluster_idx, 0]:.1f} | pixels={counts[cluster_idx]} | nz={nz}"
        )

    pal_path = os.path.join(cfg.output_dir, "palette_by_name.json")
    save_json(palette, pal_path)
    print(f"Palette saved: {pal_path}")
    print("Color extraction: done.")
