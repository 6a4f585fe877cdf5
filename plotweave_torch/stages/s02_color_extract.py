"""[02] Color-layer extraction → <layer>/mask.png + palette_by_name.json
(twin of ``plotweave/stages/s02_color_extract.py``, host-exact mode).

The k-means is the host-exact path of the JAX package, unchanged: cv2's
fixed-point Lab, the ``rng(seed).choice`` subsample, the bit-exact
``cv2.kmeans`` replica (``ops/cvkmeans.py``), the native assignment and the
cv2 mask refine.  When the runner chains stages 03 and 04, the cleaned masks,
packed 8 px per byte, go through :func:`chain_from_clean` on the raster
device, on a side thread so the mask PNG writes overlap it; stages 03 and 04
take its blob from the derived-artifact registry.
"""

from __future__ import annotations

import os
import threading
from typing import List

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.bitpack import boards_to_rows, rows_to_boards
from ..ops.canny import canny_boards
from ..ops.cvkmeans import assign_labels, cv_kmeans
from ..ops.morphology import _valid_bits, morph_program, morph_steps
from ..ops.thinning import zhang_suen_packed
from ..utils import read_image, register_derived_artifact, save_json, thread_map, write_image
from ..utils.devices import raster_device
from .common import chain_key, darkness_rank, edge_params, layer_dir


def open_close_boards(masks_b: torch.Tensor, w: int, open_iters: int, close_iters: int,
                      shape: str = "rect", ksize: int = 3) -> torch.Tensor:
    """Open, then close, binary masks held as bitboards, as one step list of
    the packed morphology (K2: one launch on the card)."""
    steps = morph_program(shape, ksize, open_iters, "ed") + morph_program(shape, ksize, close_iters, "de")
    return morph_steps(masks_b, _valid_bits(w, masks_b.device), steps)


def edges_from_boards(masks_b: torch.Tensor, w: int, mk: int, oi: int, ci: int, bk: int, lo: int,
                      hi: int) -> torch.Tensor:
    """Stage 03 over bitboards: the masks' open and close, the blur and Canny
    → the edges as bitboards (K2, K3+K4 and K5 on the card)."""
    return canny_boards(open_close_boards(masks_b, w, oi, ci, "ellipse", mk), w, bk, lo, hi)


def chain_tail(masks_b: torch.Tensor, w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int) -> torch.Tensor:
    """Stage 03's morphology, blur and Canny and stage 04's thinning over the
    cleaned masks as (k, H, ⌈W/32⌉) bitboards → packed (2, k, H, ⌈W/8⌉)
    edges, then skeletons, in one tensor."""
    # the hysteresis board feeds the thinner in the same encoding
    edges_b = edges_from_boards(masks_b, w, mk, oi, ci, bk, lo, hi)
    skels_b = zhang_suen_packed(edges_b, max_iter=120, rotated=True)
    blob = torch.empty((2, *masks_b.shape[:-1], -(-w // 8)), dtype=torch.uint8, device=masks_b.device)
    boards_to_rows(edges_b, w, out=blob[0])
    boards_to_rows(skels_b, w, out=blob[1])
    return blob


def chain_from_clean(packed_clean, w: int, mk: int, oi: int, ci: int, bk: int, lo: int, hi: int,
                     device) -> torch.Tensor:
    """The fused 03→04 chain over stage 02's cleaned masks, packed
    (k, H, ⌈W/8⌉) uint8, on ``device`` → one flat uint8 blob
    [packed edges (k·H·⌈W/8⌉)][packed skeletons], in cluster order.  On the
    card every step between the upload and the blob is a kernel: K1, K2,
    K3+K4, K5, K6, K1."""
    packed = torch.as_tensor(packed_clean, dtype=torch.uint8, device=device)
    return chain_tail(rows_to_boards(packed, w), w, mk, oi, ci, bk, lo, hi).reshape(-1)


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


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported to plotweave_torch yet (ROADMAP.md, {item})")


def run(cfg: PipelineConfig) -> None:
    os.makedirs(cfg.output_dir, exist_ok=True)
    if cfg.extraction_mode.lower() == "swatch":
        raise _not_ported("extraction_mode='swatch'", "Queue 2: K11 dense morphology")
    if cfg.kmeans_init.lower() == "device":
        raise _not_ported("kmeans_init='device'", "Queue 1: device k-means")
    if int(cfg.shard_rows or 0) > 0 or float(cfg.shard_auto_mpx or 0) > 0:
        raise _not_ported("row sharding (shard_rows / shard_auto_mpx)", "Queue 1: multi-GPU")

    import cv2  # noqa: PLC0415

    img = read_image(os.path.join(cfg.output_dir, "resized.png"))
    names = list(cfg.color_names)
    k = cfg.resolve_cluster_k()
    h, w = img.shape[:2]
    n = h * w
    seed = int(cfg.kmeans_seed)
    limit = int(cfg.kmeans_sample_limit)

    from ..pipeline import chain_hint  # noqa: PLC0415

    fuse = {3, 4} <= chain_hint() and k == len(names)

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

    device = raster_device(cfg)
    packed_np = np.stack([np.packbits(m > 0, axis=-1) for m in masks8])
    w8 = (w + 7) // 8

    def chain():
        blob = chain_from_clean(packed_np, w, *edge_params(cfg), device=device)
        return blob.cpu().numpy().reshape(2 * k, h, w8)

    fetch = _BgFetch(chain)
    try:
        return _finish_kmeans(cfg, names, k, w, centers, counts0, lambda ci: masks8[ci], fetch)
    finally:
        fetch.wait()


def _finish_kmeans(cfg, names: List[str], k: int, w: int, centers, counts0, mask_of, chain_fetch):
    """Dark→light relabel, mask PNG writes, chain artifact registration and
    the palette JSON.  ``mask_of(cluster_idx)`` is the cleaned 0/255 mask of
    an original cluster; ``chain_fetch`` (when fused) joins the chain →
    (2k, H, ⌈W/8⌉) packed, called after the PNG writes."""
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
        _, nz = written[cluster_idx]
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
