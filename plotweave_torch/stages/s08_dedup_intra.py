"""[08] Intra-layer dedup: contours_sorted.pkl → lines_intra.pkl + taps_intra.pkl
(twin of ``plotweave/stages/s08_dedup_intra.py``).

The shared ``dedup_layer`` has no ``thinner`` argument, and its default
thinner falls back to the JAX ``zhang_suen`` when the native library is off.
So :func:`dedup_layer` here is its body, over the same shared helpers, with
the skeleton merge's ``thinner=`` set to :func:`make_thinner`'s: the native
``thin_native`` first, as the default does, else the port's ``zhang_suen``
(standard ring, 48 iterations) on the raster device.
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np
import torch

from plotweave.config import PipelineConfig
from plotweave.native.api import thin_native
from plotweave.stages.common import layer_dir, target_size_px
from plotweave.utils import load_pickle, save_pickle
from plotweave.vector.dedup_intra import (_virtual_draw_all_native, classify_taps, reorder_intra,
                                          skeleton_merge, virtual_draw_cut)
from plotweave.vector.geometry import as_pts, perimeter_open, split_on_jumps

from ..ops.thinning import zhang_suen
from ..utils.devices import raster_device


def make_thinner(cfg: PipelineConfig):
    """Stage 08's thinner: uint8 0/255 ROI → uint8 0/255 skeleton.  The
    raster device is resolved only when the native library is missing."""

    def thinner(roi: np.ndarray) -> np.ndarray:
        sk = thin_native(roi, max_iter=48, rotated=False)
        if sk is not None:
            return sk * 255
        x = torch.from_numpy(np.ascontiguousarray(roi)).to(raster_device(cfg))
        return zhang_suen(x, max_iter=48, rotated=False).to(torch.uint8).cpu().numpy() * 255

    return thinner


def dedup_layer(polys: List[np.ndarray], canvas_wh: Tuple[int, int], *, tap_diam: float,
                tap_max_dim: float, min_keep: float, tap_max_perimeter: float,
                tap_max_vertices: int, sample_step: float, tail_len_px: float,
                collision_radius: float, grid_cell: float, max_jump: float, post_enabled: bool,
                post_brush: int, post_step: float, post_rdp_eps: float, post_min_len: int,
                thinner, log=lambda s: None):
    """``plotweave.vector.dedup_intra.dedup_layer`` with the skeleton merge's
    ``thinner`` passed through (08:484-557)."""
    W, H = canvas_wh
    canvas = np.zeros((H, W), np.uint8)
    brush = max(1, int(round(2.0 * collision_radius)))

    kept, taps = classify_taps(polys, tap_diam, min_keep, tap_max_perimeter, tap_max_vertices, tap_max_dim)

    order = sorted(range(len(kept)), key=lambda i: perimeter_open(kept[i]), reverse=True)
    per_contour = _virtual_draw_all_native(
        kept, order, canvas, collision_radius, grid_cell, sample_step, tail_len_px, brush, log
    )
    if per_contour is None:
        # no native library: the per-contour loop (identical bytes)
        per_contour = []
        last_beat = time.perf_counter()
        for idx, i in enumerate(order, 1):
            per_contour.append(virtual_draw_cut(
                kept[i], canvas, collision_radius, grid_cell, sample_step, tail_len_px, brush
            ))
            now = time.perf_counter()
            if idx == len(order) or now - last_beat > 1.0:
                last_beat = now
                log(f"virtual draw {idx}/{len(order)}")
    cleaned: List[np.ndarray] = []
    for frags in per_contour:
        for f in frags:
            parts = split_on_jumps(f, max_jump, keep_singleton=True)
            cleaned.extend(parts if parts else [f])

    if order:
        lines, taps2 = classify_taps(cleaned, tap_diam, min_keep, tap_max_perimeter, tap_max_vertices, tap_max_dim)
        taps = taps2 if len(taps) == 0 else (taps + taps2)
    else:
        lines = []

    if post_enabled and lines:
        log(f"skeleton merge: {len(lines)} fragments")
        lines = skeleton_merge(lines, post_brush, post_step, post_rdp_eps, post_min_len, thinner=thinner)

    return reorder_intra(lines), taps


def run(cfg: PipelineConfig) -> None:
    canvas_wh = target_size_px(cfg)
    thinner = make_thinner(cfg)

    for name in cfg.color_names:
        d = layer_dir(cfg, name)
        src = os.path.join(d, "contours_sorted.pkl")
        if not os.path.exists(src):
            raise RuntimeError(f"[intra] missing input: {src}. Run step 7 first.")
        polys = load_pickle(src)
        if not isinstance(polys, list):
            raise RuntimeError(f"[intra] invalid pickle format: {src}")
        if not polys:
            save_pickle([], os.path.join(d, "lines_intra.pkl"))
            save_pickle([], os.path.join(d, "taps_intra.pkl"))
            print(f"[intra] {name}: empty input.")
            continue

        lines, taps = dedup_layer(
            polys,
            canvas_wh,
            tap_diam=cfg.resolve_tap_diameter(),
            tap_max_dim=float(cfg.tap_max_dim),
            min_keep=cfg.resolve_min_keep_diameter(),
            tap_max_perimeter=cfg.resolve_tap_max_perimeter_intra(),
            tap_max_vertices=int(cfg.tap_max_vertices),
            sample_step=float(cfg.dedup_sample_step),
            tail_len_px=cfg.resolve_ignore_tail_len(),
            collision_radius=float(cfg.collision_radius_intra_px),
            grid_cell=float(cfg.hash_stride_px),
            max_jump=float(cfg.max_join_jump_px),
            post_enabled=bool(cfg.intra_post_skeleton_enabled),
            post_brush=int(cfg.intra_post_brush_px),
            post_step=float(cfg.intra_post_resample_step_px),
            post_rdp_eps=cfg.resolve_intra_rdp_eps(),
            post_min_len=cfg.resolve_intra_min_path_len(),
            thinner=thinner,
            log=lambda s, n=name: print(f"[intra] {n}: {s}", flush=True),
        )

        save_pickle(lines, os.path.join(d, "lines_intra.pkl"))
        save_pickle(taps, os.path.join(d, "taps_intra.pkl"))
        vin = sum(int(as_pts(p).shape[0]) for p in polys)
        vout = sum(int(as_pts(p).shape[0]) for p in lines)
        print(
            f"[intra] {name}: lines={len(lines)}, taps={len(taps)}, "
            f"vertices_in={vin}, vertices_out={vout}"
        )
