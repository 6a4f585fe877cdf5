"""[08] Intra-layer dedup: contours_sorted.pkl → lines_intra.pkl + taps_intra.pkl
(reference 08_dedup_layer_basic.py).

Copy of ``plotweave/stages/s08_dedup_intra.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..utils import load_pickle, save_pickle
from ..vector.dedup_intra import dedup_layer
from ..vector.geometry import as_pts
from .common import layer_dir, target_size_px


def run(cfg: PipelineConfig) -> None:
    canvas_wh = target_size_px(cfg)
    pen_radius = float(cfg.pen_radius_px)
    tap_diam = cfg.resolve_tap_diameter()
    col_rad = float(cfg.collision_radius_intra_px)

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
            tap_diam=tap_diam,
            tap_max_dim=float(cfg.tap_max_dim),
            min_keep=cfg.resolve_min_keep_diameter(),
            tap_max_perimeter=cfg.resolve_tap_max_perimeter_intra(),
            tap_max_vertices=int(cfg.tap_max_vertices),
            sample_step=float(cfg.dedup_sample_step),
            tail_len_px=cfg.resolve_ignore_tail_len(),
            collision_radius=col_rad,
            grid_cell=float(cfg.hash_stride_px),
            max_jump=float(cfg.max_join_jump_px),
            post_enabled=bool(cfg.intra_post_skeleton_enabled),
            post_brush=int(cfg.intra_post_brush_px),
            post_step=float(cfg.intra_post_resample_step_px),
            post_rdp_eps=cfg.resolve_intra_rdp_eps(),
            post_min_len=cfg.resolve_intra_min_path_len(),
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
