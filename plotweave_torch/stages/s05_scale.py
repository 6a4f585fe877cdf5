"""[05] Scale contours to the page: contours.pkl → contours_scaled.pkl
(reference 05_scale_vectors.py).

Copy of ``plotweave/stages/s05_scale.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..utils import load_pickle, save_pickle
from ..vector.scale import fit_scale, scale_polys
from .common import layer_dir, source_size_px, target_size_px


def run(cfg: PipelineConfig) -> None:
    os.makedirs(cfg.output_dir, exist_ok=True)
    w_src, h_src = source_size_px(cfg)
    w_full, h_full = target_size_px(cfg)
    margins = cfg.margins_px()
    sx, sy, dx, dy = fit_scale((w_src, h_src), (w_full, h_full), margins, cfg.keep_aspect)

    print(
        f"[scale] source={w_src}x{h_src}, target(full)={w_full}x{h_full}, "
        f"margins(l,r,t,b)={margins}, scale=({sx:.4f},{sy:.4f}), offset=({dx},{dy})"
    )

    for name in cfg.color_names:
        d = layer_dir(cfg, name)
        src = os.path.join(d, "contours.pkl")
        if not os.path.exists(src):
            print(f"[scale] {name}: missing {src}, skipping")
            continue
        contours = load_pickle(src)
        scaled = scale_polys(contours, sx, sy, dx, dy)
        dst = os.path.join(d, "contours_scaled.pkl")
        save_pickle(scaled, dst)
        print(f"[scale] {name}: contours={len(contours)} → {dst}")
