"""[10] Cross-layer dedup: lines_intra/taps_intra → lines_cross/taps_cross
per layer, dark→light against one shared forbidden canvas (reference
10_dedup_cross_basic.py).

Copy of ``plotweave/stages/s10_dedup_cross.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import PipelineConfig
from ..utils import load_pickle, save_pickle, write_image
from ..vector.dedup_cross import dedup_cross_layer
from ..vector.geometry import as_pts
from .common import cross_layer_order, layer_dir, target_size_px


def _load_intra(d: str):
    lines, taps = [], []
    pl = os.path.join(d, "lines_intra.pkl")
    pt = os.path.join(d, "taps_intra.pkl")
    if os.path.exists(pl):
        lines = load_pickle(pl)
    else:
        print(f"[cross] WARNING: missing {pl}")
    if os.path.exists(pt):
        for it in load_pickle(pt):
            a = np.asarray(it).reshape(-1)
            if a.size >= 2:
                taps.append((int(a[0]), int(a[1])))
    else:
        print(f"[cross] WARNING: missing {pt}")
    return lines, taps


def run(cfg: PipelineConfig) -> None:
    W, H = target_size_px(cfg)
    canvas = np.zeros((H, W), np.uint8)

    tap_diam = cfg.resolve_tap_diameter()
    brush_lines, brush_taps = cfg.resolve_cross_brushes()
    names = cross_layer_order(list(cfg.color_names))

    print(
        f"[cross] forbidden: {W}x{H} | D_lines={brush_lines:.1f}px | "
        f"D_taps={brush_taps:.1f}px | step={float(cfg.cross_cut_step_px):.1f}px"
    )

    for idx, name in enumerate(names, 1):
        d = layer_dir(cfg, name)
        lines_in, taps_in = _load_intra(d)

        lines_out, taps_out = dedup_cross_layer(
            lines_in,
            taps_in,
            canvas,
            tap_diam=tap_diam,
            min_keep=cfg.resolve_min_keep_diameter_cross(),
            tap_max_perimeter=cfg.resolve_tap_max_perimeter_cross(),
            tap_max_vertices=int(cfg.tap_max_vertices),
            max_jump=float(cfg.max_join_jump_px),
            brush_lines=brush_lines,
            brush_taps=brush_taps,
            cut_step=float(cfg.cross_cut_step_px),
        )

        save_pickle(lines_out, os.path.join(d, "lines_cross.pkl"))
        save_pickle(taps_out, os.path.join(d, "taps_cross.pkl"))

        if cfg.cross_debug_masks:
            write_image(os.path.join(cfg.output_dir, f"forbidden_after_{idx:02d}_{name}.png"), canvas)

        vin = sum(int(as_pts(p).shape[0]) for p in lines_in)
        vout = sum(int(as_pts(p).shape[0]) for p in lines_out)
        print(
            f"[cross] {name}: lines {len(lines_in)}→{len(lines_out)} (v {vin}→{vout}), "
            f"taps {len(taps_in)}→{len(taps_out)}"
        )
