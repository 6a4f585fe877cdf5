"""[11] Final preview after cross-layer dedup → preview_cross.png + composite
(reference 11_preview_cross.py; same renderer as stage 09 over the
lines_cross/taps_cross artifacts).

Copy of ``plotweave/stages/s11_preview_cross.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..viz.previews import render_stage_previews
from .common import palette_bgr, target_size_px
from .s09_preview_intra import load_lines_strict, load_taps_strict


def run(cfg: PipelineConfig) -> None:
    size = target_size_px(cfg)
    layers = []
    for name in cfg.color_names:
        d = os.path.join(cfg.output_dir, name)
        os.makedirs(d, exist_ok=True)
        layers.append((name, load_lines_strict(d, "lines_cross.pkl"), load_taps_strict(d, "taps_cross.pkl")))
    render_stage_previews(
        cfg.output_dir,
        size,
        layers,
        palette_bgr(cfg),
        "preview_cross.png",
        "preview_cross_composite.png",
        thickness=int(cfg.preview_line_thickness_px),
        antialiased=bool(cfg.preview_antialiased),
        tap_radius=int(cfg.pen_radius_px),
    )
