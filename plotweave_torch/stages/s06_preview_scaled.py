"""[06] Preview of scaled vectors → <layer>/scaled_preview.png + composite
(reference 06_preview_scaled.py).

Copy of ``plotweave/stages/s06_preview_scaled.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..utils import load_pickle
from ..viz.previews import render_stage_previews
from .common import palette_bgr, target_size_px


def _load_with_fallback(d: str):
    for fname in ("contours_scaled.pkl", "contours_sorted.pkl", "contours.pkl"):
        p = os.path.join(d, fname)
        if os.path.exists(p):
            obj = load_pickle(p)
            if isinstance(obj, list):
                return obj
    return []


def run(cfg: PipelineConfig) -> None:
    size = target_size_px(cfg)
    layers = []
    for name in cfg.color_names:
        d = os.path.join(cfg.output_dir, name)
        os.makedirs(d, exist_ok=True)
        layers.append((name, _load_with_fallback(d), None))
    render_stage_previews(
        cfg.output_dir,
        size,
        layers,
        palette_bgr(cfg),
        "scaled_preview.png",
        "scaled_preview_composite.png",
        thickness=int(cfg.scaled_preview_thickness_px),
        antialiased=bool(cfg.scaled_preview_antialiased),
    )
