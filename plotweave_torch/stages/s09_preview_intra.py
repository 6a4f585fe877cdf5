"""[09] Preview after intra-layer dedup (STRICT inputs) → preview_intra.png
+ composite (reference 09_preview_intra.py).

Copy of ``plotweave/stages/s09_preview_intra.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import PipelineConfig
from ..utils import load_pickle
from ..viz.previews import render_stage_previews
from .common import palette_bgr, target_size_px


def load_lines_strict(d: str, fname: str):
    p = os.path.join(d, fname)
    if not os.path.exists(p):
        raise RuntimeError(f"Missing required input: {p}")
    obj = load_pickle(p)
    if not isinstance(obj, list):
        raise RuntimeError(f"Invalid pickle format: {p}")
    return obj


def load_taps_strict(d: str, fname: str):
    p = os.path.join(d, fname)
    if not os.path.exists(p):
        raise RuntimeError(f"Missing required input: {p}")
    taps = []
    for it in load_pickle(p):
        a = np.asarray(it).reshape(-1)
        if a.size >= 2:
            taps.append((int(a[0]), int(a[1])))
    return taps


def run(cfg: PipelineConfig) -> None:
    size = target_size_px(cfg)
    layers = []
    for name in cfg.color_names:
        d = os.path.join(cfg.output_dir, name)
        os.makedirs(d, exist_ok=True)
        layers.append((name, load_lines_strict(d, "lines_intra.pkl"), load_taps_strict(d, "taps_intra.pkl")))
    render_stage_previews(
        cfg.output_dir,
        size,
        layers,
        palette_bgr(cfg),
        "preview_intra.png",
        "preview_intra_composite.png",
        thickness=int(cfg.preview_line_thickness_px),
        antialiased=bool(cfg.preview_antialiased),
        tap_radius=int(cfg.pen_radius_px),
    )
