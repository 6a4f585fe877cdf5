"""Shared stage helpers: canvas geometry, palette lookup, layer paths.

Copy of ``plotweave/stages/common.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

from ..config import PipelineConfig
from ..utils import load_json, read_image


def target_size_px(cfg: PipelineConfig) -> Tuple[int, int]:
    """(W, H) of the output canvas: explicit px → mm×ppm → resized.png size
    (priority chain used by stages 05/06/08/09/10/11/12/13)."""
    w, h = cfg.target_size_px()
    if w > 0 and h > 0:
        return w, h
    base = read_image(os.path.join(cfg.output_dir, "resized.png"))
    return base.shape[1], base.shape[0]


def source_size_px(cfg: PipelineConfig) -> Tuple[int, int]:
    base = read_image(os.path.join(cfg.output_dir, "resized.png"))
    return base.shape[1], base.shape[0]


def layer_dir(cfg: PipelineConfig, name: str) -> str:
    d = os.path.join(cfg.output_dir, name)
    os.makedirs(d, exist_ok=True)
    return d


def darkness_rank(name: str) -> int:
    """Dark→light ordering by name substring (02:17-23)."""
    s = name.lower()
    if "dark" in s:
        return 0
    if "mid" in s:
        return 1
    if "skin" in s:
        return 2
    if "light" in s:
        return 3
    return 2


def cross_layer_order(names: List[str]) -> List[str]:
    """Stage 10's dark→light ordering uses a fixed name list (10:206-208),
    unknown names last, ties by original position (list.sort is stable)."""
    fixed = ["layer_dark", "layer_mid", "layer_skin", "layer_light"]
    out = list(names)
    out.sort(key=lambda n: fixed.index(n) if n in fixed else 999)
    return out


def palette_bgr(cfg: PipelineConfig, key: str = "approx_bgr") -> Dict[str, Tuple[int, int, int]]:
    """Per-layer BGR from palette_by_name.json, falling back to cfg.colors
    by index (06:45-62).  ``key`` lets callers reproduce the composite's
    lookup of a key the palette never contains (03:85-91 probes "bgr")."""
    path = os.path.join(cfg.output_dir, "palette_by_name.json")
    data = None
    if os.path.exists(path):
        try:
            data = load_json(path)
        except Exception:  # noqa: BLE001
            data = None
    out: Dict[str, Tuple[int, int, int]] = {}
    for i, name in enumerate(cfg.color_names):
        if data and name in data and key in data[name]:
            b, g, r = data[name][key]
        else:
            b, g, r = cfg.colors[i]
        out[name] = (int(b), int(g), int(r))
    return out



def edge_params(cfg: PipelineConfig):
    """Static stage-03 parameter tuple (mk, oi, ci, bk, lo, hi) — shared by
    stage 03 and the fused 02→04 chain so their programs/keys agree."""
    bk = max(3, int(cfg.edge_kernel_size))
    if bk % 2 == 0:
        bk += 1
    return (
        max(1, int(cfg.edge_morph_kernel)),
        int(cfg.edge_morph_open_iters),
        int(cfg.edge_morph_close_iters),
        bk,
        int(cfg.edge_low_threshold),
        int(cfg.edge_high_threshold),
    )


def chain_key(cfg: PipelineConfig, tag: str) -> str:
    """Derived-artifact key for the fused 02→04 chain outputs.

    Encodes the layer-name tuple: the packed rows are permuted for THAT
    names order, so a rerun with reordered/renamed layers (same mask files
    on disk) must miss the cache, not consume mis-assigned rows."""
    return f"{cfg.output_dir}::{tag}::{tuple(cfg.color_names)}::{edge_params(cfg)}"
