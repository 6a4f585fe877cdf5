"""[12] Plot-order optimization: lines_cross/taps_cross → <layer>/ops.pkl +
vector_manifest.json (reference 12_optimize_plot_order.py).

Copy of ``plotweave/stages/s12_plot_order.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import PipelineConfig
from ..utils import load_pickle, save_json, save_pickle
from ..utils.devices import raster_device
from ..vector.planner import layer_color_index, plan_layer_ops, refine_tour, tour_length
from .common import layer_dir, target_size_px


def _load_cross(d: str):
    pl = os.path.join(d, "lines_cross.pkl")
    pt = os.path.join(d, "taps_cross.pkl")
    if not os.path.exists(pl) or not os.path.exists(pt):
        raise SystemExit(f"Missing cross artifacts in {d}")
    lines = load_pickle(pl)
    taps = []
    for it in load_pickle(pt):
        a = np.asarray(it).reshape(-1)
        if a.size >= 2:
            taps.append((int(a[0]), int(a[1])))
    return lines, taps


def run(cfg: PipelineConfig) -> None:
    W, H = target_size_px(cfg)
    r_insert = cfg.resolve_tap_insert_radius()

    layers = []
    for name in cfg.color_names:
        d = layer_dir(cfg, name)
        lines, taps = _load_cross(d)
        ops = plan_layer_ops(lines, taps, r_insert)
        if cfg.plotopt_two_opt:
            before = tour_length(ops)
            gate = int(getattr(cfg, "refine_device_min_n", 0))
            # the device is resolved only for a list that crosses the gate
            device = raster_device(cfg) if gate and len(ops) >= gate else None
            ops = refine_tour(ops, device_min_n=gate, device=device)
            print(f"[plot-opt] {name}: 2-opt+or-opt travel {before:.0f} → {tour_length(ops):.0f} px")
        p_ops = os.path.join(d, "ops.pkl")
        save_pickle(ops, p_ops)
        layers.append(
            {
                "name": name,
                "color_name": name,
                "color_index": layer_color_index(name),
                "file": os.path.relpath(p_ops, cfg.output_dir),
                "count_ops": len(ops),
            }
        )
        n_lines = sum(1 for o in ops if o["type"] == "line")
        n_taps = sum(1 for o in ops if o["type"] == "tap")
        print(f"[plot-opt] {name}: ops={len(ops)} (lines={n_lines}, taps={n_taps})")

    manifest = {"image_size": [W, H], "layers": layers, "coords": "pixel_top_left"}
    out = os.path.join(cfg.output_dir, "vector_manifest.json")
    save_json(manifest, out)
    print(f"[plot-opt] manifest saved: {out}")
