"""[07] Greedy travel-order sorting: contours_scaled.pkl → contours_sorted.pkl
(reference 07_sort_contours.py).

Copy of ``plotweave/stages/s07_sort.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os
import time

from ..config import PipelineConfig
from ..utils import load_pickle, save_pickle
from ..utils.devices import raster_device
from ..vector.sort import sort_contours
from .common import layer_dir


def run(cfg: PipelineConfig) -> None:
    for name in cfg.color_names:
        d = layer_dir(cfg, name)
        src = os.path.join(d, "contours_scaled.pkl")
        if not os.path.exists(src):
            src = os.path.join(d, "contours.pkl")
        if not os.path.exists(src):
            print(f"[sort] skip (missing): {src}")
            continue
        contours = load_pickle(src)
        t0 = time.perf_counter()
        gate = int(cfg.planner_device_min_n)
        # the device is resolved only for a layer that crosses the gate
        device = raster_device(cfg) if gate and len(contours) >= gate else None
        ordered = sort_contours(contours, device_min_n=gate, device=device)
        save_pickle(ordered, os.path.join(d, "contours_sorted.pkl"))
        print(
            f"[sort] {name}: contours={len(ordered)}, time={time.perf_counter() - t0:.2f}s"
        )
