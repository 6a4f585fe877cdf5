"""[12] Plot-order optimization: the shared stage with the JAX device
refiner switched off (``refine_device_min_n=0``); the optional 2-opt
refinement runs on the host.  The GPU refiner is a later port (ROADMAP.md,
Queue 2: K10)."""

from __future__ import annotations

import dataclasses

from plotweave.config import PipelineConfig
from plotweave.stages import s12_plot_order


def run(cfg: PipelineConfig) -> None:
    s12_plot_order.run(dataclasses.replace(cfg, refine_device_min_n=0))
