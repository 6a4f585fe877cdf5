"""[07] Greedy travel-order sorting: the shared stage with the JAX device
planner switched off (``planner_device_min_n=0``); the host C++ planner
orders every layer.  The GPU planner is a later port (ROADMAP.md, Queue 2: K9)."""

from __future__ import annotations

import dataclasses

from plotweave.config import PipelineConfig
from plotweave.stages import s07_sort


def run(cfg: PipelineConfig) -> None:
    s07_sort.run(dataclasses.replace(cfg, planner_device_min_n=0))
