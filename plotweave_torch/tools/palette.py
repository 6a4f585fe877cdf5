"""Marker palette for color recommendations.

The reference's analyze_colors imports a ``color_palette.CariocaPalette``
module that does not exist in its repo (analyze_colors.py:16 — the tool
cannot run as-is).  This ships a working equivalent: a typical 24-marker set
with names and RGB values plus nearest-color lookup in Lab.

Copy of ``plotweave/tools/palette.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class MarkerColor:
    name: str
    rgb: Tuple[int, int, int]


MARKER_SET_24: List[MarkerColor] = [
    MarkerColor("black", (30, 30, 30)),
    MarkerColor("grey", (128, 128, 128)),
    MarkerColor("light grey", (200, 200, 200)),
    MarkerColor("white", (245, 245, 245)),
    MarkerColor("red", (220, 40, 35)),
    MarkerColor("dark red", (150, 25, 30)),
    MarkerColor("orange", (240, 130, 30)),
    MarkerColor("yellow", (250, 220, 50)),
    MarkerColor("light green", (150, 210, 90)),
    MarkerColor("green", (60, 160, 70)),
    MarkerColor("dark green", (25, 100, 60)),
    MarkerColor("teal", (40, 160, 160)),
    MarkerColor("cyan", (80, 200, 230)),
    MarkerColor("light blue", (120, 170, 230)),
    MarkerColor("blue", (45, 90, 190)),
    MarkerColor("dark blue", (30, 50, 120)),
    MarkerColor("violet", (120, 70, 160)),
    MarkerColor("magenta", (210, 60, 150)),
    MarkerColor("pink", (245, 160, 190)),
    MarkerColor("skin", (245, 200, 170)),
    MarkerColor("tan", (210, 160, 110)),
    MarkerColor("brown", (140, 90, 50)),
    MarkerColor("dark brown", (90, 55, 35)),
    MarkerColor("olive", (128, 120, 50)),
]


class MarkerPalette:
    """Nearest-marker lookup in Lab space with near-duplicate suppression."""

    def __init__(self, colors: List[MarkerColor] = None):
        self.colors = list(colors or MARKER_SET_24)
        self._lab = self._rgb_to_lab(np.array([c.rgb for c in self.colors], np.float32))

    @staticmethod
    def _rgb_to_lab(rgb: np.ndarray) -> np.ndarray:
        import torch  # noqa: PLC0415

        from ..ops.colorspace import bgr_to_lab_u8  # noqa: PLC0415

        bgr = np.ascontiguousarray(rgb[..., ::-1].astype(np.uint8))
        return bgr_to_lab_u8(torch.from_numpy(bgr)).numpy()

    def nearest(self, rgb: Tuple[int, int, int]) -> Tuple[MarkerColor, float]:
        lab = self._rgb_to_lab(np.array([rgb], np.float32))[0]
        d = np.linalg.norm(self._lab - lab, axis=1)
        i = int(np.argmin(d))
        return self.colors[i], float(d[i])

    def recommend(
        self,
        cluster_rgbs: np.ndarray,
        coverages: np.ndarray,
        n: int = 4,
        dedup_lab_dist: float = 18.0,
    ) -> List[Tuple[MarkerColor, float]]:
        """Pick ≤ n markers for the clusters, weighting by pixel coverage and
        suppressing near-duplicate picks in Lab."""
        labs = self._rgb_to_lab(cluster_rgbs.astype(np.float32))
        order = np.argsort(-np.asarray(coverages))
        picks: List[Tuple[MarkerColor, float]] = []
        picked_lab: List[np.ndarray] = []
        for idx in order:
            marker, _ = self.nearest(tuple(int(v) for v in cluster_rgbs[idx]))
            mlab = self._lab[[c.name for c in self.colors].index(marker.name)]
            if any(np.linalg.norm(mlab - pl) < dedup_lab_dist for pl in picked_lab):
                continue
            picks.append((marker, float(coverages[idx])))
            picked_lab.append(mlab)
            if len(picks) >= n:
                break
        return picks
