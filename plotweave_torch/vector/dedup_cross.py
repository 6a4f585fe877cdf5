"""Cross-layer overlap deduplication (stage 10).

Layers are processed dark→light against one shared forbidden canvas: each
layer's lines are cut where they sample onto forbidden pixels, tiny leftovers
become taps, survivors are reordered and stamped THICK (2×pen by default)
into the canvas; taps are then accepted sequentially (center-pixel test) and
stamped immediately so later taps/layers cannot overlap (reference
10_dedup_cross_basic.py:212-278).

Copy of ``plotweave/vector/dedup_cross.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import cv2
import numpy as np

from .geometry import arc_length, as_pts, split_on_jumps
from .sort import reorder_cross

Tap = Tuple[int, int]


def cut_against_canvas(poly: np.ndarray, canvas: np.ndarray, step_px: float) -> List[np.ndarray]:
    """Sample each segment every ``step_px`` and split at forbidden pixels
    (10:142-177).  The polyline's own vertices are resampled, so output
    vertices are sample points, not original vertices."""
    pts = as_pts(poly).astype(np.float32)
    if len(pts) < 2:
        return []
    h, w = canvas.shape
    out: List[np.ndarray] = []
    cur: List[Tuple[float, float]] = []

    def blocked(x: float, y: float) -> bool:
        xi, yi = int(round(x)), int(round(y))
        return 0 <= yi < h and 0 <= xi < w and canvas[yi, xi] != 0

    if not blocked(float(pts[0, 0]), float(pts[0, 1])):
        cur.append((float(pts[0, 0]), float(pts[0, 1])))

    for i in range(1, len(pts)):
        p0, p1 = pts[i - 1], pts[i]
        v = p1 - p0
        seg_len = float(np.hypot(v[0], v[1]))
        if seg_len <= 1e-6:
            continue
        n = max(1, int(math.ceil(seg_len / max(1.0, step_px))))
        for k in range(1, n + 1):
            q = p0 + v * (k / n)
            if blocked(float(q[0]), float(q[1])):
                if len(cur) >= 2:
                    out.append(np.array(cur, np.float32).reshape(-1, 1, 2).astype(np.int32))
                cur = []
            else:
                cur.append((float(q[0]), float(q[1])))

    if len(cur) >= 2:
        out.append(np.array(cur, np.float32).reshape(-1, 1, 2).astype(np.int32))
    return out


def stamp_thick(canvas: np.ndarray, lines: List[np.ndarray], taps: List[Tap], brush_diam: float) -> None:
    """Thick-brush stamping: polylines with round joints, taps as discs (10:122-140)."""
    thickness = int(max(1, round(brush_diam)))
    radius = max(1, int(round(brush_diam / 2.0)))
    arrs = [np.asarray(p).reshape(-1, 1, 2).astype(np.int32) for p in lines]
    arrs = [a for a in arrs if len(a) >= 2]
    if arrs:
        cv2.polylines(canvas, arrs, isClosed=False, color=255, thickness=thickness, lineType=cv2.LINE_8)
    for x, y in taps:
        cv2.circle(canvas, (int(x), int(y)), radius, 255, thickness=-1, lineType=cv2.LINE_8)


def classify_taps_cross(
    polys: List[np.ndarray],
    tap_diam: float,
    min_keep_diam: float,
    tap_max_perimeter: float,
    tap_max_vertices: int,
) -> Tuple[List[np.ndarray], List[Tap]]:
    """Tiny→tap classification by min-enclosing-circle *diameter* (10:99-118) —
    note: unlike stage 08's bbox test, and keep requires d ≥ min_keep."""
    kept: List[np.ndarray] = []
    taps: List[Tap] = []
    for c in polys:
        if c is None:
            continue
        f = as_pts(c).astype(np.float32).reshape(-1, 1, 2)
        (cx, cy), r = cv2.minEnclosingCircle(f)
        d = float(2.0 * r)
        if d <= tap_diam:
            if arc_length(c, False) <= tap_max_perimeter and int(as_pts(c).shape[0]) <= tap_max_vertices:
                taps.append((int(round(cx)), int(round(cy))))
                continue
        if d >= min_keep_diam:
            kept.append(c)
    return kept, taps


def dedup_cross_layer(
    lines_in: List[np.ndarray],
    taps_in: List[Tap],
    canvas: np.ndarray,
    *,
    tap_diam: float,
    min_keep: float,
    tap_max_perimeter: float,
    tap_max_vertices: int,
    max_jump: float,
    brush_lines: float,
    brush_taps: float,
    cut_step: float,
) -> Tuple[List[np.ndarray], List[Tap]]:
    """One layer against the shared forbidden canvas; mutates the canvas."""
    cut: List[np.ndarray] = []
    for poly in lines_in:
        cut.extend(cut_against_canvas(poly, canvas, cut_step))

    pieces: List[np.ndarray] = []
    for seg in cut:
        parts = split_on_jumps(seg, max_jump, keep_singleton=False)
        pieces.extend(parts if parts else [seg])

    lines_keep, taps_from_lines = classify_taps_cross(
        pieces, tap_diam, min_keep, tap_max_perimeter, tap_max_vertices
    )
    lines_out = reorder_cross(lines_keep)

    stamp_thick(canvas, lines_out, [], brush_lines)

    h, w = canvas.shape
    taps_out: List[Tap] = []
    for x, y in list(taps_in) + list(taps_from_lines):
        if not (0 <= y < h and 0 <= x < w and canvas[y, x] != 0):
            taps_out.append((x, y))
            stamp_thick(canvas, [], [(x, y)], brush_taps)

    return lines_out, taps_out
