"""Procedural A4 demo stream: shapes, multicolor text with hatch fill, taps.

Capability match for the reference demo generator
(stream_generators/plotter_demo/xyplotter_demo.py): a stateful pen ``Turtle``
whose pen-down strokes reuse the ramped travel profile (softened for short
segments), parametric shapes split into color quarters, L1 nearest-neighbor
group ordering with reversal, matplotlib TextPath outlines with serpentine
scanline hatching, and a serpentine tap matrix.  Emits stream + meta JSON.

Copy of ``plotweave/demo/generator.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, replace
from math import cos, sin, tau
from pathlib import Path
from typing import List, Tuple

from ..stream import MotionProfile
from ..stream.emitter import StreamEmitter

STEPS_PER_MM = 40.0
A4_W_MM, A4_H_MM = 210.0, 297.0
CANVAS_W = int(round(A4_W_MM * STEPS_PER_MM))
CANVAS_H = int(round(A4_H_MM * STEPS_PER_MM))

Point = Tuple[int, int]


@dataclass
class Turtle:
    """Stateful pen over a StreamBuilder: dedups pen transitions, rides the
    ramped travel engine for both travel and draw moves."""

    sb: StreamEmitter
    prof: MotionProfile
    x: int = 0
    y: int = 0
    down: bool = False

    def pen_up(self):
        if self.down:
            self.sb.pen_up()
            self.down = False

    def pen_down(self):
        if not self.down:
            self.sb.pen_down()
            self.down = True

    def travel(self, tx: int, ty: int):
        self.pen_up()
        if (tx, ty) != (self.x, self.y):
            self.sb.travel(self.x, self.y, tx, ty, self.prof)
            self.x, self.y = tx, ty

    def stroke(self, tx: int, ty: int):
        """Pen-down move; short segments get a softer local profile."""
        if (tx, ty) == (self.x, self.y):
            return
        self.pen_down()
        est = max(abs(tx - self.x), abs(ty - self.y))
        if est < 2 * int(self.prof.corner_window_steps):
            soft = replace(
                self.prof,
                div_start=max(self.prof.div_start, 12),
                div_fast=min(10, max(self.prof.div_start, 12)),
            )
            self.sb.travel(self.x, self.y, tx, ty, soft)
        else:
            self.sb.travel(self.x, self.y, tx, ty, self.prof)
        self.x, self.y = tx, ty

    def polyline(self, pts: List[Point]):
        if len(pts) < 2:
            return
        self.travel(*pts[0])
        self.pen_down()
        for p in pts[1:]:
            self.stroke(*p)
        self.pen_up()

    def tap(self):
        self.pen_up()
        self.sb.tap()


# ------------------------------- shapes -------------------------------


def circle_pts(cx: int, cy: int, r: int, n: int = 480) -> List[Point]:
    return [(int(cx + r * cos(i * tau / (n - 1))), int(cy + r * sin(i * tau / (n - 1)))) for i in range(n)]


def rect_pts(x: int, y: int, w: int, h: int, n: int = 160) -> List[Point]:
    sides = [((x, y), (x + w, y)), ((x + w, y), (x + w, y + h)),
             ((x + w, y + h), (x, y + h)), ((x, y + h), (x, y))]
    pts: List[Point] = []
    for si, ((ax, ay), (bx, by)) in enumerate(sides):
        for i in range(0 if si == 0 else 1, n):
            t = i / (n - 1)
            pts.append((int(ax + (bx - ax) * t), int(ay + (by - ay) * t)))
    return pts


def sine_pts(x0: int, x1: int, y0: int, amp: int, periods: int, per: int) -> List[Point]:
    n = periods * per
    return [
        (int(x0 + i * (x1 - x0) / (n - 1)), int(y0 + amp * sin(tau * periods * i / (n - 1))))
        for i in range(n)
    ]


def split_quarters(poly: List[Point]) -> List[List[Point]]:
    """Split a polyline into 4 runs of roughly equal arc length."""
    if len(poly) < 2:
        return [poly]
    seg = [
        ((poly[i + 1][0] - poly[i][0]) ** 2 + (poly[i + 1][1] - poly[i][1]) ** 2) ** 0.5
        for i in range(len(poly) - 1)
    ]
    total = sum(seg)
    if total == 0:
        return [poly]
    parts, cur, acc, qi = [], [poly[0]], 0.0, 1
    for i in range(1, len(poly)):
        cur.append(poly[i])
        acc += seg[i - 1]
        if acc >= total * qi / 4 and qi < 4:
            parts.append(cur)
            cur = [poly[i]]
            qi += 1
    if len(cur) >= 2:
        parts.append(cur)
    return parts


def order_nearest(paths: List[List[Point]], start: Point) -> List[List[Point]]:
    """L1 nearest-neighbor ordering with reversal."""
    remain = [p for p in paths if len(p) >= 2]
    out: List[List[Point]] = []
    cur = start
    while remain:
        bi, brev, bd = 0, False, 10**12
        for i, p in enumerate(remain):
            df = abs(cur[0] - p[0][0]) + abs(cur[1] - p[0][1])
            dr = abs(cur[0] - p[-1][0]) + abs(cur[1] - p[-1][1])
            if df < bd:
                bd, bi, brev = df, i, False
            if dr < bd:
                bd, bi, brev = dr, i, True
        p = remain.pop(bi)
        out.append(list(reversed(p)) if brev else p)
        cur = out[-1][-1]
    return out


def draw_group(t: Turtle, paths: List[List[Point]], color: int):
    """One color select per group; NN-ordered strokes."""
    paths = [p for p in paths if len(p) >= 2]
    if not paths:
        return
    ordered = order_nearest(paths, (t.x, t.y))
    t.travel(*ordered[0][0])
    t.sb.select_color(color)
    for pts in ordered:
        t.travel(*pts[0])
        t.pen_down()
        for p in pts[1:]:
            t.stroke(*p)
        t.pen_up()


def draw_quarters(t: Turtle, poly: List[Point], start_color: int = 0):
    parts = split_quarters(poly)
    for c in range(4):
        group = [p for i, p in enumerate(parts) if (start_color + i) % 4 == c and len(p) >= 2]
        draw_group(t, group, c)


# ------------------------------- text -------------------------------


def text_outlines(text: str, x: int, baseline: int, height_mm: float, spacing_mm: float) -> List[Tuple[List[List[Point]], int]]:
    """Per-character outline polygons in step space (matplotlib TextPath)."""
    from matplotlib.font_manager import FontProperties  # noqa: PLC0415
    from matplotlib.textpath import TextPath  # noqa: PLC0415

    prop = FontProperties(weight="bold")
    scale = (height_mm * STEPS_PER_MM) / 100.0
    spacing = int(spacing_mm * STEPS_PER_MM)
    out = []
    cur_x = x
    for ch in text:
        if ch == " ":
            cur_x += int(height_mm * STEPS_PER_MM * 0.5) + spacing
            continue
        tp = TextPath((0, 0), ch, prop=prop, size=100)
        polys = [
            [(int(cur_x + px * scale), int(baseline + py * scale)) for px, py in poly]
            for poly in tp.to_polygons()
            if len(poly)
        ]
        out.append((polys, cur_x))
        if polys:
            xs = [p[0] for poly in polys for p in poly]
            cur_x += (max(xs) - min(xs)) + spacing
        else:
            cur_x += int(height_mm * STEPS_PER_MM * 0.6) + spacing
    return out


def hatch_fill(t: Turtle, polys: List[List[Point]], spacing: int, inset: int = 27):
    """Even-odd scanline fill with serpentine direction alternation."""
    if not polys:
        return
    ys = [py for poly in polys for _, py in poly]
    y0 = ((min(ys) + spacing // 2) // spacing) * spacing
    ltr = True
    for y in range(y0, max(ys) + 1, spacing):
        xs = []
        for poly in polys:
            n = len(poly)
            for i in range(n):
                x1, y1 = poly[i]
                x2, y2 = poly[(i + 1) % n]
                if y1 == y2:
                    continue
                if y1 > y2:
                    x1, y1, x2, y2 = x2, y2, x1, y1
                if y1 < y <= y2:
                    xs.append(x1 + (y - y1) / (y2 - y1) * (x2 - x1))
        xs.sort()
        for i in range(0, len(xs) - 1, 2):
            sx, ex = int(xs[i] + inset), int(xs[i + 1] - inset)
            if ex <= sx:
                continue
            a, b = ((ex, y), (sx, y)) if not ltr else ((sx, y), (ex, y))
            t.travel(*a)
            t.pen_down()
            t.stroke(*b)
        ltr = not ltr


def draw_text(t: Turtle, text: str, x: int, baseline: int, height_mm: float,
              spacing_mm: float, color0: int, fill: bool = True):
    color = color0
    for polys, _ in text_outlines(text, x, baseline, height_mm, spacing_mm):
        selected = False
        for pts in polys:
            if len(pts) < 2:
                continue
            t.travel(*pts[0])
            if not selected:
                t.sb.select_color(color)
                selected = True
            t.pen_down()
            for p in pts[1:]:
                t.stroke(*p)
            t.stroke(*pts[0])
            t.pen_up()
        if fill and polys:
            hatch_fill(t, polys, spacing=40)
        color = (color + 1) % 4


def tap_matrix(t: Turtle, x: int, y: int, w: int, h: int, cols: int, rows: int, margin: int, color: int):
    """Serpentine tap grid starting from the nearest corner."""
    xs = [int(x + margin + c * (w - 2 * margin) / max(1, cols - 1)) for c in range(cols)]
    ys = [int(y + margin + r * (h - 2 * margin) / max(1, rows - 1)) for r in range(rows)]
    top_first = abs(t.y - ys[0]) <= abs(t.y - ys[-1])
    rows_iter = list(range(rows)) if top_first else list(reversed(range(rows)))
    ltr_first = abs(t.x - xs[0]) <= abs(t.x - xs[-1])
    t.travel(xs[0 if ltr_first else -1], ys[rows_iter[0]])
    t.sb.select_color(color)
    for i, r in enumerate(rows_iter):
        ltr = ltr_first if i % 2 == 0 else not ltr_first
        for c in range(cols) if ltr else reversed(range(cols)):
            t.travel(xs[c], ys[r])
            t.tap()


# ------------------------------- assembly -------------------------------


def generate_demo(output: str = "demo_stream.bin") -> bytes:
    prof = MotionProfile(
        steps_per_mm=STEPS_PER_MM,
        invert_y=True,
        div_start=25,
        div_fast=12,
        profile="triangle",
        travel_div_fast=10,
        corner_deg=85.0,
        corner_div=25,
        corner_window_steps=300,
    )
    sb = StreamEmitter()
    t = Turtle(sb, prof)

    margin = int(10 * STEPS_PER_MM)
    left, top = margin, margin
    right = CANVAS_W - margin

    draw_text(t, "OmniRevolve", left + int(10 * STEPS_PER_MM), top + int(240 * STEPS_PER_MM), 20.0, 5.0, 0)
    draw_text(t, "Plotter Demo", left + int(10 * STEPS_PER_MM), top + int(200 * STEPS_PER_MM), 20.0, 5.0, 3)

    sine = sine_pts(left, right, top + int(45 * STEPS_PER_MM), int(12 * STEPS_PER_MM), 8, 300)
    for c in range(4):
        group = [sine[p * 300 : (p + 1) * 300] for p in range(8) if p % 4 == c]
        draw_group(t, group, c)

    draw_quarters(t, circle_pts(left + int(45 * STEPS_PER_MM), top + int(95 * STEPS_PER_MM), int(30 * STEPS_PER_MM)), 0)
    tri = [
        (left + int(60 * STEPS_PER_MM), top + int(160 * STEPS_PER_MM)),
        (left + int(110 * STEPS_PER_MM), top + int(160 * STEPS_PER_MM)),
        (left + int(85 * STEPS_PER_MM), top + int(120 * STEPS_PER_MM)),
        (left + int(60 * STEPS_PER_MM), top + int(160 * STEPS_PER_MM)),
    ]
    tri_dense: List[Point] = []
    for (ax, ay), (bx, by) in zip(tri[:-1], tri[1:]):
        for i in range(150):
            u = i / 149
            tri_dense.append((int(ax + (bx - ax) * u), int(ay + (by - ay) * u)))
    draw_quarters(t, tri_dense, 2)

    rx, ry = left + int(110 * STEPS_PER_MM), top + int(70 * STEPS_PER_MM)
    rw, rh = int(80 * STEPS_PER_MM), int(50 * STEPS_PER_MM)
    draw_quarters(t, rect_pts(rx, ry, rw, rh), 1)
    tap_matrix(t, rx, ry, rw, rh, 9, 7, int(8 * STEPS_PER_MM), 1)

    data = sb.finish()
    Path(output).write_bytes(data)
    Path(output).with_suffix(".json").write_text(
        json.dumps(
            {
                "canvas_steps": {"width": CANVAS_W, "height": CANVAS_H},
                "steps_per_mm": STEPS_PER_MM,
                "invert_y": True,
                "bytes": len(data),
            },
            indent=2,
        )
    )
    print(f"Demo stream saved: {output} ({len(data)} bytes)")
    return data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Generate the A4 plotter demo stream")
    ap.add_argument("-o", "--output", default="demo_stream.bin")
    args = ap.parse_args(argv)
    generate_demo(args.output)


if __name__ == "__main__":
    main()
