"""Native SVG front-end: parse shapes/paths, sample curves to polylines.

Replaces the reference's dependency on the external ``svg_to_gcode`` package
(svg_to_stream/svg2gcode.py:34-35 — not installable here) with a
self-contained parser supporting the full path grammar
(M/L/H/V/C/S/Q/T/A/Z + relative forms + implicit repeats), basic shapes,
and nested transforms.

Curve sampling is batched: all cubic segments are stacked into one (N, 4, 2)
control tensor and evaluated against a shared t-grid with a single Bernstein
matmul — the "vectorized path sampling" path.  numpy float64 is the default
(and the byte-contract path); ``--sampling-backend torch`` on the svg2gcode /
svg2stream CLIs samples through ``ops.bezier.BezierSampler`` instead (kernel
K14 in float32 on the card — geometry may differ in final ulps, opt-in).

Copy of ``plotweave/frontends/svg.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET
from typing import List, Optional

import numpy as np

Mat = np.ndarray  # 3x3 affine


_NUM = r"[+-]?(?:\d*\.\d+|\d+\.?)(?:[eE][+-]?\d+)?"
_NUM_RE = re.compile(_NUM)
_CMD_RE = re.compile(r"([MmLlHhVvCcSsQqTtAaZz])")
_TRANSFORM_RE = re.compile(r"(matrix|translate|scale|rotate|skewX|skewY)\s*\(([^)]*)\)")


def _floats(s: str) -> List[float]:
    return [float(m) for m in _NUM_RE.findall(s)]


def parse_transform(spec: Optional[str]) -> Mat:
    m = np.eye(3)
    if not spec:
        return m
    for name, args in _TRANSFORM_RE.findall(spec):
        v = _floats(args)
        t = np.eye(3)
        if name == "matrix" and len(v) == 6:
            t = np.array([[v[0], v[2], v[4]], [v[1], v[3], v[5]], [0, 0, 1]])
        elif name == "translate":
            t[0, 2] = v[0] if v else 0.0
            t[1, 2] = v[1] if len(v) > 1 else 0.0
        elif name == "scale":
            t[0, 0] = v[0] if v else 1.0
            t[1, 1] = v[1] if len(v) > 1 else t[0, 0]
        elif name == "rotate":
            a = math.radians(v[0]) if v else 0.0
            r = np.array(
                [[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]]
            )
            if len(v) >= 3:
                c1 = np.eye(3)
                c1[:2, 2] = (v[1], v[2])
                c2 = np.eye(3)
                c2[:2, 2] = (-v[1], -v[2])
                t = c1 @ r @ c2
            else:
                t = r
        elif name == "skewX":
            t[0, 1] = math.tan(math.radians(v[0])) if v else 0.0
        elif name == "skewY":
            t[1, 0] = math.tan(math.radians(v[0])) if v else 0.0
        m = m @ t
    return m


# ------------------------------ curve sampling ------------------------------


def _samples_for(length_estimate: float, per_unit: float, lo: int = 8, hi: int = 128) -> int:
    return int(min(hi, max(lo, math.ceil(length_estimate * per_unit))))


def sample_cubics_batched(ctrl: np.ndarray, n: int, xp=np) -> np.ndarray:
    """(N, 4, 2) control points → (N, n, 2) points via one Bernstein matmul.

    ``xp=numpy`` (default) samples in float64 — the byte-contract path.
    ``xp`` an ``ops.bezier.BezierSampler`` samples in float32 on its torch
    device (K14 on the card)."""
    if xp is not np:
        return xp.sample(ctrl, n)
    dt = xp.float64 if xp is np else None
    t = xp.linspace(0.0, 1.0, n, dtype=dt)[:, None]
    u = 1.0 - t
    B = xp.concatenate([u**3, 3 * u**2 * t, 3 * u * t**2, t**3], axis=1)  # (n, 4)
    return xp.einsum("nk,skc->snc", B, xp.asarray(ctrl))


def sample_quads_batched(ctrl: np.ndarray, n: int, xp=np) -> np.ndarray:
    """(N, 3, 2) quadratic controls → (N, n, 2); dtype contract as cubics."""
    if xp is not np:
        return xp.sample(ctrl, n)
    dt = xp.float64 if xp is np else None
    t = xp.linspace(0.0, 1.0, n, dtype=dt)[:, None]
    u = 1.0 - t
    B = xp.concatenate([u**2, 2 * u * t, t**2], axis=1)
    return xp.einsum("nk,skc->snc", B, xp.asarray(ctrl))


def _arc_to_points(p0, rx, ry, rot_deg, large, sweep, p1, n) -> np.ndarray:
    """SVG elliptical arc → sampled points (endpoint → center conversion per
    the SVG spec's F.6.5)."""
    x0, y0 = p0
    x1, y1 = p1
    if rx == 0 or ry == 0 or (x0 == x1 and y0 == y1):
        return np.array([[x1, y1]])
    rx, ry = abs(rx), abs(ry)
    phi = math.radians(rot_deg)
    cp, sp = math.cos(phi), math.sin(phi)
    dx, dy = (x0 - x1) / 2.0, (y0 - y1) / 2.0
    x1p = cp * dx + sp * dy
    y1p = -sp * dx + cp * dy
    lam = (x1p / rx) ** 2 + (y1p / ry) ** 2
    if lam > 1:
        s = math.sqrt(lam)
        rx *= s
        ry *= s
    num = rx**2 * ry**2 - rx**2 * y1p**2 - ry**2 * x1p**2
    den = rx**2 * y1p**2 + ry**2 * x1p**2
    c = math.sqrt(max(0.0, num / den)) if den else 0.0
    if large == sweep:
        c = -c
    cxp = c * rx * y1p / ry
    cyp = -c * ry * x1p / rx
    cx = cp * cxp - sp * cyp + (x0 + x1) / 2.0
    cy = sp * cxp + cp * cyp + (y0 + y1) / 2.0

    def ang(ux, uy, vx, vy):
        d = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1.0, min(1.0, (ux * vx + uy * vy) / d)))
        return -a if ux * vy - uy * vx < 0 else a

    th1 = ang(1, 0, (x1p - cxp) / rx, (y1p - cyp) / ry)
    dth = ang((x1p - cxp) / rx, (y1p - cyp) / ry, (-x1p - cxp) / rx, (-y1p - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    elif sweep and dth < 0:
        dth += 2 * math.pi
    t = np.linspace(th1, th1 + dth, n)
    xs = cx + rx * np.cos(t) * cp - ry * np.sin(t) * sp
    ys = cy + rx * np.cos(t) * sp + ry * np.sin(t) * cp
    return np.stack([xs, ys], axis=1)[1:]


def parse_path_data(d: str, samples_per_unit: float = 0.5, xp=np) -> List[np.ndarray]:
    """Path data → list of (N, 2) float64 subpaths (curves pre-collected and
    batch-sampled)."""
    tokens = _CMD_RE.split(d)
    subpaths: List[List] = []  # list of list of ("pt",xy) | ("cubic",i) | ("quad",i) | ("arc",arr)
    cubics: List[np.ndarray] = []
    quads: List[np.ndarray] = []

    cur = np.zeros(2)
    start = np.zeros(2)
    prev_cubic_c2: Optional[np.ndarray] = None
    prev_quad_c: Optional[np.ndarray] = None
    path: Optional[List] = None

    def ensure_path():
        nonlocal path
        if path is None:
            path = [("pt", cur.copy())]
            subpaths.append(path)

    i = 1
    while i < len(tokens):
        cmd = tokens[i]
        vals = _floats(tokens[i + 1]) if i + 1 < len(tokens) else []
        i += 2
        rel = cmd.islower()
        C = cmd.upper()

        if C == "M":
            for j in range(0, len(vals), 2):
                p = np.array(vals[j : j + 2])
                cur = cur + p if rel else p
                if j == 0:
                    start = cur.copy()
                    path = [("pt", cur.copy())]
                    subpaths.append(path)
                else:  # implicit lineto
                    path.append(("pt", cur.copy()))
            prev_cubic_c2 = prev_quad_c = None
        elif C == "L":
            ensure_path()
            for j in range(0, len(vals), 2):
                p = np.array(vals[j : j + 2])
                cur = cur + p if rel else p
                path.append(("pt", cur.copy()))
            prev_cubic_c2 = prev_quad_c = None
        elif C in ("H", "V"):
            ensure_path()
            for v in vals:
                if C == "H":
                    cur = np.array([cur[0] + v if rel else v, cur[1]])
                else:
                    cur = np.array([cur[0], cur[1] + v if rel else v])
                path.append(("pt", cur.copy()))
            prev_cubic_c2 = prev_quad_c = None
        elif C in ("C", "S"):
            ensure_path()
            step = 6 if C == "C" else 4
            for j in range(0, len(vals) - step + 1, step):
                if C == "C":
                    c1 = np.array(vals[j : j + 2])
                    c2 = np.array(vals[j + 2 : j + 4])
                    p = np.array(vals[j + 4 : j + 6])
                else:
                    c1 = 2 * cur - prev_cubic_c2 if prev_cubic_c2 is not None else cur.copy()
                    c2 = np.array(vals[j : j + 2])
                    p = np.array(vals[j + 2 : j + 4])
                    if rel:
                        pass  # c1 already absolute
                if rel:
                    if C == "C":
                        c1 = cur + c1
                    c2 = cur + c2
                    p = cur + p
                cubics.append(np.stack([cur, c1, c2, p]))
                path.append(("cubic", len(cubics) - 1))
                prev_cubic_c2 = c2.copy()
                cur = p
            prev_quad_c = None
        elif C in ("Q", "T"):
            ensure_path()
            step = 4 if C == "Q" else 2
            for j in range(0, len(vals) - step + 1, step):
                if C == "Q":
                    c = np.array(vals[j : j + 2])
                    p = np.array(vals[j + 2 : j + 4])
                    if rel:
                        c = cur + c
                        p = cur + p
                else:
                    c = 2 * cur - prev_quad_c if prev_quad_c is not None else cur.copy()
                    p = np.array(vals[j : j + 2])
                    if rel:
                        p = cur + p
                quads.append(np.stack([cur, c, p]))
                path.append(("quad", len(quads) - 1))
                prev_quad_c = c.copy()
                cur = p
            prev_cubic_c2 = None
        elif C == "A":
            ensure_path()
            for j in range(0, len(vals) - 6, 7):
                rx, ry, rot, large, sweep = vals[j : j + 5]
                p = np.array(vals[j + 5 : j + 7])
                if rel:
                    p = cur + p
                est = math.hypot(*(p - cur)) * 2
                pts = _arc_to_points(cur, rx, ry, rot, bool(large), bool(sweep), p, _samples_for(est, samples_per_unit))
                path.append(("arc", pts))
                cur = p
            # handle the final group when len(vals) % 7 == 0
            prev_cubic_c2 = prev_quad_c = None
        elif C == "Z":
            if path is not None:
                path.append(("pt", start.copy()))
                cur = start.copy()
            prev_cubic_c2 = prev_quad_c = None

    # batch-sample all curves (shared t-grid sized by the longest curve);
    # a BezierSampler as xp samples on its torch device (opt-in,
    # --sampling-backend torch — see sample_cubics_batched's dtype note)
    cub_pts = []
    if cubics:
        ctrl = np.stack(cubics)
        lens = np.linalg.norm(np.diff(ctrl, axis=1), axis=2).sum(axis=1)
        n = _samples_for(float(lens.max()), samples_per_unit)
        cub_pts = sample_cubics_batched(ctrl, n, xp=xp)
    quad_pts = []
    if quads:
        ctrl = np.stack(quads)
        lens = np.linalg.norm(np.diff(ctrl, axis=1), axis=2).sum(axis=1)
        n = _samples_for(float(lens.max()), samples_per_unit)
        quad_pts = sample_quads_batched(ctrl, n, xp=xp)
    if isinstance(xp, _Families):  # svg_to_polylines' document route: assembled after its one sampling call
        return (subpaths, cub_pts, quad_pts)
    return _assemble(subpaths, cub_pts, quad_pts)


def _assemble(subpaths, cub_pts, quad_pts) -> List[np.ndarray]:
    """Each subpath's points, a curve's samples after its first point."""

    out: List[np.ndarray] = []
    for sp in subpaths:
        pts: List[np.ndarray] = []
        for kind, v in sp:
            if kind == "pt":
                pts.append(v[None, :])
            elif kind == "cubic":
                pts.append(cub_pts[v][1:])
            elif kind == "quad":
                pts.append(quad_pts[v][1:])
            else:  # arc
                pts.append(v)
        arr = np.concatenate(pts, axis=0)
        if len(arr) >= 2:
            out.append(arr)
    return out


class _Families:
    """The document route's ``xp``: records each curve family and hands back
    its index in the document's table."""

    def __init__(self):
        self.table = []

    def sample(self, ctrl, n):
        self.table.append((ctrl, n))
        return len(self.table) - 1

    def polylines(self, items, sampler) -> List[np.ndarray]:
        pts = sampler.sample_families(self.table)
        out: List[np.ndarray] = []
        for polys, m in items:
            if isinstance(polys, tuple):  # a path's subpaths, its families' indices
                polys = _assemble(polys[0], *(pts[f] if isinstance(f, int) else f for f in polys[1:]))
            for p in polys:
                hp = np.concatenate([p, np.ones((len(p), 1))], axis=1)
                out.append((hp @ m.T)[:, :2])
        return out


# ------------------------------ document parsing ------------------------------

_SVG_NS = "{http://www.w3.org/2000/svg}"


def _local(tag: str) -> str:
    return tag.split("}")[-1]


def svg_to_polylines(svg_text: str, samples_per_unit: float = 0.5, xp=np) -> List[np.ndarray]:
    """Parse an SVG document into transformed (N, 2) polylines (user units).

    ``xp`` an ``ops.bezier.BezierSampler`` runs the batched curve sampling
    on its torch device (opt-in; float32, so sampled geometry may differ in
    the last ulps from the numpy float64 default — not part of the byte
    contract): each path parsed once, the document's curve families sampled
    in one ``sample_families`` call (one launch of K14 on the card), then
    every polyline assembled and transformed in document order."""
    root = ET.fromstring(svg_text)
    out: List[np.ndarray] = []
    families = None if xp is np else _Families()

    def walk(el, mat: Mat):
        m = mat @ parse_transform(el.get("transform"))
        tag = _local(el.tag)
        polys: List[np.ndarray] = []
        if tag == "path" and el.get("d"):
            polys = parse_path_data(el.get("d"), samples_per_unit, xp=xp if families is None else families)
        elif tag == "line":
            polys = [np.array([[float(el.get("x1", 0)), float(el.get("y1", 0))],
                               [float(el.get("x2", 0)), float(el.get("y2", 0))]])]
        elif tag in ("polyline", "polygon"):
            v = _floats(el.get("points", ""))
            if len(v) >= 4:
                p = np.array(v).reshape(-1, 2)
                if tag == "polygon":
                    p = np.vstack([p, p[:1]])
                polys = [p]
        elif tag == "rect":
            x, y = float(el.get("x", 0)), float(el.get("y", 0))
            w, h = float(el.get("width", 0)), float(el.get("height", 0))
            if w > 0 and h > 0:
                polys = [np.array([[x, y], [x + w, y], [x + w, y + h], [x, y + h], [x, y]])]
        elif tag in ("circle", "ellipse"):
            cx, cy = float(el.get("cx", 0)), float(el.get("cy", 0))
            rx = float(el.get("r", el.get("rx", 0)))
            ry = float(el.get("r", el.get("ry", 0)))
            if rx > 0 and ry > 0:
                n = _samples_for(2 * math.pi * max(rx, ry), samples_per_unit, lo=16)
                t = np.linspace(0, 2 * math.pi, n)
                polys = [np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], axis=1)]
        if families is not None:  # transformed after the document's families are sampled
            out.append((polys, m))
            polys = []

        for p in polys:
            hp = np.concatenate([p, np.ones((len(p), 1))], axis=1)
            out.append((hp @ m.T)[:, :2])

        for child in el:
            walk(child, m)

    walk(root, np.eye(3))
    if families is not None:
        return families.polylines(out, xp)
    return out


def svg_viewbox(svg_text: str) -> Optional[tuple]:
    """(x, y, w, h) from the root viewBox, else from width/height, else None."""
    root = ET.fromstring(svg_text)
    vb = root.get("viewBox") or root.get("viewbox")
    if vb:
        parts = vb.replace(",", " ").split()
        if len(parts) == 4:
            try:
                x, y, w, h = (float(p) for p in parts)
                return (x, y, w, h)
            except ValueError:
                pass
    num = re.compile(r"^([+-]?\d*\.?\d+(?:[eE][+-]?\d+)?)")
    try:
        w = float(num.match(root.get("width", "")).group(1))
        h = float(num.match(root.get("height", "")).group(1))
        return (0.0, 0.0, w, h)
    except (AttributeError, ValueError, TypeError):
        return None


def fit_viewbox_to_page(
    polylines: List[np.ndarray],
    viewbox: tuple,
    page_w_mm: float = 210.0,
    page_h_mm: float = 297.0,
    margin_mm: float = 10.0,
) -> List[np.ndarray]:
    """Scale from the document's declared frame (viewBox) rather than the
    content bbox — the reference's alternative fit strategy
    (svg_to_stream/svg2gcode_.py:54-98,280-304).  Content outside the viewBox
    scales along with it."""
    vx, vy, vw, vh = viewbox
    avail_w = max(1e-6, page_w_mm - 2 * margin_mm)
    avail_h = max(1e-6, page_h_mm - 2 * margin_mm)
    s = min(avail_w / max(vw, 1e-9), avail_h / max(vh, 1e-9))
    return [(p - np.array([vx, vy])) * s + margin_mm for p in polylines]


def fit_to_page(
    polylines: List[np.ndarray],
    page_w_mm: float = 210.0,
    page_h_mm: float = 297.0,
    margin_mm: float = 10.0,
) -> List[np.ndarray]:
    """Uniform-scale the set into page-minus-margins, top-left at the margin
    (the reference's bbox-fit strategy, svg2gcode.py:313-340)."""
    if not polylines:
        return []
    allpts = np.concatenate(polylines)
    mn = allpts.min(axis=0)
    mx = allpts.max(axis=0)
    size = np.maximum(mx - mn, 1e-9)
    avail = np.array([page_w_mm - 2 * margin_mm, page_h_mm - 2 * margin_mm])
    s = float(np.min(avail / size))
    return [(p - mn) * s + margin_mm for p in polylines]


def polylines_to_gcode(polylines: List[np.ndarray], decimals: int = 3) -> str:
    """Polylines (mm) → the G0/G1/M3/M5 dialect our G-code parser consumes.

    One native pass renders the whole body (pw_gcode_text: glibc snprintf
    "%.Nf" is the same correctly-rounded ties-to-even fixed-decimal
    conversion as CPython's formatter — tie-fuzz-pinned in test_frontends);
    the numpy fallback formats via np.char.mod ("%.Nf" % x shares
    PyOS_double_to_string with the scalar f"{x:.Nf}").  Both byte-identical
    to the original per-vertex loop; the M3/M5 markers ride the first/last
    vertex line of each polyline."""
    kept = [np.asarray(p, np.float64) for p in polylines if len(p) >= 2]
    if not kept:
        return "G21\nG90\nM5\n"
    lens = np.array([len(p) for p in kept])
    v = np.concatenate(kept, axis=0)
    first = np.zeros(len(v), bool)
    first[np.concatenate([[0], np.cumsum(lens)[:-1]])] = True
    last = np.zeros(len(v), bool)
    last[np.cumsum(lens) - 1] = True

    from ..native.api import gcode_text_native  # noqa: PLC0415

    body = gcode_text_native(v, first, last, decimals)
    if body is None:
        fmt = f"%.{decimals}f"
        xs = np.char.mod(fmt, v[:, 0])
        ys = np.char.mod(fmt, v[:, 1])
        pre = np.where(first, "G0 X", "G1 X")
        suf = np.where(first, "\nM3", np.where(last, "\nM5", ""))
        rows = np.char.add(
            np.char.add(np.char.add(np.char.add(pre, xs), " Y"), ys), suf
        )
        body = "\n".join(rows.tolist()) + "\n"
    return "G21\nG90\nM5\n" + body
