"""CLI: G-code → SVG polyline rendering for quick inspection
(reference svg_to_stream/gcode2svg.py: pen-down paths in mm, Y-down,
configurable display scale).

Copy of ``plotweave/frontends/gcode2svg.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .gcode import parse_polylines_mm


def gcode_to_svg(
    text: str,
    scale: float = 3.0,
    stroke: str = "black",
    stroke_width: float = 0.5,
    margin_px: int = 10,
) -> str:
    """Reference geometry semantics (gcode2svg.py:146-184): bbox-normalized,
    ``(v - min) * scale + margin`` per axis, Y-down, %.2f coordinates,
    canvas ``int(extent_mm * scale) + 2 * margin``."""
    paths, _ = parse_polylines_mm(text)
    if not paths:
        return '<svg xmlns="http://www.w3.org/2000/svg" width="100" height="100"></svg>\n'
    xs = [x for p in paths for x, _ in p]
    ys = [y for p in paths for _, y in p]
    min_x, min_y = min(xs), min(ys)
    w = int((max(xs) - min_x) * scale) + 2 * margin_px
    h = int((max(ys) - min_y) * scale) + 2 * margin_px
    lines = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" '
        f'viewBox="0 0 {w} {h}">',
        f'<g fill="none" stroke="{stroke}" stroke-width="{stroke_width}">',
    ]
    for p in paths:
        pts = " ".join(
            f"{(x - min_x) * scale + margin_px:.2f},{(y - min_y) * scale + margin_px:.2f}"
            for x, y in p
        )
        lines.append(f'<polyline points="{pts}"/>')
    lines += ["</g>", "</svg>"]
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Render plotter G-code as an SVG")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="out.svg")
    ap.add_argument("--scale", type=float, default=3.0)
    ap.add_argument("--stroke", default="black")
    ap.add_argument("--stroke-width", type=float, default=0.5)
    ap.add_argument("--margin-px", type=int, default=10)
    args = ap.parse_args(argv)
    text = Path(args.input).read_text(encoding="utf-8", errors="ignore")
    Path(args.output).write_text(
        gcode_to_svg(text, args.scale, args.stroke, args.stroke_width, args.margin_px)
    )
    print(f"SVG saved: {args.output}")


if __name__ == "__main__":
    main()
