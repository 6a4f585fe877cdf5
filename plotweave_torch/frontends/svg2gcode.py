"""CLI: SVG → page-fitted G-code (reference svg_to_stream/svg2gcode.py,
reimplemented without the unavailable ``svg_to_gcode`` package: native parse
+ batched curve sampling + bbox fit into page-minus-margins).

Copy of ``plotweave/frontends/svg2gcode.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from .svg import fit_to_page, fit_viewbox_to_page, polylines_to_gcode, svg_to_polylines, svg_viewbox


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Convert SVG to page-fitted plotter G-code")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="out.gcode")
    ap.add_argument("--page-width-mm", type=float, default=210.0)
    ap.add_argument("--page-height-mm", type=float, default=297.0)
    ap.add_argument("--margin-mm", type=float, default=10.0)
    ap.add_argument("--samples-per-unit", type=float, default=0.5,
                    help="curve sampling density in points per SVG user unit")
    ap.add_argument("--no-fit", action="store_true", help="keep raw SVG coordinates")
    ap.add_argument(
        "--fit-mode",
        choices=["bbox", "viewbox"],
        default="bbox",
        help="fit by content bounding box (default) or by the document viewBox frame",
    )
    ap.add_argument(
        "--sampling-backend",
        choices=["numpy", "torch"],
        default="numpy",
        help="curve-sampling backend: numpy float64 (default, byte-contract) "
        "or kernel K14 on --sampling-device (float32; last-ulp geometry "
        "differences possible)",
    )
    ap.add_argument("--sampling-device", choices=["auto", "cpu"], default="auto",
                    help="torch backend: auto = the CUDA card (raises without one); cpu = the plain version")
    return ap


def convert(
    svg_text: str,
    page_w: float = 210.0,
    page_h: float = 297.0,
    margin: float = 10.0,
    samples_per_unit: float = 0.5,
    fit: bool = True,
    fit_mode: str = "bbox",
    sampling_backend: str = "numpy",
    sampling_device: str = "auto",
) -> str:
    if sampling_backend == "torch":
        from ..ops.bezier import BezierSampler  # noqa: PLC0415
        xp = BezierSampler(sampling_device)
    else:
        import numpy as xp  # noqa: PLC0415
    polys = svg_to_polylines(svg_text, samples_per_unit, xp=xp)
    if fit:
        vb = svg_viewbox(svg_text) if fit_mode == "viewbox" else None
        if fit_mode == "viewbox" and vb is not None:
            polys = fit_viewbox_to_page(polys, vb, page_w, page_h, margin)
        else:
            polys = fit_to_page(polys, page_w, page_h, margin)
    return polylines_to_gcode(polys)


def main(argv=None) -> None:
    import sys
    import xml.etree.ElementTree as ET

    args = build_argparser().parse_args(argv)
    svg_text = Path(args.input).read_text(encoding="utf-8", errors="ignore")
    try:
        gcode = convert(
            svg_text,
            args.page_width_mm,
            args.page_height_mm,
            args.margin_mm,
            args.samples_per_unit,
            fit=not args.no_fit,
            fit_mode=args.fit_mode,
            sampling_backend=args.sampling_backend,
            sampling_device=args.sampling_device,
        )
    except ET.ParseError as e:
        print(f"error: {args.input} is not valid SVG/XML: {e}", file=sys.stderr)
        sys.exit(2)
    Path(args.output).write_text(gcode, encoding="utf-8")
    n_paths = gcode.count("M3")
    print(f"G-code saved: {args.output} ({n_paths} paths)")


if __name__ == "__main__":
    main()
