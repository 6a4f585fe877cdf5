"""CLI: SVG → G-code → plotter stream (+ optional headless preview).

In-process orchestration of the stage chain the reference runs as three
subprocesses (svg_to_stream/svg2stream.py:200-324).

Copy of ``plotweave/frontends/svg2stream.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..stream import MotionProfile
from .gcode import gcode_to_stream
from .svg2gcode import convert as svg_to_gcode_text


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="SVG → G-code → plotter stream")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="stream_from_svg.bin")
    ap.add_argument("--gcode-out", help="also save the intermediate G-code")
    ap.add_argument("--page-width-mm", type=float, default=210.0)
    ap.add_argument("--page-height-mm", type=float, default=297.0)
    ap.add_argument("--margin-mm", type=float, default=10.0)
    ap.add_argument("--steps-per-mm", type=float, default=40.0)
    ap.add_argument("--samples-per-unit", type=float, default=0.5)
    ap.add_argument("--color-index", type=int, default=3)
    ap.add_argument("--invert-y", type=int, default=1)
    ap.add_argument("--speed-scale", type=float, default=1.0)
    ap.add_argument("--no-reorder", action="store_true")
    ap.add_argument("--preview", help="render a PNG preview of the stream")
    ap.add_argument("--sampling-backend", choices=["numpy", "torch"], default="numpy",
                    help="curve-sampling backend (see svg2gcode --help)")
    ap.add_argument("--sampling-device", choices=["auto", "cpu"], default="auto",
                    help="torch backend: auto = the CUDA card; cpu = the plain version")
    args = ap.parse_args(argv)

    svg_text = Path(args.input).read_text(encoding="utf-8", errors="ignore")
    gcode = svg_to_gcode_text(
        svg_text, args.page_width_mm, args.page_height_mm, args.margin_mm,
        args.samples_per_unit, sampling_backend=args.sampling_backend,
        sampling_device=args.sampling_device,
    )
    if args.gcode_out:
        Path(args.gcode_out).write_text(gcode, encoding="utf-8")

    cw = int(round(args.page_width_mm * args.steps_per_mm))
    ch = int(round(args.page_height_mm * args.steps_per_mm))
    prof = MotionProfile(steps_per_mm=args.steps_per_mm, invert_y=bool(args.invert_y))
    data, info = gcode_to_stream(
        gcode,
        steps_per_mm=args.steps_per_mm,
        canvas_w=cw,
        canvas_h=ch,
        invert_y=bool(args.invert_y),
        color_index=args.color_index,
        reorder=not args.no_reorder,
        profile=prof,
        speed_scale=args.speed_scale,
    )
    Path(args.output).write_bytes(data)
    meta = {"canvas_steps": [cw, ch], "invert_y": bool(args.invert_y), **info}
    Path(args.output).with_suffix(".json").write_text(json.dumps(meta, indent=2))
    print(f"Stream saved: {args.output} ({info['bytes']} bytes, paths={info['polylines_steps']})")

    if args.preview:
        import cv2  # noqa: PLC0415

        from ..viz.simulator import DEFAULT_PALETTE, print_stats, render_stream  # noqa: PLC0415

        img, dec = render_stream(data, cw, ch, invert_y=bool(args.invert_y), palette=DEFAULT_PALETTE)
        cv2.imwrite(args.preview, img)
        print(f"Preview saved: {args.preview}")
        print_stats(dec)


if __name__ == "__main__":
    main()
