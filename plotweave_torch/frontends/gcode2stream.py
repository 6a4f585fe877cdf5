"""CLI: G-code → plotter stream (reference svg_to_stream/gcode2stream.py).

Copy of ``plotweave/frontends/gcode2stream.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..stream import MotionProfile
from .gcode import DEFAULT_STEPS_PER_MM, A4_H_MM, A4_W_MM, gcode_to_stream


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Convert G-code to an OmniRevolve plotter stream")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", default="stream_from_gcode.bin")
    ap.add_argument("--target-width-steps", type=int, default=None)
    ap.add_argument("--target-height-steps", type=int, default=None)
    ap.add_argument("--steps-per-mm", type=float, default=DEFAULT_STEPS_PER_MM)
    ap.add_argument("--invert-y", type=int, default=0)
    ap.add_argument("--offset-x-mm", type=float, default=0.0)
    ap.add_argument("--offset-y-mm", type=float, default=0.0)
    ap.add_argument("--scale-x", type=float, default=1.0)
    ap.add_argument("--scale-y", type=float, default=1.0)
    ap.add_argument("--color-index", type=int, default=3)
    ap.add_argument("--div-start", type=int, default=28)
    ap.add_argument("--div-fast", type=int, default=15)
    ap.add_argument("--profile", choices=["triangle", "scurve"], default="triangle")
    ap.add_argument("--corner-deg", type=float, default=85.0)
    ap.add_argument("--corner-div", type=int, default=28)
    ap.add_argument("--corner-window-steps", type=int, default=300)
    ap.add_argument("--travel-div-fast", type=int, default=10)
    ap.add_argument("--travel-start-div", type=int, default=28)
    ap.add_argument("--travel-window-steps", type=int, default=240)
    ap.add_argument("--travel-quant-step", type=int, default=4)
    ap.add_argument("--short-len-steps", type=int, default=120)
    ap.add_argument("--short-div", type=int, default=16)
    ap.add_argument("--speed-scale", type=float, default=1.0)
    ap.add_argument("--no-reorder", action="store_true")
    ap.add_argument("--meta", help="optional JSON sidecar with conversion stats")
    return ap


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    prof = MotionProfile(
        steps_per_mm=args.steps_per_mm,
        invert_y=bool(args.invert_y),
        div_start=args.div_start,
        div_fast=args.div_fast,
        profile=args.profile,
        corner_deg=args.corner_deg,
        corner_div=args.corner_div,
        corner_window_steps=args.corner_window_steps,
        short_len_steps=args.short_len_steps,
        short_div=args.short_div,
        travel_div_fast=args.travel_div_fast,
        travel_start_div=args.travel_start_div,
        travel_window_steps=args.travel_window_steps,
        travel_quant_step=args.travel_quant_step,
    )
    cw = args.target_width_steps or int(round(A4_W_MM * args.steps_per_mm))
    ch = args.target_height_steps or int(round(A4_H_MM * args.steps_per_mm))
    text = Path(args.input).read_text(encoding="utf-8", errors="ignore")
    data, info = gcode_to_stream(
        text,
        steps_per_mm=args.steps_per_mm,
        canvas_w=cw,
        canvas_h=ch,
        invert_y=bool(args.invert_y),
        offset_mm=(args.offset_x_mm, args.offset_y_mm),
        scale=(args.scale_x, args.scale_y),
        color_index=args.color_index,
        reorder=not args.no_reorder,
        profile=prof,
        speed_scale=args.speed_scale,
    )
    Path(args.output).write_bytes(data)
    if args.meta:
        Path(args.meta).write_text(json.dumps(info, indent=2))
    print(f"Stream saved: {args.output} ({info['bytes']} bytes, paths={info['polylines_steps']})")


if __name__ == "__main__":
    main()
