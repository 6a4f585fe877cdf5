"""[13] Stream build: vector_manifest.json + per-layer ops.pkl →
plot_stream.bin + plot_stream.json (reference 13_build_stream.py).

Pixel coords (top-left origin) map to plotter steps (bottom-left origin) via
clamp + ``y → H-1-y``.  Color remap precedence: ENV overrides
(STREAM_FORCE_COLOR_INDEX / STREAM_COLOR_ORDER) → force index → by-name →
by-order → manifest index, all masked &7 (13:107-156).  The stream begins
with a pen-up at (0,0) and — deliberately — NO initial speed byte (13:247-250;
the alternative creator differs here).

Copy of ``plotweave/stages/s13_build_stream.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Tuple

import numpy as np

from ..config import PipelineConfig
from ..stream import MotionProfile
from ..stream.emitter import StreamEmitter
from ..utils import load_json, load_pickle, save_json
from .common import target_size_px


def motion_profile(cfg: PipelineConfig) -> MotionProfile:
    return MotionProfile(
        steps_per_mm=float(cfg.pixels_per_mm),
        invert_y=True,
        div_start=int(cfg.draw_div_start),
        div_fast=int(cfg.draw_div_fast),
        profile=str(cfg.draw_profile),
        corner_deg=float(cfg.corner_deg),
        corner_div=int(cfg.corner_div),
        corner_window_steps=int(cfg.corner_window_steps),
        travel_div_fast=int(cfg.travel_div_fast),
    )


def to_steps(x: float, y: float, W: int, H: int) -> Tuple[int, int]:
    xi = max(0, min(W - 1, int(round(x))))
    yi = max(0, min(H - 1, int(round(y))))
    return xi, H - 1 - yi


def _mask7(v) -> int:
    try:
        return int(v) & 7
    except (TypeError, ValueError):
        return 0


def resolve_color_maps(cfg: PipelineConfig):
    force = cfg.stream_force_color_index
    force = _mask7(force) if force is not None else None
    by_name = (
        {str(k): _mask7(v) for k, v in cfg.stream_color_by_name.items()}
        if isinstance(cfg.stream_color_by_name, dict)
        else None
    )
    by_order = (
        [_mask7(v) for v in cfg.stream_color_by_order]
        if isinstance(cfg.stream_color_by_order, (list, tuple)) and cfg.stream_color_by_order
        else None
    )
    env_force = os.environ.get("STREAM_FORCE_COLOR_INDEX")
    if env_force is not None:
        force = _mask7(env_force)
    env_order = os.environ.get("STREAM_COLOR_ORDER")
    if env_order:
        by_order = [_mask7(v) for v in env_order.split(",")]
    print(f"[stream] color maps: force={force} by_name={by_name} by_order={by_order}")
    return force, by_name, by_order


def pick_color(name: str, orig: int, ordinal: int, force, by_name, by_order) -> int:
    if force is not None:
        return force
    if by_name and name in by_name:
        return by_name[name]
    if by_order:
        return by_order[ordinal % len(by_order)]
    return _mask7(orig)


def emit_layer(
    sb: StreamEmitter,
    ops: List[Dict[str, Any]],
    color_idx: int,
    W: int,
    H: int,
    prof: MotionProfile,
    pos: Tuple[int, int],
) -> Tuple[int, int]:
    """Emit one layer: approach first op, select color, then lines/taps
    (13:179-227)."""
    if ops:
        first = ops[0]
        if first["type"] == "tap":
            target = to_steps(first["x"], first["y"], W, H)
        else:
            q = np.asarray(first["points"]).reshape(-1, 2).astype(np.float64)
            target = to_steps(q[0, 0], q[0, 1], W, H)
        if pos != target:
            sb.travel(pos[0], pos[1], target[0], target[1], prof)
            pos = target

    sb.select_color(color_idx)

    for op in ops:
        if op["type"] == "tap":
            t = to_steps(op["x"], op["y"], W, H)
            if pos != t:
                sb.pen_up()
                sb.travel(pos[0], pos[1], t[0], t[1], prof)
                pos = t
            sb.tap()
            continue

        pts = np.asarray(op["points"]).reshape(-1, 2).astype(np.float64)
        if len(pts) < 2:
            continue
        start = to_steps(pts[0, 0], pts[0, 1], W, H)
        if pos != start:
            sb.pen_up()
            sb.travel(pos[0], pos[1], start[0], start[1], prof)
            pos = start
        sb.pen_down()
        steps = [to_steps(x, y, W, H) for x, y in pts]
        sb.polyline(steps, prof)
        sb.pen_up()
        pos = steps[-1]

    return pos


def build_stream(cfg: PipelineConfig) -> bytes:
    W, H = target_size_px(cfg)
    prof = motion_profile(cfg)

    man_path = os.path.join(cfg.output_dir, "vector_manifest.json")
    if not os.path.exists(man_path):
        raise SystemExit(f"Missing manifest: {man_path}")
    man = load_json(man_path)
    if man.get("coords") not in (None, "pixel_top_left"):
        raise SystemExit("Unsupported coordinates in manifest; expected pixel_top_left")
    ms = man.get("image_size")
    if not (isinstance(ms, (list, tuple)) and len(ms) == 2 and int(ms[0]) == W and int(ms[1]) == H):
        print(f"[stream] WARN: manifest size {ms} != target {W}x{H}")

    force, by_name, by_order = resolve_color_maps(cfg)

    sb = StreamEmitter()
    sb.pen_up()
    pos = (0, 0)
    total_lines = total_taps = 0

    for ordinal, entry in enumerate(man.get("layers", [])):
        cname = str(entry.get("color_name", entry.get("name", "unknown")))
        pkl = os.path.join(cfg.output_dir, entry["file"])
        if not os.path.exists(pkl):
            raise SystemExit(f"Missing layer file: {pkl}")
        ops = load_pickle(pkl)
        cidx = pick_color(cname, int(entry.get("color_index", 0)), ordinal, force, by_name, by_order)
        print(f"[stream] layer#{ordinal + 1} '{cname}': color {entry.get('color_index', 0)} → {cidx} | ops={len(ops)}")
        total_lines += sum(1 for o in ops if o["type"] == "line")
        total_taps += sum(1 for o in ops if o["type"] == "tap")
        pos = emit_layer(sb, ops, cidx, W, H, prof, pos)

    data = sb.finish()
    dst = os.path.join(cfg.output_dir, "plot_stream.bin")
    with open(dst, "wb") as f:
        f.write(data)
    save_json(
        {
            "target_steps": {"width": W, "height": H},
            "bytes": len(data),
            "lines": total_lines,
            "taps": total_taps,
        },
        os.path.join(cfg.output_dir, "plot_stream.json"),
    )
    print(f"Stream saved: {dst} ({len(data)} bytes, lines={total_lines}, taps={total_taps})")
    return data


def run(cfg: PipelineConfig) -> None:
    build_stream(cfg)
