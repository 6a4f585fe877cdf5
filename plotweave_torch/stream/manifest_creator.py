"""Alternative manifest-driven stream creator (legacy layer format).

Consumes the older manifest layout where each layer pickle holds
``{"contours": [{"points": ...}], "taps": [{"x","y"}], "color_name",
"color_idx"}``; layers are emitted sorted by color index and the stream opens
with an explicit pen-up + initial speed byte — unlike the stage-13 builder
(reference shared/omnirevolve_plotter_stream_creator.py:93-178; the
initial-speed difference is at :126 vs 13_build_stream.py:247-250).

Copy of ``plotweave/stream/manifest_creator.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import json
import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .emitter import StreamEmitter
from .encoder import MotionProfile


@dataclass
class Layer:
    color_name: str
    color_index: int
    contours: List[np.ndarray] = field(default_factory=list)  # (N,2) int32 step coords
    taps: List[Tuple[int, int]] = field(default_factory=list)


def _to_steps(x: float, y: float, invert_y: bool, w: int, h: int) -> Tuple[int, int]:
    xi, yi = int(round(x)), int(round(y))
    if invert_y:
        yi = h - 1 - yi
    return max(0, min(w - 1, xi)), max(0, min(h - 1, yi))


def load_layers(manifest_path: Path, invert_y: bool, w: int, h: int) -> List[Layer]:
    manifest = json.loads(manifest_path.read_text(encoding="utf-8"))
    base = manifest_path.parent
    layers: List[Layer] = []
    for entry in manifest.get("layers", []):
        f = base / entry["file"]
        if not f.exists():
            print(f"Warning: missing layer file: {f}")
            continue
        data = pickle.loads(f.read_bytes())
        layer = Layer(
            color_name=str(data.get("color_name", entry.get("color_name", "unknown"))),
            color_index=int(data.get("color_idx", entry.get("color_index", 0))),
        )
        for item in data.get("contours", []):
            pts = np.asarray(item["points"]).reshape(-1, 2).astype(np.float64)
            if len(pts) >= 2:
                steps = np.array([_to_steps(x, y, invert_y, w, h) for x, y in pts], np.int32)
                layer.contours.append(steps)
        for t in data.get("taps", []):
            layer.taps.append(_to_steps(float(t["x"]), float(t["y"]), invert_y, w, h))
        layers.append(layer)
    layers.sort(key=lambda L: L.color_index)
    return layers


def build(manifest_path: Path, output: Path, w: int, h: int, prof: MotionProfile) -> bytes:
    sb = StreamEmitter()
    sb.pen_up()
    sb.speed(prof.div_start)  # explicit initial speed (creator:126)

    layers = load_layers(manifest_path, prof.invert_y, w, h)
    pos: Tuple[int, int] = (0, 0)

    for L in layers:
        first: Optional[Tuple[int, int]] = None
        if L.contours:
            first = (int(L.contours[0][0, 0]), int(L.contours[0][0, 1]))
        elif L.taps:
            first = L.taps[0]
        if first and pos != first:
            sb.travel(pos[0], pos[1], first[0], first[1], prof)
            pos = first
        sb.select_color(L.color_index)

        for cs in L.contours:
            start = (int(cs[0, 0]), int(cs[0, 1]))
            if pos != start:
                sb.pen_up()
                sb.travel(pos[0], pos[1], start[0], start[1], prof)
                pos = start
            sb.pen_down()
            pts = [(int(x), int(y)) for x, y in cs]
            sb.polyline(pts, prof)
            sb.pen_up()
            pos = pts[-1]

        for t in L.taps:
            if pos != t:
                sb.pen_up()
                sb.travel(pos[0], pos[1], t[0], t[1], prof)
                pos = t
            sb.tap()

    data = sb.finish()
    output.write_bytes(data)
    output.with_suffix(".json").write_text(
        json.dumps(
            {
                "target_steps": {"width": w, "height": h},
                "config": dict(prof.__dict__),
                "stats": {
                    "layers": len(layers),
                    "contours": sum(len(L.contours) for L in layers),
                    "taps": sum(len(L.taps) for L in layers),
                },
                "bytes": len(data),
                "manifest": str(manifest_path),
            },
            indent=2,
        )
    )
    print(f"Stream saved: {output} ({len(data)} bytes)")
    return data


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Build a stream from a legacy vector manifest")
    ap.add_argument("manifest")
    ap.add_argument("-o", "--output", default="plot_stream.bin")
    ap.add_argument("--target-width-steps", type=int, default=8400)
    ap.add_argument("--target-height-steps", type=int, default=11880)
    ap.add_argument("--steps-per-mm", type=float, default=40.0)
    ap.add_argument("--invert-y", type=int, default=1)
    ap.add_argument("--div-start", type=int, default=28)
    ap.add_argument("--div-fast", type=int, default=15)
    args = ap.parse_args(argv)
    prof = MotionProfile(
        steps_per_mm=args.steps_per_mm,
        invert_y=bool(args.invert_y),
        div_start=args.div_start,
        div_fast=args.div_fast,
    )
    build(Path(args.manifest), Path(args.output), args.target_width_steps, args.target_height_steps, prof)


if __name__ == "__main__":
    main()
