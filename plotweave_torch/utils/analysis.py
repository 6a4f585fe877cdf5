"""Pipeline-output analytics: per-stage stats table, layer compositing,
combined SVG export (capability match for image_processor/utils.py:85-166,
retargeted at the artifact names the current 14-step chain actually writes —
the reference version still referenced legacy filenames).

Copy of ``plotweave/utils/analysis.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig
from ..vector.geometry import as_pts
from .io import load_pickle

STAGE_FILES = [
    ("contours", "contours.pkl"),
    ("scaled", "contours_scaled.pkl"),
    ("sorted", "contours_sorted.pkl"),
    ("intra", "lines_intra.pkl"),
    ("cross", "lines_cross.pkl"),
]


def stage_stats(cfg: PipelineConfig) -> Dict[str, Dict[str, Tuple[int, int]]]:
    """{layer: {stage: (n_polylines, n_vertices)}} over existing artifacts."""
    out: Dict[str, Dict[str, Tuple[int, int]]] = {}
    for name in cfg.color_names:
        d = os.path.join(cfg.output_dir, name)
        row: Dict[str, Tuple[int, int]] = {}
        for stage, fname in STAGE_FILES:
            p = os.path.join(d, fname)
            if os.path.exists(p):
                polys = load_pickle(p)
                row[stage] = (
                    len(polys),
                    sum(int(as_pts(c).shape[0]) for c in polys),
                )
        out[name] = row
    return out


def print_stage_table(cfg: PipelineConfig) -> None:
    stats = stage_stats(cfg)
    stages = [s for s, _ in STAGE_FILES]
    header = f"{'layer':<14}" + "".join(f"{s:>18}" for s in stages)
    print(header)
    print("-" * len(header))
    for name, row in stats.items():
        cells = []
        for s in stages:
            if s in row:
                n, v = row[s]
                cells.append(f"{n:>6}/{v:<10}")
            else:
                cells.append(f"{'—':>18}")
        print(f"{name:<14}" + "".join(f"{c:>18}" for c in cells))


def combine_layers_to_image(
    cfg: PipelineConfig,
    stage_file: str = "lines_cross.pkl",
    size_wh: Optional[Tuple[int, int]] = None,
    thickness: int = 1,
) -> np.ndarray:
    """Rasterize all layers' polylines of one stage into a single BGR image."""
    import cv2  # noqa: PLC0415

    from ..stages.common import palette_bgr, target_size_px  # noqa: PLC0415

    w, h = size_wh or target_size_px(cfg)
    img = np.full((h, w, 3), 255, np.uint8)
    colors = palette_bgr(cfg)
    for name in cfg.color_names:
        p = os.path.join(cfg.output_dir, name, stage_file)
        if not os.path.exists(p):
            continue
        for poly in load_pickle(p):
            arr = as_pts(poly).reshape(-1, 1, 2).astype(np.int32)
            if len(arr) >= 2:
                cv2.polylines(img, [arr], False, colors[name], thickness, cv2.LINE_8)
    return img


def export_combined_svg(
    cfg: PipelineConfig,
    out_path: str,
    stage_file: str = "lines_cross.pkl",
    stroke_width: float = 1.0,
) -> str:
    """Write all layers' polylines of one stage as a grouped SVG."""
    from ..stages.common import palette_bgr, target_size_px  # noqa: PLC0415

    w, h = target_size_px(cfg)
    colors = palette_bgr(cfg)
    parts: List[str] = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{w}" height="{h}" viewBox="0 0 {w} {h}">'
    ]
    for name in cfg.color_names:
        p = os.path.join(cfg.output_dir, name, stage_file)
        if not os.path.exists(p):
            continue
        b, g, r = colors[name]
        parts.append(f'<g id="{name}" fill="none" stroke="rgb({r},{g},{b})" stroke-width="{stroke_width}">')
        for poly in load_pickle(p):
            pts = as_pts(poly)
            if len(pts) >= 2:
                coords = " ".join(f"{x},{y}" for x, y in pts)
                parts.append(f'<polyline points="{coords}"/>')
        parts.append("</g>")
    parts.append("</svg>")
    svg = "\n".join(parts) + "\n"
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(svg)
    return out_path


def main(argv=None) -> None:
    """CLI: print the per-stage stats table for a pipeline output directory."""
    import argparse

    from ..config import load_config

    ap = argparse.ArgumentParser(description="Per-stage artifact statistics")
    ap.add_argument("output_dir")
    ap.add_argument("--svg", help="also export the combined SVG to this path")
    args = ap.parse_args(argv)
    cfg = load_config(f"{args.output_dir}/config.json")
    cfg.output_dir = args.output_dir
    print_stage_table(cfg)
    if args.svg:
        export_combined_svg(cfg, args.svg)
        print(f"combined SVG: {args.svg}")


if __name__ == "__main__":
    main()
