"""Image color analysis + marker recommendations (working equivalent of the
reference's non-runnable analyze_colors.py — its palette import is missing
from its repo).

Clusters non-white pixels (deterministic k-means), buckets hues, recommends
marker colors from the shipped palette with coverage weighting and Lab
near-duplicate suppression; writes ``<stem>_colors.json`` and an optional
matplotlib overview panel.

Copy of ``plotweave/tools/analyze_colors.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import colorsys
import json
import os
from typing import List

import numpy as np

from ..ops.kmeans import kmeans
from ..utils.devices import add_raster_device_flag
from .palette import MarkerPalette

HUE_BUCKETS = [
    ("red", 345, 15),
    ("orange", 15, 45),
    ("yellow", 45, 70),
    ("green", 70, 165),
    ("cyan", 165, 200),
    ("blue", 200, 255),
    ("violet", 255, 290),
    ("magenta", 290, 345),
]


def hue_histogram(rgb_pixels: np.ndarray) -> dict:
    """Fractions of (chromatic) pixels per named hue bucket."""
    r, g, b = rgb_pixels[:, 0] / 255.0, rgb_pixels[:, 1] / 255.0, rgb_pixels[:, 2] / 255.0
    mx = np.maximum(np.maximum(r, g), b)
    mn = np.minimum(np.minimum(r, g), b)
    sat = np.where(mx > 0, (mx - mn) / np.maximum(mx, 1e-9), 0.0)
    chromatic = sat > 0.15
    if not chromatic.any():
        return {name: 0.0 for name, *_ in HUE_BUCKETS}
    hue = np.array(
        [colorsys.rgb_to_hsv(rr, gg, bb)[0] * 360 for rr, gg, bb in rgb_pixels[chromatic][:20000] / 255.0]
    )
    out = {}
    for name, lo, hi in HUE_BUCKETS:
        if lo > hi:  # wraps 360
            frac = float(((hue >= lo) | (hue < hi)).mean())
        else:
            frac = float(((hue >= lo) & (hue < hi)).mean())
        out[name] = round(frac, 4)
    return out


def analyze(image_path: str, k: int = 6, sample_limit: int = 50_000, n_recommend: int = 4,
            device: str = "auto") -> dict:
    import cv2  # noqa: PLC0415

    img = cv2.imread(image_path)
    if img is None:
        raise FileNotFoundError(image_path)
    rgb = img[:, :, ::-1].reshape(-1, 3)

    non_white = rgb[(rgb < 250).any(axis=1)]
    if len(non_white) == 0:
        non_white = rgb
    centers, labels = kmeans(non_white.astype(np.float32), k, sample_limit=sample_limit, device=device)
    counts = np.bincount(labels, minlength=k)
    coverage = counts / counts.sum()

    palette = MarkerPalette()
    recs = palette.recommend(np.clip(centers, 0, 255), coverage, n=n_recommend)

    return {
        "image": os.path.basename(image_path),
        "clusters": [
            {
                "rgb": [int(v) for v in np.clip(np.rint(c), 0, 255)],
                "coverage": round(float(cov), 4),
            }
            for c, cov in sorted(zip(centers, coverage), key=lambda t: -t[1])
        ],
        "hue_histogram": hue_histogram(non_white[:: max(1, len(non_white) // 50000)]),
        "recommended_markers": [
            {"name": m.name, "rgb": list(m.rgb), "coverage": round(cov, 4)} for m, cov in recs
        ],
    }


def save_panel(image_path: str, result: dict, out_path: str) -> None:
    """4-panel overview: image, cluster swatches, hue histogram, markers."""
    import matplotlib

    matplotlib.use("Agg")
    import cv2  # noqa: PLC0415
    import matplotlib.pyplot as plt  # noqa: PLC0415

    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    axes[0, 0].imshow(cv2.imread(image_path)[:, :, ::-1])
    axes[0, 0].set_title("image")
    axes[0, 0].axis("off")

    clusters = result["clusters"]
    axes[0, 1].bar(
        range(len(clusters)),
        [c["coverage"] for c in clusters],
        color=[np.array(c["rgb"]) / 255 for c in clusters],
    )
    axes[0, 1].set_title("clusters (coverage)")

    hh = result["hue_histogram"]
    axes[1, 0].bar(range(len(hh)), list(hh.values()))
    axes[1, 0].set_xticks(range(len(hh)), list(hh.keys()), rotation=45)
    axes[1, 0].set_title("hue buckets")

    recs = result["recommended_markers"]
    axes[1, 1].bar(
        range(len(recs)),
        [r["coverage"] for r in recs],
        color=[np.array(r["rgb"]) / 255 for r in recs],
    )
    axes[1, 1].set_xticks(range(len(recs)), [r["name"] for r in recs], rotation=30)
    axes[1, 1].set_title("recommended markers")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def main(argv: List[str] = None) -> None:
    ap = argparse.ArgumentParser(description="Analyze image colors and recommend marker pens")
    ap.add_argument("image")
    ap.add_argument("-k", "--clusters", type=int, default=6)
    ap.add_argument("-n", "--recommend", type=int, default=4)
    ap.add_argument("--panel", help="save a matplotlib overview PNG")
    add_raster_device_flag(ap)
    args = ap.parse_args(argv)

    result = analyze(args.image, k=args.clusters, n_recommend=args.recommend, device=args.raster_device or "auto")
    out = os.path.splitext(args.image)[0] + "_colors.json"
    with open(out, "w", encoding="utf-8") as f:
        json.dump(result, f, indent=2)
    print(f"Analysis saved: {out}")
    for r in result["recommended_markers"]:
        print(f"  marker: {r['name']:<12} rgb={tuple(r['rgb'])} coverage={r['coverage']:.1%}")
    if args.panel:
        save_panel(args.image, result, args.panel)
        print(f"Panel saved: {args.panel}")


if __name__ == "__main__":
    main()
