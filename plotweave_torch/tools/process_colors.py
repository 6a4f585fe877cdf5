"""One-hot color-layer splitter (reference image_processor/process_colors.py):
quantize an image to a palette (adaptive k-means or a palette JSON from
analyze_colors) and write the label map + per-color binary masks.
Copy of ``plotweave/tools/process_colors.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..ops.kmeans import kmeans
from ..utils.devices import add_raster_device_flag


def split_layers(image_path: str, out_dir: str, k: int = 6, palette_json: str = None, device: str = "auto") -> dict:
    import cv2  # noqa: PLC0415

    img = cv2.imread(image_path)
    if img is None:
        raise FileNotFoundError(image_path)
    os.makedirs(out_dir, exist_ok=True)
    h, w = img.shape[:2]
    rgb = img[:, :, ::-1].reshape(-1, 3).astype(np.float32)

    if palette_json:
        with open(palette_json, "r", encoding="utf-8") as f:
            pal = json.load(f)
        entries = pal.get("recommended_markers") or pal.get("clusters") or []
        centers = np.array([e["rgb"] for e in entries], np.float32)
        names = [e.get("name", f"c{i}") for i, e in enumerate(entries)]
        d2 = (
            np.sum(rgb * rgb, axis=1, keepdims=True)
            - 2.0 * rgb @ centers.T
            + np.sum(centers * centers, axis=1)
        )
        labels = np.argmin(d2, axis=1).astype(np.int32)
    else:
        centers, labels = kmeans(rgb, k, device=device)
        names = [f"c{i}" for i in range(len(centers))]

    labels2d = labels.reshape(h, w)
    cv2.imwrite(os.path.join(out_dir, "labels.png"), (labels2d * (255 // max(1, len(centers) - 1))).astype(np.uint8))
    np.save(os.path.join(out_dir, "labels.npy"), labels2d)

    palette_out = {
        "colors": [
            {"name": n, "rgb": [int(v) for v in np.clip(np.rint(c), 0, 255)], "pixels": int((labels == i).sum())}
            for i, (n, c) in enumerate(zip(names, centers))
        ]
    }
    with open(os.path.join(out_dir, "palette.json"), "w", encoding="utf-8") as f:
        json.dump(palette_out, f, indent=2)

    for i, n in enumerate(names):
        mask = (labels2d == i).astype(np.uint8) * 255
        cv2.imwrite(os.path.join(out_dir, f"layer_{i}_{n.replace(' ', '_')}.png"), mask)

    return palette_out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Split an image into one-hot color layers")
    ap.add_argument("image")
    ap.add_argument("-o", "--out-dir", default="layers_out")
    ap.add_argument("-k", "--clusters", type=int, default=6)
    ap.add_argument("--palette", help="palette JSON from analyze_colors")
    add_raster_device_flag(ap)
    args = ap.parse_args(argv)
    pal = split_layers(args.image, args.out_dir, args.clusters, args.palette, args.raster_device or "auto")
    for c in pal["colors"]:
        print(f"  {c['name']:<12} rgb={tuple(c['rgb'])} pixels={c['pixels']}")


if __name__ == "__main__":
    main()
