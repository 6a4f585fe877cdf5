"""[01] Input resize: cap the longest side at max_dimension → resized.png
(twin of ``plotweave/stages/s01_resize.py``; the resize runs on the host)."""

from __future__ import annotations

import os

import torch

from ..config import PipelineConfig
from ..utils import read_image, register_device_artifact, write_image
from ..utils.devices import raster_device


def run(cfg: PipelineConfig) -> None:
    import cv2  # noqa: PLC0415

    cfg.ensure_output_dirs()
    img = read_image(cfg.input_image)
    h, w = img.shape[:2]
    m = max(h, w)
    # cv2.resize is the byte-exactness contract (reference 01_resize.py:20)
    if m > cfg.max_dimension:
        scale = cfg.max_dimension / m
        out = cv2.resize(img, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_AREA)
        print(f"Resizing: {w}x{h} -> {out.shape[1]}x{out.shape[0]}")
    else:
        out = img
        print(f"No resize required: {w}x{h}")
    dst = os.path.join(cfg.output_dir, "resized.png")
    # only kmeans_init="device" takes the image on the raster device (stage 02
    # fetches it); the host-exact mode reads host pixels and uploads its packed
    # masks itself, so nothing is uploaded then
    if str(cfg.kmeans_init).lower() == "device" and str(cfg.extraction_mode).lower() != "swatch":
        out_dev = torch.from_numpy(out).to(raster_device(cfg))
        write_image(dst, out)
        register_device_artifact(dst, out_dev)
    else:
        write_image(dst, out)
    print(f"Saved: {dst}")
