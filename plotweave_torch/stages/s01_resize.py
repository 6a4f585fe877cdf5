"""[01] Input resize: cap the longest side at max_dimension → resized.png
(twin of ``plotweave/stages/s01_resize.py``, host resize only)."""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..utils import read_image, write_image


def run(cfg: PipelineConfig) -> None:
    import cv2  # noqa: PLC0415

    cfg.ensure_output_dirs()
    img = read_image(cfg.input_image)
    h, w = img.shape[:2]
    m = max(h, w)
    # cv2.resize is the byte-exactness contract (reference 01_resize.py:20);
    # the host-exact stage 02 reads host pixels, so nothing is uploaded here
    if m > cfg.max_dimension:
        scale = cfg.max_dimension / m
        out = cv2.resize(img, (int(w * scale), int(h * scale)), interpolation=cv2.INTER_AREA)
        print(f"Resizing: {w}x{h} -> {out.shape[1]}x{out.shape[0]}")
    else:
        out = img
        print(f"No resize required: {w}x{h}")
    dst = os.path.join(cfg.output_dir, "resized.png")
    write_image(dst, out)
    print(f"Saved: {dst}")
