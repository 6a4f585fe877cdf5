"""[14] Stream preview: launch the simulator on plot_stream.bin
(reference 14_preview_stream.py).

Canvas size comes from stream_meta.json when present, else
``target_*_mm × steps_per_mm`` (the reference probes a ``steps_per_mm`` key
its loader never admits, so it is effectively the default 40).  Headless
environments (or ``PLOTWEAVE_PREVIEW_PNG``) render a PNG instead of the
interactive window.

Copy of ``plotweave/stages/s14_preview_stream.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os

from ..config import PipelineConfig
from ..utils import load_json
from ..viz.simulator import DEFAULT_PALETTE, print_stats, render_stream, run_interactive


def run(cfg: PipelineConfig) -> None:
    stream_path = os.path.join(cfg.output_dir, "plot_stream.bin")
    if not os.path.exists(stream_path):
        raise SystemExit(f"[preview] ERROR: stream file not found: {stream_path}")

    meta_path = os.path.join(cfg.output_dir, "stream_meta.json")
    if os.path.exists(meta_path):
        meta = load_json(meta_path)
        W, H = meta.get("canvas_steps", [8400, 11880])
        invert_y = bool(meta.get("invert_y", True))
    else:
        W = int(cfg.target_width_mm * cfg.steps_per_mm)
        H = int(cfg.target_height_mm * cfg.steps_per_mm)
        invert_y = True

    data = open(stream_path, "rb").read()

    headless = os.environ.get("PLOTWEAVE_PREVIEW_PNG") or not os.environ.get("DISPLAY")
    if headless:
        out = os.environ.get("PLOTWEAVE_PREVIEW_PNG") or os.path.join(cfg.output_dir, "stream_preview.png")
        img, dec = render_stream(data, W, H, invert_y=invert_y, palette=DEFAULT_PALETTE)
        import cv2  # noqa: PLC0415

        cv2.imwrite(out, img)
        print(f"[preview] headless render saved: {out}")
        print_stats(dec)
    else:
        rgb = [(r, g, b) for (b, g, r) in DEFAULT_PALETTE]
        run_interactive(data, W, H, invert_y, rgb)
