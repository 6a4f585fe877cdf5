"""Pipeline runner + CLI of the port: ``python -m plotweave_torch <img> --output DIR``.

``STEPS``, ``MAX_STEP``, :func:`missing_for_step` (the preflight table) and
:func:`load_preset` are copied from ``plotweave/pipeline.py``; presets are
the port's own (``plotweave_torch/presets/<name>.json``).  Every step runs
the port's stage module (``plotweave_torch/stages``); the port imports
nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, Tuple

from .config import PipelineConfig, load_config, save_config
from .utils.devices import add_raster_device_flag
from .utils.io import flush_pending_saves

STEPS: List[Tuple[str, str]] = [
    ("Image resize", "s01_resize"),
    ("Color extraction", "s02_color_extract"),
    ("Edge detection", "s03_edge_detect"),
    ("Vectorization", "s04_vectorize"),
    ("Scale vectors", "s05_scale"),
    ("Scaled vector preview", "s06_preview_scaled"),
    ("Sort contours", "s07_sort"),
    ("Intra-layer dedup", "s08_dedup_intra"),
    ("Preview after intra-dedup", "s09_preview_intra"),
    ("Cross-layer dedup", "s10_dedup_cross"),
    ("Final preview", "s11_preview_cross"),
    ("Optimize plot order", "s12_plot_order"),
    ("Build stream", "s13_build_stream"),
    ("Preview stream", "s14_preview_stream"),
]
MAX_STEP = len(STEPS)


def stage_module(module_name: str):
    return importlib.import_module(f"plotweave_torch.stages.{module_name}")


def missing_for_step(step_idx: int, outdir: str, color_names: List[str]) -> List[str]:
    """Expected-but-missing artifacts when starting at ``step_idx`` (1-based);
    prerequisite table per reference pipeline.py:114-145."""
    need: List[str] = []
    J = os.path.join
    if step_idx >= 2:
        need.append(J(outdir, "resized.png"))
    if step_idx >= 3:
        need += [J(outdir, c, "mask.png") for c in color_names]
    if step_idx >= 4:
        need += [J(outdir, c, "edges.png") for c in color_names]
    if step_idx >= 5:
        need += [J(outdir, c, "contours.pkl") for c in color_names]
    if step_idx >= 6:
        need += [J(outdir, c, "contours_scaled.pkl") for c in color_names]
    if step_idx >= 8:
        need += [J(outdir, c, "contours_sorted.pkl") for c in color_names]
    if step_idx >= 9:
        need += [J(outdir, c, "lines_intra.pkl") for c in color_names]
    if step_idx >= 11:
        need += [J(outdir, c, "lines_cross.pkl") for c in color_names]
    if step_idx >= 12:
        need += [J(outdir, c, "taps_cross.pkl") for c in color_names]
    if step_idx >= 13:
        need.append(J(outdir, "vector_manifest.json"))
    if step_idx >= 14:
        need.append(J(outdir, "plot_stream.bin"))
    return [p for p in need if not os.path.exists(p)]


def load_preset(name: str) -> dict:
    """Config overrides for a named preset (plotweave_torch/presets/<name>.json)
    or an explicit JSON path."""
    path = name
    if not os.path.isfile(path):
        path = os.path.join(os.path.dirname(__file__), "presets", f"{name}.json")
    if not os.path.isfile(path):
        avail = sorted(
            os.path.splitext(f)[0]
            for f in os.listdir(os.path.join(os.path.dirname(__file__), "presets"))
            if f.endswith(".json")
        )
        raise SystemExit(f"unknown preset {name!r}; available: {', '.join(avail)}")
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


# The steps the current run_pipeline call will run (1-based), per thread:
# stage 02 fuses stages 03/04's raster work into its chain when both follow.
_CHAIN = threading.local()


def chain_hint() -> frozenset:
    return getattr(_CHAIN, "steps", frozenset())


def run_pipeline(cfg: PipelineConfig, start_step: int = 1, end_step: int = MAX_STEP,
                 on_error: str = "raise") -> Dict[str, float]:
    """Run stages [start_step, end_step] in-process; returns each stage
    module's wall seconds."""
    s0 = max(1, min(start_step, MAX_STEP))
    s1 = max(1, min(end_step, MAX_STEP))
    if s0 > s1:
        s0, s1 = s1, s0

    missing = missing_for_step(s0, cfg.output_dir, list(cfg.color_names))
    if missing:
        print("\n[Preflight] Warning: missing inputs for the chosen start step:")
        for p in missing:
            print(" -", p)
        print("The step may fail; consider starting earlier.\n")

    # the write-behind writer keys its errors by absolute path and its flush
    # scope matches by prefix: resolve symlinks once, so both sides agree
    cfg = dataclasses.replace(cfg, output_dir=os.path.realpath(cfg.output_dir))
    times: Dict[str, float] = {}
    _CHAIN.steps = frozenset(range(s0, s1 + 1))
    try:
        for i in range(s0 - 1, s1):
            title, module = STEPS[i]
            print(f"\n[{i + 1}/{MAX_STEP}] {title}…", flush=True)
            t0 = time.perf_counter()
            try:
                stage_module(module).run(cfg)
            except Exception:
                if on_error == "raise":
                    raise
                import traceback  # noqa: PLC0415

                traceback.print_exc()
                print(f"Error in step {i + 1} ({module})", file=sys.stderr)
                sys.exit(1)
            times[module] = time.perf_counter() - t0
            print(f"[{i + 1}/{MAX_STEP}] done in {times[module]:.2f}s", flush=True)
    finally:
        _CHAIN.steps = frozenset()
        # write-behind barrier: every queued artifact dump is on disk before
        # the runner returns
        in_flight = sys.exc_info()[0] is not None
        try:
            flush_pending_saves(cfg.output_dir)
        except Exception:
            if not in_flight:
                raise
            import traceback  # noqa: PLC0415

            traceback.print_exc()
    return times


def run_pipeline_batch(*_args, **_kwargs):
    raise NotImplementedError(
        "the batch runner is not ported to plotweave_torch yet (ROADMAP.md, Queue 1: batch runner)"
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="plotweave_torch",
        description="Raster → plotter-stream pipeline (PyTorch / CUDA port)",
    )
    ap.add_argument("input_image", nargs="?", help="Input raster image")
    ap.add_argument("--output", dest="output_dir", help="Output directory")
    ap.add_argument("--config", dest="config_path", help="Existing config.json to load")
    ap.add_argument("--preset", help="named config preset (plotweave_torch/presets/<name>.json) or a JSON path")
    ap.add_argument("--start-step", type=int, default=1, help=f"1..{MAX_STEP}")
    ap.add_argument("--end-step", type=int, default=MAX_STEP, help=f"1..{MAX_STEP}")
    ap.add_argument("--pixels-per-mm", type=int, dest="pixels_per_mm")
    ap.add_argument("--target-width-mm", type=int, dest="target_width_mm")
    ap.add_argument("--target-height-mm", type=int, dest="target_height_mm")
    ap.add_argument("--colors", dest="colors_json", help="BGR swatches as JSON, e.g. [[0,0,0],[255,0,0]]")
    add_raster_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None) -> Dict[str, float]:
    """The CLI; returns :func:`run_pipeline`'s per-stage wall seconds."""
    args = parse_args(argv)
    if not args.output_dir:
        print("error: --output is required", file=sys.stderr)
        sys.exit(2)
    os.makedirs(args.output_dir, exist_ok=True)

    base = load_config(args.config_path) if args.config_path else PipelineConfig()
    overrides = {
        "input_image": args.input_image,
        "output_dir": args.output_dir,
        "pixels_per_mm": args.pixels_per_mm,
        "target_width_mm": args.target_width_mm,
        "target_height_mm": args.target_height_mm,
        "raster_device": args.raster_device,
    }
    if args.colors_json:
        try:
            overrides["colors"] = json.loads(args.colors_json)
        except json.JSONDecodeError as e:
            print(f"Failed to parse --colors JSON: {e}", file=sys.stderr)
    if args.preset:
        for k, v in load_preset(args.preset).items():
            if overrides.get(k) is None:  # explicit CLI flags win
                overrides[k] = v

    cfg_file = save_config(base, os.path.join(args.output_dir, "config.json"), overrides)
    print("Config saved to", cfg_file)
    cfg = load_config(cfg_file)

    print("=" * 50)
    print("PLOTWEAVE_TORCH — RASTER → PLOTTER STREAM")
    print("=" * 50)
    print("Input image:", cfg.input_image)
    print("Output dir: ", cfg.output_dir)
    times = run_pipeline(cfg, args.start_step, args.end_step, on_error="exit")
    print("\nDone.")
    return times


if __name__ == "__main__":
    main()
