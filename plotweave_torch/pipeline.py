"""Pipeline runner + CLI of the port: ``python -m plotweave_torch <img> --output DIR``.

The step titles, the preflight table, presets and the config save/load are
the JAX package's (``plotweave.pipeline`` and ``plotweave.config`` import no
jax).  Each step runs the port's stage module where there is one
(``plotweave_torch/stages``) and the shared ``plotweave.stages`` module
otherwise; ``plotweave.pipeline.stage_runner`` is not used, since it would
import the JAX stage modules.
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
from typing import Dict

from plotweave.config import PipelineConfig, load_config, save_config
from plotweave.pipeline import MAX_STEP, STEPS, load_preset, missing_for_step
from plotweave.utils.io import flush_pending_saves

from .utils.devices import add_raster_device_flag

# stages with a module in plotweave_torch/stages; the rest are shared as they are
PORTED = frozenset({
    "s01_resize", "s02_color_extract", "s03_edge_detect", "s04_vectorize",
    "s07_sort", "s08_dedup_intra", "s12_plot_order",
})


def stage_module(module_name: str):
    package = "plotweave_torch.stages" if module_name in PORTED else "plotweave.stages"
    return importlib.import_module(f"{package}.{module_name}")


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
    ap.add_argument("--preset", help="named config preset (plotweave/presets/<name>.json) or a JSON path")
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
