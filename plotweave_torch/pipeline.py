"""Pipeline runner + CLI of the port: ``python -m plotweave_torch <img> --output DIR``.

``STEPS``, ``MAX_STEP``, :func:`missing_for_step` (the preflight table),
:func:`load_preset`, :func:`stage_clock` and the batch runner
(:func:`run_pipeline_batch`, ``--batch-dir``) follow ``plotweave/pipeline.py``;
presets are the port's own (``plotweave_torch/presets/<name>.json``).  Every
step runs the port's stage module (``plotweave_torch/stages``); the port
imports nothing of ``plotweave``.  ``--profile DIR`` writes a
``torch.profiler`` trace of the run.
"""

from __future__ import annotations

import argparse
import contextlib
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


# Optional per-stage wall-clock collector: sums stage seconds across ALL
# images and threads of a run (the batch runner's steady-state profile).
# Install with stage_clock(); costs one test per stage when uninstalled.
_STAGE_CLOCK: dict | None = None
_STAGE_CLOCK_LOCK = threading.Lock()


@contextlib.contextmanager
def stage_clock():
    """Collect {stage_module: summed_wall_seconds} for every stage executed
    (by any thread) inside the context."""
    global _STAGE_CLOCK
    d: dict = {}
    with _STAGE_CLOCK_LOCK:
        if _STAGE_CLOCK is not None:
            raise RuntimeError("a stage_clock is already installed")
        _STAGE_CLOCK = d
    try:
        yield d
    finally:
        with _STAGE_CLOCK_LOCK:
            _STAGE_CLOCK = None


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
            if _STAGE_CLOCK is not None:
                with _STAGE_CLOCK_LOCK:
                    if _STAGE_CLOCK is not None:
                        _STAGE_CLOCK[module] = _STAGE_CLOCK.get(module, 0.0) + times[module]
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


def run_pipeline_batch(
    cfgs: List[PipelineConfig],
    start_step: int = 1,
    end_step: int = 13,
    workers: int = 0,
    mesh_dp: bool | None = None,
    devices=None,
) -> List[float]:
    """Throughput mode for many images: each image runs the full pipeline; a
    host thread pool overlaps one image's host-side stages (tracing, dedup,
    stream emission, PNG encodes) with the device work of the others.  The
    per-image fused 02→04 chain calls additionally rendezvous into grouped
    chain calls over a mesh ``data`` axis (``parallel/batchrun.py``): a group
    is split over the axis's devices, one call each, so one upload, one
    launch sequence and one download a device carry every image of the
    group.  ``mesh_dp`` None = whenever there is more than one image.
    ``devices`` (the data axis; it may name one card twice) defaults to the
    CUDA cards, or the CPU pool when every image asks for
    ``raster_device: "cpu"``; an image whose raster device is not on the
    mesh's platform runs its chain alone.  Images are independent, so
    outputs are byte-for-byte the same as sequential runs.  An image that
    fails is reported and does not stop the others.  Returns per-image wall
    seconds, -1.0 for a failed image."""
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

    from .parallel.mesh import default_devices, make_mesh  # noqa: PLC0415

    devs: list = []
    if (mesh_dp is None or mesh_dp) and len(cfgs) > 1:
        cpu = all(str(c.raster_device).lower() == "cpu" for c in cfgs)
        devs = list(devices) if devices is not None else default_devices("cpu" if cpu else "cuda")
    ndev = len(devs)
    if not workers:
        # enough concurrent submitters to fill the data axis, or a useful one-device group
        workers = min(len(cfgs), max(4, ndev)) if ndev else min(4, max(1, len(cfgs)))

    batcher = None
    if ndev:
        from .parallel.batchrun import DeviceBatcher, batcher_ctx  # noqa: PLC0415

        batcher = DeviceBatcher(make_mesh((ndev,), ("data",), devices=devs), workers, len(cfgs))
        print(f"[batch] mesh data-parallelism over {ndev} device(s)")

    def one(cfg: PipelineConfig) -> float:
        t0 = time.perf_counter()
        try:
            run_pipeline(cfg, start_step, end_step)
        except Exception as e:  # noqa: BLE001 — isolate failures per image
            print(
                f"[batch] FAILED {cfg.input_image}: {type(e).__name__}: {e}",
                file=sys.stderr,
                flush=True,
            )
            return -1.0
        finally:
            if batcher is not None:
                batcher.image_finished()
        return time.perf_counter() - t0

    def run_all() -> List[float]:
        if workers == 1 or len(cfgs) == 1:
            return [one(c) for c in cfgs]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(one, cfgs))

    if batcher is None:
        return run_all()
    with batcher_ctx(batcher):
        times = run_all()
    print(
        f"[batch] grouped: {batcher.n_batched_images} image chain(s) in "
        f"{batcher.n_dispatches} grouped call(s)"
    )
    return times


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
    ap.add_argument(
        "--shard-rows",
        type=int,
        dest="shard_rows",
        help="row-shard the stage 02-04 raster chain over up to N devices (fitted to the "
        "largest row divisor <= device count: the CUDA cards, or with --raster-device cpu the "
        "CPU pool that --xla_force_host_platform_device_count in XLA_FLAGS sets; one device runs "
        "the unsharded chain, byte-identical; more than one card is not ported)",
    )
    ap.add_argument(
        "--batch-dir",
        help="process every image in this directory (one <output>/<stem>/ run each, "
        "host threads overlapping device work); ignores input_image",
    )
    ap.add_argument("--workers", type=int, default=0, help="batch mode: host worker threads (default min(4, n))")
    ap.add_argument(
        "--profile",
        metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR (a Chrome trace, open with "
        "Perfetto) in addition to the per-stage wall-clock lines",
    )
    return ap.parse_args(argv)


@contextlib.contextmanager
def _profiled(trace_dir: str | None, name: str):
    """A ``torch.profiler`` trace of the block (host, and the card where there
    is one) written to ``<trace_dir>/<name>.json``; nothing where
    ``trace_dir`` is empty."""
    if not trace_dir:
        yield
        return
    import torch  # noqa: PLC0415
    from torch.profiler import ProfilerActivity, profile  # noqa: PLC0415

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(trace_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    print(f"[profile] trace written to {path}")


def _main_batch(args, base: PipelineConfig, overrides: dict) -> None:
    exts = {".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tif", ".tiff"}
    images = sorted(
        os.path.join(args.batch_dir, f)
        for f in os.listdir(args.batch_dir)
        if os.path.splitext(f)[1].lower() in exts
    )
    if not images:
        print(f"error: no images in {args.batch_dir}", file=sys.stderr)
        sys.exit(2)
    # photo.png + photo.jpg must not share an output dir (concurrent runs
    # would clobber each other's artifacts): disambiguate duplicate stems
    stems = {}
    cfgs = []
    for img in images:
        stem = os.path.splitext(os.path.basename(img))[0]
        if stem in stems:
            stems[stem] += 1
            stem = f"{stem}_{stems[stem]}"
            print(f"[batch] note: duplicate stem; {os.path.basename(img)} → {stem}/")
        else:
            stems[stem] = 1
        out = os.path.join(args.output_dir, stem)
        os.makedirs(out, exist_ok=True)
        ov = dict(overrides, input_image=img, output_dir=out)
        cfg_file = save_config(base, os.path.join(out, "config.json"), ov)
        cfgs.append(load_config(cfg_file))
    print(f"Batch: {len(images)} images → {args.output_dir} ({args.workers or min(4, len(images))} workers)")
    if args.end_step > 13:
        print("[batch] note: stage 14 (interactive stream preview) is skipped in batch mode")
    t0 = time.perf_counter()
    # one trace spanning the whole batch: worker threads show up as separate
    # host tracks, the device lanes show how well they overlap
    with _profiled(args.profile, "batch"):
        times = run_pipeline_batch(cfgs, args.start_step, min(args.end_step, 13), workers=args.workers)
    wall = time.perf_counter() - t0
    ok = [t for t in times if t >= 0]
    failed = [img for img, t in zip(images, times) if t < 0]
    print(
        f"\nBatch done: {len(ok)}/{len(images)} images in {wall:.1f}s wall "
        f"({wall / max(1, len(images)):.2f}s/image; per-image sum {sum(ok):.1f}s)"
    )
    if failed:
        for img in failed:
            print(f"  failed: {img}", file=sys.stderr)
        sys.exit(1)


def main(argv=None) -> Dict[str, float] | None:
    """The CLI; returns :func:`run_pipeline`'s per-stage wall seconds (None
    in batch mode)."""
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
        "shard_rows": args.shard_rows,
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

    if args.batch_dir:
        overrides.pop("input_image", None)
        overrides.pop("output_dir", None)
        _main_batch(args, base, overrides)
        return None

    cfg_file = save_config(base, os.path.join(args.output_dir, "config.json"), overrides)
    print("Config saved to", cfg_file)
    cfg = load_config(cfg_file)

    print("=" * 50)
    print("PLOTWEAVE_TORCH — RASTER → PLOTTER STREAM")
    print("=" * 50)
    print("Input image:", cfg.input_image)
    print("Output dir: ", cfg.output_dir)
    with _profiled(args.profile, "run"):
        times = run_pipeline(cfg, args.start_step, args.end_step, on_error="exit")
    print("\nDone.")
    return times


if __name__ == "__main__":
    main()
