#!/usr/bin/env python3
"""Smoke test of plotweave_torch on one CUDA card: ``python3 chip_smoke.py``.

Run from the root of a checkout.  It builds the hand-written kernels from the
sources, checks each against its plain PyTorch version on the card, runs the
stage 02→04 chain, the fused raster front-end and the main path, image →
``plot_stream.bin``, on the card and on the CPU, and fails on any mismatch.
Phases:

1. probe: torch / CUDA / card / nvcc / OpenCV / g++;
2. build the kernels with nvcc, one library per source, all at once (K2
   packed morphology, K5 hysteresis, K6 packed Zhang–Suen, K7 Lab + nearest
   centre, K12 dense Zhang–Suen), and the shared native host library with g++;
3. each kernel vs its plain version on the card: K5, K6 and K2 byte-equal on
   seeded random boards, K6 and K12 against ``tests/golden/thinning_cases.npz``,
   K12 byte-equal to its plain version and to K6, K7 over all 2^24 BGR colours
   with the near-tie rule;
4. ``chain_from_clean`` at 4 × 1500 × 2000 on the card vs on the CPU, with
   device times (CUDA events) of the chain, K5 and K6 and their plain versions;
5. ``plotweave_torch.pipeline.main`` steps 1–13 on a seeded synthetic
   2000 × 1500 image and on the four configs of ``tests/golden/e2e``, with
   ``--raster-device auto`` (the card) and ``cpu``; every mask.png,
   edges.png, contours.pkl and plot_stream.bin must be byte-equal, and the
   card run must launch the main path's kernels (K2, K5, K6);
6. ``raster_frontend`` on a seeded 2000 × 1500 image, k = 4, through both
   thinning routes on the card and on the CPU: labels by the near-tie rule,
   edges and skeletons byte-equal from the same labels, with device times
   of each route and of K2, K7 and K12 beside their plain versions;
7. ``plotweave_torch.entry.entry("auto")`` once.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the repo
beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
E2E_CONFIGS = ["base_cfg.json", "base_cfg2.json", "cfg3_8layers.json", "cfg4_gray1layer.json"]
E2E_REFS = ["ref_artifacts.tar.gz", "ref_artifacts2.tar.gz", "ref_artifacts3.tar.gz", "ref_artifacts4.tar.gz"]
CHAIN_SHAPE = (4, 1500, 2000)  # layers, H, W: the default max_dimension, 4 layers
EDGE_PARAMS = (3, 1, 1, 5, 22, 70)  # (mk, oi, ci, bk, lo, hi): the default config's
FRONTEND_SHAPE = (1500, 2000)  # H, W: bench.py --frontend's image size
BENCH_CENTERS = [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]]  # bench.py:509-511
NEAR_TIE = 0.01  # a label may differ only where the two nearest centres are this close (float64)
MAIN_PATH_KERNELS = ("morph_bits", "hysteresis", "zhang_suen_packed")  # K2, K5, K6


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max().item()) if a.numel() else 0


def synthetic_image(seed: int, h: int, w: int):
    """A seeded BGR poster: four palette tones over smooth curved regions,
    discs and mild noise (numpy only)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = np.zeros((h, w), np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(1.0, 6.0, 2) * 2 * np.pi / np.array([h, w])
        field += np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi)).astype(np.float32)
    for _ in range(40):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(15, 120)
        field[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(-4, 4)
    bins = np.digitize(field, np.quantile(field, [0.25, 0.5, 0.75]))
    palette = np.array([[30, 25, 20], [70, 90, 190], [140, 175, 220], [225, 220, 215]], np.int16)
    img = palette[bins] + rng.integers(-6, 7, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8), bins


def random_boards(rng, k: int, h: int, w: int):
    """Seeded (k, h, w) binary images: blobs and strokes thick enough to thin."""
    import numpy as np

    x = rng.random((k, h + 4, w + 4)) < rng.uniform(0.3, 0.6)
    # a 3×3 majority vote grows the noise into connected blobs
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return (s[:, 2 : h + 2, 2 : w + 2] >= 5).astype(np.uint8) * 255


def near_tie_flips(img, centers, got, ref, what: str) -> int:
    """Count the labels that differ; fail unless each is a near tie (the
    float64 distances of its two nearest centres differ by <= NEAR_TIE)."""
    from plotweave_torch.ops.frontend import nearest_gaps

    diff = (got.cpu() != ref.cpu()).numpy()
    if not diff.any():
        return 0
    gap = float(nearest_gaps(img.cpu().numpy()[diff], centers).max())
    check(gap <= NEAR_TIE, f"{what}: {int(diff.sum())} labels differ, largest float64 gap {gap} > {NEAR_TIE}")
    print(f"  {what}: {int(diff.sum())} near-tie flips, largest float64 gap {gap:.6f}")
    return int(diff.sum())


def phase_probe() -> dict:
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "plotweave_torch").is_dir() or not (ROOT / "plotweave").is_dir():
        fail(f"run from the root of a plotweave checkout (no packages beside {__file__})")
    sys.path.insert(0, str(ROOT))
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    from plotweave_torch.ops.kernels import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import cv2

        print("cv2:", cv2.__version__)
    except ImportError:
        fail("OpenCV (cv2) is missing: the host stages of the main path need it")
    print("g++:", shutil.which("g++") or "absent (the native library falls back to Python)")
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from plotweave.native.loader import get_lib
    from plotweave_torch.ops import kernels

    t0 = time.perf_counter()
    paths = kernels.build()
    for name in paths:
        kernels.load(name)
    print(f"built {len(paths)} libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(str(p.relative_to(ROOT)) for p in paths.values()))
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    # the shared host library (g++), built here so that no timed stage pays for it
    t0 = time.perf_counter()
    print(f"native host library: {'loaded' if get_lib() is not None else 'absent'} "
          f"in {time.perf_counter() - t0:.1f} s")


def phase_kernels_vs_plain() -> None:
    import numpy as np
    import torch

    from plotweave_torch.ops.canny import canny_candidates, hysteresis_plain
    from plotweave_torch.ops.kernels import hysteresis_cuda, zhang_suen_packed_cuda
    from plotweave_torch.ops.thinning import pack_bitboards, unpack_bitboards, zhang_suen_packed_plain

    dev = torch.device("cuda")
    z = np.load(GOLDEN / "thinning_cases.npz")
    n_cases = len([f for f in z.files if f.startswith("edges_")])
    for t in range(n_cases):
        edges = torch.from_numpy(z[f"edges_{t}"]).to(dev)
        for key, rotated, it in ((f"skel04_{t}", True, 120), (f"skel08_{t}", False, 48)):
            got = unpack_bitboards(zhang_suen_packed_cuda(pack_bitboards(edges), it, rotated), edges.shape[-1])
            check(np.array_equal(got.cpu().numpy(), z[key].astype(np.int32)), f"K6 vs golden {key}")
    print(f"K6 == thinning_cases.npz: {n_cases} cases x 2 rings")

    rng = np.random.default_rng(7)
    shapes = [(1, 1, 40), (1, 37, 33), (2, 64, 31), (3, 100, 95), (5, 50, 257), (8, 73, 130), (4, 200, 1)]
    for k, h, w in shapes:
        x = torch.from_numpy(random_boards(rng, k, h, w)).to(dev)
        b = pack_bitboards(x)
        for rotated, it in ((True, 120), (False, 48), (True, 2)):  # it=2 stops at max_iter
            ref = zhang_suen_packed_plain(b, it, rotated)
            check(torch.equal(zhang_suen_packed_cuda(b, it, rotated), ref), f"K6 {k}x{h}x{w} rot={rotated} it={it}")
        cand, strong = canny_candidates(x, 20, 60)
        check(torch.equal(hysteresis_cuda(cand, strong), hysteresis_plain(cand, strong)), f"K5 {k}x{h}x{w}")
    # long weak chains: hysteresis needs many chunks of sweeps
    cand = torch.full((2, 300, 4), -1, dtype=torch.int32, device=dev)
    strong = torch.zeros_like(cand)
    strong[0, 0, 0] = 1
    check(torch.equal(hysteresis_cuda(cand, strong), hysteresis_plain(cand, strong)), "K5 long chain")
    print(f"K6 == plain, K5 == plain: {len(shapes)} random shapes (k 1-8, ragged W, H=1, max_iter hit)")


def phase_new_kernels_vs_plain(stats: dict) -> None:
    """K2, K12 and K7 against their plain versions on the card."""
    import numpy as np
    import torch

    from plotweave_torch.ops.frontend import assign_nearest_plain
    from plotweave_torch.ops.kernels import (
        assign_nearest_cuda, morph_bits_cuda, zhang_suen_dense_cuda, zhang_suen_packed_cuda)
    from plotweave_torch.ops.morphology import _valid_bits, morph_bits_plain
    from plotweave_torch.ops.thinning import pack_bitboards, unpack_bitboards, zhang_suen_dense_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    shapes = [(1, 1, 40), (1, 37, 33), (2, 64, 31), (3, 100, 95), (5, 50, 257), (8, 73, 130)]
    n = 0
    for k, h, w in shapes:
        b = pack_bitboards(torch.from_numpy(rng.random((k, h, w)) < 0.6).to(dev))
        valid = _valid_bits(w, dev)
        for shape in ("rect", "ellipse", "cross"):
            for ksize in (3, 5, 7):
                for program in ("ed", "de", "e", "d"):
                    it = 1 + n % 2
                    n += 1
                    check(torch.equal(morph_bits_cuda(b, valid, shape, ksize, it, program),
                                      morph_bits_plain(b, valid, shape, ksize, it, program)),
                          f"K2 {k}x{h}x{w} {shape} {ksize} {program}x{it}")
    print(f"K2 == plain: {n} programs (rect/ellipse/cross, ksize 3/5/7, ed/de/e/d, iterations 1-2, "
          f"k 1-8, ragged W, H=1)")

    z = np.load(GOLDEN / "thinning_cases.npz")
    n_cases = len([f for f in z.files if f.startswith("edges_")])
    for t in range(n_cases):
        edges = torch.from_numpy(z[f"edges_{t}"]).to(dev)
        for key, rotated, it in ((f"skel04_{t}", True, 120), (f"skel08_{t}", False, 48)):
            got = zhang_suen_dense_cuda(edges, it, rotated)
            check(np.array_equal(got.cpu().numpy(), z[key].astype(np.int32)), f"K12 vs golden {key}")
    print(f"K12 == thinning_cases.npz: {n_cases} cases x 2 rings")
    for k, h, w in shapes + [(4, 200, 1)]:
        x = torch.from_numpy(random_boards(rng, k, h, w)).to(dev)
        # 3 and 11 stop at max_iter after an odd chunk
        for rotated, it in ((True, 120), (False, 48), (True, 3), (False, 11)):
            got = zhang_suen_dense_cuda(x, it, rotated)
            check(torch.equal(got, zhang_suen_dense_plain(x, it, rotated)), f"K12 {k}x{h}x{w} rot={rotated} it={it}")
            k6 = unpack_bitboards(zhang_suen_packed_cuda(pack_bitboards(x), it, rotated), w)
            check(torch.equal(got, k6), f"K12 != K6 {k}x{h}x{w} rot={rotated} it={it}")
        check(torch.equal(zhang_suen_dense_cuda(x[0]), zhang_suen_dense_cuda(x)[0]), f"K12 (H, W) input {h}x{w}")
    print(f"K12 == plain == unpack(K6): {len(shapes) + 1} random shapes x 4 (ring, max_iter), (H, W) input")

    # every BGR colour once, against the bench's centres
    v = torch.arange(2**24, dtype=torch.int32, device=dev)
    img = torch.stack([v & 255, (v >> 8) & 255, v >> 16], dim=-1).to(torch.uint8).reshape(4096, 4096, 3)
    c = torch.tensor(BENCH_CENTERS, dtype=torch.float32, device=dev)
    got = assign_nearest_cuda(img, c)
    ref = assign_nearest_plain(img, c, 4)
    flips = near_tie_flips(img, BENCH_CENTERS, got, ref, "K7 vs plain, all 2^24 colours")
    stats["K7"] = {"max_abs_err": flips}
    print(f"K7 == plain up to near ties: {flips} of 16777216 labels flip (near-tie rule {NEAR_TIE})")


def phase_chain(stats: dict) -> None:
    import numpy as np
    import torch

    from plotweave_torch.ops.bitpack import bitunpack_rows
    from plotweave_torch.ops.canny import canny_candidates, hysteresis_plain
    from plotweave_torch.ops.filters import gaussian_blur_u8
    from plotweave_torch.ops.kernels import hysteresis_cuda, zhang_suen_packed_cuda
    from plotweave_torch.ops.thinning import zhang_suen_packed_plain
    from plotweave_torch.stages.s02_color_extract import _binary_morph_u8, chain_from_clean

    k, h, w = CHAIN_SHAPE
    _, bins = synthetic_image(1, h, w)
    masks = np.stack([(bins == j).astype(np.uint8) * 255 for j in range(k)])
    packed = np.packbits(masks > 0, axis=-1)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    t0 = time.perf_counter()
    ref = chain_from_clean(packed, w, *EDGE_PARAMS, device=cpu)
    cpu_s = time.perf_counter() - t0
    got = chain_from_clean(packed, w, *EDGE_PARAMS, device=cuda)
    check(torch.equal(got.cpu(), ref), "chain_from_clean: card != CPU at 4x1500x2000")
    nz = int(np.unpackbits(ref.numpy()).sum())
    print(f"chain {k}x{h}x{w}: card == CPU ({ref.numel()} blob bytes, {nz} set bits)")

    # the kernels' inputs at the main path's shapes, as the chain makes them
    mk, oi, ci, bk, lo, hi = EDGE_PARAMS
    m = _binary_morph_u8(bitunpack_rows(torch.from_numpy(packed).to(cuda), w) * 255, w, oi, ci, "ellipse", mk)
    cand, strong = canny_candidates(gaussian_blur_u8(m, bk), lo, hi)
    edges_k = hysteresis_cuda(cand, strong)
    edges_p = hysteresis_plain(cand, strong)
    skel_k = zhang_suen_packed_cuda(edges_k, 120, True)
    skel_p = zhang_suen_packed_plain(edges_p, 120, True)
    stats["K5"] = {"max_abs_err": max_abs_err(edges_k, edges_p),
                   "ms": cuda_ms(lambda: hysteresis_cuda(cand, strong), 20),
                   "plain_ms": cuda_ms(lambda: hysteresis_plain(cand, strong), 3)}
    stats["K6"] = {"max_abs_err": max_abs_err(skel_k, skel_p),
                   "ms": cuda_ms(lambda: zhang_suen_packed_cuda(edges_k, 120, True), 20),
                   "plain_ms": cuda_ms(lambda: zhang_suen_packed_plain(edges_k, 120, True), 3)}
    check(stats["K5"]["max_abs_err"] == 0 and stats["K6"]["max_abs_err"] == 0, "kernel != plain at full size")
    chain_ms = cuda_ms(lambda: chain_from_clean(packed, w, *EDGE_PARAMS, device=cuda), 5)
    print(f"chain device time {chain_ms:.3f} ms/call (CUDA events, H2D of the masks included); "
          f"CPU plain version {cpu_s * 1e3:.1f} ms wall")
    for name in ("K5", "K6"):
        s = stats[name]
        print(f"{name} at {k}x{h}x{w}: kernel {s['ms']:.4f} ms, plain PyTorch on the card "
              f"{s['plain_ms']:.4f} ms, max_abs_err {s['max_abs_err']}")


def run_main(image: str, out: Path, device: str, config: Path | None = None) -> dict:
    """The CLI entry point, steps 1–13; its stage log goes to ``<out>.log``."""
    from plotweave_torch.pipeline import main

    argv = [image, "--output", str(out), "--end-step", "13", "--raster-device", device]
    if config is not None:
        argv += ["--config", str(config)]
    with open(f"{out}.log", "w") as log, contextlib.redirect_stdout(log):
        return main(argv)


def same_artifacts(a: Path, b: Path, names) -> list:
    """Relative paths of the compared artifacts that differ between two runs."""
    rel = ["plot_stream.bin"] + [f"{n}/{f}" for n in names for f in ("mask.png", "edges.png", "contours.pkl")]
    return [r for r in rel if (a / r).read_bytes() != (b / r).read_bytes()]


def phase_main_path(work: Path) -> dict:
    import cv2
    import numpy as np

    from plotweave.config import PipelineConfig
    from plotweave.stream.decoder import StreamDecoder, replay
    from plotweave_torch.ops import kernels

    img, _ = synthetic_image(2, 1500, 2000)
    image = str(work / "synthetic.png")
    cv2.imwrite(image, img)
    names = list(PipelineConfig().color_names)

    kernels.reset_launches()
    t0 = time.perf_counter()
    times_cuda = run_main(image, work / "synthetic_cuda", "auto")
    wall_cuda = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    check(all(launches[n] > 0 for n in MAIN_PATH_KERNELS), f"main path did not launch K2, K5 and K6: {launches}")
    t0 = time.perf_counter()
    times_cpu = run_main(image, work / "synthetic_cpu", "cpu")
    wall_cpu = time.perf_counter() - t0
    diff = same_artifacts(work / "synthetic_cuda", work / "synthetic_cpu", names)
    check(not diff, f"synthetic 2000x1500: card run != CPU run: {diff}")
    data = (work / "synthetic_cuda" / "plot_stream.bin").read_bytes()
    man = json.loads((work / "synthetic_cuda" / "vector_manifest.json").read_text())
    dec = StreamDecoder(data)
    replay(dec, *man["image_size"])
    check(dec.stats.eof_seen and dec.stats.off_canvas_steps == 0, "plot_stream.bin does not decode cleanly")
    print(f"main path, synthetic 2000x1500: card == CPU ({len(data)} stream bytes, decodes to EOF); "
          f"launches {launches}; wall {wall_cuda:.2f} s (card) vs {wall_cpu:.2f} s (cpu)")
    print("  stage wall seconds (card | cpu): " + ", ".join(
        f"{m[:3]} {times_cuda[m]:.3f}|{times_cpu[m]:.3f}" for m in times_cuda))

    import tarfile

    for cfg_name, ref_name in zip(E2E_CONFIGS, E2E_REFS):
        cfg = json.loads((GOLDEN / "e2e" / cfg_name).read_text())
        image = str(GOLDEN / "e2e" / Path(cfg["input_image"]).name)
        runs = {}
        for device in ("auto", "cpu"):
            out = work / f"{cfg_name}_{device}"
            out.mkdir()
            (out / "config.json").write_text(json.dumps(dict(cfg, output_dir=str(out))))
            before = dict(kernels.LAUNCHES)
            runs[device] = run_main(image, out, device, out / "config.json")
            if device == "auto":
                check(all(kernels.LAUNCHES[n] > before[n] for n in MAIN_PATH_KERNELS),
                      f"{cfg_name}: K2, K5 and K6 not launched")
        diff = same_artifacts(work / f"{cfg_name}_auto", work / f"{cfg_name}_cpu", cfg["color_names"])
        check(not diff, f"{cfg_name}: card run != CPU run: {diff}")
        ref = work / f"{cfg_name}_ref"
        with tarfile.open(GOLDEN / "e2e" / ref_name) as tf:
            tf.extractall(ref, filter="data")
        golden = (ref / "plot_stream.bin").read_bytes() == (work / f"{cfg_name}_auto" / "plot_stream.bin").read_bytes()
        print(f"main path, {cfg_name}: card == CPU; plot_stream.bin == golden: {golden}; "
              f"card stage seconds {sum(runs['auto'].values()):.3f}")
    return launches


def phase_frontend(stats: dict) -> dict:
    """``raster_frontend`` at 2000 x 1500, k = 4, both routes, card vs CPU."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.frontend import (
        assign_nearest, assign_nearest_plain, frontend_from_labels, raster_frontend)
    from plotweave_torch.ops.morphology import _valid_bits, morph_bits_plain
    from plotweave_torch.ops.thinning import pack_bitboards, unpack_bitboards, zhang_suen_dense_plain

    h, w = FRONTEND_SHAPE
    img_np, _ = synthetic_image(3, h, w)
    centers = np.array(BENCH_CENTERS, np.float32)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    img, c = torch.from_numpy(img_np).to(cuda), torch.from_numpy(centers).to(cuda)

    t0 = time.perf_counter()
    labels_cpu = assign_nearest(torch.from_numpy(img_np), centers, 4)
    ref = {route: frontend_from_labels(labels_cpu, 4, pallas_thinning=route) for route in (False, True)}
    cpu_s = time.perf_counter() - t0

    launches = {}
    out = {}
    for route in (False, True):
        kernels.reset_launches()
        out[route] = raster_frontend(img, c, k=4, pallas_thinning=route)
        torch.cuda.synchronize()
        launches[route] = dict(kernels.LAUNCHES)
    need = {False: ("assign_nearest", "morph_bits", "hysteresis", "zhang_suen_packed"), True: ("zhang_suen_dense",)}
    for route, names in need.items():
        check(all(launches[route][n] > 0 for n in names), f"front-end route {route}: {names} not all launched: "
              f"{launches[route]}")
    check(torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1]),
          "front-end: the K12 route's output != the K6 route's on the card")
    labels = assign_nearest(img, c, 4)
    flips = near_tie_flips(img, centers, labels, labels_cpu, "front-end labels, card vs CPU")
    for route in (False, True):
        e, sk = frontend_from_labels(labels_cpu.to(cuda), 4, pallas_thinning=route)
        check(torch.equal(e.cpu(), ref[route][0]) and torch.equal(sk.cpu(), ref[route][1]),
              f"front-end from the same labels: card != CPU (pallas_thinning={route})")
        if flips == 0:
            check(torch.equal(out[route][1].cpu(), ref[route][1]), f"front-end: card != CPU (pallas_thinning={route})")
    edges, skel = out[False]
    print(f"front-end {h}x{w} k=4: card == CPU from the same labels, both routes; K12 route == K6 route; "
          f"{int(edges.count_nonzero())} edge px, {int(skel.count_nonzero())} skeleton px; "
          f"launches default {launches[False]}, dense {launches[True]['zhang_suen_dense']} K12")

    # device times at the front-end's shapes
    route_ms = {route: cuda_ms(lambda route=route: raster_frontend(img, c, k=4, pallas_thinning=route), 5)
                for route in (False, True)}
    k7 = kernels.assign_nearest_cuda(img, c)
    stats["K7"].update(ms=cuda_ms(lambda: kernels.assign_nearest_cuda(img, c), 20),
                       plain_ms=cuda_ms(lambda: assign_nearest_plain(img, c, 4), 5))
    masks_b = pack_bitboards(k7[None, :, :] == torch.arange(4, device=cuda)[:, None, None])
    valid = _valid_bits(w, cuda)
    programs = [("rect", 3, "ed"), ("rect", 3, "de"), ("ellipse", 3, "ed"), ("ellipse", 3, "de")]

    def morph_all(fn):
        b = masks_b
        for shape, ksize, program in programs:
            b = fn(b, valid, shape, ksize, 1, program)
        return b

    k2 = unpack_bitboards(morph_all(kernels.morph_bits_cuda), w)
    stats["K2"] = {"max_abs_err": max_abs_err(k2, unpack_bitboards(morph_all(morph_bits_plain), w)),
                   "ms": cuda_ms(lambda: morph_all(kernels.morph_bits_cuda), 20),
                   "plain_ms": cuda_ms(lambda: morph_all(morph_bits_plain), 5)}
    stats["K12"] = {"max_abs_err": max_abs_err(kernels.zhang_suen_dense_cuda(edges), zhang_suen_dense_plain(edges)),
                    "ms": cuda_ms(lambda: kernels.zhang_suen_dense_cuda(edges), 10),
                    "plain_ms": cuda_ms(lambda: zhang_suen_dense_plain(edges), 2)}
    check(stats["K2"]["max_abs_err"] == 0 and stats["K12"]["max_abs_err"] == 0, "K2 or K12 != plain at full size")
    mpx = h * w / 1e6
    for route, name in ((False, "K6 route"), (True, "K12 route")):
        print(f"front-end {name}: {route_ms[route]:.3f} ms/call (CUDA events), {mpx / route_ms[route] * 1e3:.1f} Mpx/s")
    print(f"front-end on the CPU (plain versions, labels + both routes): {cpu_s * 1e3:.1f} ms wall")
    for name, what in (("K7", f"{h}x{w} px"), ("K2", "4 programs of one call"), ("K12", f"4x{h}x{w}")):
        st = stats[name]
        print(f"{name} at {what}: kernel {st['ms']:.4f} ms, plain PyTorch on the card {st['plain_ms']:.4f} ms, "
              f"max_abs_err {st['max_abs_err']}")
    return {"assign_nearest": launches[False]["assign_nearest"],
            "zhang_suen_dense": launches[True]["zhang_suen_dense"]}


def phase_entry() -> None:
    import torch

    from plotweave_torch.entry import entry

    fn, args = entry("auto")
    edges, skel = fn(*args)
    torch.cuda.synchronize()
    check(edges.is_cuda and tuple(edges.shape) == tuple(skel.shape) == (4, 512, 512), "entry('auto'): bad output")
    print(f"entry('auto'): edges {tuple(edges.shape)} {edges.dtype}, skeletons {tuple(skel.shape)} {skel.dtype} "
          f"on {edges.device}")


def main() -> None:
    info = phase_probe()
    import torch

    phase_build()
    stats: dict = {}
    phase_kernels_vs_plain()
    phase_new_kernels_vs_plain(stats)
    phase_chain(stats)
    with tempfile.TemporaryDirectory(prefix="pw_smoke_") as tmp:
        launches = phase_main_path(Path(tmp))
    launches.update(phase_frontend(stats))
    phase_entry()

    table = [
        {"name": "K2 morph_bits", "route": "cuda", "source": "plotweave_torch/csrc/morph_bits.cu",
         "replaces": "plotweave/ops/morphology.py:133", "launches": launches["morph_bits"], **stats["K2"]},
        {"name": "K5 hysteresis", "route": "cuda", "source": "plotweave_torch/csrc/bitboard_fixpoints.cu",
         "replaces": "plotweave/ops/canny.py:133", "launches": launches["hysteresis"], **stats["K5"]},
        {"name": "K6 zhang_suen_packed", "route": "cuda", "source": "plotweave_torch/csrc/bitboard_fixpoints.cu",
         "replaces": "plotweave/ops/pallas_kernels.py:179", "launches": launches["zhang_suen_packed"],
         **stats["K6"]},
        {"name": "K7 assign_nearest", "route": "cuda", "source": "plotweave_torch/csrc/assign_nearest.cu",
         "replaces": "plotweave/ops/frontend.py:24", "launches": launches["assign_nearest"], **stats["K7"]},
        {"name": "K12 zhang_suen_dense", "route": "cuda", "source": "plotweave_torch/csrc/zs_dense.cu",
         "replaces": "plotweave/ops/pallas_kernels.py:99", "launches": launches["zhang_suen_dense"],
         **stats["K12"]},
    ]
    print(json.dumps({"kernels": table}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
