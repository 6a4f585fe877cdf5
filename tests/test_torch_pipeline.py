"""The port's runner end to end on the CPU, and its device and build policy.

The four e2e golden configs run through ``plotweave_torch.pipeline`` with
``raster_device="cpu"`` (the plain PyTorch versions), and every artifact of
the golden reference run that steps 1–13 write must equal the golden's:
``plot_stream.bin`` byte for byte, the JSON files as parsed, the pickles item
by item (their bytes depend on the numpy and pickle versions that wrote
them), the PNGs pixel by pixel (masks, edges, the resized image and all the
previews: they are drawn by OpenCV from integer coordinates, so the pixels
are deterministic; the files' bytes depend on the PNG encoder of the OpenCV
build, so they are not pinned).  ``config.json`` is the test's own input.
Stage 14 runs headless on a golden stream.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tarfile
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from plotweave_torch.config import PipelineConfig, load_config

GOLDEN = Path(__file__).parent / "golden" / "e2e"
REPO = Path(__file__).resolve().parent.parent
CONFIGS = [
    ("base_cfg.json", "ref_artifacts.tar.gz"),
    ("base_cfg2.json", "ref_artifacts2.tar.gz"),
    ("cfg3_8layers.json", "ref_artifacts3.tar.gz"),
    ("cfg4_gray1layer.json", "ref_artifacts4.tar.gz"),
]


def _write_cfg(cfg_name: str, out: Path, **extra) -> Path:
    cfg = json.loads((GOLDEN / cfg_name).read_text())
    cfg.update(input_image=str(GOLDEN / Path(cfg["input_image"]).name), output_dir=str(out), **extra)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(cfg))
    return out / "config.json"


@pytest.fixture(scope="module", params=CONFIGS, ids=["default", "variant", "8layers", "gray1layer"])
def runs(request, tmp_path_factory):
    from plotweave_torch.pipeline import run_pipeline

    cfg_name, tar_name = request.param
    base = tmp_path_factory.mktemp("torch_e2e")
    with tarfile.open(GOLDEN / tar_name) as tf:
        tf.extractall(base / "ref", filter="data")
    cfg = load_config(str(_write_cfg(cfg_name, base / "mine", raster_device="cpu")))
    times = run_pipeline(cfg, 1, 13)
    return base / "ref", base / "mine", list(cfg.color_names), times


@pytest.mark.parametrize("fname", ["mask.png", "edges.png"])
def test_raster_artifacts_identical(runs, fname):
    import cv2

    ref, mine, layers, _ = runs
    for layer in layers:
        a = cv2.imread(str(ref / layer / fname), cv2.IMREAD_GRAYSCALE)
        b = cv2.imread(str(mine / layer / fname), cv2.IMREAD_GRAYSCALE)
        assert a is not None and b is not None
        np.testing.assert_array_equal(a, b, err_msg=f"{layer}/{fname}")


def test_contours_identical(runs):
    ref, mine, layers, _ = runs
    for layer in layers:
        a = pickle.loads((ref / layer / "contours.pkl").read_bytes())
        b = pickle.loads((mine / layer / "contours.pkl").read_bytes())
        assert len(a) == len(b), layer
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


PER_LAYER = ["contours_scaled.pkl", "contours_sorted.pkl", "lines_intra.pkl", "taps_intra.pkl", "lines_cross.pkl",
             "taps_cross.pkl", "ops.pkl", "scaled_preview.png", "preview_intra.png", "preview_cross.png"]
TOP_LEVEL = ["resized.png", "edges_composite.png", "scaled_preview_composite.png", "preview_intra_composite.png",
             "preview_cross_composite.png", "palette_by_name.json", "vector_manifest.json", "plot_stream.json"]
COMPARED_ELSEWHERE = {"mask.png", "edges.png", "contours.pkl", "plot_stream.bin", "config.json"}


def _same_artifact(a: Path, b: Path) -> None:
    import cv2

    if a.suffix == ".png":
        x, y = cv2.imread(str(a), cv2.IMREAD_UNCHANGED), cv2.imread(str(b), cv2.IMREAD_UNCHANGED)
        assert x is not None and y is not None and x.shape == y.shape, a.name
        np.testing.assert_array_equal(x, y, err_msg=a.name)
    elif a.suffix == ".json":
        assert json.loads(a.read_text()) == json.loads(b.read_text()), a.name
    else:
        x, y = pickle.loads(a.read_bytes()), pickle.loads(b.read_bytes())
        assert len(x) == len(y), f"{a.name}: {len(x)} vs {len(y)} items"
        for i, (p, q) in enumerate(zip(x, y)):
            if isinstance(p, dict):  # ops.pkl
                assert p["type"] == q["type"], f"{a.name}[{i}] type"
                if p["type"] == "line":
                    np.testing.assert_array_equal(p["points"], q["points"], err_msg=f"{a.name}[{i}]")
                else:
                    assert (p["x"], p["y"]) == (q["x"], q["y"]), f"{a.name}[{i}] tap"
            else:
                np.testing.assert_array_equal(np.asarray(p), np.asarray(q), err_msg=f"{a.name}[{i}]")


@pytest.mark.parametrize("name", [f"layer/{n}" for n in PER_LAYER] + TOP_LEVEL)
def test_golden_artifact_identical(runs, name):
    """Every artifact of the golden run beside those of the tests above."""
    ref, mine, layers, _ = runs
    rels = [f"{layer}/{name[6:]}" for layer in layers] if name.startswith("layer/") else [name]
    for rel in rels:
        assert (ref / rel).is_file() and (mine / rel).is_file(), rel
        _same_artifact(ref / rel, mine / rel)


def test_every_golden_file_is_written_and_compared(runs):
    """Steps 1–13 write every file of the golden tarball, and the lists above name them all."""
    ref, mine, layers, _ = runs
    golden = {str(p.relative_to(ref)) for p in ref.rglob("*") if p.is_file()}
    assert golden <= {str(p.relative_to(mine)) for p in mine.rglob("*") if p.is_file()}
    named = set(TOP_LEVEL) | COMPARED_ELSEWHERE
    named |= {f"{layer}/{n}" for layer in layers for n in [*PER_LAYER, *COMPARED_ELSEWHERE]}
    assert golden <= named, sorted(golden - named)


def test_stage14_headless_preview(runs, tmp_path, monkeypatch):
    """Stage 14 on the run's stream, headless: the PNG it writes is the
    render of the golden stream by the JAX package's simulator."""
    import cv2

    from plotweave.viz.simulator import DEFAULT_PALETTE, render_stream
    from plotweave_torch.stages import s14_preview_stream

    ref, mine, _, _ = runs
    out = tmp_path / "stream_preview.png"
    monkeypatch.setenv("PLOTWEAVE_PREVIEW_PNG", str(out))
    decoders = []  # print_stats writes to the stderr of the moment its module was imported
    monkeypatch.setattr(s14_preview_stream, "print_stats", decoders.append)
    cfg = load_config(str(mine / "config.json"))
    s14_preview_stream.run(cfg)
    assert len(decoders) == 1 and decoders[0].stats.eof_seen and decoders[0].stats.steps_total > 0
    got = cv2.imread(str(out), cv2.IMREAD_UNCHANGED)
    w, h = int(cfg.target_width_mm * cfg.steps_per_mm), int(cfg.target_height_mm * cfg.steps_per_mm)
    want, _ = render_stream((ref / "plot_stream.bin").read_bytes(), w, h, invert_y=True, palette=DEFAULT_PALETTE)
    assert got is not None and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any()  # something was drawn


def test_stream_byte_identical(runs):
    ref, mine, _, times = runs
    assert (ref / "plot_stream.bin").read_bytes() == (mine / "plot_stream.bin").read_bytes()
    assert sorted(times) == sorted(
        ["s01_resize", "s02_color_extract", "s03_edge_detect", "s04_vectorize", "s05_scale",
         "s06_preview_scaled", "s07_sort", "s08_dedup_intra", "s09_preview_intra",
         "s10_dedup_cross", "s11_preview_cross", "s12_plot_order", "s13_build_stream"]
    )


def test_resumed_stages_03_04_identical(tmp_path):
    """Steps 3 and 4 alone (no fused blob) run their own raster programs."""
    from plotweave_torch.pipeline import run_pipeline

    cfg = load_config(str(_write_cfg("base_cfg2.json", tmp_path / "a", raster_device="cpu")))
    run_pipeline(cfg, 1, 4)
    rel = [f"{n}/{p}" for n in cfg.color_names for p in ("edges.png", "contours.pkl")]
    fused = {r: (tmp_path / "a" / r).read_bytes() for r in rel}
    for n in cfg.color_names:
        (tmp_path / "a" / n / "edges.png").unlink()
    run_pipeline(cfg, 3, 4)
    for r in rel:
        assert (tmp_path / "a" / r).read_bytes() == fused[r], r


def test_cli_subprocess_imports_no_jax(tmp_path):
    cfg_path = _write_cfg("base_cfg.json", tmp_path / "out")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['plotweave_torch', {str(GOLDEN / 'testimg.png')!r}, '--output', "
        f"{str(tmp_path / 'out')!r}, '--config', {str(cfg_path)!r}, '--end-step', '13', "
        "'--raster-device', 'cpu']\n"
        "runpy.run_module('plotweave_torch', run_name='__main__')\n"
        "assert 'jax' not in sys.modules, 'plotweave_torch imported jax'\n"
        "bad = [m for m in sys.modules if m == 'plotweave' or m.startswith('plotweave.')]\n"
        "assert not bad, f'plotweave_torch imported {bad}'\n"
        "print('NO_JAX_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK" in res.stdout
    with tarfile.open(GOLDEN / "ref_artifacts.tar.gz") as tf:
        tf.extractall(tmp_path / "ref", filter="data")
    assert (tmp_path / "out" / "plot_stream.bin").read_bytes() == (tmp_path / "ref" / "plot_stream.bin").read_bytes()


def test_auto_raster_device_raises_without_cuda(tmp_path, monkeypatch):
    from plotweave_torch.pipeline import run_pipeline
    from plotweave_torch.utils.devices import raster_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="raster_device='auto'"):
        raster_device(PipelineConfig())
    assert raster_device(PipelineConfig(raster_device="cpu")) == torch.device("cpu")
    with pytest.raises(ValueError):
        raster_device(PipelineConfig(raster_device="tpu"))
    cfg = load_config(str(_write_cfg("base_cfg.json", tmp_path / "auto")))
    with pytest.raises(RuntimeError, match="raster_device='auto'"):
        run_pipeline(cfg, 1, 4)


@pytest.mark.parametrize(
    "override",
    [{"shard_rows": 2}, {"shard_auto_mpx": 0.01}],
    ids=["shard-rows", "shard-auto"],
)
def test_unported_modes_raise(tmp_path, monkeypatch, override):
    """Row sharding over more than one card (mocked: four cards, tensors
    that say they lie on a card, ``tests/mocked_cards.py``) runs stage 02's
    chain over a ``space`` mesh of the cards through the slab kernels'
    wrappers, once a shard (K5 and K6 once a shard a round), and no plain
    op; steps 1-4 give the artifacts of the unsharded run on the CPU."""
    from mocked_cards import launches, stage02_on_cards
    from plotweave_torch.ops.kernels import STATS
    from plotweave_torch.pipeline import run_pipeline

    ref = tmp_path / "cpu"
    run_pipeline(load_config(str(_write_cfg("base_cfg.json", ref, raster_device="cpu"))), 1, 4)
    calls, meshes = stage02_on_cards(monkeypatch, 4)
    cfg = load_config(str(_write_cfg("base_cfg.json", tmp_path / "x", **override)))
    run_pipeline(cfg, 1, 4)
    n = len(meshes[0])
    assert len(meshes) == 1 and n > 1 and meshes[0] == [torch.device("cuda", i) for i in range(n)]
    assert launches(calls) == {
        "morph_steps_cuda": n, "edge_candidates_slab_cuda": n, "hysteresis_slab_cuda": n * STATS["hysteresis_rounds"],
        "zhang_suen_slab_cuda": n * STATS["thinning_rounds"]}
    compared = 0
    for f in sorted(ref.rglob("*")):
        if f.is_file() and f.name != "config.json":
            assert (tmp_path / "x" / f.relative_to(ref)).read_bytes() == f.read_bytes(), f.relative_to(ref)
            compared += 1
    assert compared >= 3 * len(cfg.color_names)


def test_stages_07_and_12_say_when_a_plan_crosses_a_device_gate(tmp_path, capsys):
    """A plan of at least ``planner_device_min_n`` contours, or an op list of
    at least ``refine_device_min_n`` entries, goes to K9 or K10 only on a
    CUDA device.  On the CPU the host planner and refiner run, silently, as
    the JAX package's do off an accelerator, and give the result they give
    below the gate: no "not ported" line, and every artifact byte-equal."""
    from plotweave_torch.pipeline import run_pipeline
    from plotweave_torch.vector.planner import refine_tour
    from plotweave_torch.vector.sort import sort_contours

    rng = np.random.default_rng(7)
    contours = [rng.integers(0, 500, (int(rng.integers(2, 9)), 1, 2)).astype(np.int32) for _ in range(12)]
    quiet = sort_contours(contours)
    assert capsys.readouterr().out == ""
    for device in (None, torch.device("cpu")):
        gated = sort_contours(contours, device_min_n=12, device=device)
        assert capsys.readouterr().out == ""
        assert len(quiet) == len(gated) and all(np.array_equal(a, b) for a, b in zip(quiet, gated))

    ops = [{"type": "line", "points": c.reshape(-1, 2)} for c in contours]
    quiet = refine_tour(ops)
    assert capsys.readouterr().out == ""
    for device in (None, torch.device("cpu")):
        gated = refine_tour(ops, device_min_n=5, device=device)
        assert capsys.readouterr().out == ""
        assert len(quiet) == len(gated) and all(np.array_equal(a["points"], b["points"]) for a, b in zip(quiet, gated))

    # through the stages: the gates come from the config, and no artifact moves
    runs = {}
    for name, gate in (("plain", 0), ("gated", 1)):
        cfg = load_config(str(_write_cfg("base_cfg.json", tmp_path / name, raster_device="cpu", plotopt_two_opt=True,
                                         planner_device_min_n=gate, refine_device_min_n=gate)))
        run_pipeline(cfg, 1, 13)
        runs[name] = capsys.readouterr().out
    for out in runs.values():
        assert "not ported" not in out and "device planner" not in out and "device refiner" not in out
    for rel in ["plot_stream.bin"] + [f"{layer}/{n}" for layer in cfg.color_names
                                      for n in ("contours_sorted.pkl", "ops.pkl")]:
        assert (tmp_path / "plain" / rel).read_bytes() == (tmp_path / "gated" / rel).read_bytes(), rel


def test_stages_07_and_12_raise_on_a_cuda_device_without_a_card(tmp_path):
    """Handed a CUDA device where there is none, the planner and the refiner
    raise instead of running on the CPU; stages 07 and 12 resolve the device
    (``raster_device: "auto"``, the card) only for a layer that crosses the
    gate, so a run below the gates is the CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py drives K9 and K10 there")
    from plotweave_torch.pipeline import run_pipeline
    from plotweave_torch.stages import s07_sort, s12_plot_order
    from plotweave_torch.vector.planner import refine_tour
    from plotweave_torch.vector.sort import sort_contours

    rng = np.random.default_rng(8)
    contours = [rng.integers(0, 500, (int(rng.integers(2, 9)), 1, 2)).astype(np.int32) for _ in range(12)]
    ops = [{"type": "line", "points": c.reshape(-1, 2)} for c in contours]
    cuda = torch.device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sort_contours(contours, device_min_n=12, device=cuda)
    with pytest.raises(RuntimeError, match="cuda"):
        refine_tour(ops, device_min_n=12, device=cuda)

    cfg = load_config(str(_write_cfg("base_cfg.json", tmp_path / "run", raster_device="cpu", plotopt_two_opt=True)))
    run_pipeline(cfg, 1, 6)
    cfg.raster_device = "auto"
    for stage, gate in ((s07_sort, "planner_device_min_n"), (s12_plot_order, "refine_device_min_n")):
        if stage is s12_plot_order:
            run_pipeline(dataclasses.replace(cfg, raster_device="cpu"), 7, 11)
        setattr(cfg, gate, 10**9)
        stage.run(cfg)  # below the gate: the device is never resolved
        setattr(cfg, gate, 1)
        with pytest.raises(RuntimeError, match="CUDA"):
            stage.run(cfg)


def test_chain_thread_joined_when_mask_write_fails(tmp_path, monkeypatch):
    from plotweave_torch.pipeline import run_pipeline
    from plotweave_torch.stages import s02_color_extract as s02

    def broken_write(path, img):
        raise OSError("disk full")

    cfg = load_config(str(_write_cfg("base_cfg.json", tmp_path / "w", raster_device="cpu")))
    run_pipeline(cfg, 1, 1)
    monkeypatch.setattr(s02, "write_image", broken_write)
    with pytest.raises(OSError, match="disk full"):
        run_pipeline(cfg, 2, 4)
    assert not [t for t in threading.enumerate() if t.name == "pw-chain-fetch"]


def test_runner_flushes_under_resolved_output_dir(tmp_path, monkeypatch):
    import plotweave_torch.pipeline as pipeline

    real = tmp_path / "real"
    real.mkdir()
    (tmp_path / "link").symlink_to(real)
    scopes = []
    monkeypatch.setattr(pipeline, "flush_pending_saves", scopes.append)
    cfg = load_config(str(_write_cfg("base_cfg.json", tmp_path / "link", raster_device="cpu")))
    pipeline.run_pipeline(cfg, 1, 1)
    assert scopes == [str(real.resolve())]
    assert (real / "resized.png").exists()


def test_kernel_module_imports_without_nvcc(tmp_path):
    code = (
        "import sys\n"
        "import plotweave_torch.ops.kernels as k\n"
        "assert k.LAUNCHES == {'bitpack': 0, 'edge_candidates': 0, 'zhang_suen_packed': 0, "
        "'zhang_suen_packed_banded': 0, 'zhang_suen_packed_multi': 0, 'hysteresis': 0, 'hysteresis_banded': 0, "
        "'hysteresis_multi': 0, 'edge_candidates_slab': 0, "
        "'hysteresis_slab': 0, 'zhang_suen_packed_slab': 0, 'morph_bits': 0, "
        "'assign_nearest': 0, 'zhang_suen_dense': 0, 'subsample': 0, 'lab_sample': 0, 'kmeans_fit': 0, 'lloyd_fit': 0, "
        "'assign_points': 0, 'morph_dense': 0, 'greedy_tour': 0, 'refine_tour': 0, 'area_resize_frac': 0, "
        "'area_resize_int': 0, 'bezier_sample': 0}\n"
        "try:\n"
        "    k.build()\n"
        "except RuntimeError as e:\n"
        "    assert 'nvcc' in str(e), e\n"
        "    print('NO_NVCC_OK')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH=str(tmp_path), CUDA_HOME=str(tmp_path))
    env.pop("CUDA_PATH", None)
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_NVCC_OK" in res.stdout


def test_kernel_wrappers_refuse_cpu_tensors():
    from plotweave_torch.ops import kernels

    b = torch.zeros((1, 4, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.zhang_suen_packed_cuda(b)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.hysteresis_cuda(b, b)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.morph_steps_cuda(b, torch.zeros(2, dtype=torch.int32), (("rect", 3, "e"),))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.assign_nearest_cuda(torch.zeros((4, 4, 3), dtype=torch.uint8), torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.zhang_suen_dense_cuda(torch.zeros((1, 4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.assign_boards_cuda(torch.zeros((4, 4, 3), dtype=torch.uint8), torch.zeros((4, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.assign_boards_cuda(torch.zeros((4, 4, 3), dtype=torch.uint8), torch.zeros((4, 3)),
                                   torch.zeros(4, dtype=torch.int32))
    pts = torch.zeros((10, 3))
    for call in (lambda: kernels.lab_sample_cuda(torch.zeros((4, 4, 3), dtype=torch.uint8)),
                 lambda: kernels.kmeans_fit_cuda(pts, torch.zeros((1, 2)), 3),
                 lambda: kernels.subsample_cuda((1, 0), 10, 5, "cpu"),
                 lambda: kernels.lloyd_fit_cuda(pts, torch.zeros((1, 2, 3)), 3),
                 lambda: kernels.assign_points_cuda(pts, torch.zeros((2, 3))),
                 lambda: kernels.morph_dense_cuda(torch.zeros((4, 4), dtype=torch.uint8), (("rect", 3, "e"),))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    img = torch.zeros((1, 4, 40), dtype=torch.uint8)
    for call in (lambda: kernels.rows_to_boards_cuda(torch.zeros((1, 4, 5), dtype=torch.uint8), 40),
                 lambda: kernels.boards_to_rows_cuda(b, 40), lambda: kernels.boards_to_dense_cuda(b, 40, 255),
                 lambda: kernels.dense_to_boards_cuda(img), lambda: kernels.labels_to_boards_cuda(img.int(), 4),
                 lambda: kernels.edge_candidates_cuda(b, 40, 5, 22, 70),
                 lambda: kernels.edge_candidates_cuda(img, None, 5, 22, 70),
                 lambda: kernels.gaussian_blur_cuda(img, 5)):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_s08_thinner_without_native_library(monkeypatch):
    """Stage 08's thinner falls back to the port's Zhang–Suen (standard ring,
    48 iterations), which must match the JAX thinner and the native one."""
    from plotweave.ops.thinning import zhang_suen as jax_zhang_suen
    from plotweave_torch.native import api
    from plotweave_torch.vector.dedup_intra import _default_thinner

    from test_torch_ops import blob_stack

    roi = blob_stack(41, 1, 37, 53)[0]
    with_native = _default_thinner(roi)
    native = api.thin_native(roi, max_iter=48, rotated=False)
    monkeypatch.setattr(api, "thin_native", lambda *a, **k: None)
    without = _default_thinner(roi)
    assert without.dtype == np.uint8 and without.any()
    np.testing.assert_array_equal(without, np.asarray(jax_zhang_suen(roi, 48, False)).astype(np.uint8) * 255)
    if native is not None:
        np.testing.assert_array_equal(with_native, without)
