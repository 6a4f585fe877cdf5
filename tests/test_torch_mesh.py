"""plotweave_torch's meshes and its ``data`` axis on the CPU.

- ``cpu_device_count()`` is the JAX package's CPU pool under the same
  ``XLA_FLAGS`` (checked in fresh processes, where the flag still counts).
- ``make_mesh`` builds the JAX package's meshes over ``torch.device`` s: the
  CUDA cards by default, an explicit list that may name one device twice,
  and it raises where the JAX one does.
- ``frontend_batch`` over a data mesh gives the JAX package's bytes (labels
  by the near-tie rule of ``tests/test_torch_frontend.py``), on both
  thinning routes.
- The batch runner splits each group over the data devices without padding,
  one chain call a device, and ``run_pipeline_batch(devices=...)`` writes
  what sequential runs write.
- Stage 02 with ``--raster-device cpu --shard-rows 4`` prints the JAX
  package's ``[shard]`` line and writes its artifacts, byte for byte, and
  the golden stream.
"""

from __future__ import annotations

import json
import os
import pickle
import re
import subprocess
import sys
import tarfile
import threading
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from plotweave.ops.frontend import assign_nearest as jax_assign_nearest
from plotweave.parallel import frontend_batch as jax_frontend_batch
from plotweave.parallel import make_mesh as jax_make_mesh
from plotweave_torch.ops.frontend import assign_nearest, nearest_gaps, raster_frontend
from plotweave_torch.parallel import batchrun, data_sharding, frontend_batch, make_mesh
from plotweave_torch.parallel.mesh import cpu_device_count, default_devices, shard_bounds
from plotweave_torch.stages.s02_color_extract import chain_from_clean

REPO = Path(__file__).resolve().parent.parent
E2E = REPO / "tests" / "golden" / "e2e"
CPU = torch.device("cpu")
CENTERS = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
PARAMS = (3, 1, 1, 5, 22, 70)
WAIT = 120  # seconds: every join of these tests gives up after this


def cpu_pool(monkeypatch, n: int) -> None:
    monkeypatch.setenv("XLA_FLAGS", f"--xla_force_host_platform_device_count={n}")


# --- the CPU pool and the mesh ----------------------------------------------------------------

COUNT_BOTH = """
import json, jax
jax.config.update("jax_platforms", "cpu")
from plotweave_torch.parallel.mesh import cpu_device_count
print(json.dumps([len(jax.devices("cpu")), cpu_device_count()]))
"""


@pytest.mark.parametrize("flags", ["--xla_force_host_platform_device_count=3",
                                   "--xla_cpu_multi_thread_eigen=false --xla_force_host_platform_device_count=6",
                                   ""], ids=["3", "6-among-flags", "unset"])
def test_cpu_device_count_is_the_jax_cpu_pool(flags):
    env = {key: v for key, v in os.environ.items() if key not in ("XLA_FLAGS", "JAX_NUM_CPU_DEVICES")}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO), **({"XLA_FLAGS": flags} if flags else {}))
    out = subprocess.run([sys.executable, "-c", COUNT_BOTH], env=env, cwd=REPO, capture_output=True, text=True,
                         timeout=WAIT)
    assert out.returncode == 0, out.stderr[-2000:]
    jax_count, ours = json.loads(out.stdout.strip().splitlines()[-1])
    assert ours == jax_count == (int(flags.rsplit("=", 1)[1]) if flags else 1)


def test_make_mesh_explicit_devices_and_axes(monkeypatch):
    mesh = make_mesh((2, 4), ("data", "space"), devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "space": 4} and mesh.platform == "cpu"
    assert mesh.along("space") == [CPU] * 4 and mesh.along("data") == [CPU] * 2
    assert mesh.grid("space", "data").shape == (4, 2)
    # one card named twice: two shards on one device
    twice = make_mesh((2,), ("data",), devices=["cuda:0", torch.device("cuda", 0)])
    assert twice.platform == "cuda" and twice.along("data") == [torch.device("cuda", 0)] * 2
    with pytest.raises(ValueError, match="mesh needs 3 devices, have 2"):
        make_mesh((3,), devices=[CPU] * 2)
    with pytest.raises(ValueError, match="one platform"):
        make_mesh((2,), devices=[CPU, torch.device("cuda", 0)])
    cpu_pool(monkeypatch, 3)
    assert cpu_device_count() == 3 and default_devices("cpu") == [CPU] * 3
    with pytest.raises(ValueError, match="platform"):
        default_devices("tpu")


def test_make_mesh_defaults_to_the_cards_once_each(monkeypatch):
    """As ``jax.devices()``: every card once, and a mesh larger than the
    cards raises (the JAX package's error)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_mesh()
    assert mesh.shape == {"data": 2} and mesh.along("data") == [torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="mesh needs 1 devices, have 0"):
        make_mesh((1,), ("space",))
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 4"):
        jax_make_mesh((8,), devices=jax.devices("cpu")[:4])


@pytest.mark.parametrize("n_items,n_shards", [(5, 2), (8, 4), (1, 3), (7, 7), (0, 2), (10, 3)])
def test_shard_bounds_are_array_split(n_items, n_shards):
    bounds = shard_bounds(n_items, n_shards)
    sizes = [len(a) for a in np.array_split(np.arange(n_items), n_shards)]
    assert [b - a for a, b in bounds] == sizes and bounds[-1][1] == n_items
    sharding = data_sharding(make_mesh((n_shards,), devices=[CPU] * n_shards))
    x = np.arange(n_items * 3, dtype=np.int32).reshape(n_items, 3)
    parts = sharding.split(x)
    assert [len(p) for _, p in parts] == [s for s in sizes if s]  # no empty part
    if n_items:
        assert torch.equal(sharding.gather([p for _, p in parts]), torch.from_numpy(x))


# --- frontend_batch ----------------------------------------------------------------------------


def posters(seed: int, b: int, h: int = 48, w: int = 40) -> np.ndarray:
    """Seeded four-tone images whose labels are no near ties."""
    rng = np.random.default_rng(seed)
    palette = np.array([[30, 25, 20], [70, 90, 190], [140, 175, 220], [225, 220, 215]], np.int16)
    yy, xx = np.mgrid[0:h, 0:w]
    imgs = []
    for _ in range(b):
        field = sum(np.sin(rng.uniform(0.05, 0.3) * yy + rng.uniform(0.05, 0.3) * xx + rng.uniform(0, 6.3))
                    for _ in range(3))
        bands = np.digitize(field, np.quantile(field, [0.25, 0.5, 0.75]))
        imgs.append(np.clip(palette[bands] + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8))
    imgs = np.stack(imgs)
    diff = assign_nearest(torch.from_numpy(imgs), CENTERS, 4).numpy() != np.asarray(
        jax_assign_nearest(imgs, CENTERS, 4))
    assert not diff.any() or nearest_gaps(imgs[diff], CENTERS).max() <= 0.01
    assert not diff.any(), "a near tie: the outputs may differ there"
    return imgs


@pytest.mark.parametrize("n", [2, 4, 8])
def test_frontend_batch_matches_jax(n):
    imgs = posters(n, 8)
    ref_e, ref_s = jax_frontend_batch(jax_make_mesh((n,), ("data",), devices=jax.devices("cpu")[:n]), imgs,
                                      CENTERS, k=4)
    e, s = frontend_batch(make_mesh((n,), ("data",), devices=[CPU] * n), imgs, CENTERS, k=4)
    assert tuple(e.shape) == (8, 4, 48, 40) and e.dtype == s.dtype == torch.uint8
    np.testing.assert_array_equal(e.numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert s.any()


def test_frontend_batch_dense_route_and_its_calls(monkeypatch):
    """With ``pallas_thinning=True`` too (the JAX kernel cannot take a
    device's sub-batch): equal to one ``raster_frontend`` call over the
    batch, one call a device, the centres given as a tensor."""
    from plotweave_torch.parallel import batch

    imgs = torch.from_numpy(posters(5, 6))
    calls = []
    monkeypatch.setattr(batch, "raster_frontend", lambda part, c, **kw: calls.append(len(part)) or
                        raster_frontend(part, c, **kw))
    mesh = make_mesh((3,), ("data",), devices=[CPU] * 3)
    e, s = frontend_batch(mesh, imgs, torch.from_numpy(CENTERS), k=4, pallas_thinning=True)
    assert calls == [2, 2, 2]
    ref_e, ref_s = raster_frontend(imgs, CENTERS, k=4, pallas_thinning=True)
    assert torch.equal(e, ref_e) and torch.equal(s, ref_s)
    assert torch.equal(s, raster_frontend(imgs, CENTERS, k=4)[1])
    with pytest.raises(ValueError, match="does not split"):
        frontend_batch(make_mesh((4,), ("data",), devices=[CPU] * 4), imgs, CENTERS)


# --- the batch runner's data axis --------------------------------------------------------------


def packed_masks(seed: int, k: int = 4, h: int = 40, w: int = 70) -> np.ndarray:
    labels = np.random.default_rng(seed).integers(0, k, (h, w))
    return np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])


@pytest.mark.parametrize("n_devices,n_images,parts", [(3, 5, [2, 2, 1]), (3, 1, [1]), (2, 4, [2, 2])])
def test_batcher_splits_a_group_over_the_data_devices(monkeypatch, n_devices, n_images, parts):
    """One group, split over the data axis without padding: one chain call
    a non-empty part, every row its solo blob."""
    from plotweave_torch.stages import s02_color_extract as s02

    calls = []
    real = s02.chain_blob_batch
    monkeypatch.setattr(s02, "chain_blob_batch", lambda packed, *a, **kw: calls.append(len(packed)) or
                        real(packed, *a, **kw))
    arrays = [packed_masks(30 + i) for i in range(n_images)]
    mesh = make_mesh((n_devices,), ("data",), devices=[CPU] * n_devices)
    batcher = batchrun.DeviceBatcher(mesh, n_workers=n_images, n_images=n_images, linger_s=5.0)
    results = {}
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, batcher.run_chain(arrays[i], 70, PARAMS)),
                                daemon=True) for i in range(n_images)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    batcher.close()
    assert not any(t.is_alive() for t in threads) and batcher.n_dispatches == 1
    assert calls == parts
    for i, arr in enumerate(arrays):
        np.testing.assert_array_equal(results[i], chain_from_clean(arr, 70, *PARAMS, device=CPU).numpy())


LAYERS = ["layer_dark", "layer_mid", "layer_skin", "layer_light"]


def _image(path: Path, seed: int, h: int = 120, w: int = 160) -> None:
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), (235, 230, 225), np.uint8)
    for _ in range(10):
        c = [(20, 20, 20), (40, 60, 200), (140, 180, 220)][int(rng.integers(0, 3))]
        cv2.circle(img, (int(rng.integers(0, w)), int(rng.integers(0, h))), int(rng.integers(6, 30)), c, -1)
    cv2.imwrite(str(path), img)


def _cfgs(base: Path, tag: str, n: int):
    from plotweave_torch.config import load_config

    cfgs = []
    for i in range(n):
        img, out = base / f"img{i}.png", base / tag / f"run{i}"
        if not img.exists():
            _image(img, 40 + i)
        out.mkdir(parents=True)
        (out / "config.json").write_text(json.dumps({
            "input_image": str(img), "output_dir": str(out), "color_names": LAYERS,
            "colors": [[20, 20, 20], [40, 60, 200], [140, 180, 220], [235, 230, 225]], "target_width_mm": 80,
            "target_height_mm": 60, "pixels_per_mm": 2, "pen_width_px": 8, "pen_radius_px": 4,
            "raster_device": "cpu"}))
        cfgs.append(load_config(str(out / "config.json")))
    return cfgs


def test_run_pipeline_batch_over_a_device_list_equals_sequential_runs(tmp_path, capsys):
    from plotweave_torch.pipeline import run_pipeline, run_pipeline_batch

    seq = _cfgs(tmp_path, "seq", 4)
    for c in seq:
        run_pipeline(c, 1, 13)
    capsys.readouterr()
    par = _cfgs(tmp_path, "par", 4)
    times = run_pipeline_batch(par, 1, 13, devices=[CPU] * 4)
    out = capsys.readouterr().out
    assert all(t > 0 for t in times)
    assert "[batch] mesh data-parallelism over 4 device(s)" in out
    m = re.search(r"grouped: (\d+) image chain\(s\) in (\d+) grouped call", out)
    assert m and int(m.group(1)) == 4
    for a, b in zip(seq, par):
        a, b = Path(a.output_dir), Path(b.output_dir)
        assert (a / "plot_stream.bin").read_bytes() == (b / "plot_stream.bin").read_bytes()
        for layer in LAYERS:
            for f in ("mask.png", "edges.png", "contours.pkl"):
                assert (a / layer / f).read_bytes() == (b / layer / f).read_bytes(), f"{layer}/{f}"


def test_run_pipeline_batch_defaults_to_the_cpu_pool(tmp_path, capsys, monkeypatch):
    """Every image on the CPU: the data axis is the CPU pool ``XLA_FLAGS``
    sets, and the workers the JAX package's ``min(images, max(4, devices))``
    (5 here, where the one-device rule gave 4)."""
    import concurrent.futures

    from plotweave_torch.pipeline import run_pipeline_batch

    cpu_pool(monkeypatch, 6)
    pools = []
    original = concurrent.futures.ThreadPoolExecutor

    class Recording(original):
        def __init__(self, max_workers=None, **kw):
            pools.append(max_workers)
            super().__init__(max_workers=max_workers, **kw)

    monkeypatch.setattr(concurrent.futures, "ThreadPoolExecutor", Recording)
    cfgs = _cfgs(tmp_path, "pool", 5)
    assert all(t > 0 for t in run_pipeline_batch(cfgs, 1, 4))
    assert "[batch] mesh data-parallelism over 6 device(s)" in capsys.readouterr().out
    assert pools[0] == 5  # the runner's pool, made before any stage runs


# --- stage 02 row-sharded over the CPU pool, both packages -----------------------------------------


def test_stage02_shard_rows_4_on_the_cpu_is_the_jax_packages(tmp_path, capsys, monkeypatch):
    """``--raster-device cpu --shard-rows 4`` in one environment (8 CPU
    devices): both packages print the same ``[shard]`` line and write the
    same artifacts, and the stream is the golden one."""
    from plotweave.config import load_config as jax_load_config
    from plotweave.pipeline import run_pipeline as jax_run_pipeline
    from plotweave_torch.config import load_config
    from plotweave_torch.pipeline import run_pipeline

    cpu_pool(monkeypatch, len(jax.devices("cpu")))
    runs = {}
    for tag, load, run in (("jax", jax_load_config, jax_run_pipeline), ("torch", load_config, run_pipeline)):
        out = tmp_path / tag
        out.mkdir()
        cfg = json.loads((E2E / "base_cfg.json").read_text())
        cfg.update(input_image=str(E2E / "testimg.png"), output_dir=str(out), raster_device="cpu", shard_rows=4)
        (out / "config.json").write_text(json.dumps(cfg))
        capsys.readouterr()
        run(load(str(out / "config.json")), 1, 13)
        runs[tag] = (out, [line for line in capsys.readouterr().out.splitlines() if line.startswith("[shard]")])
    (jax_out, jax_lines), (out, lines) = runs["jax"], runs["torch"]
    assert lines == jax_lines == ["[shard] raster chain row-sharded over 4 device(s)"]
    names = json.loads((E2E / "base_cfg.json").read_text())["color_names"]
    for layer in names:
        for f in ("mask.png", "edges.png"):
            assert (out / layer / f).read_bytes() == (jax_out / layer / f).read_bytes(), f"{layer}/{f}"
        mine, ref = (pickle.loads((d / layer / "contours.pkl").read_bytes()) for d in (out, jax_out))
        assert len(mine) == len(ref) and all(np.array_equal(a, b) for a, b in zip(mine, ref))
    assert (out / "plot_stream.bin").read_bytes() == (jax_out / "plot_stream.bin").read_bytes()
    with tarfile.open(E2E / "ref_artifacts.tar.gz") as tf:
        tf.extractall(tmp_path / "golden", filter="data")
    assert (out / "plot_stream.bin").read_bytes() == (tmp_path / "golden" / "plot_stream.bin").read_bytes()
