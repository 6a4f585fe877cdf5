"""The port's batch runner on the CPU: grouped chain calls
(``plotweave_torch/parallel/batchrun.py``, ``chain_blob_batch``) and
``run_pipeline_batch`` must write what sequential single-image runs write,
byte for byte, on every schedule: one group, more images than one group, a
ragged last group, mixed shapes, an image that fails while its group
completes, a dispatcher that dies.  Every wait here has a timeout.
"""

from __future__ import annotations

import json
import re
import threading
import time
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave_torch.config import load_config
from plotweave_torch.parallel import batchrun
from plotweave_torch.parallel.mesh import make_mesh
from plotweave_torch.pipeline import main, run_pipeline, run_pipeline_batch, stage_clock
from plotweave_torch.stages.s02_color_extract import chain_blob_batch, chain_from_clean

PARAMS = (3, 1, 1, 5, 22, 70)
LAYERS = ["layer_dark", "layer_mid", "layer_skin", "layer_light"]
CPU = torch.device("cpu")
MESH = make_mesh((1,), ("data",), devices=[CPU])  # the batcher's data axis: one group, one chain call
WAIT = 120  # seconds: every join and wait of these tests gives up after this


def _make_image(path: Path, seed: int, h: int = 120, w: int = 160) -> None:
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :] = (235, 230, 225)
    colors = [(20, 20, 20), (40, 60, 200), (140, 180, 220)]
    for _ in range(10):
        c = colors[int(rng.integers(0, 3))]
        cv2.circle(img, (int(rng.integers(0, w)), int(rng.integers(0, h))), int(rng.integers(6, 30)), c, -1)
    cv2.imwrite(str(path), img)


def _cfg(img: Path, out: Path) -> dict:
    return {"input_image": str(img), "output_dir": str(out),
            "colors": [[20, 20, 20], [40, 60, 200], [140, 180, 220], [235, 230, 225]], "color_names": LAYERS,
            "target_width_mm": 80, "target_height_mm": 60, "pixels_per_mm": 2, "pen_width_px": 8, "pen_radius_px": 4,
            "raster_device": "cpu"}


def _build(tmp_path: Path, tag: str, imgs):
    cfgs = []
    for i, img in enumerate(imgs):
        out = tmp_path / tag / f"run{i}"
        out.mkdir(parents=True)
        (out / "config.json").write_text(json.dumps(_cfg(img, out)))
        cfgs.append(load_config(str(out / "config.json")))
    return cfgs


def _same_run(a, b, files=("mask.png", "edges.png", "contours.pkl"), stream: bool = True) -> None:
    a, b = Path(a.output_dir), Path(b.output_dir)
    if stream:
        assert (a / "plot_stream.bin").read_bytes() == (b / "plot_stream.bin").read_bytes()
        assert json.loads((a / "palette_by_name.json").read_text()) == json.loads((b / "palette_by_name.json").read_text())
    for layer in LAYERS:
        for f in files:
            assert (a / layer / f).read_bytes() == (b / layer / f).read_bytes(), f"{layer}/{f}"


def _packed_masks(seed: int, k: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.random((k, h + 4, w + 4)) < 0.5
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return np.packbits(s[:, 2 : h + 2, 2 : w + 2] >= 5, axis=-1)


# --- the grouped chain call ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(1, 4, 40, 70), (5, 3, 33, 31), (3, 1, 17, 64)])
def test_chain_blob_batch_rows_are_the_solo_blobs_and_the_jax_rows(shape):
    from plotweave.stages.s02_color_extract import _chain_blob_batch

    b, k, h, w = shape
    packed = np.stack([_packed_masks(100 * w + i, k, h, w) for i in range(b)])
    got = chain_blob_batch(packed, w, *PARAMS, device=CPU)
    assert tuple(got.shape) == (b, 2 * k * h * -(-w // 8)) and got.dtype == torch.uint8
    mk, oi, ci, bk, lo, hi = PARAMS
    ref = np.asarray(_chain_blob_batch(jnp.asarray(packed), w=w, mk=mk, oi=oi, ci=ci, bk=bk, lo=lo, hi=hi))
    np.testing.assert_array_equal(got.numpy(), ref)
    for i in range(b):
        assert torch.equal(got[i], chain_from_clean(packed[i], w, *PARAMS, device=CPU)), f"row {i}"
    assert got.numpy().any()


# --- the batcher ------------------------------------------------------------------------


def _submit_all(batcher, arrays, w=70, params=PARAMS):
    """Submit each array from its own thread; → (results, errors) by index."""
    results, errors = {}, {}

    def work(i, arr):
        try:
            results[i] = batcher.run_chain(arr, w, params)
        except Exception as e:  # noqa: BLE001 — the test inspects it
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i, a), daemon=True) for i, a in enumerate(arrays)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    assert not any(t.is_alive() for t in threads), "a waiter hangs"
    return results, errors


def test_batcher_groups_concurrent_submissions():
    arrays = [_packed_masks(i, 4, 40, 70) for i in range(6)]
    batcher = batchrun.DeviceBatcher(MESH, n_workers=6, n_images=6, linger_s=5.0)
    try:
        results, errors = _submit_all(batcher, arrays)
    finally:
        batcher.close()
    assert not errors and batcher.n_batched_images == 6
    assert batcher.n_dispatches == 1  # capacity reached: one group, long before the linger
    for i, arr in enumerate(arrays):
        np.testing.assert_array_equal(results[i], chain_from_clean(arr, 70, *PARAMS, device=CPU).numpy())


def test_batcher_more_images_than_one_group_and_a_ragged_last_group():
    arrays = [_packed_masks(20 + i, 2, 33, 70) for i in range(7)]
    batcher = batchrun.DeviceBatcher(MESH, n_workers=3, n_images=7, linger_s=5.0)
    results = {}
    lock = threading.Lock()
    pending = list(enumerate(arrays))

    def worker():  # a pool of 3 workers, each submitting one image after another
        while True:
            with lock:
                if not pending:
                    return
                i, arr = pending.pop(0)
            results[i] = batcher.run_chain(arr, 70, PARAMS)
            batcher.image_finished()

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    batcher.close()
    assert not any(t.is_alive() for t in threads) and len(results) == 7
    assert batcher.n_batched_images == 7 and 3 <= batcher.n_dispatches <= 7  # groups of at most 3, the last ragged
    for i, arr in enumerate(arrays):
        np.testing.assert_array_equal(results[i], chain_from_clean(arr, 70, *PARAMS, device=CPU).numpy())


def test_batcher_mixed_shapes_and_devices_group_by_key():
    a = [_packed_masks(40 + i, 4, 40, 70) for i in range(2)]
    b = [_packed_masks(50 + i, 4, 25, 64) for i in range(2)]
    batcher = batchrun.DeviceBatcher(MESH, n_workers=4, n_images=4, linger_s=0.3)
    results = {}

    def work(tag, i, arr, w):
        results[tag, i] = batcher.run_chain(arr, w, PARAMS)

    threads = [threading.Thread(target=work, args=("a", i, arr, 70), daemon=True) for i, arr in enumerate(a)]
    threads += [threading.Thread(target=work, args=("b", i, arr, 64), daemon=True) for i, arr in enumerate(b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT)
    batcher.close()
    assert not any(t.is_alive() for t in threads) and batcher.n_batched_images == 4
    assert 2 <= batcher.n_dispatches <= 4  # never one call over two shapes
    for i in range(2):
        np.testing.assert_array_equal(results["a", i], chain_from_clean(a[i], 70, *PARAMS, device=CPU).numpy())
        np.testing.assert_array_equal(results["b", i], chain_from_clean(b[i], 64, *PARAMS, device=CPU).numpy())


def test_batcher_delivers_a_chain_error_to_its_whole_group_and_goes_on():
    good = [_packed_masks(60 + i, 4, 40, 70) for i in range(2)]
    batcher = batchrun.DeviceBatcher(MESH, n_workers=2, n_images=4, linger_s=5.0)
    try:
        # three edge parameters instead of six: the chain call raises for this group
        bad_results, bad_errors = _submit_all(batcher, good, params=PARAMS[:3])
        assert not bad_results and len(bad_errors) == 2 and all(isinstance(e, TypeError) for e in bad_errors.values())
        results, errors = _submit_all(batcher, good)
    finally:
        batcher.close()
    assert not errors and len(results) == 2 and batcher.n_dispatches == 1  # only the good group counts


def test_batcher_dispatcher_death_raises_in_every_waiter(monkeypatch):
    batcher = batchrun.DeviceBatcher(MESH, n_workers=3, n_images=3, linger_s=5.0)

    def die(key, batch):
        raise SystemExit("dispatcher killed")  # not an Exception: _dispatch's own handler does not see it

    monkeypatch.setattr(batcher, "_dispatch", die)
    monkeypatch.setattr(threading, "excepthook", lambda args: None)  # keep the thread's traceback out of the log
    results, errors = _submit_all(batcher, [_packed_masks(70 + i, 4, 40, 70) for i in range(3)])
    assert not results and len(errors) == 3
    assert all(isinstance(e, RuntimeError) and "dispatcher exited" in str(e) for e in errors.values())
    with pytest.raises(RuntimeError, match="closed"):  # a later submission raises instead of parking
        batcher.run_chain(_packed_masks(1, 4, 40, 70), 70, PARAMS)
    batcher.close()


def test_batcher_ctx_is_exclusive_and_cleans_up():
    assert batchrun.active_batcher() is None
    with batchrun.batcher_ctx(batchrun.DeviceBatcher(MESH, 1, 1)) as b:
        assert batchrun.active_batcher() is b
        with pytest.raises(RuntimeError, match="already active"):
            with batchrun.batcher_ctx(batchrun.DeviceBatcher(MESH, 1, 1)):
                pass
    assert batchrun.active_batcher() is None
    with pytest.raises(RuntimeError, match="closed"):
        b.run_chain(_packed_masks(1, 4, 40, 70), 70, PARAMS)


def test_trailing_group_does_not_wait_for_finished_images():
    """With 4 workers declared and 3 images already finished, a lone
    submission is a full group: it runs long before the linger."""
    batcher = batchrun.DeviceBatcher(MESH, n_workers=4, n_images=4, linger_s=60.0)
    for _ in range(3):
        batcher.image_finished()
    t0 = time.monotonic()
    results, errors = _submit_all(batcher, [_packed_masks(80, 4, 40, 70)])
    batcher.close()
    assert not errors and len(results) == 1 and time.monotonic() - t0 < 30


# --- the runner -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sequential(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_batch")
    imgs = []
    for i in range(5):
        p = base / f"img{i}.png"
        _make_image(p, seed=10 + i)
        imgs.append(p)
    for i in range(2):
        p = base / f"wide{i}.png"
        _make_image(p, seed=30 + i, h=90, w=200)
        imgs.append(p)
    seq = _build(base, "seq", imgs)
    for c in seq:
        run_pipeline(c, 1, 13)
    return base, imgs, seq


def test_batch_equals_sequential(sequential, capsys):
    base, imgs, seq = sequential
    par = _build(base, "par3", imgs[:3])
    times = run_pipeline_batch(par, 1, 13, workers=3)
    assert len(times) == 3 and all(t > 0 for t in times)
    out = capsys.readouterr().out
    m = re.search(r"grouped: (\d+) image chain\(s\) in (\d+) grouped call", out)
    assert m and int(m.group(1)) == 3 and 1 <= int(m.group(2)) <= 3
    for a, b in zip(seq, par):
        _same_run(a, b)
    assert batchrun.active_batcher() is None


def test_batch_more_images_than_workers_and_mixed_shapes(sequential, capsys):
    """Seven images of two shapes through two workers: several groups, a
    ragged last one, one group per shape."""
    base, imgs, seq = sequential
    par = _build(base, "par7", imgs)
    with stage_clock() as clock:
        times = run_pipeline_batch(par, 1, 4, workers=2)
    assert len(times) == 7 and all(t > 0 for t in times)
    m = re.search(r"grouped: (\d+) image chain\(s\) in (\d+) grouped call", capsys.readouterr().out)
    assert m and int(m.group(1)) == 7 and 4 <= int(m.group(2)) <= 7  # at most two images a group
    assert set(clock) == {"s01_resize", "s02_color_extract", "s03_edge_detect", "s04_vectorize"}
    assert all(v > 0 for v in clock.values())
    for a, b in zip(seq, par):
        _same_run(a, b, stream=False)


def test_batch_ungrouped_and_single_worker_equal_sequential(sequential, capsys):
    base, imgs, seq = sequential
    for tag, kwargs in (("solo", {"workers": 2, "mesh_dp": False}), ("one", {"workers": 1})):
        par = _build(base, tag, imgs[:2])
        assert all(t > 0 for t in run_pipeline_batch(par, 1, 4, **kwargs))
        for a, b in zip(seq, par):
            _same_run(a, b, stream=False)
    assert "grouped: 2 image chain(s)" in capsys.readouterr().out  # workers=1 still groups, one image a call


def test_batch_isolates_failures_while_the_group_completes(tmp_path, capsys):
    """A bad image fails in stage 01; the others' group must not wait for it
    beyond the linger, and must complete."""
    good = []
    for i in range(2):
        p = tmp_path / f"good{i}.png"
        _make_image(p, seed=1 + i)
        good.append(p)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    cfgs = _build(tmp_path, "mixed", [bad, *good])
    done: list = []
    t = threading.Thread(target=lambda: done.append(run_pipeline_batch(cfgs, 1, 13, workers=3)), daemon=True)
    t.start()
    t.join(WAIT)
    assert not t.is_alive(), "the batch hangs behind a failed image"
    times = done[0]
    assert times[0] < 0 and times[1] > 0 and times[2] > 0
    assert "FAILED" in capsys.readouterr().err
    for c in cfgs[1:]:
        assert (Path(c.output_dir) / "plot_stream.bin").exists()


def test_stage_clock_is_exclusive():
    with stage_clock():
        with pytest.raises(RuntimeError, match="already installed"):
            with stage_clock():
                pass
    with stage_clock() as d:
        assert d == {}


def test_cli_batch_dir(sequential, tmp_path, capsys):
    """``--batch-dir``: one run per image under <output>/<stem>/, duplicate
    stems kept apart, byte-equal to the sequential runs, exit code 1 and the
    failed file named when an image fails."""
    base, imgs, seq = sequential
    src = tmp_path / "in"
    src.mkdir()
    for p in imgs[:2]:
        (src / p.name).write_bytes(p.read_bytes())
    cv2.imwrite(str(src / "img0.bmp"), cv2.imread(str(imgs[0])))  # a second img0: duplicate stem
    (src / "notes.txt").write_text("ignored")
    cfg_file = tmp_path / "base.json"
    base_cfg = {k: v for k, v in _cfg(imgs[0], tmp_path).items() if k not in ("input_image", "output_dir")}
    cfg_file.write_text(json.dumps(base_cfg))
    out = tmp_path / "out"
    assert main(["--batch-dir", str(src), "--output", str(out), "--config", str(cfg_file), "--end-step", "14",
                 "--workers", "2", "--raster-device", "cpu", "--profile", str(tmp_path / "trace")]) is None
    text = capsys.readouterr().out
    assert "duplicate stem" in text and "stage 14" in text and "Batch done: 3/3" in text
    assert sorted(p.name for p in out.iterdir()) == ["img0", "img0_2", "img1"]
    assert (tmp_path / "trace" / "batch.json").stat().st_size > 0
    for stem, ref in (("img0_2", seq[0]), ("img1", seq[1])):  # sorted: img0.bmp first, img0.png second
        _same_run(ref, load_config(str(out / stem / "config.json")))
    assert (out / "img0" / "plot_stream.bin").read_bytes() == (out / "img0_2" / "plot_stream.bin").read_bytes()

    (src / "broken.png").write_bytes(b"not a png")
    with pytest.raises(SystemExit) as e:
        main(["--batch-dir", str(src), "--output", str(tmp_path / "out2"), "--config", str(cfg_file),
              "--end-step", "2", "--raster-device", "cpu"])
    assert e.value.code == 1 and "broken.png" in capsys.readouterr().err
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(SystemExit) as e:
        main(["--batch-dir", str(empty), "--output", str(tmp_path / "out3")])
    assert e.value.code == 2


def test_batcher_launch_counts_are_thread_safe():
    """Wrappers on worker threads and on the dispatcher share the launch
    counts: concurrent updates must not be lost."""
    import sys

    from plotweave_torch.ops import kernels

    kernels.reset_launches()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels._count("bitpack") for _ in range(2000)], daemon=True)
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and kernels.LAUNCHES["bitpack"] == 16000
    kernels.reset_launches()
