"""The port's gray morphology (the plain version of kernel K11, its schedule
and an emulation of its tiles), the rest of ``plotweave.ops``' public surface
and stage 02's swatch mode, on the CPU, byte for byte against the JAX package
on the same numpy inputs (everything here is integer).
"""

from __future__ import annotations

import importlib
import json
import pickle

import numpy as np
import pytest
import torch

from plotweave.ops import morphology as jmorph
from plotweave_torch import ops as port_ops
from plotweave_torch.ops import kernels, morphology

jcanny = importlib.import_module("plotweave.ops.canny")  # the package binds `canny` to a function

SHAPES = ("rect", "ellipse", "cross")


def gray(rng, *shape) -> np.ndarray:
    """Smooth blobs plus noise, so that neighbouring minima and maxima differ."""
    x = rng.integers(0, 256, shape).astype(np.float32)
    for axis in (-1, -2):
        x = (np.roll(x, 1, axis) + x + np.roll(x, -1, axis)) / 3
    return np.clip(x * 1.6 - 70 + rng.integers(-20, 21, shape), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 7])
@pytest.mark.parametrize("shape", SHAPES)
def test_morph_plain_matches_jax(shape, ksize):
    rng = np.random.default_rng(ksize * 10 + len(shape))
    for dims in ((33, 47), (3, 20, 31), (2, 2, 9, 40), (1, 5), (4, 1)):
        x = gray(rng, *dims)
        binary = (x > 128).astype(np.uint8) * 255
        for src in (x, binary):
            for program, iterations in (("e", 1), ("d", 2), ("ed", 1), ("de", 3), ("ed", 0)):
                ref = np.asarray(jmorph._morph(src, shape, ksize, iterations, program))
                got = morphology.morph_plain(torch.from_numpy(src), shape, ksize, iterations, program)
                assert got.dtype == torch.uint8
                np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{dims} {program}x{iterations}")


@pytest.mark.parametrize("name", ["erode", "dilate", "morph_open", "morph_close"])
def test_public_morphology_matches_jax(name):
    rng = np.random.default_rng(3)
    x = gray(rng, 2, 40, 57)
    for shape, ksize, iterations in (("rect", 3, 1), ("ellipse", 5, 2), ("cross", 4, 1), ("rect", 31, 1)):
        ref = np.asarray(getattr(jmorph, name)(x, shape, ksize, iterations))
        got = getattr(morphology, name)(torch.from_numpy(x), shape, ksize, iterations)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{shape} {ksize} x{iterations}")
    np.testing.assert_array_equal(getattr(morphology, name)(torch.from_numpy(x)).numpy(),
                                  np.asarray(getattr(jmorph, name)(x)))  # the defaults: rect 3, once
    assert getattr(port_ops, name) is getattr(morphology, name)


def test_morph_binary_packed_matches_jax_and_dense():
    """Model: the JAX package's ``test_morphology_packed_matches_dense_fuzz``."""
    r = np.random.default_rng(31)
    for _ in range(3):
        h, w = int(r.integers(20, 120)), int(r.integers(20, 120))
        m = (r.random((3, h, w)) < r.uniform(0.2, 0.7)).astype(np.uint8) * 255
        for shape in SHAPES:
            for k in (3, 5, 7):
                for prog in ("ed", "de", "e", "d"):
                    ref = np.asarray(jmorph.morph_binary_packed(m, shape, k, 1, prog))
                    got = morphology.morph_binary_packed(torch.from_numpy(m), shape, k, 1, prog)
                    np.testing.assert_array_equal(got.numpy(), ref, err_msg=f"{h}x{w} {shape} {k} {prog}")
                    np.testing.assert_array_equal(
                        got.numpy(), morphology.morph_plain(torch.from_numpy(m), shape, k, 1, prog).numpy())


def test_ops_package_exports_the_jax_packages_surface():
    import plotweave.ops as jax_ops

    assert set(port_ops.__all__) == set(jax_ops.__all__)
    for name in port_ops.__all__:
        assert callable(getattr(port_ops, name))


@pytest.mark.parametrize("low,high", [(22, 70), (90, 30)])
def test_dense_canny_matches_jax(low, high):
    rng = np.random.default_rng(5)
    for dims in ((40, 61), (3, 25, 33)):
        img = gray(rng, *dims)
        ref = np.asarray(jcanny.canny(img, low, high))
        got = port_ops.canny(torch.from_numpy(img), low, high)
        assert got.dtype == torch.uint8 and ref.any()
        np.testing.assert_array_equal(got.numpy(), ref)


def test_unpack_rows_is_the_jax_packages():
    from plotweave.ops.bitpack import unpack_rows as jax_unpack
    from plotweave_torch.ops.bitpack import bitpack_rows, unpack_rows

    rng = np.random.default_rng(6)
    m = (rng.random((2, 9, 45)) < 0.5).astype(np.uint8)
    packed = bitpack_rows(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(unpack_rows(packed, 45), m)
    np.testing.assert_array_equal(unpack_rows(packed, 45), jax_unpack(packed, 45))


def test_morphology_refuses_other_dtypes_and_devices():
    with pytest.raises(TypeError):
        morphology.morph_plain(torch.zeros((4, 4), dtype=torch.int32), "rect", 3, 1, "e")
    with pytest.raises(ValueError):
        morphology.erode(torch.zeros((4, 4), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        kernels.morph_dense_cuda(torch.zeros((4, 4), dtype=torch.uint8), (("rect", 3, "e"),))


# --- K11's schedule and tiles ------------------------------------------------------


def test_element_taps_anchor_and_radius():
    assert kernels.element_taps("rect", 3) == (1, tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)))
    assert kernels.element_taps("rect", 2) == (1, ((-1, -1), (-1, 0), (0, -1), (0, 0)))  # anchor ksize // 2
    assert kernels.element_taps("cross", 5)[0] == 2 and len(kernels.element_taps("cross", 5)[1]) == 9
    assert kernels.element_taps("ellipse", 1) == (0, ((0, 0),))


def test_dense_morph_schedule():
    th, tw = kernels.DENSE_TILE
    # the swatch program: one launch, halo 2
    assert kernels.dense_morph_schedule((1, 1), (9, 9)) == ((0, 2, th, tw, 2, 9),)
    # steps share a launch up to the halo cap, then a new launch starts
    cap = kernels.DENSE_HALO_CAP
    segs = kernels.dense_morph_schedule((1,) * (cap + 3), (9,) * (cap + 3))
    assert [(a, b, halo) for a, b, _, _, halo, _ in segs] == [(0, cap, cap), (cap, cap + 3, 3)]
    # a step larger than the cap runs alone on the full tile where it fits
    segs = kernels.dense_morph_schedule((1, 40, 1), (9, 81 * 81, 9))
    assert [(a, b, sh, sw, halo) for a, b, sh, sw, halo, _ in segs] == [(0, 1, th, tw, 1), (1, 2, th, tw, 40),
                                                                        (2, 3, th, tw, 1)]
    for seg in segs:
        assert kernels.dense_morph_smem_bytes(seg[2], seg[3], seg[4], seg[5]) <= kernels.MAX_SMEM
    # a step whose halo does not fit the full tile takes a smaller one; one that fits no tile raises
    (_, _, sh, sw, halo, most), = kernels.dense_morph_schedule((150,), (601,))  # a cross of ksize 301
    assert (sh, sw) != (th, tw) and kernels.dense_morph_smem_bytes(sh, sw, halo, most) <= kernels.MAX_SMEM
    with pytest.raises(ValueError):
        kernels.dense_morph_schedule((300,), (601 * 601,))


def emulate_dense_tiles(x: np.ndarray, steps, rng) -> np.ndarray:
    """``csrc/morph_dense.cu`` in numpy, launch by launch and tile by tile: a
    region of the tile and the launch's halo, garbage in every cell outside
    the image and in every cell a step may not read yet, two buffers, windows
    that shrink by each step's radius, coordinate tests on rim tiles only."""
    h, w = x.shape[-2:]
    table = [(op == "d", *kernels.element_taps(shape, ksize)) for shape, ksize, op in steps]
    segments = kernels.dense_morph_schedule(tuple(t[1] for t in table), tuple(len(t[2]) for t in table))
    src = x.reshape(-1, h, w)
    for start, stop, th, tw, halo, _ in segments:
        dst = rng.integers(0, 256, src.shape, dtype=np.uint8)
        ah, aw = th + 2 * halo, tw + 2 * halo
        for img in range(src.shape[0]):
            for ty in range(-(-h // th)):
                for tx in range(-(-w // tw)):
                    y0, x0 = ty * th - halo, tx * tw - halo
                    rim = y0 < 0 or x0 < 0 or y0 + ah > h or x0 + aw > w
                    a = rng.integers(0, 256, (ah, aw), dtype=np.uint8)
                    b = rng.integers(0, 256, (ah, aw), dtype=np.uint8)
                    ys, xs = np.arange(y0, y0 + ah), np.arange(x0, x0 + aw)
                    inside = ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :]
                    a[inside] = src[img][np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]][inside]
                    margin = 0
                    for is_max, radius, taps in table[start:stop]:
                        margin += radius
                        pad = 0 if is_max else 255
                        for ry in range(margin, ah - margin):
                            for rx in range(margin, aw - margin):
                                if rim and not inside[ry, rx]:
                                    continue
                                acc = pad
                                for dy, dx in taps:
                                    if rim and not (0 <= y0 + ry + dy < h and 0 <= x0 + rx + dx < w):
                                        v = pad
                                    else:
                                        v = int(a[ry + dy, rx + dx])
                                    acc = max(acc, v) if is_max else min(acc, v)
                                b[ry, rx] = acc
                        a, b = b, a
                    assert margin == halo
                    tile = a[halo : halo + th, halo : halo + tw]
                    oy, ox = ty * th, tx * tw
                    dst[img, oy : oy + th, ox : ox + tw] = tile[: max(0, h - oy), : max(0, w - ox)]
        src = dst
    return src.reshape(x.shape)


@pytest.mark.parametrize("steps", [
    (("rect", 3, "e"), ("rect", 3, "d")),
    (("rect", 3, "d"), ("rect", 3, "e")),
    (("ellipse", 5, "e"), ("cross", 3, "d"), ("rect", 2, "d")),
    (("cross", 4, "d"),),
], ids=["open", "close", "mixed", "even"])
def test_dense_tile_schedule_emulated(steps, monkeypatch):
    """The kernel's tiles, halo, margins and rim tests give the plain
    version's bytes, on an image with interior tiles, rim tiles and a ragged
    edge (small tiles keep the emulation quick)."""
    monkeypatch.setattr(kernels, "DENSE_TILE", (8, 16))
    kernels.dense_morph_schedule.cache_clear()
    try:
        rng = np.random.default_rng(7)
        for dims in ((2, 37, 61), (5, 9), (30, 50)):
            x = gray(rng, *dims)
            want = morphology.morph_dense_plain(torch.from_numpy(x), steps).numpy()
            np.testing.assert_array_equal(emulate_dense_tiles(x, steps, rng), want, err_msg=str(dims))
    finally:
        kernels.dense_morph_schedule.cache_clear()


def test_dense_tile_schedule_emulated_over_two_launches(monkeypatch):
    monkeypatch.setattr(kernels, "DENSE_TILE", (8, 16))
    monkeypatch.setattr(kernels, "DENSE_HALO_CAP", 2)
    kernels.dense_morph_schedule.cache_clear()
    try:
        rng = np.random.default_rng(8)
        steps = morphology.morph_program("rect", 3, 2, "ed") + (("ellipse", 7, "d"),)
        assert len(kernels.dense_morph_schedule((1, 1, 1, 1, 3), (9, 9, 9, 9, 29))) == 3
        x = gray(rng, 2, 21, 40)
        want = morphology.morph_dense_plain(torch.from_numpy(x), steps).numpy()
        np.testing.assert_array_equal(emulate_dense_tiles(x, steps, rng), want)
    finally:
        kernels.dense_morph_schedule.cache_clear()


def test_dense_step_table_packs_signed_taps():
    table, radii, counts = kernels._dense_table((("rect", 2, "e"), ("cross", 3, "d")), torch.device("cpu"))
    t = table.tolist()
    assert radii == (1, 1) and counts == (4, 5)
    assert t[:8] == [0, 1, 4, 8, 1, 1, 5, 12]
    taps = [((v >> 16), ((v & 0xFFFF) ^ 0x8000) - 0x8000) for v in t[8:]]  # an arithmetic shift, a sign-extended short
    assert taps == list(kernels.element_taps("rect", 2)[1]) + list(kernels.element_taps("cross", 3)[1])


# --- swatch mode through the runner ------------------------------------------------

PALETTE = [(20, 20, 20), (40, 60, 200), (140, 180, 220), (235, 230, 225)]
NAMES = ["layer_dark", "layer_mid", "layer_skin", "layer_light"]


@pytest.fixture(scope="module", params=[71, 83])
def swatch_runs(request, tmp_path_factory):
    """Model: the JAX package's ``test_swatch_mode_mask_oracle``.  Swatches 0
    and 2 are given as they are (the as-is order wins) and 1 and 3 reversed
    (the RGB→BGR order wins)."""
    import cv2

    from plotweave.config import load_config as jax_load
    from plotweave.pipeline import run_pipeline as jax_run
    from plotweave_torch.config import load_config
    from plotweave_torch.pipeline import run_pipeline

    rng = np.random.default_rng(request.param)
    base = tmp_path_factory.mktemp("torch_swatch")
    w, h = int(rng.integers(150, 260)), int(rng.integers(130, 220))
    img = np.zeros((h, w, 3), np.uint8)
    img[:, :] = PALETTE[-1]
    for c in PALETTE:
        for _ in range(3):
            x, y, r = int(rng.integers(0, w)), int(rng.integers(0, h)), int(rng.integers(12, 55))
            if rng.random() < 0.5:
                cv2.circle(img, (x, y), r, c, -1)
            else:
                cv2.rectangle(img, (x, y), (x + r, y + int(r * 0.8)), c, -1)
    img = np.clip(img.astype(np.int16) + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)
    cv2.imwrite(str(base / "img.png"), img)
    cfg = {"input_image": str(base / "img.png"), "color_names": NAMES, "extraction_mode": "swatch",
           "colors": [list(c) if i % 2 == 0 else list(c[::-1]) for i, c in enumerate(PALETTE)],
           "color_tolerance": int(rng.integers(12, 40)), "target_width_mm": 120, "target_height_mm": 150,
           "pixels_per_mm": 3, "pen_width_px": 8, "pen_radius_px": 4, "raster_device": "cpu"}
    outs = {}
    for tag, load, run in (("jax", jax_load, jax_run), ("port", load_config, run_pipeline)):
        out = base / tag
        out.mkdir()
        (out / "config.json").write_text(json.dumps(dict(cfg, output_dir=str(out))))
        run(load(str(out / "config.json")), 1, 13)
        outs[tag] = out
    return outs, img, cfg


@pytest.mark.parametrize("fname", ["mask.png", "edges.png", "contours.pkl", "lines_cross.pkl", "plot_stream.bin"])
def test_swatch_mode_through_the_runner(swatch_runs, fname):
    import cv2

    outs, _, _ = swatch_runs
    assert not (outs["port"] / "palette_by_name.json").exists()  # swatch mode writes none
    if fname == "plot_stream.bin":
        assert (outs["port"] / fname).read_bytes() == (outs["jax"] / fname).read_bytes()
        return
    for layer in NAMES:
        a, b = outs["port"] / layer / fname, outs["jax"] / layer / fname
        if fname.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(str(a), 0), cv2.imread(str(b), 0), err_msg=layer)
        else:
            x, y = pickle.loads(a.read_bytes()), pickle.loads(b.read_bytes())
            assert len(x) == len(y), layer
            for p, q in zip(x, y):
                np.testing.assert_array_equal(np.asarray(p), np.asarray(q))


def test_swatch_mode_both_channel_orders_win(swatch_runs):
    _, img, cfg = swatch_runs
    tol = cfg["color_tolerance"]
    won = []
    for raw in cfg["colors"]:
        nz = []
        for cand in (raw[::-1], raw):
            lo, hi = np.maximum(np.array(cand) - tol, 0), np.minimum(np.array(cand) + tol, 255)
            nz.append(int((np.all(img >= lo, axis=2) & np.all(img <= hi, axis=2)).sum()))
        won.append("as-is" if nz[1] > nz[0] else "reversed")
    # the gray swatches read the same both ways: the first candidate keeps them
    assert won[1] == "reversed" and won[2] == "as-is" and len(set(won)) == 2


def test_swatch_mode_needs_enough_colours(tmp_path):
    from plotweave_torch.config import PipelineConfig
    from plotweave_torch.stages.s02_color_extract import swatch_mode

    cfg = PipelineConfig(output_dir=str(tmp_path), colors=[[1, 2, 3]], color_names=["a", "b"], raster_device="cpu")
    with pytest.raises(RuntimeError, match="swatch mode"):
        swatch_mode(cfg, np.zeros((4, 4, 3), np.uint8))
