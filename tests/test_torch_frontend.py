"""plotweave_torch's fused raster front-end vs the JAX package's, on the CPU.

The labels come from float Lab distances, so they are compared by a near-tie
rule: a label may differ only where the two nearest centres' float64
distances differ by at most ``NEAR_TIE`` (measured over all 2^24 BGR colours
against the JAX package: at most 0.0018).  Everything after the labels is
integer, so from the same labels the port must be byte-equal.  The JAX route
``pallas_thinning=True`` runs only in interpret mode on the CPU, so its
reference is ``zhang_suen_pallas(edges, interpret=True)`` on the JAX
front-end's own edges.  The kernels (K1, K2, K3+K4, K5, K6, K7, K12) are held
against these plain versions on the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from plotweave.ops.colorspace import bgr_to_lab_u8 as jax_bgr_to_lab_u8
from plotweave.ops.frontend import assign_nearest as jax_assign_nearest
from plotweave.ops.frontend import raster_frontend as jax_raster_frontend
from plotweave.ops.pallas_kernels import zhang_suen_pallas
from plotweave.ops.thinning import pack_bitboards as jax_pack_bitboards
from plotweave_torch.ops.colorspace import _div, _srgb_gamma_inv, bgr_to_lab_u8
from plotweave_torch.ops.frontend import (
    assign_boards, assign_nearest, frontend_from_boards, frontend_from_labels, nearest_gaps, onehot_boards,
    raster_frontend)
from plotweave_torch.ops.thinning import bitboards_to_jax

REPO = Path(__file__).resolve().parent.parent
NEAR_TIE = 0.01
BENCH_CENTERS = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
# k = 8, one centre per pen of the plotter, spread over Lab
PEN_CENTERS = np.array(
    [[30, 128, 128], [60, 150, 100], [90, 110, 160], [120, 170, 170], [150, 90, 120],
     [180, 140, 200], [210, 120, 90], [245, 128, 128]], np.float32)


def colour_sample(seed: int, n: int) -> np.ndarray:
    """(sqrt n, sqrt n, 3) uint8 BGR: a seeded sample of n colours."""
    side = int(round(n**0.5))
    return np.random.default_rng(seed).integers(0, 256, (side, side, 3)).astype(np.uint8)


def poster(seed: int, shape) -> np.ndarray:
    """(..., H, W, 3) uint8 BGR: four tones over smooth regions with noise,
    so every layer has masks, edges and skeletons."""
    rng = np.random.default_rng(seed)
    *lead, h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    field = np.zeros((*lead, h, w))
    for _ in range(4):
        fy, fx = rng.uniform(0.04, 0.3, 2)
        field = field + np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3, (*lead, 1, 1)))
    bands = np.digitize(field, np.quantile(field, [0.25, 0.5, 0.75]))
    palette = np.array([[30, 25, 20], [70, 90, 190], [140, 175, 220], [225, 220, 215]], np.int16)
    img = palette[bands] + rng.integers(-40, 41, (*lead, h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def label_flips(img: np.ndarray, centers: np.ndarray, ours: np.ndarray, ref: np.ndarray) -> int:
    """Count the pixels whose labels differ; fail if any of them is not a
    near tie (float64 gap between its two nearest centres > NEAR_TIE)."""
    diff = ours != ref
    if diff.any():
        gaps = nearest_gaps(img[diff], centers)
        assert gaps.max() <= NEAR_TIE, f"labels differ beyond a near tie: gaps {gaps.max()}"
    return int(diff.sum())


def test_bgr_to_lab_u8_matches_jax():
    img = colour_sample(0, 2**20)
    ref = np.asarray(jax_bgr_to_lab_u8(img))
    got = bgr_to_lab_u8(torch.from_numpy(img)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-3


@pytest.mark.parametrize("centers,flips", [(BENCH_CENTERS, 0), (PEN_CENTERS, 0)], ids=["bench-k4", "pens-k8"])
def test_assign_nearest_near_ties(centers, flips):
    img = colour_sample(1, 2**20)
    k = len(centers)
    ref = np.asarray(jax_assign_nearest(img, centers, k))
    got = assign_nearest(torch.from_numpy(img), centers, k)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    assert label_flips(img, centers, got.numpy(), ref) == flips


def test_assign_nearest_centers_on_another_device():
    img = torch.zeros((2, 3, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="centers"):
        assign_nearest(img, torch.from_numpy(BENCH_CENTERS).to("meta"), 4)
    with pytest.raises(ValueError, match="centers"):
        assign_nearest(img, BENCH_CENTERS[:2], 4)


def test_gamma_table_is_the_plain_gamma_bit_for_bit():
    """Kernel K7 looks the sRGB gamma up in a table of its 256 possible
    inputs, filled by the function it replaces: the lookup gives the plain
    version's bits for every pixel value, in any order and shape."""
    table = _srgb_gamma_inv(_div(torch.arange(256, dtype=torch.float32), 255.0))
    img = torch.from_numpy(colour_sample(11, 2**16))
    direct = _srgb_gamma_inv(_div(img.to(torch.float32), 255.0))
    assert torch.equal(table[img.long()].view(torch.int32), direct.view(torch.int32))
    assert table[0] == 0 and table[255] == 1 and bool((table[1:] > table[:-1]).all())
    from plotweave.ops.colorspace import _srgb_gamma_inv as jax_gamma_inv

    ref = np.asarray(jax_gamma_inv(np.arange(256, dtype=np.float32) / np.float32(255.0)))
    assert np.abs(table.numpy() - ref).max() <= 1e-6


@pytest.mark.parametrize("shape,k", [((37, 45), 4), ((2, 19, 70), 8), ((3, 1), 3), ((1, 32), 1)],
                         ids=["37x45-k4", "batch-k8", "3x1-k3", "1x32-k1"])
def test_onehot_boards_match_jax(shape, k):
    """The plain one-hot boards (K7's second output, K1's labels -> boards)
    are the JAX front-end's ``pack_bitboards(labels == arange(k))``."""
    img = colour_sample(12, 2**14).reshape(-1, 3)[: int(np.prod(shape))].reshape(*shape, 3)
    centers = PEN_CENTERS[:k]
    labels = np.asarray(jax_assign_nearest(img, centers, k))
    ref = np.asarray(jax_pack_bitboards(labels[..., None, :, :] == np.arange(k)[:, None, None]))
    got = onehot_boards(torch.from_numpy(np.array(labels)), k)
    assert got.dtype == torch.int32 and tuple(got.shape) == (*shape[:-2], k, shape[-2], -(-shape[-1] // 32))
    np.testing.assert_array_equal(bitboards_to_jax(got), ref)
    ours = assign_nearest(torch.from_numpy(img), centers, k)
    assert torch.equal(assign_boards(torch.from_numpy(img), centers, k), onehot_boards(ours, k))


def jax_frontend(img, **kw):
    e, s = jax_raster_frontend(img, BENCH_CENTERS, k=4, **kw)
    return np.asarray(e), np.asarray(s)


@pytest.mark.parametrize("seed,shape", [(2, (64, 80)), (3, (96, 128)), (4, (2, 48, 72))],
                         ids=["64x80", "96x128", "batch2"])
def test_frontend_from_labels_byte_equal(seed, shape):
    """From the JAX package's own labels, the port's post-assign steps give
    the JAX front-end's bytes."""
    img = poster(seed, shape)
    labels = np.asarray(jax_assign_nearest(img, BENCH_CENTERS, 4))
    edges, skel = frontend_from_labels(torch.from_numpy(np.array(labels)), 4)
    ref_e, ref_s = jax_frontend(img)
    assert edges.dtype == torch.uint8 and skel.dtype == torch.uint8
    np.testing.assert_array_equal(edges.numpy(), ref_e)
    np.testing.assert_array_equal(skel.numpy(), ref_s)
    assert ref_s.any() and (ref_s.reshape(-1, *ref_s.shape[-2:]).any(axis=(-2, -1))).all()


@pytest.mark.parametrize("pallas_thinning", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("seed,shape", [(12, (64, 80)), (13, (50, 97))], ids=["64x80", "50x97"])
def test_frontend_from_boards_byte_equal(seed, shape, pallas_thinning):
    """From the one-hot boards of the JAX package's own labels, the port's
    front-end over boards gives the JAX front-end's bytes on both thinning
    routes."""
    img = poster(seed, shape)
    labels = np.asarray(jax_assign_nearest(img, BENCH_CENTERS, 4))
    boards = onehot_boards(torch.from_numpy(np.array(labels)), 4)
    edges, skel = frontend_from_boards(boards, shape[-1], pallas_thinning=pallas_thinning)
    ref_e, ref_s = jax_frontend(img)
    if pallas_thinning:
        ref_s = np.asarray(zhang_suen_pallas(ref_e, max_iter=120, rotated=True, interpret=True)).astype(np.uint8)
    assert edges.dtype == torch.uint8 and skel.dtype == torch.uint8
    np.testing.assert_array_equal(edges.numpy(), ref_e)
    np.testing.assert_array_equal(skel.numpy(), ref_s)
    assert ref_s.any()


@pytest.mark.parametrize("pallas_thinning", [False, True], ids=["packed", "dense"])
@pytest.mark.parametrize("seed,shape", [(5, (64, 80)), (6, (96, 128))], ids=["64x80", "96x128"])
def test_raster_frontend_matches_jax(seed, shape, pallas_thinning):
    img = poster(seed, shape)
    labels = assign_nearest(torch.from_numpy(img), BENCH_CENTERS, 4).numpy()
    assert label_flips(img, BENCH_CENTERS, labels, np.asarray(jax_assign_nearest(img, BENCH_CENTERS, 4))) == 0
    edges, skel = raster_frontend(torch.from_numpy(img), BENCH_CENTERS, pallas_thinning=pallas_thinning)
    ref_e, ref_s = jax_frontend(img)
    if pallas_thinning:
        ref_s = np.asarray(zhang_suen_pallas(ref_e, max_iter=120, rotated=True, interpret=True)).astype(np.uint8)
    assert tuple(edges.shape) == (4, *shape) and tuple(skel.shape) == (4, *shape)
    np.testing.assert_array_equal(edges.numpy(), ref_e)
    np.testing.assert_array_equal(skel.numpy(), ref_s)


def test_raster_frontend_batch_matches_jax():
    img = poster(7, (2, 64, 80))
    labels = assign_nearest(torch.from_numpy(img), BENCH_CENTERS, 4).numpy()
    assert label_flips(img, BENCH_CENTERS, labels, np.asarray(jax_assign_nearest(img, BENCH_CENTERS, 4))) == 0
    edges, skel = raster_frontend(torch.from_numpy(img), torch.from_numpy(BENCH_CENTERS), k=4)
    ref_e, ref_s = jax_frontend(img)
    assert tuple(skel.shape) == (2, 4, 64, 80)
    np.testing.assert_array_equal(edges.numpy(), ref_e)
    np.testing.assert_array_equal(skel.numpy(), ref_s)


def test_raster_frontend_parameters_match_jax():
    """Non-default parameters reach every step as in the JAX front-end."""
    img = poster(8, (72, 90))
    kw = dict(extract_iters=2, edge_kernel=5, edge_iters=2, blur_kernel=5, low=30, high=90, thin_iters=3)
    edges, skel = raster_frontend(torch.from_numpy(img), BENCH_CENTERS, k=3, **kw)
    e, s = jax_raster_frontend(img, BENCH_CENTERS, k=3, **kw)
    np.testing.assert_array_equal(edges.numpy(), np.asarray(e))
    np.testing.assert_array_equal(skel.numpy(), np.asarray(s))


def test_pallas_thinning_rejects_a_batch():
    """The dense route no longer rejects a batch (``frontend_batch`` runs it):
    its images are more planes of K12, where the JAX kernel takes none.
    Each image's outputs are its solo call's, and the skeletons are
    ``zhang_suen_pallas`` of the batch's edges, one image at a time."""
    img = torch.from_numpy(poster(9, (2, 32, 40)))
    edges, skel = raster_frontend(img, BENCH_CENTERS, pallas_thinning=True)
    assert tuple(skel.shape) == (2, 4, 32, 40)
    for i in range(2):
        e, s = raster_frontend(img[i], BENCH_CENTERS, pallas_thinning=True)
        assert torch.equal(edges[i], e) and torch.equal(skel[i], s)
        ref_s = np.asarray(zhang_suen_pallas(edges[i].numpy(), max_iter=120, rotated=True, interpret=True))
        np.testing.assert_array_equal(skel[i].numpy(), ref_s.astype(np.uint8))
    assert skel.any()


def test_entry_cpu():
    from plotweave_torch.entry import _example_centers, entry

    import __graft_entry__

    np.testing.assert_array_equal(_example_centers(), __graft_entry__._example_centers())
    fn, (image, centers) = entry("cpu")
    _, (jimage, _) = __graft_entry__.entry()
    np.testing.assert_array_equal(image.numpy(), jimage)
    edges, skel = fn(image, centers)
    assert tuple(edges.shape) == tuple(skel.shape) == (4, 512, 512)
    assert edges.device.type == "cpu" and skel.dtype == torch.uint8


def test_entry_auto_raises_without_cuda(monkeypatch):
    from plotweave_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry("auto")


def test_entry_subprocess_imports_no_jax():
    code = (
        "import sys\n"
        "from plotweave_torch.entry import entry\n"
        "fn, args = entry('cpu')\n"
        "edges, skel = fn(*args)\n"
        "assert 'jax' not in sys.modules, 'plotweave_torch imported jax'\n"
        "bad = [m for m in sys.modules if m == 'plotweave' or m.startswith('plotweave.')]\n"
        "assert not bad, f'plotweave_torch imported {bad}'\n"
        "print('NO_JAX_OK', tuple(skel.shape))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO_JAX_OK (4, 512, 512)" in res.stdout
