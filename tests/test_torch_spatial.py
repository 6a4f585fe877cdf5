"""plotweave_torch's row sharding against the JAX package's, on the CPU.

Each per-shard program of ``plotweave_torch/parallel/spatial.py`` runs over
n slabs of the host (n = 1, 2, 4, 5, 8) and must give the bytes of its JAX
twin run under ``shard_map`` over the first n of the 8 virtual CPU devices
(``tests/conftest.py``): the halo exchange in each border mode, the
morphology programs, the blur, Canny with its hysteresis (a checkerboard
that drives Sobel to ±1020, and a weak edge that crosses every shard from a
strong seed in the last one, so the changed flag has to go round several
times) and thinning (a thick disc that takes many iterations, and the same
stopped at a small ``max_iter``).  The sharded chain must equal the JAX
package's ``sharded_chain`` and the port's unsharded ``chain_from_clean``,
also with an outsized edge kernel and its fitted shard count; the sharded
front-ends the JAX package's, their labels checked by the near-tie rule of
``tests/test_torch_frontend.py``.  Over several CUDA devices every sharded
program raises before it touches a tensor.  Each JAX program is built once
per module (``jax_program``).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from plotweave.config import PipelineConfig as JaxPipelineConfig
from plotweave.ops.frontend import assign_nearest as jax_assign_nearest
from plotweave.parallel import spatial as jspatial
from plotweave.parallel._compat import shard_map
from plotweave.stages.s02_color_extract import _chain_from_clean, _resolve_shard_n
from plotweave_torch.config import PipelineConfig
from plotweave_torch.ops.canny import _sobel_pair
from plotweave_torch.ops.frontend import assign_nearest, nearest_gaps
from plotweave_torch.parallel.mesh import make_mesh
from plotweave_torch.parallel.spatial import (
    blur_halo, canny_halo, gather_rows, grid_frontend, morph_prog_halo, sharded_chain, spatial_frontend, split_rows,
    thin_halo, with_halo)
from plotweave_torch.stages.s02_color_extract import chain_from_clean, resolve_shard_n

CPU = torch.device("cpu")
NS = (1, 2, 4, 5, 8)
NEAR_TIE = 0.01
CENTERS = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
CHAIN_ARGS = (3, 1, 1, 7, 22, 70)  # mk, oi, ci, bk, lo, hi


def jax_mesh(n: int, names=("space",), shape=None) -> JaxMesh:
    return JaxMesh(np.array(jax.devices("cpu")[:n]).reshape(shape or (n,)), names)


def host_mesh(n: int, names=("space",), shape=None):
    return make_mesh(shape or (n,), names, devices=[CPU] * n)


@lru_cache(maxsize=None)
def jax_program(op: str, n: int, ndim: int, args: tuple):
    """The JAX twin ``op`` under ``shard_map`` over n CPU devices, rows (axis
    -2) split, jitted: built once per (op, n, rank, arguments)."""
    body = {
        "halo": lambda h, border: lambda x: jspatial._with_halo_b(x, h, border),
        "morph": lambda shape, ksize, it, prog: lambda x: jspatial._morph_prog_halo(x, shape, ksize, it, prog),
        "blur": lambda ksize: lambda x: jspatial._blur_halo_b(x, ksize),
        "canny": lambda lo, hi: lambda x: jspatial._canny_halo_b(x, lo, hi),
        "thin": lambda max_iter: lambda x: jspatial._thin_halo_b(x, max_iter),
    }[op](*args)
    spec = P(*([None] * (ndim - 2)), "space", None)
    return jax.jit(shard_map(body, mesh=jax_mesh(n), in_specs=(spec,), out_specs=spec, check_rep=False))


def run_both(op: str, x: np.ndarray, n: int, args: tuple, port):
    """(the JAX twin's output, the port's slabs joined) on the same input."""
    ref = np.asarray(jax_program(op, n, x.ndim, args)(x))
    return ref, gather_rows(port(split_rows(x, [CPU] * n), *args)).numpy()


def gray(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


# --- the halo exchange and the stencils --------------------------------------------------------


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("border", ["zero", "reflect", "edge"])
def test_with_halo_matches_jax(border, n):
    """Shards of exactly 8 rows (``MIN_ROWS_PER_SHARD``), a 3-row halo: each
    widened slab, in order, is the JAX shard's."""
    x = gray(n, (2, 8 * n, 13))
    ref = np.asarray(jax_program("halo", n, 3, (3, border))(x))
    got = torch.cat(with_halo(split_rows(x, [CPU] * n), 3, border), dim=-2).numpy()
    assert got.shape == (2, n * 14, 13)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("shape,ksize,iterations,program", [("ellipse", 7, 2, "ed"), ("rect", 3, 1, "de"),
                                                            ("cross", 5, 1, "ed")])
def test_morph_prog_halo_matches_jax(shape, ksize, iterations, program, n):
    ref, got = run_both("morph", gray(10 + n, (2, 8 * n, 19)), n, (shape, ksize, iterations, program),
                        morph_prog_halo)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ksize", [3, 7])
def test_blur_halo_matches_jax(ksize, n):
    ref, got = run_both("blur", gray(20 + n, (2, 8 * n, 21)), n, (ksize,), blur_halo)
    np.testing.assert_array_equal(got, ref)


def checkerboard(h: int = 80, w: int = 48) -> np.ndarray:
    """8-pixel blocks of 0 and 255 and a band of 6-pixel stripes: Sobel at
    its ±1020 ceiling, every NMS sector lit."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (((yy // 8) + (xx // 8)) % 2).astype(np.uint8) * 255
    img[50:62] = np.where(np.arange(w) % 12 < 6, 255, 0)[None, :]
    return img[None]


def weak_edge(h: int = 80, w: int = 48) -> np.ndarray:
    """A vertical step of magnitude 40 (weak between 22 and 70) down every
    row, reaching strong (160) only in the last 6 rows."""
    img = np.zeros((1, h, w), np.uint8)
    img[:, :, 20:] = 10
    img[:, -6:, 20:] = 40
    return img


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("image", [checkerboard, weak_edge], ids=["checkerboard", "weak-edge"])
def test_canny_halo_matches_jax(image, n):
    x = image()
    ref, got = run_both("canny", x, n, (22, 70), canny_halo)
    np.testing.assert_array_equal(got, ref)
    if image is checkerboard:
        gx, gy = _sobel_pair(torch.from_numpy(x))
        assert int(gx.abs().max()) == int(gy.abs().max()) == 1020
    else:
        # the strong seed's edge grew through every shard up to the first row
        assert ref[0, 0].any() and ref[0, -1].any()


def thick_disc(h: int = 80, w: int = 48) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    disc = ((yy - 40) ** 2 + (xx - 24) ** 2 <= 30**2) | ((yy > 5) & (yy < 75) & (xx > 30) & (xx < 44))
    return disc.astype(np.uint8)[None] * 255


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("max_iter", [120, 4])
def test_thin_halo_matches_jax(max_iter, n):
    """A disc 60 pixels across: its thinning takes many iterations, each
    crossing the shards' edges; ``max_iter`` 4 stops it half way."""
    ref, got = run_both("thin", thick_disc(), n, (max_iter,), thin_halo)
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < (thick_disc() > 0).sum()


# --- the sharded chain and front-ends ----------------------------------------------------------


def packed_labels(seed: int, k: int, h: int, w: int) -> np.ndarray:
    labels = np.random.default_rng(seed).integers(0, k, (h, w))
    return np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])


@pytest.mark.parametrize("n", NS)
def test_sharded_chain_matches_jax_and_the_unsharded_chain(n):
    k, h, w = 4, 120, 90  # 120 rows split over 1, 2, 4, 5 and 8 shards
    packed = packed_labels(n, k, h, w)
    ref = np.asarray(jspatial.sharded_chain(jax_mesh(n), packed, w, *CHAIN_ARGS))
    got = sharded_chain(host_mesh(n), packed, w, *CHAIN_ARGS)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (2 * k * h * -(-w // 8),)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, chain_from_clean(packed, w, *CHAIN_ARGS, device=CPU))
    assert np.unpackbits(ref).any()


def test_outsized_edge_kernel_fits_the_shard_count_and_matches_jax(capsys):
    """An edge kernel of 21 (radius 10) caps 8 requested shards of 64 rows at
    4, as the JAX package does, and the sharded chain over 4 stays exact."""
    cfg = dict(shard_rows=8, edge_morph_kernel=21, edge_morph_open_iters=1, edge_morph_close_iters=1,
               raster_device="cpu")
    n = resolve_shard_n(PipelineConfig(**cfg), 64, 96)
    mine = capsys.readouterr().out
    assert n == _resolve_shard_n(JaxPipelineConfig(**cfg), 64, 96) == 4
    assert "stencil radius 10" in mine and mine == capsys.readouterr().out
    k, h, w = 4, 64, 96
    packed = packed_labels(4, k, h, w)
    args = (w, 21, 1, 1, 7, 22, 70)
    ref = np.asarray(jspatial.sharded_chain(jax_mesh(n), packed, *args))
    np.testing.assert_array_equal(sharded_chain(host_mesh(n), packed, *args).numpy(), ref)
    np.testing.assert_array_equal(ref, np.asarray(_chain_from_clean(packed, *args)))


def label_flips(img: np.ndarray) -> int:
    """Pixels whose labels differ between the packages; fail unless each is
    a near tie (``tests/test_torch_frontend.py``)."""
    ours = assign_nearest(torch.from_numpy(img), CENTERS, 4).numpy()
    diff = ours != np.asarray(jax_assign_nearest(img, CENTERS, 4))
    if diff.any():
        assert nearest_gaps(img[diff], CENTERS).max() <= NEAR_TIE
    return int(diff.sum())


def poster(seed: int, h: int = 128, w: int = 96) -> np.ndarray:
    """Four tones over smooth regions, with noise: every layer has edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = sum(np.sin(rng.uniform(0.05, 0.3) * yy + rng.uniform(0.05, 0.3) * xx + rng.uniform(0, 6.3))
                for _ in range(3))
    bands = np.digitize(field, np.quantile(field, [0.25, 0.5, 0.75]))
    palette = np.array([[30, 25, 20], [70, 90, 190], [140, 175, 220], [225, 220, 215]], np.int16)
    return np.clip(palette[bands] + rng.integers(-30, 31, (h, w, 3)), 0, 255).astype(np.uint8)


def extreme_image() -> np.ndarray:
    """``tests/test_parallel.py``'s checkerboard, noise band and stripes."""
    rng = np.random.default_rng(17)
    board = np.repeat(checkerboard(128, 96)[0, ..., None], 3, axis=2)
    board[40:72] = rng.integers(0, 256, (32, 96, 3))
    board[96:112] = np.where((np.arange(96) % 12 < 6)[None, :, None], 255, 0)
    return board


@pytest.mark.parametrize("n,image", [(1, "poster"), (2, "poster"), (4, "poster"), (8, "poster"), (8, "extreme")])
def test_spatial_frontend_matches_jax(n, image):
    img = poster(11) if image == "poster" else extreme_image()
    assert label_flips(img) == 0  # equal labels: everything after them must be byte-equal
    ref_e, ref_s = jspatial.spatial_frontend(jax_mesh(n), img, CENTERS, k=4)
    e, s = spatial_frontend(host_mesh(n), img, CENTERS, k=4)
    assert e.dtype == s.dtype == torch.uint8 and tuple(e.shape) == tuple(s.shape) == (4, 128, 96)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))
    assert int((e > 0).sum()) > 100 and s.any()


def test_grid_frontend_matches_jax():
    """4 images over data 2 × space 4 (``tests/test_parallel.py``'s grid)."""
    imgs = np.stack([poster(13 + i, 64, 48) for i in range(4)])
    assert label_flips(imgs) == 0
    ref_e, ref_s = jspatial.grid_frontend(jax_mesh(8, ("data", "space"), (2, 4)), imgs, CENTERS, k=4)
    e, s = grid_frontend(host_mesh(8, ("data", "space"), (2, 4)), imgs, CENTERS, k=4)
    assert tuple(e.shape) == (4, 4, 64, 48)
    np.testing.assert_array_equal(e.numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ref_s))


# --- what the twins refuse ------------------------------------------------------------------------


def test_several_cuda_devices_raise_item_10b_before_any_work():
    """No plain op runs on a card and nothing falls back to the unsharded
    chain: over two CUDA devices (one card named twice) each sharded program
    raises, naming Item 10b, before it reads its input."""
    cards = [torch.device("cuda", 0)] * 2
    space = make_mesh((2,), ("space",), devices=cards)
    not_an_input = object()  # any use of it would raise something else
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue 1, Item 10b"):
        sharded_chain(space, not_an_input, 90, *CHAIN_ARGS)
    with pytest.raises(NotImplementedError, match="Item 10b"):
        spatial_frontend(space, not_an_input, CENTERS)
    with pytest.raises(NotImplementedError, match="Item 10b"):
        grid_frontend(make_mesh((1, 2), ("data", "space"), devices=cards), not_an_input, CENTERS)


def test_the_slab_programs_refuse_a_card_and_short_slabs():
    slab = torch.zeros((1, 8, 16), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="Item 10b"):
        blur_halo([slab, slab.to("meta")], 3)
    with pytest.raises(ValueError, match="border"):
        with_halo([slab], 1, "wrap")
    with pytest.raises(ValueError, match="cannot give 3 halo rows"):
        with_halo([slab, slab[:, :2]], 3, "zero")
    with pytest.raises(ValueError, match="cannot reflect 8 rows"):
        with_halo([slab], 8, "reflect")
    with pytest.raises(ValueError, match="split evenly"):
        split_rows(np.zeros((1, 10, 4), np.uint8), [CPU] * 4)
    # one slab is both edge shards: a zero or replicate border needs no rows of its own
    one = with_halo([slab[:, :1]], 3, "edge")[0]
    assert tuple(one.shape) == (1, 7, 16)
