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
``tests/test_torch_frontend.py``.  These run the schedule that the card runs,
with the kernels' plain slab versions.  Over mocked cards (tensors that say
they lie on a card; ``CardTensor``) every sharded program launches the slab
kernels' wrappers and nothing else: any plain op on such a tensor fails.
Each JAX program is built once per module (``jax_program``).
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
from plotweave_torch.ops.kernels import STATS
from plotweave_torch.parallel.spatial import (
    RoundFlags, _hysteresis_rounds, _thin_rounds, blur_halo, canny_halo, grid_frontend, morph_prog_halo, sharded_chain,
    spatial_frontend, split_rows, thin_halo, widen)
from plotweave_torch.stages.s02_color_extract import chain_from_clean, resolve_shard_n

import mocked_cards
from mocked_cards import CardTensor, card, cards, launches, on_mocked_cards, plain

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


def gather_rows(slabs) -> torch.Tensor:
    """The slabs joined along their rows on the host."""
    return torch.cat([s.cpu() for s in slabs], dim=-2)


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
    buffer of the card schedule's exchange (``widen``), in order, is the JAX
    shard's widened slab (``_with_halo_b``) less the rows it builds at the
    image's border in each border mode, which ``widen`` leaves to the slab
    modes."""
    x = gray(n, (2, 8 * n, 13))
    ref = np.asarray(jax_program("halo", n, 3, (3, border))(x))
    assert ref.shape == (2, n * 14, 13)
    for i, (buf, top, bottom) in enumerate(widen(split_rows(x, [CPU] * n), 3)):
        assert (top, bottom) == (3 if i > 0 else 0, 3 if i < n - 1 else 0)
        np.testing.assert_array_equal(buf.numpy(), ref[:, i * 14 + 3 - top : (i + 1) * 14 - 3 + bottom])


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


# --- the card route, on mocked cards ------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_several_cuda_devices_raise_item_10b_before_any_work(monkeypatch, n):
    """Over several CUDA devices (mocked: tensors that say they lie on a
    card) each sharded program launches the slab kernels' wrappers, K2 and
    K3+K4 once a shard, K5 and K6 once a shard a round, and moves rows by
    copies: no plain op on a card, no unsharded kernel, no fallback to the
    CPU.  Its bytes are those of the CPU mesh."""
    calls = on_mocked_cards(monkeypatch)
    devices = [torch.device("cuda", i) for i in range(n)]
    k, h, w = 4, 120, 90
    packed = packed_labels(n, k, h, w)
    with cards():
        mocked_cards.PEER_COPIES.clear()
        blob = sharded_chain(make_mesh((n,), ("space",), devices=devices), card(torch.from_numpy(packed)), w,
                             *CHAIN_ARGS)
        assert isinstance(blob, CardTensor) and blob.device == devices[0]
        assert torch.equal(plain(blob), chain_from_clean(packed, w, *CHAIN_ARGS, device=CPU))
        assert launches(calls) == {"edge_candidates_slab_cuda": n, "morph_steps_cuda": n,
                                   "hysteresis_slab_cuda": n * STATS["hysteresis_rounds"],
                                   "zhang_suen_slab_cuda": n * STATS["thinning_rounds"]}
        # halo rows between neighbouring cards, and each other card's rows of the blob, by peer copies
        peers = set(mocked_cards.PEER_COPIES)
        assert {(devices[i], devices[i + 1]) for i in range(n - 1)} <= peers
        assert {(devices[0], d) for d in devices[1:]} <= peers

        calls.clear()
        img = poster(11)
        e, s = spatial_frontend(make_mesh((n,), ("space",), devices=devices), card(torch.from_numpy(img)), CENTERS,
                                k=4)
        ref = spatial_frontend(host_mesh(n), img, CENTERS, k=4)
        assert torch.equal(plain(e), ref[0]) and torch.equal(plain(s), ref[1])
        assert launches(calls) == {"assign_boards_cuda": n, "edge_candidates_slab_cuda": n, "morph_steps_cuda": n,
                                   "hysteresis_slab_cuda": n * STATS["hysteresis_rounds"],
                                   "zhang_suen_slab_cuda": n * STATS["thinning_rounds"]}

        calls.clear()
        imgs = np.stack([poster(13 + i, 64, 48) for i in range(4)])
        grid = make_mesh((2, n), ("data", "space"), devices=devices * 2)
        e, s = grid_frontend(grid, card(torch.from_numpy(imgs)), CENTERS, k=4)
        ref = grid_frontend(host_mesh(2 * n, ("data", "space"), (2, n)), imgs, CENTERS, k=4)
        assert torch.equal(plain(e), ref[0]) and torch.equal(plain(s), ref[1])
        assert calls.count("assign_boards_cuda") == calls.count("edge_candidates_slab_cuda") == 2 * n

        calls.clear()
        slabs = split_rows(card(torch.from_numpy(gray(3, (2, 8 * n, 21)))), devices)
        assert [x.device for x in slabs] == devices
        assert torch.equal(gather_rows(blur_halo(slabs, 7)), gather_rows(blur_halo(plain(slabs), 7)))
        assert torch.equal(gather_rows(morph_prog_halo(slabs, "ellipse", 7, 1, "ed")),
                           gather_rows(morph_prog_halo(plain(slabs), "ellipse", 7, 1, "ed")))
        assert torch.equal(gather_rows(canny_halo(slabs, 22, 70)), gather_rows(canny_halo(plain(slabs), 22, 70)))
        assert torch.equal(gather_rows(thin_halo(slabs, 6)), gather_rows(thin_halo(plain(slabs), 6)))
        assert {"gaussian_blur_slab_cuda", "morph_dense_cuda", "dense_to_boards_cuda",
                "boards_to_dense_cuda"} <= set(calls)


@pytest.mark.parametrize("layout", ["rows", "dense"])
@pytest.mark.parametrize("order", [(0, 1, 0, 1), (1, 0, 0, 2), (0, 0, 1, 1)])
def test_slabs_on_several_cards_flag_and_store_apart(monkeypatch, order, layout):
    """Slabs on different mocked cards, the outputs on the first slab's: a
    round's flags are one tensor a card, each slab's slot on its card; a
    slab on another card than the outputs stores its rows into its own,
    which reach the outputs by peer copies; the thinning and hysteresis
    rounds give the bytes of the same rounds on the host."""
    from plotweave_torch.ops.thinning import pack_bitboards_plain

    calls = on_mocked_cards(monkeypatch)
    devices = [torch.device("cuda", i) for i in order]
    n, k, w = len(order), 2, 45
    x = np.zeros((k, 8 * n, w), np.uint8)
    x[0, 2:-2, 3:40] = 1  # a thick bar over every slab
    x[1, :, 20:23] = 1
    weak = x.copy()
    weak[0, :, 41:43] = 1  # a weak chain down every slab, its strong seed in the last
    strong = np.zeros_like(weak)
    strong[:, -2:] = weak[:, -2:]
    packed, cand, seeds = (pack_bitboards_plain(torch.from_numpy(a)) for a in (x, weak, strong))
    rb = w if layout == "dense" else -(-w // 8)
    want = torch.full((2, 1, k, 8 * n, rb), 0xA5, dtype=torch.uint8)
    ref = _thin_rounds(split_rows(packed, [CPU] * n), 120, (w, want[0], want[1], layout))
    ref_rounds = STATS["thinning_rounds"]
    ref_edges = _hysteresis_rounds(split_rows(cand, [CPU] * n), split_rows(seeds, [CPU] * n))
    assert STATS["hysteresis_rounds"] >= n
    with cards():
        mocked_cards.PEER_COPIES.clear()
        slabs = split_rows(card(packed), devices)
        flags = RoundFlags(slabs)
        assert {d: t.numel() for d, t in flags.tensors.items()} == {d: order.count(d.index) for d in devices}
        assert [slot.device for slot in flags.slots] == devices
        outs = card(torch.full((2, 1, k, 8 * n, rb), 0xA5, dtype=torch.uint8), devices[0])
        got = _thin_rounds(slabs, 120, (w, outs[0], outs[1], layout))
        assert STATS["thinning_rounds"] == ref_rounds and [g.device for g in got] == devices
        assert torch.equal(plain(outs), want) and all(torch.equal(plain(a), b) for a, b in zip(got, ref))
        assert {(devices[0], d) for d in devices if d != devices[0]} <= set(mocked_cards.PEER_COPIES)
        edges = _hysteresis_rounds(split_rows(card(cand), devices), split_rows(card(seeds), devices))
        assert all(torch.equal(plain(a), b) for a, b in zip(edges, ref_edges))
    assert set(calls) == {"zhang_suen_slab_cuda", "hysteresis_slab_cuda"}


def test_a_plain_op_on_a_mocked_card_fails():
    """The mock above is not vacuous: arithmetic, a reduction or a join on a
    card tensor fails; a view, an allocation and a copy do not, and each
    says which mocked card it lies on."""
    x = card(torch.zeros((2, 8, 4), dtype=torch.int32))
    for op in (lambda: x + 1, lambda: x.any(), lambda: torch.cat([x, x]), lambda: x.to(torch.int64)):
        with pytest.raises(AssertionError, match="on a card tensor"):
            op()
    y = x.new_empty((2, 4, 4), device=torch.device("cuda", 1))
    assert isinstance(y, CardTensor) and y.device == torch.device("cuda", 1) and x.device == torch.device("cuda", 0)
    assert y[:, :2].device == y.device and y.is_cuda
    x[:, :4].copy_(x[:, 4:])
    y.copy_(x[:, :4])
    assert torch.equal(plain(y), torch.zeros((2, 4, 4), dtype=torch.int32))
    with cards():
        z = torch.zeros(3, device="cuda:2")
        u = torch.ones(2).to(torch.device("cuda", 3))
    assert (z.device, u.device) == (torch.device("cuda", 2), torch.device("cuda", 3))
    assert isinstance(z, CardTensor) and torch.equal(plain(u), torch.ones(2))


# --- what the twins refuse ------------------------------------------------------------------------


def test_the_slab_programs_refuse_a_card_and_short_slabs():
    """A slab mode refuses a device it has no kernel for, and no plain
    version runs there; ``widen`` and the slab versions refuse halos their
    neighbours cannot give or their stencils cannot use; one slab is both
    edge shards and gets no halo rows."""
    from plotweave_torch.ops.canny import edge_candidates_slab, edge_candidates_slab_plain, hysteresis_slab
    from plotweave_torch.ops.filters import gaussian_blur_slab
    from plotweave_torch.ops.thinning import zhang_suen_slab

    slab = torch.zeros((1, 8, 16), dtype=torch.uint8)
    meta = torch.zeros((1, 14, 1), dtype=torch.int32, device="meta")
    flag = torch.empty(1, dtype=torch.int32, device="meta")
    for run in (lambda: edge_candidates_slab(meta, 16, 5, 22, 70, 3, 3),
                lambda: gaussian_blur_slab(meta.to(torch.uint8), 5, 2, 2),
                lambda: hysteresis_slab(meta[:, 1:-1], meta, 1, 1, flag),
                lambda: zhang_suen_slab(meta, 2, 2, 1, flag)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            run()
    with pytest.raises(ValueError, match="cannot give 3 halo rows"):
        widen([slab, slab[:, :2]], 3)
    with pytest.raises(ValueError, match="split evenly"):
        split_rows(np.zeros((1, 10, 4), np.uint8), [CPU] * 4)
    with pytest.raises(ValueError, match="at least 4"):
        edge_candidates_slab_plain(torch.zeros((1, 14, 16), dtype=torch.uint8), 16, 5, 22, 70, 3, 3)
    assert [(tuple(b.shape), t, u) for b, t, u in widen([slab[:, :1]], 3)] == [((1, 1, 16), 0, 0)]


# --- the dry run's twin ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_twin_on_the_cpu_pool(n, capsys):
    """``entry.dryrun_multichip`` over the CPU pool (the host named n times):
    ``grid_frontend`` (data × space as the JAX package chooses them),
    ``sharded_chain``, the three adversarial shapes and the batch runner,
    each certified byte for byte by the function itself."""
    from plotweave_torch.entry import dryrun_multichip

    dryrun_multichip(n, "cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("[dryrun]")]
    data = 2 if n == 4 else 1
    assert lines[0].startswith(f"[dryrun] mesh data={data} × space={n // data}") and len(lines) == 7
    assert lines[-1] == ("[dryrun] ALL OK: grid-2d=eq chain=eq shapes=3/3 batch=3/3 (all byte-certified vs "
                         "unsharded/sequential)")


def test_entry_module_runs_the_dry_run():
    """``python -m plotweave_torch.entry cpu`` runs ``entry()`` and then the
    dry run over the CPU pool that ``XLA_FLAGS`` sets (at least two)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-m", "plotweave_torch.entry", "cpu"], cwd=Path(__file__).parent.parent,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "entry ok: [(4, 512, 512), (4, 512, 512)]" in proc.stdout
    assert "[dryrun] mesh data=1 × space=2" in proc.stdout and "[dryrun] ALL OK" in proc.stdout
