"""The slab modes of K3+K4, K5 and K6 and the card's row-sharding schedule,
on the CPU.

A slab is a shard's own rows widened by halo rows copied from its neighbours
(``parallel.spatial.widen``); a side without halo rows is the image's border.
Here, with the JAX package as the reference (byte equality: all integer):

- each plain slab version, on every slab position of 1 to 8 shards at the
  ``MIN_ROWS_PER_SHARD`` floor and at widths of one and two words that are
  not multiples of 32, gives the rows of the unsharded function: the blur
  (``gaussian_blur_u8``), Canny's candidates, the hysteresis rounds
  (``canny_packed``) and the thinning rounds (``_thin_halo_b`` under
  ``shard_map``, the cap reached mid-round, slabs that reach their fixpoint
  in different iterations);
- K2's rule (a row outside its layer reads as the neutral value) on a slab
  widened by the summed radius of a step list gives the bytes of the JAX
  program's replicate halo, step by step (``_morph_prog_halo``);
- ``widen``'s buffers hold the halo rows of the JAX package's exchange
  (``_with_halo_b``), and no fill;
- numpy emulations of K3+K4's tiles in slab mode (``emulate_edge_tiles``:
  tiles over the own rows, the rim's rules at the buffer's ends) and of
  K6's row-offset stores (its CTAs over the slab's rows storing only the own
  rows at the slab's first row of the unsharded layers) against the plain
  versions;
- the round length and the segments that the card's schedule computes.

``chip_smoke.py`` holds the kernels to these plain versions on the card.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, PartitionSpec as P

from plotweave.ops.canny import canny_packed as jax_canny_packed
from plotweave.ops.filters import gaussian_blur_u8 as jax_blur
from plotweave.parallel import spatial as jspatial
from plotweave.parallel._compat import shard_map
from plotweave_torch.ops import kernels
from plotweave_torch.ops.canny import edge_candidates_plain, edge_candidates_slab_plain, hysteresis_slab_plain
from plotweave_torch.ops.filters import gaussian_blur_slab_plain, slab_rows
from plotweave_torch.ops.morphology import _valid_bits, morph_program, morph_steps_plain
from plotweave_torch.ops.thinning import (
    bitboards_to_jax, dense_from_boards_plain, pack_bitboards_plain, unpack_bitboards_plain, zhang_suen_slab_plain)
from plotweave_torch.parallel import spatial
from plotweave_torch.parallel.spatial import (
    MIN_ROWS_PER_SHARD, RoundFlags, _segments, _thin_rounds, split_rows, widen)

from test_torch_edge_kernels import emulate_edge_tiles
from test_torch_k1_fold import SENTINEL, store_dense_words, store_row_words

CPU = torch.device("cpu")
NS = (1, 2, 3, 4, 8)
WIDTHS = (13, 45)  # one word and two words, neither a multiple of 32


def gray(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """Smooth tones with noise, so that every threshold finds edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.sin(0.3 * yy[None] + rng.uniform(0.1, 0.5, (k, 1, 1)) * xx[None]) * 100 + 120
    return np.clip(field + rng.integers(-40, 41, (k, h, w)), 0, 255).astype(np.uint8)


def binary(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """Blobs and strokes: a 3 x 3 majority vote over noise, 0/255."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, h + 2, w + 2)) < 0.5
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return (s[:, 1 : h + 1, 1 : w + 1] >= 5).astype(np.uint8) * 255


def slabs_of(x: np.ndarray, n: int):
    return split_rows(torch.from_numpy(x), [CPU] * n)


def own_rows(x: np.ndarray, n: int, i: int) -> np.ndarray:
    rows = x.shape[-2] // n
    return x[..., i * rows : (i + 1) * rows, :]


# --- the plain slab versions against the unsharded functions ---------------------------------


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_blur_slab_is_the_unsharded_blur(ksize, n, w):
    """Slabs of 8 rows (the floor), widened by the blur's radius: each
    slab's blur is its rows of the JAX package's blur of the whole image,
    from a dense image and from a bitboard alike."""
    img = gray(ksize + n, 2, MIN_ROWS_PER_SHARD * n, w)
    ref = np.asarray(jax_blur(img, ksize))
    mask = binary(n, 2, MIN_ROWS_PER_SHARD * n, w)
    ref_b = np.asarray(jax_blur(mask, ksize))
    boards = split_rows(pack_bitboards_plain(torch.from_numpy(mask)), [CPU] * n)
    for i, ((buf, top, bottom), (bb, tb, ub)) in enumerate(zip(widen(slabs_of(img, n), ksize // 2),
                                                                widen(boards, ksize // 2))):
        np.testing.assert_array_equal(gaussian_blur_slab_plain(buf, ksize, top, bottom).numpy(), own_rows(ref, n, i))
        np.testing.assert_array_equal(gaussian_blur_slab_plain(bb, ksize, tb, ub, w).numpy(), own_rows(ref_b, n, i))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("ksize", [1, 5, 7])
def test_edge_candidates_slab_is_the_unsharded_function(ksize, n, w):
    """Canny's candidates of each slab, widened by the blur's radius plus
    two, are its rows of the unsharded function (held to the JAX package by
    ``tests/test_torch_edge_kernels.py``), from bitboards and dense images;
    two shards' worth of halo changes nothing."""
    rows = max(MIN_ROWS_PER_SHARD, 2 * (ksize // 2 + 2))
    mask = binary(ksize * 10 + n, 3, rows * n, w)
    boards = pack_bitboards_plain(torch.from_numpy(mask))
    for x in (boards, torch.from_numpy(gray(n, 3, rows * n, w))):
        ref = edge_candidates_plain(x, w, ksize, 22, 70)
        for halo in (ksize // 2 + 2, rows):
            for i, (buf, top, bottom) in enumerate(widen(split_rows(x, [CPU] * n), halo)):
                got = edge_candidates_slab_plain(buf, w, ksize, 22, 70, top, bottom)
                for g, r in zip(got, ref):
                    np.testing.assert_array_equal(g.numpy(), own_rows(r.numpy(), n, i))


def weak_chain(n: int, w: int = 45, rows: int = MIN_ROWS_PER_SHARD) -> np.ndarray:
    """A weak vertical step (magnitude 40: between 22 and 70) down every row
    of two layers, strong (160) only in the last slab's last rows, and a
    diagonal weak line: hysteresis must carry growth across every shard."""
    h = rows * n
    img = np.zeros((2, h, w), np.uint8)
    img[0, :, w // 2 :] = 10
    img[0, -3:, w // 2 :] = 40
    for y in range(h):
        img[1, y, (y * 7) % (w - 4) : (y * 7) % (w - 4) + 4] = 10
    img[1, -3:, :] = np.where(np.arange(w) % 9 < 4, 40, 0)[None, :]
    return img


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("n", NS)
def test_hysteresis_rounds_carry_a_weak_chain_across_every_shard(n, w):
    """The hysteresis rounds (K5's plain slab version on slabs widened by one
    row, the halo rows seeds that cannot grow) give the JAX package's
    unsharded edges; the weak chain crosses every shard, so it takes at
    least n rounds, and each round's flag says whether a slab's own rows
    grew."""
    img = weak_chain(n, w)
    ref = np.asarray(jax_canny_packed(img, 22, 70)[0]) > 0
    assert ref[0, 0].any()  # the strong seed's edge reached the first row
    cand, strong = edge_candidates_plain(torch.from_numpy(img), w, 1, 22, 70)
    got = spatial._hysteresis_rounds(split_rows(cand, [CPU] * n), split_rows(strong, [CPU] * n))
    np.testing.assert_array_equal(torch.cat([unpack_bitboards_plain(b, w) for b in got], dim=-2).numpy() > 0, ref)
    assert kernels.STATS["hysteresis_rounds"] >= n
    # one round by hand: the flags
    flags = RoundFlags(split_rows(cand, [CPU] * n))
    edges = split_rows(strong, [CPU] * n)
    new = [hysteresis_slab_plain(c, buf, top, bottom, f)
           for c, (buf, top, bottom), f in zip(split_rows(cand, [CPU] * n), widen(edges, 1), flags.slots)]
    for e, e2, f in zip(edges, new, flags.slots):
        assert int(f) == int(not torch.equal(e, e2))
    assert flags.any()


def thick_shapes(n: int, w: int = 45, rows: int = MIN_ROWS_PER_SHARD) -> np.ndarray:
    """A thick bar in the first slab only (many iterations), thin strokes
    elsewhere (few): the slabs reach their fixpoints in different
    iterations."""
    h = rows * n
    x = np.zeros((2, h, w), np.uint8)
    x[0, 1 : rows - 1, 2 : w - 2] = 1
    x[0, :, w // 2 : w // 2 + 2] = 1
    x[1, 1:-1, 3:12] = 1
    x[1, h // 2 :, 20:24] = 1
    return x


@lru_cache(maxsize=None)
def jax_thin(n: int, max_iter: int):
    spec = P(None, "space", None)
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n]), ("space",))
    return jax.jit(shard_map(lambda x: jspatial._thin_halo_b(x, max_iter), mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_rep=False))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("cap", ["fixpoint", "mid-round", "one-round"])
def test_thinning_rounds_match_jax(cap, n, w):
    """The thinning rounds (K6's plain slab version, rounds of m iterations
    on slabs widened by 2 m rows) against the JAX package's ``_thin_halo_b``
    under ``shard_map``: to the fixpoint, with ``max_iter`` reached in the
    middle of a round, and with a cap below one round."""
    x = thick_shapes(n, w)
    m = kernels.thinning_round(MIN_ROWS_PER_SHARD, -(-w // 32), 120)
    max_iter = {"fixpoint": 120, "mid-round": m + 3, "one-round": m - 1}[cap]
    ref = np.asarray(jax_thin(n, max_iter)(x))
    got = _thin_rounds(split_rows(pack_bitboards_plain(torch.from_numpy(x)), [CPU] * n), max_iter)
    np.testing.assert_array_equal(torch.cat([unpack_bitboards_plain(b, w) for b in got], dim=-2).numpy(), ref)
    rounds = kernels.STATS["thinning_rounds"]
    if cap == "mid-round":
        assert rounds == 2 or (n == 1 and rounds <= 2)
    elif cap == "one-round":
        assert rounds == 1
    else:
        assert 0 < ref.sum() < x.sum() and (rounds >= 2 or n == 1)


def test_thinning_flag_is_the_own_rows_last_iteration():
    """K6's flag: set where the round's last iteration changed an own row,
    not where it changed only halo rows; clear where the slab stopped at its
    fixpoint."""
    w = 45
    x = np.zeros((1, 16, w), np.uint8)
    x[0, 1:7, 2:40] = 1  # a thick bar in rows 1-6, two rows clear of row 8
    boards = pack_bitboards_plain(torch.from_numpy(x))
    flag = torch.empty(1, dtype=torch.int32)
    zhang_suen_slab_plain(boards[:, :8], 0, 0, 1, flag)  # the bar's own slab: its rows change
    assert int(flag) == 1
    own = zhang_suen_slab_plain(boards, 8, 0, 1, flag)  # the slab below: the bar is halo, its own rows stay empty
    assert int(flag) == 0 and not own.any()
    zhang_suen_slab_plain(boards[:, :8], 0, 0, 60, flag)  # to the slab's fixpoint: the last iteration changed nothing
    assert int(flag) == 0


# --- K2's neutral rows against the replicate halo --------------------------------------------------


@lru_cache(maxsize=None)
def jax_morph(n: int, shape: str, ksize: int, iterations: int, program: str):
    spec = P(None, "space", None)
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n]), ("space",))
    return jax.jit(shard_map(lambda x: jspatial._morph_prog_halo(x, shape, ksize, iterations, program), mesh=mesh,
                             in_specs=(spec,), out_specs=spec, check_rep=False))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("shape,ksize,iterations,program",
                         [("ellipse", 3, 1, "edde"), ("rect", 3, 2, "ed"), ("ellipse", 5, 1, "de"),
                          ("cross", 5, 1, "ed"), ("ellipse", 7, 1, "e")])
def test_k2_summed_radius_is_the_replicate_halo(shape, ksize, iterations, program, n):
    """K2's step list on 0/255 masks as bitboards, on slabs widened once by
    the steps' summed row radius (rows outside the buffer read as the
    neutral value), gives the JAX package's per-step replicate halo program
    byte for byte, at each slab position; where the summed radius passes a
    slab's rows, the steps go in segments, one exchange each."""
    w = 45
    steps = tuple(st for op in program for st in morph_program(shape, ksize, iterations, op))
    rows = max(MIN_ROWS_PER_SHARD, ksize // 2 + 1)
    mask = binary(7 * n + ksize, 2, rows * n, w)
    ref = np.asarray(jax_morph(n, shape, ksize, iterations, program)(mask))
    x = split_rows(pack_bitboards_plain(torch.from_numpy(mask)), [CPU] * n)
    valid = _valid_bits(w)
    for start, stop, halo in _segments([ks // 2 for _, ks, _ in steps], rows):
        x = [morph_steps_plain(buf, valid, steps[start:stop])[..., top : buf.shape[-2] - bottom, :]
             for buf, top, bottom in widen(x, halo)]
    got = torch.cat([dense_from_boards_plain(b, w, 255) for b in x], dim=-2).numpy()
    np.testing.assert_array_equal(got, ref)


# --- the widened buffers ------------------------------------------------------------------------------


@lru_cache(maxsize=None)
def jax_halo(n: int, halo: int):
    spec = P(None, "space", None)
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n]), ("space",))
    return jax.jit(shard_map(lambda x: jspatial._with_halo_b(x, halo, "zero"), mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_rep=False))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("halo", [1, 3, 8])
def test_widen_holds_with_halos_rows(halo, n):
    """Each buffer is the slab between the rows that the JAX package's
    exchange (``_with_halo_b`` under ``shard_map``) takes from its
    neighbours; the image's border gets no rows (where the JAX exchange
    builds a fill)."""
    x = gray(halo + n, 2, MIN_ROWS_PER_SHARD * n, 19)
    ref = np.asarray(jax_halo(n, halo)(x))
    wide = MIN_ROWS_PER_SHARD + 2 * halo
    for i, (buf, top, bottom) in enumerate(widen(slabs_of(x, n), halo)):
        assert (top, bottom) == ((halo if i > 0 else 0), (halo if i < n - 1 else 0))
        assert buf.is_contiguous() and buf.shape[-2] == top + MIN_ROWS_PER_SHARD + bottom
        np.testing.assert_array_equal(buf.numpy(), ref[..., i * wide + halo - top : (i + 1) * wide - halo + bottom, :])


# --- numpy emulations of the kernels' slab modes --------------------------------------------------


@pytest.mark.parametrize("position", ["top", "middle", "bottom", "alone"])
@pytest.mark.parametrize("ksize,w,tile", [(5, 45, None), (7, 13, (3, 1)), (5, 100, (64, 2)), (1, 33, (5, 1))])
def test_k34_slab_tiles_emulated(ksize, w, tile, position):
    """K3+K4's tiles in slab mode (``emulate_edge_tiles`` with halos: tiles
    over the own rows, a tile interior only inside the buffer and the own
    rows, the rim's reflect-101, replicate and zero magnitude at the
    buffer's ends, stores at the own rows' row 0), from a board and from
    bytes, and the blur-only mode, against the plain slab versions."""
    halo = ksize // 2 + 2
    top, bottom = {"top": (0, halo), "middle": (halo, halo), "bottom": (halo, 0), "alone": (0, 0)}[position]
    h = top + 11 + bottom
    rng = np.random.default_rng(ksize * w)
    boards = pack_bitboards_plain(torch.from_numpy(binary(w, 2, h, w)))
    dense = torch.from_numpy(gray(ksize, 2, h, w))
    for x in (boards, dense):
        got = emulate_edge_tiles(x, w, ksize, 0.0, 22, 70, tile, rng, top=top, bottom=bottom)
        ref = edge_candidates_slab_plain(x, w, ksize, 22, 70, top, bottom)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), r.numpy())
    blurred = emulate_edge_tiles(dense, w, ksize, 0.0, 0, 0, tile, rng, blur_only=True, top=top, bottom=bottom)
    np.testing.assert_array_equal(blurred.numpy(), gaussian_blur_slab_plain(dense, ksize, top, bottom).numpy())


def k6_slab_store(out, count, base: int, boards: np.ndarray, top: int, own: int, row0: int, out_h: int, w: int,
                  group: int, img_stride: int, layout: str, value: int = 255) -> None:
    """K6's CTAs over a slab's rows (``zs_cluster``: rpc = ⌈rows / 16⌉ rows
    each), each storing only its own rows [s0, s1), at
    ``kernels.layer_offset`` of a layer of ``out_h`` rows, row ``row0 + s0 -
    top``."""
    layers, h, _ = boards.shape
    rb = kernels.row_bytes(layout, w)
    rpc = -(-h // kernels.CLUSTER_SIZE)
    for layer in range(layers):
        for rank in range(kernels.CLUSTER_SIZE):
            r0 = rank * rpc
            nrows = max(0, min(h - r0, rpc))
            s0, s1 = max(r0, top), min(r0 + nrows, top + own)
            if s1 <= s0:
                continue
            starts = base + kernels.layer_offset(layer, group, out_h, rb, img_stride, row0 + s0 - top) + rb * np.arange(
                s1 - s0)
            words = boards[layer, s0:s1]
            if layout == "rows":
                store_row_words(out, count, starts, words, w)
            else:
                store_dense_words(out, count, starts, words, w, value, False)


@pytest.mark.parametrize("layout", ["rows", "dense"])
@pytest.mark.parametrize("w", [13, 45, 64])
@pytest.mark.parametrize("position", ["top", "middle", "bottom", "alone"])
def test_k6_slab_store_emulated(position, w, layout):
    """K6's slab stores into the unsharded outputs (the chain's blob, the
    front-end's dense bytes), filled with a sentinel: each of the slab's own
    rows written once at the slab's first row of every layer, no halo row
    and nothing else written, and the plain slab version's stores the same
    (0 iterations: the skeletons are the edges)."""
    k, b, h_out, own, halo = 3, 2, 40, 10, 4
    top, bottom = {"top": (0, halo), "middle": (halo, halo), "bottom": (halo, 0), "alone": (0, 0)}[position]
    row0 = {"top": 0, "middle": 16, "bottom": h_out - own, "alone": 7}[position]
    boards = pack_bitboards_plain(torch.from_numpy(binary(w, b * k, top + own + bottom, w)))
    rb = kernels.row_bytes(layout, w)
    half, img_stride = k * h_out * rb, 2 * k * h_out * rb
    out = np.full(b * img_stride, SENTINEL, np.uint8)
    count = np.zeros(out.size, np.int64)
    for base, value in ((0, 255), (half, 1)):  # the edges, then the skeletons, as K6 stores them
        k6_slab_store(out, count, base, bitboards_to_jax(boards), top, own, row0, h_out, w, k, img_stride, layout,
                      value)
    mine = np.zeros(out.size, bool)
    for layer in range(b * k):
        at = kernels.layer_offset(layer, k, h_out, rb, img_stride, row0)
        mine[at : at + own * rb] = mine[half + at : half + at + own * rb] = True
    assert (count[mine] == 1).all() and not count[~mine].any() and (out[~mine] == SENTINEL).all()
    blob = torch.full((b, 2, k, h_out, rb), SENTINEL, dtype=torch.uint8)
    flag = torch.empty(1, dtype=torch.int32)
    zhang_suen_slab_plain(boards, top, bottom, 0, flag, w, blob[:, 0], blob[:, 1], layout, row0)
    np.testing.assert_array_equal(blob.numpy().reshape(-1), out)
    assert int(flag) == 0


# --- what the card's wrappers compute on the host -------------------------------------------------


def test_thinning_round():
    """m: as long as the neighbours can give 2 m rows and ``max_iter``
    allows (the 4-shard chain and the 4400 x 4400 slabs take 120, one
    round); where the widened slab does not fit one cluster, K6 runs it as
    bands and m is fitted to a band, at most a cluster's rows / 8, not
    halved against the whole slab."""
    assert kernels.thinning_round(375, 63, 120) == 120
    assert kernels.thinning_round(1100, 138, 120) == 120
    assert kernels.thinning_round(187, 63, 120) == 93
    assert kernels.thinning_round(8, 2, 120) == 4
    assert kernels.thinning_round(8, 2, 3) == 3
    assert kernels.thinning_round(1, 2, 120) == 1
    m = kernels.thinning_round(20000, 400, 120)
    cap = kernels.cluster_rows("zhang_suen_packed", 400)
    assert not kernels.resident("zhang_suen_packed", 20000 + 4 * m, 400) and m == min(120, cap // 8)
    sched = kernels.slab_bands("zhang_suen_packed", 20000 + 4 * m, 400, 2 * m, 20000, m)
    assert len(sched.bands) > 1 and max(w1 - w0 for *_, w0, w1 in sched.bands) <= cap


def test_segments():
    assert _segments([1, 1, 1, 1, 4], 8) == [(0, 5, 8)]
    assert _segments([10, 10, 10, 10, 5], 16) == [(0, 1, 10), (1, 2, 10), (2, 3, 10), (3, 5, 15)]
    with pytest.raises(ValueError, match="needs more than the 8 rows"):
        _segments([9], 8)


def test_slab_rows_refuses_short_halos():
    assert slab_rows("s", 20, 0, 4, 4) == 16
    assert slab_rows("s", 20, 5, 0, 4) == 15
    with pytest.raises(ValueError, match="top halo of 3 rows"):
        slab_rows("s", 20, 3, 0, 4)
    with pytest.raises(ValueError, match="no own rows"):
        slab_rows("s", 8, 4, 4, 4)
    with pytest.raises(ValueError, match="not the own rows"):
        hysteresis_slab_plain(torch.zeros(2, 5, 1, dtype=torch.int32), torch.zeros(2, 8, 1, dtype=torch.int32),
                              1, 1, torch.empty(1, dtype=torch.int32))


@pytest.mark.parametrize("bk", [11, 15])
def test_a_blur_too_wide_for_one_exchange_runs_apart_from_canny(bk):
    """Where the blur's radius plus Canny's two rows pass a shard's rows
    (blur 15 on the 8-row floor), the schedule blurs in one exchange and
    runs Canny on the blurred slabs in the next: the blob is still the JAX
    package's sharded chain's and the unsharded chain's."""
    from plotweave.stages.s02_color_extract import _chain_from_clean
    from plotweave_torch.parallel.mesh import make_mesh

    k, h, w, n = 2, 64, 45, 8
    labels = np.random.default_rng(bk).integers(0, k, (h, w))
    packed = np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])
    args = (w, 3, 1, 1, bk, 22, 70)
    ref = np.asarray(_chain_from_clean(packed, *args))
    mesh = JaxMesh(np.array(jax.devices("cpu")[:n]), ("space",))
    np.testing.assert_array_equal(np.asarray(jspatial.sharded_chain(mesh, packed, *args)), ref)
    got = spatial.sharded_chain(make_mesh((n,), ("space",), devices=[CPU] * n), packed, *args)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (bk // 2 + 2 > h // n) == (bk == 15)
