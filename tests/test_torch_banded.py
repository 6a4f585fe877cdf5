"""K5 and K6 on layers too large for one cluster: the banded route, on the CPU.

A layer whose window does not fit one thread block cluster's shared memory
is split into bands (``ops.kernels.band_schedule``; a slab of row sharding
by ``slab_bands``), each held resident in one cluster, every band of every
layer in one launch, each reading its halo rows in place from the whole
layer.  Here, with the JAX package as the reference (byte equality: all
integer):

- the band tables: every own row in one band, windows clamped at the
  layer's edges and fitting ``resident_smem_bytes``, m at most ``max_iter``,
  the 4400 × 4400 layer in two bands and one round of K6, the sharded
  round's m fitted to a band;
- numpy emulations of the two cluster kernels over a band table
  (``emulate_zs_launch``, ``emulate_hysteresis_launch``: the C formula of a
  band, its window read in place with zero rows outside it, the items in a
  seeded random order, K6's stores at the own rows' row with a sentinel
  everywhere else, K5's window rows outside a band's own rows as seeds that
  cannot grow, from the previous round's board where given), put in place
  of the launches under the real wrappers, so the host's rounds, its two
  boards in turn and its flag reads run as on the card: against the JAX
  package's ``zhang_suen_packed``, ``zhang_suen_packed_pallas`` (interpret
  mode) and ``canny_packed``'s hysteresis, with ``band_rows`` of a few rows
  so that many bands and rounds occur, and a weak spiral against OpenCV's
  connected component of its seed;
- the slab modes cut into bands against their plain slab versions, and the
  sharded chain and front-end over mocked cards (``tests/mocked_cards.py``)
  with a cluster too small for their slabs, byte-equal to the JAX package's
  ``shard_map`` programs on a CPU mesh;
- no fallback: a failed banded launch raises, and no size takes the
  multi-launch route.

``chip_smoke.py`` holds the kernels themselves to the plain versions on the
card.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import cv2
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from plotweave.ops.canny import canny_packed as jax_canny_packed
from plotweave.ops.pallas_kernels import zhang_suen_packed_pallas
from plotweave.ops.thinning import zhang_suen_packed as jax_zhang_suen_packed
from plotweave.parallel import spatial as jspatial
from plotweave_torch.ops import kernels
from plotweave_torch.ops.canny import canny_candidates_plain, hysteresis_plain, hysteresis_slab_plain
from plotweave_torch.ops.thinning import (
    bitboards_to_jax, pack_bitboards_plain, unpack_bitboards_plain, zhang_suen_into_plain, zhang_suen_packed_plain,
    zhang_suen_slab_plain)
from plotweave_torch.parallel.mesh import make_mesh
from plotweave_torch.parallel.spatial import canny_halo, sharded_chain, spatial_frontend, split_rows, thin_halo
from plotweave_torch.stages.s02_color_extract import chain_from_clean

from mocked_cards import card, cards, launches, on_mocked_cards, plain
from test_torch_k1_fold import SENTINEL, store_dense_words, store_row_words

CPU = torch.device("cpu")
K6, K5 = "zhang_suen_packed", "hysteresis"
CHAIN_ARGS = (3, 1, 1, 7, 22, 70)  # mk, oi, ci, bk, lo, hi
CENTERS = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
RING = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


# --- numpy emulations of the cluster kernels over a band table ------------------------------------


def band(j: int, nbands: int, top: int, own: int, h: int, halo: int) -> tuple:
    """``Band`` of csrc/bitboard_fixpoints.cu: own rows [r0, r1), window [w0, w1)."""
    r0, r1 = top + j * own // nbands, top + (j + 1) * own // nbands
    return r0, r1, max(0, r0 - halo), min(h, r1 + halo)


def dense(words: np.ndarray) -> np.ndarray:
    """(..., R, nw) uint32 words → (..., R, 32 nw) 0/1 uint8, LSB first."""
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    return bits.reshape(*words.shape[:-1], -1).astype(np.uint8)


def words_of(px: np.ndarray) -> np.ndarray:
    """Inverse of :func:`dense`."""
    x = px.reshape(*px.shape[:-1], -1, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)
    return x.sum(-1).astype(np.uint32)


def zs_subpass(x: np.ndarray, first: bool, rotated: bool) -> np.ndarray:
    """One Zhang–Suen subpass on (R, C) 0/1 pixels, zero outside."""
    h, w = x.shape
    pad = np.pad(x, 1).astype(np.int32)
    ring = [(-dy, -dx) for dy, dx in RING] if rotated else RING
    p = [pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy, dx in ring]
    b = sum(p)
    a = sum(((p[i] == 0) & (p[(i + 1) % 8] == 1)).astype(np.int32) for i in range(8))
    if first:
        dir_ok = (p[0] * p[2] * p[4] == 0) & (p[2] * p[4] * p[6] == 0)
    else:
        dir_ok = (p[0] * p[2] * p[6] == 0) & (p[0] * p[4] * p[6] == 0)
    return np.where((x == 1) & (a == 1) & (b >= 2) & (b <= 6) & dir_ok, 0, x).astype(np.uint8)


def dilate8(x: np.ndarray) -> np.ndarray:
    pad = np.pad(x, 1)
    h, w = x.shape
    return np.max([pad[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy in (-1, 0, 1) for dx in (-1, 0, 1)], axis=0)


STORE_COUNTS: dict = {}  # (address, bytes) of an output → writes of each byte
BANDS: list = []  # (launch name, bands) of each emulated launch
ORDER_RNG = np.random.default_rng(0)  # the order in which the clusters take their (layer, band) items


def flat_bytes(t: torch.Tensor, img_stride: int) -> np.ndarray:
    """A (B, group, H, row bytes) uint8 output as the flat bytes its
    pointer addresses (images ``img_stride`` apart)."""
    t = plain(t)
    n = (t.shape[0] - 1) * img_stride + t.shape[1] * t.shape[2] * t.shape[3]
    return t.as_strided((n,), (1,)).numpy()


def store(t, layer, rows_at, words, group, img_stride, layout, width, out_h, value):
    """K6's store of ``words`` (R, nw), row i at row ``rows_at + i`` of its layer."""
    flat = flat_bytes(t, img_stride)
    rows = layout == kernels.LAYOUTS["rows"]
    rb = kernels.row_bytes("rows" if rows else "dense", width)
    starts = kernels.layer_offset(layer, group, out_h, rb, img_stride, rows_at) + rb * np.arange(len(words))
    count = STORE_COUNTS.setdefault((plain(t).data_ptr(), flat.size), np.zeros(flat.size, np.int64))
    if rows:
        store_row_words(flat, count, starts, words, width)
    else:
        store_dense_words(flat, count, starts, words, width, value, False)


def items(k: int, nbands: int) -> list:
    order = [(layer, j) for layer in range(k) for j in range(nbands)]
    ORDER_RNG.shuffle(order)
    return order


def emulate_zs_launch(name, x, out, iters, edges, skels, changed, img_stride, group, layout, h, nw, width, n_iter,
                      rotated, top, own, out_row0, out_h, sched, calls=None):
    """``pw_zs_cluster_run``: each (layer, band) item loads its window of
    ``x`` in place (rows outside read zero), stores its own rows of the
    input as the edges, runs at most ``n_iter`` iterations, stopping after
    iteration t if it changed no row within 2 (n_iter - t) rows of the own
    rows (its zone), and stores its own rows of the result; ``iters`` gets
    each layer's most iterations, ``changed`` whether the last iteration of
    a band changed one of its own rows."""
    nbands, halo = len(sched.bands), sched.halo
    assert tuple(band(j, nbands, top, own, h, halo) for j in range(nbands)) == tuple(
        (r0, r0 + rows, w0, w1) for r0, rows, w0, w1 in sched.bands)
    assert max(w1 - w0 for *_, w0, w1 in sched.bands) <= kernels.cluster_rows(K6, nw)
    if calls is not None:
        calls.append(name)
    BANDS.append((name, nbands))
    xs, it_out = bitboards_to_jax(plain(x)).reshape(-1, h, nw), plain(iters).numpy()
    it_out[:] = 0
    any_own = False
    for layer, j in items(it_out.size, nbands):
        r0, r1, w0, w1 = band(j, nbands, top, own, h, halo)
        win = dense(xs[layer, w0:w1])
        if edges is not None:
            store(edges, layer, out_row0 + r0 - top, xs[layer, r0:r1], group, img_stride, layout, width, out_h, 255)
        it, last = 0, False
        while it < n_iter:
            nxt = zs_subpass(zs_subpass(win, True, rotated), False, rotated)
            diff = nxt != win
            zone = 2 * (n_iter - it - 1)
            quiet = not diff[max(0, r0 - zone - w0) : max(0, r1 + zone - w0)].any()
            last, win, it = bool(diff[r0 - w0 : r1 - w0].any()), nxt, it + 1
            if quiet:
                break
        it_out[layer] = max(it_out[layer], it)
        any_own |= last
        result = words_of(win[r0 - w0 : r1 - w0])
        if out is not None:
            plain(out).numpy().view(np.uint32).reshape(-1, own, nw)[layer, r0 - top : r1 - top] = result
        if layout:
            store(skels, layer, out_row0 + r0 - top, result, group, img_stride, layout, width, out_h, 1)
    if changed is not None:
        plain(changed).numpy()[0] = int(any_own)


def emulate_hysteresis_launch(name, cand, strong, prev, out, stats, changed, h, nw, top, own, sched, calls=None):
    """``pw_hysteresis_cluster_run``: each (layer, band) item takes its
    window's edges (``prev``'s own rows where given, else ``strong``; rows
    outside the window zero), cand for its own rows and the edges as cand
    elsewhere (seeds that cannot grow), grows cand & dilate8(edges) to its
    fixpoint and stores its own rows; ``changed`` gets whether a band's own
    rows differ from their edges."""
    nbands, halo = len(sched.bands), sched.halo
    assert tuple(band(j, nbands, top, own, h, halo) for j in range(nbands)) == tuple(
        (r0, r0 + rows, w0, w1) for r0, rows, w0, w1 in sched.bands)
    assert max(w1 - w0 for *_, w0, w1 in sched.bands) <= kernels.cluster_rows(K5, nw)
    if calls is not None:
        calls.append(name)
    BANDS.append((name, nbands))
    c = bitboards_to_jax(plain(cand)).reshape(-1, own, nw)
    s = bitboards_to_jax(plain(strong)).reshape(-1, h, nw)
    p = None if prev is None else bitboards_to_jax(plain(prev)).reshape(-1, own, nw)
    o = plain(out).numpy().view(np.uint32).reshape(-1, own, nw)
    plain(stats).numpy()[:] = 1
    grew = False
    for layer, j in items(c.shape[0], nbands):
        r0, r1, w0, w1 = band(j, nbands, top, own, h, halo)
        edge = s[layer, w0:w1].copy()
        if p is not None:
            a, b = max(w0, top), min(w1, top + own)
            edge[a - w0 : b - w0] = p[layer, a - top : b - top]
        cw = edge.copy()
        cw[r0 - w0 : r1 - w0] = c[layer, r0 - top : r1 - top]
        cd, e = dense(cw), dense(cw) & dilate8(dense(edge))
        while True:
            nxt = cd & dilate8(e)
            if (nxt == e).all():
                break
            e = nxt
        result = words_of(e[r0 - w0 : r1 - w0])
        grew |= bool((result != edge[r0 - w0 : r1 - w0]).any())
        o[layer, r0 - top : r1 - top] = result
    if changed is not None:
        plain(changed).numpy()[0] = int(grew)


@pytest.fixture
def emulated(monkeypatch):
    """The wrappers' launches replaced by the emulations (no device guard
    on the host); returns the launch names, one a launch."""
    calls: list = []
    monkeypatch.setattr(kernels, "_guard", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "_zs_launch", lambda *a: emulate_zs_launch(*a, calls=calls))
    monkeypatch.setattr(kernels, "_hysteresis_launch", lambda *a: emulate_hysteresis_launch(*a, calls=calls))
    STORE_COUNTS.clear()
    return calls


def small_cluster(monkeypatch, w: int) -> None:
    """Shrink a cluster's shared memory to nine padded rows a CTA of
    ``w``-px layers: a band window of 64 rows of K6 and 32 of K5, so that
    small test layers need bands, as a poster-sized one does on the card."""
    monkeypatch.setattr(kernels, "MAX_SMEM", 9 * 4 * (-(-w // 32) + 2) + 8)


# --- the band tables -------------------------------------------------------------------------------

SCHEDULES = [  # kernel, h, w, max_iter, band_rows
    (K6, 4400, 4400, 120, None), (K5, 4400, 4400, 120, None), (K6, 6600, 4400, 120, None),
    (K5, 3800, 3800, 120, None), (K6, 20000, 64000, 120, None), (K5, 20000, 64000, 120, None),
    (K6, 1500, 2000, 120, 700), (K5, 1500, 2000, 120, 700), (K6, 1500, 2000, 7, 3), (K5, 1500, 2000, 7, 3),
    (K6, 1500, 2000, 0, 400), (K6, 37, 13, 120, 5), (K5, 37, 13, 120, 1), (K6, 1500, 2000, 120, None),
]


@pytest.mark.parametrize("kernel, h, w, max_iter, band_rows", SCHEDULES)
def test_band_schedule_covers_each_row_once_and_fits(kernel, h, w, max_iter, band_rows):
    """Every row of the layer is an own row of exactly one band, the bands
    in order with their own rows evenly split (at most ``band_rows`` each
    where given, the fewest that fit otherwise); each window is its band's
    own rows and the halo inside the layer (clamped at its edges) and fits
    ``resident_smem_bytes``; m is at most ``max_iter`` and K6's halo is 2 m."""
    nw = -(-w // 32)
    sched = kernels.band_schedule(kernel, h, nw, max_iter, band_rows)
    owner = np.zeros(h, int)
    sizes = [rows for _, rows, _, _ in sched.bands]
    for r0, rows, w0, w1 in sched.bands:
        owner[r0 : r0 + rows] += 1
        assert (w0, w1) == (max(0, r0 - sched.halo), min(h, r0 + rows + sched.halo))
        assert kernels.resident_smem_bytes(kernel, w1 - w0, nw) <= kernels.MAX_SMEM
    assert (owner == 1).all() and max(sizes) - min(sizes) <= 1
    assert [b[0] for b in sched.bands] == sorted(b[0] for b in sched.bands)
    if band_rows:
        assert max(sizes) <= band_rows
    if kernel == K6:
        assert 0 <= sched.m <= max_iter and (len(sched.bands) == 1 or sched.halo == 2 * sched.m)
    else:
        assert sched.m == 1 and (len(sched.bands) == 1 or sched.halo == 1)
    n, cap = len(sched.bands), kernels.cluster_rows(kernel, nw)
    if n == 2 and not band_rows:  # the fewest: one band (the whole layer) does not fit
        assert h > cap
    elif n > 2 and not band_rows:  # nor do one band fewer, at the halo the bands were chosen for
        halo = 2 * min(max_iter, cap // 8) if kernel == K6 else 1
        assert max(w1 - w0 for *_, w0, w1 in kernels.band_table(h, 0, h, n - 1, halo)) > cap


def test_the_poster_layer_takes_two_bands_and_one_round():
    """At 4400 × 4400 px (138 words a row) a cluster holds 3,312 rows of K6
    and 3,280 of K5: two bands of 2,200 own rows each, K6's halo 240 rows
    (m = max_iter = 120: one round, one launch), K5's one row."""
    assert kernels.cluster_rows(K6, 138) == 3312 and kernels.cluster_rows(K5, 138) == 3280
    k6 = kernels.band_schedule(K6, 4400, 138, 120)
    assert k6 == ((((0, 2200, 0, 2440), (2200, 2200, 1960, 4400)), 240, 120))
    k5 = kernels.band_schedule(K5, 4400, 138)
    assert k5.bands == ((0, 2200, 0, 2201), (2200, 2200, 2199, 4400)) and k5.halo == 1
    # the default max_dimension's layers stay resident: one band, the whole layer
    assert kernels.band_schedule(K6, 2000, 63, 120).bands == ((0, 2000, 0, 2000),)
    assert kernels.band_schedule(K5, 1500, 63).bands == ((0, 1500, 0, 1500),)


@pytest.mark.parametrize("kernel", [K6, K5])
@pytest.mark.parametrize("h, w, route", [
    (1500, 2000, "resident"), (2000, 2000, "resident"), (3800, 3800, None), (4400, 4400, "banded"),
    (6600, 4400, "banded"), (20000, 64000, "banded"), (40, 300000, "banded")])
def test_no_size_takes_the_multi_launch_route(kernel, h, w, route):
    """By size, a layer that fits one cluster is resident and any other is
    banded; "multi" is only ever named (K5 holds four more rows a CTA than
    K6, so 3,800 rows fit K6 and not K5)."""
    nw = -(-w // 32)
    want = route or ("resident" if kernel == K6 else "banded")
    assert kernels.fixpoint_route(kernel, h, nw) == want
    assert kernels.fixpoint_route(kernel, h, nw, "multi") == "multi"
    assert kernels.fixpoint_route(kernel, h, nw, "banded") == "banded"
    assert (want == "resident") == kernels.resident(kernel, h, nw)


@pytest.mark.parametrize("kernel, top, own, bottom, iters, w, fits", [
    (K6, 0, 1100, 480, 120, 4400, True),  # the 4-shard 4400 x 4400 slabs: one band, the whole slab
    (K6, 480, 1100, 480, 120, 4400, True),
    (K6, 240, 2200, 0, 120, 8800, False),  # 2 shards of 4400 x 8800 px: 2,440 rows, a cluster holds 1,664
    (K6, 240, 2200, 240, 60, 8800, False),
    (K5, 1, 2200, 1, 1, 8800, False),
    (K5, 0, 2200, 1, 1, 4400, True),
    (K6, 16, 60, 16, 8, 64, True),
])
def test_slab_bands(kernel, top, own, bottom, iters, w, fits):
    """A slab that fits one cluster is one band whose window is the whole
    slab (the slab mode as before); a larger one the fewest bands of its own
    rows whose windows, 2 · iters halo rows a side for K6 and 1 for K5,
    clamped to the slab, fit."""
    nw, h = -(-w // 32), top + own + bottom
    sched = kernels.slab_bands(kernel, h, nw, top, own, iters)
    assert (len(sched.bands) == 1) == fits == kernels.resident(kernel, h, nw)
    owner = np.zeros(h, int)
    for r0, rows, w0, w1 in sched.bands:
        owner[r0 : r0 + rows] += 1
        assert w1 - w0 <= kernels.cluster_rows(kernel, nw)
        if not fits:
            halo = 2 * iters if kernel == K6 else 1
            assert (w0, w1) == (max(0, r0 - halo), min(h, r0 + rows + halo))
    assert (owner[top : top + own] == 1).all() and owner.sum() == own
    if fits:
        assert sched.bands == ((top, own, 0, h),)


@pytest.mark.parametrize("rows, w, max_iter, want", [
    (1100, 4400, 120, 120),  # the 4-shard 4400 x 4400 slabs fit whole
    (375, 2000, 120, 120),
    (187, 2000, 120, 93),  # as far as the neighbours can give
    (2200, 8800, 120, 120),  # 2,680 rows do not fit (1,664): bands, m fitted to a band (1,664 / 8 = 208)
    (20000, 12800, 120, 120),
    (20000, 64000, 120, 28),  # a cluster holds 224 rows of 2,000 words: m = 224 / 8
])
def test_sharded_round_fits_m_to_a_band(rows, w, max_iter, want):
    """``thinning_round`` keeps m where the widened slab fits one cluster;
    where it does not, the slab runs as bands and m is fitted to a band (at
    most a cluster's rows / 8), not halved against the whole slab."""
    nw = -(-w // 32)
    m = kernels.thinning_round(rows, nw, max_iter)
    assert m == want
    sched = kernels.slab_bands(K6, rows + 4 * m, nw, 2 * m, rows, m)
    assert max(w1 - w0 for *_, w0, w1 in sched.bands) <= kernels.cluster_rows(K6, nw)


# --- the banded wrappers with their launches emulated ----------------------------------------------


def binary(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """Blobs and strokes: a 3 x 3 majority vote over noise, 0/1."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, h + 2, w + 2)) < 0.5
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return (s[:, 1 : h + 1, 1 : w + 1] >= 5).astype(np.uint8)


def thick_shapes(k: int, h: int, w: int) -> np.ndarray:
    """Filled discs and bars that take many iterations to thin."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = np.zeros((k, h, w), np.uint8)
    for i in range(k):
        out[i] = ((yy - h // 2) ** 2 + (xx - w // 2 - i) ** 2 < (min(h, w) // 2 - 1 - i) ** 2)
        out[i, 2 : h - 2, 2 + i : 6 + i] = 1
    return out


def frames(k: int, h: int, w: int) -> np.ndarray:
    """Thick rectangular frames: the thinning's fronts move along the rows
    for many iterations, past rows that stay still meanwhile."""
    out = np.zeros((k, h, w), np.uint8)
    for i in range(k):
        out[i, 2 + i : h - 2, 3 : w - 3 - i] = 1
        out[i, 12 + i : h - 12, 13 : w - 13 - 2 * i] = 0
    return out


@pytest.mark.parametrize("image, k, h, w, band_rows, max_iter, rotated", [
    ("noise", 3, 40, 45, 6, 120, True),
    ("noise", 2, 37, 13, 5, 120, False),
    ("shapes", 2, 48, 40, 8, 120, True),  # a disc takes ~20 iterations: several rounds of m
    ("shapes", 1, 48, 40, 12, 4, True),  # stopped at max_iter mid-round
    ("shapes", 2, 33, 64, 16, 48, False),
    ("noise", 1, 24, 33, 24, 120, True),  # one band, forced banded
    ("noise", 4, 40, 64, 1, 120, True),  # bands of one row: a band's rows stay still while its zone's change
    ("noise", 4, 40, 64, 2, 120, False),
    ("frames", 2, 48, 64, 1, 120, True),
])
def test_k6_banded_matches_jax(monkeypatch, emulated, image, k, h, w, band_rows, max_iter, rotated):
    """``zhang_suen_packed_cuda(route="banded")`` with its launches
    emulated over a small cluster: rounds of m iterations on bands that
    read their 2 m halo rows in place, two boards in turn, one flag read a
    round, each band stopping once its zone is still; the board equals the
    JAX package's ``zhang_suen_packed`` and ``zhang_suen_packed_pallas`` in
    interpret mode (bands of one row catch a band that stops on its own
    rows alone)."""
    small_cluster(monkeypatch, w)
    x = {"noise": lambda: binary(w, k, h, w), "shapes": lambda: thick_shapes(k, h, w), "frames": lambda: frames(k, h, w)}[
        image]()
    boards = pack_bitboards_plain(torch.from_numpy(x))
    got = kernels.zhang_suen_packed_cuda(card(boards), max_iter, rotated, route="banded", band_rows=band_rows)
    sched = kernels.band_schedule(K6, h, -(-w // 32), max_iter, band_rows)
    rounds, _ = kernels.STATS["zhang_suen_packed_banded"]
    assert len(emulated) == rounds and set(emulated) == {"zhang_suen_packed_banded"}
    assert rounds <= -(-max_iter // max(1, sched.m))
    ref = np.asarray(jax_zhang_suen_packed(bitboards_to_jax(boards), max_iter=max_iter, rotated=rotated))
    np.testing.assert_array_equal(bitboards_to_jax(plain(got)), ref)
    pallas = np.asarray(zhang_suen_packed_pallas(x, max_iter=max_iter, rotated=rotated, interpret=True))
    np.testing.assert_array_equal(unpack_bitboards_plain(plain(got), w).numpy(), pallas)


@pytest.mark.parametrize("layout", ["rows", "dense"])
@pytest.mark.parametrize("w, band_rows, max_iter", [(45, 7, 120), (64, 10, 3), (13, 4, 0)])
def test_k6_banded_stores(monkeypatch, emulated, layout, w, band_rows, max_iter):
    """``zhang_suen_into_cuda(route="banded")`` into a blob filled with a
    sentinel: each band stores its own rows of the edges in the first round
    and of the skeletons every round, at its first row of each layer, and
    nothing else is written; the bytes are ``zhang_suen_into_plain``'s."""
    small_cluster(monkeypatch, w)
    b, group, h = 2, 2, 40
    boards = pack_bitboards_plain(torch.from_numpy(thick_shapes(b * group, h, w)))
    rb = kernels.row_bytes(layout, w)
    blob = torch.full((b, 2, group, h, rb), SENTINEL, dtype=torch.uint8)
    with cards():
        mocked = card(blob.clone())
        kernels.zhang_suen_into_cuda(card(boards), w, mocked[:, 0], mocked[:, 1], layout, max_iter, True, "banded",
                                     band_rows)
    rounds, _ = kernels.STATS["zhang_suen_packed_banded"]
    zhang_suen_into_plain(boards, w, blob[:, 0], blob[:, 1], layout, max_iter, True)
    np.testing.assert_array_equal(plain(mocked).numpy(), blob.numpy())
    (edges, count_e), (skels, count_s) = [(k, v) for k, v in STORE_COUNTS.items()][:2]
    img_stride = 2 * group * h * rb
    written = np.zeros(b * img_stride, np.int64)
    written[: count_e.size] += count_e
    written[group * h * rb : group * h * rb + count_s.size] += count_s
    rows = written.reshape(b, 2, group, h, rb)
    assert (rows.max(-1) == rows.min(-1)).all()  # whole rows
    assert (rows[:, 0] == 1).all() and (rows[:, 1] == rounds).all()  # the edges once, the skeletons every round


def weak_image(seed: int, k: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    field = np.sin(0.21 * yy[None] + rng.uniform(0.1, 0.4, (k, 1, 1)) * xx[None]) * 60 + 120
    return np.clip(field + rng.integers(-30, 31, (k, h, w)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("k, h, w, band_rows", [(2, 48, 45, 5), (1, 64, 70, 3), (3, 31, 13, 8), (2, 40, 33, 40)])
def test_k5_banded_matches_jax(monkeypatch, emulated, k, h, w, band_rows):
    """``hysteresis_cuda(route="banded")`` with its launches emulated: one
    launch a round over every band, the previous round's rows outside a
    band its seeds, the host's read of one flag a round; the board equals
    the JAX package's ``canny_packed`` hysteresis on the same image."""
    small_cluster(monkeypatch, w)
    img = weak_image(h + w, k, h, w)
    cand, strong = canny_candidates_plain(torch.from_numpy(img), 20, 60)
    got = kernels.hysteresis_cuda(card(cand), card(strong), route="banded", band_rows=band_rows)
    rounds, _ = kernels.STATS["hysteresis_banded"]
    assert emulated == ["hysteresis_banded"] * rounds and rounds >= 2
    ref = np.asarray(jax_canny_packed(img, 20, 60)[1])
    np.testing.assert_array_equal(bitboards_to_jax(plain(got)), ref)
    assert torch.equal(plain(got), hysteresis_plain(cand, strong))


def spiral(h: int, w: int, step: int = 4) -> np.ndarray:
    """A rectangular spiral of 1-px lines ``step`` px apart, from (0, 0)
    inwards, as uint8 0/1."""
    img = np.zeros((h, w), np.uint8)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        img[top, left : right + 1] = 1
        img[top : bottom + 1, right] = 1
        if bottom - top < step or right - left < step:
            break
        img[bottom, left : right + 1] = 1
        img[top + step : bottom + 1, left] = 1
        top, left, bottom, right = top + step, left + step, bottom - step, right - step
    return img


@pytest.mark.parametrize("h, w, band_rows", [(60, 70, 7), (40, 48, 5), (64, 64, 64)])
def test_k5_banded_weak_spiral_against_opencv(monkeypatch, emulated, h, w, band_rows):
    """A spiral of weak pixels with one strong seed at its outer end: the
    banded route reaches OpenCV's 8-connected component of the seed,
    crossing the band boundaries round after round."""
    small_cluster(monkeypatch, w)
    weak = spiral(h, w)
    seed = np.zeros_like(weak)
    seed[0, 0] = 1
    cand, strong = (pack_bitboards_plain(torch.from_numpy(a[None])) for a in (weak, seed))
    got = kernels.hysteresis_cuda(card(cand), card(strong), route="banded", band_rows=band_rows)
    _, labels = cv2.connectedComponents(weak, connectivity=8)
    want = (labels == labels[0, 0]).astype(np.int32)
    np.testing.assert_array_equal(unpack_bitboards_plain(plain(got), w)[0].numpy(), want)
    rounds, _ = kernels.STATS["hysteresis_banded"]
    assert rounds >= (3 if len(kernels.band_schedule(K5, h, -(-w // 32), band_rows=band_rows).bands) > 1 else 1)


@pytest.mark.parametrize("position", ["top", "middle", "bottom", "alone"])
@pytest.mark.parametrize("band_rows", [3, 9])
def test_slab_modes_in_bands_match_their_plain_versions(monkeypatch, emulated, position, band_rows):
    """A slab mode cut into bands: K6 in one launch (each band's window 2 ·
    iters rows a side inside the slab), K5 by rounds inside its call until
    no band's own rows change, its flag the first round's: both equal the
    plain slab versions, the stores at the slab's row of the unsharded
    outputs and the changed flags included."""
    iters, w, own, k = 3, 45, 24, 2
    small_cluster(monkeypatch, w)
    halo = 2 * iters
    top, bottom = {"top": (0, halo), "middle": (halo, halo), "bottom": (halo, 0), "alone": (0, 0)}[position]
    h = top + own + bottom
    x = pack_bitboards_plain(torch.from_numpy(thick_shapes(k, h, w)))
    rb, row0, out_h = kernels.row_bytes("rows", w), 5, own + 9
    want = torch.full((2, 1, k, out_h, rb), SENTINEL, dtype=torch.uint8)
    flag_want = torch.empty(1, dtype=torch.int32)
    ref = zhang_suen_slab_plain(x, top, bottom, iters, flag_want, w, want[0], want[1], "rows", row0)
    with cards():
        outs, flag = card(want.clone().fill_(SENTINEL)), card(torch.full((1,), 7, dtype=torch.int32))
        got = kernels.zhang_suen_slab_cuda(card(x), top, bottom, iters, flag, w, outs[0], outs[1], "rows", row0,
                                           band_rows=band_rows)
    assert emulated == ["zhang_suen_packed_slab"]
    assert torch.equal(plain(got), ref) and torch.equal(plain(outs), want) and int(plain(flag)) == int(flag_want)

    img = weak_image(own + band_rows, k, h, w)
    cand, strong = canny_candidates_plain(torch.from_numpy(img), 20, 60)
    cand_own = cand[:, top : top + own].contiguous()
    for edges in (strong, hysteresis_plain(cand, strong)):  # a first round, and one that changes nothing
        want_flag = torch.empty(1, dtype=torch.int32)
        ref = hysteresis_slab_plain(cand_own, edges, top, bottom, want_flag)
        emulated.clear()
        with cards():
            flag = card(torch.full((1,), 7, dtype=torch.int32))
            got = kernels.hysteresis_slab_cuda(card(cand_own), card(edges), top, bottom, flag, band_rows=band_rows)
        assert torch.equal(plain(got), ref) and int(plain(flag)) == int(want_flag)
        assert emulated == ["hysteresis_slab"] * kernels.STATS["hysteresis_slab"][0]


# --- row sharding over mocked cards with slabs too large for a cluster ------------------------------


def packed_labels(seed: int, k: int, h: int, w: int) -> np.ndarray:
    labels = np.random.default_rng(seed).integers(0, k, (h, w))
    return np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])


def jax_mesh(n: int) -> JaxMesh:
    return JaxMesh(np.array(jax.devices("cpu")[:n]), ("space",))


def slab_wrappers_emulated(monkeypatch) -> list:
    """Over mocked cards: K2, K3+K4 and K7 as recorders of their plain
    versions (``on_mocked_cards``), and K5's and K6's slab modes the real
    wrappers with their launches emulated, recorded by launch name."""
    real = {name: getattr(kernels, name) for name in ("hysteresis_slab_cuda", "zhang_suen_slab_cuda")}
    calls = on_mocked_cards(monkeypatch)
    for name, fn in real.items():
        monkeypatch.setattr(kernels, name, fn)
    edge = kernels.edge_candidates_slab_cuda  # its outputs contiguous, as the kernel's are
    monkeypatch.setattr(kernels, "edge_candidates_slab_cuda", lambda *a: tuple(t.contiguous() for t in edge(*a)))
    monkeypatch.setattr(kernels, "_guard", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(kernels, "_zs_launch", lambda *a: emulate_zs_launch(*a, calls=calls))
    monkeypatch.setattr(kernels, "_hysteresis_launch", lambda *a: emulate_hysteresis_launch(*a, calls=calls))
    BANDS.clear()
    return calls


def most_bands(name: str) -> int:
    return max(n for launch, n in BANDS if launch == name)


@pytest.mark.parametrize("n, h", [(2, 120), (3, 120), (4, 160)])
def test_sharded_chain_with_slabs_too_large_for_a_cluster(monkeypatch, n, h):
    """The sharded chain over n mocked cards whose cluster holds 64 rows of
    K6 and 32 of K5, on masks of 30 to 60 rows a shard: no slab fits, each runs as bands
    (K6 in one launch a shard and round, K5 by rounds inside its call) and
    the blob equals the JAX package's ``shard_map`` chain on a CPU mesh and
    the unsharded chain.  Before, such a slab raised."""
    calls = slab_wrappers_emulated(monkeypatch)
    k, w = 3, 45
    small_cluster(monkeypatch, w)
    nw = -(-w // 32)
    assert kernels.cluster_rows(K6, nw) == 64 and kernels.cluster_rows(K5, nw) == 32
    m = kernels.thinning_round(h // n, nw, 120)
    widest = h // n + (2 if n == 2 else 4) * m  # the widened slabs of K6: an edge shard's, or a middle one's
    assert not kernels.resident(K6, widest, nw) and not kernels.resident(K5, h // n + 1, nw) and m == 8
    packed = packed_labels(n, k, h, w)
    ref = np.asarray(jspatial.sharded_chain(jax_mesh(n), packed, w, *CHAIN_ARGS))
    devices = [torch.device("cuda", i) for i in range(n)]
    with cards():
        blob = sharded_chain(make_mesh((n,), ("space",), devices=devices), card(torch.from_numpy(packed)), w,
                             *CHAIN_ARGS)
    np.testing.assert_array_equal(plain(blob).numpy(), ref)
    assert torch.equal(plain(blob), chain_from_clean(packed, w, *CHAIN_ARGS, device=CPU))
    got = launches(calls)
    assert got["zhang_suen_packed_slab"] == n * kernels.STATS["thinning_rounds"]
    assert got["hysteresis_slab"] >= n * kernels.STATS["hysteresis_rounds"]
    assert "zhang_suen_slab_cuda" not in got and "hysteresis_slab_cuda" not in got  # the real wrappers ran
    assert most_bands("zhang_suen_packed_slab") > 1 and most_bands("hysteresis_slab") > 1


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("program", ["canny", "thin"])
def test_canny_and_thinning_halo_with_slabs_too_large_for_a_cluster(monkeypatch, program, n):
    """Canny of a weak edge that crosses every shard from a strong seed in
    the last one, and thinning of a thick disc, over mocked cards whose
    slabs do not fit a cluster: K5's bands carry the edge across their
    boundaries by rounds inside each call, and both equal their JAX twins
    under ``shard_map`` on a CPU mesh."""
    from test_torch_spatial import jax_program, thick_disc, weak_edge

    calls = slab_wrappers_emulated(monkeypatch)
    h, w = (96 if program == "canny" else 80 * n), 48
    small_cluster(monkeypatch, w)
    x = weak_edge(h, w) if program == "canny" else thick_disc(h, w)
    args = (22, 70) if program == "canny" else (120,)
    ref = np.asarray(jax_program(program, n, x.ndim, args)(x))
    devices = [torch.device("cuda", i) for i in range(n)]
    with cards():
        slabs = split_rows(card(torch.from_numpy(x)), devices)
        got = (canny_halo if program == "canny" else thin_halo)(slabs, *args)
    np.testing.assert_array_equal(torch.cat([plain(g) for g in got], dim=-2).numpy(), ref)
    if program == "canny":
        assert ref[0, 0].any() and launches(calls)["hysteresis_slab"] > n * kernels.STATS["hysteresis_rounds"]
        assert most_bands("hysteresis_slab") > 1
    else:
        assert launches(calls)["zhang_suen_packed_slab"] == n * kernels.STATS["thinning_rounds"]
        assert most_bands("zhang_suen_packed_slab") > 1 and ref.any()


def test_spatial_frontend_with_slabs_too_large_for_a_cluster(monkeypatch):
    """The sharded front-end (dense stores) over two mocked cards whose
    slabs do not fit a cluster: the bytes of the same program on the host."""
    calls = slab_wrappers_emulated(monkeypatch)
    small_cluster(monkeypatch, 64)
    rng = np.random.default_rng(5)
    img = np.clip(rng.normal(128, 60, (160, 64, 3)), 0, 255).astype(np.uint8)
    img[20:130, 10:50] = (230, 150, 140)
    ref = spatial_frontend(make_mesh((2,), ("space",), devices=[CPU] * 2), img, CENTERS, k=4)
    with cards():
        e, s = spatial_frontend(make_mesh((2,), ("space",), devices=[torch.device("cuda", i) for i in range(2)]),
                                card(torch.from_numpy(img)), CENTERS, k=4)
    assert torch.equal(plain(e), ref[0]) and torch.equal(plain(s), ref[1])
    assert most_bands("zhang_suen_packed_slab") > 1 and most_bands("hysteresis_slab") > 1
    assert np.asarray(ref[1]).any()


# --- no fallback ------------------------------------------------------------------------------------


class FailingLib:
    """A library whose every launch fails, as a launch that does not fit would."""

    def __init__(self):
        self.called = []

    def __getattr__(self, fn):
        def run(*args):
            self.called.append(fn)
            return 98

        return run

    def pw_error_string(self, err):
        return b"invalid device function"


@pytest.mark.parametrize("kernel", [K6, K5])
def test_a_failed_banded_launch_raises(monkeypatch, kernel):
    """A banded launch that fails raises; nothing carries on by another
    route or on the host."""
    lib = FailingLib()
    monkeypatch.setattr(kernels, "load", lambda name: lib)
    monkeypatch.setattr(kernels, "_guard", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: SimpleNamespace(cuda_stream=0))
    x = card(torch.zeros((1, 4400, 138), dtype=torch.int32))
    with cards(), pytest.raises(RuntimeError, match="CUDA error 98"):
        if kernel == K6:
            kernels.zhang_suen_packed_cuda(x)
        else:
            kernels.hysteresis_cuda(x, x)
    assert lib.called == ["pw_zs_cluster_run" if kernel == K6 else "pw_hysteresis_cluster_run"]
