"""Kernels K1 (layout conversions) and K3+K4 (blur, Sobel, NMS, thresholds in
one launch): their plain versions against the JAX package, and the K3+K4
tile-and-halo schedule emulated in plain numpy against its plain version.

The kernels run only on the card, where ``chip_smoke.py`` holds them against
these plain versions.  What the emulation pins is the part that makes the
kernel exact: the tile geometry from ``ops/kernels.py::edge_schedule``, the
halo of ``ksize // 2 + 2`` px, the index relations between the four regions
in shared memory, and the three borders (reflect-101 for the blur, replicate
for Sobel, zero for the NMS), with garbage in every blurred cell outside the
image, which no pass may read.  Every op is integer: the tolerance is 0.
"""

from __future__ import annotations

import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import bitpack as jbitpack
from plotweave.ops import filters as jfilters
from plotweave.ops import thinning as jthin
from plotweave_torch.ops import bitpack, canny, filters, kernels, thinning
from plotweave_torch.ops.frontend import assign_boards, onehot_boards
from plotweave_torch.ops.thinning import bitboards_from_jax, bitboards_to_jax

jcanny = importlib.import_module("plotweave.ops.canny")  # the package binds `canny` to a function

THRESHOLDS = [(22, 70), (70, 22), (5, 3000), (2500, 2100), (0, 0)]


def gray_images(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """(k, h, w) uint8: seeded smooth blobs with full-range noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    field = sum(np.sin(rng.uniform(0.05, 0.6) * yy + rng.uniform(0.05, 0.6) * xx + rng.uniform(0, 6.3, (k, 1, 1)))
                for _ in range(3))
    return np.clip(128 + 60 * field + rng.integers(-50, 51, (k, h, w)), 0, 255).astype(np.uint8)


def binary_boards(seed: int, k: int, h: int, w: int):
    """Seeded masks as (dense 0/255 uint8, int32 bitboards whose padding bits
    beyond W are random: no reader may use them)."""
    rng = np.random.default_rng(seed)
    dense = (gray_images(seed, k, h, w) > 128).astype(np.uint8) * 255
    boards = bitboards_to_jax(thinning.pack_bitboards_plain(torch.from_numpy(dense))).copy()
    pad = (-w) % 32
    if pad:
        boards[..., -1] |= rng.integers(0, 2**pad, boards.shape[:-1], dtype=np.uint64).astype(np.uint32) << (32 - pad)
    return dense, bitboards_from_jax(boards)


def jax_edges(img: np.ndarray, ksize: int, low: int, high: int, sigma: float = 0.0):
    dense, packed = jcanny.canny_packed(jfilters.gaussian_blur_u8(jnp.asarray(img), ksize, sigma), low, high)
    return np.asarray(dense), np.asarray(packed)


# ---------------------------------------------------------------------------
# the plain fused edge candidates, over gray images and over boards, vs JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 31, 33, 100])
@pytest.mark.parametrize("ksize", list(range(1, 10)))
def test_edge_candidates_plain_matches_jax(ksize, w):
    h = (1, 6, 19, 40)[(ksize + w) % 4]
    low, high = THRESHOLDS[(ksize + w) % len(THRESHOLDS)]
    gray = gray_images(ksize * 100 + w, 2, h, w)
    dense, boards = binary_boards(ksize * 100 + w + 1, 2, h, w)
    for what, ref_in, x in (("gray", gray, torch.from_numpy(gray)), ("boards", dense, boards)):
        ref_dense, ref_packed = jax_edges(ref_in, ksize, low, high)
        edges_b = canny.canny_boards(x, w, ksize, low, high)
        np.testing.assert_array_equal(bitboards_to_jax(edges_b), ref_packed, err_msg=what)
        np.testing.assert_array_equal(thinning.dense_from_boards(edges_b, w, 255).numpy(), ref_dense, err_msg=what)
        cand, strong = canny.edge_candidates(x, w, ksize, low, high)
        assert cand.dtype == strong.dtype == torch.int32 and tuple(cand.shape) == (2, h, -(-w // 32))
        assert torch.equal(strong & cand, strong)
        # bits at and beyond W are zero in both boards
        assert torch.equal(cand & thinning.pack_bitboards_plain(torch.ones((h, w))), cand)


@pytest.mark.parametrize("ksize, sigma, shape", [(5, 1.4, (2, 30, 45)), (9, 2.0, (1, 17, 70)), (7, 0.0, (1, 5, 2)),
                                                 (9, 0.0, (2, 3, 4)), (3, 0.7, (3, 2, 2, 33))])
def test_edge_candidates_sigma_and_short_axes_match_jax(ksize, sigma, shape):
    """A sigma > 0 changes the taps; a radius at and beyond the axis repeats
    the reflection; leading dims ride along."""
    gray = gray_images(ksize, int(np.prod(shape[:-2])), *shape[-2:]).reshape(shape)
    ref_dense, ref_packed = jax_edges(gray, ksize, 10, 40, sigma)
    edges_b = canny.hysteresis(*canny.edge_candidates(torch.from_numpy(gray), shape[-1], ksize, 10, 40, sigma))
    np.testing.assert_array_equal(bitboards_to_jax(edges_b), ref_packed)
    got = filters.gaussian_blur_u8(torch.from_numpy(gray), ksize, sigma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfilters.gaussian_blur_u8(jnp.asarray(gray), ksize, sigma)))
    assert ref_dense.shape == shape


def test_canny_candidates_is_ksize_one():
    gray = torch.from_numpy(gray_images(3, 2, 21, 50))
    for got, ref in zip(canny.canny_candidates(gray, 30, 90), canny.edge_candidates_plain(gray, 50, 1, 30, 90)):
        assert torch.equal(got, ref)
    for got, ref in zip(canny.canny_candidates(gray, 30, 90), canny.canny_candidates_plain(gray, 90, 30)):
        assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# K3+K4: the tile-and-halo schedule of csrc/edge_candidates.cu, emulated
# ---------------------------------------------------------------------------


def reflect101(i: np.ndarray, n: int) -> np.ndarray:
    """The kernel's reflect101() on an index array."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    j = np.abs(i) % period
    j = np.where(j >= n, period - j, j)
    return np.where((i >= 0) & (i < n), i, j)


def emulate_edge_tiles(x: torch.Tensor, w: int, ksize: int, sigma: float, low: int, high: int, tile, rng,
                       blur_only: bool = False):
    """csrc/edge_candidates.cu's blocks, one tile at a time: load the tile
    with its halo by reflect-101, the row and the column pass, the magnitude
    of the tile and 1 px around it from clamped reads of the blurred region
    (0 outside the image), the NMS and the thresholds.  Blurred cells outside
    the image hold garbage.  Returns (cand, strong) int32 bitboards, or the
    blurred image."""
    if low > high:
        low, high = high, low
    low, high = min(low, 2041), min(high, 2041)
    taps = filters.gaussian_kernel_q8(ksize, sigma).astype(np.int64)
    img = (thinning.dense_from_boards_plain(x, w, 255) if x.dtype == torch.int32 else x).numpy().astype(np.int64)
    k, h, _ = img.shape
    th, tww = tile
    tw, nw, halo = 32 * tww, -(-w // 32), ksize // 2 + 2
    bh, bw = th + 4, tw + 4
    cand = np.zeros((k, -(-h // th) * th, -(-nw // tww) * tw), bool)
    strong, blurred = cand.copy(), np.zeros(cand.shape, np.uint8)
    for y0 in range(0, h, th):
        for x0 in range(0, 32 * nw, tw):
            # 1. the input region: cell (i, j) holds pixel (reflect(y0 - halo + i), reflect(x0 - halo + j))
            ys = reflect101(np.arange(y0 - halo, y0 + th + halo), h)
            xs = reflect101(np.arange(x0 - halo, x0 + tw + halo), w)
            in_s = img[:, ys][:, :, xs]
            # 2. column jb of the row sums reads input columns jb + t; row ib of the blur reads rows ib + t
            tmp_s = sum(taps[t] * in_s[:, :, t : t + bw] for t in range(ksize))
            assert tmp_s.max() <= 65535  # uint16 in the kernel
            acc = sum(taps[t] * tmp_s[:, t : t + bh, :] for t in range(ksize))
            blur_s = np.clip((acc + (1 << 15)) >> 16, 0, 255)
            by, bx = np.arange(y0 - 2, y0 + th + 2), np.arange(x0 - 2, x0 + tw + 2)
            outside = ~((by >= 0) & (by < h))[:, None] | ~((bx >= 0) & (bx < w))[None, :]
            blur_s[:, outside] = rng.integers(0, 256, (k, int(outside.sum())))  # no pass may read these
            if blur_only:
                blurred[:, y0 : y0 + th, x0 : x0 + tw] = blur_s[:, 2 : 2 + th, 2 : 2 + tw]
                continue

            def sobel(yv, xv):
                """gx, gy at image pixels (yv x xv): the neighbours' coordinates clamped to the image."""
                iy = {d: np.clip(yv + d, 0, h - 1) - y0 + 2 for d in (-1, 0, 1)}
                ix = {d: np.clip(xv + d, 0, w - 1) - x0 + 2 for d in (-1, 0, 1)}
                assert min(v.min() for v in iy.values()) >= 0 and max(v.max() for v in iy.values()) < bh
                assert min(v.min() for v in ix.values()) >= 0 and max(v.max() for v in ix.values()) < bw

                def at(dy, dx):
                    return blur_s[:, iy[dy][:, None], ix[dx][None, :]]

                gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))
                gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
                return gx, gy

            # 3. the magnitude of the tile and 1 px around it, 0 outside the image
            cy, cx = np.arange(y0 - 1, y0 + th + 1), np.arange(x0 - 1, x0 + tw + 1)
            gx, gy = sobel(cy, cx)
            inside = ((cy >= 0) & (cy < h))[:, None] & ((cx >= 0) & (cx < w))[None, :]
            mag_s = np.where(inside, np.abs(gx) + np.abs(gy), 0)
            # 4. the tile's own pixels
            ty, tx = np.arange(y0, y0 + th), np.arange(x0, x0 + tw)
            gx, gy = sobel(ty, tx)

            def m(dy, dx):
                return mag_s[:, 1 + dy : 1 + dy + th, 1 + dx : 1 + dx + tw]

            mag, ax, ay = m(0, 0), np.abs(gx), np.abs(gy) << 15
            tg22x = ax * 13573
            tg67x = tg22x + (ax << 16)
            keep = np.where(ay < tg22x, (mag > m(0, -1)) & (mag >= m(0, 1)),
                            np.where(ay > tg67x, (mag > m(-1, 0)) & (mag >= m(1, 0)),
                                     np.where((gx ^ gy) < 0, (mag > m(-1, 1)) & (mag > m(1, -1)),
                                              (mag > m(-1, -1)) & (mag > m(1, 1)))))
            valid = (ty < h)[:, None] & (tx < w)[None, :]
            c = valid & keep & (mag > low)
            cand[:, y0 : y0 + th, x0 : x0 + tw] = c
            strong[:, y0 : y0 + th, x0 : x0 + tw] = c & (mag > high)
    if blur_only:
        return torch.from_numpy(blurred[:, :h, :w].copy())
    return tuple(thinning.pack_bitboards_plain(torch.from_numpy(b[:, :h, : 32 * nw].copy())) for b in (cand, strong))


TILES = [None, (3, 1), (5, 2), (1, 1)]  # None: the kernel's own tile for the shape


@pytest.mark.parametrize("tile", TILES, ids=["own", "3x1", "5x2", "1x1"])
@pytest.mark.parametrize("ksize, sigma, k, h, w", [
    (5, 0.0, 2, 40, 150), (7, 0.0, 1, 33, 257), (1, 0.0, 2, 9, 31), (3, 0.0, 1, 1, 40), (9, 0.0, 1, 3, 2),
    (4, 0.0, 1, 12, 33), (5, 1.4, 1, 20, 64), (63, 0.0, 1, 12, 70)])
def test_k34_tile_schedule_matches_plain(ksize, sigma, k, h, w, tile):
    rng = np.random.default_rng(ksize * 1000 + h * 7 + w)
    low, high = THRESHOLDS[(ksize + h) % len(THRESHOLDS)]
    if tile is None:
        tile = kernels.edge_schedule(ksize, h, -(-w // 32))
    gray = torch.from_numpy(gray_images(ksize + w, k, h, w))
    _, boards = binary_boards(ksize + w + 1, k, h, w)
    for x in (gray, boards):
        got = emulate_edge_tiles(x, w, ksize, sigma, low, high, tile, rng)
        ref = canny.edge_candidates_plain(x, w, ksize, low, high, sigma)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = emulate_edge_tiles(gray, w, ksize, sigma, 0, 0, tile, rng, blur_only=True)
    assert torch.equal(got, filters.gaussian_blur_u8_plain(gray, ksize, sigma))


def test_k34_schedule():
    """The defaults take the full tile; a halo that does not fit halves the
    tile, rows first, before any launch; no tile at all raises."""
    for ksize in (1, 3, 5, 7, 9, 31):
        assert kernels.edge_schedule(ksize, 1500, 63) == (32, 4)
        assert kernels.edge_schedule(ksize, 4400, 138) == (32, 4)
    assert kernels.edge_schedule(5, 7, 1) == (7, 1)
    assert kernels.edge_smem_bytes(32, 4, 5) == 29612 and kernels.edge_smem_bytes(32, 4, 7) == 30504
    th, tww = kernels.edge_schedule(301, 50, 3)
    assert (th, tww) == (32, 3) and kernels.edge_smem_bytes(th, tww, 301) <= kernels.MAX_SMEM
    th, tww = kernels.edge_schedule(401, 1500, 63)
    assert th < 32 and kernels.edge_smem_bytes(th, tww, 401) <= kernels.MAX_SMEM
    assert kernels.edge_smem_bytes(min(32, 2 * th), 4, 401) > kernels.MAX_SMEM or tww < 4
    with pytest.raises(ValueError, match="does not fit"):
        kernels.edge_schedule(1001, 50, 3)


def test_k34_constants_match_the_source():
    """ops/kernels.py repeats csrc/edge_candidates.cu's layout: the same
    bytes for a tile, the same halo."""
    src = (Path(kernels.CSRC) / "edge_candidates.cu").read_text()
    assert "const int R = ksize / 2 + 2, tw = 32 * tww;" in src
    assert "size_t bytes = 2 * ah * bw + 2 * ch * cw + ah * aw + bh * bw;" in src
    assert "constexpr int kTG22 = 13573;" in src and canny._TG22 == 13573
    assert f"constexpr int kMaxSmem = {kernels.MAX_SMEM};" in src
    assert (kernels.EDGE_TILE_ROWS, kernels.EDGE_TILE_WORDS) == (32, 4)


# ---------------------------------------------------------------------------
# K1: the plain conversions vs the JAX package and np.packbits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("w", [1, 7, 8, 9, 31, 32, 33, 100, 250])
def test_k1_plain_conversions_match_jax(w):
    rng = np.random.default_rng(w)
    shape = (2, 5, w)
    u8 = ((rng.random(shape) < 0.5) * rng.integers(1, 256, shape)).astype(np.uint8)
    i32 = u8.astype(np.int32) - 7 * (u8 % 3 == 0)  # zeros and a third of the rest go <= 0
    ref_b = np.asarray(jthin.pack_bitboards(jnp.asarray(u8)))
    for dense in (u8, u8 > 0):
        np.testing.assert_array_equal(bitboards_to_jax(thinning.pack_bitboards(torch.from_numpy(dense))), ref_b)
    np.testing.assert_array_equal(bitboards_to_jax(thinning.pack_bitboards(torch.from_numpy(i32))),
                                  np.asarray(jthin.pack_bitboards(jnp.asarray(i32))))

    # packed rows with random padding bits in their last byte -> boards: bits at and beyond W zero
    rows = rng.integers(0, 256, (2, 5, -(-w // 8)), dtype=np.uint8)
    bits = np.asarray(jbitpack.bitunpack_rows(jnp.asarray(rows), w))
    np.testing.assert_array_equal(bits, np.unpackbits(rows, axis=-1)[..., :w])
    boards = bitpack.rows_to_boards(torch.from_numpy(rows), w)
    np.testing.assert_array_equal(bitboards_to_jax(boards), np.asarray(jthin.pack_bitboards(jnp.asarray(bits))))
    valid = thinning.pack_bitboards_plain(torch.ones((1, w)))
    assert torch.equal(boards & valid, boards)

    # boards with random padding bits -> rows and dense: the padding is dropped
    words = rng.integers(0, 2**32, (2, 5, -(-w // 32)), dtype=np.uint64).astype(np.uint32)
    dense = np.asarray(jthin.unpack_bitboards(jnp.asarray(words), w))
    np.testing.assert_array_equal(thinning.unpack_bitboards(bitboards_from_jax(words), w).numpy(), dense)
    got = bitpack.boards_to_rows(bitboards_from_jax(words), w)
    np.testing.assert_array_equal(got.numpy(), np.packbits(dense > 0, axis=-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitpack.bitpack_rows(jnp.asarray(dense))))
    for value in (1, 255):
        got = thinning.dense_from_boards(bitboards_from_jax(words), w, value)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), dense.astype(np.uint8) * value)
    # into a given tensor: the chain writes its blob in place
    out = torch.full((2, 2, 5, -(-w // 8)), 0xAB, dtype=torch.uint8)
    assert bitpack.boards_to_rows(bitboards_from_jax(words), w, out=out[1]) is not None
    np.testing.assert_array_equal(out[1].numpy(), np.packbits(dense > 0, axis=-1))
    assert bool((out[0] == 0xAB).all())


def test_new_dispatchers_raise_for_other_devices():
    """Only a CPU tensor takes a plain version; a tensor on any device but the
    CPU and CUDA raises."""
    meta = torch.device("meta")
    u8 = torch.zeros((1, 4, 40), dtype=torch.uint8, device=meta)
    b = torch.zeros((1, 4, 2), dtype=torch.int32, device=meta)
    for call in (lambda: thinning.pack_bitboards(u8), lambda: thinning.unpack_bitboards(b, 40),
                 lambda: thinning.dense_from_boards(b, 40, 255), lambda: bitpack.bitpack_rows(u8),
                 lambda: bitpack.bitunpack_rows(u8[..., :5], 40), lambda: bitpack.rows_to_boards(u8[..., :5], 40),
                 lambda: bitpack.boards_to_rows(b, 40), lambda: filters.gaussian_blur_u8(u8, 5),
                 lambda: canny.edge_candidates(b, 40, 5, 22, 70), lambda: canny.canny_candidates(u8, 22, 70),
                 lambda: onehot_boards(b, 4),
                 lambda: assign_boards(torch.zeros((4, 4, 3), dtype=torch.uint8, device=meta),
                                       torch.zeros((4, 3), device=meta), 4)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
