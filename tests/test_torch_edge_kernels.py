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
from plotweave_torch.ops import bitpack, filters, kernels, morphology, thinning

# the package exports the function ``canny``, as ``plotweave.ops`` does, so the module is named in full
canny = importlib.import_module("plotweave_torch.ops.canny")
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


THREADS = 256  # kThreads in csrc/edge_candidates.cu


def edge_layout(th: int, tww: int, ksize: int, boards: bool, fast: bool) -> dict:
    """csrc/edge_candidates.cu's make_layout()."""
    halo, tw = ksize // 2 + 2, 32 * tww
    ra = -(-halo // 4) * 4
    lay = {"R": halo, "tw": tw, "ah": th + 2 * halo, "bh": th + 4, "bwords": tw // 4 + 1, "hw": -(-halo // 32),
           "pad": ra - halo if fast and not boards else 0}
    lay["in_words"] = tww + 2 * lay["hw"] if boards else tw // 4 + ra // 2 + 1 if fast else -(-(tw + 2 * halo) // 4)
    lay["aux_words"] = lay["ah"] * (tw + 4) // 2 if not fast else ((1 << ksize) + 1) // 2 if boards else 0
    total = 4 * (lay["bh"] * lay["bwords"] + lay["ah"] * lay["in_words"] + lay["aux_words"] + ksize)
    assert total == kernels.edge_smem_bytes(th, tww, ksize, boards, fast) <= kernels.MAX_SMEM
    return lay


def funnel(lo: np.ndarray, hi: np.ndarray, shift) -> np.ndarray:
    """__funnelshift_r: the low 32 bits of (hi:lo) >> (shift & 31)."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both >> (np.asarray(shift) & 31).astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def emulate_edge_tiles(x: torch.Tensor, w: int, ksize: int, sigma: float, low: int, high: int, tile, rng,
                       blur_only: bool = False, fast=None, top: int = 0, bottom: int = 0):
    """csrc/edge_candidates.cu's blocks, one tile at a time, in its own index
    relations: the input region loaded as words (a board) or bytes (a dense
    image), by plain coordinates in an interior tile and by reflect-101 in a
    rim tile; the blur walk of four-column strips over row segments with the
    last ``ksize`` row sums in a ring (window-table sums from a board, byte
    windows times packed taps from bytes), or the general path's two passes;
    the rim's replicate fix-up; the Sobel and NMS walk with its three rotating
    slots, the NMS one row behind, the magnitude 0 outside the image; words
    assembled from eight strips.  Every cell the kernel must not read holds
    garbage: the bits and bytes of the input region beside its pixels, the
    blurred cells outside the image before the fix-up, the slots before their
    first write.  Returns (cand, strong) int32 bitboards, or the blurred
    image.  With ``top`` and ``bottom`` (the slab mode) ``x`` is a slab whose
    tiles cover rows [top, H - bottom), stored at their own row 0: a tile is
    interior only inside the buffer and the own rows, and the rim's rules
    apply at the buffer's ends."""
    if low > high:
        low, high = high, low
    low, high = min(low, 2041), min(high, 2041)
    taps = filters.gaussian_kernel_q8(ksize, sigma).astype(np.int64)
    boards = x.dtype == torch.int32
    if fast is None:
        fast = kernels.edge_fast(ksize, sigma)
    assert not fast or (ksize in kernels.EDGE_FAST_KSIZES and (ksize == 1 or (taps.min() >= 0 and taps.max() <= 255)))
    src = bitboards_to_jax(x) if boards else x.numpy()
    k, h = src.shape[0], src.shape[1]
    own_rows = h - top - bottom
    nw = -(-w // 32)
    th, tww = tile if tile is not None else kernels.edge_schedule(ksize, k, own_rows, nw, boards, fast)
    lay = edge_layout(th, tww, ksize, boards, fast)
    R, tw, ah, bh, hw, pad, in_words = (lay[key] for key in ("R", "tw", "ah", "bh", "hw", "pad", "in_words"))
    bw = tw + 4
    cand = np.zeros((k, own_rows, nw), np.uint32)
    strong, blurred = cand.copy(), np.zeros((k, own_rows, w), np.uint8)
    written = np.zeros((own_rows, nw), bool)

    def garbage(shape, dtype=np.uint32):
        return rng.integers(0, np.iinfo(dtype).max, shape, dtype=np.uint64).astype(dtype)

    for y0 in range(top, top + own_rows, th):
        for x0 in range(0, 32 * nw, tw):
            interior = y0 >= R and y0 + th + R <= h and y0 + th <= top + own_rows and x0 >= R and x0 + tw + R <= w
            ys = np.arange(y0 - R, y0 + th + R)
            if interior:
                assert ys[0] >= 0 and ys[-1] < h  # plain coordinates
            else:
                ys = reflect101(ys, h)

            # 1. the input region
            if boards:
                in_s = np.zeros((k, ah, in_words), np.uint32)
                for jw in range(in_words):
                    wi = x0 // 32 - hw + jw
                    if interior:
                        if 0 <= wi < nw:
                            in_s[:, :, jw] = src[:, ys, wi]
                    elif 32 * wi >= 0 and 32 * wi + 32 <= w:
                        in_s[:, :, jw] = src[:, ys, wi]
                    else:  # bit by bit through reflect-101: never a bit at or beyond W
                        for b in range(32):
                            xx = int(reflect101(np.array([32 * wi + b]), w)[0])
                            in_s[:, :, jw] |= ((src[:, ys, xx >> 5] >> np.uint32(xx & 31)) & np.uint32(1)) << np.uint32(b)
                # the bits beside the region's pixels (columns x0 - R ... x0 + tw + R - 1) are never read
                cols = 32 * (x0 // 32 - hw) + np.arange(32 * in_words)
                unread = (cols < x0 - R) | (cols >= x0 + tw + R)
                noise = np.packbits(unread[None, None, :] & (rng.random((k, ah, 32 * in_words)) < 0.5), axis=-1,
                                    bitorder="little").view(np.uint32)
                in_s ^= noise
            else:
                in_b = garbage((k, ah, in_words * 4), np.uint8)
                xs = np.arange(x0 - R, x0 + tw + R)
                if interior:
                    assert xs[0] >= 0 and xs[-1] < w
                else:
                    xs = reflect101(xs, w)
                in_b[:, :, pad : pad + tw + 2 * R] = src[:, ys][:, :, xs]

            # 2. the blurred bytes of the tile and 2 px around it
            blur_s = np.full((k, bh, bw), -1, np.int64)
            if fast:
                nsx = lay["bwords"]
                nseg = max(1, THREADS // nsx)
                rps = -(-bh // nseg)
                j = np.arange(nsx)
                if boards:
                    tab = np.array([255 * sum(int(taps[t]) for t in range(ksize) if m >> t & 1)
                                    for m in range(1 << ksize)], np.int64)
                    assert tab.max() <= 65535  # uint16 in the kernel
                    bit = 32 * hw - R + 4 * j
                else:
                    nq = (ksize + 3) // 4
                    tapw = np.zeros(4 * nq, np.int64)  # the taps packed four bytes a word, zero beyond ksize
                    tapw[:ksize] = taps & 255
                for seg in range(nseg):
                    b0, b1 = seg * rps, min(bh, seg * rps + rps)
                    ring = rng.integers(0, 70000, (ksize, k, nsx, 4))  # garbage until a step writes its slot
                    for t in range(b1 - b0 + ksize - 1 if b0 < b1 else 0):
                        u = t % ksize
                        if boards:
                            row = in_s[:, b0 + t]
                            win = funnel(row[:, bit >> 5], row[:, (bit >> 5) + 1], bit & 31)
                            for p in range(4):
                                idx = (win >> np.uint32(p)) & np.uint32((1 << ksize) - 1)
                                ring[u, :, :, p] = idx.astype(np.int64) * 255 if ksize == 1 else tab[idx]
                        else:
                            row = in_b[:, b0 + t].astype(np.int64)
                            for p in range(4):
                                first = 4 * j + pad + p  # the window's first byte
                                if ksize == 1:
                                    ring[u, :, :, p] = row[:, first]
                                else:  # __dp4a over whole words of four bytes: bytes under a zero tap are read
                                    ring[u, :, :, p] = sum(tapw[q] * row[:, first + q] for q in range(4 * nq))
                        if t >= ksize - 1:
                            if ksize == 1:
                                out = ring[0]
                            else:
                                acc = sum(taps[q] * ring[(u + 1 + q) % ksize] for q in range(ksize)) + (1 << 15)
                                out = acc >> 16
                                assert out.min() >= 0 and out.max() <= 255  # no clamp in the kernel
                            ib = b0 + t - (ksize - 1)
                            blur_s[:, ib] = out.reshape(k, 4 * nsx)
            else:
                if boards:
                    bits = np.unpackbits(in_s.view(np.uint8), axis=-1, bitorder="little").astype(np.int64)
                    rs = sum(taps[t] * bits[:, :, 32 * hw - R + t : 32 * hw - R + t + bw] for t in range(ksize)) * 255
                else:
                    rs = sum(taps[t] * in_b[:, :, t : t + bw].astype(np.int64) for t in range(ksize))
                rs = rs.astype(np.uint16).astype(np.int64)  # uint16 in the kernel
                acc = sum(taps[t] * rs[:, t : t + bh] for t in range(ksize))
                blur_s = np.clip((acc + (1 << 15)) >> 16, 0, 255)
            assert blur_s.min() >= 0  # every cell written

            if blur_only:
                ny, nx = min(th, top + own_rows - y0), max(0, min(tw, w - x0))
                blurred[:, y0 - top : y0 - top + ny, x0 : x0 + nx] = blur_s[:, 2 : 2 + ny, 2 : 2 + nx]
                continue

            if not interior:
                # Sobel's replicate border: blurred cells outside the image take the byte at the clamped coordinate
                by, bx = np.arange(y0 - 2, y0 + th + 2), np.arange(x0 - 2, x0 + tw + 2)
                outside = ~((by >= 0) & (by < h))[:, None] | ~((bx >= 0) & (bx < w))[None, :]
                blur_s[:, outside] = rng.integers(0, 256, (k, int(outside.sum())))  # whatever the walk left there
                iy, ix = np.clip(by, 0, h - 1) - y0 + 2, np.clip(bx, 0, w - 1) - x0 + 2
                assert iy.min() >= 0 and iy.max() < bh and ix.min() >= 0 and ix.max() < bw
                fixed = blur_s[:, iy[:, None], ix[None, :]]
                blur_s = np.where(outside[None], fixed, blur_s)

            # 3. the Sobel and NMS walk
            nss = tw // 4
            nseg = max(1, THREADS // nss)
            rps = -(-th // nseg)
            s = np.arange(nss)
            xcol = x0 + 4 * s
            for seg in range(nseg):
                i0 = seg * rps
                i1 = min(th, i0 + rps)
                if i0 >= th:  # the kernel walks these too, and stores nothing
                    continue
                d, sm, mg = (rng.integers(-3000, 3000, (3, k, nss, 6)) for _ in range(3))
                gxs, gys = (rng.integers(-3000, 3000, (3, k, nss, 4)) for _ in range(2))
                for t in range(rps + 4):
                    u, s0, s1 = t % 3, (t + 1) % 3, (t + 2) % 3
                    row = blur_s[:, min(i0 + t, bh - 1)]  # an overhanging segment re-reads the last row
                    b = np.stack([row[:, 4 * s + c] for c in range(8)], axis=-1)  # words s and s + 1
                    d[u] = b[..., 2:8] - b[..., 0:6]
                    sm[u] = b[..., 0:6] + 2 * b[..., 1:7] + b[..., 2:8]
                    if t < 2:
                        continue
                    m = i0 + t - 3
                    gx, gy = d[s0] + 2 * d[s1] + d[u], sm[u] - sm[s0]
                    mag = np.abs(gx) + np.abs(gy)
                    if not interior:  # the NMS's border: 0 outside the image
                        xc = xcol[:, None] - 1 + np.arange(6)[None, :]
                        mag = np.where((0 <= y0 + m < h) & (xc >= 0) & (xc < w), mag, 0)
                    mg[s0], gxs[s0], gys[s0] = mag, gx[..., 1:5], gy[..., 1:5]
                    if t < 4:
                        continue
                    i = m - 1
                    gx, gy, own, up, down = gxs[u], gys[u], mg[u], mg[s1], mg[s0]
                    mag, ax, ay = own[..., 1:5], np.abs(gx), np.abs(gy) << 15
                    tg22x = ax * 13573
                    tg67x = tg22x + (ax << 16)
                    keep = np.where(ay < tg22x, (mag > own[..., 0:4]) & (mag >= own[..., 2:6]),
                                    np.where(ay > tg67x, (mag > up[..., 1:5]) & (mag >= down[..., 1:5]),
                                             np.where((gx ^ gy) < 0, (mag > up[..., 2:6]) & (mag > down[..., 0:4]),
                                                      (mag > up[..., 0:4]) & (mag > down[..., 2:6]))))
                    cb = keep & (mag > low)  # never beyond the image: a magnitude of 0 keeps nothing
                    sb = cb & (mag > high)
                    if not i < i1:
                        continue
                    if y0 + i >= top + own_rows:
                        assert not interior
                        continue
                    for bits, out in ((cb, cand), (sb, strong)):
                        words = np.packbits(bits.reshape(k, nss // 8, 32), axis=-1, bitorder="little").view(np.uint32)
                        for wj in range(nss // 8):
                            if x0 // 32 + wj < nw:
                                out[:, y0 + i - top, x0 // 32 + wj] = words[:, wj, 0]
                            else:
                                assert not interior
                    written[y0 + i - top, x0 // 32 : x0 // 32 + nss // 8] = True
    if blur_only:
        return torch.from_numpy(blurred)
    assert written.all()  # each word of each row stored
    return bitboards_from_jax(cand), bitboards_from_jax(strong)


TILES = [None, (3, 1), (5, 2), (1, 1), (64, 3)]  # None: the kernel's own tile for the shape
CASES = [(5, 0.0, 2, 30, 150), (7, 0.0, 1, 14, 257), (1, 0.0, 2, 9, 31), (3, 0.0, 1, 1, 40), (9, 0.0, 1, 3, 2),
         (4, 0.0, 1, 12, 33), (5, 1.4, 1, 20, 64), (63, 0.0, 1, 12, 70), (5, 0.1, 1, 14, 45), (9, 2.0, 1, 21, 100),
         (3, 0.0, 2, 38, 200), (11, 0.0, 1, 16, 64)]


@pytest.mark.parametrize("tile", TILES, ids=["own", "3x1", "5x2", "1x1", "64x3"])
@pytest.mark.parametrize("ksize, sigma, k, h, w", CASES)
def test_k34_tile_schedule_matches_plain(ksize, sigma, k, h, w, tile):
    rng = np.random.default_rng(ksize * 1000 + h * 7 + w)
    low, high = THRESHOLDS[(ksize + h) % len(THRESHOLDS)]
    gray = torch.from_numpy(gray_images(ksize + w, k, h, w))
    _, boards = binary_boards(ksize + w + 1, k, h, w)
    for x in (gray, boards):
        got = emulate_edge_tiles(x, w, ksize, sigma, low, high, tile, rng)
        ref = canny.edge_candidates_plain(x, w, ksize, low, high, sigma)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    got = emulate_edge_tiles(gray, w, ksize, sigma, 0, 0, tile, rng, blur_only=True)
    assert torch.equal(got, filters.gaussian_blur_u8_plain(gray, ksize, sigma))


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("what", ["board", "dense", "board general", "dense general"])
def test_k34_interior_and_rim_tiles_match_jax(ksize, what):
    """An image of several tiles each way, so that interior tiles (no
    reflection, no clamp, no bound test) and rim tiles both run, on every
    template instance and on the general path with the same taps, against the
    JAX functions and the plain version."""
    k, h, w = 2, 26, 200
    rng = np.random.default_rng(ksize)
    dense, boards = binary_boards(40 + ksize, k, h, w)
    gray = gray_images(50 + ksize, k, h, w)
    x, ref_in = (boards, dense) if what.startswith("board") else (torch.from_numpy(gray), gray)
    fast = not what.endswith("general")
    assert kernels.edge_fast(ksize)
    for tile in ((6, 1), (4, 2)):
        n_interior = sum(y0 >= ksize // 2 + 2 and y0 + tile[0] + ksize // 2 + 2 <= h and x0 >= ksize // 2 + 2
                         and x0 + 32 * tile[1] + ksize // 2 + 2 <= w
                         for y0 in range(0, h, tile[0]) for x0 in range(0, 224, 32 * tile[1]))
        assert n_interior >= 2
        cand, strong = emulate_edge_tiles(x, w, ksize, 0.0, 22, 70, tile, rng, fast=fast)
        ref = canny.edge_candidates_plain(x, w, ksize, 22, 70)
        assert torch.equal(cand, ref[0]) and torch.equal(strong, ref[1])
        _, ref_packed = jax_edges(ref_in, ksize, 22, 70)
        np.testing.assert_array_equal(bitboards_to_jax(canny.hysteresis_plain(cand, strong)), ref_packed)
        if not what.startswith("board"):
            got = emulate_edge_tiles(x, w, ksize, 0.0, 0, 0, tile, rng, blur_only=True, fast=fast)
            np.testing.assert_array_equal(got.numpy(), np.asarray(jfilters.gaussian_blur_u8(jnp.asarray(gray), ksize)))


def test_k34_paths():
    """The template instances take odd ksize up to 9 whose taps are bytes; a
    sigma so small that the centre tap is 256, an even or a larger ksize take
    the general path."""
    assert all(kernels.edge_fast(ks) for ks in (1, 3, 5, 7, 9)) and kernels.edge_fast(5, 1.4) and kernels.edge_fast(9, 2.0)
    assert filters.gaussian_kernel_q8(5, 0.1).tolist() == [0, 0, 256, 0, 0]
    assert not any(kernels.edge_fast(ks, sg) for ks, sg in ((5, 0.1), (3, 0.2), (4, 0.0), (11, 0.0), (63, 0.0)))
    assert kernels.edge_fast(1, 0.1)


def test_k34_schedule():
    """The taller tile where the grid keeps enough blocks, else the shorter; a
    halo that does not fit halves the tile, rows first, before any launch; no
    tile at all raises."""
    assert (kernels.EDGE_TILE_ROWS, kernels.EDGE_TILE_WORDS, kernels.EDGE_TALL_BLOCKS) == ((32, 64), 4, 1024)
    for ksize in (1, 3, 5, 7, 9):
        for boards in (True, False):
            assert kernels.edge_schedule(ksize, 4, 1500, 63, boards, True) == (64, 4)  # 4 * 24 * 16 blocks
            assert kernels.edge_schedule(ksize, 1, 1500, 63, boards, True) == (32, 4)  # 384 at 64 rows
            assert kernels.edge_schedule(ksize, 1, 4400, 138, boards, True) == (64, 4)
            assert kernels.edge_schedule(ksize, 8, 1024, 32, boards, True) == (64, 4)  # 1,024 exactly
            assert kernels.edge_schedule(ksize, 4, 512, 16, boards, True) == (32, 4)
    assert kernels.edge_schedule(31, 1, 1500, 63, False, False) == (32, 4)
    assert kernels.edge_schedule(5, 1, 7, 1, True, True) == (7, 1)
    # from a board at ksize 5 and 7: 36 rows of 33 blurred words, the region of 6 words a row, the table, the taps
    assert kernels.edge_smem_bytes(32, 4, 5, True, True) == 4 * (36 * 33 + 40 * 6 + 16 + 5) == 5796
    assert kernels.edge_smem_bytes(32, 4, 7, True, True) == 4 * (36 * 33 + 42 * 6 + 64 + 7) == 6044
    assert kernels.edge_smem_bytes(64, 4, 5, True, True) == 4 * (68 * 33 + 72 * 6 + 16 + 5) == 10788
    assert kernels.edge_smem_bytes(32, 4, 5, False, True) == 4 * (36 * 33 + 40 * 35 + 5)
    assert kernels.edge_smem_bytes(32, 4, 4, False, False) == 4 * (36 * 33 + 40 * 34 + 40 * 132 // 2 + 4)
    th, tww = kernels.edge_schedule(301, 2, 50, 3, False, False)
    assert (th, tww) == (32, 3) and kernels.edge_smem_bytes(th, tww, 301, False, False) <= kernels.MAX_SMEM
    th, tww = kernels.edge_schedule(401, 4, 1500, 63, False, False)
    assert (th, tww) == (1, 1) and kernels.edge_smem_bytes(1, 1, 401, False, False) <= kernels.MAX_SMEM
    assert kernels.edge_smem_bytes(1, 2, 401, False, False) > kernels.MAX_SMEM
    with pytest.raises(ValueError, match="does not fit"):
        kernels.edge_schedule(1001, 1, 50, 3, False, False)


def test_k34_constants_match_the_source():
    """ops/kernels.py repeats csrc/edge_candidates.cu's layout and template
    instances, and ``edge_layout`` here repeats both."""
    src = (Path(kernels.CSRC) / "edge_candidates.cu").read_text()
    for line in ("L.R = ksize / 2 + 2, L.tw = 32 * tww;",
                 "L.ah = th + 2 * L.R, L.bh = th + 4, L.bwords = L.tw / 4 + 1;",
                 "L.hw = (L.R + 31) / 32;",
                 "const int ra = (L.R + 3) / 4 * 4;",
                 "if (boards) L.in_words = tww + 2 * L.hw;",
                 "else if (fast) L.in_words = L.tw / 4 + ra / 2 + 1;",
                 "else L.in_words = (L.tw + 2 * L.R + 3) / 4;",
                 "if (!fast) L.aux_words = L.ah * (L.tw + 4) / 2;",
                 "else L.aux_words = boards ? ((1 << ksize) + 1) / 2 : 0;",
                 "return 4 * ((size_t)L.bh * L.bwords + (size_t)L.ah * L.in_words + (size_t)L.aux_words + (size_t)ksize);",
                 "constexpr int kTG22 = 13573;", f"constexpr int kMaxSmem = {kernels.MAX_SMEM};",
                 f"constexpr int kThreads = {THREADS};"):
        assert line in src, line
    assert canny._TG22 == 13573
    assert kernels.EDGE_TILE_WORDS == 4 and "tww > 4" in src
    for ks in range(0, 12):
        assert (f"case {ks}: return edge_tiles<{ks}, kBoards>;" in src) == (ks == 0 or ks in kernels.EDGE_FAST_KSIZES)
    for boards in (True, False):
        for fast in (True, False):
            edge_layout(32, 4, 7, boards, fast)


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
    boards = bitpack.rows_to_boards_plain(torch.from_numpy(rows), w)
    np.testing.assert_array_equal(bitboards_to_jax(boards), np.asarray(jthin.pack_bitboards(jnp.asarray(bits))))
    valid = thinning.pack_bitboards_plain(torch.ones((1, w)))
    assert torch.equal(boards & valid, boards)

    # boards with random padding bits -> rows and dense: the padding is dropped
    words = rng.integers(0, 2**32, (2, 5, -(-w // 32)), dtype=np.uint64).astype(np.uint32)
    dense = np.asarray(jthin.unpack_bitboards(jnp.asarray(words), w))
    np.testing.assert_array_equal(thinning.unpack_bitboards(bitboards_from_jax(words), w).numpy(), dense)
    got = bitpack.boards_to_rows_plain(bitboards_from_jax(words), w)
    np.testing.assert_array_equal(got.numpy(), np.packbits(dense > 0, axis=-1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbitpack.bitpack_rows(jnp.asarray(dense))))
    for value in (1, 255):
        got = thinning.dense_from_boards(bitboards_from_jax(words), w, value)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), dense.astype(np.uint8) * value)
    # into a given tensor, by K2's packed-row store: stage 02's device mode writes the masks' rows in place
    out = torch.full((2, 2, 5, -(-w // 8)), 0xAB, dtype=torch.uint8)
    assert morphology.morph_steps(bitboards_from_jax(words), morphology._valid_bits(w), (), w, out[1]) is not None
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
                 lambda: bitpack.bitunpack_rows(u8[..., :5], 40),
                 lambda: morphology.morph_steps(u8[..., :5], b[0, 0], (), 40),
                 lambda: thinning.zhang_suen_into(b, 40, u8[None, ..., :5], u8[None, ..., :5]),
                 lambda: filters.gaussian_blur_u8(u8, 5),
                 lambda: canny.edge_candidates(b, 40, 5, 22, 70), lambda: canny.canny_candidates(u8, 22, 70),
                 lambda: onehot_boards(b, 4),
                 lambda: assign_boards(torch.zeros((4, 4, 3), dtype=torch.uint8, device=meta),
                                       torch.zeros((4, 3), device=meta), 4)):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            call()
