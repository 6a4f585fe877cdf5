"""Kernel K11's schedule (``plotweave_torch/csrc/morph_dense.cu``) emulated in
numpy, on the CPU, byte for byte against the plain version
(``ops/morphology.py::morph_dense_plain``) and the JAX package's ``_morph``.

The emulation repeats the kernel's work as it lies in shared memory: the
element's row runs (``kernels.element_runs``), the segments of
``kernels.dense_morph_schedule``, persistent CTAs that walk their tiles with
buffers that keep whatever the last tile left, the region of a tile with its
halo and slack, loaded by 16-byte chunks (zero outside the image) or byte by
byte (cells outside untouched), the next tile loaded into the other buffer
before this one's steps run, the rim's neutral fill of the rows each step reads, the H
pass on 32-bit words cut by funnel shifts (unrolled runs and long runs), the
V pass over the run's rows folded into the step's output, the 16-pixel chunks
that round each step's window outward, a rect of side 2 to 5 walked down in
word columns with its rows' min/max widened to u16 pairs (``roll_step``, no H
plane), and the store.  Every buffer starts as
garbage, so a step that reads a cell it may not read gives other bytes.  The
byte ops are the kernel's: ``__byte_perm`` with its selectors (read from the
source) and DPX three-input min/max on u16 lanes.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from plotweave.ops import morphology as jmorph
from plotweave_torch.ops import kernels, morphology

SHAPES = ("rect", "ellipse", "cross")
SRC = (kernels.CSRC / "morph_dense.cu").read_text()


def cu_constant(name: str) -> int:
    """A constant of csrc/morph_dense.cu, as the source declares it."""
    return int(re.search(rf"\b{name} = (0x[0-9a-fA-F]+|\d+)", SRC).group(1), 0)


EVENS, ODDS, INTERLEAVE = cu_constant("kEvens"), cu_constant("kOdds"), cu_constant("kInterleave")
FAST_RUN = cu_constant("kFastRun")
U64 = np.uint64


def gray(rng, *shape) -> np.ndarray:
    """Smooth blobs plus noise, so that neighbouring minima and maxima differ."""
    x = rng.integers(0, 256, shape).astype(np.float32)
    for axis in (-1, -2):
        x = (np.roll(x, 1, axis) + x + np.roll(x, -1, axis)) / 3
    return np.clip(x * 1.6 - 70 + rng.integers(-20, 21, shape), 0, 255).astype(np.uint8)


# --- the kernel's word operations ---------------------------------------------------


def funnelshift_r(lo, hi, s: int):
    """``__funnelshift_r``: the low 32 bits of (hi:lo) >> (s & 31)."""
    v = (np.asarray(hi).astype(U64) << U64(32)) | np.asarray(lo).astype(U64)
    return ((v >> U64(s & 31)) & U64(0xFFFFFFFF)).astype(np.uint32)


def byte_perm(x, y, sel: int):
    """``__byte_perm``: byte i of the result is byte (sel >> 4 i) & 7 of (y:x)."""
    x, y = np.asarray(x, np.uint32), np.asarray(y, np.uint32)
    src = [(x >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)] + \
          [(y >> np.uint32(8 * i)) & np.uint32(0xFF) for i in range(4)]
    out = np.zeros(np.broadcast(x, y).shape, np.uint32)
    for i in range(4):
        nib = (sel >> (4 * i)) & 0xF
        assert nib < 8, "no sign replication in the kernel's selectors"
        out |= src[nib] << np.uint32(8 * i)
    return out


def lanes(bits: int, f, *xs):
    """``f`` applied lane by lane to 32-bit words cut into lanes of ``bits``."""
    mask, out = np.uint32((1 << bits) - 1), 0
    for i in range(0, 32, bits):
        out = out | (f(*[(np.asarray(x, np.uint32) >> np.uint32(i)) & mask for x in xs]) << np.uint32(i))
    return np.asarray(out, np.uint32)


def op3(a, b, c, is_max: bool):
    """The kernel's ``op3``: bytewise min (max) of three words, as DPX on
    the even and the odd bytes widened to u16 lanes."""
    f = np.maximum if is_max else np.minimum

    def f3(p, q, r):
        return f(f(p, q), r)

    e = lanes(16, f3, *(byte_perm(v, 0, EVENS) for v in (a, b, c)))
    o = lanes(16, f3, *(byte_perm(v, 0, ODDS) for v in (a, b, c)))
    return byte_perm(e, o, INTERLEAVE)


def op2(a, b, is_max: bool):
    return op3(a, b, b, is_max)


# --- the kernel, pass by pass -------------------------------------------------------


def offsets(buf: int, S: int, y0: int, y1: int, c0: int, c1: int) -> np.ndarray:
    """Byte offsets of the chunks [c0, c1) of rows [y0, y1) of a buffer."""
    return buf + np.arange(y0, y1)[:, None] * S + 16 * np.arange(c0, c1)[None, :]


def hpass(words, a, hb, S, y0, y1, c0, c1, dx0, L, is_max):
    off = offsets(0, S, y0, y1, c0, c1)
    qa, s = dx0 >> 2, (dx0 & 3) * 8
    wi = (a + off) // 4 + qa
    r = []
    if L <= FAST_RUN:
        n_a = 5 + (L - 1) // 4
        W = [words[wi + m] for m in range(n_a + 1)]
        A = [funnelshift_r(W[m], W[m + 1], s) for m in range(n_a)]
        for j in range(4):
            v = [funnelshift_r(A[j + i // 4], A[j + i // 4 + 1], 8 * (i & 3)) if i & 3 else A[j + i // 4]
                 for i in range(L)]
            acc = v[0]
            for i in range(1, L, 2):
                acc = op3(acc, v[i], v[i + 1], is_max) if i + 1 < L else op2(acc, v[i], is_max)
            r.append(acc)
    else:
        for j in range(4):
            q = wi + j
            w1 = words[q + 1]
            cur = funnelshift_r(words[q], w1, s)
            acc = cur
            for m in range((L + 3) // 4):
                w2 = words[q + m + 2]
                nxt = funnelshift_r(w1, w2, s)
                left = L - 4 * m
                v1 = funnelshift_r(cur, nxt, 8) if left > 1 else cur
                v2 = funnelshift_r(cur, nxt, 16) if left > 2 else cur
                v3 = funnelshift_r(cur, nxt, 24) if left > 3 else cur
                acc = op3(op3(acc, cur, v1, is_max), v2, v3, is_max)
                w1, cur = w2, nxt
            r.append(acc)
    for j in range(4):
        words[(hb + off) // 4 + j] = r[j]


def vpass(words, hb, d, S, y0, y1, c0, c1, dys, first, is_max):
    off = offsets(0, S, y0, y1, c0, c1)
    out = []
    for j in range(4):
        rows = [words[(hb + off + dy * S) // 4 + j] for dy in dys]
        acc = rows[0]
        for i in range(1, len(rows), 2):
            acc = op3(acc, rows[i], rows[i + 1], is_max) if i + 1 < len(rows) else op2(acc, rows[i], is_max)
        if not first:
            acc = op2(acc, words[(d + off) // 4 + j], is_max)
        out.append(acc)
    for j in range(4):
        words[(d + off) // 4 + j] = out[j]


def square_side(groups) -> int:
    """The side of a rect step that ``roll_step`` takes (2 to 5; one run
    [-K/2, (K-1)/2] over the same rows), else 0: the kernel's rule."""
    if len(groups) != 1:
        return 0
    dx0, dx1, dys = groups[0]
    side = dx1 - dx0 + 1
    return side if 2 <= side <= 5 and dx0 == -(side // 2) and tuple(dys) == tuple(range(dx0, dx1 + 1)) else 0


def window(d: int, el, ol, ec, oc, er, orr):
    """``window<D>``: the run's window at pixel offset d as (even, odd) u16 pairs."""
    return {-2: (funnelshift_r(el, ec, 16), funnelshift_r(ol, oc, 16)),
            -1: (funnelshift_r(ol, oc, 16), ec),
            0: (ec, oc),
            1: (oc, funnelshift_r(ec, er, 16)),
            2: (funnelshift_r(ec, er, 16), funnelshift_r(oc, orr, 16))}[d]


def lanes_all(vals, is_max: bool):
    """``lanes_all``: op over u16-pair words, three at a time (the last repeated)."""
    f = np.maximum if is_max else np.minimum
    acc = vals[0]
    for i in range(1, len(vals), 2):
        acc = lanes(16, lambda p, q, r: f(f(p, q), r), acc, vals[i], vals[min(i + 1, len(vals) - 1)])
    return acc


def roll_step(words, a, d, S, y0, y1, w0, w1, side, is_max):
    """``roll_step``: every output word of rows [y0, y1) and word columns
    [w0, w1) from the run's min/max of the side rows around it, each row's
    words widened once; the segments and the ring in registers change no byte."""
    lo, hi = -(side // 2), (side - 1) // 2
    q = (a + np.arange(y0 + lo, y1 + hi)[:, None] * S) // 4 + np.arange(w0, w1)[None, :]
    planes = [byte_perm(words[q + k], 0, sel) for k in (-1, 0, 1) for sel in (EVENS, ODDS)]
    wins = [window(lo + i, *planes) for i in range(side)]
    he, ho = lanes_all([e for e, _ in wins], is_max), lanes_all([o for _, o in wins], is_max)  # by row from y0 + lo
    n = y1 - y0
    ring_e = [he[i: i + n] for i in range(side)]
    ring_o = [ho[i: i + n] for i in range(side)]
    out = byte_perm(lanes_all(ring_e, is_max), lanes_all(ring_o, is_max), INTERLEAVE)
    words[(d + np.arange(y0, y1)[:, None] * S) // 4 + np.arange(w0, w1)[None, :]] = out


def emulate_k11(x: np.ndarray, steps, rng, ctas: int = 3, force_bytes: bool = False):
    """K11 on a (..., H, W) uint8 array, launch by launch, CTA by CTA."""
    h, w = x.shape[-2:]
    src = x.reshape(-1, h, w)
    k = src.shape[0]
    runs = [kernels.element_runs(shape, ksize) for shape, ksize, _ in steps]
    sizes = kernels.dense_morph_sizes(steps)
    slack = kernels.DENSE_SLACK
    for start, stop, th, tw, halo, prefetch in kernels.dense_morph_schedule(sizes):
        assert tw % 16 == 0 and halo == sum(r for r, _ in runs[start:stop])
        seg = [(steps[i][2] == "d", *runs[i]) for i in range(start, stop)]
        aligned = w % 16 == 0 and not force_bytes
        prefetch = prefetch and aligned
        dst = rng.integers(0, 256, src.shape, dtype=np.uint8)
        hx = -(-halo // 16) * 16
        rh, rw = th + 2 * halo, tw + 2 * hx
        S, r1 = rw + 2 * slack, seg[0][1]
        h_first, m = None, 0  # the H plane from the rows the first step with an H pass reaches
        for radius, _, _, reach in sizes[start:stop]:
            m += radius
            if h_first is None and reach >= 0:
                h_first = m - reach
        h_rows = 0 if h_first is None else rh - 2 * h_first
        rows = rh * (2 if prefetch else 1) + rh - 2 * r1 + h_rows
        assert S * rows == kernels.dense_morph_smem_bytes(th, tw, halo, r1, h_first, prefetch)
        tiles_x, tiles_y = -(-w // tw), -(-h // th)
        n_tiles = k * tiles_x * tiles_y
        grid = min(n_tiles, ctas)

        def tile_at(t):
            img, rest = divmod(t, tiles_x * tiles_y)
            ty, tx = divmod(rest, tiles_x)
            return img, ty * th, tx * tw

        def region(gy0, gx0):  # (rows, cols) inside the image, over the region's rh x rw cells
            ys, xs = gy0 + np.arange(rh), gx0 + np.arange(rw)
            return ((ys >= 0) & (ys < h))[:, None] & ((xs >= 0) & (xs < w))[None, :], ys, xs

        def load(smem, buf, t):
            img, gy, gx = tile_at(t)
            inside, ys, xs = region(gy - halo, gx - hx)
            view = np.lib.stride_tricks.as_strided(smem[buf:], (rh, rw), (S, 1))
            image = src[img][np.clip(ys, 0, h - 1)[:, None], np.clip(xs, 0, w - 1)[None, :]]
            if aligned:  # 16-byte chunks: whole chunks in or out (w % 16 == 0), zero filled outside
                view[...] = np.where(inside, image, 0)
            else:
                view[inside] = image[inside]

        for b in range(grid):
            smem = rng.integers(0, 256, S * rows, dtype=np.uint8)
            words = smem.view(np.uint32)
            ibuf = [slack, slack + (rh * S if prefetch else 0)]
            dbuf = slack + (2 if prefetch else 1) * rh * S - r1 * S
            hbuf = dbuf + r1 * S + (rh - 2 * r1) * S - (h_first or 0) * S
            par = 0
            if prefetch:
                load(smem, ibuf[0], b)
            for t in range(b, n_tiles, grid):
                img, gy, gx = tile_at(t)
                gy0, gx0 = gy - halo, gx - hx
                a = ibuf[par]
                if aligned and not prefetch:
                    load(smem, a, t)
                elif aligned and t + grid < n_tiles:
                    load(smem, ibuf[par ^ 1], t + grid)  # lands while this tile's steps run
                elif not aligned:
                    load(smem, a, t)
                rim = gy0 < 0 or gx0 < 0 or gy0 + rh > h or gx0 + rw > w
                inside, _, _ = region(gy0, gx0)
                d, m = dbuf, 0
                for is_max, radius, groups in seg:
                    if rim:  # the rows this step reads
                        view = np.lib.stride_tricks.as_strided(smem[a + m * S:], (rh - 2 * m, rw), (S, 1))
                        view[~inside[m: rh - m]] = 0 if is_max else 255
                    m += radius
                    c0, c1 = (hx - halo + m) >> 4, (rw - hx + halo - m + 15) >> 4
                    if square_side(groups):
                        roll_step(words, a, d, S, m, rh - m, 4 * c0, 4 * c1, square_side(groups), is_max)
                        a, d = d, a
                        continue
                    for gi, (dx0, dx1, dys) in enumerate(groups):
                        hsrc = a
                        if (dx0, dx1) != (0, 0):
                            hpass(words, a, hbuf, S, m + min(dys), rh - m + max(dys), c0, c1, dx0, dx1 - dx0 + 1,
                                  is_max)
                            hsrc = hbuf
                        vpass(words, hsrc, d, S, m, rh - m, c0, c1, dys, gi == 0, is_max)
                    a, d = d, a
                tile = np.lib.stride_tricks.as_strided(smem[a + halo * S + hx:], (th, tw), (S, 1))
                dst[img, gy: gy + th, gx: gx + tw] = tile[: max(0, h - gy), : max(0, w - gx)]
                if prefetch:
                    par ^= 1
        src = dst
    return src.reshape(x.shape)


def check_emulated(x: np.ndarray, steps, rng, jax_too: bool = False, **kw) -> None:
    want = morphology.morph_dense_plain(torch.from_numpy(x), steps).numpy()
    np.testing.assert_array_equal(emulate_k11(x, steps, rng, **kw), want, err_msg=f"{x.shape} {steps}")
    if jax_too:
        np.testing.assert_array_equal(jax_steps(x, steps), want, err_msg=f"JAX {x.shape} {steps}")


def jax_steps(x: np.ndarray, steps) -> np.ndarray:
    """The JAX package's ``_morph`` step by step (each step one call)."""
    for shape, ksize, op in steps:
        x = np.asarray(jmorph._morph(x, shape, ksize, 1, "d" if op == "d" else "e"))
    return x


# --- tests --------------------------------------------------------------------------


def test_kernel_constants_match_the_wrapper():
    assert cu_constant("kSlack") == kernels.DENSE_SLACK
    assert (cu_constant("kMaxSteps"), cu_constant("kMaxGroups"), cu_constant("kMaxDys")) == (
        kernels.DENSE_MAX_STEPS, kernels.DENSE_MAX_GROUPS, kernels.DENSE_MAX_DYS)
    assert kernels.DENSE_TILE[1] % 16 == 0


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 6, 7, 8, 9, 31])
@pytest.mark.parametrize("shape", SHAPES)
def test_element_runs_cover_the_element(shape, ksize):
    """Each row's runs are maximal and cover exactly its set cells, around
    the anchor ksize // 2 (even ksize too)."""
    se = morphology.structuring_element(shape, ksize)
    radius, runs = kernels.element_runs(shape, ksize)
    r = ksize // 2
    assert radius == r
    got = np.zeros_like(se)
    seen = set()
    for dx0, dx1, dys in runs:
        assert dx0 <= dx1 and list(dys) == sorted(set(dys)) and (dx0, dx1) not in seen
        seen.add((dx0, dx1))
        for dy in dys:
            assert -r <= dy <= ksize - 1 - r and -r <= dx0 and dx1 <= ksize - 1 - r
            row = got[dy + r]
            assert not row[dx0 + r: dx1 + r + 1].any(), "runs overlap"
            row[dx0 + r: dx1 + r + 1] = True
            # maximal: the cells beside the run are clear
            assert dx0 + r == 0 or not se[dy + r, dx0 + r - 1]
            assert dx1 + r == ksize - 1 or not se[dy + r, dx1 + r + 1]
    np.testing.assert_array_equal(got, se)


@pytest.mark.parametrize("shape", SHAPES)
def test_rolling_steps_take_no_h_plane(shape):
    """The emulation's rule for ``roll_step`` (rects of side 2 to 5) is the
    schedule's: those steps, and only those, reach no H plane."""
    for ksize in (1, 2, 3, 4, 5, 6, 7, 31):
        runs = kernels.element_runs(shape, ksize)[1]
        rolls = square_side(runs) > 0
        assert rolls == (shape == "rect" and 2 <= ksize <= 5)
        reach = kernels.dense_morph_sizes(((shape, ksize, "e"),))[0][3]
        assert (reach < 0) == (rolls or all((dx0, dx1) == (0, 0) for dx0, dx1, _ in runs))


@pytest.mark.parametrize("is_max", [False, True])
def test_op3_is_bytewise(is_max):
    rng = np.random.default_rng(4)
    a, b, c = (rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32) for _ in range(3))
    a[:16] = [0, 0xFFFFFFFF, 0x00FF00FF, 0xFF00FF00] * 4
    f = np.maximum if is_max else np.minimum
    want = f(f(a.view(np.uint8), b.view(np.uint8)), c.view(np.uint8)).view(np.uint32)
    np.testing.assert_array_equal(op3(a, b, c, is_max), want)
    np.testing.assert_array_equal(op2(a, b, is_max), f(a.view(np.uint8), b.view(np.uint8)).view(np.uint32))


# widths none of them multiples of 4 or 16; 1 x 1, 1 x W and H x 1 planes; k = 1 and 4 stacked layers
DIMS = ((1, 1), (1, 21), (13, 1), (23, 70), (4, 19, 37))
PROGRAMS = (("e", 1), ("d", 1), ("ed", 1), ("de", 2), ("ed", 3), ("d", 0))


@pytest.mark.parametrize("ksize", [1, 2, 3, 4, 5, 7, 31])
@pytest.mark.parametrize("shape", SHAPES)
def test_k11_emulated_matches_plain_and_jax(shape, ksize):
    rng = np.random.default_rng(100 * ksize + len(shape))
    n = 0
    for dims in DIMS:
        x = gray(rng, *dims)
        for src in (x, (x > 128).astype(np.uint8) * 255):
            for program, iterations in PROGRAMS:
                if ksize == 31 and iterations > 1:
                    continue  # one step of radius 15 a launch: two steps cover the long runs
                steps = morphology.morph_program(shape, ksize, iterations, program)
                check_emulated(src, steps, rng, jax_too=(program, iterations) == ("ed", 1) and len(dims) == 3)
                n += 1
    assert n >= 40


@pytest.mark.parametrize("steps", [
    morphology.morph_program("rect", 3, 1, "ed") + morphology.morph_program("rect", 3, 1, "de"),
    morphology.morph_program("ellipse", 5, 2, "ed"),
    (("cross", 4, "d"), ("rect", 2, "e"), ("ellipse", 3, "d")),
    morphology.morph_program("rect", 31, 1, "e"),
], ids=["swatch", "ellipse5x2", "mixed-even", "rect31"])
def test_k11_emulated_aligned_route_with_prefetch(steps, monkeypatch):
    """Widths that are multiples of 16: 16-byte chunks, zero fill, the next
    tile loaded before this one's steps; small tiles so that each CTA walks
    several, over a stack of planes, against the forced byte route too."""
    monkeypatch.setattr(kernels, "DENSE_TILE", (8, 16))
    monkeypatch.setattr(kernels, "DENSE_ROLL_TILE", (16, 32))
    kernels.dense_morph_schedule.cache_clear()
    try:
        rng = np.random.default_rng(9)
        for dims in ((4, 21, 48), (37, 64), (16, 16)):
            x = gray(rng, *dims)
            for ctas in (2, 3):
                check_emulated(x, steps, rng, ctas=ctas)
            check_emulated((x > 120).astype(np.uint8) * 255, steps, rng, force_bytes=True, ctas=5)
    finally:
        kernels.dense_morph_schedule.cache_clear()


def test_k11_emulated_over_segments(monkeypatch):
    """Lists cut by the halo cap, by the parameter block's room and by shared
    memory (a step alone on a smaller tile with one load buffer)."""
    rng = np.random.default_rng(12)
    x = gray(rng, 2, 29, 50)
    monkeypatch.setattr(kernels, "DENSE_HALO_CAP", 2)
    kernels.dense_morph_schedule.cache_clear()
    try:
        steps = morphology.morph_program("rect", 3, 2, "ed") + (("ellipse", 7, "d"),)
        assert len(kernels.dense_morph_schedule(kernels.dense_morph_sizes(steps))) == 3
        check_emulated(x, steps, rng)
        monkeypatch.setattr(kernels, "DENSE_HALO_CAP", 16)
        kernels.dense_morph_schedule.cache_clear()
        steps = morphology.morph_program("cross", 1, 20, "ed")  # 40 steps of radius 0: two launches by room
        segs = kernels.dense_morph_schedule(kernels.dense_morph_sizes(steps))
        assert [b - a for a, b, *_ in segs] == [kernels.DENSE_MAX_STEPS, 8]
        check_emulated(x, steps, rng)
        monkeypatch.setattr(kernels, "MAX_SMEM", 24 * 1024)
        kernels.dense_morph_schedule.cache_clear()
        steps = (("rect", 3, "e"), ("cross", 21, "d"), ("rect", 3, "d"))
        segs = kernels.dense_morph_schedule(kernels.dense_morph_sizes(steps))
        assert [s[:2] for s in segs] == [(0, 1), (1, 2), (2, 3)] and segs[1][2:4] != kernels.DENSE_TILE
        assert not segs[1][5]
        check_emulated(x, steps, rng)
    finally:
        kernels.dense_morph_schedule.cache_clear()
