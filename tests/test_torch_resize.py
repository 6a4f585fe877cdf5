"""The port's INTER_AREA resize (``plotweave_torch/ops/resize.py``, the plain
versions of kernel K13) on the CPU, byte for byte against the JAX package's
``area_resize`` and against ``cv2.resize(..., INTER_AREA)`` on the same
seeded numpy images: the cases of ``tests/test_ops_raster.py`` (integer,
fractional, fractional fuzz, over 16 taps, the 4K scale, gray) and more
channel counts; the tap tables against the JAX package's and what the
fractional kernel reads off them; the no-op; the fractional kernel's
schedule (``kernels.area_frac_schedule``) on ``chip_smoke.py``'s cases and
the fuzz shapes, and its CTAs emulated in numpy float32 (the staged rows,
the horizontal sums once a source row, the events of the pair route, the
ring of an upscale, the stores) against the plain version and JAX.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from plotweave.ops import resize as jresize
from plotweave_torch import ops as port_ops
from plotweave_torch.ops import kernels, resize


def _image(seed: int, h: int, w: int, c: int | None = 3) -> np.ndarray:
    shape = (h, w) if c is None else (h, w, c)
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _check(img: np.ndarray, nw: int, nh: int, cv: bool = True) -> np.ndarray:
    """The port's area_resize on a CPU tensor == the JAX package's (== cv2's)."""
    got = resize.area_resize(torch.from_numpy(img), nw, nh)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize.area_resize(img, nw, nh)))
    if cv:
        ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)  # (h, w) for one channel
        np.testing.assert_array_equal(got, ref.reshape(got.shape))
    return got


def _smoke():
    """``chip_smoke.py`` (standard library only at import): its K13 cases."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


INTEGER = [(100, 100, 2, 2), (120, 90, 3, 3), (64, 64, 4, 4), (90, 60, 3, 2), (40, 96, 2, 6), (75, 75, 5, 5),
           (48, 48, 6, 6), (7, 9, 7, 9)]


@pytest.mark.parametrize("h,w,sy,sx", INTEGER)
def test_integer_ratio_matches_jax_and_cv2(h, w, sy, sx):
    _check(_image(h * w + sy, h, w), w // sx, h // sy)


@pytest.mark.parametrize("area", [(3, 3), (6, 6), (2, 3)])
def test_integer_ratio_every_block_sum(area):
    """Every block sum 0..255·area once: the float32 quotient (the JAX
    package's ``float64`` is float32 without x64) and its half-even rounding
    at every tie, against the JAX package and cv2."""
    sy, sx = area
    n = 255 * sy * sx + 1
    blocks = np.zeros((n, sy * sx), np.int64)
    for i in range(n):  # spread sum i over the block's pixels
        q, r = divmod(i, sy * sx)
        blocks[i] = q + (np.arange(sy * sx) < r)
    side = int(np.ceil(np.sqrt(n)))
    pad = np.zeros((side * side, sy * sx), np.int64)
    pad[:n] = blocks
    img = pad.reshape(side, side, sy, sx).transpose(0, 2, 1, 3).reshape(side * sy, side * sx).astype(np.uint8)
    got = _check(img, side, side)
    want = np.array([(i + 2) >> 2 if (sy, sx) == (2, 2) else np.float32(i) / np.float32(sy * sx)
                     for i in range(n)])
    np.testing.assert_array_equal(got.reshape(-1)[:n], np.clip(np.rint(want), 0, 255).astype(np.uint8))


FRACTIONAL = [(333, 517, 166, 258), (97, 311, 31, 99), (640, 480, 512, 384), (100, 100, 99, 99), (50, 61, 50, 30),
              (61, 50, 30, 50)]


@pytest.mark.parametrize("h,w,nh,nw", FRACTIONAL)
def test_fractional_ratio_matches_jax_and_cv2(h, w, nh, nw):
    _check(_image(h + w, h, w), nw, nh)


def _fuzz_cases():
    r = np.random.default_rng(17)
    out = []
    for _ in range(25):
        h, w = int(r.integers(40, 500)), int(r.integers(40, 500))
        out.append((h, w, int(r.integers(8, h)), int(r.integers(8, w))))
    return out


@pytest.mark.parametrize("h,w,nh,nw", _fuzz_cases())
def test_fractional_fuzz_matches_jax_and_cv2(h, w, nh, nw):
    _check(_image(h * 7 + w, h, w), nw, nh)


@pytest.mark.parametrize("h,w,nh,nw", [(1813, 397, 89, 97), (997, 211, 23, 11), (800, 600, 9, 7)])
def test_over_16_taps_matches_jax_and_cv2(h, w, nh, nw):
    """Ratios whose tables exceed the JAX package's 16-tap chunks: its cut
    groups keep the global add order, and so does the port's one pass."""
    assert max(resize._resize_area_tab(h, nh)[0].shape[1], resize._resize_area_tab(w, nw)[0].shape[1]) > 16
    _check(_image(h, h, w), nw, nh)


def test_4k_scale_matches_jax_and_cv2():
    _check(_image(4, 540, 960), 500, 281)


@pytest.mark.parametrize("h,w,nh,nw", [(80, 120, 40, 60), (80, 120, 33, 47), (37, 1000, 3, 100)])
def test_gray_matches_jax_and_cv2(h, w, nh, nw):
    got = _check(_image(h, h, w, None), nw, nh)
    assert got.shape == (nh, nw)


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("ratio", ["integer", "fractional"])
def test_channel_counts_match_jax(c, ratio):
    img = _image(c, 60, 90, c)
    nw, nh = (45, 30) if ratio == "integer" else (41, 29)
    _check(img, nw, nh, cv=c != 2)  # cv2 takes 1, 3 and 4 channels


@pytest.mark.parametrize("ssize,dsize", [(517, 258), (311, 99), (4032, 2000), (3024, 1500), (8000, 97), (6000, 73),
                                         (480, 384), (100, 99), (1000, 3)])
def test_tap_tables_equal_jax(ssize, dsize):
    si, al = resize._resize_area_tab(ssize, dsize)
    jsi, jal = jresize._resize_area_tab(ssize, dsize)
    assert si.dtype == jsi.dtype == np.int32 and al.dtype == jal.dtype == np.float32
    np.testing.assert_array_equal(si, jsi)
    np.testing.assert_array_equal(al.view(np.uint32), jal.view(np.uint32))


GARBAGE = 0xA5  # bytes the kernel must not read, or must not leave in its output


def _area_frac_kernel(img: np.ndarray, nw: int, nh: int, src_base: int = 0, dst_base: int = 0,
                      sched: dict | None = None) -> np.ndarray:
    """K13's fractional launch (``csrc/area_resize.cu``, ``area_frac_bands``)
    CTA by CTA, in numpy float32, on :func:`kernels.area_frac_schedule`: the
    image's bytes at address ``src_base`` of a memory of garbage and the
    output at ``dst_base`` of another; each CTA's band rows and tile columns
    from the tables' real taps (alpha > 0), the band's source rows walked
    upwards in groups, each row staged from the 16-byte boundary below the
    tile's first source byte (vectors inside the tensor whole, the ends byte
    by byte, garbage elsewhere); per (source row, column) the horizontal
    sums once over the taps in order: ``kh`` taps every column, alpha 0 past
    its real ones and whatever bytes are staged there, the first tap setting
    the sum (the word route), or the real taps from an exact 0; each into the
    open band rows that take the row (on the pair route from the band's
    events, at most two a source row, the lower open row's sums from an
    exact 0 in the first slot, the row that starts where it ends in the
    second, which takes its place once it closes; else the rows found open
    at the row, a ring of ``slots``, the first tap setting the sum); a closed
    row rounded into a
    staged output row at its destination's alignment; rows of no tap 0; the
    band stored by whole vectors of its own bytes and byte by byte at the
    ends.  Every output byte must be written exactly once."""
    x = img if img.ndim == 3 else img[:, :, None]
    h, w, c = x.shape
    sch = sched or kernels.area_frac_schedule(h, w, nh, nw, c)
    br, tile, group, pitch, slots = sch["band_rows"], sch["tile"], sch["group"], sch["pitch"], sch["slots"]
    events, kh = sch["events"], sch["kh"]
    assert events or not kh  # the ring's route reads byte by byte
    xsi, xal = resize._resize_area_tab(w, nw)
    ysi, yal = resize._resize_area_tab(h, nh)
    assert sch["taps"] == (xsi.shape[1], ysi.shape[1])
    xf, xl = kernels.area_spans(xsi, xal)
    yf, yl = kernels.area_spans(ysi, yal)
    n_src, n_dst = h * w * c, nh * nw * c
    mem = np.full(src_base + n_src + 64, GARBAGE, np.uint8)
    mem[src_base:src_base + n_src] = x.reshape(-1)
    out = np.full(dst_base + n_dst + 64, GARBAGE, np.uint8)
    writes = np.zeros(n_dst, np.int64)
    out_pitch = -(-(tile * c + 15) // 16) * 16
    for band in range(sch["bands"]):
        oy0 = band * br
        rows = min(br, nh - oy0)
        f, l = yf[oy0:oy0 + rows], yl[oy0:oy0 + rows]
        lo, hi = (int(f[f >= 0].min()), int(l.max())) if (f >= 0).any() else (0, -1)
        for t in range(sch["tiles"]):
            ox0 = t * tile
            cols = min(tile, nw - ox0)
            fx, lx = xf[ox0:ox0 + cols], xl[ox0:ox0 + cols]
            nx = np.where(fx >= 0, lx - fx + 1, 0)
            assert (nx <= xsi.shape[1]).all()
            some = fx >= 0
            sx_lo = int(fx[some].min()) if some.any() else 0
            span = (int(lx.max()) - sx_lo + 1) * c if some.any() else 0
            off = (np.where(some, fx, sx_lo) - sx_lo) * c
            assert not kh or (nx <= kh).all()
            out_s = np.full((br, out_pitch), GARBAGE, np.uint8)
            for r in range(rows):
                if f[r] < 0:
                    out_s[r] = 0
            acc = np.full((slots, c, cols), np.nan, np.float32)
            pair = [np.zeros((c, cols), np.float32), np.zeros((c, cols), np.float32)]
            ra, rb = 0, -1

            def close(r, sums, oy0=oy0, ox0=ox0, cols=cols, out_s=out_s):
                mis_o = (dst_base + ((oy0 + r) * nw + ox0) * c) % 16
                vals = np.clip(np.rint(sums), 0, 255).astype(np.uint8)  # (c, cols)
                out_s[r, mis_o:mis_o + cols * c] = vals.T.reshape(-1)

            if events:  # the pair route's events: two slots a source row, the row that starts where the last ends 2nd
                assert (f >= 0).all() and hi - lo + 1 <= events
                ev = [[None, None] for _ in range(hi - lo + 1)]
                for r in range(rows):
                    second = r > 0 and l[r - 1] == f[r]
                    for sy in range(f[r], l[r] + 1):
                        k = 1 if second and sy == f[r] else 0
                        assert ev[sy - lo][k] is None, "two rows in one event slot"
                        ev[sy - lo][k] = r
            n_groups = (hi - lo + group) // group if lo <= hi else 0
            for k in range(n_groups):
                r0 = lo + k * group
                r1 = min(r0 + group, hi + 1)
                buf = np.full((group, pitch + 32), GARBAGE, np.uint8)  # a word path reads past its taps
                for j, sy in enumerate(range(r0, r1)):  # the vectors with 16 v < mis + span
                    first = src_base + (sy * w + sx_lo) * c
                    cover = first - first % 16
                    vecs = -(-(first % 16 + span) // 16) if span else 0
                    assert 16 * vecs <= pitch
                    lo_b, hi_b = max(cover, src_base), min(cover + 16 * vecs, src_base + n_src)
                    buf[j, lo_b - cover:hi_b - cover] = mem[lo_b:hi_b]
                # the group's horizontal sums, (row, channel, column), tap by tap in order: with kh, kh taps
                # every column, alpha 0 past its real taps (the bytes there whatever is staged), the first tap
                # setting the sum; else each column's real taps from an exact 0
                mis = (src_base + (np.arange(r0, r1) * w + sx_lo) * c) % 16
                hsum = np.zeros((r1 - r0, c, cols), np.float32)
                for tap in range(kh or (int(nx.max()) if cols else 0)):
                    live = tap < nx
                    al = np.where(live, xal[ox0:ox0 + cols, min(tap, xal.shape[1] - 1)], 0).astype(np.float32)
                    at = mis[:, None, None] + (off + tap * c)[None, None, :] + np.arange(c)[None, :, None]
                    b = np.take_along_axis(buf[:r1 - r0], at.reshape(r1 - r0, -1), axis=1).reshape(at.shape)
                    prod = b.astype(np.float32) * al
                    if kh:
                        hsum = prod if tap == 0 else hsum + prod
                    else:  # the byte route: a column's own real taps only
                        hsum = np.where(live, hsum + prod, hsum)
                for sy in range(r0, r1):
                    hs = hsum[sy - r0]
                    if events:  # cur, the lower open row, takes slot 0; next, the row starting where it ends, slot 1
                        slot_rows = ev[sy - lo]
                        for k, r in enumerate(slot_rows):
                            a = np.float32(0) if r is None else yal[oy0 + r, sy - f[r]]
                            assert r is None or (a > 0 and ysi[oy0 + r, sy - f[r]] == sy)
                            pair[k] = pair[k] + hs * a  # from an exact 0: 0 + p is p; no row: + 0
                        if slot_rows[0] is not None and sy == l[slot_rows[0]]:
                            close(slot_rows[0], pair[0])
                            pair = [pair[1], np.zeros_like(pair[1])]
                            if slot_rows[1] is not None and sy == l[slot_rows[1]]:
                                close(slot_rows[1], pair[0])
                                pair[0] = np.zeros_like(pair[0])
                        continue
                    while rb + 1 < rows and f[rb + 1] <= sy:
                        rb += 1
                    while ra <= rb and l[ra] < sy:
                        ra += 1
                    for r in [r for r in range(ra, rb + 1) if f[r] <= sy <= l[r]]:
                        assert yal[oy0 + r, sy - f[r]] > 0 and ysi[oy0 + r, sy - f[r]] == sy
                        p = hs * yal[oy0 + r, sy - f[r]]
                        acc[r % slots] = p if sy == f[r] else acc[r % slots] + p
                        if sy == l[r]:
                            close(r, acc[r % slots])
            for r in range(rows):
                d = dst_base + ((oy0 + r) * nw + ox0) * c
                mis_o, n = d % 16, cols * c
                for v in range(out_pitch // 16):
                    b0, b1 = max(16 * v, mis_o), min(16 * v + 16, mis_o + n)
                    if b0 < b1:
                        out[d - mis_o + b0:d - mis_o + b1] = out_s[r, b0:b1]
                        writes[d - mis_o + b0 - dst_base:d - mis_o + b1 - dst_base] += 1
    assert (writes == 1).all(), "every output byte written exactly once"
    assert (out[:dst_base] == GARBAGE).all() and (out[dst_base + n_dst:] == GARBAGE).all()
    got = out[dst_base:dst_base + n_dst].reshape(nh, nw, c)
    return got if img.ndim == 3 else got[:, :, 0]


@pytest.mark.parametrize("h,w,nh,nw", [(333, 517, 166, 258), (403, 302, 200, 150), (1813, 397, 89, 97)])
def test_kernel_order_of_operations_matches_plain(h, w, nh, nw):
    """The kernel's order (each horizontal sum once per source row, from an
    exact 0, then into each output row in its tap order, padded taps
    skipped) gives the plain version's bytes: every term is ≥ 0, so 0 + the
    first product is that product and a padded tap's +0 changes nothing."""
    img = _image(nw, h, w)
    np.testing.assert_array_equal(_area_frac_kernel(img, nw, nh), _check(img, nw, nh))


def _emulation_cases():
    cases = [(h, w, nh, nw, 3) for h, w, nh, nw in FRACTIONAL]
    cases += [(h, w, nh, nw, 3) for h, w, nh, nw in _fuzz_cases()[::3]]
    cases += [(1813, 397, 89, 97, 3), (997, 211, 23, 11, 1), (800, 600, 9, 7, 4)]  # over 16 taps
    cases += [(80, 120, 33, 47, None), (37, 1000, 3, 100, None)]  # gray
    cases += [(60, 90, 29, 41, c) for c in (1, 2, 4)]
    cases += [(37, 517, 1, 258, 3), (517, 37, 258, 1, 3), (29, 31, 1, 1, 4), (5, 7, 3, 1, 2)]  # outputs of 1 px
    cases += [(101, 1033, 67, 517, 1), (77, 4111, 40, 2049, 3)]  # widths not a multiple of 16, several tiles
    cases += [(h, w, nh, nw, c) for (h, w, c), (nw, nh), _ in _smoke().RING_CASES]  # the ring route
    return cases


@pytest.mark.parametrize("h,w,nh,nw,c", _emulation_cases())
def test_emulated_schedule_matches_plain_and_jax(h, w, nh, nw, c):
    """The CTAs of the schedule, emulated with garbage everywhere the kernel
    must not read, byte-equal to the plain version and the JAX package (and
    cv2 where it takes the channel count), at source and output addresses off
    a 16-byte boundary."""
    img = _image(h * 3 + w + (c or 0), h, w, c)
    want = _check(img, nw, nh, cv=c != 2 and nh <= h and nw <= w)  # cv2's INTER_AREA is bilinear up
    np.testing.assert_array_equal(_area_frac_kernel(img, nw, nh), want)
    np.testing.assert_array_equal(_area_frac_kernel(img, nw, nh, src_base=5, dst_base=11), want)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_emulated_schedule_on_narrowed_tiles(c):
    """A ratio over 16 taps at a small tile and group (the schedule a wide
    span takes), and an upscale's ring of open rows, through the emulation."""
    img = _image(c, 300, 450, c)
    sched = dict(kernels.area_frac_schedule(300, 450, 9, 11, c), tile=4, group=2, tiles=3)
    sched["pitch"] = -(-(4 * (-(-450 // 11) + 2) * c + 15) // 16) * 16
    assert max(resize._resize_area_tab(300, 9)[0].shape[1], resize._resize_area_tab(450, 11)[0].shape[1]) > 16
    np.testing.assert_array_equal(_area_frac_kernel(img, 11, 9, 3, 7, sched), _check(img, 11, 9, cv=False))
    small = _image(c + 1, 4, 5, c)
    sched = kernels.area_frac_schedule(4, 5, 37, 23, c)
    assert sched["slots"] > 2
    np.testing.assert_array_equal(_area_frac_kernel(small, 23, 37), _check(small, 23, 37, cv=False))


def _schedule_shapes():
    smoke = _smoke()
    out = [(tuple(shape) + (1,))[:3] + (nh, nw) for shape, (nw, nh), _ in
           smoke.RESIZE_CASES + smoke.FRAC_CASES + smoke.RING_CASES]
    out += [(h, w, 3, nh, nw) for h, w, nh, nw in _fuzz_cases()]
    return out


@pytest.mark.parametrize("ctas", [0, 1452])
@pytest.mark.parametrize("h,w,c,nh,nw", _schedule_shapes())
def test_area_frac_schedule_covers_the_output(h, w, c, nh, nw, ctas):
    """The schedule of the chip's cases and the fuzz shapes, with the CTAs
    the card holds unknown and known (11 a CTA on 132 SMs): the bands and
    tiles cover every output pixel once; fitted, the items fit the CTAs
    unless the bands are at their most rows; each tile's source span, from
    the 16-byte boundary below it, fits a staged row; the ring holds every
    output row open at one source row (counted by brute force); the pair
    route's events hold every band's source rows; the shared memory is the C
    function's formula and stays within 227 KB."""
    sch = kernels.area_frac_schedule(h, w, nh, nw, c, ctas)
    if ctas:
        assert sch["items"] <= ctas or sch["band_rows"] == min(kernels.AREA_MAX_BAND_ROWS, nh) or (
            sch["band_rows"] * -(-(sch["tile"] * c + 15) // 16) * 16 > 0xFFFF - 16 * 64)
        br = sch["band_rows"]  # no taller than the fit needs: a row less a band would not fit
        assert br == 1 or -(-nh // (br - 1)) * sch["tiles"] > ctas
    br, tile = sch["band_rows"], sch["tile"]
    assert sch["bands"] == -(-nh // br) and sch["tiles"] == -(-nw // tile) and sch["items"] == sch["bands"] * sch["tiles"]
    assert sch["threads"] == max(32, tile) <= kernels.AREA_MAX_TILE and tile & (tile - 1) == 0
    cover = np.zeros((nh, nw), np.int64)
    for band in range(sch["bands"]):
        for t in range(sch["tiles"]):
            cover[band * br:(band + 1) * br, t * tile:(t + 1) * tile] += 1
    assert (cover == 1).all()
    xf, xl = kernels.area_spans(*resize._resize_area_tab(w, nw))
    widest = int(np.where(xf >= 0, xl - xf + 1, 0).max())
    assert sch["kh"] == (widest if sch["events"] and widest <= 4 else 0)
    for t in range(sch["tiles"]):
        f, l = xf[t * tile:(t + 1) * tile], xl[t * tile:(t + 1) * tile]
        if (f >= 0).any():
            assert 15 + (l.max() - f[f >= 0].min() + 1) * c <= sch["pitch"]
    yf, yl = kernels.area_spans(*resize._resize_area_tab(h, nh))
    for band in range(sch["bands"]):
        f, l = yf[band * br:(band + 1) * br], yl[band * br:(band + 1) * br]
        for sy in range(max(0, f[f >= 0].min()), l.max() + 1):
            live = np.flatnonzero((f <= sy) & (sy <= l))
            if len(live):
                assert live[-1] - live[0] + 1 <= sch["slots"]
    assert sch["smem"] == kernels.area_frac_smem(br, tile, sch["group"], sch["pitch"], sch["slots"], sch["events"], c)
    if sch["events"]:  # the pair route: a tap in every row, a row's first source row at most the last one's last
        assert (yf >= 0).all() and (yl[:-1] <= yf[1:]).all() and sch["slots"] == 2
        assert kernels._open_rows(yf, yl, h) <= 2 and (xf >= 0).all() and (np.diff(xl) >= 0).all()
        assert max(yl[min(b + br, nh) - 1] - yf[b] + 1 for b in range(0, nh, br)) == sch["events"]
    assert sch["smem"] <= kernels.AREA_SMEM_CAP or sch["group"] == 1
    assert sch["smem"] <= kernels.MAX_SMEM


@pytest.mark.parametrize("ctas", [0, 1452])
@pytest.mark.parametrize("case", range(len(_smoke().RING_CASES)))
def test_ring_cases_take_the_ring_route(case, ctas):
    """``chip_smoke.py``'s RING_CASES (an upscale, and a downscale whose bands
    walk more source rows than the events hold) are scheduled on the ring
    route (``events`` 0), with the CTAs the card holds unknown and known, so
    that the card runs that route."""
    (h, w, c), (nw, nh), _ = _smoke().RING_CASES[case]
    assert kernels.area_frac_schedule(h, w, nh, nw, c, ctas)["events"] == 0


@pytest.mark.parametrize("h,w,c,nh,nw", [(3024, 4032, 3, 1500, 2000), (300, 200, 3, 389, 517), (4111, 300, 1, 2, 7)])
def test_area_frac_plan_makes_the_tables_and_schedule_together(h, w, c, nh, nw):
    """The wrapper's one owner of a launch (``kernels._area_frac_plan``): the
    schedule fitted to the CTAs the card reports, and on its device the very
    tap tables that schedule was made from."""
    class Card:  # pw_area_frac_ctas of a card that holds 528 CTAs of any schedule
        def pw_area_frac_ctas(self, *args):
            return 528

    sched, tables = kernels._area_frac_plan(Card(), torch.device("cpu"), h, w, nh, nw, c)
    assert sched == dict(kernels.area_frac_schedule(h, w, nh, nw, c, 528), ctas=528)
    want = resize._resize_area_tab(w, nw) + resize._resize_area_tab(h, nh)
    assert len(tables) == 4 and sched["taps"] == (want[0].shape[1], want[2].shape[1])
    for got, table in zip(tables, want):
        np.testing.assert_array_equal(got.numpy(), table)


@pytest.mark.parametrize("ssize,dsize", [(4032, 2000), (3024, 1500), (8000, 97), (6000, 73), (517, 258), (2017, 1001),
                                         (3001, 611), (1031, 517), (4, 2858), (99, 100), (3, 7), (1000, 1)])
def test_tap_table_real_taps_are_a_run_of_increasing_rows(ssize, dsize):
    """What the kernel reads off a table: a row's real taps (alpha > 0) are a
    prefix of the row on consecutive, so strictly increasing, source indices,
    its padding index 0 and alpha 0; the rows' first and last real taps never
    fall from one row to the next; a downscale has a tap in every row and
    holds at most two rows open at once (the kernel's registers)."""
    si, al = resize._resize_area_tab(ssize, dsize)
    n = (al > 0).sum(axis=1)
    for d in range(dsize):
        assert (al[d, :n[d]] > 0).all() and (al[d, n[d]:] == 0).all() and (si[d, n[d]:] == 0).all()
        assert (np.diff(si[d, :n[d]]) == 1).all()
    first, last = kernels.area_spans(si, al)
    assert (np.diff(first[first >= 0]) >= 0).all() and (np.diff(last[first >= 0]) >= 0).all()
    if ssize >= dsize:
        assert (n > 0).all() and kernels._open_rows(first, last, ssize) <= 2


def test_no_op_returns_its_input():
    t = torch.from_numpy(_image(1, 30, 40))
    assert resize.area_resize(t, 40, 30) is t
    img = _image(2, 30, 40)
    same, changed = resize.resize_if_needed(img, 40)
    assert same is img and changed is False
    same, changed = resize.resize_if_needed(t, 100)
    assert same is t and changed is False
    jsame, jchanged = jresize.resize_if_needed(img, 40)
    assert jsame is img and jchanged is False


@pytest.mark.parametrize("shape,cap", [((300, 200, 3), 150), ((200, 300, 3), 100), ((400, 300), 151),
                                       ((3024, 4032, 3), 2000)])
def test_resize_if_needed_matches_jax(shape, cap):
    img = np.random.default_rng(cap).integers(0, 256, shape).astype(np.uint8)
    got, changed = resize.resize_if_needed(torch.from_numpy(img), cap)
    ref, jchanged = jresize.resize_if_needed(img, cap)
    assert changed is jchanged is True
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert max(got.shape[:2]) <= cap


def test_ndarray_input_goes_to_the_card_or_raises(monkeypatch):
    """An ndarray is uploaded to the card ("auto"): without one, an error, not
    a CPU fallback; a tensor stays on its device."""
    img = _image(3, 50, 70)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resize.area_resize(img, 35, 25)
    with pytest.raises(RuntimeError, match="CUDA"):
        resize.resize_if_needed(img, 35)
    got, changed = resize.resize_if_needed(torch.from_numpy(img), 35)
    assert changed and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.area_resize(img, 35, 25)))


def test_ops_exports_the_resize():
    assert port_ops.area_resize is resize.area_resize
    assert port_ops.resize_if_needed is resize.resize_if_needed


def test_wrappers_take_only_cuda_tensors():
    """On the CPU the plain versions run only because the tensor lies there:
    K13's wrappers refuse a CPU tensor instead of falling back."""
    img = torch.from_numpy(_image(5, 20, 30))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.area_resize_frac_cuda(img, 17, 17)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.area_resize_int_cuda(img, 2, 2)
    assert kernels.LAUNCHES["area_resize_frac"] == kernels.LAUNCHES["area_resize_int"] == 0
