"""Kernel K8's draw and seeding on the CPU: the plain versions
(``plotweave_torch/ops/kmeans.py``: ``subsample_indices_plain``,
``kpp_init_plain``) held to their contracts, and numpy emulations of the two
kernels' schedules (``csrc/kmeans.cu``: ``subsample_draw``, ``kpp_init``)
held to the plain versions exactly.

The draw: the ``limit`` pixels of least ``fmix32(i·a + b mod 2³²)`` (a
bijection of i, so the keys are distinct), in increasing index order.  The
emulation runs the kernel's CTAs (runs of whole tiles), its three radix
rounds (a histogram per CTA merged into one, then the digit every CTA finds
from the merged counts), which end on the limit-th least key K, the per-CTA
counts of keys up to K, each CTA's first output slot, and the compaction
tile by tile with one scan, into an output of garbage that every slot must
be written in exactly once.

The seeding: integer weights ``max(⌊d²·2¹⁶⌋, 1)``, the first row whose
running sum exceeds ``⌊total·u⌋``.  The emulation runs 16 CTAs of a cluster,
their tiles of rows, warp sums of the weights' low and high 18 bits into a
tile's two 32-bit sums, the CTAs' totals, the
offsets, the exact target from the float's bits, the one CTA that searches
(warp 0 over the tile totals, then one tile rescanned), on both routes (d² in
a CTA's own rows, or in one array over all rows), each starting from NaN.
"""

from __future__ import annotations

import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from plotweave_torch.ops import kernels
from plotweave_torch.ops import kmeans as tkm

CLUSTER = kernels.CLUSTER_SIZE
DIGITS = 2048
ROUNDS = ((21, 0x7FF), (10, 0x7FF), (0, 0x3FF))  # (shift, digit mask) of the radix select's rounds


# --- the draw -----------------------------------------------------------------------


def np_keys(seed: int, n: int) -> np.ndarray:
    """The draw's keys with numpy's wrapping uint32 arithmetic (the kernel's)."""
    a, b = tkm.draw_words(seed)
    h = np.arange(n, dtype=np.uint32) * np.uint32(a) + np.uint32(b)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def exclusive(v: np.ndarray) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(v)[:-1]]).astype(np.int64)


def draw_grid(n: int, max_grid: int, threads: int):
    """``pw_subsample``'s CTAs and their chunk: whole tiles a CTA."""
    tiles = -(-n // threads)
    grid = min(max_grid, threads, tiles)
    chunk = -(-tiles // grid) * threads
    return -(-n // chunk), chunk


def emulate_draw(seed: int, n: int, limit: int, max_grid: int, threads: int) -> np.ndarray:
    keys = np_keys(seed, n).astype(np.int64)
    grid, chunk = draw_grid(n, max_grid, threads)
    ranges = [(q * chunk, min(q * chunk + chunk, n)) for q in range(grid)]
    prefix, mask, need = 0, 0, limit
    for sh, digit in ROUNDS:
        merged = np.zeros(DIGITS, np.int64)
        for lo, hi in ranges:  # each CTA's shared histogram, merged by atomics (any order)
            k = keys[lo:hi]
            inside = k[(k & mask) == prefix]
            merged += np.bincount((inside >> sh) & digit, minlength=DIGITS)
        pairs = merged.reshape(-1, 2)  # two buckets a thread
        below = exclusive(pairs.sum(1))
        first = (below < need) & (need <= below + pairs[:, 0])
        second = (below + pairs[:, 0] < need) & (need <= below + pairs.sum(1))
        assert first.sum() + second.sum() == 1  # exactly one thread finds the digit
        t = int(np.flatnonzero(first | second)[0])
        found = (2 * t, int(below[t])) if first[t] else (2 * t + 1, int(below[t] + pairs[t, 0]))
        prefix |= found[0] << sh
        mask |= digit << sh
        need -= found[1]
    assert need == 1 and (keys == prefix).sum() == 1  # prefix is one key, the limit-th least
    counts = np.array([(keys[lo:hi] <= prefix).sum() for lo, hi in ranges])
    base = exclusive(counts)
    out = np.full(limit, -7, np.int64)  # garbage
    writes = np.zeros(limit, np.int64)
    for q, (lo, hi) in enumerate(ranges):
        run = base[q]
        for t0 in range(lo, hi, threads):
            i = np.arange(t0, t0 + threads)
            taken = ((i < hi) & (keys[np.minimum(i, n - 1)] <= prefix)).astype(np.int64)
            pos = run + exclusive(taken)
            out[pos[taken == 1]] = i[taken == 1]
            np.add.at(writes, pos[taken == 1], 1)
            run += int(taken.sum())
    assert (writes == 1).all()  # every slot written once
    return out


@pytest.mark.parametrize("n,limit", [(5000, 700), (1000, 1), (1000, 999), (701, 700), (2, 1), (100_000, 30_000)])
def test_draw_plain_takes_limit_distinct_increasing(n, limit):
    idx = tkm.subsample_indices(42, n, limit)
    assert idx.dtype == torch.int32 and idx.numel() == limit
    assert int(idx.min()) >= 0 and int(idx.max()) < n
    assert bool((idx[1:] > idx[:-1]).all())  # distinct, increasing
    assert torch.equal(idx, tkm.subsample_indices(42, n, limit))  # deterministic per seed
    assert len({tuple(tkm.subsample_indices(s, n, limit).tolist()) for s in range(8)}) > 1  # seeds differ


@pytest.mark.parametrize("seed,n,limit", [(7, 6000, 1234), (8, 4097, 4096), (2**40 + 9, 30_000, 17)])
def test_draw_plain_is_the_least_keys(seed, n, limit):
    """The plain draw against its definition, with numpy's uint32 hash: the
    ``limit`` least keys."""
    keys = np_keys(seed, n)
    np.testing.assert_array_equal(tkm.draw_keys(seed, n).numpy(), keys.astype(np.int64))
    order = np.argsort(keys, kind="stable")[:limit]
    np.testing.assert_array_equal(tkm.subsample_indices(seed, n, limit).numpy(), np.sort(order))


@pytest.mark.parametrize("seed", [0, 1, 42, 2**40 + 3, -5])
def test_draw_keys_are_a_bijection_per_seed(seed):
    a, b = tkm.draw_words(seed)
    assert a % 2 == 1 and 0 <= a < 2**32 and 0 <= b < 2**32
    assert len(np.unique(np_keys(seed, 200_000))) == 200_000


def test_draw_plain_roughly_uniform_over_seeds():
    n, limit, seeds = 1000, 100, 400
    hits = np.zeros(n)
    for seed in range(seeds):
        hits[tkm.subsample_indices(seed, n, limit).numpy()] += 1
    p = limit / n
    sigma = math.sqrt(seeds * p * (1 - p))
    assert np.abs(hits - seeds * p).max() <= 5 * sigma
    deciles = hits.reshape(10, -1).sum(1)  # each tenth of the index range gets a tenth of the draws
    assert np.abs(deciles - seeds * limit / 10).max() <= 5 * math.sqrt(seeds * limit / 10)


def test_draw_every_pixel_where_nothing_is_drawn():
    assert torch.equal(tkm.subsample_indices(3, 50, 50), torch.arange(50, dtype=torch.int32))
    assert torch.equal(tkm.subsample_indices(3, 50, 200_000), torch.arange(50, dtype=torch.int32))


def test_draw_dispatch_raises():
    with pytest.raises(ValueError):
        tkm.subsample_indices(1, 100, 10, "meta")
    with pytest.raises(ValueError):
        tkm.subsample_indices(1, 100, 0)
    with pytest.raises(ValueError):
        tkm.subsample_indices(1, 2**31, 10)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.subsample_cuda(tkm.draw_words(1), 100, 10, "cpu")


@pytest.mark.parametrize("n,limit,seed,max_grid,threads", [
    (5000, 700, 11, 3, 64),
    (5000, 4999, 12, 3, 64),  # the threshold is the greatest key but one
    (3000, 1, 11, 2, 64),
    (3000, 2999, 11, 5, 64),
    (3001, 1500, 13, 7, 32),
    (200_000, 20_000, 11, 132, 1024),
    (200_000, 199_999, 14, 132, 1024),
    (1025, 1024, 11, 264, 1024),
    (70_000, 3, 15, 9, 256),
    (2, 1, 11, 132, 1024),
])
def test_draw_emulated_schedule_equals_plain(n, limit, seed, max_grid, threads):
    got = emulate_draw(seed, n, limit, max_grid, threads)
    np.testing.assert_array_equal(got, tkm.subsample_indices_plain(seed, n, limit).numpy())


@pytest.mark.parametrize("limit", [1, 40, 98, 99, 500])
def test_subsample_lab_is_the_labs_of_the_drawn_pixels(limit):
    rng = np.random.default_rng(limit)
    img = torch.from_numpy(rng.integers(0, 256, (9, 11, 3), dtype=np.uint8))
    want = tkm.lab_sample(img, tkm.subsample_indices(5, 99, limit)) if limit < 99 else tkm.lab_sample(img)
    assert torch.equal(tkm.subsample_lab(img, 5, limit), want)
    assert tkm.subsample_lab(img, 5, limit).shape == (min(limit, 99), 3)


@pytest.mark.parametrize("idx", [[-1], [99], [0, 5, 99], [2**40]])
def test_lab_sample_refuses_indices_outside_the_image(idx):
    img = torch.zeros((9, 11, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="outside"):
        tkm.lab_sample(img, torch.tensor(idx, dtype=torch.int64))


# --- the seeding --------------------------------------------------------------------


def kernel_target(total: int, u: np.float32) -> int:
    """``kpp_target`` of csrc/kmeans.cu on the float's bits, in 64-bit words."""
    bits = int(np.float32(u).view(np.uint32))
    if bits >= 0x80000000 or bits == 0:
        return 0
    if bits >= 0x3F800000:
        return total
    e8, f23 = bits >> 23, bits & 0x7FFFFF
    m = (f23 | 0x800000) if e8 else f23
    q = 150 - e8 if e8 else 149
    hi, lo = total >> 24, total & 0xFFFFFF
    assert hi * m < 2**64 and lo * m < 2**64
    v = hi * m + ((lo * m) >> 24)
    assert v < 2**64
    return 0 if q - 24 >= 64 else v >> (q - 24)


def np_weights(d2: np.ndarray) -> np.ndarray:
    scaled = np.minimum(d2 * np.float32(1 << kernels.KPP_SCALE_BITS), np.float32(kernels.KPP_WEIGHT_CAP))
    return np.maximum(scaled.astype(np.int64), 1)


def emulate_kpp(sample: np.ndarray, k: int, first: int, uniforms: np.ndarray, route: str, threads: int) -> list:
    n = sample.shape[0]
    rows, tiles = -(-n // CLUSTER), -(-(-(-n // CLUSTER)) // threads)
    los = [min(r * rows, n) for r in range(CLUSTER)]
    lens = [min(lo + rows, n) - lo for lo in los]
    d2_global = np.full(n, np.nan, np.float32)
    d2_own = [np.full(rows, np.nan, np.float32) for _ in range(CLUSTER)]
    idx = first
    picks = [idx]
    for j in range(1, k):
        c = sample[idx]
        tile_lo = np.zeros((CLUSTER, tiles), np.int64)  # a tile's sums of its weights' low and high 18 bits
        tile_hi = np.zeros((CLUSTER, tiles), np.int64)
        for r in range(CLUSTER):
            d2 = d2_own[r] if route == "resident" else d2_global[los[r]: los[r] + lens[r]]
            for t in range(tiles):
                rr = t * threads + np.arange(threads)
                rr = rr[rr < lens[r]]
                e = sample[los[r] + rr] - c
                d = (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]
                if j > 1:
                    d = np.minimum(d2[rr], d)
                d2[rr] = d
                w = np_weights(d)
                for wp in range(0, len(w), 32):  # a warp's two sums, added to the tile's (any order)
                    tile_lo[r, t] += (w[wp: wp + 32] & 0x3FFFF).sum()
                    tile_hi[r, t] += (w[wp: wp + 32] >> 18).sum()
        assert tile_lo.max() < 2**32 and tile_hi.max() < 2**32  # the kernel's 32-bit shared-memory atomics
        tile_tot = (tile_hi << 18) + tile_lo
        totals = tile_tot.sum(1)
        total = int(totals.sum())
        target = kernel_target(total, uniforms[j - 1])
        assert target == math.floor(Fraction(float(min(max(float(uniforms[j - 1]), 0.0), 1.0))) * total)
        if target >= total:
            r = (n - 1) // rows
            local = lens[r] - 1
        else:
            offs = exclusive(totals)
            r = int(np.flatnonzero((offs <= target) & (target < offs + totals))[0])
            res = target - int(offs[r])
            per = -(-tiles // 32)  # warp 0: a run of tiles a lane
            own = np.array([tile_tot[r, min(la * per, tiles): min(la * per + per, tiles)].sum() for la in range(32)])
            incl = np.cumsum(own)
            la = int(np.flatnonzero(incl > res)[0])
            rest, t = res - int(incl[la] - own[la]), min(la * per, tiles)
            while rest >= tile_tot[r, t]:
                rest -= int(tile_tot[r, t])
                t += 1
            d2 = d2_own[r] if route == "resident" else d2_global[los[r]: los[r] + lens[r]]
            rr = t * threads + np.arange(threads)
            w = np.where(rr < lens[r], np_weights(d2[np.minimum(rr, lens[r] - 1)]), 0)
            before = exclusive(w)
            hit = np.flatnonzero((before <= rest) & (rest < before + w))
            assert len(hit) == 1
            local = int(rr[hit[0]])
        idx = los[r] + local
        picks.append(idx)
    return picks


def kpp_sample(n: int, seed: int = 21) -> np.ndarray:
    """Blobs in Lab's 8-bit range, rounded to quarters: duplicate rows, d² ties."""
    g = np.random.default_rng(seed)
    centres = np.array([(20, 120, 130), (80, 100, 120), (200, 128, 128), (240, 200, 180)], np.float32)
    x = centres[g.integers(0, 4, n)] + g.normal(0, 9.0, (n, 3))
    return (np.round(x * 4) / 4).astype(np.float32)


@pytest.mark.parametrize("route", kernels.KPP_ROUTES)
@pytest.mark.parametrize("n", [5, 200, 16 * 64, 16 * 3 * 64 + 7])  # below 16 CTAs, below a tile, one tile, ragged
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_kpp_emulated_schedule_equals_plain(k, n, route):
    sample = kpp_sample(n)
    first, uniforms = tkm.seed_stream(300 + n, 2, k, n)
    for a in range(2):
        got = emulate_kpp(sample, k, int(first[a]), uniforms[a].numpy(), route, threads=64)
        ref = tkm.kpp_init_plain(torch.from_numpy(sample), k, int(first[a]), uniforms[a])[1]
        assert got == ref.tolist(), (got, ref.tolist())


def test_kpp_emulated_at_the_kernels_tile():
    n = 20_000  # 1,250 rows a CTA: three tiles of KPP_THREADS, the last ragged
    assert kernels.kpp_schedule(n) == {"route": "resident", "rows": 1250, "tiles": 3}
    sample = kpp_sample(n, 22)
    first, uniforms = tkm.seed_stream(9, 2, 4, n)
    for a in range(2):
        ref = tkm.kpp_init_plain(torch.from_numpy(sample), 4, int(first[a]), uniforms[a])[1].tolist()
        for route in kernels.KPP_ROUTES:
            assert emulate_kpp(sample, 4, int(first[a]), uniforms[a].numpy(), route, kernels.KPP_THREADS) == ref


@pytest.mark.parametrize("u", [0.0, 1e-45, 2.0**-24, 0.5, 0.999999, float(np.nextafter(np.float32(1), np.float32(0))),
                               1.0])
def test_kpp_emulated_edges_of_u(u):
    n = 16 * 3 * 64 + 7
    sample = kpp_sample(n, 23)
    uniforms = np.full(3, u, np.float32)
    ref = tkm.kpp_init_plain(torch.from_numpy(sample), 4, 5, torch.from_numpy(uniforms))[1].tolist()
    for route in kernels.KPP_ROUTES:
        assert emulate_kpp(sample, 4, 5, uniforms, route, threads=64) == ref
    if u == 0.0:
        assert ref[1] == 0  # row 0's weight is at least 1, so R(0) > 0
    if u == 1.0:
        assert ref[1:] == [n - 1] * 3  # no running sum exceeds the total


@pytest.mark.parametrize("u", [1 / 32, 33 / 1024, 1 / 16, 0.5 + 1 / 1024, 1 - 1 / 2048])
def test_kpp_emulated_targets_on_tile_and_cta_edges(u):
    """Every weight 1 (one point, repeated): R(i) = i + 1, and with 2,048
    rows (128 a CTA, 64 tiles of 2, two tiles a lane of warp 0's search)
    these targets fall exactly on the end of a lane's run, of a tile inside
    one, or of a CTA's rows, where the search must step to the next one."""
    n = 2048
    sample = np.full((n, 3), 7.0, np.float32)
    uniforms = np.full(1, u, np.float32)
    ref = tkm.kpp_init_plain(torch.from_numpy(sample), 2, 3, torch.from_numpy(uniforms))[1].tolist()
    assert ref[1] == int(u * n)  # the first row whose running sum exceeds u n
    for route in kernels.KPP_ROUTES:
        assert emulate_kpp(sample, 2, 3, uniforms, route, threads=2) == ref


def test_kpp_target_is_exact():
    g = np.random.default_rng(5)
    totals = [0, 1, 2**24 - 1, 2**24, 2**24 + 1, 2**62 + 12345, 2**63 - 1] + [int(t) for t in g.integers(0, 2**63 - 1, 50)]
    us = [np.float32(x) for x in (0.0, 1e-45, 2.0**-126, 2.0**-24, 0.5, 0.999999, 1.0)]
    us += [np.float32(x) for x in g.random(50, dtype=np.float32)] + [np.uint32(b).view(np.float32) for b in
                                                                     g.integers(1, 0x3F800000, 50, dtype=np.uint32)]
    for total in totals:
        for u in us:
            assert kernel_target(total, u) == tkm.kpp_target(total, float(u)) == math.floor(Fraction(float(u)) * total)


def test_kpp_weights_round_down_and_saturate():
    d2 = torch.tensor([0.0, 1e-9, 2.0**-16, 1.5, 123.25, 3 * 255.0**2, 2.0**20, 1e30, float("inf")])
    w = tkm.kpp_weights(d2).tolist()
    assert w == [1, 1, 1, 98304, 8077312, 3 * 255**2 * 65536, 2**36, 2**36, 2**36]
    np.testing.assert_array_equal(np_weights(d2.numpy()), np.array(w))


def test_kpp_refuses_a_sample_whose_sums_could_overflow():
    big = torch.empty((kernels.KPP_MAX_N, 3), device="meta")
    with pytest.raises(ValueError, match="rows"):
        tkm.kpp_init(big, 2, torch.zeros(1, dtype=torch.int32), torch.zeros((1, 1)))
    assert kernels.KPP_MAX_N * kernels.KPP_WEIGHT_CAP <= 2**63


def test_kpp_schedule_routes():
    assert kernels.kpp_schedule(200_000)["route"] == "resident"  # the default subsample fits: read once
    assert kernels.kpp_schedule(231_696) == {"route": "resident", "rows": 14_481, "tiles": 29}  # the largest that fits
    assert kernels.kpp_schedule(231_697)["route"] == "streamed"
    assert kernels.kpp_schedule(250_000)["route"] == "streamed"
    assert kernels.kpp_schedule(kernels.KPP_MAX_N - 1)["route"] == "streamed"
    assert {kernels.kpp_schedule(n)["route"] for n in (1, 5, 2048, 231_696, 231_697, 10**6)} == set(kernels.KPP_ROUTES)


# --- the seeds and fits in one launch -------------------------------------------------


def tree(v: np.ndarray) -> np.ndarray:
    """The kernel's shuffle tree over the last axis (a power of two): lane l
    adds lane l + o for o = L/2, ..., 1; lane 0's value."""
    v = v.copy()
    o = v.shape[-1] // 2
    while o:
        v[..., :o] = v[..., :o] + v[..., o: 2 * o]
        o //= 2
    return v[..., 0]


def np_nearest(x: np.ndarray, cen: np.ndarray):
    """The nearest of the centres to each row by the expanded distance, each
    float32 operation in the kernel's order; the first minimum wins →
    (labels, minimal distances)."""
    f2 = np.float32(2.0)
    sq = (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + x[:, 2] * x[:, 2]
    best, best_d = np.zeros(len(x), np.int64), None
    for c in range(len(cen)):
        cc = (cen[c, 0] * cen[c, 0] + cen[c, 1] * cen[c, 1]) + cen[c, 2] * cen[c, 2]
        dot = (x[:, 0] * cen[c, 0] + x[:, 1] * cen[c, 1]) + x[:, 2] * cen[c, 2]
        d = (sq - f2 * dot) + cc
        if best_d is None:
            best_d = d
        else:
            better = d < best_d
            best, best_d = np.where(better, c, best), np.where(better, d, best_d)
    return best, best_d


class FitCta:
    """One CTA's shared memory as the fit sees it, every cell NaN until
    written: the rows' columns (resident; NaN past the CTA's len rows) or a
    stage of FIT_STAGE_TILES tiles (streamed; NaN past the staged rows before
    each copy), and the fit's scratch in the dead d² region (warps' partials,
    the double-buffered part, the totals)."""

    def __init__(self, sample: np.ndarray, lo: int, length: int, rows: int, threads: int, route: str):
        self.lo, self.len, self.rows, self.threads, self.route = lo, length, rows, threads, route
        self.tiles = -(-rows // threads)
        self.xs = np.full((3, rows), np.nan, np.float32)
        if route == "resident":  # the coalesced load: the CTA's 3 len floats in order
            flat = sample[lo: lo + length].reshape(-1)
            f = np.arange(3 * length)
            self.xs[f % 3, f // 3] = flat[f]
        self.sample = sample
        words = kernels.FIT_SCRATCH_BYTES // 4
        self.scratch = np.full(max(words, rows if route == "resident" else 0), np.nan)  # the dead d² column
        self.wpart, self.part, self.tot = 0, 32 * 16, 32 * 16 + 2 * 32

    def tile(self, t: int):
        """Tile t's rows, one a thread (NaN where r >= len), as scan_rows reads them."""
        r = t * self.threads + np.arange(self.threads)
        valid = r < self.len
        if self.route == "resident":
            x = self.xs[:, np.minimum(r, self.rows - 1)].T
        else:  # every FIT_STAGE_TILES-th tile, the next tiles' rows copied in order, one float a thread and step
            per = kernels.FIT_STAGE_TILES * self.threads
            if t % kernels.FIT_STAGE_TILES == 0:
                self.stage = np.full((3, per), np.nan, np.float32)
                cnt = 3 * max(min(per, self.len - t * self.threads), 0)
                flat = self.sample[self.lo + t * self.threads:].reshape(-1)
                f = np.arange(cnt)
                self.stage[f % 3, f // 3] = flat[f]
            rr = (t % kernels.FIT_STAGE_TILES) * self.threads + np.arange(self.threads)
            x = self.stage[:, rr].T
        return np.where(valid[:, None], x, np.float32(0)), valid


def cluster_sums(ctas, vals_per_cta, nf: int, buf: int, warps: int) -> np.ndarray:
    """The kernel's cluster_sums: each CTA's (threads, NV) values by a warp
    tree into its warps' partials, a tree over its warps into part[buf],
    then the 16 CTAs' parts by a tree over 16 lanes → the totals, written to
    and read back from every CTA's scratch."""
    nv = vals_per_cta[0].shape[1]
    for cta, v in zip(ctas, vals_per_cta):
        per_warp = tree(np.moveaxis(v.reshape(warps, 32, nv), 1, -1))  # (warps, nv)
        for j in range(nv):
            cta.scratch[cta.wpart + j * 16: cta.wpart + j * 16 + warps] = per_warp[:, j]
        for j in range(nv):
            w = cta.scratch[cta.wpart + j * 16: cta.wpart + j * 16 + warps]
            w = w.astype(np.float32) if j < nf else w.astype(np.int64)
            cta.scratch[cta.part + buf * 32 + j] = tree(w)
    for cta in ctas:  # every CTA reads the 16 parts
        for j in range(nv):
            p = np.array([c.scratch[c.part + buf * 32 + j] for c in ctas])
            cta.scratch[cta.tot + j] = tree(p.astype(np.float32) if j < nf else p.astype(np.int64))
    tot = ctas[0].scratch[ctas[0].tot: ctas[0].tot + nv]
    assert not np.isnan(tot).any()  # no cell was read before it was written
    assert all(np.array_equal(c.scratch[c.tot: c.tot + nv], tot) for c in ctas)
    return tot


def emulate_lloyd(sample: np.ndarray, seeds: np.ndarray, iters: int, route: str, threads: int, eps: float = 0.5):
    """The fit body of ``kmeans_fit`` / ``lloyd_fit`` for one attempt: 16
    CTAs over contiguous rows, each thread's rows in order, every sum in the
    kernel's order (a thread's sequential float32 adds, the warp tree, the
    CTA's 16-warp tree, the cluster's 16-CTA tree), the same new centres in
    every thread → (centres, compactness, iterations)."""
    n, k = len(sample), len(seeds)
    rows = -(-n // CLUSTER)
    warps = threads // 32
    ctas = [FitCta(sample, min(r * rows, n), min(r * rows + rows, n) - min(r * rows, n), rows, threads, route)
            for r in range(CLUSTER)]
    cen = seeds.astype(np.float32).copy()
    shift, it = np.float32(np.inf), 0
    while shift > eps and it < iters:
        vals = []
        for cta in ctas:
            s = np.zeros((threads, k, 3), np.float32)
            cnt = np.zeros((threads, k), np.int64)
            for t in range(cta.tiles):
                x, valid = cta.tile(t)
                lab, _ = np_nearest(x, cen)
                for c in range(k):
                    hit = valid & (lab == c)
                    s[hit, c] = s[hit, c] + x[hit]
                    cnt[hit, c] += 1
            v = np.concatenate([s.reshape(threads, 3 * k).astype(np.float64), cnt.astype(np.float64)], 1)
            vals.append(v)
        tot = cluster_sums(ctas, vals, 3 * k, it & 1, warps)
        sums, counts = tot[: 3 * k].astype(np.float32).reshape(k, 3), tot[3 * k:].astype(np.int64)
        new = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1).astype(np.float32)[:, None], cen)
        e = new - cen
        shift = np.sqrt((e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]).max()
        cen, it = new.astype(np.float32), it + 1
    comp = []
    for cta in ctas:
        acc = np.zeros(threads, np.float32)
        for t in range(cta.tiles):
            x, valid = cta.tile(t)
            _, d = np_nearest(x, cen)
            acc = np.where(valid, acc + d, acc)
        comp.append(acc.astype(np.float64)[:, None])
    total = cluster_sums(ctas, comp, 1, it & 1, warps)
    return cen, np.float32(total[0]), it


def emulate_kmeans_fit(sample: np.ndarray, k: int, first, uniforms, iters: int, route: str, threads: int):
    """``kmeans_fit``: each attempt's seeds as :func:`emulate_kpp` draws them,
    then :func:`emulate_lloyd` from them, and the first attempt of least
    compactness → (best, centres, compactness, iterations, picks)."""
    picks, fits = [], []
    for a in range(len(first)):
        p = emulate_kpp(sample, k, int(first[a]), np.asarray(uniforms[a]), route, threads)
        picks.append(p)
        fits.append(emulate_lloyd(sample, sample[p], iters, route, threads))
    comps = [f[1] for f in fits]
    best, best_comp = np.zeros((k, 3), np.float32), np.inf
    for f in fits:
        if f[1] < best_comp:
            best, best_comp = f[0], f[1]
    return best, np.stack([f[0] for f in fits]), np.array(comps), np.array([f[2] for f in fits]), np.array(picks)


PENS = np.array([[30, 128, 128], [60, 150, 100], [90, 110, 160], [120, 170, 170], [150, 90, 120],
                 [180, 140, 200], [210, 120, 90], [245, 128, 128]], np.float32)


def fit_sample(n: int, blobs: int, seed: int = 31) -> np.ndarray:
    """``blobs`` separable blobs of Lab-like rows, rounded to quarters (duplicate rows and distance ties)."""
    g = np.random.default_rng(seed)
    x = PENS[:blobs][g.integers(0, blobs, n)] + g.normal(0, 2.0, (n, 3))
    return (np.round(x * 4) / 4).astype(np.float32)


def check_fused(sample: np.ndarray, k: int, iters: int, route: str, threads: int, seed: int = 7):
    """The emulated launch against ``kmeans_fit_plain`` and against JAX's ``_lloyd`` from the same seeds."""
    import jax.numpy as jnp

    from plotweave.ops import kmeans as jkm

    first, uniforms = tkm.seed_stream(seed, 3, k, len(sample))
    got = emulate_kmeans_fit(sample, k, first, uniforms.numpy(), iters, route, threads)
    ref = tkm.kmeans_fit_plain(torch.from_numpy(sample), k, first, uniforms, iters)
    np.testing.assert_array_equal(got[4], ref[4].numpy())  # the picks
    np.testing.assert_allclose(got[1], ref[1].numpy(), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got[3], ref[3].numpy())  # iterations
    np.testing.assert_allclose(got[0], ref[0].numpy(), rtol=0, atol=1e-3)  # the same attempt won
    assert int(np.argmin(got[2])) == int(np.argmin(ref[2].numpy()))
    np.testing.assert_allclose(got[2], ref[2].numpy(), rtol=1e-3, atol=0)
    for a in range(3):
        centers, _ = jkm._lloyd(jnp.asarray(sample), jnp.asarray(sample[got[4][a]]), iters)
        np.testing.assert_allclose(got[1][a], np.asarray(centers), rtol=0, atol=1e-3)
    return got


@pytest.mark.parametrize("route", kernels.KPP_ROUTES)
@pytest.mark.parametrize("n", [5, 200, 16 * 3 * 64 + 7])  # below 16 CTAs, below a tile, ragged tiles
@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_fused_emulated_schedule_equals_plain_and_jax(k, n, route):
    check_fused(fit_sample(n, max(k, 1), seed=n + k), k, 40, route, threads=64)


@pytest.mark.parametrize("route", kernels.KPP_ROUTES)
@pytest.mark.parametrize("iters", [0, 1])
def test_fused_emulated_few_iterations(iters, route):
    sample = fit_sample(3 * 1024 + 5, 4, seed=3)
    got = check_fused(sample, 4, iters, route, threads=64)
    if iters == 0:  # Lloyd from zero iterations returns the seeds
        np.testing.assert_array_equal(got[1], sample[got[4]])


def test_fused_emulated_at_the_kernels_tile():
    n = 20_000  # 1,250 rows a CTA: three tiles of KPP_THREADS, the last ragged; 16 warps a CTA
    assert kernels.kpp_schedule(n) == {"route": "resident", "rows": 1250, "tiles": 3}
    for route in kernels.KPP_ROUTES:
        check_fused(fit_sample(n, 4, seed=5), 4, 40, route, threads=kernels.KPP_THREADS)


@pytest.mark.parametrize("route", kernels.KPP_ROUTES)
def test_fused_emulated_empty_clusters_keep_their_seeds(route):
    """Four distinct rows repeated and k = 8: the last four seeds repeat
    earlier ones, which win their rows (first minimum), so their clusters
    stay empty and keep their centres."""
    sample = np.repeat(PENS[[0, 2, 5, 7]], 300, axis=0)
    got = check_fused(sample, 8, 40, route, threads=64)
    np.testing.assert_array_equal(got[1][:, 4:], sample[got[4][:, 4:]])
    assert (got[3] == 1).all()


def test_fit_scratch_fits_the_dead_d2_column():
    assert kernels.FIT_SCRATCH_BYTES == 4 * (32 * 16 + 3 * 32 + 5 * 8)  # warps' partials, part[2], totals, centres
    assert kernels.FIT_SCRATCH_BYTES + kernels.KPP_STATIC_SMEM < kernels.MAX_SMEM
    # at the resident limit the d² column (4 bytes a row) is far larger than the scratch: the limit is unchanged
    rows = kernels.kpp_schedule(231_696)["rows"]
    assert 4 * rows > kernels.FIT_SCRATCH_BYTES
    assert kernels.kpp_schedule(1) == {"route": "resident", "rows": 1, "tiles": 1}


def test_fit_outputs_are_one_allocation():
    best, centers, comp, picks, its, done, best_idx, d2 = kernels._fit_outputs(3, 4, 10, "cpu")
    assert [t.numel() for t in (best, centers, comp, picks, its, done, best_idx, d2)] == [12, 36, 3, 12, 3, 1, 1, 10]
    assert [t.dtype for t in (picks, its, done, best_idx)] == [torch.int32] * 4
    assert {t.untyped_storage().data_ptr() for t in (best, centers, comp, picks, its, done, best_idx, d2)} == {
        best.untyped_storage().data_ptr()}


@pytest.mark.parametrize("k", [1, 3, 8])
def test_seed_draws_pack_first_and_uniforms(k):
    first, uniforms = tkm.seed_stream(11, 4, k, 1000)
    draws = tkm.seed_draws(first, uniforms)
    assert draws.shape == (4, k) and draws.dtype == torch.float32 and draws.is_contiguous()
    assert torch.equal(draws.view(torch.int32)[:, 0], first)
    assert torch.equal(draws[:, 1:], uniforms)


def test_kmeans_fits_on_the_cpu_is_the_plain_fit():
    sample = torch.from_numpy(fit_sample(3000, 4))
    first, uniforms = tkm.seed_stream(5, 3, 4, 3000)
    got = tkm.kmeans_fits(sample, 4, first, uniforms, 40)
    ref = tkm.kmeans_fit_plain(sample, 4, first, uniforms, 40)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    out = torch.full((12,), -1.0)
    assert torch.equal(tkm.kmeans_fits(sample, 4, first, uniforms, 40, out=out)[0], ref[0])
    assert torch.equal(out.view(4, 3), ref[0])
    assert torch.equal(tkm.kmeans_fit_device(sample, 4, 3, 40, 5), ref[0])
    seeds = tkm.kpp_init(sample, 4, first, uniforms)
    assert torch.equal(seeds[1], ref[4]) and torch.equal(tkm.lloyd_fits_plain(sample, seeds[0], 40)[1], ref[1])


def test_kmeans_fit_cuda_refuses_what_it_does_not_take():
    pts = torch.zeros((10, 3))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.kmeans_fit_cuda(pts, torch.zeros((1, 2)), 3)
    meta = torch.empty((10, 3), device="meta")
    with pytest.raises(ValueError):
        tkm.kmeans_fits(meta, 2, torch.zeros(1, dtype=torch.int32), torch.zeros((1, 1)), 3)
    with pytest.raises(ValueError, match="outside"):
        tkm.kmeans_fits(pts, 2, torch.tensor([10], dtype=torch.int32), torch.zeros((1, 1)), 3)
    with pytest.raises(ValueError, match="rows"):
        tkm.kmeans_fits(torch.empty((kernels.KPP_MAX_N, 3), device="meta"), 2, torch.zeros(1, dtype=torch.int32),
                        torch.zeros((1, 1)), 3)


@pytest.mark.parametrize("k", [2, 4])
def test_fused_emulated_streamed_over_several_stages(k):
    """1,101 rows a CTA in tiles of 64: 18 tiles, staged 8, 8 and 2 at a time, the last ragged."""
    sample = fit_sample(16 * 1101 - 5, 4, seed=17)
    assert -(-(-(-len(sample) // CLUSTER)) // 64) == 18
    check_fused(sample, k, 40, "streamed", threads=64)
