"""Kernel K8's draw, sampler and seeding on the CPU: the plain versions
(``plotweave_torch/ops/kmeans.py``: ``subsample_indices_plain``,
``lab_sample``, ``kpp_init_plain``) held to their contracts, and numpy
emulations of the kernels' schedules (``csrc/kmeans.cu``:
``subsample_draw``, ``lab_sample``, ``kpp_init``) held to the plain versions
exactly; the sampler's gamma table and the 32-byte sectors of its bound.

The draw: the ``limit`` pixels of least ``fmix32(i·a + b mod 2³²)`` (a
bijection of i, so the keys are distinct), in increasing index order.  The
emulation runs the kernel's three passes and two barriers: the CTAs in
clusters (each a run of pixels), each CTA's histogram of the top digit, the
cluster's merge (each rank a slice of the bins, the ranks' exclusive
prefixes kept by the rank that merged a bin, a row of bins and coarse sums a
cluster, in scratch of garbage); the bucket B from the coarse sums and then
the fine counts of one coarse bucket (read beside the coarse sums for the
bucket where limit / n falls, again where that guess is wrong), each CTA's first slot in the candidate
list, the candidates written in a seeded order (every slot once); the
selection of the limit-th least key K over the list, from shared memory or
in place by the list's size, by the second digit's histogram and then each
sub-bucket key's rank by counting, the tallies of each CTA's candidates up to K, each CTA's output
base; the compaction in rounds of runs of up to 16 pixels a thread, staged and
stored in order, into an output of garbage that every slot must be written in exactly once.

The seeding: integer weights ``max(⌊d²·2¹⁶⌋, 1)``, the first row whose
running sum exceeds ``⌊total·u⌋``.  The emulation runs 16 CTAs of a cluster,
their tiles of rows, warp sums of the weights' low and high 18 bits into a
tile's two 32-bit sums, the CTAs' totals, the
offsets, the exact target from the float's bits, the one CTA that searches
(warp 0 over the tile totals, then one tile rescanned), on both routes (d² in
a CTA's own rows, or in one array over all rows), each starting from NaN.
"""

from __future__ import annotations

import importlib.util
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from plotweave_torch.ops import kernels
from plotweave_torch.ops import kmeans as tkm
from plotweave_torch.ops.colorspace import _div, _srgb_gamma_inv, bgr_to_lab_u8

CLUSTER = kernels.CLUSTER_SIZE
DIGITS, COARSE = kernels.DRAW_DIGITS, kernels.DRAW_COARSE
FINE = DIGITS // COARSE
RUN = 16  # the compaction's pixels a thread and round (``kRun``)


def smoke():
    """``chip_smoke.py`` (standard library only at import), for its bounds."""
    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


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


def draw_grid(n: int, max_clusters: int, threads: int, cluster: int = kernels.DRAW_CLUSTER):
    """``pw_subsample``'s CTAs and their chunk: as many clusters as the card
    holds (``max_clusters``) but no more than the pixels fill, nor than
    ``DRAW_MAX_CLUSTERS``; a chunk a multiple of 32 pixels."""
    clusters = min(-(-n // (cluster * threads)), max_clusters, kernels.DRAW_MAX_CLUSTERS)
    grid = clusters * cluster
    return grid, -(-(-(-n // grid)) // 32) * 32


def find_bin(counts: np.ndarray, need: int, per: int) -> tuple:
    """``warp_find_bin`` / ``block_find_bin``: the threads' sums of ``per``
    bins each, their exclusive scan, the one thread whose range reaches
    ``need``, then its bin → (bin, count below it)."""
    sums = counts.reshape(-1, per).sum(1)
    run = exclusive(sums)
    hit = np.flatnonzero((run < need) & (need <= run + sums))
    assert len(hit) == 1  # exactly one thread finds it
    t = int(hit[0])
    within = exclusive(counts[t * per: (t + 1) * per]) + run[t]
    j = int(np.flatnonzero((within < need) & (need <= within + counts[t * per: (t + 1) * per]))[0])
    return t * per + j, int(within[j])


def emulate_draw(seed: int, n: int, limit: int, max_clusters: int, threads: int, cap: int,
                 cluster: int = kernels.DRAW_CLUSTER):
    """The kernel's schedule → (output, whether the selection read the list
    from shared memory)."""
    rng = np.random.default_rng(seed)
    keys = np_keys(seed, n).astype(np.int64)
    grid, chunk = draw_grid(n, max_clusters, threads, cluster)
    assert grid <= threads  # thread q stands for CTA q in the output bases
    clusters, own = grid // cluster, DIGITS // cluster
    ranges = [(min(q * chunk, n), min(q * chunk + chunk, n)) for q in range(grid)]
    # pass 1: each CTA's histogram of the top digit; the cluster's merge, each rank its slice of bins
    hists = [np.bincount(keys[lo:hi] >> 21, minlength=DIGITS) for lo, hi in ranges]
    rows = rng.integers(0, 2**32, (kernels.DRAW_MAX_CLUSTERS, DIGITS + COARSE))  # scratch: garbage
    prefix = [np.full(DIGITS, -1, np.int64) for _ in range(grid)]  # held by the rank that merged the bin
    for c in range(clusters):
        for r in range(cluster):
            j = np.arange(r * own, (r + 1) * own)
            v = np.stack([hists[c * cluster + rr][j] for rr in range(cluster)])  # (ranks, bins)
            prefix[c * cluster + r][:] = np.concatenate(exclusive_rows(v))
            rows[c, j] = v.sum(0)
            rows[c, DIGITS + j[::FINE] // FINE] = v.sum(0).reshape(-1, FINE).sum(1)  # a warp's bins, one coarse bin
    # barrier 1; every CTA: the coarse bin, the bin, the rank inside it, its first slot in the list
    guess = int(limit / n * COARSE)  # the fine counts read beside the coarse rows
    early = rows[:clusters, guess * FINE: (guess + 1) * FINE].copy()
    cbin, below = find_bin(rows[:clusters, DIGITS:].sum(0), limit, COARSE // 32)
    need = limit - below
    fine = early if cbin == guess else rows[:clusters, cbin * FINE: (cbin + 1) * FINE]
    fbin, below = find_bin(fine.sum(0), need, FINE // 32)
    bucket, need = cbin * FINE + fbin, need - below
    m = int(fine[:, fbin].sum())
    assert m == int(((keys >> 21) == bucket).sum()) <= min(n, kernels.DRAW_MAX_BUCKET)
    cap_list = min(n, kernels.DRAW_MAX_BUCKET)
    lst = rng.integers(0, 2**31, cap_list)  # garbage
    written = np.zeros(cap_list, np.int64)
    belows = rng.integers(0, 2**31, threads)  # garbage past the grid
    for q, (lo, hi) in enumerate(ranges):
        c, r = divmod(q, cluster)
        owner = c * cluster + bucket // own
        first = int(fine[:c, fbin].sum()) + int(prefix[owner][r * own + bucket % own])
        k = keys[lo:hi]
        belows[q] = int(((k >> 21) < bucket).sum())
        mine = np.flatnonzero((k >> 21) == bucket)
        slots = first + rng.permutation(len(mine))  # a shared atomic's order
        lst[slots] = (k[mine] & 0x1FFFFF) << 10 | q
        np.add.at(written, slots, 1)
    assert (written[:m] == 1).all() and (written[m:] == 0).all()  # every slot of the list written once
    # barrier 2; every CTA: K among the candidates, its tallies, its output base
    shared = m <= cap
    cand = lst[:m].copy() if shared else lst  # the copy in shared memory, or the list in place
    words = cand[:m]
    b2, below = find_bin(np.bincount((words >> 20) & 0x7FF, minlength=DIGITS), need, DIGITS // threads
                         if threads < DIGITS else 1)
    need -= below
    d2 = (words >> 20) & 0x7FF
    tally = np.bincount(words[d2 < b2] & 0x3FF, minlength=1024)
    sub = rng.permutation(words[d2 == b2])
    assert len(sub) <= 1024
    low = (sub >> 10) & 0x3FF
    rank = (low[None, :] < low[:, None]).sum(1)  # each key's rank among the sub-bucket's, by counting
    assert sorted(rank.tolist()) == list(range(len(sub)))  # distinct keys
    b3 = int(low[rank + 1 == need][0])
    tally += np.bincount(sub[rank < need] & 0x3FF, minlength=1024)
    key = bucket << 21 | b2 << 10 | b3
    assert (keys <= key).sum() == limit and (keys == key).sum() == 1  # K is the limit-th least key
    counts = np.where(np.arange(threads) < grid, belows + tally[:threads], 0)
    assert (counts[:grid] == [(keys[lo:hi] <= key).sum() for lo, hi in ranges]).all()
    bases = exclusive(counts)
    # pass 3: rounds of up to 16 x threads pixels, a run of up to 16 a thread, one scan a round, the round's
    # indices staged (in shared memory) and then stored in order
    out = np.full(limit, -7, np.int64)  # garbage
    writes = np.zeros(limit, np.int64)
    for q, (lo, hi) in enumerate(ranges):
        base = int(bases[q])
        for r0 in range(lo, hi, RUN * threads):
            length = min(hi - r0, RUN * threads)
            per = -(-length // threads)
            assert per <= RUN
            i = np.arange(r0, r0 + length)
            taken = keys[i] <= key
            thread = (i - r0) // per
            pops = np.bincount(thread[taken], minlength=threads)
            start = base + exclusive(pops)
            rank_in_run = np.cumsum(taken) - 1 - exclusive(np.bincount(thread, weights=taken, minlength=threads)
                                                           .astype(np.int64))[thread]
            pos = start[thread] + rank_in_run
            stage = np.full(length, -9, np.int64)  # garbage past the round's indices
            stage[pos[taken] - base] = i[taken]
            out[base: base + int(taken.sum())] = stage[: int(taken.sum())]
            np.add.at(writes, np.arange(base, base + int(taken.sum())), 1)
            base += int(taken.sum())
    assert (writes == 1).all()  # every slot written once
    return out, shared


def exclusive_rows(v: np.ndarray) -> list:
    """The ranks' exclusive prefix of each bin, rank-major (``prefix[r·own + j]``)."""
    return list(np.cumsum(v, axis=0) - v)


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


@pytest.mark.parametrize("n,limit,seed,max_clusters,threads,cap,shared", [
    (5000, 700, 11, 3, 64, 16384, True),
    (5000, 4999, 12, 3, 64, 16384, True),  # the threshold is the greatest key but one
    (3000, 1, 11, 2, 64, 16384, True),
    (3000, 2999, 11, 5, 64, 16384, True),
    (3001, 1500, 13, 4, 32, 0, False),  # every list read in place
    (200_000, 20_000, 11, 30, 1024, kernels.DRAW_LIST_CAP, True),
    (200_000, 199_999, 14, 30, 1024, kernels.DRAW_LIST_CAP, True),
    (300_000, 20_000, 16, 14, 1024, 100, False),  # the large-list route: about 146 candidates, a cap of 100
    (300_000, 299_999, 17, 30, 1024, 146, False),
    (1025, 1024, 11, 33, 1024, kernels.DRAW_LIST_CAP, True),
    (70_000, 3, 15, 8, 64, kernels.DRAW_LIST_CAP, True),
    (70_000, 69_000, 18, 8, 128, 30, False),
    (2, 1, 11, 30, 1024, kernels.DRAW_LIST_CAP, True),
    (9, 8, 19, 1, 32, 1, True),  # one CTA's worth of pixels
    (100_000, 50_000, 20, 12, 1024, kernels.DRAW_LIST_CAP, True),  # K below the coarse bin where limit / n falls
])
def test_draw_emulated_schedule_equals_plain(n, limit, seed, max_clusters, threads, cap, shared):
    got, took_shared = emulate_draw(seed, n, limit, max_clusters, threads, cap)
    assert took_shared == shared
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


# --- the sampler --------------------------------------------------------------------

SAMPLE_GARBAGE = np.float32(np.nan)


def emulate_lab_sample(image: torch.Tensor, idx: torch.Tensor | None, grid: int, src_base: int = 0,
                       idx_base: int = 0) -> torch.Tensor:
    """K8's sampler (``csrc/kmeans.cu``, ``lab_sample``) CTA by CTA: the
    image's bytes at address ``src_base`` of a memory of garbage, the indices
    at ``idx_base``; ``grid`` CTAs striding over chunks of
    :data:`kernels.SAMPLE_CHUNK` pixels; a loader's
    :data:`kernels.SAMPLE_PER_THREAD` consecutive pixels, their indices one
    int4 where the indices are 16-byte aligned and the loader's pixels lie in
    the chunk, else one by one (-1 past the chunk, read as pixel 0); each
    pixel's bytes from the aligned words that hold bytes 3i and 3i + 2 by a
    funnel shift where both words lie inside the image's bytes, else byte by
    byte (no word read outside the image), or with no indices the chunk's bytes from its 16-byte cover
    (vectors inside the image whole, the ends byte by byte, garbage
    elsewhere); each pixel's 3 floats staged at 3 p, the chunk stored as
    whole 16-byte vectors and then its tail float by float, into an
    output of garbage that every float must be written in exactly once.  The
    floats carried through the stage are the pixels' three bytes, and the Lab
    of the stored (n, 3) bytes is taken at the end in one call, as
    ``lab_sample`` takes it: torch's CPU ``pow`` gives other bits in its
    vector loop than in its scalar tail, so the plain Lab of a pixel depends
    on where it stands in a tensor (the kernel's table takes the card's one
    ``powf`` a byte, ``test_gamma_table_is_every_bytes_gamma``)."""
    per, chunk = kernels.SAMPLE_PER_THREAD, kernels.SAMPLE_CHUNK
    threads = chunk // per  # the loaders
    flat = image.reshape(-1).numpy()
    px = flat.size // 3
    mem = np.full(src_base + flat.size + 8, 0xA5, np.uint8)
    mem[src_base:src_base + flat.size] = flat
    words = np.frombuffer(mem[: mem.size // 4 * 4].tobytes(), np.uint32)
    n = px if idx is None else idx.numel()
    ix_all = None if idx is None else idx.to(torch.int64).numpy()
    out = np.full(3 * n, SAMPLE_GARBAGE, np.float32)
    writes = np.zeros(3 * n, np.int64)
    n_chunks = -(-n // chunk)
    for cta in range(grid):
        for c in range(cta, n_chunks, grid):
            p0 = c * chunk
            m = min(chunk, n - p0)
            q = per * np.arange(threads)[:, None] + np.arange(per)[None, :]  # (thread, pixel)
            inside = q < m
            if idx is not None:
                vector = (idx_base % 16 == 0) & (per * np.arange(threads) + per <= m)
                ix = np.where(inside, ix_all[np.minimum(p0 + q, n - 1)], -1)
                assert (ix[vector[:, None] & np.ones(per, bool)] >= 0).all()
                addr = src_base + 3 * np.maximum(ix, 0)
                w0, w1 = addr // 4, (addr + 2) // 4
                word = (4 * w0 >= src_base) & (4 * w1 + 4 <= src_base + flat.size)  # else byte by byte
                lo, hi = np.where(word, words[w0], 0), np.where(word, words[w1], 0)
                shifted = ((hi.astype(np.uint64) << 32 | lo.astype(np.uint64)) >> (8 * (addr % 4)).astype(np.uint64))
                by_bytes = (mem[addr].astype(np.uint32) | mem[addr + 1].astype(np.uint32) << 8
                            | mem[addr + 2].astype(np.uint32) << 16)
                vals = np.where(word, shifted.astype(np.uint32), by_bytes)
            else:
                first = src_base + 3 * p0
                cover = first - first % 16
                vecs = -(-(first % 16 + 3 * m) // 16)
                assert vecs <= 3 * chunk // 16 + 2
                staged = np.full(16 * vecs, 0xA5, np.uint8)
                lo_b, hi_b = max(cover, src_base), min(cover + 16 * vecs, src_base + flat.size)
                staged[lo_b - cover:hi_b - cover] = mem[lo_b:hi_b]
                at = first % 16 + 3 * np.where(inside, q, 0)
                vals = (staged[at].astype(np.uint32) | staged[at + 1].astype(np.uint32) << 8
                        | staged[at + 2].astype(np.uint32) << 16)
            bgr = np.stack([vals & 255, (vals >> 8) & 255, (vals >> 16) & 255], -1).astype(np.float32)
            staged_out = bgr.reshape(-1)  # pixel p's 3 floats at 3 p
            vecs = 3 * m // 4
            out[3 * p0:3 * p0 + 4 * vecs] = staged_out[:4 * vecs]
            out[3 * p0 + 4 * vecs:3 * p0 + 3 * m] = staged_out[4 * vecs:3 * m]
            writes[3 * p0:3 * p0 + 3 * m] += 1
    assert (writes == 1).all(), "every output float written exactly once"
    return bgr_to_lab_u8(torch.from_numpy(out.reshape(n, 3).astype(np.uint8)))


def sample_image(seed: int, shape) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (*shape, 3), dtype=np.uint8))


@pytest.mark.parametrize("n_px,n,grid,src_base,idx_base", [
    (3000, 1024, 2, 0, 0),      # two whole chunks
    (3000, 1500, 2, 1, 0),      # a ragged last chunk, a CTA taking two chunks
    (3000, 100, 4, 2, 0),       # below one chunk
    (3000, 515, 1, 3, 4),       # indices off a 16-byte boundary: one by one
    (5, 5, 1, 0, 0),            # every pixel drawn, pixel 0 and the image's last bytes
    (7, 7, 1, 1, 0),            # the first and last pixel byte by byte: the image starts and ends off a word
    (7, 7, 1, 2, 0),
    (70_000, 20_000, 3, 13, 0),
])
def test_sampler_emulation_with_indices_equals_lab_sample(n_px, n, grid, src_base, idx_base):
    img = sample_image(n_px, (n_px,))
    idx = torch.from_numpy(np.sort(np.random.default_rng(n).choice(n_px, n, replace=False)).astype(np.int32))
    idx[-1] = n_px - 1  # the image's last pixel: byte by byte where its second word would end past the image
    want = tkm.lab_sample(img, idx)
    got = emulate_lab_sample(img, idx, grid, src_base, idx_base)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("shape,grid,src_base", [((9, 11), 1, 0), ((512,), 1, 7), ((513,), 2, 15), ((40, 77), 3, 9),
                                                 ((1, 1), 1, 3), ((2048,), 5, 1)])
def test_sampler_emulation_every_pixel_equals_lab_sample(shape, grid, src_base):
    img = sample_image(len(shape) + shape[0], shape)
    want = tkm.lab_sample(img)
    got = emulate_lab_sample(img, None, grid, src_base)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("order", ["bytes", "reversed", "random", "image"])
def test_gamma_table_is_every_bytes_gamma(order):
    """The sampler's 256-entry table, gamma_inv(b / 255) of the 256 bytes in
    one pass, holds the bits that the plain conversion computes for each
    byte over an image of them in any order (a whole number of the CPU's
    vectors: its scalar tail takes another ``pow``), and each entry is within
    one float32 step of the float64 power of its float32 base (the
    exponent 2.4 as float32 rounds it)."""
    table = _srgb_gamma_inv(_div(torch.arange(256, dtype=torch.float32), 255.0))
    b = torch.arange(256, dtype=torch.int64)
    b = {"bytes": b, "reversed": b.flip(0), "random": torch.from_numpy(np.random.default_rng(3).permutation(256)),
         "image": torch.from_numpy(np.random.default_rng(4).integers(0, 256, 4096))}[order]
    direct = _srgb_gamma_inv(_div(b.to(torch.float32), 255.0))
    assert torch.equal(table[b].view(torch.int32), direct.view(torch.int32))
    assert table[0] == 0 and table[255] == 1 and bool((table[1:] > table[:-1]).all())
    u = np.arange(256, dtype=np.float32) / np.float32(255.0)
    base = ((u + np.float32(0.055)) / np.float32(1.055)).astype(np.float64)
    exact = np.where(u <= np.float32(0.04045), (u / np.float32(12.92)).astype(np.float64),
                     base ** np.float64(np.float32(2.4)))
    step = np.spacing(np.float32(exact)).astype(np.float64)
    assert (np.abs(table.numpy().astype(np.float64) - exact) <= step).all()


@pytest.mark.parametrize("n_px,n,offset", [(1000, 1, 0), (1000, 1000, 0), (3000, 200, 7), (100_000, 7_000, 31),
                                           (300_000, 20_000, 16), (64, 11, 30)])
def test_sample_sectors_count_the_32_byte_sectors_touched(n_px, n, offset):
    """The sampler's bound counts each 32-byte sector that bytes 3i to 3i + 2
    of a drawn pixel touch once: the fast count against a brute force over
    the bytes."""
    idx = torch.from_numpy(np.random.default_rng(n_px + n).choice(n_px, n, replace=False).astype(np.int32))
    brute = {(offset + 3 * int(i) + b) // 32 for i in idx.tolist() for b in range(3)}
    assert smoke().gather_sectors(idx, offset) == len(brute)


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
