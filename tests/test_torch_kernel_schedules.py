"""The schedules of kernels K2 (a morphology step list in bands) and K12
(dense Zhang–Suen in tiles, several iterations per launch), emulated in plain
PyTorch on the CPU, against the plain versions and the JAX package.

The kernels run only on the card, where ``chip_smoke.py`` holds them against
their plain versions.  What these tests pin is the part that makes them
exact: the band and tile geometry, the halos, the rows each step or subpass
may compute, the segment split and the host's launch loop, all taken from
``ops/kernels.py``.  Rows that a step does not compute hold garbage here, so
a schedule that read one would fail.  Every op is integer: the tolerance is
0.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import morphology as jmorph
from plotweave.ops import thinning as jthin
from plotweave_torch.ops import kernels, morphology, thinning
from plotweave_torch.ops.frontend import frontend_steps
from plotweave_torch.ops.thinning import bitboards_from_jax, bitboards_to_jax

MAIN_PATH_STEPS = morphology.morph_program("ellipse", 3, 1, "ed") + morphology.morph_program("ellipse", 3, 1, "de")


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations run many small tensor ops; beside other test workers,
    PyTorch's thread pool makes them tens of times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def random_words(rng, shape) -> torch.Tensor:
    """int32 boards of uniformly random bits, padding bits beyond W included."""
    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32))


def radii_of(steps) -> tuple:
    return tuple(-kernels.element_rows(shape, ksize)[0] for shape, ksize, _ in steps)


# ---------------------------------------------------------------------------
# K2: bands of rows, the step list's halo, segments
# ---------------------------------------------------------------------------


def emulate_k2(x: torch.Tensor, valid: torch.Tensor, steps, schedule, rng) -> torch.Tensor:
    """csrc/morph_bits.cu's blocks, one (layer, band) at a time: load the band
    and its halo (0 outside the layer), run each step of a segment between
    two buffers over the rows it gets right (the rest hold garbage), store
    the band's own rows."""
    k, h, nw = x.shape
    radii = radii_of(steps)
    for start, stop, band, radius in schedule:
        out = torch.empty_like(x)
        rows = band + 2 * radius
        for layer in range(k):
            for b in range(-(-h // band)):
                g0 = b * band - radius
                g = torch.arange(g0, g0 + rows)
                inside = (g >= 0) & (g < h)
                bufs = [random_words(rng, (rows, nw)), random_words(rng, (rows, nw))]
                bufs[0][~inside] = 0
                bufs[0][inside] = x[layer, g[inside]]
                src, done = 0, 0
                for (shape, ksize, op), r in zip(steps[start:stop], radii[start:stop]):
                    done += r
                    lo, hi = max(done, -g0), min(rows - done, h - g0)
                    cur = bufs[src]
                    operand = cur if op == "d" else (~cur & valid)
                    # a row outside the layer reads as 0 in the operand
                    operand = torch.where(inside[:, None], operand, torch.zeros_like(operand))
                    acc = morphology._dilate_bits(operand, morphology.structuring_element(shape, ksize))
                    res = acc if op == "d" else (~acc & valid)
                    if hi > lo:
                        bufs[src ^ 1][lo:hi] = res[lo:hi]
                    src ^= 1
                n = min(band, h - (g0 + radius))
                out[layer, g0 + radius : g0 + radius + n] = bufs[src][radius : radius + n]
        x = out
    return x


SEQUENCES = {
    "front-end": frontend_steps(),
    "main path": MAIN_PATH_STEPS,
    "mixed 3/5/7": (("rect", 5, "e"), ("cross", 7, "d"), ("ellipse", 3, "e"), ("rect", 3, "d"), ("cross", 5, "e")),
    "ksize 1 and 4": (("rect", 1, "e"), ("rect", 4, "d"), ("ellipse", 4, "e"), ("cross", 1, "d")),
    "wide": (("cross", 63, "d"), ("rect", 7, "e")),
    "one step": (("ellipse", 7, "e"),),
}


SHAPES = [(2, 75, 70), (1, 1, 40), (3, 33, 1), (1, 31, 31), (2, 40, 32), (1, 20, 33), (1, 9, 2000)]


# the plain version shifts rows by at most the layer's height: the 63-row
# element only on layers of 32 rows and more
@pytest.mark.parametrize("name, k, h, w", [(name, *shape) for name in SEQUENCES for shape in SHAPES
                                           if name != "wide" or shape[1] >= 32])
def test_k2_band_schedule_matches_plain(name, k, h, w):
    steps = SEQUENCES[name]
    rng = np.random.default_rng(len(name) * 1000 + h * 7 + w)
    x = random_words(rng, (k, h, -(-w // 32)))
    valid = morphology._valid_bits(w)
    schedule = kernels.morph_schedule(radii_of(steps), h, x.shape[-1])
    assert len(schedule) == 1  # these fit one launch
    got = emulate_k2(x, valid, steps, schedule, rng)
    assert torch.equal(got, morphology.morph_steps_plain(x, valid, steps))


@pytest.mark.parametrize("max_smem", [3_000, 6_000, 7_000])
def test_k2_segments_match_plain(max_smem, monkeypatch):
    """A step list whose halo does not fit is split into segments, one
    launch each; a step too large for a full band takes a shorter one (here
    with 3 KB of shared memory)."""
    steps = frontend_steps(2, 5, 1) + (("cross", 7, "d"),)
    h, w = 61, 300
    rng = np.random.default_rng(max_smem)
    x = random_words(rng, (2, h, -(-w // 32)))
    valid = morphology._valid_bits(w)
    monkeypatch.setattr(kernels, "MAX_SMEM", max_smem)
    schedule = kernels.morph_schedule.__wrapped__(radii_of(steps), h, x.shape[-1])
    assert len(schedule) > 1
    assert any(band < kernels.MORPH_BAND for _, _, band, _ in schedule) == (max_smem == 3_000)
    assert [(a, b) for a, b, _, _ in schedule] == list(zip([0] + [b for _, b, _, _ in schedule[:-1]],
                                                           [b for _, b, _, _ in schedule]))
    for _, _, band, radius in schedule:
        assert band >= 1 and kernels.morph_smem_bytes(band, radius, x.shape[-1]) <= max_smem
    got = emulate_k2(x, valid, steps, schedule, rng)
    assert torch.equal(got, morphology.morph_steps_plain(x, valid, steps))


def test_k2_schedule_defaults_are_one_launch():
    """The main path's open+close and the front-end's four programs are one
    segment of 32-row bands, up to the 4400 px the smoke drives."""
    for steps, radius in ((MAIN_PATH_STEPS, 4), (frontend_steps(), 8)):
        for h, w in ((1500, 2000), (2000, 2000), (4400, 4400), (5, 7)):
            nw = -(-w // 32)
            assert kernels.morph_schedule(radii_of(steps), h, nw) == ((0, len(steps), min(32, h), radius),)
    # the bytes the note in csrc/morph_bits.cu gives: 22 and 26 KB at 63 words
    assert kernels.morph_smem_bytes(32, 4, 63) == 21060 + 1008
    assert kernels.morph_smem_bytes(32, 8, 63) == 25220 + 1008


def test_k2_schedule_long_list_and_wide_rows():
    """Eight radius-31 steps need two launches at 2000 px; any single step
    with |dx| <= 31 fits up to 453 words a row, and wider rows raise before
    any launch."""
    steps = morphology.morph_program("cross", 63, 4, "ed")
    schedule = kernels.morph_schedule(radii_of(steps), 100, 63)
    assert [(a, b) for a, b, _, _ in schedule] == [(0, 6), (6, 8)]
    assert kernels.morph_schedule((31,), 1, 453)[0][2] == 1
    assert kernels.morph_schedule((31,), 40, 453)[0][2] == 1  # a shorter band than the layer's
    with pytest.raises(ValueError, match="does not fit"):
        kernels.morph_schedule((31,), 1, 454)


def test_k2_long_list_emulated():
    steps = morphology.morph_program("cross", 63, 4, "ed")
    h, w = 70, 2000
    rng = np.random.default_rng(63)
    x = (random_words(rng, (1, h, 63)) & random_words(rng, (1, h, 63))) | random_words(rng, (1, h, 63))
    valid = morphology._valid_bits(w)
    schedule = kernels.morph_schedule(radii_of(steps), h, 63)
    assert len(schedule) == 2
    assert torch.equal(emulate_k2(x, valid, steps, schedule, rng), morphology.morph_steps_plain(x, valid, steps))


@pytest.mark.parametrize("extract_iters, edge_kernel, edge_iters", [(1, 3, 1), (2, 5, 1), (0, 3, 2), (1, 7, 0)])
def test_morph_steps_plain_matches_chained_jax_calls(extract_iters, edge_kernel, edge_iters):
    """The front-end's step list == the JAX front-end's four ``morph_bits``
    calls, and the main path's == stage 03's open then close."""
    rng = np.random.default_rng(extract_iters * 10 + edge_kernel)
    k, h, w = 3, 41, 77
    x = (rng.random((k, h, w)) < 0.55).astype(np.uint8)
    packed = jnp.asarray(jthin.pack_bitboards(jnp.asarray(x)))
    valid = jnp.asarray(jmorph._valid_bits(w))
    ref = packed
    for shape, ksize, iters, program in (("rect", 3, extract_iters, "ed"), ("rect", 3, extract_iters, "de"),
                                         ("ellipse", edge_kernel, edge_iters, "ed"),
                                         ("ellipse", edge_kernel, edge_iters, "de")):
        ref = jmorph.morph_bits(ref, valid, shape, ksize, iters, program)
    got = morphology.morph_steps(bitboards_from_jax(np.asarray(packed)), morphology._valid_bits(w),
                                 frontend_steps(extract_iters, edge_kernel, edge_iters))
    np.testing.assert_array_equal(bitboards_to_jax(got), np.asarray(ref))

    ref = jmorph.morph_bits(packed, valid, "ellipse", edge_kernel, extract_iters, "ed")
    ref = jmorph.morph_bits(ref, valid, "ellipse", edge_kernel, edge_iters, "de")
    steps = (morphology.morph_program("ellipse", edge_kernel, extract_iters, "ed")
             + morphology.morph_program("ellipse", edge_kernel, edge_iters, "de"))
    got = morphology.morph_steps_plain(bitboards_from_jax(np.asarray(packed)), morphology._valid_bits(w), steps)
    np.testing.assert_array_equal(bitboards_to_jax(got), np.asarray(ref))


def test_morph_bits_is_a_one_program_step_list():
    rng = np.random.default_rng(3)
    x = random_words(rng, (2, 19, 3))
    valid = morphology._valid_bits(70)
    assert morphology.morph_program("rect", 5, 2, "ed") == (("rect", 5, "e"),) * 2 + (("rect", 5, "d"),) * 2
    assert morphology.morph_program("rect", 5, 0, "ed") == ()
    assert morphology.morph_steps(x, valid, ()) is x
    assert torch.equal(morphology.morph_bits(x, valid, "cross", 5, 2, "de"),
                       morphology.morph_steps(x, valid, morphology.morph_program("cross", 5, 2, "de")))
    assert morphology._valid_bits(70) is valid  # made once per (w, device)


# ---------------------------------------------------------------------------
# K12: tiles with a 2T-row, one-word halo, T iterations per launch
# ---------------------------------------------------------------------------


def emulate_k12_launch(src: torch.Tensor, n: int, rotated: bool, tile, rng):
    """One launch of csrc/zs_dense.cu on packed (k, h, nw) boards: every
    (layer, tile) loads its tile and halo (0 outside the image), runs up to
    n iterations over the rows each subpass gets right (the rest hold
    garbage), stops where its whole computed region did not change, and
    stores its own region.  Returns the packed result and the flags:
    flags[it] = some tile's own region changed at iteration it."""
    tr, tw, t = tile
    halo = 2 * t
    rows, cols = tr + 2 * halo, tw + 2
    k, h, nw = src.shape
    grid = [(layer, ty, tx) for layer in range(k) for ty in range(-(-h // tr)) for tx in range(-(-nw // tw))]
    padded = torch.zeros((k, -(-h // tr) * tr + 2 * halo, -(-nw // tw) * tw + 2), dtype=torch.int32)
    padded[:, halo : halo + h, 1 : 1 + nw] = src
    xs = torch.stack([padded[layer, ty * tr : ty * tr + rows, tx * tw : tx * tw + cols] for layer, ty, tx in grid])
    ys = random_words(rng, xs.shape)
    active = torch.ones(len(grid), dtype=torch.bool)[:, None, None]
    flags = [False] * n
    for it in range(n):
        lo1, hi1 = 2 * it + 1, rows - 2 * it - 1
        ys[:, lo1:hi1] = thinning._subpass_bits(xs, True, rotated)[:, lo1:hi1]
        lo2, hi2 = 2 * it + 2, rows - 2 * it - 2
        new = thinning._subpass_bits(ys, False, rotated)[:, lo2:hi2]
        changed = (new != xs[:, lo2:hi2]) & active
        flags[it] = bool(changed[:, halo - lo2 : halo - lo2 + tr, 1 : tw + 1].any())
        xs[:, lo2:hi2] = torch.where(active, new, xs[:, lo2:hi2])
        active = active & changed.flatten(1).any(1)[:, None, None]
        if not active.any():
            break
    out = torch.empty_like(src)
    for i, (layer, ty, tx) in enumerate(grid):
        g1, w1 = min(h, ty * tr + tr), min(nw, tx * tw + tw)
        out[layer, ty * tr : g1, tx * tw : w1] = xs[i, halo : halo + g1 - ty * tr, 1 : 1 + w1 - tx * tw]
    return out, flags


def emulate_k12(binary: torch.Tensor, max_iter: int, rotated: bool, tile, rng):
    """``kernels.zhang_suen_dense_cuda``'s launch loop over the emulated
    launches → (int32 0/1 planes, launches)."""
    src = thinning.pack_bitboards(binary)  # the first launch packs on load
    done, launches = 0, 0
    while True:
        n = max(0, min(tile[2], max_iter - done))
        src, flags = emulate_k12_launch(src, n, rotated, tile, rng)
        launches, done = launches + 1, done + n
        if done >= max_iter or not flags[n - 1]:
            break
    return thinning.unpack_bitboards(src, binary.shape[-1]), launches


def square_and_strokes(seed: int, k: int, h: int, w: int) -> torch.Tensor:
    """Seeded uint8 0/255 strokes, with a filled square in layer 0 that needs
    more than 8 iterations."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, h + 2, w + 2)) < 0.5
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    img = (s[:, 1 : h + 1, 1 : w + 1] >= 5).astype(np.uint8) * 255
    img[0, 3 : min(h, 3 + 30), 2 : min(w, 2 + 34)] = 255
    return torch.from_numpy(img)


@pytest.mark.parametrize("max_iter", [1, 7, 8, 9, 120])
@pytest.mark.parametrize("rotated", [True, False])
def test_k12_tile_schedule_matches_plain(rotated, max_iter):
    """The kernel's own geometry (64 x 16-word tiles, T = 8) on an image
    three tiles wide, and a small tile (5 rows x 1 word) that puts a halo at
    every few pixels, with max_iter below, at and above T."""
    x = square_and_strokes(max_iter, 2, 70, 1100 if max_iter in (8, 120) else 70)
    ref = thinning.zhang_suen_dense_plain(x, max_iter, rotated)
    for tile in ((kernels.ZS_TILE_ROWS, kernels.ZS_TILE_WORDS, kernels.ZS_CHUNK), (5, 1, kernels.ZS_CHUNK), (3, 2, 3)):
        got, launches = emulate_k12(x, max_iter, rotated, tile, np.random.default_rng(1))
        assert torch.equal(got, ref), tile
        assert launches <= -(-max(max_iter, 1) // tile[2])


def test_k12_square_needs_more_than_one_launch():
    """A filled square thins in more than T iterations: the host launches
    again from the packed state, and stops after the first launch whose last
    iteration changed nothing."""
    x = torch.zeros((1, 40, 45), dtype=torch.uint8)
    x[0, 2:38, 3:42] = 1
    for tile in ((kernels.ZS_TILE_ROWS, kernels.ZS_TILE_WORDS, kernels.ZS_CHUNK), (6, 1, 4)):
        got, launches = emulate_k12(x, 120, True, tile, np.random.default_rng(2))
        assert torch.equal(got, thinning.zhang_suen_dense_plain(x, 120, True))
        assert 1 < launches < 120 // tile[2]


def test_k12_tile_constants_match_the_source():
    """ops/kernels.py repeats csrc/zs_dense.cu's constants: T <= 16 keeps the
    bits of 2T subpasses inside the one-word halo."""
    from pathlib import Path

    src = (Path(kernels.CSRC) / "zs_dense.cu").read_text()
    assert f"constexpr int kT = {kernels.ZS_CHUNK};" in src
    assert f"constexpr int kTR = {kernels.ZS_TILE_ROWS};" in src
    assert f"constexpr int kTW = {kernels.ZS_TILE_WORDS};" in src
    assert kernels.ZS_CHUNK <= 16
    # and csrc/morph_bits.cu's static masks: two steps of at most 63 rows of taps
    assert "constexpr int kMaxRows = 63;" in (Path(kernels.CSRC) / "morph_bits.cu").read_text()
    assert kernels.MORPH_MASK_BYTES == 2 * 63 * 8


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.bool])
def test_zhang_suen_dense_plain_matches_jax_for_input_types(dtype):
    """The dense thinner binarises any input as > 0, (k, H, W) or (H, W)."""
    x = square_and_strokes(5, 2, 37, 45)
    # int32: 0 becomes -1, which binarises to 0 as well
    planes = {torch.uint8: x, torch.int32: x.to(torch.int32) - 1, torch.bool: x > 0}[dtype]
    ref = np.asarray(jthin.zhang_suen_dense(x.numpy(), max_iter=120, rotated=True))
    np.testing.assert_array_equal(thinning.zhang_suen_dense(planes, 120, True).numpy(), ref)
    np.testing.assert_array_equal(thinning.zhang_suen_dense(planes[1], 120, True).numpy(), ref[1])
