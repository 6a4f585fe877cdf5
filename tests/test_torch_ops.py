"""plotweave_torch ops vs the JAX ops on the same numpy-seeded inputs.

Every op of the stage 02→04 chain is integer, so the tolerance is 0: the
port's outputs must be byte-equal to the JAX package's.  Bitboards cross
between the packages as the same bits (``bitboards_from_jax`` /
``bitboards_to_jax``).  These run the plain PyTorch versions (CPU tensors);
the CUDA kernels are checked against the same plain versions on the card by
``chip_smoke.py``.
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
from plotweave.ops import morphology as jmorph
from plotweave.ops import thinning as jthin
from plotweave.ops.pallas_kernels import zhang_suen_packed_pallas
from plotweave_torch.ops import bitpack, filters, morphology, thinning

# the package exports the function ``canny``, as ``plotweave.ops`` does, so the module is named in full
canny = importlib.import_module("plotweave_torch.ops.canny")
from plotweave_torch.ops.thinning import bitboards_from_jax, bitboards_to_jax

jcanny = importlib.import_module("plotweave.ops.canny")  # the package binds `canny` to a function

GOLDEN = Path(__file__).parent / "golden"


def blob_stack(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """(k, h, w) 0/255 uint8 masks: a seeded smooth field cut into k bands,
    plus speckle, so edges, skeletons and morphology all have work."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    field = np.zeros((h, w))
    for _ in range(4):
        fy, fx = rng.uniform(0.05, 0.35, 2)
        field += np.sin(fy * yy + fx * xx + rng.uniform(0, 6.3))
    bands = np.digitize(field, np.quantile(field, np.linspace(0, 1, k + 1)[1:-1]))
    masks = np.stack([bands == j for j in range(k)])
    masks ^= rng.random(masks.shape) < 0.02
    return masks.astype(np.uint8) * 255


def gray_stack(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """(k, h, w) uint8 images: blurred-looking blobs with full-range noise."""
    rng = np.random.default_rng(seed)
    base = blob_stack(seed, k, h, w).astype(np.int16) // 2 + 40
    return np.clip(base + rng.integers(-40, 41, base.shape), 0, 255).astype(np.uint8)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 5, 13), (3, 17), (1, 4, 64), (9,)])
def test_bitpack_rows_roundtrip(shape):
    rng = np.random.default_rng(1)
    x = (rng.random(shape) < 0.5).astype(np.uint8) * rng.integers(1, 256, shape).astype(np.uint8)
    ref = np.asarray(jbitpack.bitpack_rows(jnp.asarray(x)))
    got = bitpack.bitpack_rows(t(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.packbits(x > 0, axis=-1))
    w = shape[-1]
    np.testing.assert_array_equal(
        bitpack.bitunpack_rows(t(ref), w).numpy(), np.asarray(jbitpack.bitunpack_rows(jnp.asarray(ref), w))
    )


@pytest.mark.parametrize("w", [1, 31, 32, 33, 70, 96])
def test_pack_unpack_bitboards(w):
    rng = np.random.default_rng(w)
    x = (rng.random((2, 9, w)) < 0.5).astype(np.uint8) * 255
    ref = np.asarray(jthin.pack_bitboards(jnp.asarray(x)))
    got = thinning.pack_bitboards(t(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(bitboards_to_jax(got), ref)
    np.testing.assert_array_equal(bitboards_from_jax(ref), got)
    np.testing.assert_array_equal(
        thinning.unpack_bitboards(got, w).numpy(), np.asarray(jthin.unpack_bitboards(jnp.asarray(ref), w))
    )


@pytest.mark.parametrize("dx", [-1, 1])
def test_nbr_bits_carry_across_words(dx):
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, (3, 4, 5), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jthin._nbr_bits(jnp.asarray(words), dx))
    got = thinning._nbr_bits(bitboards_from_jax(words), dx)
    np.testing.assert_array_equal(bitboards_to_jax(got), ref)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("program", ["ed", "de"])
@pytest.mark.parametrize("ksize", [3, 5])
@pytest.mark.parametrize("shape", ["rect", "ellipse"])
def test_morph_bits(shape, ksize, program, iterations):
    k, h, w = 3, 24, 45
    x = blob_stack(11, k, h, w)
    packed = np.asarray(jthin.pack_bitboards(jnp.asarray(x)))
    ref = np.asarray(
        jmorph.morph_bits(jnp.asarray(packed), jnp.asarray(jmorph._valid_bits(w)), shape, ksize, iterations, program)
    )
    got = morphology.morph_bits(
        bitboards_from_jax(packed), morphology._valid_bits(w), shape, ksize, iterations, program
    )
    np.testing.assert_array_equal(bitboards_to_jax(got), ref)


def test_structuring_elements_match():
    for shape in ("rect", "cross", "ellipse"):
        for ksize in (1, 3, 5, 7, 9):
            np.testing.assert_array_equal(
                morphology.structuring_element(shape, ksize), jmorph.structuring_element(shape, ksize)
            )


@pytest.mark.parametrize("ksize", [3, 5, 7])
def test_gaussian_blur_u8(ksize):
    x = gray_stack(3, 2, 19, 37)
    ref = np.asarray(jfilters.gaussian_blur_u8(jnp.asarray(x), ksize))
    got = filters.gaussian_blur_u8(t(x), ksize)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("low,high", [(22, 70), (70, 22), (40, 120), (5, 3000), (0, 0)])
def test_canny_packed(low, high):
    x = np.asarray(jfilters.gaussian_blur_u8(jnp.asarray(blob_stack(7, 3, 33, 50)), 5))
    ref_dense, ref_packed = jcanny.canny_packed(jnp.asarray(x), low, high)
    got_dense, got_packed = canny.canny_packed(t(x), low, high)
    np.testing.assert_array_equal(got_dense.numpy(), np.asarray(ref_dense))
    np.testing.assert_array_equal(bitboards_to_jax(got_packed), np.asarray(ref_packed))


def test_canny_gray_input():
    x = gray_stack(9, 2, 40, 41)
    ref_dense, _ = jcanny.canny_packed(jnp.asarray(x), 30, 90)
    got_dense, _ = canny.canny_packed(t(x), 30, 90)
    assert got_dense.numpy().any()
    np.testing.assert_array_equal(got_dense.numpy(), np.asarray(ref_dense))


@pytest.mark.parametrize("rotated,max_iter", [(True, 120), (False, 48), (True, 1)])
def test_zhang_suen_packed(rotated, max_iter):
    x = blob_stack(13, 3, 40, 75)
    packed = np.asarray(jthin.pack_bitboards(jnp.asarray(x)))
    ref = np.asarray(jthin.zhang_suen_packed(jnp.asarray(packed), max_iter=max_iter, rotated=rotated))
    got = thinning.zhang_suen_packed(bitboards_from_jax(packed), max_iter=max_iter, rotated=rotated)
    np.testing.assert_array_equal(bitboards_to_jax(got), ref)


@pytest.mark.parametrize("rotated,max_iter", [(True, 120), (False, 48)])
def test_zhang_suen_vs_pallas_interpret(rotated, max_iter):
    x = blob_stack(17, 2, 30, 70)
    ref = np.asarray(zhang_suen_packed_pallas(x, max_iter, rotated, interpret=True))
    got = thinning.zhang_suen(t(x), max_iter=max_iter, rotated=rotated)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_zhang_suen_golden_cases():
    z = np.load(GOLDEN / "thinning_cases.npz")
    for i in range(4):
        edges = t(z[f"edges_{i}"])
        np.testing.assert_array_equal(thinning.zhang_suen(edges, 120, rotated=True).numpy(), z[f"skel04_{i}"])
        np.testing.assert_array_equal(thinning.zhang_suen(edges, 48, rotated=False).numpy(), z[f"skel08_{i}"])


def test_fixpoint_wrappers_refuse_other_devices():
    meta = torch.zeros((1, 4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        thinning.zhang_suen_packed(meta)
    with pytest.raises(ValueError):
        canny.hysteresis(meta, meta)
