"""The port's fused stage 03→04 chain and its carried-over k-means vs the JAX
package, byte for byte (tolerance 0: the chain is integer only).

``chain_from_clean`` on CPU tensors runs the plain versions of the kernels;
``chip_smoke.py`` holds the same function on the card against these bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from plotweave.ops import cvkmeans as jkm
from plotweave.stages.s02_color_extract import _chain_from_clean
from plotweave_torch.ops import cvkmeans as tkm
from plotweave_torch.stages.s02_color_extract import chain_from_clean

from test_torch_ops import blob_stack

# (mk, oi, ci, bk, lo, hi) as stages.common.edge_params builds them
EDGE_PARAMS = [
    (3, 1, 1, 5, 22, 70),   # the default config
    (3, 1, 1, 3, 40, 120),  # golden variant config
    (5, 2, 1, 7, 10, 40),   # 5×5 ellipse: column shifts of 2
    (7, 1, 2, 5, 22, 70),   # 7×7 ellipse: column shifts of 3
    (1, 0, 0, 3, 50, 20),   # no morphology; low > high swaps
    (3, 1, 0, 5, 0, 2041),  # open only; clamped high threshold
]
# one (k, H, W) per parameter tuple: each pair is one JAX compile
CASES = list(zip(EDGE_PARAMS, [(4, 48, 70), (1, 9, 33), (3, 40, 64), (2, 24, 100), (4, 16, 40), (1, 64, 8)]))


def _cleaned(seed: int, k: int, h: int, w: int) -> np.ndarray:
    return np.packbits(blob_stack(seed, k, h, w) > 0, axis=-1)


@pytest.mark.parametrize("params,shape", CASES, ids=["-".join(map(str, p)) for p, _ in CASES])
def test_chain_from_clean_byte_equal(params, shape):
    k, h, w = shape
    packed = _cleaned(31 + h, k, h, w)
    ref = np.asarray(_chain_from_clean(packed, w, *params))
    got = chain_from_clean(packed, w, *params, device=torch.device("cpu"))
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def test_chain_blob_layout():
    """[packed edges (k·H·⌈W/8⌉)][packed skeletons]; skeletons ⊆ edges."""
    k, h, w = 3, 40, 61
    w8 = (w + 7) // 8
    blob = chain_from_clean(_cleaned(5, k, h, w), w, *EDGE_PARAMS[0], device=torch.device("cpu"))
    blob = blob.numpy().reshape(2 * k, h, w8)
    edges, skels = np.unpackbits(blob[:k], axis=-1)[..., :w], np.unpackbits(blob[k:], axis=-1)[..., :w]
    assert edges.any() and skels.any()
    assert not (skels & ~edges).any()
    assert not np.unpackbits(blob, axis=-1)[..., w:].any()  # padding bits stay clear


@pytest.mark.parametrize("k,n", [(2, 500), (4, 3000), (8, 1200)])
def test_cv_kmeans_carried_over(k, n):
    rng = np.random.default_rng(k * n)
    lab = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    lab[: n // 2] //= 4  # a dense cluster for the seeding to find
    data = lab.astype(np.float32)
    c_ref, l_ref, ctr_ref = jkm.cv_kmeans(data, k, max_count=20, epsilon=0.5, attempts=2)
    c_got, l_got, ctr_got = tkm.cv_kmeans(data, k, max_count=20, epsilon=0.5, attempts=2)
    assert c_got == c_ref
    np.testing.assert_array_equal(l_got, l_ref)
    np.testing.assert_array_equal(ctr_got, ctr_ref)
    np.testing.assert_array_equal(tkm.assign_labels(lab, ctr_got), jkm.assign_labels(lab, ctr_ref))


def test_cv_kmeans_python_path_carried_over():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (400, 3)).astype(np.float32)
    ref = jkm._cv_kmeans_py(data, 4, 10, 0.5, 2, jkm.DEFAULT_RNG_STATE)
    got = tkm._cv_kmeans_py(data, 4, 10, 0.5, 2, tkm.DEFAULT_RNG_STATE)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[2], ref[2])
