"""The plain versions of kernels K2 (packed morphology) and K12 (dense
Zhang–Suen) vs the JAX package, and what the kernel wrappers do on a machine
without a card.

Both ops are integer, so the tolerance is 0: byte-equal to the JAX package.
K12's JAX references are ``zhang_suen_dense`` and the Pallas kernel
``zhang_suen_pallas`` in interpret mode.  The kernels themselves run only on
the card, where ``chip_smoke.py`` holds them against these plain versions.
"""

from __future__ import annotations

import os
import stat
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import morphology as jmorph
from plotweave.ops import thinning as jthin
from plotweave.ops.pallas_kernels import zhang_suen_pallas
from plotweave_torch.ops import kernels, morphology, thinning
from plotweave_torch.ops.thinning import bitboards_from_jax, bitboards_to_jax

GOLDEN = Path(__file__).parent / "golden"


def strokes(seed: int, k: int, h: int, w: int) -> np.ndarray:
    """Seeded (k, h, w) 0/255 uint8 blobs and strokes thick enough to thin."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, h + 2, w + 2)) < rng.uniform(0.3, 0.6)
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return (s[:, 1 : h + 1, 1 : w + 1] >= 5).astype(np.uint8) * 255


@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("shape", ["rect", "ellipse", "cross"])
def test_morph_bits_plain_matches_jax(shape, ksize):
    rng = np.random.default_rng(ksize)
    for k, h, w, program, iterations in [(3, 23, 70, "ed", 1), (2, 17, 33, "de", 2), (1, 1, 40, "e", 1),
                                         (4, 9, 96, "d", 2)]:
        x = (rng.random((k, h, w)) < 0.6).astype(np.uint8)
        packed = np.asarray(jthin.pack_bitboards(jnp.asarray(x)))
        valid = jmorph._valid_bits(w)
        ref = np.asarray(jmorph.morph_bits(jnp.asarray(packed), jnp.asarray(valid), shape, ksize, iterations, program))
        got = morphology.morph_bits_plain(bitboards_from_jax(packed), morphology._valid_bits(w), shape, ksize,
                                          iterations, program)
        np.testing.assert_array_equal(bitboards_to_jax(got), ref, err_msg=f"{k}x{h}x{w} {program}x{iterations}")


@pytest.mark.parametrize("shape", ["rect", "ellipse", "cross"])
@pytest.mark.parametrize("ksize", [1, 3, 4, 7, 63])
def test_element_rows_encode_every_tap(shape, ksize):
    """K2 takes the element as one mask of column offsets per row of taps."""
    se = morphology.structuring_element(shape, ksize)
    dy0, rows = kernels.element_rows(shape, ksize)
    r = se.shape[0] // 2
    assert dy0 == -r and len(rows) == se.shape[0]
    taps = {(dy0 + i, b - 31) for i, m in enumerate(rows) for b in range(64) if m >> b & 1}
    assert taps == {(y - r, x - r) for y, x in zip(*np.nonzero(se))}


def test_element_rows_refuse_wide_elements():
    with pytest.raises(ValueError, match="dx"):
        kernels.element_rows("rect", 65)


@pytest.mark.parametrize("rotated,max_iter", [(True, 120), (False, 48), (True, 2)])
def test_zhang_suen_dense_plain_matches_jax(rotated, max_iter):
    for seed, (k, h, w) in enumerate([(3, 40, 70), (1, 33, 31), (2, 64, 129)]):
        x = strokes(seed, k, h, w)
        ref = np.asarray(jthin.zhang_suen_dense(x, max_iter=max_iter, rotated=rotated))
        got = thinning.zhang_suen_dense(torch.from_numpy(x), max_iter, rotated)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        # the Pallas kernel that K12 ports computes the same bytes
        pal = np.asarray(zhang_suen_pallas(x, max_iter=max_iter, rotated=rotated, interpret=True))
        np.testing.assert_array_equal(pal, ref)


def test_zhang_suen_dense_golden_cases():
    z = np.load(GOLDEN / "thinning_cases.npz")
    n = len([f for f in z.files if f.startswith("edges_")])
    for t in range(n):
        edges = torch.from_numpy(z[f"edges_{t}"])
        for key, rotated, it in ((f"skel04_{t}", True, 120), (f"skel08_{t}", False, 48)):
            got = thinning.zhang_suen_dense_plain(edges, it, rotated)
            np.testing.assert_array_equal(got.numpy(), z[key].astype(np.int32), err_msg=key)


def test_zhang_suen_dense_shapes():
    x = strokes(9, 2, 20, 30)
    planes = thinning.zhang_suen_dense(torch.from_numpy(x))
    single = thinning.zhang_suen_dense(torch.from_numpy(x[1]))
    assert tuple(single.shape) == (20, 30)
    np.testing.assert_array_equal(single.numpy(), planes[1].numpy())
    with pytest.raises(ValueError, match="zhang_suen_dense"):
        thinning.zhang_suen_dense(torch.from_numpy(x[None]))


def test_dispatchers_raise_for_other_devices():
    """Only a CPU tensor takes a plain version; a tensor on any device but the
    CPU and CUDA raises."""
    from plotweave_torch.ops.frontend import assign_nearest

    meta = torch.device("meta")
    b = torch.zeros((1, 4, 2), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        morphology.morph_bits(b, torch.zeros(2, dtype=torch.int32, device=meta), "rect", 3, 1, "ed")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        thinning.zhang_suen_dense(torch.zeros((1, 4, 4), dtype=torch.uint8, device=meta))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        assign_nearest(torch.zeros((4, 4, 3), dtype=torch.uint8, device=meta),
                       torch.zeros((4, 3), device=meta), 4)


def fake_nvcc(tmp_path: Path, exit_code: int = 0) -> Path:
    """An ``nvcc`` that logs its arguments and writes the ``-o`` file."""
    log = tmp_path / "nvcc.log"
    path = tmp_path / "bin" / "nvcc"
    path.parent.mkdir()
    path.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> {log}\n'
        'while [ "$#" -gt 0 ]; do if [ "$1" = "-o" ]; then out="$2"; fi; shift; done\n'
        f'echo built > "$out"\nexit {exit_code}\n'
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return log


def test_build_one_library_per_source(tmp_path, monkeypatch):
    log = fake_nvcc(tmp_path)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    paths = kernels.build()
    assert set(paths) == {"bitpack", "edge_candidates", "bitboard_fixpoints", "morph_bits", "assign_nearest",
                          "zs_dense", "kmeans", "morph_dense", "greedy_tour", "refine_tour", "area_resize",
                          "bezier_sample"}
    assert all(p.exists() and p.parent == tmp_path / "build" for p in paths.values())
    calls = log.read_text().splitlines()
    assert len(calls) == 12
    for line in calls:
        assert "arch=compute_90a,code=sm_90a" in line
        # every source that includes csrc/lab.cuh, and K9, K10, K13 and K14 (exact float orders), keep their
        # multiply-adds apart
        assert ("--fmad=false" in line) == line.endswith(("assign_nearest.cu", "kmeans.cu", "greedy_tour.cu",
                                                          "refine_tour.cu", "area_resize.cu", "bezier_sample.cu"))
        name = line.split("/")[-1]
        if '#include "lab.cuh"' in (kernels.CSRC / name).read_text():
            assert "--fmad=false" in line
    assert kernels.build() == paths  # built once: no second nvcc
    assert len(log.read_text().splitlines()) == 12


def test_build_raises_when_nvcc_fails(tmp_path, monkeypatch):
    fake_nvcc(tmp_path, exit_code=2)
    monkeypatch.setenv("PATH", f"{tmp_path / 'bin'}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="zs_dense.cu: nvcc failed"):
        kernels.build(["zs_dense", "morph_bits"])
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("kernel, k, h, w, resident", [
    ("zhang_suen_packed", 4, 1500, 2000, True),  # the main path's chain: one launch per call
    ("hysteresis", 4, 1500, 2000, True),
    ("zhang_suen_packed", 4, 2000, 2000, True),  # the default max_dimension
    ("hysteresis", 4, 2000, 2000, True),
    ("zhang_suen_packed", 1, 4400, 4400, False),  # too large for one cluster: the banded route
    ("hysteresis", 1, 4400, 4400, False),
    ("hysteresis", 1, 3800, 3800, False),  # K5 holds three more rows than K6 per CTA
    ("zhang_suen_packed", 1, 3800, 3800, True),
])
def test_fixpoint_route_by_size(kernel, k, h, w, resident):
    """The route of K5 and K6 is chosen by the shared memory a CTA of the
    resident route would take, before any launch (``csrc/bitboard_fixpoints.cu``
    lays out ceil(h / 16) rows of nw + 2 words per board): resident where the
    layer fits one cluster, banded where it does not; no size takes the
    multi-launch route."""
    nw = -(-w // 32)
    rpc = -(-h // 16)
    rows = 2 * rpc + (1 if kernel == "zhang_suen_packed" else 5)
    assert kernels.resident_smem_bytes(kernel, h, nw) == rows * (nw + 2) * 4 + 8
    assert kernels.resident(kernel, h, nw) is resident
    assert (kernels.resident_smem_bytes(kernel, h, nw) <= kernels.MAX_SMEM) is resident
    assert kernels.fixpoint_route(kernel, h, nw) == ("resident" if resident else "banded")


@pytest.mark.parametrize("kernel", ["zhang_suen_packed", "hysteresis"])
@pytest.mark.parametrize("h, w, route, expect", [
    (1500, 2000, "multi", "multi"),  # a named route overrides the size
    (1500, 2000, "resident", "resident"),
    (1500, 2000, "banded", "banded"),  # bands of a layer that fits (``band_rows`` cuts them)
    (4400, 4400, "multi", "multi"),
    (4400, 4400, "banded", "banded"),
    (4400, 4400, "resident", ValueError),  # does not fit one cluster
    (1500, 2000, "cluster", ValueError),  # no such route
])
def test_fixpoint_route_named(kernel, h, w, route, expect):
    """A caller may name K5's and K6's route; a resident route that does not
    fit raises before any launch, never falling back."""
    nw = -(-w // 32)
    if expect is ValueError:
        with pytest.raises(ValueError):
            kernels.fixpoint_route(kernel, h, nw, route)
    else:
        assert kernels.fixpoint_route(kernel, h, nw, route) == expect
