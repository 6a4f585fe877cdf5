"""Kernel K14 over a whole SVG document on the CPU: the family table, its
plain version and the document route of ``frontends/svg.py``.

- ``ops.bezier.sample_families_plain`` over a ``pack_families`` buffer
  equals ``sample_bezier_plain`` of each family bit for bit (cubics and
  quadratics mixed in one table, n = 1, 2 and 128, one curve and many, empty
  families left out of the table).
- A numpy emulation of the kernel's CTA-to-family search (each CTA's range
  of the start table, the binary search over the table's output offsets)
  puts every point of every family exactly once, in its slot, with its
  curve's control points; at the kernel's 256 points a CTA and at CTAs of 1,
  3 and 32 points, so that CTAs straddle many families.
- ``svg_to_polylines`` with a CPU ``BezierSampler`` (the document route:
  each path parsed once, one ``sample_families`` call a document) equals
  the per-path route (a sampling call for each family of each path, as the
  port sampled before the table) bit for bit, on the front-end tests' seeded
  documents and on a seeded poster of nested groups under transforms; the
  numpy route stays the JAX package's, bit for bit.
"""

from __future__ import annotations

import unittest.mock as mock

import numpy as np
import pytest
import torch

import plotweave.frontends.svg as JS
from plotweave_torch.frontends import svg as S
from plotweave_torch.ops import bezier, kernels

from test_torch_frontends import random_svg


def random_families(seed: int, count: int, curves=(0, 1, 2, 7, 40), ns=(1, 2, 8, 37, 128)):
    """Seeded families: (ctrl (S, K, 2) float64, n), K 3 or 4 at random."""
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-500, 4200, (int(rng.choice(curves)), int(rng.choice([3, 4])), 2)), int(rng.choice(ns)))
            for _ in range(count)]


def per_family(families):
    """Each family through ``sample_bezier_plain`` on its own float32 copy."""
    return [bezier.sample_bezier_plain(torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32)), n).numpy()
            for c, n in families]


TABLES = {
    "mixed": random_families(1, 30),
    "one curve each": random_families(2, 12, curves=(1,)),
    "many curves": random_families(3, 4, curves=(300,)),
    "n = 1": random_families(4, 9, ns=(1,)),
    "n = 2": random_families(5, 9, ns=(2,)),
    "n = 128": random_families(6, 9, ns=(128,)),
    "empties around": [(np.zeros((0, 4, 2)), 8)] + random_families(7, 3) + [(np.zeros((0, 3, 2)), 1)],
    "all empty": [(np.zeros((0, 4, 2)), 8), (np.zeros((0, 3, 2)), 5)],
    "one family": random_families(8, 1, curves=(5,)),
}


@pytest.mark.parametrize("name", list(TABLES))
def test_plain_table_equals_each_family(name):
    families = TABLES[name]
    words, table, n_points = bezier.pack_families(families)
    kept = table[:, 0] >= 0
    assert n_points == sum(len(c) * n for c, n in families)
    assert (kept == np.array([len(c) > 0 for c, _ in families])).all()
    got = bezier.sample_families_plain(words, int(kept.sum()), n_points).numpy()
    for (c, n), want, (c0, o0, nn, k) in zip(families, per_family(families), table.tolist()):
        if not len(c):
            assert c0 == o0 == nn == k == -1
            continue
        assert (nn, k) == (n, c.shape[1])
        np.testing.assert_array_equal(got[o0: o0 + len(c) * n].reshape(len(c), n, 2), want)
    sampler = bezier.BezierSampler("cpu")
    for (c, n), pts, want in zip(families, sampler.sample_families(families), per_family(families)):
        assert pts.dtype == np.float32 and pts.shape == (len(c), n, 2)
        np.testing.assert_array_equal(pts, want)
    assert sampler.calls == len(families) and sampler.documents == int(n_points > 0)


def emulate_cta_search(words: np.ndarray, n_fam: int, n_points: int, threads: int):
    """K14's ``bezier_families`` index arithmetic thread by thread: for each
    point q, (family, curve, i, control offset) as the kernel finds them."""
    table_off, first_off = kernels.bezier_layout(len(words), n_fam, n_points)
    table = words[table_off: table_off + 4 * n_fam].reshape(n_fam, 4).astype(np.int64)
    first = words[first_off:].astype(np.int64)
    assert len(first) == -(-n_points // threads) + 1
    found = []
    for b in range(len(first) - 1):
        for t in range(threads):
            q = b * threads + t
            if q >= n_points:
                break
            lo, hi = int(first[b]), int(first[b + 1])
            assert 0 <= lo <= hi < n_fam
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                if table[mid, 1] <= q:
                    lo = mid
                else:
                    hi = mid - 1
            c0, o0, n, k = table[lo]
            curve, i = divmod(q - o0, n)
            found.append((q, lo, curve, i, c0 + curve * 2 * k))
    return found


@pytest.mark.parametrize("threads", [kernels.BEZIER_THREADS, 32, 3, 1])
@pytest.mark.parametrize("name", ["mixed", "one curve each", "n = 1", "empties around", "one family"])
def test_cta_search_covers_every_point_once(name, threads, monkeypatch):
    monkeypatch.setattr(kernels, "BEZIER_THREADS", threads)
    monkeypatch.setattr(bezier, "BEZIER_THREADS", threads)
    families = [f for f in TABLES[name] if len(f[0])]
    words, table, n_points = bezier.pack_families(families)
    found = emulate_cta_search(words.numpy(), len(families), n_points, threads)
    want = []  # every (family, curve, i) once, at its slot, with its curve's control points
    slot = ctrl = 0
    for f, (c, n) in enumerate(families):
        for curve in range(len(c)):
            want += [(slot + i, f, curve, i, ctrl) for i in range(n)]
            slot += n
            ctrl += 2 * c.shape[1]
    assert found == want
    floats = words.numpy()[: ctrl].view(np.float32)
    for q, f, curve, i, c0 in found[:: max(1, len(found) // 200)]:
        k = families[f][0].shape[1]
        np.testing.assert_array_equal(floats[c0: c0 + 2 * k].reshape(k, 2),
                                      families[f][0][curve].astype(np.float32))


def test_layout_and_packing_refuse_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="3 or 4"):
        bezier.pack_families([(np.zeros((2, 5, 2)), 8)])
    with pytest.raises(ValueError, match="n >= 1"):
        bezier.pack_families([(np.zeros((2, 4, 2)), 0)])
    with pytest.raises(ValueError, match="2\\^31"):
        kernels.bezier_layout(10, 1, 2**31)
    with pytest.raises(ValueError, match="do not hold"):
        kernels.bezier_layout(3, 1, 8)
    with pytest.raises(ValueError, match="non-empty"):
        kernels.bezier_layout(10, 0, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bezier_families_cuda(bezier.pack_families(TABLES["mixed"])[0], 1, 8)


# --- the document route ------------------------------------------------------------


def nested_poster(seed: int, groups: int = 5, depth: int = 3) -> str:
    """A seeded poster: the paths and shapes of ``random_svg`` documents in
    groups nested ``depth`` deep, each level under its own transform
    (translate, scale, rotate about a point, skew, matrix)."""
    rng = np.random.default_rng(seed)
    transforms = [lambda: f"translate({rng.uniform(-40, 40):.2f},{rng.uniform(-40, 40):.2f})",
                  lambda: f"scale({rng.uniform(0.5, 2):.3f})",
                  lambda: f"rotate({rng.uniform(-30, 30):.2f} {rng.uniform(0, 400):.1f} {rng.uniform(0, 300):.1f})",
                  lambda: f"skewX({rng.uniform(-15, 15):.2f})",
                  lambda: "matrix(" + ",".join(f"{x:.3f}" for x in rng.uniform(-1.5, 1.5, 6)) + ")"]
    body = []
    for g in range(groups):
        inner = random_svg(seed * 100 + g, n_paths=4, segments=8, shapes=1)
        inner = inner[inner.index("<g"): inner.rindex("</svg>")]
        for _ in range(depth):
            inner = f'<g transform="{transforms[int(rng.integers(0, len(transforms)))]()}">{inner}</g>'
        body.append(inner)
    return '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 420 297">' + "".join(body) + "</svg>"


DOCUMENTS = {**{f"random {seed}": random_svg(seed) for seed in (1, 2, 3, 4)},
             **{f"nested poster {seed}": nested_poster(seed) for seed in (5, 6)},
             "chain test": ('<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 100 100">'
                            '<circle cx="50" cy="50" r="30"/><path d="M10,10 C 30,0 70,0 90,10"/></svg>'),
             "no curves": ('<svg xmlns="http://www.w3.org/2000/svg"><g transform="translate(5,5) scale(2)">'
                           '<rect x="0" y="0" width="10" height="10"/><path d="M 0 0 L 10 0 L 10 10 Z"/></g></svg>')}


class PerFamily:
    """The per-path route's ``xp``: each family of each path sampled by its
    own call, the plain version of today's one launch a family."""

    def __init__(self):
        self.calls = 0

    def sample(self, ctrl, n):
        self.calls += 1
        return per_family([(ctrl, n)])[0]


def per_path_route(svg: str, sampler: PerFamily):
    """``svg_to_polylines`` sampling a path's families as its parse ends:
    the JAX package's walk (the copy's, line for line) with its batched
    samplers handing each family to ``sampler``."""
    with mock.patch.object(JS, "sample_cubics_batched", lambda ctrl, n, xp: xp.sample(ctrl, n)), \
            mock.patch.object(JS, "sample_quads_batched", lambda ctrl, n, xp: xp.sample(ctrl, n)):
        return JS.svg_to_polylines(svg, xp=sampler)


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_document_route_equals_per_path_route(name):
    svg = DOCUMENTS[name]
    ref = PerFamily()
    want = per_path_route(svg, ref)
    sampler = bezier.BezierSampler("cpu")
    with mock.patch.object(bezier.BezierSampler, "sample_families", autospec=True,
                           side_effect=bezier.BezierSampler.sample_families) as spy:
        got = S.svg_to_polylines(svg, xp=sampler)
    assert spy.call_count == 1  # the whole document in one call
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)
    assert sampler.calls == ref.calls and sampler.documents == int(ref.calls > 0)
    numpy = S.svg_to_polylines(svg)
    assert len(numpy) == len(got)
    for g, r in zip(got, numpy):
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("name", list(DOCUMENTS))
def test_numpy_route_is_the_jax_packages(name):
    svg = DOCUMENTS[name]
    a, b = S.svg_to_polylines(svg), JS.svg_to_polylines(svg)
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        np.testing.assert_array_equal(pa, pb)


def test_parse_path_data_with_a_sampler_samples_per_path():
    """``parse_path_data`` called alone with a sampler still samples its own
    families (one call each) and returns the polylines."""
    d = "M 0 0 C 10 0 20 10 30 0 Q 40 -10 50 0 L 60 0 c 5 5 10 5 15 0"
    sampler = bezier.BezierSampler("cpu")
    got = S.parse_path_data(d, xp=sampler)
    want = per_path_route(f'<svg xmlns="http://www.w3.org/2000/svg"><path d="{d}"/></svg>', PerFamily())
    assert sampler.calls == 2 and sampler.documents == 2
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(got[0], want[0])
