"""The plain reference against the port's plain path on the CPU, byte for
byte, at small sizes (this file may import the port; the reference does not),
and the near-tie comparison: any choice among the centres within
``near_tie`` passes it, an altered byte does not."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from plotweave_torch.ops.filters import gaussian_blur_u8_plain
from plotweave_torch.ops.frontend import raster_frontend
from plotweave_torch.ops.morphology import structuring_element
from portbench.images import image, shot
from portbench.reference import raster
from portbench.tests.conftest import MIXES, REPO

CENTRES = np.array([[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]], np.float32)
PARAMS = {name: json.loads((REPO / f"portbench/traffic/{name}.json").read_text())["image"] for name in MIXES}


def images(mix, seed, h, w, n=2):
    return torch.stack([image(seed, i, h, w, PARAMS[mix]) for i in range(n)])


@pytest.mark.parametrize("shape,ksize", [("rect", 3), ("rect", 5), ("ellipse", 3), ("ellipse", 5), ("ellipse", 7)])
def test_portbench_element_geometry(shape, ksize):
    assert np.array_equal(raster.element(shape, ksize).numpy(), structuring_element(shape, ksize))


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_portbench_blur_fixed_point(ksize):
    img = torch.from_numpy(np.random.default_rng(ksize).integers(0, 256, (2, 37, 45), dtype=np.uint8))
    assert torch.equal(raster.blur(img, ksize), gaussian_blur_u8_plain(img, ksize))


@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("seed,h,w", [(1, 64, 96), (2**33 + 5, 150, 211), (7, 97, 130)])
def test_portbench_frontend_reference(mix, seed, h, w):
    imgs = images(mix, seed, h, w)
    edges, skels = raster_frontend(imgs, CENTRES, k=4)
    ref = raster.frontend(imgs, CENTRES, 4, near_tie=0.01)
    assert torch.equal(edges, ref["edges"] * 255) and torch.equal(skels, ref["skeletons"])
    assert raster.judge(edges, skels, ref, 120) == {"edges_off": 0, "skeletons_off": 0}
    assert int(ref["edges"].count_nonzero()) > 0 and len(ref["counts"]["k6_iterations"]) == 8


def _other_choice(imgs, near_tie):
    """The front-end with each pixel labelled by the last centre within
    ``near_tie`` of its nearest (the reference takes the first)."""
    out = {"edges": [], "skeletons": []}
    k = len(CENTRES)
    for img in imgs:
        near = raster.nearest(img, CENTRES, near_tie)[1]
        last = k - 1 - near.flip(-1).to(torch.int64).argmax(-1)
        masks = (last == torch.arange(k)[:, None, None]).to(torch.uint8)
        m = raster.morphology(masks, raster.frontend_steps(), img.shape[1])
        edges = raster.hysteresis(*raster.canny_candidates(raster.blur(m * 255, 7), 22, 70))
        out["edges"].append(edges * 255)
        out["skeletons"].append(raster.thin(edges, 120)[0])
    return torch.stack(out["edges"]), torch.stack(out["skeletons"])


@pytest.mark.parametrize("mix,seed,near_tie", [("photo", 3, 40.0), ("photo", 2**31 + 9, 150.0), ("poster", 4, 300.0)])
def test_portbench_judge_takes_either_near_tie(mix, seed, near_tie):
    """With a wide ``near_tie`` many pixels have a choice: the other choice
    changes the edges and skeletons, and passes; one edge byte altered where
    the bounds agree, or one skeleton byte away from every difference of the
    edges, fails."""
    imgs = images(mix, seed, 90, 120)
    ref = raster.frontend(imgs, CENTRES, 4, near_tie=near_tie)
    edges, skels = _other_choice(imgs, near_tie)
    assert ref["counts"]["near_ties"] > 0 and not torch.equal(edges, ref["edges"] * 255)
    assert raster.judge(edges, skels, ref, 120) == {"edges_off": 0, "skeletons_off": 0}
    settled = (ref["edges_lo"] == ref["edges_hi"]).nonzero()
    bad = edges.clone()
    bad[tuple(settled[len(settled) // 2])] ^= 255
    assert raster.judge(bad, skels, ref, 120)["edges_off"] == 1
    on = (edges != 0).to(torch.uint8)
    zone = raster.reconstruct(on | ref["edges"], on ^ ref["edges"], 240)
    far = ((raster.dilate_square(zone, 2) == 0) & (skels == 0)).nonzero()
    bad = skels.clone()
    bad[tuple(far[len(far) // 3])] = 1
    assert raster.judge(edges, bad, ref, 120) == {"edges_off": 0, "skeletons_off": 1}


def test_portbench_judge_counts_wrong_forms():
    imgs = images("poster", 5, 40, 50)
    ref = raster.frontend(imgs, CENTRES, 4, near_tie=0.01)
    edges, skels = raster_frontend(imgs, CENTRES, k=4)
    n = ref["edges"].numel()
    assert raster.judge(edges[:1], skels, ref, 120) == {"edges_off": n, "skeletons_off": n}
    assert raster.judge(edges.to(torch.int32), skels, ref, 120) == {"edges_off": n, "skeletons_off": n}
    assert raster.judge(edges // 255, skels, ref, 120)["edges_off"] == int(ref["edges"].sum())
    assert raster.judge(edges, skels * 7, ref, 120)["skeletons_off"] == int(ref["skeletons"].sum())


@pytest.mark.parametrize("mix", MIXES)
def test_portbench_images_from_the_seed(mix):
    a, b = images(mix, 5, 120, 160), images(mix, 5, 120, 160)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    assert not torch.equal(a, images(mix, 6, 120, 160))
    assert len(torch.unique(a[0].reshape(-1, 3), dim=0)) > (1000 if mix == "photo" else 10)


@pytest.mark.parametrize("mix", MIXES)
def test_portbench_seeds_shoot_the_same_scenes(mix):
    """Two seeds give other bytes of the same scenes: turned back by their
    shots' flips, the two images agree where their windows of the scene
    overlap, and differ as a whole."""
    m, h, w = PARAMS[mix]["shift_px"], 120, 160
    seeds = (5, 2**31 + 6)
    a, b = (images(mix, s, h, w, n=3) for s in seeds)
    for i in range(3):
        views = []
        for s, x in zip(seeds, (a[i], b[i])):
            dy, dx, fy, fx = shot(s, i, m)
            views.append((dy, dx, x.flip([d for d, f in ((0, fy), (1, fx)) if f])))
        (ya, xa, va), (yb, xb, vb) = views
        y0, x0 = max(ya, yb), max(xa, xb)
        y1, x1 = min(ya, yb) + h, min(xa, xb) + w
        assert torch.equal(va[y0 - ya : y1 - ya, x0 - xa : x1 - xa], vb[y0 - yb : y1 - yb, x0 - xb : x1 - xb])
        assert not torch.equal(a[i], b[i])
