"""The port's copies of the colour tools (``plotweave_torch/tools``) against
the JAX package's on the same seeded images: they share the numpy subsample
and k-means++ stream, so the clusters agree within the k-means tolerance
(centres rounded to integers, coverages to 1e-4) and the label maps are equal
on these separable images.
"""

from __future__ import annotations

import json

import cv2
import numpy as np
import pytest


def _bands(tmp_path, seed: int):
    rng = np.random.default_rng(seed)
    img = np.zeros((60, 80, 3), np.uint8)
    img[:30] = (200, 30, 30)
    img[30:, :40] = (30, 200, 30)
    img[30:, 40:] = (30, 30, 200)
    img = np.clip(img.astype(np.int16) + rng.integers(-8, 9, img.shape), 0, 255).astype(np.uint8)
    p = tmp_path / "img.png"
    cv2.imwrite(str(p), img)
    return p


@pytest.mark.parametrize("seed", [3, 4])
def test_split_layers_matches_jax_package(tmp_path, seed):
    from plotweave.tools.process_colors import split_layers as jax_split
    from plotweave_torch.tools.process_colors import split_layers

    p = _bands(tmp_path, seed)
    ref = jax_split(str(p), str(tmp_path / "jax"), k=3)
    got = split_layers(str(p), str(tmp_path / "port"), k=3, device="cpu")
    assert got == ref
    np.testing.assert_array_equal(np.load(tmp_path / "port" / "labels.npy"), np.load(tmp_path / "jax" / "labels.npy"))
    for f in sorted((tmp_path / "jax").glob("layer_*.png")):
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / f.name), 0), cv2.imread(str(f), 0))
    assert json.loads((tmp_path / "port" / "palette.json").read_text()) == got


def test_split_layers_palette_mode_and_cli(tmp_path, capsys):
    from plotweave_torch.tools.process_colors import main, split_layers

    img = np.zeros((20, 20, 3), np.uint8)
    img[:10] = (250, 10, 10)
    img[10:] = (10, 10, 250)
    p = tmp_path / "img.png"
    cv2.imwrite(str(p), img)
    pal_path = tmp_path / "pal.json"
    pal_path.write_text(json.dumps({"recommended_markers": [{"name": "red", "rgb": [250, 10, 10]},
                                                            {"name": "blue", "rgb": [10, 10, 250]}]}))
    pal = split_layers(str(p), str(tmp_path / "layers"), palette_json=str(pal_path))  # no k-means: no device
    assert [c["name"] for c in pal["colors"]] == ["red", "blue"]
    labels = np.load(tmp_path / "layers" / "labels.npy")
    assert (labels[:10] == 1).all() and (labels[10:] == 0).all()
    main([str(p), "-o", str(tmp_path / "cli"), "-k", "2", "--raster-device", "cpu"])
    assert "pixels=200" in capsys.readouterr().out


def test_analyze_matches_jax_package(tmp_path):
    from plotweave.tools.analyze_colors import analyze as jax_analyze
    from plotweave_torch.tools.analyze_colors import analyze, main

    rng = np.random.default_rng(4)
    img = np.zeros((50, 70, 3), np.uint8)
    img[:25] = (40, 60, 200)
    img[25:] = (200, 160, 40)
    img = np.clip(img.astype(np.int16) + rng.integers(-10, 11, img.shape), 0, 255).astype(np.uint8)
    p = tmp_path / "img.png"
    cv2.imwrite(str(p), img)
    ref = jax_analyze(str(p), k=3, n_recommend=2)
    got = analyze(str(p), k=3, n_recommend=2, device="cpu")
    assert got == analyze(str(p), k=3, n_recommend=2, device="cpu")
    assert got["hue_histogram"] == ref["hue_histogram"] and got["recommended_markers"] == ref["recommended_markers"]
    assert len(got["clusters"]) == 3
    for a, b in zip(got["clusters"], ref["clusters"]):
        assert np.abs(np.array(a["rgb"]) - np.array(b["rgb"])).max() <= 1 and abs(a["coverage"] - b["coverage"]) <= 1e-3
    main([str(p), "-k", "3", "-n", "2", "--raster-device", "cpu"])
    assert json.loads((tmp_path / "img_colors.json").read_text()) == got


def test_marker_palette_matches_jax_package():
    from plotweave.tools.palette import MarkerPalette as JaxPalette
    from plotweave_torch.tools.palette import MARKER_SET_24, MarkerPalette

    ref, got = JaxPalette(), MarkerPalette()
    assert [c.name for c in got.colors] == [c.name for c in ref.colors] and len(MARKER_SET_24) == 24
    np.testing.assert_allclose(got._lab, np.asarray(ref._lab), atol=1e-3, rtol=0)
    rng = np.random.default_rng(2)
    for rgb in rng.integers(0, 256, (40, 3)):
        a, b = got.nearest(tuple(int(v) for v in rgb)), ref.nearest(tuple(int(v) for v in rgb))
        assert a[0].name == b[0].name and abs(a[1] - b[1]) <= 1e-2
    clusters = rng.integers(0, 256, (6, 3)).astype(np.float32)
    cov = rng.random(6)
    assert [(m.name, c) for m, c in got.recommend(clusters, cov)] == [(m.name, c) for m, c in ref.recommend(clusters, cov)]


def test_tools_on_the_card_by_default(tmp_path):
    import torch

    from plotweave_torch.tools.analyze_colors import analyze

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="raster_device='auto'"):
        analyze(str(_bands(tmp_path, 1)), k=3)
