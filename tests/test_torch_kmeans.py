"""The port's k-means (``plotweave_torch/ops/kmeans.py``, the plain versions
of kernel K8), stage 02's device mode and K7 with counts, on the CPU, against
the JAX package on the same numpy inputs.

Tolerances: centres within 1e-3 absolute (float32 sums of a few thousand rows
taken in another order).  The compactness is a sum of distances in the
expanded form ``|x|² − 2·x·c + |c|²``, whose three terms are near 1e5 where
the distance is near 10, so each row carries a rounding error of about an ulp
of ``|x|²`` that depends on the order and contraction of the products (XLA's
dot against the port's written-out sum; either is up to 3e-4 relative off the
float64 value on these blobs): it is compared within half an ulp of the
largest ``|x|²`` per row (:func:`comp_tol`), not the 1e-5 relative that holds
between the kernel and its plain version, which share every operation.
Labels, counts and masks are equal wherever the float64 gap between a
pixel's two nearest centres exceeds the near-tie rule's 0.01.
"""

from __future__ import annotations

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import kmeans as jkm
from plotweave_torch.ops import kmeans as tkm
from plotweave_torch.ops.frontend import assign_boards_counts, nearest_gaps
from plotweave_torch.ops.thinning import unpack_bitboards_plain

BLOBS = [(20, 20, 20), (80, 100, 120), (200, 128, 128), (240, 200, 180)]
NEAR_TIE = 0.01
SUBSAMPLE = 5000  # kmeans_sample_limit of the runner's subsampled device-mode runs (the image has 12,288 pixels)


def blobs(seed: int = 0, n: int = 500) -> np.ndarray:
    g = np.random.default_rng(seed)
    return np.concatenate([g.normal(c, 2.0, size=(n, 3)) for c in BLOBS]).astype(np.float32)


def comp_tol(sample: np.ndarray) -> float:
    """Half an ulp of the largest |x|² for every row."""
    return 0.5 * len(sample) * float(np.spacing(np.float32((sample.astype(np.float64) ** 2).sum(1).max())))


def jax_lloyd(sample, init, iters):
    centers, comp = jkm._lloyd(jnp.asarray(sample), jnp.asarray(init), iters)
    return np.asarray(centers), float(comp)


@pytest.mark.parametrize("iters", [1, 40])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lloyd_plain_matches_jax_on_blobs(seed, iters):
    sample = blobs(seed)
    init = jkm._kpp_init(sample, 4, np.random.default_rng(seed + 7))
    ref_c, ref_comp = jax_lloyd(sample, init, iters)
    got_c, got_comp, it = tkm.lloyd_plain(torch.from_numpy(sample), torch.from_numpy(init), iters)
    np.testing.assert_allclose(got_c.numpy(), ref_c, atol=1e-3, rtol=0)
    assert abs(float(got_comp) - ref_comp) <= comp_tol(sample)
    assert 1 <= it <= iters


@pytest.mark.parametrize("iters", [1, 40])
def test_lloyd_plain_empty_cluster_keeps_its_centre(iters):
    sample = blobs(3)
    init = np.array([BLOBS[0], BLOBS[1], BLOBS[2], (-5000, -5000, -5000)], np.float32)  # the last wins no point
    ref_c, ref_comp = jax_lloyd(sample, init, iters)
    got_c, got_comp, _ = tkm.lloyd_plain(torch.from_numpy(sample), torch.from_numpy(init), iters)
    np.testing.assert_array_equal(got_c.numpy()[3], init[3])
    np.testing.assert_allclose(got_c.numpy(), ref_c, atol=1e-3, rtol=0)
    assert abs(float(got_comp) - ref_comp) <= comp_tol(sample)


def test_lloyd_plain_zero_iterations_returns_the_seeds():
    sample = blobs(4)
    init = sample[[0, 600, 1200, 1800]]
    ref_c, ref_comp = jax_lloyd(sample, init, 0)
    got_c, got_comp, it = tkm.lloyd_plain(torch.from_numpy(sample), torch.from_numpy(init), 0)
    assert it == 0
    np.testing.assert_array_equal(got_c.numpy(), ref_c)
    assert abs(float(got_comp) - ref_comp) <= comp_tol(sample)


def test_lloyd_fits_first_of_least_compactness_wins():
    sample = torch.from_numpy(blobs(5))
    good = torch.tensor(BLOBS, dtype=torch.float32)
    bad = torch.tensor([BLOBS[0], BLOBS[0], BLOBS[0], BLOBS[0]], dtype=torch.float32) + torch.arange(4)[:, None] * 0.01
    inits = torch.stack([bad, good, good])
    best, centers, comp, iters = tkm.lloyd_fits(sample, inits, 1)
    assert comp[1] == comp[2] < comp[0] and iters.dtype == torch.int32
    assert torch.equal(best, centers[1])
    out = torch.empty(12)
    assert torch.equal(tkm.lloyd_fits(sample, inits, 1, out=out)[0], best) and torch.equal(out.view(4, 3), best)


@pytest.mark.parametrize("limit", [200_000, 700])
def test_kmeans_matches_jax(limit):
    data = blobs(6)
    ref_c, ref_l = jkm.kmeans(data, 4, sample_limit=limit)
    got_c, got_l = tkm.kmeans(data, 4, sample_limit=limit, device="cpu")
    np.testing.assert_allclose(got_c, ref_c, atol=1e-3, rtol=0)
    assert got_l.dtype == np.int32
    np.testing.assert_array_equal(got_l, ref_l)  # separable: no near tie
    again_c, again_l = tkm.kmeans(data, 4, sample_limit=limit, device="cpu")
    assert np.array_equal(again_c, got_c) and np.array_equal(again_l, got_l)
    assert tkm.kmeans(data, 4, sample_limit=limit, assign=False, device="cpu")[1] is None


def test_kmeans_labels_equal_off_near_ties():
    rng = np.random.default_rng(8)
    data = rng.uniform(0, 255, (4000, 3)).astype(np.float32)  # no structure: many near ties
    ref_c, ref_l = jkm.kmeans(data, 5, iters=3)
    got_c, got_l = tkm.kmeans(data, 5, iters=3, device="cpu")
    np.testing.assert_allclose(got_c, ref_c, atol=1e-3, rtol=0)
    d = np.sort(((data[:, None, :].astype(np.float64) - ref_c.astype(np.float64)) ** 2).sum(-1), axis=1)
    clear = d[:, 1] - d[:, 0] > 1.0
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_l[clear], ref_l[clear])


def test_kmeans_auto_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="raster_device='auto'"):
        tkm.kmeans(blobs(0), 4)


def test_kpp_init_copy_is_the_jax_packages():
    sample = blobs(9)
    for seed in range(3):
        np.testing.assert_array_equal(tkm._kpp_init(sample, 4, np.random.default_rng(seed)),
                                      jkm._kpp_init(sample, 4, np.random.default_rng(seed)))


# --- the device mode's seed stream and seeding -----------------------------------


def test_seed_stream_is_deterministic_per_seed():
    a, b = tkm.seed_stream(42, 3, 4, 1000), tkm.seed_stream(42, 3, 4, 1000)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.int32 and a[1].dtype == torch.float32 and tuple(a[1].shape) == (3, 3)
    assert int(a[0].min()) >= 0 and int(a[0].max()) < 1000 and float(a[1].min()) >= 0 and float(a[1].max()) < 1
    c = tkm.seed_stream(43, 3, 4, 1000)
    assert not torch.equal(a[1], c[1])
    assert len({float(u[0]) for u in a[1]}) == 3  # attempts differ
    # the subsample: hashed keys drawn on the image's device, the least 700 in increasing index order
    idx = tkm.subsample_indices(42, 5000, 700)
    assert idx.dtype == torch.int32 and idx.numel() == 700 and int(idx.min()) >= 0 and int(idx.max()) < 5000
    assert bool((idx[1:] > idx[:-1]).all())
    assert torch.equal(idx, tkm.subsample_indices(42, 5000, 700, "cpu"))
    assert not torch.equal(idx, tkm.subsample_indices(41, 5000, 700))
    keys = tkm.draw_keys(42, 5000)
    assert int(keys[idx.long()].max()) < int(keys[torch.ones(5000, dtype=torch.bool).index_fill_(0, idx.long(), False)].min())


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_kpp_init_plain_per_seed(k):
    sample = torch.from_numpy(blobs(10, 300))  # 1200 rows: 2 rows a lane, the last lanes empty
    first, uniforms = tkm.seed_stream(5, 2, k, sample.shape[0])
    centers, picks = tkm.kpp_init(sample, k, first, uniforms)
    again, picks2 = tkm.kpp_init(sample, k, first, uniforms)
    assert torch.equal(centers, again) and torch.equal(picks, picks2)
    assert tuple(centers.shape) == (2, k, 3) and picks.dtype == torch.int32
    assert torch.equal(centers, sample[picks.long()])  # every centre is a row of the sample
    assert torch.equal(picks[:, 0], first)
    if k > 1:
        other = tkm.kpp_init(sample, k, *tkm.seed_stream(6, 2, k, sample.shape[0]))[1]
        assert not torch.equal(other, picks)


def test_kpp_init_plain_all_coincident_sample():
    sample = torch.full((300, 3), 7.0)
    centers, picks = tkm.kpp_init_plain(sample, 4, 17, torch.tensor([0.0, 0.5, 0.999999]))
    assert torch.equal(centers, sample[:4]) and picks[0] == 17
    assert 0 <= int(picks.min()) and int(picks.max()) < 300  # weights max(0, 1e-12): a uniform draw, no 0 / 0
    assert int(picks[1]) == 0 and int(picks[3]) == 299


def test_kpp_init_plain_edges_of_the_running_sum():
    sample = torch.from_numpy(blobs(11, 300))
    n = sample.shape[0]
    lo = tkm.kpp_init_plain(sample, 2, 0, torch.tensor([0.0]))[1]
    assert int(lo[1]) == 0  # u = 0: row 0's own weight, max(floor(0 * 2^16), 1) = 1, already exceeds 0
    hi = tkm.kpp_init_plain(sample, 2, 0, torch.tensor([1.0]))[1]  # floor(total * 1) = total: no running sum exceeds it
    assert int(hi[1]) == n - 1
    # in between: the first row whose integer running sum exceeds floor(total * u), in Python integers
    e = sample - sample[0]
    w = [max(min(int(float(x) * 65536), 2**36), 1) for x in (e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1]) + e[:, 2] * e[:, 2]]
    total = sum(w)
    for u in (2.0**-24, 0.25, 0.5, 0.999999):
        target = int(total * u)  # u is a dyadic float: exact here
        run, want = 0, None
        for i, x in enumerate(w):
            run += x
            if run > target:
                want = i
                break
        assert int(tkm.kpp_init_plain(sample, 2, 0, torch.tensor([u]))[1][1]) == want


def test_kpp_init_plain_second_draw_follows_d2_weights():
    # three point masses: the first centre at A, the second at B or C with probability ∝ n d²
    a, b, c = (0.0, 0.0, 0.0), (3.0, 0.0, 0.0), (0.0, 4.0, 0.0)
    sample = torch.tensor([a] * 40 + [b] * 30 + [c] * 50, dtype=torch.float32)
    p_b = 30 * 9.0 / (30 * 9.0 + 50 * 16.0)
    trials, hits = 2000, 0
    for seed in range(trials):
        g = torch.Generator().manual_seed(seed)
        u = torch.rand(1, generator=g, dtype=torch.float32)
        pick = int(tkm.kpp_init_plain(sample, 2, 0, u)[1][1])
        assert pick >= 40
        hits += pick < 70
    sigma = (trials * p_b * (1 - p_b)) ** 0.5
    assert abs(hits - trials * p_b) <= 3 * sigma, (hits, trials * p_b, sigma)


def test_kmeans_fit_device_recovers_blobs_and_repeats():
    sample = torch.from_numpy(blobs(12))
    a = tkm.kmeans_fit_device(sample, 4, 3, 40, 42)
    assert torch.equal(a, tkm.kmeans_fit_device(sample, 4, 3, 40, 42))
    for c in BLOBS:
        assert float((a - torch.tensor(c)).norm(dim=1).min()) < 1.0


def test_lab_sample_is_the_labs_of_the_indexed_pixels():
    from plotweave_torch.ops.colorspace import bgr_to_lab_u8

    rng = np.random.default_rng(13)
    img = torch.from_numpy(rng.integers(0, 256, (9, 11, 3), dtype=np.uint8))
    idx = torch.tensor([98, 0, 5, 5, 33], dtype=torch.int32)
    lab = bgr_to_lab_u8(img).reshape(-1, 3)
    # torch.pow's vector and scalar paths differ in the last bit, so a gathered pixel is not bit-equal to itself in place
    torch.testing.assert_close(tkm.lab_sample(img, idx), lab[idx.long()], atol=1e-4, rtol=0)
    assert torch.equal(tkm.lab_sample(img), lab)
    with pytest.raises(ValueError):
        tkm.lab_sample(img, torch.tensor([99], dtype=torch.int32))


def test_dispatchers_raise_for_other_devices():
    meta = torch.empty((10, 3), device="meta")
    for call in (lambda: tkm.lloyd_fits(meta, meta[None, :4], 1), lambda: tkm.assign_points(meta, meta[:4]),
                 lambda: tkm.lab_sample(meta.to(torch.uint8))):
        with pytest.raises(ValueError):
            call()


# --- K7 with counts and the stage's tail -----------------------------------------


def _poster(seed: int, h: int, w: int, noise: int):
    import cv2

    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.int16)
    img[:, :] = (235, 230, 225)
    for _ in range(10):
        c = [(20, 20, 20), (40, 60, 200), (140, 180, 220)][int(rng.integers(0, 3))]
        canvas = np.zeros((h, w, 3), np.uint8)
        cv2.circle(canvas, (int(rng.integers(0, w)), int(rng.integers(0, h))), int(rng.integers(5, 25)), (1, 1, 1), -1)
        img = np.where(canvas > 0, np.array(c, np.int16), img)
    if noise:
        img = img + rng.integers(-noise, noise + 1, img.shape, dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("noise", [0, 40])
def test_assign_tail_matches_jax(noise):
    from plotweave.ops.colorspace import bgr_to_lab_u8 as jax_lab
    from plotweave.stages.s02_color_extract import _assign_tail
    from plotweave_torch.stages.s02_color_extract import assign_tail

    img = _poster(14, 61, 83, noise)
    centers = np.array([[40, 128, 128], [110, 160, 150], [190, 140, 150], [235, 128, 130]], np.float32)
    stats, ref_packed, ref_masks = _assign_tail(jax_lab(jnp.asarray(img)), jnp.asarray(centers), 4, 1, 1)
    ref_counts = np.ascontiguousarray(np.asarray(stats)[:, 3]).view(np.int32)
    counts, packed, masks_b = assign_tail(torch.from_numpy(img), torch.from_numpy(centers), 4, 1, 1)
    assert counts.dtype == torch.int32 and int(counts.sum()) == img.shape[0] * img.shape[1]
    dense = unpack_bitboards_plain(masks_b, img.shape[1]).numpy().astype(np.uint8) * 255
    np.testing.assert_array_equal(np.unpackbits(packed.numpy(), axis=-1)[..., : img.shape[1]] * 255, dense)
    gaps = nearest_gaps(img.reshape(-1, 3), centers)
    ties = int((gaps <= NEAR_TIE).sum())
    if noise == 0:
        assert ties == 0
        np.testing.assert_array_equal(counts.numpy(), ref_counts)
        np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_packed))
        np.testing.assert_array_equal(dense, np.asarray(ref_masks))
    else:
        assert np.abs(counts.numpy() - ref_counts).sum() <= 2 * ties
        # a flipped pixel changes the cleaned masks only within the 3x3 open and close around it
        assert (dense != np.asarray(ref_masks)).sum() <= 4 * 25 * ties


def test_assign_boards_counts_is_the_bincount_of_the_labels():
    from plotweave_torch.ops.frontend import assign_nearest, onehot_boards

    img = torch.from_numpy(_poster(15, 40, 70, 30))
    centers = np.array([[40, 128, 128], [110, 160, 150], [235, 128, 130]], np.float32)
    out = torch.empty(3, dtype=torch.int32)
    boards, counts = assign_boards_counts(img, centers, 3, out)
    labels = assign_nearest(img, centers, 3)
    assert counts is out and torch.equal(counts, torch.bincount(labels.reshape(-1).long(), minlength=3).to(torch.int32))
    assert torch.equal(boards, onehot_boards(labels, 3))
    with pytest.raises(ValueError):
        assign_boards_counts(img[None], centers, 3)


def test_device_init_stage_blob_layout():
    from plotweave_torch.stages.s02_color_extract import assign_tail, chain_tail, device_init_stage

    img = torch.from_numpy(_poster(16, 50, 75, 0))
    k, (h, w) = 4, img.shape[:2]
    w8 = -(-w // 8)
    params = (3, 1, 1, 5, 22, 70)
    blob, masks_b = device_init_stage(img, k, 40, 3, 2000, 42, True, *params)
    assert blob.dtype == torch.uint8 and blob.numel() == 16 * k + 3 * k * h * w8
    centers = blob[: 12 * k].view(torch.float32).view(k, 3)
    sample = tkm.lab_sample(img, tkm.subsample_indices(42, h * w, 2000))
    assert torch.equal(centers, tkm.kmeans_fit_device(sample, k, 3, 40, 42))
    counts, packed, ref_b = assign_tail(img, centers, k, 1, 1)
    assert torch.equal(blob[12 * k : 16 * k].view(torch.int32), counts) and torch.equal(masks_b, ref_b)
    assert torch.equal(blob[16 * k : 16 * k + k * h * w8], packed.reshape(-1))
    assert torch.equal(blob[16 * k + k * h * w8 :], chain_tail(masks_b, w, *params).reshape(-1))
    unfused, _ = device_init_stage(img, k, 40, 3, 2000, 42, False)
    assert torch.equal(unfused, blob[: 16 * k + k * h * w8])
    whole, _ = device_init_stage(img, k, 40, 3, h * w, 42, False)  # no subsample: every pixel in order
    assert torch.equal(whole[: 12 * k].view(torch.float32).view(k, 3),
                       tkm.kmeans_fit_device(tkm.lab_sample(img), k, 3, 40, 42))


# --- through the runner ------------------------------------------------------------


def _tiny_cfg(tmp_path, tag: str, load, **extra):
    """The JAX handoff test's tiny separable image and config."""
    import cv2

    rng = np.random.default_rng(5)
    img = np.zeros((96, 128, 3), np.uint8)
    img[:, :] = (235, 230, 225)
    for _ in range(8):
        c = [(20, 20, 20), (40, 60, 200), (140, 180, 220)][int(rng.integers(0, 3))]
        cv2.circle(img, (int(rng.integers(0, 128)), int(rng.integers(0, 96))), int(rng.integers(5, 25)), c, -1)
    p = tmp_path / f"{tag}.png"
    cv2.imwrite(str(p), img)
    out = tmp_path / tag
    out.mkdir()
    cfg = {"input_image": str(p), "output_dir": str(out),
           "colors": [[20, 20, 20], [40, 60, 200], [140, 180, 220], [235, 230, 225]],
           "color_names": ["layer_dark", "layer_mid", "layer_skin", "layer_light"],
           "target_width_mm": 64, "target_height_mm": 48, "pixels_per_mm": 2, "pen_width_px": 8,
           "pen_radius_px": 4, **extra}
    (out / "config.json").write_text(json.dumps(cfg))
    return load(str(out / "config.json")), out


@pytest.fixture(scope="module")
def device_mode_runs(tmp_path_factory):
    from plotweave.config import load_config as jax_load
    from plotweave.pipeline import run_pipeline as jax_run
    from plotweave_torch.config import load_config
    from plotweave_torch.pipeline import run_pipeline

    base = tmp_path_factory.mktemp("torch_device_kmeans")
    cfg, exact = _tiny_cfg(base, "exact", load_config, raster_device="cpu")
    run_pipeline(cfg, 1, 13)
    cfg, device = _tiny_cfg(base, "device", load_config, raster_device="cpu", kmeans_init="device")
    run_pipeline(cfg, 1, 13)
    cfg, stepwise = _tiny_cfg(base, "stepwise", load_config, raster_device="cpu", kmeans_init="device")
    for step in range(1, 5):
        run_pipeline(cfg, step, step)
    cfg, jax_device = _tiny_cfg(base, "jax_device", jax_load, raster_device="cpu", kmeans_init="device")
    jax_run(cfg, 1, 13)
    # a subsample: 5,000 of the image's 12,288 pixels
    cfg, sub = _tiny_cfg(base, "sub", load_config, raster_device="cpu", kmeans_init="device",
                         kmeans_sample_limit=SUBSAMPLE)
    run_pipeline(cfg, 1, 13)
    cfg, jax_sub = _tiny_cfg(base, "jax_sub", jax_load, raster_device="cpu", kmeans_init="device",
                             kmeans_sample_limit=SUBSAMPLE)
    jax_run(cfg, 1, 13)
    return ({"exact": exact, "device": device, "stepwise": stepwise, "jax": jax_device, "sub": sub, "jax_sub": jax_sub},
            list(cfg.color_names))


def _same_artifacts(mine, ref, names, fname):
    import cv2

    if fname == "plot_stream.bin":
        assert (mine / fname).read_bytes() == (ref / fname).read_bytes()
        return
    for layer in names:
        if fname.endswith(".png"):
            a, b = cv2.imread(str(mine / layer / fname), 0), cv2.imread(str(ref / layer / fname), 0)
            assert a is not None and b is not None and a.any()
            np.testing.assert_array_equal(a, b, err_msg=layer)
        else:
            a = pickle.loads((mine / layer / fname).read_bytes())
            b = pickle.loads((ref / layer / fname).read_bytes())
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("other", ["exact", "jax"])
@pytest.mark.parametrize("fname", ["mask.png", "edges.png", "contours.pkl", "plot_stream.bin"])
def test_device_mode_through_the_runner(device_mode_runs, other, fname):
    """Twin of the JAX package's ``test_kmeans_device_init_mode``: on the
    separable image the device mode's artifacts equal the host-exact mode's,
    and the JAX package's device mode's."""
    outs, names = device_mode_runs
    _same_artifacts(outs["device"], outs[other], names, fname)


@pytest.mark.parametrize("other", ["exact", "jax", "jax_sub"])
@pytest.mark.parametrize("fname", ["mask.png", "edges.png", "contours.pkl", "plot_stream.bin"])
def test_device_mode_with_a_subsample_through_the_runner(device_mode_runs, other, fname):
    """The device mode with ``kmeans_sample_limit`` below the image's pixels,
    so the subsample is drawn (the port's hashed keys; the JAX package's
    ``jax.random.choice``): on the separable image its artifacts equal the
    host-exact mode's and the JAX package's device mode's, with and without
    a subsample."""
    outs, names = device_mode_runs
    _same_artifacts(outs["sub"], outs[other], names, fname)


def test_device_mode_palette_matches_jax(device_mode_runs):
    outs, _ = device_mode_runs
    mine = json.loads((outs["device"] / "palette_by_name.json").read_text())
    ref = json.loads((outs["jax"] / "palette_by_name.json").read_text())
    assert mine.keys() == ref.keys()
    for name in mine:
        assert mine[name]["pixels"] == ref[name]["pixels"] and mine[name]["mask_nonzero"] == ref[name]["mask_nonzero"]
        assert np.abs(np.array(mine[name]["cluster_lab"]) - np.array(ref[name]["cluster_lab"])).max() <= 1


@pytest.mark.parametrize("fname", ["mask.png", "edges.png", "contours.pkl"])
def test_device_mode_stepwise_equals_chained(device_mode_runs, fname):
    """Stages 1 to 4 run one by one (the masks and edges handed over through
    the device-artifact registry) write what the fused run writes."""
    import cv2

    outs, names = device_mode_runs
    for layer in names:
        a, b = outs["device"] / layer / fname, outs["stepwise"] / layer / fname
        if fname.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(str(a), 0), cv2.imread(str(b), 0), err_msg=layer)
        else:
            x, y = pickle.loads(a.read_bytes()), pickle.loads(b.read_bytes())
            assert len(x) == len(y) and all(np.array_equal(np.asarray(p), np.asarray(q)) for p, q in zip(x, y))


def test_device_mode_hands_masks_and_edges_over_on_the_device(tmp_path):
    from plotweave_torch.config import load_config
    from plotweave_torch.pipeline import run_pipeline
    from plotweave_torch.stages.s03_edge_detect import device_boards
    from plotweave_torch.utils import fetch_device_artifact

    cfg, out = _tiny_cfg(tmp_path, "handoff", load_config, raster_device="cpu", kmeans_init="device")
    run_pipeline(cfg, 1, 1)
    out = out.resolve()
    assert isinstance(fetch_device_artifact(str(out / "resized.png")), torch.Tensor)
    run_pipeline(cfg, 2, 2)
    masks = [str(out / n / "mask.png") for n in cfg.color_names]
    held = device_boards(masks, torch.device("cpu"))
    assert held is not None and tuple(held[0].shape) == (4, 96, 4) and held[1] == 128
    run_pipeline(cfg, 3, 3)
    assert device_boards([str(out / n / "edges.png") for n in cfg.color_names], torch.device("cpu")) is not None
    # a mask rewritten on disk is stale in the registry: stage 03 reads the file
    import cv2

    cv2.imwrite(masks[0], np.zeros((96, 128), np.uint8))
    assert device_boards(masks, torch.device("cpu")) is None
