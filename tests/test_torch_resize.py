"""The port's INTER_AREA resize (``plotweave_torch/ops/resize.py``, the plain
versions of kernel K13) on the CPU, byte for byte against the JAX package's
``area_resize`` and against ``cv2.resize(..., INTER_AREA)`` on the same
seeded numpy images: the cases of ``tests/test_ops_raster.py`` (integer,
fractional, fractional fuzz, over 16 taps, the 4K scale, gray) and more
channel counts; the tap tables against the JAX package's; the no-op; a numpy
emulation of the kernel's per-thread order of float32 operations.
"""

from __future__ import annotations

import cv2
import numpy as np
import pytest
import torch

from plotweave.ops import resize as jresize
from plotweave_torch import ops as port_ops
from plotweave_torch.ops import kernels, resize


def _image(seed: int, h: int, w: int, c: int | None = 3) -> np.ndarray:
    shape = (h, w) if c is None else (h, w, c)
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.uint8)


def _check(img: np.ndarray, nw: int, nh: int, cv: bool = True) -> np.ndarray:
    """The port's area_resize on a CPU tensor == the JAX package's (== cv2's)."""
    got = resize.area_resize(torch.from_numpy(img), nw, nh)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    got = got.numpy()
    np.testing.assert_array_equal(got, np.asarray(jresize.area_resize(img, nw, nh)))
    if cv:
        ref = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)  # (h, w) for one channel
        np.testing.assert_array_equal(got, ref.reshape(got.shape))
    return got


INTEGER = [(100, 100, 2, 2), (120, 90, 3, 3), (64, 64, 4, 4), (90, 60, 3, 2), (40, 96, 2, 6), (75, 75, 5, 5),
           (48, 48, 6, 6), (7, 9, 7, 9)]


@pytest.mark.parametrize("h,w,sy,sx", INTEGER)
def test_integer_ratio_matches_jax_and_cv2(h, w, sy, sx):
    _check(_image(h * w + sy, h, w), w // sx, h // sy)


@pytest.mark.parametrize("area", [(3, 3), (6, 6), (2, 3)])
def test_integer_ratio_every_block_sum(area):
    """Every block sum 0..255·area once: the float32 quotient (the JAX
    package's ``float64`` is float32 without x64) and its half-even rounding
    at every tie, against the JAX package and cv2."""
    sy, sx = area
    n = 255 * sy * sx + 1
    blocks = np.zeros((n, sy * sx), np.int64)
    for i in range(n):  # spread sum i over the block's pixels
        q, r = divmod(i, sy * sx)
        blocks[i] = q + (np.arange(sy * sx) < r)
    side = int(np.ceil(np.sqrt(n)))
    pad = np.zeros((side * side, sy * sx), np.int64)
    pad[:n] = blocks
    img = pad.reshape(side, side, sy, sx).transpose(0, 2, 1, 3).reshape(side * sy, side * sx).astype(np.uint8)
    got = _check(img, side, side)
    want = np.array([(i + 2) >> 2 if (sy, sx) == (2, 2) else np.float32(i) / np.float32(sy * sx)
                     for i in range(n)])
    np.testing.assert_array_equal(got.reshape(-1)[:n], np.clip(np.rint(want), 0, 255).astype(np.uint8))


FRACTIONAL = [(333, 517, 166, 258), (97, 311, 31, 99), (640, 480, 512, 384), (100, 100, 99, 99), (50, 61, 50, 30),
              (61, 50, 30, 50)]


@pytest.mark.parametrize("h,w,nh,nw", FRACTIONAL)
def test_fractional_ratio_matches_jax_and_cv2(h, w, nh, nw):
    _check(_image(h + w, h, w), nw, nh)


def _fuzz_cases():
    r = np.random.default_rng(17)
    out = []
    for _ in range(25):
        h, w = int(r.integers(40, 500)), int(r.integers(40, 500))
        out.append((h, w, int(r.integers(8, h)), int(r.integers(8, w))))
    return out


@pytest.mark.parametrize("h,w,nh,nw", _fuzz_cases())
def test_fractional_fuzz_matches_jax_and_cv2(h, w, nh, nw):
    _check(_image(h * 7 + w, h, w), nw, nh)


@pytest.mark.parametrize("h,w,nh,nw", [(1813, 397, 89, 97), (997, 211, 23, 11), (800, 600, 9, 7)])
def test_over_16_taps_matches_jax_and_cv2(h, w, nh, nw):
    """Ratios whose tables exceed the JAX package's 16-tap chunks: its cut
    groups keep the global add order, and so does the port's one pass."""
    assert max(resize._resize_area_tab(h, nh)[0].shape[1], resize._resize_area_tab(w, nw)[0].shape[1]) > 16
    _check(_image(h, h, w), nw, nh)


def test_4k_scale_matches_jax_and_cv2():
    _check(_image(4, 540, 960), 500, 281)


@pytest.mark.parametrize("h,w,nh,nw", [(80, 120, 40, 60), (80, 120, 33, 47), (37, 1000, 3, 100)])
def test_gray_matches_jax_and_cv2(h, w, nh, nw):
    got = _check(_image(h, h, w, None), nw, nh)
    assert got.shape == (nh, nw)


@pytest.mark.parametrize("c", [1, 2, 4])
@pytest.mark.parametrize("ratio", ["integer", "fractional"])
def test_channel_counts_match_jax(c, ratio):
    img = _image(c, 60, 90, c)
    nw, nh = (45, 30) if ratio == "integer" else (41, 29)
    _check(img, nw, nh, cv=c != 2)  # cv2 takes 1, 3 and 4 channels


@pytest.mark.parametrize("ssize,dsize", [(517, 258), (311, 99), (4032, 2000), (3024, 1500), (8000, 97), (6000, 73),
                                         (480, 384), (100, 99), (1000, 3)])
def test_tap_tables_equal_jax(ssize, dsize):
    si, al = resize._resize_area_tab(ssize, dsize)
    jsi, jal = jresize._resize_area_tab(ssize, dsize)
    assert si.dtype == jsi.dtype == np.int32 and al.dtype == jal.dtype == np.float32
    np.testing.assert_array_equal(si, jsi)
    np.testing.assert_array_equal(al.view(np.uint32), jal.view(np.uint32))


def _kernel_emulation(img: np.ndarray, nw: int, nh: int) -> np.ndarray:
    """K13's fractional route thread by thread, in numpy float32: for each
    output pixel and channel, acc = 0; per vertical tap hb = 0, hb += x·xal
    per horizontal tap, acc += hb·yal; rint; clip."""
    x = img if img.ndim == 3 else img[:, :, None]
    xsi, xal = resize._resize_area_tab(x.shape[1], nw)
    ysi, yal = resize._resize_area_tab(x.shape[0], nh)
    xf = x.astype(np.float32)
    acc = np.zeros((nh, nw, x.shape[2]), np.float32)
    for v in range(ysi.shape[1]):
        rows = xf[ysi[:, v]]  # (nh, W, C)
        hb = np.zeros_like(acc)
        for t in range(xsi.shape[1]):
            hb = hb + rows[:, xsi[:, t], :] * xal[None, :, t, None]
        acc = acc + hb * yal[:, v, None, None]
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[:, :, 0]


@pytest.mark.parametrize("h,w,nh,nw", [(333, 517, 166, 258), (403, 302, 200, 150), (1813, 397, 89, 97)])
def test_kernel_order_of_operations_matches_plain(h, w, nh, nw):
    """The kernel's order (horizontal sum per vertical tap, starting from an
    exact 0) gives the plain version's bytes: every term is ≥ 0, so 0 + the
    first product is that product."""
    img = _image(nw, h, w)
    np.testing.assert_array_equal(_kernel_emulation(img, nw, nh), _check(img, nw, nh))


def test_no_op_returns_its_input():
    t = torch.from_numpy(_image(1, 30, 40))
    assert resize.area_resize(t, 40, 30) is t
    img = _image(2, 30, 40)
    same, changed = resize.resize_if_needed(img, 40)
    assert same is img and changed is False
    same, changed = resize.resize_if_needed(t, 100)
    assert same is t and changed is False
    jsame, jchanged = jresize.resize_if_needed(img, 40)
    assert jsame is img and jchanged is False


@pytest.mark.parametrize("shape,cap", [((300, 200, 3), 150), ((200, 300, 3), 100), ((400, 300), 151),
                                       ((3024, 4032, 3), 2000)])
def test_resize_if_needed_matches_jax(shape, cap):
    img = np.random.default_rng(cap).integers(0, 256, shape).astype(np.uint8)
    got, changed = resize.resize_if_needed(torch.from_numpy(img), cap)
    ref, jchanged = jresize.resize_if_needed(img, cap)
    assert changed is jchanged is True
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert max(got.shape[:2]) <= cap


def test_ndarray_input_goes_to_the_card_or_raises(monkeypatch):
    """An ndarray is uploaded to the card ("auto"): without one, an error, not
    a CPU fallback; a tensor stays on its device."""
    img = _image(3, 50, 70)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resize.area_resize(img, 35, 25)
    with pytest.raises(RuntimeError, match="CUDA"):
        resize.resize_if_needed(img, 35)
    got, changed = resize.resize_if_needed(torch.from_numpy(img), 35)
    assert changed and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(jresize.area_resize(img, 35, 25)))


def test_ops_exports_the_resize():
    assert port_ops.area_resize is resize.area_resize
    assert port_ops.resize_if_needed is resize.resize_if_needed


def test_wrappers_take_only_cuda_tensors():
    """On the CPU the plain versions run only because the tensor lies there:
    K13's wrappers refuse a CPU tensor instead of falling back."""
    img = torch.from_numpy(_image(5, 20, 30))
    si, al = (torch.from_numpy(a) for a in resize._resize_area_tab(30, 17))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.area_resize_frac_cuda(img, si, al, si, al)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.area_resize_int_cuda(img, 2, 2)
    assert kernels.LAUNCHES["area_resize_frac"] == kernels.LAUNCHES["area_resize_int"] == 0
