"""Bit-packed binary morphology (twin of ``plotweave/ops/morphology.py``).

Erode and dilate on 0/255 masks are AND/OR algebra on the int32 bitboards of
``ops/thinning.py``.  Dilation ORs the board shifted over the structuring
element (the zero fill is OpenCV's non-feeding border); erosion is
``~dilate(~x & valid) & valid``, so bits beyond the image read as set and do
not constrain it.  A step list ((shape, ksize, op), ...) chains such ops;
:func:`morph_steps` runs it through kernel K2 on a CUDA tensor and
:func:`morph_steps_plain` on a CPU tensor, and :func:`morph_bits` is one
program of the JAX package's signature as a step list.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .thinning import _shift_rows, _shift_words, lsr


def structuring_element(shape: str, ksize: int) -> np.ndarray:
    """Rect / ellipse / cross structuring element, OpenCV-compatible geometry
    (copied: the JAX module imports jax)."""
    if shape == "rect":
        return np.ones((ksize, ksize), dtype=bool)
    if shape == "cross":
        se = np.zeros((ksize, ksize), dtype=bool)
        se[ksize // 2, :] = True
        se[:, ksize // 2] = True
        return se
    if shape == "ellipse":
        r = ksize // 2
        c = r
        inv_r2 = 1.0 / (r * r) if r else 0.0
        se = np.zeros((ksize, ksize), dtype=bool)
        for i in range(ksize):
            dy = i - r
            if abs(dy) <= r:
                dx = int(np.rint(r * np.sqrt(max(0.0, (r * r - dy * dy) * inv_r2))))
                se[i, max(c - dx, 0) : min(c + dx + 1, ksize)] = True
        return se
    raise ValueError(f"unknown structuring element shape: {shape}")


def _shift_cols_bits(p: torch.Tensor, dx: int) -> torch.Tensor:
    """Bit j of the result = bit j+dx of the packed row (carries across word
    boundaries, zero fill); ``|dx|`` may exceed 1 for kernels wider than 3."""
    if dx == 0:
        return p
    if dx > 0:
        return lsr(p, dx) | (_shift_words(p, 1) << (32 - dx))
    return (p << -dx) | lsr(_shift_words(p, -1), 32 + dx)


def _dilate_bits(x: torch.Tensor, se: np.ndarray) -> torch.Tensor:
    ys, xs = np.nonzero(se)
    r = se.shape[0] // 2
    acc = None
    for dy, dx in zip(ys.tolist(), xs.tolist()):
        t = _shift_cols_bits(_shift_rows(x, dy - r), dx - r)
        acc = t if acc is None else (acc | t)
    return acc


@functools.lru_cache(maxsize=None)
def _valid_bits(w: int, device=None) -> torch.Tensor:
    """int32 word mask with bits [0, w) set (padding bits beyond w zero);
    made once per (w, device), so callers must not write to it."""
    nw = -(-w // 32)
    bits = (np.arange(nw * 32) < w).astype(np.uint64).reshape(nw, 32)
    weights = np.uint64(1) << np.arange(32, dtype=np.uint64)
    words = (bits * weights).sum(axis=-1).astype(np.uint32).view(np.int32)
    return torch.from_numpy(words.copy()).to(device)


def morph_program(shape: str, ksize: int, iterations: int, program: str) -> tuple:
    """``morph_bits``'s program as a step list: ((shape, ksize, op), ...),
    each char of ``program`` ('e' erode, 'd' dilate) repeated ``iterations``
    times."""
    return tuple((shape, ksize, op) for op in program for _ in range(iterations))


def morph_steps_plain(x: torch.Tensor, valid: torch.Tensor, steps) -> torch.Tensor:
    """A step list on bitboards, each step (shape, ksize, op) one dilation
    (op 'd') or erosion (any other op) by its element, in order: the chained
    calls of the JAX package's ``morph_bits``."""
    for shape, ksize, op in steps:
        se = structuring_element(shape, ksize)
        if op == "d":
            x = _dilate_bits(x, se)
        else:
            x = (~_dilate_bits((~x) & valid, se)) & valid
    return x


def morph_bits_plain(x: torch.Tensor, valid: torch.Tensor, shape: str, ksize: int,
                     iterations: int, program: str) -> torch.Tensor:
    """A morphology program on bitboards: each char of ``program`` is 'e'
    (erode) or 'd' (dilate), repeated ``iterations`` times."""
    return morph_steps_plain(x, valid, morph_program(shape, ksize, iterations, program))


def morph_steps(x: torch.Tensor, valid: torch.Tensor, steps) -> torch.Tensor:
    """:func:`morph_steps_plain`'s step list on (..., H, NW) int32 bitboards
    (``valid`` from :func:`_valid_bits`).  A CUDA tensor runs kernel K2
    (``ops/kernels.py``), the whole list in one launch at the defaults; a CPU
    tensor the plain version; any other device raises."""
    if x.is_cuda:
        from .kernels import morph_steps_cuda  # noqa: PLC0415

        return morph_steps_cuda(x, valid, steps)
    if x.device.type != "cpu":
        raise ValueError(f"morph_bits: no kernel for device {x.device}")
    return morph_steps_plain(x, valid, steps)


def morph_bits(x: torch.Tensor, valid: torch.Tensor, shape: str, ksize: int,
               iterations: int, program: str) -> torch.Tensor:
    """:func:`morph_bits_plain`'s program through :func:`morph_steps`."""
    return morph_steps(x, valid, morph_program(shape, ksize, iterations, program))
