"""Morphology, gray and bit-packed (twin of ``plotweave/ops/morphology.py``).

Gray (uint8) erosion and dilation over an arbitrary structuring element are
the minimum and maximum over its set cells; a read outside the image gives
255 to an erosion and 0 to a dilation (OpenCV's defaults: the border neither
constrains the one nor feeds the other), and the anchor is ``ksize // 2`` for
an even ``ksize`` too.  :func:`erode`, :func:`dilate`, :func:`morph_open` and
:func:`morph_close` run a whole program through kernel K11 on a CUDA tensor
(``ops/kernels.py``, ``csrc/morph_dense.cu``) and :func:`morph_plain` on a CPU
tensor.

Erode and dilate on 0/255 masks are AND/OR algebra on the int32 bitboards of
``ops/thinning.py``.  Dilation ORs the board shifted over the structuring
element (the zero fill is OpenCV's non-feeding border); erosion is
``~dilate(~x & valid) & valid``, so bits beyond the image read as set and do
not constrain it.  A step list ((shape, ksize, op), ...) chains such ops;
:func:`morph_steps` runs it through kernel K2 on a CUDA tensor and
:func:`morph_steps_plain` on a CPU tensor, and :func:`morph_bits` is one
program of the JAX package's signature as a step list.  Both take packed rows
(8 px a byte) in place of a board and can write the result's packed rows as
well: on the card K2's load and store convert, with no launch of K1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bitpack import boards_to_rows_plain, rows_to_boards_plain
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


def morph_steps_plain(x: torch.Tensor, valid: torch.Tensor, steps, width: int | None = None,
                      rows_out: torch.Tensor | None = None) -> torch.Tensor:
    """A step list on bitboards, each step (shape, ksize, op) one dilation
    (op 'd') or erosion (any other op) by its element, in order: the chained
    calls of the JAX package's ``morph_bits``.  ``x`` may be uint8 packed
    rows (..., H, ⌈width/8⌉) instead, converted first; ``rows_out`` (uint8,
    as many bytes as the rows) receives the result's packed rows.  Returns
    the result's board."""
    if x.dtype == torch.uint8:
        x = rows_to_boards_plain(x, width)
    for shape, ksize, op in steps:
        se = structuring_element(shape, ksize)
        if op == "d":
            x = _dilate_bits(x, se)
        else:
            x = (~_dilate_bits((~x) & valid, se)) & valid
    if rows_out is not None:
        rows_out.copy_(boards_to_rows_plain(x, width).reshape(rows_out.shape))
    return x


def morph_bits_plain(x: torch.Tensor, valid: torch.Tensor, shape: str, ksize: int,
                     iterations: int, program: str) -> torch.Tensor:
    """A morphology program on bitboards: each char of ``program`` is 'e'
    (erode) or 'd' (dilate), repeated ``iterations`` times."""
    return morph_steps_plain(x, valid, morph_program(shape, ksize, iterations, program))


def morph_steps(x: torch.Tensor, valid: torch.Tensor, steps, width: int | None = None,
                rows_out: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`morph_steps_plain`'s step list on (..., H, NW) int32 bitboards
    or (..., H, ⌈width/8⌉) uint8 packed rows (``valid`` from
    :func:`_valid_bits`), the result's packed rows into ``rows_out`` when
    given.  A CUDA tensor runs kernel K2 (``ops/kernels.py``), the whole list
    in one launch at the defaults, its load and store converting; a CPU
    tensor the plain version; any other device raises."""
    if x.is_cuda:
        from .kernels import morph_steps_cuda  # noqa: PLC0415

        return morph_steps_cuda(x, valid, steps, width, rows_out)
    if x.device.type != "cpu":
        raise ValueError(f"morph_bits: no kernel for device {x.device}")
    return morph_steps_plain(x, valid, steps, width, rows_out)


def morph_bits(x: torch.Tensor, valid: torch.Tensor, shape: str, ksize: int,
               iterations: int, program: str) -> torch.Tensor:
    """:func:`morph_bits_plain`'s program through :func:`morph_steps`."""
    return morph_steps(x, valid, morph_program(shape, ksize, iterations, program))


def _window_reduce(x: torch.Tensor, se: np.ndarray, is_max: bool) -> torch.Tensor:
    """Min or max over the element's set cells via shifted slices of the
    padded tensor, on the last two dims (leading dims ride along)."""
    h, w = x.shape[-2], x.shape[-1]
    ry, rx = se.shape[0] // 2, se.shape[1] // 2
    p = torch.nn.functional.pad(x, (rx, rx, ry, ry), value=0 if is_max else 255)
    ys, xs = np.nonzero(se)
    acc = None
    for dy, dx in zip(ys.tolist(), xs.tolist()):
        win = p[..., dy : dy + h, dx : dx + w]
        acc = win if acc is None else (torch.maximum(acc, win) if is_max else torch.minimum(acc, win))
    return acc


def morph_dense_plain(x: torch.Tensor, steps) -> torch.Tensor:
    """A step list ((shape, ksize, op), ...) on a (..., H, W) uint8 tensor,
    each step one dilation (op 'd') or erosion (any other op) by its element,
    in order: the plain version of kernel K11."""
    if x.dtype != torch.uint8:
        raise TypeError(f"morph: expected a uint8 tensor, got {x.dtype}")
    for shape, ksize, op in steps:
        x = _window_reduce(x, structuring_element(shape, ksize), op == "d")
    return x


def morph_plain(x: torch.Tensor, shape: str, ksize: int, iterations: int, program: str) -> torch.Tensor:
    """A morphology program on a (..., H, W) uint8 tensor: each char of
    ``program`` is 'e' (erode) or 'd' (dilate), repeated ``iterations`` times
    (twin of the JAX package's ``_morph``)."""
    return morph_dense_plain(x, morph_program(shape, ksize, iterations, program))


def morph_dense(x: torch.Tensor, steps) -> torch.Tensor:
    """:func:`morph_dense_plain`'s step list on the tensor's device: kernel
    K11 for a CUDA tensor (the whole list in one launch at the defaults), the
    plain version for a CPU tensor, else raise."""
    if x.is_cuda:
        from .kernels import morph_dense_cuda  # noqa: PLC0415

        return morph_dense_cuda(x, steps)
    if x.device.type != "cpu":
        raise ValueError(f"morph: no kernel for device {x.device}")
    return morph_dense_plain(x, steps)


def erode(x, shape="rect", ksize=3, iterations=1):
    return morph_dense(x, morph_program(shape, ksize, iterations, "e"))


def dilate(x, shape="rect", ksize=3, iterations=1):
    return morph_dense(x, morph_program(shape, ksize, iterations, "d"))


def morph_open(x, shape="rect", ksize=3, iterations=1):
    """iterations× erode then iterations× dilate (OpenCV MORPH_OPEN semantics)."""
    return morph_dense(x, morph_program(shape, ksize, iterations, "ed"))


def morph_close(x, shape="rect", ksize=3, iterations=1):
    return morph_dense(x, morph_program(shape, ksize, iterations, "de"))


def morph_binary_packed(x: torch.Tensor, shape: str, ksize: int, iterations: int, program: str) -> torch.Tensor:
    """Drop-in for :func:`morph_plain` on BINARY (0/255 or 0/1) uint8 masks:
    pack → bit-domain program → unpack to 0/255 uint8 (K1, K2, K1 on the card)."""
    from .thinning import dense_from_boards, pack_bitboards  # noqa: PLC0415

    w = x.shape[-1]
    b = morph_bits(pack_bitboards(x), _valid_bits(w, x.device), shape, ksize, iterations, program)
    return dense_from_boards(b, w, 255)
