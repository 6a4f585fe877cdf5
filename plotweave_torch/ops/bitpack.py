"""Bit-packing of binary images, 8 px per byte, MSB-first (== ``np.packbits``).

Twin of ``plotweave/ops/bitpack.py``: the fused chain's input (cleaned masks)
and its output blob (edges, then skeletons) use this layout.  The chain works
on the int32 bitboards of ``ops/thinning.py`` (32 px a word, LSB-first);
:func:`rows_to_boards_plain` and :func:`boards_to_rows_plain` convert between
the two, the plain versions of K2's packed-row load and store and K6's
packed-row stores, which do it on the card with no launch of their own.  On
a CUDA tensor every public function here runs kernel K1 (``ops/kernels.py``,
``csrc/bitpack.cu``), on a CPU tensor its plain version, and raises for any
other device.
"""

from __future__ import annotations

import numpy as np
import torch

from .thinning import _on_card
from .thinning import pack_bitboards_plain, unpack_bitboards_plain

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def bitpack_rows_plain(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) any dtype (> 0 = set) → (..., ceil(W/8)) uint8."""
    w = masks.shape[-1]
    bits = (masks > 0).to(torch.int32)
    pad = (-w) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], -1, 8)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=masks.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def bitunpack_rows_plain(packed: torch.Tensor, width: int) -> torch.Tensor:
    """(..., ceil(W/8)) uint8 → (..., width) 0/1 uint8 (inverse of
    :func:`bitpack_rows_plain`)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]


def rows_to_boards_plain(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Packed rows (..., ceil(W/8)) uint8 → (..., ceil(W/32)) int32
    bitboards; bits at and beyond ``width`` are zero."""
    return pack_bitboards_plain(bitunpack_rows_plain(packed, width))


def boards_to_rows_plain(boards: torch.Tensor, width: int) -> torch.Tensor:
    """Bitboards (..., ceil(W/32)) int32 → packed rows (..., ceil(W/8))
    uint8; bits at and beyond ``width`` are dropped."""
    return bitpack_rows_plain(unpack_bitboards_plain(boards, width))


def bitpack_rows(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) uint8, bool or int32 (> 0 = set) → (..., ceil(W/8)) uint8;
    on a card one launch of K1."""
    if _on_card("bitpack_rows", masks):
        from .kernels import dense_to_rows_cuda  # noqa: PLC0415

        return dense_to_rows_cuda(masks)
    return bitpack_rows_plain(masks)


def bitunpack_rows(packed: torch.Tensor, width: int) -> torch.Tensor:
    """(..., ceil(W/8)) uint8 → (..., width) 0/1 uint8 (inverse of
    :func:`bitpack_rows`); on a card one launch of K1."""
    if _on_card("bitunpack_rows", packed):
        from .kernels import rows_to_dense_cuda  # noqa: PLC0415

        return rows_to_dense_cuda(packed, width)
    return bitunpack_rows_plain(packed, width)


def unpack_rows(packed: np.ndarray, width: int) -> np.ndarray:
    """Host inverse of :func:`bitpack_rows`; returns 0/1 uint8 of last-axis
    length ``width``."""
    return np.unpackbits(np.asarray(packed), axis=-1)[..., :width]
