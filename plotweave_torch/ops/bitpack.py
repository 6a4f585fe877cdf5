"""Bit-packing of binary images, 8 px per byte, MSB-first (== ``np.packbits``).

Twin of ``plotweave/ops/bitpack.py``: the fused chain's input (cleaned masks)
and its output blob (edges, then skeletons) use this layout.
"""

from __future__ import annotations

import torch

_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)


def bitpack_rows(masks: torch.Tensor) -> torch.Tensor:
    """(..., W) any dtype (nonzero = set) → (..., ceil(W/8)) uint8."""
    w = masks.shape[-1]
    bits = (masks > 0).to(torch.int32)
    pad = (-w) % 8
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], -1, 8)
    weights = torch.tensor(_WEIGHTS, dtype=torch.int32, device=masks.device)
    return (bits * weights).sum(dim=-1).to(torch.uint8)


def bitunpack_rows(packed: torch.Tensor, width: int) -> torch.Tensor:
    """(..., ceil(W/8)) uint8 → (..., width) 0/1 uint8 (inverse of
    :func:`bitpack_rows`)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]
