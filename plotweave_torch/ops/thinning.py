"""Zhang–Suen thinning on bit-packed boards (twin of ``plotweave/ops/thinning.py``).

Bitboards hold 32 pixels per word, LSB-first, exactly as the JAX package's
``uint32`` boards.  PyTorch's CPU build lacks shifts and ``~`` on ``uint32``,
so every public function here takes and returns the same bits as
``torch.int32``: ``<<`` wraps as on ``uint32``, and a logical right shift is
``(x >> n) & ((1 << (32 - n)) - 1)`` (:func:`lsr`).  Tests move boards
between the two packages with :func:`bitboards_from_jax` /
:func:`bitboards_to_jax`.

:func:`pack_bitboards`, :func:`unpack_bitboards` and
:func:`dense_from_boards` convert between dense pixels and boards: kernel K1
on a CUDA tensor, the plain versions on a CPU tensor.

:func:`zhang_suen_packed` is the fixpoint: on a CUDA tensor it runs the
hand-written kernel (``ops/kernels.py``), on a CPU tensor the plain version
below.  Iterations past the fixpoint are no-ops, and one convergence flag
covers every layer, as in the JAX ``while_loop``.  :func:`zhang_suen_into`
writes the fixpoint's input (the edges) and its result (the skeletons) as
packed rows or dense bytes into given outputs: on the card from K6's own
launch, with no launch of K1.

:func:`zhang_suen_dense` is the same thinning on dense 0/1 pixels, the
front-end's ``pallas_thinning=True`` route: kernel K12 on a CUDA tensor,
:func:`zhang_suen_dense_plain` on a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def bitboards_from_jax(a: np.ndarray) -> torch.Tensor:
    """JAX ``uint32`` bitboards → the same bits as a CPU ``int32`` tensor."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint32).view(np.int32).copy())


def bitboards_to_jax(t: torch.Tensor) -> np.ndarray:
    """``int32`` bitboards (any device) → the same bits as ``uint32`` numpy."""
    return t.detach().cpu().numpy().view(np.uint32)


def lsr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32-held uint32 bits (``>>`` is arithmetic)."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (32 - n)) - 1)


def pack_bitboards_plain(binary: torch.Tensor) -> torch.Tensor:
    """(..., H, W) 0/nonzero → (..., H, ceil(W/32)) int32 bitboards, LSB-first."""
    w = binary.shape[-1]
    x = (binary > 0).to(torch.int64)
    pad = (-w) % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    xr = x.reshape(*x.shape[:-1], -1, 32)
    weights = torch.ones(32, dtype=torch.int64, device=binary.device) << torch.arange(
        32, dtype=torch.int64, device=binary.device
    )
    return (xr * weights).sum(dim=-1).to(torch.int32)  # int64 → int32 wraps


def unpack_bitboards_plain(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`pack_bitboards_plain` → (..., H, width) int32 0/1."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], -1)[..., :width]


def dense_from_boards_plain(packed: torch.Tensor, width: int, value: int = 1) -> torch.Tensor:
    """Bitboards → (..., H, width) uint8, ``value`` where the bit is set."""
    return unpack_bitboards_plain(packed, width).to(torch.uint8) * value


def _on_card(name: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor (kernel K1), False for a CPU tensor (the plain
    version); any other device raises."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    return False


def pack_bitboards(binary: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8, bool or int32 (> 0 = set) → (..., H, ceil(W/32))
    int32 bitboards, LSB-first: kernel K1 (``ops/kernels.py``) for a CUDA
    tensor, :func:`pack_bitboards_plain` for a CPU tensor, else raise."""
    if _on_card("pack_bitboards", binary):
        from .kernels import dense_to_boards_cuda  # noqa: PLC0415

        return dense_to_boards_cuda(binary)
    return pack_bitboards_plain(binary)


def unpack_bitboards(packed: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of :func:`pack_bitboards` → (..., H, width) int32 0/1, by
    kernel K1 or :func:`unpack_bitboards_plain`."""
    if _on_card("unpack_bitboards", packed):
        from .kernels import boards_to_dense_cuda  # noqa: PLC0415

        return boards_to_dense_cuda(packed, width, 1, torch.int32)
    return unpack_bitboards_plain(packed, width)


def dense_from_boards(packed: torch.Tensor, width: int, value: int = 1) -> torch.Tensor:
    """Bitboards → (..., H, width) uint8, ``value`` where the bit is set (255
    for edges, 1 for skeletons), by kernel K1 or
    :func:`dense_from_boards_plain`."""
    if _on_card("dense_from_boards", packed):
        from .kernels import boards_to_dense_cuda  # noqa: PLC0415

        return boards_to_dense_cuda(packed, width, value)
    return dense_from_boards_plain(packed, width, value)


def _shift_words(p: torch.Tensor, d: int) -> torch.Tensor:
    """Word-axis shift on the last axis: out[..., k] = p[..., k+d], zero fill."""
    nw = p.shape[-1]
    z = torch.zeros_like(p[..., : abs(d)])
    if d > 0:
        return torch.cat([p[..., d:], z], dim=-1)
    return torch.cat([z, p[..., : nw + d]], dim=-1)


def _shift_rows(p: torch.Tensor, d: int) -> torch.Tensor:
    """Row-axis shift: out[..., r, :] = p[..., r+d, :], zero fill."""
    if d == 0:
        return p
    z = torch.zeros_like(p[..., : abs(d), :])
    if d > 0:
        return torch.cat([p[..., d:, :], z], dim=-2)
    return torch.cat([z, p[..., : p.shape[-2] + d, :]], dim=-2)


def _nbr_bits(p: torch.Tensor, dx: int) -> torch.Tensor:
    """Column-neighbour board: bit j of the result = bit j+dx of the row,
    carrying across word boundaries (east ``dx=+1`` is a right shift)."""
    if dx == 0:
        return p
    if dx > 0:
        return lsr(p, 1) | (_shift_words(p, 1) << 31)
    return (p << 1) | lsr(_shift_words(p, -1), 31)


def _fa(a, b, c):
    """Bitboard full adder: (sum, carry)."""
    ab = a ^ b
    return ab ^ c, (a & b) | (c & ab)


# P2..P9 as (dy, dx): N, NE, E, SE, S, SW, W, NW (the textbook ring); stage
# 04 uses its 180° rotation
_RING = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def _subpass_bits(x: torch.Tensor, first: bool, rotated: bool) -> torch.Tensor:
    ring = [(-dy, -dx) for dy, dx in _RING] if rotated else _RING
    rows = {dy: _shift_rows(x, dy) for dy in (-1, 0, 1)}
    n = [_nbr_bits(rows[dy], dx) for dy, dx in ring]

    # B = sum of the 8 neighbour bits, bit-sliced through carry-save adders
    s1, c1 = _fa(n[0], n[1], n[2])
    s2, c2 = _fa(n[3], n[4], n[5])
    s3, c3 = n[6] ^ n[7], n[6] & n[7]
    b0, c4 = _fa(s1, s2, s3)
    s5, c5 = _fa(c1, c2, c3)
    b1, c6 = s5 ^ c4, s5 & c4
    b2, b3 = c5 ^ c6, c5 & c6
    b_ok = (b1 | b2 | b3) & ~(b3 | (b2 & b1 & b0))  # 2 <= B <= 6

    # A == 1: exactly one 0->1 transition around the ring
    any_, two = ~n[0] & n[1], torch.zeros_like(x)
    for i in range(1, 8):
        t = ~n[i] & n[(i + 1) % 8]
        two = two | (any_ & t)
        any_ = any_ | t
    a1 = any_ & ~two

    p2, p4, p6, p8 = n[0], n[2], n[4], n[6]
    if first:
        dir_ok = ~(p2 & p4 & p6) & ~(p4 & p6 & p8)
    else:
        dir_ok = ~(p2 & p4 & p8) & ~(p2 & p6 & p8)
    return x & ~(a1 & b_ok & dir_ok)


def zhang_suen_packed_plain(packed: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """Plain PyTorch fixpoint: at most ``max_iter`` iterations of both
    subpasses, stopping after the first iteration that changes no layer."""
    x = packed
    for _ in range(max_iter):
        x2 = _subpass_bits(_subpass_bits(x, True, rotated), False, rotated)
        changed = bool((x2 != x).any())
        x = x2
        if not changed:
            break
    return x


def zhang_suen_packed(packed: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """The fixpoint on (..., H, NW) int32 bitboards → the packed skeleton.

    A CUDA tensor runs kernel K6 (``ops/kernels.py``); a CPU tensor runs
    :func:`zhang_suen_packed_plain`; any other device raises."""
    if packed.is_cuda:
        from .kernels import zhang_suen_packed_cuda  # noqa: PLC0415

        return zhang_suen_packed_cuda(packed, max_iter, rotated)
    if packed.device.type != "cpu":
        raise ValueError(f"zhang_suen_packed: no kernel for device {packed.device}")
    return zhang_suen_packed_plain(packed, max_iter, rotated)


def zhang_suen_into_plain(packed: torch.Tensor, width: int, edges: torch.Tensor, skels: torch.Tensor,
                          layout: str = "rows", max_iter: int = 120, rotated: bool = True) -> None:
    """Writes the edge boards ``packed`` (B·group layers, (..., H, NW)) and
    their :func:`zhang_suen_packed_plain` fixpoint into ``edges`` and
    ``skels`` (B, group, H, row bytes): as packed rows (``layout`` "rows",
    ⌈width/8⌉ bytes a row) or dense bytes ("dense", the edges 255, the
    skeletons 1).  The plain version of ``ops.kernels.zhang_suen_into_cuda``:
    K1's plain conversions after the plain K6."""
    from .bitpack import boards_to_rows_plain  # noqa: PLC0415 (bitpack imports this module)

    skel = zhang_suen_packed_plain(packed, max_iter, rotated)
    for src, dst, value in ((packed, edges, 255), (skel, skels, 1)):
        rows = boards_to_rows_plain(src, width) if layout == "rows" else dense_from_boards_plain(src, width, value)
        dst.copy_(rows.reshape(dst.shape))


def zhang_suen_into(packed: torch.Tensor, width: int, edges: torch.Tensor, skels: torch.Tensor,
                    layout: str = "rows", max_iter: int = 120, rotated: bool = True) -> None:
    """:func:`zhang_suen_into_plain` on the boards' device: kernel K6 with its
    stores for a CUDA tensor (``ops/kernels.py``), the plain version for a CPU
    tensor, else raise."""
    if layout not in ("rows", "dense"):
        raise ValueError(f"zhang_suen_into: layout {layout!r} is neither 'rows' nor 'dense'")
    if packed.is_cuda:
        from .kernels import zhang_suen_into_cuda  # noqa: PLC0415

        return zhang_suen_into_cuda(packed, width, edges, skels, layout, max_iter, rotated)
    if packed.device.type != "cpu":
        raise ValueError(f"zhang_suen_into: no kernel for device {packed.device}")
    return zhang_suen_into_plain(packed, width, edges, skels, layout, max_iter, rotated)


def zhang_suen_slab_plain(x: torch.Tensor, top: int, bottom: int, iters: int, changed: torch.Tensor,
                          w: int | None = None, edges: torch.Tensor | None = None, skels: torch.Tensor | None = None,
                          layout: str = "rows", row0: int = 0, rotated: bool = True) -> torch.Tensor:
    """The plain version of K6's slab mode, one round of row sharding's
    thinning.  ``x`` is a slab of int32 bitboards (..., top + rows + bottom,
    NW), each side with 0 halo rows (the image's border) or at least
    ``2 * iters``: at most ``iters`` iterations run on the slab, rows beyond
    it zero, stopping after one that changes nothing in it, and a subpass
    reads one row beyond its own, so the own rows come out exact.  Returns
    the own rows.  ``changed``, a (1,) int32 tensor, gets 1 where the last
    iteration changed an own row, else 0.  Where given, ``edges`` and
    ``skels`` (B, group, H, row bytes; ``w`` px a row) receive the input's
    and the result's own rows at rows [row0, row0 + rows) of each layer, as
    :func:`zhang_suen_into_plain` lays out a whole image."""
    from .bitpack import boards_to_rows_plain  # noqa: PLC0415 (bitpack imports this module)
    from .filters import slab_rows  # noqa: PLC0415

    own = slab_rows("zhang_suen_slab", x.shape[-2], top, bottom, 2 * iters)
    x0, last = x, False
    for _ in range(iters):
        x2 = _subpass_bits(_subpass_bits(x, True, rotated), False, rotated)
        diff = x2 != x
        last, x = bool(diff[..., top : top + own, :].any()), x2
        if not bool(diff.any()):
            break
    changed.fill_(int(last))
    for src, dst, value in ((x0, edges, 255), (x, skels, 1)):
        if dst is not None:
            src = src[..., top : top + own, :]
            rows = boards_to_rows_plain(src, w) if layout == "rows" else dense_from_boards_plain(src, w, value)
            dst[:, :, row0 : row0 + own, :].copy_(rows.reshape(*dst.shape[:2], own, dst.shape[-1]))
    return x[..., top : top + own, :]


def zhang_suen_slab(x: torch.Tensor, top: int, bottom: int, iters: int, changed: torch.Tensor,
                    w: int | None = None, edges: torch.Tensor | None = None, skels: torch.Tensor | None = None,
                    layout: str = "rows", row0: int = 0, rotated: bool = True) -> torch.Tensor:
    """:func:`zhang_suen_slab_plain` on the boards' device: K6's slab mode
    with its stores for a CUDA tensor, the plain version for a CPU tensor,
    else raise."""
    if layout not in ("rows", "dense"):
        raise ValueError(f"zhang_suen_slab: layout {layout!r} is neither 'rows' nor 'dense'")
    if x.is_cuda:
        from .kernels import zhang_suen_slab_cuda  # noqa: PLC0415

        return zhang_suen_slab_cuda(x, top, bottom, iters, changed, w, edges, skels, layout, row0, rotated)
    if x.device.type != "cpu":
        raise ValueError(f"zhang_suen_slab: no kernel for device {x.device}")
    return zhang_suen_slab_plain(x, top, bottom, iters, changed, w, edges, skels, layout, row0, rotated)


def zhang_suen(binary: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """Thin (..., H, W) 0/nonzero images to 1-px skeletons; int32 0/1.

    ``rotated=True`` with 120 iterations is stage 04's thinner;
    ``rotated=False`` with 48 is stage 08's."""
    x = zhang_suen_packed(pack_bitboards(binary), max_iter=max_iter, rotated=rotated)
    return unpack_bitboards(x, binary.shape[-1])


def _subpass_dense(x: torch.Tensor, first: bool, rotated: bool) -> torch.Tensor:
    """One subpass on (k, H, W) int32 0/1 planes with a zero border
    (``plotweave/ops/thinning.py::_subpass``)."""
    h, w = x.shape[-2], x.shape[-1]
    pad = torch.nn.functional.pad(x, (1, 1, 1, 1))
    ring = [(-dy, -dx) for dy, dx in _RING] if rotated else _RING
    p = [pad[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w] for dy, dx in ring]
    b = sum(p)
    a = sum(((p[i] == 0) & (p[(i + 1) % 8] == 1)).to(torch.int32) for i in range(8))
    if first:
        dir_ok = ((p[0] * p[2] * p[4]) == 0) & ((p[2] * p[4] * p[6]) == 0)
    else:
        dir_ok = ((p[0] * p[2] * p[6]) == 0) & ((p[0] * p[4] * p[6]) == 0)
    kill = (x == 1) & (a == 1) & (b >= 2) & (b <= 6) & dir_ok
    return torch.where(kill, 0, x)


def _dense_planes(binary: torch.Tensor, name: str):
    """(k, H, W) or (H, W) 0/nonzero → ((k, H, W) planes, squeeze flag), as
    ``zhang_suen_pallas`` takes them; more leading dims raise."""
    if binary.dim() not in (2, 3):
        raise ValueError(f"{name}: expected (k, H, W) or (H, W), got {tuple(binary.shape)}")
    squeeze = binary.dim() == 2
    return (binary[None] if squeeze else binary), squeeze


def zhang_suen_dense_plain(binary: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """Plain dense-pixel fixpoint (``plotweave/ops/thinning.py::zhang_suen_dense``),
    the plain version of kernel K12: at most ``max_iter`` iterations of both
    subpasses, stopping after the first iteration that changes no layer."""
    x, squeeze = _dense_planes(binary, "zhang_suen_dense")
    x = (x > 0).to(torch.int32)
    for _ in range(max_iter):
        x2 = _subpass_dense(_subpass_dense(x, True, rotated), False, rotated)
        changed = bool((x2 != x).any())
        x = x2
        if not changed:
            break
    return x[0] if squeeze else x


def zhang_suen_dense(binary: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """Thin (k, H, W) or (H, W) 0/nonzero images; int32 0/1 of the same shape
    (``plotweave/ops/pallas_kernels.py::zhang_suen_pallas``).

    A CUDA tensor runs kernel K12 (``ops/kernels.py``); a CPU tensor runs
    :func:`zhang_suen_dense_plain`; any other device raises."""
    if binary.is_cuda:
        from .kernels import zhang_suen_dense_cuda  # noqa: PLC0415

        return zhang_suen_dense_cuda(binary, max_iter, rotated)
    if binary.device.type != "cpu":
        raise ValueError(f"zhang_suen_dense: no kernel for device {binary.device}")
    return zhang_suen_dense_plain(binary, max_iter, rotated)
