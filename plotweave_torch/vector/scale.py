"""Affine page-fit scaling of contour sets (stage 05).

Fit semantics per 05_scale_vectors.py:63-96: isotropic min-scale into the
inner rect (page minus margins) when keep_aspect, translate to the inner
rect's top-left, float32 affine, truncate to int32.

Copy of ``plotweave/vector/scale.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def fit_scale(
    src_wh: Tuple[int, int],
    full_wh: Tuple[int, int],
    margins: Tuple[int, int, int, int],
    keep_aspect: bool = True,
) -> Tuple[float, float, int, int]:
    """(sx, sy, dx, dy): scale factors into the inner rect + its top-left."""
    ml, mr, mt, mb = margins
    inner_w = max(1, full_wh[0] - ml - mr)
    inner_h = max(1, full_wh[1] - mt - mb)
    sx = inner_w / max(1e-6, src_wh[0])
    sy = inner_h / max(1e-6, src_wh[1])
    if keep_aspect:
        s = min(sx, sy)
        sx = sy = s
    return sx, sy, ml, mt


def scale_polys(polys: List[np.ndarray], sx: float, sy: float, dx: float, dy: float) -> List[np.ndarray]:
    """float32 (pts @ diag(sx,sy)) + (dx,dy), truncated to int32 (05:82-96).

    Computed over ONE concatenated array: the affine math is elementwise per
    point (the 2×2 matmul is two muls + one add per coordinate, evaluated
    row-independently), so batching is bit-identical to the per-contour
    loop."""
    out: List[np.ndarray] = []
    if not polys:
        return out
    native = _scale_polys_native(polys, sx, sy, dx, dy)
    if native is not None:
        return native
    from .geometry import _chunk_ranges  # noqa: PLC0415

    # the 2×2 matrix is diagonal, so the row-vector matmul reduces to an
    # elementwise multiply: x·sx + y·0.0 == x·sx bit-for-bit for finite
    # float32 coords (adding ±0.0 never changes a float except -0.0 → the
    # truncating int cast maps both zeros to 0).  Multiply/add run in place
    # on the one float32 copy — the matmul path materialized two extra
    # ~60 MB temporaries per 4K spun layer.
    S = np.array([sx, sy], dtype=np.float32)
    T = np.array([dx, dy], dtype=np.float32)
    for lo, hi in _chunk_ranges([p.reshape(-1, 2) for p in polys]):
        group = [p.reshape(-1, 2) for p in polys[lo:hi]]
        lens = np.fromiter((g.shape[0] for g in group), np.int64, count=len(group))
        offs = np.zeros(len(group) + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        # cast during the concatenation pass: int32→float32 is exact for
        # pixel coords (< 2^24) and skips a second full-size temporary
        big = np.concatenate(group, dtype=np.float32)
        np.multiply(big, S, out=big)
        np.add(big, T, out=big)
        big = big.astype(np.int32)
        out.extend(big[offs[i] : offs[i + 1]].reshape(-1, 1, 2) for i in range(len(group)))
    return out


def _scale_polys_native(polys, sx, sy, dx, dy):
    """Fused C++ pass (pw_scale_batch): int32 read → float32 affine in
    registers → int32 write, one output allocation and no float temporary.
    Bit-identical to the numpy chain (same int32→float32 conversion, single
    IEEE float32 mul and add with fma fusion disabled, same truncating cast
    — fuzz-pinned in test_native.py).  None when the library is unavailable
    or any contour isn't int32."""
    import ctypes  # noqa: PLC0415

    from ..native.loader import bind_skeleton_ops, get_lib  # noqa: PLC0415

    lib = get_lib()
    if lib is None or any(np.asarray(p).dtype != np.int32 for p in polys):
        return None
    bind_skeleton_ops(lib)
    arrs = [np.ascontiguousarray(np.asarray(p).reshape(-1, 2)) for p in polys]
    ptrs = np.fromiter((a.ctypes.data for a in arrs), np.uintp, count=len(arrs))
    lens = np.fromiter((len(a) for a in arrs), np.int64, count=len(arrs))
    offs = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    big = np.empty((int(offs[-1]), 2), np.int32)
    lib.pw_scale_batch(
        ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(arrs),
        np.float32(sx), np.float32(sy), np.float32(dx), np.float32(dy),
        big.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return [big[offs[i] : offs[i + 1]].reshape(-1, 1, 2) for i in range(len(arrs))]
