"""Shared polyline geometry: all float expressions match the reference's
numpy arithmetic bit-for-bit (same dtype, same operation order), because the
greedy planners downstream break ties on exact float comparisons and the
stream bytes inherit any divergence.

Copy of ``plotweave/vector/geometry.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def as_pts(poly: np.ndarray) -> np.ndarray:
    """(N,1,2) or (N,2) → (N,2) view."""
    return np.asarray(poly).reshape(-1, 2)


def perimeter_open(poly: np.ndarray) -> float:
    """Open polyline length in float32 accumulation (08:25-28)."""
    p = as_pts(poly).astype(np.float32)
    if len(p) < 2:
        return 0.0
    return float(np.linalg.norm(p[1:] - p[:-1], axis=1).sum())


def arc_length(poly: np.ndarray, closed: bool) -> float:
    """Sequential double accumulation like cv2.arcLength (07:50, 10:41-43)."""
    p = as_pts(poly).astype(np.float64)
    if len(p) < 2:
        return 0.0
    d = p[1:] - p[:-1]
    seg = np.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    total = float(np.cumsum(seg)[-1]) if len(seg) else 0.0
    if closed:
        dx, dy = p[0] - p[-1]
        total += float(np.sqrt(dx * dx + dy * dy))
    return total


def poly_len_f32(poly: np.ndarray) -> float:
    """float32 hypot-sum length (12:71-76)."""
    a = as_pts(poly).astype(np.float32)
    if a.shape[0] < 2:
        return 0.0
    d = a[1:] - a[:-1]
    return float(np.sum(np.hypot(d[:, 0], d[:, 1])))


def is_closed(poly: np.ndarray) -> bool:
    p = as_pts(poly)
    return len(p) > 2 and bool(np.all(p[0] == p[-1]))


def ensure_open(poly: np.ndarray) -> np.ndarray:
    """Drop a duplicated closing vertex; (N,1,2) int32 out (08:48-51).

    Already-int32 inputs come back as a VIEW (no copy): every caller only
    reads the result (resampling/rasterizing into fresh arrays), and the
    spun 4K contours run to 60 MB each — an unconditional astype copy here
    measured ~0.1 s/layer-set."""
    p = as_pts(poly)
    if len(p) >= 2 and np.all(p[0] == p[-1]):
        p = p[:-1]
    return p.reshape(-1, 1, 2).astype(np.int32, copy=False)


def bbox(poly: np.ndarray) -> Tuple[int, int, int, int]:
    p = as_pts(poly)
    return (
        int(np.floor(p[:, 0].min())),
        int(np.floor(p[:, 1].min())),
        int(np.ceil(p[:, 0].max())),
        int(np.ceil(p[:, 1].max())),
    )


# ---------------------------------------------------------------------------
# Batched per-contour geometry over ONE concatenated array.  8k+ contours ×
# tiny numpy calls dominate stages 07/08 at poster scale; these helpers hoist
# the elementwise math into one pass while preserving the exact float
# semantics of the scalar functions above:
#  - batch_arc_length totals via np.add.reduceat = SEQUENTIAL accumulation,
#    exactly arc_length's cumsum[-1] (an appended +0.0 boundary term is a
#    no-op for non-negative partials);
#  - batch_perimeter_open sums each contour's SLICE of the big float32
#    norm array with np.sum — numpy's pairwise summation depends only on the
#    slice length and contiguity, so it equals perimeter_open bit-for-bit;
#  - batch_bbox is integer min/max (order-free, trivially exact).


def _concat_pts(ptss: List[np.ndarray], dtype) -> Tuple[np.ndarray, np.ndarray]:
    """(concatenated (sum N, 2) array, offsets (k+1,)) for non-empty ptss.
    ``dtype=None`` keeps numpy's native promotion (no second copy)."""
    lens = np.fromiter((len(p) for p in ptss), np.int64, count=len(ptss))
    offs = np.zeros(len(ptss) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    arrs = [np.asarray(p).reshape(-1, 2) for p in ptss]
    if dtype is not None:
        # cast during the concatenation pass (skips a full-size temporary);
        # int32→float32 is exact for pixel coords (< 2^24)
        big = np.concatenate(arrs, dtype=dtype)
    else:
        big = np.concatenate(arrs)
    return big, offs


# cap per-chunk concatenation size: poster-scale contour sets run to
# 10M+ points, and one giant fresh allocation pays seconds of first-touch
# page faults on this host — bounded chunks keep the allocator arena warm.
# Chunks split at contour boundaries, so per-contour results are unchanged.
_CHUNK_PTS = 1_000_000


def _chunk_ranges(ptss: List[np.ndarray], max_pts: int = _CHUNK_PTS):
    """Yield (lo, hi) contour-index ranges whose total points ≤ max_pts
    (a single over-large contour gets its own range)."""
    lo, tot = 0, 0
    for i, p in enumerate(ptss):
        n = len(p)
        if tot and tot + n > max_pts:
            yield lo, i
            lo, tot = i, 0
        tot += n
    if lo < len(ptss):
        yield lo, len(ptss)


def batch_arc_length(ptss: List[np.ndarray], closed: np.ndarray) -> np.ndarray:
    """arc_length() per contour (float64); ``closed`` adds the closing seg.

    The accumulation must be SEQUENTIAL to match cv2.arcLength (the
    reference's 07:50 / 10:41-43 seed metric): numpy's add.reduceat — the
    previous batch machinery — accumulates with unrolled partial sums that
    differ from the sequential sum at the ulp from n≈4 up, a latent
    argmax-seed risk.  The native pw_arc_batch runs the exact C++ loop over
    the concatenated int32 contours; without the library, the per-contour
    scalar (np.cumsum is sequential) is the fallback."""
    if not ptss:
        return np.zeros(0)
    closed = np.asarray(closed, bool)
    from ..native.loader import bind_skeleton_ops, get_lib  # noqa: PLC0415

    lib = get_lib()
    if lib is not None and all(np.asarray(p).dtype == np.int32 for p in ptss):
        import ctypes  # noqa: PLC0415

        bind_skeleton_ops(lib)
        # zero-copy: hand the C loop each contour's own storage instead of
        # concatenating (poster-scale spun layers are tens of MB — the concat
        # copy dominated this call and swings badly with the host's episodic
        # page-fault phases).  Same loop, same accumulation order.
        arrs = [np.ascontiguousarray(np.asarray(p).reshape(-1, 2)) for p in ptss]
        ptrs = np.fromiter((a.ctypes.data for a in arrs), np.uintp, count=len(arrs))
        lens = np.fromiter((len(a) for a in arrs), np.int64, count=len(arrs))
        out = np.empty(len(ptss))
        cl = np.ascontiguousarray(closed, np.uint8)
        lib.pw_arc_batch_ptrs(
            ptrs.ctypes.data_as(ctypes.POINTER(ctypes.c_void_p)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(ptss),
            cl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return out
    return np.array([arc_length(p, bool(c)) for p, c in zip(ptss, closed)], np.float64)


def batch_perimeter_open(ptss: List[np.ndarray]) -> np.ndarray:
    """perimeter_open() per contour: float32 norms, pairwise slice sums."""
    if not ptss:
        return np.zeros(0, np.float32)
    if sum(len(p) for p in ptss) > _CHUNK_PTS:
        out = np.zeros(len(ptss), np.float32)
        for lo, hi in _chunk_ranges(ptss):
            out[lo:hi] = batch_perimeter_open(ptss[lo:hi])
        return out
    big, offs = _concat_pts(ptss, np.float32)
    d = big[1:] - big[:-1]
    # same elementwise machinery as np.linalg.norm(d, axis=1)
    norms = np.sqrt(np.add.reduce(np.abs(d) ** 2, axis=1))
    out = np.zeros(len(ptss), np.float32)
    for i in range(len(ptss)):
        a, b = offs[i], offs[i + 1] - 1
        if b > a:
            out[i] = norms[a:b].sum()
    return out


def batch_bbox(ptss: List[np.ndarray]) -> np.ndarray:
    """bbox() per contour as an (k, 4) int array (x0, y0, x1, y1).
    Integer-coordinate contours only (the cast truncates floats)."""
    if not ptss:
        return np.zeros((0, 4), np.int64)
    if sum(len(p) for p in ptss) > _CHUNK_PTS:
        out = np.zeros((len(ptss), 4), np.int64)
        for lo, hi in _chunk_ranges(ptss):
            out[lo:hi] = batch_bbox(ptss[lo:hi])
        return out
    # min/max commute with the truncating int cast (both are monotone), so
    # reduce in the NATIVE dtype and cast only the (k, 4) result — the
    # int64 concat copy cost ~0.2 s/call on the 4K poster's spun layers.
    # A single contour (how the chunker passes each over-large spun walk)
    # needs no concatenation at all.
    if len(ptss) == 1:
        p = np.asarray(ptss[0]).reshape(-1, 2)
        if len(p) == 0:
            return np.zeros((1, 4), np.int64)
        return np.concatenate([p.min(axis=0), p.max(axis=0)]).astype(np.int64).reshape(1, 4)
    big, offs = _concat_pts(ptss, None)
    starts = np.minimum(offs[:-1], max(0, len(big) - 1))
    mins = np.minimum.reduceat(big, starts, axis=0)
    maxs = np.maximum.reduceat(big, starts, axis=0)
    empty = offs[1:] == offs[:-1]
    if empty.any():
        mins[empty] = 0
        maxs[empty] = 0
    return np.concatenate([mins, maxs], axis=1).astype(np.int64, copy=False)


def resample_arclen(pts: np.ndarray, step: float) -> np.ndarray:
    """Uniform arc-length resampling (08:53-64): closing vertex dropped,
    short polylines returned unchanged, samples at t = 0, step, 2·step …"""
    p = as_pts(pts).astype(np.float32)
    if len(p) < 2:
        return p
    if is_closed(pts):
        p = p[:-1]
    seg = np.linalg.norm(p[1:] - p[:-1], axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    if s[-1] <= step:
        return p
    t = np.arange(0.0, s[-1], step, dtype=np.float32)
    k = np.searchsorted(s, t, side="right") - 1
    k = np.clip(k, 0, len(p) - 2)
    u = (t - s[k]) / np.maximum(1e-6, s[k + 1] - s[k])
    return p[k] * (1.0 - u[:, None]) + p[k + 1] * u[:, None]


def split_on_jumps(poly: np.ndarray, max_jump: float, keep_singleton: bool = True) -> List[np.ndarray]:
    """Split where consecutive vertices are farther than ``max_jump`` apart.

    Two reference variants differ on a 1-point pending segment at a jump:
    the intra-dedup variant (08:185-196) keeps the far point joined to it
    (``keep_singleton=True``), the cross-dedup variant (10:49-63) discards
    the lone point and starts fresh (``keep_singleton=False``).  Fragments
    shorter than 2 vertices are dropped.
    """
    p = as_pts(poly).astype(np.float32)
    if len(p) < 2:
        return []
    diff = p[1:] - p[:-1]  # float32, as both reference variants compute it
    if keep_singleton:  # 08: float32 norm, but compared as a Python float —
        # i.e. in float64 (08:190) — so widen before comparing
        d = np.sqrt((diff * diff).sum(axis=1)).astype(np.float64)
    else:  # 10 computes hypot in float64 from float32 diffs
        d = np.hypot(diff[:, 0].astype(np.float64), diff[:, 1].astype(np.float64))
    jumps = d > max_jump
    out: List[np.ndarray] = []
    start = 0
    for i in range(1, len(p)):
        if jumps[i - 1]:
            if i - start >= 2:
                out.append(p[start:i].astype(np.int32).reshape(-1, 1, 2))
                start = i
            elif not keep_singleton:
                start = i
            # else: a lone pending point stays joined across the jump (08)
    if len(p) - start >= 2:
        out.append(p[start:].astype(np.int32).reshape(-1, 1, 2))
    return out


def rdp_simplify(points: np.ndarray, eps: float) -> np.ndarray:
    """Iterative Ramer–Douglas–Peucker keep-mask (08:451-463 inline variant:
    stack-based, perpendicular distance via unnormalized normal)."""
    # NOT nativized (round-5 negative result): the reference computes the
    # perpendicular distances with `(P[s+1:e]-a) @ seg_n` (08:459), and
    # numpy's f32 matmul semantics are SIZE-DISPATCHED BLAS kernels (measured:
    # one fmaf form for m=200k rows, mixed per-element forms at m=46) — a
    # closed-form C++ replication cannot be bit-exact, and these bytes are
    # oracle-pinned.  The ~0.5 ms/fragment Python overhead stays.
    P = np.asarray(points, dtype=np.float32)
    keep = np.zeros(len(P), bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(P) - 1)]
    while stack:
        s, e = stack.pop()
        if e <= s + 1:
            continue
        a, b = P[s], P[e]
        seg = b - a
        seg_n = np.array([-seg[1], seg[0]], np.float32)
        seg_len = float(np.linalg.norm(seg)) + 1e-12
        d = np.abs((P[s + 1 : e] - a) @ seg_n) / seg_len
        i = int(np.argmax(d))
        if d[i] > eps:
            k = s + 1 + i
            keep[k] = True
            stack.append((s, k))
            stack.append((k, e))
    return P[keep]
