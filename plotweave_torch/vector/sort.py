"""Greedy nearest-neighbor travel ordering with endpoint flipping.

One engine covers the reference's three greedy variants, which differ only
in seed-length metric and closed-contour awareness:

- stage 07 (07_sort_contours.py:36-88): closed-aware, seeds on closed arc
  length, never flips closed contours, re-closes after assembly;
- stage 08's post-dedup reorder (08:223-248): open float32 perimeter;
- stage 10's reorder (10:69-97): open double arc length.

Selection semantics are exact: distances are float32 squared sums computed
with the same numpy expressions, candidates are scanned in ascending index
with strict-< updates (first minimum wins), and an open contour prefers its
start when d²(start) ≤ d²(end).

Copy of ``plotweave/vector/sort.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .geometry import arc_length, as_pts, batch_arc_length, batch_perimeter_open, perimeter_open


def _endpoints(poly: np.ndarray, strip_closed: bool) -> Tuple[np.ndarray, np.ndarray, bool]:
    pts = as_pts(poly)
    closed = bool(np.all(pts[0] == pts[-1])) and len(pts) > 1
    if strip_closed and closed:
        pts = pts[:-1]
    return pts[0], pts[-1], closed


def _batch_endpoints(ptss, strip_closed: bool):
    """(starts (k,2), ends (k,2), closed (k,)) in ONE pass — the per-contour
    _endpoints() semantics (closed = first==last and len>1; closed contours
    strip the duplicate closing vertex, so their end is pts[-2])."""
    closed = np.fromiter(
        (
            len(p) > 1 and bool(p[0, 0] == p[-1, 0]) and bool(p[0, 1] == p[-1, 1])
            for p in ptss
        ),
        bool,
        count=len(ptss),
    )
    starts = np.stack([p[0] for p in ptss])
    if strip_closed:
        ends = np.stack([p[-2] if (c and len(p) > 1) else p[-1] for p, c in zip(ptss, closed)])
    else:
        ends = np.stack([p[-1] for p in ptss])
    return starts, ends, closed


def _greedy_order_native(starts, ends, closed, closed_aware, seed):
    """C++ selection loop (bit-identical float32 semantics, fuzz-tested);
    None when the native library is unavailable."""
    import ctypes  # noqa: PLC0415

    from ..native.loader import bind_skeleton_ops, get_lib  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_skeleton_ops(lib)
    n = len(starts)
    s32 = np.ascontiguousarray(starts, dtype=np.float32)
    e32 = np.ascontiguousarray(ends, dtype=np.float32)
    cl = np.ascontiguousarray(np.asarray(closed, dtype=bool), dtype=np.uint8)
    order = np.empty(n, np.int32)
    flips = np.empty(n, np.uint8)
    lib.pw_greedy_order(
        s32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        e32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        1 if closed_aware else 0,
        int(seed),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return [int(i) for i in order], [bool(f) for f in flips]


def greedy_order(
    polys: Sequence[np.ndarray],
    lengths: Sequence[float],
    closed: Sequence[bool],
    closed_aware: bool,
    starts: np.ndarray = None,
    ends: np.ndarray = None,
    device_min_n: int = 0,
    device=None,
) -> Tuple[List[int], List[bool]]:
    """Return (order, flips) of the greedy nearest-endpoint tour.

    ``starts``/``ends`` may be precomputed (the _batch_endpoints fast path);
    when omitted they are derived per contour exactly as before.
    ``device_min_n`` > 0 routes plans of at least that many contours through
    the device planner (vector/planner_device.py: K9) when ``device`` is a
    CUDA device; on the CPU the host planner runs, as the JAX package's does
    off an accelerator.  Selection semantics are identical, and nothing
    falls back: a card that fails raises."""
    n = len(polys)
    if starts is None or ends is None:
        starts = np.array([_endpoints(c, closed_aware)[0] for c in polys])
        ends = np.array([_endpoints(c, closed_aware)[1] for c in polys])

    cur = int(np.argmax(lengths))

    if device_min_n and n >= device_min_n:
        from .planner_device import MAX_N, greedy_order_device, on_cuda  # noqa: PLC0415

        if on_cuda(device):
            dev = greedy_order_device(starts, ends, closed, closed_aware, cur, device)
            if dev is not None:
                print(f"[sort] device planner: n={n}")
                return dev
            print(f"[sort] n={n} is outside the device planner's 2..{MAX_N}: host planner")

    native = _greedy_order_native(starts, ends, closed, closed_aware, cur)
    if native is not None:
        return native

    used = np.zeros(n, dtype=bool)
    order, flips = [cur], [False]
    used[cur] = True
    cur_end = starts[cur] if (closed_aware and closed[cur]) else ends[cur]

    while not np.all(used):
        idxs = np.flatnonzero(~used)
        d2s = np.sum((starts[idxs].astype(np.float32) - cur_end.astype(np.float32)) ** 2, axis=1)
        d2e = np.sum((ends[idxs].astype(np.float32) - cur_end.astype(np.float32)) ** 2, axis=1)
        best, flip, bd = -1, False, np.float32(np.inf)
        for k, i in enumerate(idxs):
            if closed_aware and closed[i]:
                if d2s[k] < bd:
                    bd, best, flip = d2s[k], i, False
            elif d2s[k] <= d2e[k]:
                if d2s[k] < bd:
                    bd, best, flip = d2s[k], i, False
            else:
                if d2e[k] < bd:
                    bd, best, flip = d2e[k], i, True
        used[best] = True
        order.append(best)
        flips.append(flip)
        if closed_aware and closed[best]:
            cur_end = starts[best]
        else:
            cur_end = starts[best] if flip else ends[best]
    return order, flips


def apply_order(polys: Sequence[np.ndarray], order: List[int], flips: List[bool], reclose: bool) -> List[np.ndarray]:
    out: List[np.ndarray] = []
    for i, f in zip(order, flips):
        pts = as_pts(polys[i])
        if f:
            pts = pts[::-1].copy()
        if reclose:
            orig = as_pts(polys[i])
            if np.all(orig[0] == orig[-1]) and not np.all(pts[0] == pts[-1]):
                pts = np.vstack([pts, pts[0]])
        # already-int32 unflipped contours come back as views (no copy):
        # every consumer treats stage artifacts as read-only, and the
        # unconditional astype copy measured ~0.1 s on a spun 4K layer
        out.append(pts.reshape(-1, 1, 2).astype(np.int32, copy=False))
    return out


def sort_contours(polys: List[np.ndarray], device_min_n: int = 0, device=None) -> List[np.ndarray]:
    """Stage-07 ordering: closed-aware, seeded on closed arc length."""
    if not polys:
        return []
    ptss = [as_pts(c) for c in polys]
    starts, ends, closed = _batch_endpoints(ptss, strip_closed=True)
    lengths = batch_arc_length(ptss, np.ones(len(ptss), bool))
    order, flips = greedy_order(polys, lengths, closed, closed_aware=True,
                                starts=starts, ends=ends, device_min_n=device_min_n, device=device)
    return apply_order(polys, order, flips, reclose=True)


def reorder_intra(polys: List[np.ndarray]) -> List[np.ndarray]:
    """Stage-08 post-dedup reorder: open float32 perimeter seed."""
    if not polys:
        return []
    ptss = [as_pts(c) for c in polys]
    starts, ends, _ = _batch_endpoints(ptss, strip_closed=False)
    lengths = batch_perimeter_open(ptss)
    order, flips = greedy_order(polys, lengths, [False] * len(polys),
                                closed_aware=False, starts=starts, ends=ends)
    return apply_order(polys, order, flips, reclose=False)


def reorder_cross(polys: List[np.ndarray]) -> List[np.ndarray]:
    """Stage-10 reorder: open double arc-length seed."""
    if not polys:
        return []
    ptss = [as_pts(c) for c in polys]
    starts, ends, _ = _batch_endpoints(ptss, strip_closed=False)
    lengths = batch_arc_length(ptss, np.zeros(len(ptss), bool))
    order, flips = greedy_order(polys, lengths, [False] * len(polys),
                                closed_aware=False, starts=starts, ends=ends)
    return apply_order(polys, order, flips, reclose=False)
