"""Intra-layer overlap deduplication (stage 08).

Two passes over a layer's sorted contours (reference semantics,
08_dedup_layer_basic.py):

**Pass A — virtual draw.**  Contours are replayed longest-first onto a shared
forbid canvas.  Each contour is arc-length resampled; a sliding tail of
recent samples is exempt from self-collision, while samples older than the
tail are committed to (a) the forbid canvas with a thick brush and (b) a
sparse point grid for radius queries.  A sample landing on forbidden canvas
or near a committed point cuts the polyline (08:117-183).

**Pass B — skeleton merge.**  Leftover fragments are clustered by expanded
bbox overlap (union-find), each cluster rasterized with a small brush,
re-thinned, and replaced by one path per connected component — the geodesic
between the longest fragment's endpoints when both map into the component,
else the BFS diameter — then resampled and RDP-simplified (08:377-469).

Host raster/labeling primitives (line stamping, minimum enclosing circle,
component labels) use OpenCV in the byte-exact path; tie-breaking, float
dtypes and traversal orders are reproduced exactly.

Copy of ``plotweave/vector/dedup_intra.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import math
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from .geometry import (
    as_pts,
    batch_bbox,
    batch_perimeter_open,
    bbox,
    ensure_open,
    perimeter_open,
    rdp_simplify,
    resample_arclen,
    split_on_jumps,
)
from .sort import reorder_intra

Tap = Tuple[int, int]

# np.linalg.norm on a float64 2-vector goes through BLAS ddot, whose n=2
# kernel computes fma(d1, d1, d0*d0) — one ulp off plain d0²+d1² in ~0.3%
# of inputs.  The reference's tail-length bookkeeping (08:141,149) uses that
# norm, and the aging comparison `tail_len > tail_len_px` is ulp-sensitive
# for small tails, so the fallback replicates it via libm fma (Python 3.12
# has no math.fma).  Exactness is pinned by tests/test_norm_semantics.py.
try:
    import ctypes as _ctypes

    _libm = _ctypes.CDLL("libm.so.6")
    _libm.fma.restype = _ctypes.c_double
    _libm.fma.argtypes = [_ctypes.c_double] * 3
    _fma = _libm.fma

    def _norm2(dx: float, dy: float) -> float:
        return math.sqrt(_fma(dy, dy, dx * dx))
except OSError:  # pragma: no cover — non-glibc hosts
    def _norm2(dx: float, dy: float) -> float:
        return float(np.linalg.norm(np.array((dx, dy))))

# BFS probe order (dy, dx) of the reference's Stage-B walks (08:252)
_BFS_OFFS = ((-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1))


class PointGrid:
    """Sparse cell grid for radius membership queries (08:68-99)."""

    def __init__(self, radius: float, cell: Optional[float] = None):
        self.r = float(radius)
        self.cell = float(cell if cell and cell > 0 else max(4.0, radius))
        self.inv = 1.0 / self.cell
        self.cells: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}

    def add(self, x: float, y: float) -> None:
        k = (int(math.floor(x * self.inv)), int(math.floor(y * self.inv)))
        self.cells.setdefault(k, []).append((x, y))

    def near(self, x: float, y: float) -> bool:
        r2 = self.r * self.r
        cx, cy = int(math.floor(x * self.inv)), int(math.floor(y * self.inv))
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                pts = self.cells.get((cx + dx, cy + dy))
                if pts:
                    for px, py in pts:
                        ddx, ddy = px - x, py - y
                        if ddx * ddx + ddy * ddy <= r2:
                            return True
        return False


def classify_taps(
    polys: List[np.ndarray],
    tap_diam: float,
    min_keep_diam: float,
    tap_max_perimeter: float,
    tap_max_vertices: int,
    tap_max_dim: float,
) -> Tuple[List[np.ndarray], List[Tap]]:
    """Split tiny contours into tap points; drop sub-threshold ticks (08:198-216).

    Tap centers come from the minimum enclosing circle of the contour.
    """
    kept: List[np.ndarray] = []
    taps: List[Tap] = []
    # batched prep: bboxes in one integer pass; float32 perimeters only for
    # the tiny-bbox candidates (bit-identical to the scalar helpers — see
    # geometry.py's batch_* notes).  Contours here are int32 pixel coords,
    # so the int bbox cast is exact.
    ptss = [as_pts(c) for c in polys]
    boxes = batch_bbox(ptss)
    dmax = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1]).astype(float)
    # the tap test ANDs the perimeter bound with the vertex bound, so a
    # perimeter is only ever consulted for contours within tap_max_vertices —
    # pre-filtering on that skips perimeter sums over the reference's spun
    # cycle walks (tiny bbox, MILLIONS of vertices; measured 0.5 s/layer-set
    # on the 4K poster)
    cand = [
        i
        for i, p in enumerate(ptss)
        if 2 <= p.shape[0] <= tap_max_vertices
        and dmax[i] <= tap_diam
        and dmax[i] <= tap_max_dim
    ]
    perims = batch_perimeter_open([ptss[i] for i in cand])
    perim_of = dict(zip(cand, perims))
    for i, c in enumerate(polys):
        p = ptss[i]
        if p.shape[0] < 2:
            continue
        d = float(dmax[i])
        if d <= tap_diam and d <= tap_max_dim:
            if int(p.shape[0]) <= tap_max_vertices and perim_of[i] <= tap_max_perimeter:
                (x, y), _ = cv2.minEnclosingCircle(p.reshape(-1, 1, 2).astype(np.float32))
                taps.append((int(round(x)), int(round(y))))
                continue
        if d < min_keep_diam:
            continue
        kept.append(ensure_open(c))
    return kept, taps


def virtual_draw_cut(
    poly: np.ndarray,
    canvas: np.ndarray,
    grid_radius: float,
    grid_cell: float,
    sample_step: float,
    tail_len_px: float,
    brush: int,
) -> List[np.ndarray]:
    """Replay one contour against the shared forbid canvas (08:117-183).

    Returns surviving fragments; commits aged samples to the canvas (thick
    line stamps between consecutive committed samples) and the point grid.
    """
    p = ensure_open(poly).reshape(-1, 2).astype(np.float32)
    if len(p) < 2:
        return []
    samples = resample_arclen(p, step=max(1.0, float(sample_step)))
    if len(samples) < 2:
        return []
    try:  # native fast path (bit-identical; bails to Python on any edge case)
        from ..native.api import virtual_draw_native  # noqa: PLC0415

        frags = virtual_draw_native(
            samples.astype(np.float64), canvas, grid_radius, grid_cell,
            tail_len_px, brush, max_delta=int(math.ceil(max(1.0, float(sample_step)))) + 2,
        )
        if frags is not None:
            return frags
    except (OSError, RuntimeError):
        pass
    # scalar Python floats throughout the loop (avoids ~20 numpy-scalar
    # allocations per sample); the tail-length increments MUST replicate
    # np.linalg.norm on a float64 2-vector bit-exactly (08:141,149) — BLAS
    # ddot computes fma(dy, dy, dx*dx), one ulp off plain dx*dx+dy*dy in
    # ~0.3% of cases, and with tiny tails that flips the aging loop (found
    # by lattice fuzz seed 1078) — hence _norm2 below
    pts = [(float(x), float(y)) for x, y in samples]

    grid = PointGrid(radius=grid_radius, cell=grid_cell)
    tail: deque[Tuple[float, float]] = deque()
    tail_len = 0.0
    h, w = canvas.shape
    frags: List[np.ndarray] = []
    cur: List[Tuple[float, float]] = []
    last_committed: Optional[Tuple[int, int]] = None
    canvas_get = canvas.item

    def commit(xy: Tuple[float, float]) -> None:
        nonlocal last_committed
        xi, yi = int(round(xy[0])), int(round(xy[1]))
        if 0 <= xi < w and 0 <= yi < h:
            if last_committed is not None:
                cv2.line(canvas, last_committed, (xi, yi), 255, thickness=brush, lineType=cv2.LINE_8)
            last_committed = (xi, yi)

    def age_out() -> None:
        nonlocal tail_len
        while tail and tail_len > tail_len_px:
            old = tail.popleft()
            grid.add(old[0], old[1])
            if tail:
                nxt = tail[0]
                tail_len -= _norm2(nxt[0] - old[0], nxt[1] - old[1])
            else:
                tail_len = 0.0
            commit(old)

    for xy in pts:
        if tail:
            prev = tail[-1]
            tail_len += _norm2(xy[0] - prev[0], xy[1] - prev[1])
        tail.append(xy)
        age_out()

        xi, yi = int(round(xy[0])), int(round(xy[1]))
        if not (0 <= xi < w and 0 <= yi < h):
            if len(cur) >= 2:
                frags.append(np.array(cur, np.int32).reshape(-1, 1, 2))
            cur = []
            continue
        if canvas_get(yi, xi) == 255 or grid.near(xy[0], xy[1]):
            if len(cur) >= 2:
                frags.append(np.array(cur, np.int32).reshape(-1, 1, 2))
            cur = []
            continue
        cur.append(xy)

    age_out()
    while tail:  # flush: stamp the remaining tail (no grid inserts, 08:174-180)
        commit(tail.popleft())

    if len(cur) >= 2:
        frags.append(np.array(cur, np.int32).reshape(-1, 1, 2))
    return frags


# --------------------------- Pass B: skeleton merge ---------------------------


def _cluster_overlapping(boxes: List[Tuple[int, int, int, int]]) -> List[List[int]]:
    """Union-find clusters of mutually overlapping (expanded) bboxes (08:319-338)."""
    n = len(boxes)
    parent = list(range(n))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i in range(n):
        x0, y0, x1, y1 = boxes[i]
        for j in range(i + 1, n):
            a0, b0, a1, b1 = boxes[j]
            if not (x1 < a0 or a1 < x0 or y1 < b0 or b1 < y0):
                ri, rj = find(i), find(j)
                if ri != rj:
                    parent[rj] = ri
    groups: Dict[int, List[int]] = {}
    for i in range(n):
        groups.setdefault(find(i), []).append(i)
    return list(groups.values())


def _bfs_tree(img: np.ndarray, src: Tuple[int, int]):
    """BFS over a component; returns (prev-pointer array, last dequeued)."""
    h, w = img.shape
    prev = -np.ones((h, w, 2), np.int32)
    seen = np.zeros((h, w), np.uint8)
    seen[src] = 1
    que = [src]
    head = 0
    last = src
    while head < len(que):
        y, x = que[head]
        head += 1
        last = (y, x)
        for dy, dx in _BFS_OFFS:
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and img[ny, nx] and not seen[ny, nx]:
                seen[ny, nx] = 1
                prev[ny, nx] = (y, x)
                que.append((ny, nx))
    return prev, last


def _geodesic(img: np.ndarray, start: Tuple[int, int], goal: Tuple[int, int]) -> List[Tuple[int, int]]:
    if start == goal:
        return [start]
    prev, _ = _bfs_tree(img, start)
    if prev[goal][0] == -1:
        return []
    path = [goal]
    y, x = goal
    while (y, x) != start:
        py, px = prev[y, x]
        if py == -1:
            return []
        path.append((int(py), int(px)))
        y, x = int(py), int(px)
    path.reverse()
    return path


def _component_path(comp: np.ndarray, a: Optional[Tuple[int, int]], b: Optional[Tuple[int, int]], min_len: int) -> List[Tuple[int, int]]:
    """Anchored geodesic if both anchors are in the component, else BFS diameter
    (two farthest sweeps) — reference 08:295-317."""
    img = (comp > 0).astype(np.uint8)
    ys, xs = np.where(img > 0)
    if ys.size == 0:
        return []
    if a is not None and b is not None and img[a] and img[b]:
        path = _geodesic(img, a, b)
        if len(path) >= max(2, min_len):
            return path
    seed = (int(ys[0]), int(xs[0]))
    _, u = _bfs_tree(img, seed)
    _, v = _bfs_tree(img, u)
    path = _geodesic(img, u, v)
    return path if len(path) >= max(2, min_len) else []


def skeleton_merge(
    lines: List[np.ndarray],
    brush_px: int,
    resample_step: float,
    rdp_eps: float,
    min_path_len: int,
    thinner=None,
) -> List[np.ndarray]:
    """Merge near-parallel fragments via rasterize→thin→one-path-per-component.

    ``thinner`` maps a uint8 0/255 ROI to a 0/255 skeleton; defaults to the
    stage-08 Zhang–Suen (standard ring, 48 iters) on a shape-bucketed JAX
    call (zero padding does not change the skeleton).
    """
    if not lines:
        return []
    if thinner is None:
        thinner = _default_thinner

    margin = brush_px * 2 + 6
    boxes = [
        (b[0] - margin, b[1] - margin, b[2] + margin, b[3] + margin)
        for b in (bbox(p) for p in lines)
    ]
    merged: List[np.ndarray] = []

    for idxs in _cluster_overlapping(boxes):
        longest = max(idxs, key=lambda j: perimeter_open(lines[j]))
        lp = as_pts(lines[longest])
        anchor_a = (int(lp[0, 0]), int(lp[0, 1]))
        anchor_b = (int(lp[-1, 0]), int(lp[-1, 1]))

        bx = boxes[idxs[0]]
        for j in idxs[1:]:
            o = boxes[j]
            bx = (min(bx[0], o[0]), min(bx[1], o[1]), max(bx[2], o[2]), max(bx[3], o[3]))
        x0, y0, x1, y1 = bx
        w, h = max(1, x1 - x0), max(1, y1 - y0)

        roi = np.zeros((h, w), np.uint8)
        for j in idxs:
            q = (as_pts(lines[j]).astype(np.int32) - np.array([x0, y0], np.int32)).reshape(-1, 1, 2)
            if len(q) >= 2:
                cv2.polylines(roi, [q], False, 255, thickness=max(1, brush_px), lineType=cv2.LINE_8)

        sk = thinner(roi)
        if sk.sum() == 0:
            continue
        num, lab = cv2.connectedComponents((sk > 0).astype(np.uint8), connectivity=8)

        ys, xs = np.where(sk > 0)
        skpts = np.stack([ys, xs], axis=1) if ys.size else np.zeros((0, 2), np.int32)

        def nearest_skel(xy_abs: Tuple[int, int]) -> Optional[Tuple[int, int]]:
            if skpts.shape[0] == 0:
                return None
            dy = skpts[:, 0] - (xy_abs[1] - y0)
            dx = skpts[:, 1] - (xy_abs[0] - x0)
            k = int(np.argmin(dy * dy + dx * dx))
            return int(skpts[k, 0]), int(skpts[k, 1])

        a0 = nearest_skel(anchor_a)
        a1 = nearest_skel(anchor_b)

        from ..native.api import component_paths_all_native  # noqa: PLC0415

        lab = np.ascontiguousarray(lab, dtype=np.int32)
        # one batched native call for every component (shared stamped BFS
        # buffers + one seed pass); per-cc results identical to the per-call
        # pw_comp_path (fuzz-pinned in test_native)
        paths_all = component_paths_all_native(lab, int(num), a0, a1, min_path_len)
        for cc in range(1, int(num)):
            if paths_all is not None:
                path = paths_all[cc - 1]
            else:  # no native library: identical Python BFS
                comp = (lab == cc).astype(np.uint8) * 255
                aa = a0 if (a0 is not None and comp[a0]) else None
                ab = a1 if (a1 is not None and comp[a1]) else None
                path = _component_path(comp, aa, ab, min_len=min_path_len)
            if len(path) < 2:
                continue
            if isinstance(path, np.ndarray):  # native: (n, 2) [y, x]
                arr = (path[:, ::-1] + np.array([x0, y0], np.int32)).astype(np.float32)
            else:
                arr = np.array([(x0 + x, y0 + y) for (y, x) in path], np.float32)
            rs = resample_arclen(arr, resample_step)
            if len(rs) < 2:
                continue
            merged.append(rdp_simplify(rs, rdp_eps).astype(np.int32).reshape(-1, 1, 2))

    return merged


def _default_thinner(roi: np.ndarray) -> np.ndarray:
    """Stage-08 Zhang–Suen: the native ``thin_native`` first, else the port's
    ``ops.thinning.zhang_suen`` (standard ring, 48 iterations) on the host.

    Cluster ROIs are small and numerous, so the fallback stays on the CPU
    (the plain PyTorch version): a round trip to the card per ROI would cost
    more than the compute, as the JAX package's fallback found for its
    accelerator.
    """
    from ..native.api import thin_native  # noqa: PLC0415

    sk = thin_native(roi, max_iter=48, rotated=False)
    if sk is not None:
        return sk * 255

    import torch  # noqa: PLC0415 — lazy: keep cv2-only paths importable

    from ..ops.thinning import zhang_suen  # noqa: PLC0415

    x = torch.from_numpy(np.ascontiguousarray(roi))
    return zhang_suen(x, max_iter=48, rotated=False).to(torch.uint8).numpy() * 255


def _virtual_draw_all_native(
    kept, order, canvas, grid_radius, grid_cell, sample_step, tail_len_px, brush, log
) -> Optional[List[List[np.ndarray]]]:
    """Pass A over the whole layer in a handful of native calls.

    Per-contour semantics identical to virtual_draw_cut (same resample, same
    canvas/grid state machine — the C side loops the same core); the Python
    per-contour overhead (~0.5 ms × thousands of contours at 4K) is what
    this removes.  Returns fragments per ordered contour, or None when the
    native library is unavailable (caller falls back to the exact loop).
    Contours whose samples round off-canvas (or any native contract edge)
    are replayed through the Python walker mid-sequence, preserving canvas
    order exactly."""
    from ..native.api import (  # noqa: PLC0415
        _STAMP_CACHE, LineStampTable,
        resample_batch_native, virtual_draw_batch_native,
    )

    k = len(order)
    if k == 0:
        return []
    step = max(1.0, float(sample_step))
    p32s = []
    closed = np.zeros(k, np.uint8)
    for j, i in enumerate(order):
        p = ensure_open(kept[i]).reshape(-1, 2).astype(np.float32)
        p32s.append(p)
        closed[j] = 1 if (len(p) > 2 and bool(np.all(p[0] == p[-1]))) else 0
    rs = resample_batch_native(p32s, closed, step)
    if rs is None:
        return None
    sx, sy, soffs = rs

    max_delta = int(math.ceil(step)) + 2
    tkey = (int(brush), int(max_delta))
    table = _STAMP_CACHE.get(tkey)
    if table is None:
        table = LineStampTable(int(brush), int(max_delta))
        _STAMP_CACHE[tkey] = table

    # same pre-screen as virtual_draw_native: off-canvas samples AND samples
    # within the stamp extent of the border (cv2 thick lines are not
    # translation-invariant once clipped) replay through the Python walker
    h, w = canvas.shape
    ext = table.extent
    bad_contour = np.zeros(k, bool)
    if len(sx):
        rx = np.rint(sx)
        ry = np.rint(sy)
        bad = ((rx < ext) | (rx >= w - ext) | (ry < ext) | (ry >= h - ext)).astype(np.int32)
        starts = np.minimum(soffs[:-1], max(0, len(bad) - 1))
        cnt = np.add.reduceat(bad, starts)
        cnt[(soffs[1:] - soffs[:-1]) == 0] = 0
        bad_contour = cnt > 0
    results: List[Optional[list]] = [None] * k
    CHUNK = 512  # keep heartbeat logs flowing on huge layers
    last_beat = time.perf_counter()
    c = 0
    while c < k:
        if bad_contour[c]:
            results[c] = virtual_draw_cut(
                kept[order[c]], canvas, grid_radius, grid_cell, sample_step, tail_len_px, brush
            )
            c += 1
        else:
            e = c
            while e < k and e - c < CHUNK and not bad_contour[e]:
                e += 1
            res = virtual_draw_batch_native(
                sx, sy, soffs[c : e + 1], canvas,
                grid_radius, grid_cell, tail_len_px, brush, max_delta,
            )
            if res is None:  # library vanished mid-run (not observed): the
                # canvas already carries earlier contours, so finish this
                # window through the exact Python walker instead of bailing
                for i in range(c, e):
                    results[i] = virtual_draw_cut(
                        kept[order[i]], canvas, grid_radius, grid_cell,
                        sample_step, tail_len_px, brush,
                    )
                c = e
                continue
            frags_per, ndone = res
            for j, frags in enumerate(frags_per[: ndone]):
                results[c + j] = frags
            if ndone < e - c:
                # native contract edge on contour c+ndone: Python replay
                i = c + ndone
                results[i] = virtual_draw_cut(
                    kept[order[i]], canvas, grid_radius, grid_cell, sample_step, tail_len_px, brush
                )
                c = i + 1
            else:
                c = e
        now = time.perf_counter()
        if c == k or now - last_beat > 1.0:
            last_beat = now
            log(f"virtual draw {c}/{k}")
    return results  # type: ignore[return-value]


def dedup_layer(
    polys: List[np.ndarray],
    canvas_wh: Tuple[int, int],
    *,
    tap_diam: float,
    tap_max_dim: float,
    min_keep: float,
    tap_max_perimeter: float,
    tap_max_vertices: int,
    sample_step: float,
    tail_len_px: float,
    collision_radius: float,
    grid_cell: float,
    max_jump: float,
    post_enabled: bool,
    post_brush: int,
    post_step: float,
    post_rdp_eps: float,
    post_min_len: int,
    log=lambda s: None,
) -> Tuple[List[np.ndarray], List[Tap]]:
    """Full stage-08 pipeline for one layer (08:484-557)."""
    W, H = canvas_wh
    canvas = np.zeros((H, W), np.uint8)
    brush = max(1, int(round(2.0 * collision_radius)))

    kept, taps = classify_taps(polys, tap_diam, min_keep, tap_max_perimeter, tap_max_vertices, tap_max_dim)

    order = sorted(range(len(kept)), key=lambda i: perimeter_open(kept[i]), reverse=True)
    per_contour = _virtual_draw_all_native(
        kept, order, canvas, collision_radius, grid_cell, sample_step, tail_len_px, brush, log
    )
    if per_contour is None:
        # no native library: the original per-contour loop (identical bytes)
        per_contour = []
        last_beat = time.perf_counter()
        for idx, i in enumerate(order, 1):
            per_contour.append(virtual_draw_cut(
                kept[i], canvas, collision_radius, grid_cell, sample_step, tail_len_px, brush
            ))
            # time-based heartbeat (the reference prints every ~1.5 s, 08:524-535)
            now = time.perf_counter()
            if idx == len(order) or now - last_beat > 1.0:
                last_beat = now
                log(f"virtual draw {idx}/{len(order)}")
    cleaned: List[np.ndarray] = []
    for frags in per_contour:
        for f in frags:
            parts = split_on_jumps(f, max_jump, keep_singleton=True)
            cleaned.extend(parts if parts else [f])

    if order:
        lines, taps2 = classify_taps(cleaned, tap_diam, min_keep, tap_max_perimeter, tap_max_vertices, tap_max_dim)
        taps = taps2 if len(taps) == 0 else (taps + taps2)
    else:
        lines = []

    if post_enabled and lines:
        log(f"skeleton merge: {len(lines)} fragments")
        lines = skeleton_merge(lines, post_brush, post_step, post_rdp_eps, post_min_len)

    return reorder_intra(lines), taps
