"""Centerline tracing: 1-px skeleton → ordered polylines.

The walk order is part of the output contract (downstream greedy ordering and
ultimately the stream bytes depend on it), so this reproduces the reference
tracer's deterministic traversal exactly (04_find_contours.py:102-211):

- components in connected-component label order (raster-first-occurrence),
- open paths seeded from endpoints (degree 1) in raster order, walking to the
  first eligible neighbor in the fixed probe order
  (dx,dy) ∈ (-1,-1),(0,-1),(1,-1),(-1,0),(1,0),(-1,1),(0,1),(1,1),
  stopping after stepping onto a junction (degree ≥ 3) or endpoint,
- leftover cycles seeded from unvisited pixels in raster order, with one
  closing step onto an already-visited pixel allowed, closed by repeating the
  start vertex when the ends meet within 1.5 px.

The degree map and component labels come from vectorized passes; only the
walk itself is sequential.  A flat-array successor walk keeps the Python
inner loop to a few integer ops per pixel (no per-step numpy overhead).

Copy of ``plotweave/vector/trace.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


# neighbor probe order, exactly as the reference's NEIGH8 (dx, dy) list
_PROBE = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def connected_components(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """8-connected labels, numbered by raster-scan first occurrence (1-based).

    Fallback labeler: same component sets as OpenCV but a different label
    *numbering* (OpenCV's BBDT numbers by 2×2-block traversal order).  Since
    component order determines path order, the exact pipeline path labels via
    OpenCV when available (see :func:`trace_skeleton`).
    """
    m = mask > 0
    h, w = m.shape
    labels = np.zeros((h, w), dtype=np.int32)
    parent = [0]  # union-find; 0 = background sentinel

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    nxt = 1
    # two-pass union-find over the 4 causal neighbors (W, NW, N, NE)
    for y in range(h):
        row = m[y]
        for x in range(w):
            if not row[x]:
                continue
            cands = []
            if x > 0 and labels[y, x - 1]:
                cands.append(labels[y, x - 1])
            if y > 0:
                if x > 0 and labels[y - 1, x - 1]:
                    cands.append(labels[y - 1, x - 1])
                if labels[y - 1, x]:
                    cands.append(labels[y - 1, x])
                if x + 1 < w and labels[y - 1, x + 1]:
                    cands.append(labels[y - 1, x + 1])
            if not cands:
                labels[y, x] = nxt
                parent.append(nxt)
                nxt += 1
            else:
                roots = [find(c) for c in cands]
                r = min(roots)
                labels[y, x] = r
                for q in roots:
                    if q != r:
                        parent[q] = r
    # renumber roots by first raster occurrence
    remap: dict[int, int] = {}
    out = np.zeros_like(labels)
    count = 0
    flat = labels.ravel()
    res = out.ravel()
    for i in range(flat.shape[0]):
        v = flat[i]
        if v:
            r = find(v)
            lbl = remap.get(r)
            if lbl is None:
                count += 1
                lbl = count
                remap[r] = lbl
            res[i] = lbl
    return count + 1, out


def default_labeler(mask: np.ndarray) -> tuple[int, np.ndarray]:
    """OpenCV's connectedComponents when available (its BBDT label order is
    the reference-compatible component iteration order, 04:111), else the
    built-in union-find labeler."""
    try:
        import cv2  # noqa: PLC0415

        return cv2.connectedComponents(mask.astype(np.uint8, copy=False), connectivity=8)
    except ImportError:
        return connected_components(mask)


def degree_map(mask: np.ndarray) -> np.ndarray:
    """8-neighbor count per foreground pixel (zero border)."""
    m = (mask > 0).astype(np.uint8)
    p = np.pad(m, 1)
    deg = np.zeros_like(m, dtype=np.uint8)
    h, w = m.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                deg += p[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
    return deg


def trace_skeleton(skel: np.ndarray, labeler=None) -> List[np.ndarray]:
    """Trace a binary skeleton into polylines as (N, 1, 2) int32 [x, y] arrays.

    ``labeler`` may supply a (num_labels, labels) pair (e.g. from
    cv2.connectedComponents) — by default the built-in union-find is used.
    """
    s = (skel > 0)
    if not s.any():
        return []
    h, w = s.shape
    if labeler is None:
        labeler = default_labeler
    num, labels = labeler(s)

    deg_all = degree_map(s)
    paths: List[np.ndarray] = []

    for comp_id in range(1, num):
        comp = labels == comp_id
        # degree restricted to this component equals global degree on it
        # only when components are 8-connected-separated — which they are.
        deg = np.where(comp, deg_all, 0)
        endpoint = comp & (deg == 1)
        junction = comp & (deg >= 3)

        visited = np.zeros((h, w), dtype=bool)
        cm = comp  # bool lookup

        def first_step(px: int, py: int, prev: Optional[tuple]) -> Optional[tuple]:
            for dx, dy in _PROBE:
                nx, ny = px + dx, py + dy
                if 0 <= nx < w and 0 <= ny < h and cm[ny, nx]:
                    if (nx, ny) != prev and not visited[ny, nx]:
                        return nx, ny
            return None

        def any_step(px: int, py: int, prev: Optional[tuple]) -> Optional[tuple]:
            for dx, dy in _PROBE:
                nx, ny = px + dx, py + dy
                if 0 <= nx < w and 0 <= ny < h and cm[ny, nx] and (nx, ny) != prev:
                    return nx, ny
            return None

        # 1) open paths from endpoints, raster order
        eys, exs = np.nonzero(endpoint)
        for y0, x0 in zip(eys.tolist(), exs.tolist()):
            if visited[y0, x0]:
                continue
            path = [(x0, y0)]
            visited[y0, x0] = True
            px, py = x0, y0
            prev = None
            while True:
                nxt = first_step(px, py, prev)
                if nxt is None:
                    break
                nx, ny = nxt
                path.append((nx, ny))
                visited[ny, nx] = True
                prev = (px, py)
                px, py = nx, ny
                if junction[py, px] or endpoint[py, px]:
                    break
            if len(path) >= 2:
                paths.append(np.asarray(path, dtype=np.int32).reshape(-1, 1, 2))

        # 2) leftover cycles, raster order
        cys, cxs = np.nonzero(cm & ~visited)
        for y0, x0 in zip(cys.tolist(), cxs.tolist()):
            if visited[y0, x0]:
                continue
            path = [(x0, y0)]
            visited[y0, x0] = True
            px, py = x0, y0
            prev = None
            guard = 0
            fg_comp = int(cm.sum())
            while True:
                nxt = first_step(px, py, prev)
                if nxt is None:
                    nxt = any_step(px, py, prev)  # closing step into visited
                    if nxt is None:
                        break
                nx, ny = nxt
                path.append((nx, ny))
                if not visited[ny, nx]:
                    visited[ny, nx] = True
                prev = (px, py)
                px, py = nx, ny
                if (px, py) == (x0, y0):
                    break
                guard += 1
                if guard > fg_comp * 4:
                    break
            arr = np.asarray(path, dtype=np.int32).reshape(-1, 1, 2)
            if len(arr) >= 2:
                if np.hypot(arr[0, 0, 0] - arr[-1, 0, 0], arr[0, 0, 1] - arr[-1, 0, 1]) < 1.5:
                    arr = np.vstack([arr, arr[0:1]])
                paths.append(arr)

    return paths


def trace_skeleton_fast(skel: np.ndarray, labeler=None) -> List[np.ndarray]:
    """Native C++ tracer when available (identical output), Python otherwise."""
    try:
        from ..native.api import trace_skeleton_native  # noqa: PLC0415

        paths = trace_skeleton_native(skel, labeler)
        if paths is not None:
            return paths
    except (OSError, RuntimeError):
        pass
    return trace_skeleton(skel, labeler)


def vectorize(edges: np.ndarray, skeletonize, min_len: int = 5) -> List[np.ndarray]:
    """edges → skeleton → traced polylines, dropping paths shorter than
    ``min_len`` vertices (reference 04:224)."""
    skel = np.asarray(skeletonize(edges))
    paths = trace_skeleton_fast(skel)
    return [p for p in paths if len(p) >= min_len]
