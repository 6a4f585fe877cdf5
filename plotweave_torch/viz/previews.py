"""Rasterized stage previews (stages 06 / 09 / 11).

One renderer serves all three: per-layer black rendering plus a palette-
colored composite where any non-white pixel of a layer wins (reference
06_preview_scaled.py:76-137, 09_preview_intra.py:75-127, 11 similarly).

Copy of ``plotweave/viz/previews.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import cv2
import numpy as np

from ..vector.geometry import as_pts

BGR = Tuple[int, int, int]


# polylines at least this long are probed for a repeating vertex period —
# the reference's cycle walks can respin a tiny loop thousands of times
# (04_find_contours.py:174-205 closing-step walk under the 4×fg guard), so
# poster-scale layers carry millions of byte-mandated duplicate segments.
# Threshold sweep on the 4K poster's 8 layers (interleaved best-of-4, both
# renders): 4096 → 1.08 s, 1536 → 0.73 s, 1024 → 0.66 s, 768 → 0.67 s —
# mid-size spun contours are common there; detection on non-periodic
# contours bails after a few vectorized candidate probes, so the threshold
# costs little on ordinary images.  Elision is byte-exact at ANY threshold
# (fixpoint construction, fuzz-pinned), so this is purely a speed knob.
_PERIODIC_MIN = 1024


def _find_period(pts: np.ndarray):
    """(s, T, k) when pts contains ≥3 exact repeats of a T-vertex block
    starting at s (k = full periods usable for segment-exact elision)."""
    n = len(pts)
    j0 = n // 2
    if j0 + 2 >= n:
        return None
    # pack each int32 (x, y) into one int64 lane: every equality test below
    # becomes a single-column compare (detection-speed only — the detected
    # period, and the drawn bytes either way, are unchanged; measured ~2×
    # on the 4K poster's million-vertex spun layers)
    v = np.ascontiguousarray(pts, dtype=np.int32).view(np.int64).ravel()
    # the native detector additionally scans OUTWARD from the anchor instead
    # of materializing full n-element compares per candidate (same algorithm,
    # same result — parity fuzz-pinned in tests/test_previews_periodic.py)
    from ..native.api import find_period_native  # noqa: PLC0415

    res = find_period_native(v)
    if res != "unavailable":
        return res
    return _find_period_py(v, n, j0)


def _find_period_py(v: np.ndarray, n: int, j0: int):
    """Numpy reference detector (the PLOTWEAVE_NO_NATIVE fallback)."""
    # anchor at a TRANSITION pair (consecutive points differ) at/after the
    # midpoint: the reference's spun walks carry duplicate-point stretches of
    # varying lengths, where a duplicate pair recurs at several offsets per
    # period and the spacing statistics below point at the wrong T
    step = np.flatnonzero(v[j0 : n - 2] != v[j0 + 1 : n - 1])
    j = j0 + int(step[0]) if len(step) else j0
    hits = np.flatnonzero(
        (v[j + 1 : n - 1] == v[j]) & (v[j + 2 : n] == v[j + 1])
    )
    cands = []
    if len(hits) > 2:
        # duplicated vertices make the anchor pair recur at local offsets
        # too; the modal spacings between hits recover the true period —
        # try those first (early accept usually stops after one)
        diffs = np.diff(hits)
        vals, counts = np.unique(diffs, return_counts=True)
        top = vals[np.argsort(counts)[::-1][:4]]
        cands.extend(int(v) - 1 for v in top)
        if len(top) >= 2:
            # an anchor pair that recurs twice per period alternates two
            # spacings whose SUM is the true period
            cands.append(int(top[0]) + int(top[1]) - 1)
    cands.extend(int(h) for h in hits[:6])
    best = None
    for d in cands:
        T = int(d) + 1
        eq = v[T:] == v[:-T]  # eq[i]: pts[i+T] == pts[i]
        if j >= len(eq) or not eq[j]:
            continue
        falses = np.flatnonzero(~eq)
        before = falses[falses < j]
        after = falses[falses > j]
        s = int(before.max()) + 1 if len(before) else 0
        e = int(after.min()) if len(after) else len(eq)
        # pass m (1-based) reuses vertices up to s+(m+1)·T; the equality
        # chain pts[i+T]==pts[i] holds for i ∈ [s, e), so the last reusable
        # vertex is e+T-1 → k ≤ (e-s-1)//T + 1; and every pass's vertices
        # must exist → k ≤ (n-1-s)//T
        k = min((e - s - 1) // T + 1, (n - 1 - s) // T)
        # a tiny-T run (duplicate-point stretches) also "matches": rank by
        # elided coverage and keep the candidate that skips the most
        if k >= 3 and (best is None or k * T > best[1] * best[2]):
            best = (s, T, k)
            if k * T >= n // 2:
                break  # covers most of the polyline — good enough
    if best is not None and best[1] * best[2] >= n // 8:
        return best
    return None


def _draw_polyline_periodic(img, pts: np.ndarray, color, thickness: int, lt,
                            found=None, batch=None, flush=None) -> bool:
    """Draw a long spun polyline with fixpoint elision; False → caller draws
    it plainly.

    The segment sequence is split into prefix (through the first full
    period), k-1 repeat passes (pixel-identical segment lists, drawn in the
    original order), and the tail.  AA blending is a deterministic
    canvas→canvas map, so once one pass leaves its region unchanged every
    remaining identical pass is a no-op — elision is byte-exact, not an
    approximation (fuzz-pinned: tests/test_previews_periodic.py).

    When the caller's pending ordinary ``batch`` (+ ``flush``) is provided,
    the prefix joins it (one cv2 call instead of two) and the tail is left
    in the batch for the caller's next flush — draw order is unchanged
    because cv2.polylines renders its list sequentially.  Repeat passes run
    in geometrically growing groups ([period]*g per call) with the fixpoint
    check per group: any pass beyond the fixpoint inside a group is a no-op,
    so the final bytes are identical to the pass-by-pass loop."""
    if found is None:
        found = _find_period(pts)
    if found is None:
        return False
    s, T, k = found
    period = pts[s : s + T + 1].reshape(-1, 1, 2)
    # region the repeat passes can touch, with stamp margin
    x0, y0 = period.reshape(-1, 2).min(axis=0) - (thickness + 3)
    x1, y1 = period.reshape(-1, 2).max(axis=0) + (thickness + 4)
    h, w = img.shape[:2]
    x0, y0 = max(0, int(x0)), max(0, int(y0))
    x1, y1 = min(w, int(x1)), min(h, int(y1))
    prefix = pts[: s + T + 1].reshape(-1, 1, 2)
    if batch is not None:
        batch.append(prefix)
        flush()
    else:
        cv2.polylines(img, [prefix], False, color, thickness, lt)
    done, group = 0, 1
    while done < k - 1:
        g = min(group, k - 1 - done)
        before = img[y0:y1, x0:x1].copy()
        cv2.polylines(img, [period] * g, False, color, thickness, lt)
        done += g
        if (img[y0:y1, x0:x1] == before).all():
            break  # fixpoint: every further identical pass is a no-op
        group <<= 1
    tail = pts[s + k * T :]
    if len(tail) >= 2:
        if batch is not None:
            batch.append(tail.reshape(-1, 1, 2))  # next flush keeps the order
        else:
            cv2.polylines(img, [tail.reshape(-1, 1, 2)], False, color, thickness, lt)
    return True


def render_layer(
    size_wh: Tuple[int, int],
    lines: List[np.ndarray],
    color: BGR,
    thickness: int,
    antialiased: bool,
    taps: Optional[List[Tuple[int, int]]] = None,
    tap_color: Optional[BGR] = None,
    tap_radius: int = 0,
    period_memo: Optional[dict] = None,
) -> np.ndarray:
    w, h = size_wh
    img = np.full((h, w, 3), 255, np.uint8)
    lt = cv2.LINE_AA if antialiased else cv2.LINE_8
    # one cv2 call per run of ordinary polylines (each is still drawn
    # independently, in order — identical pixels to per-contour calls);
    # long spun polylines take the byte-exact periodic fixpoint path
    batch: List[np.ndarray] = []

    def flush():
        if batch:
            cv2.polylines(img, batch, False, color, thickness, lt)
            batch.clear()

    _MISS = object()
    for p in lines:
        if p is None:
            continue
        a = as_pts(p).reshape(-1, 1, 2).astype(np.int32)
        if len(a) < 2:
            continue
        if len(a) >= _PERIODIC_MIN:
            # period structure depends only on the points — memoize it across
            # the per-layer black and palette-colored renders (id(p) is
            # stable: the caller holds the lines list for both renders)
            found = period_memo.get(id(p), _MISS) if period_memo is not None else _MISS
            if found is _MISS:
                found = _find_period(a[:, 0, :])
                if period_memo is not None:
                    period_memo[id(p)] = found
            if found is None or not _draw_polyline_periodic(
                img, a[:, 0, :], color, thickness, lt, found=found,
                batch=batch, flush=flush,
            ):
                batch.append(a)
        else:
            batch.append(a)
    flush()
    if taps:
        for x, y in taps:
            cv2.circle(img, (int(x), int(y)), int(tap_radius), tap_color or color, -1, cv2.LINE_AA)
    return img


def overlay_nonwhite(composite: np.ndarray, layer_img: np.ndarray) -> None:
    """composite[p] = layer_img[p] wherever layer_img[p] != (255,255,255)."""
    white = cv2.inRange(layer_img, (255, 255, 255), (255, 255, 255))
    cv2.copyTo(layer_img, cv2.bitwise_not(white), composite)


def render_stage_previews(
    out_dir: str,
    size_wh: Tuple[int, int],
    layers: List[Tuple[str, List[np.ndarray], Optional[List[Tuple[int, int]]]]],
    palette: Dict[str, BGR],
    per_layer_name: str,
    composite_name: str,
    thickness: int,
    antialiased: bool,
    tap_radius: int = 0,
    tap_color_black_pass: BGR = (0, 0, 255),
) -> str:
    """Write <layer>/<per_layer_name> + <out_dir>/<composite_name>.

    Layers render concurrently (cv2 releases the GIL; each layer's render and
    PNG write are independent), then composite overlays apply in layer order —
    output bytes are identical to the sequential loop.
    """
    from ..utils import thread_map  # noqa: PLC0415

    composite = np.full((size_wh[1], size_wh[0], 3), 255, np.uint8)

    def one(layer):
        name, lines, taps = layer
        d = os.path.join(out_dir, name)
        os.makedirs(d, exist_ok=True)
        memo: dict = {}  # share period detection between the two renders
        black = render_layer(
            size_wh, lines, (0, 0, 0), thickness, antialiased,
            taps=taps, tap_color=tap_color_black_pass, tap_radius=tap_radius,
            period_memo=memo,
        )
        cv2.imwrite(os.path.join(d, per_layer_name), black)
        col = palette.get(name, (0, 0, 0))
        return render_layer(
            size_wh, lines, col, thickness, antialiased,
            taps=taps, tap_color=col, tap_radius=tap_radius,
            period_memo=memo,
        )

    colored_layers = thread_map(one, layers)
    for (name, lines, taps), colored in zip(layers, colored_layers):
        overlay_nonwhite(composite, colored)
        print(f"[preview] {name}: lines={len(lines)}, taps={len(taps or [])}")
    out = os.path.join(out_dir, composite_name)
    cv2.imwrite(out, composite)
    print(f"[preview] composite saved: {out}")
    return out
