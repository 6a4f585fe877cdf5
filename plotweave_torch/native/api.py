"""High-level wrappers over the native library.

``NativeStreamBuilder`` mirrors plotweave.stream.StreamBuilder's interface;
``trace_skeleton_native`` mirrors plotweave.vector.trace.trace_skeleton.
Both are drop-in and bit-identical (fuzz-tested against the Python paths).

Copy of ``plotweave/native/api.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..stream.encoder import MotionProfile
from .loader import PwProfile, get_lib


def to_pw_profile(p: MotionProfile) -> PwProfile:
    return PwProfile(
        div_start=int(p.div_start),
        div_fast=int(p.div_fast),
        profile_scurve=1 if p.profile == "scurve" else 0,
        corner_deg=float(p.corner_deg),
        corner_div=int(p.corner_div),
        corner_window_steps=int(p.corner_window_steps),
        short_len_steps=int(p.short_len_steps),
        short_div=int(p.short_div),
        travel_div_fast=int(p.travel_div_fast),
        travel_start_div=int(p.travel_start_div),
        travel_window_steps=int(p.travel_window_steps),
        travel_quant_step=int(p.travel_quant_step),
    )


class NativeStreamBuilder:
    """C++-backed stream writer (same interface as StreamBuilder plus
    profile-aware polyline/travel emission)."""

    def __init__(self):
        self._lib = get_lib()
        if self._lib is None:
            raise RuntimeError("native library unavailable")
        self._h = self._lib.pw_writer_new()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pw_writer_free(self._h)
            self._h = None

    def pen_up(self):
        self._lib.pw_pen_up(self._h)

    def pen_down(self):
        self._lib.pw_pen_down(self._h)

    def tap(self):
        self._lib.pw_tap(self._h)

    def select_color(self, idx: int):
        if not 0 <= int(idx) <= 7:
            raise ValueError("color index must be 0..7")
        self._lib.pw_color(self._h, int(idx))

    def speed(self, divider: int):
        self._lib.pw_set_speed(self._h, int(divider))

    def polyline(self, pts: Sequence[Tuple[int, int]], prof: MotionProfile):
        arr = np.ascontiguousarray(np.asarray(pts, dtype=np.int32).reshape(-1, 2))
        if len(arr) < 2:
            return
        pp = to_pw_profile(prof)
        self._lib.pw_polyline(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(arr), ctypes.byref(pp)
        )

    def travel(self, x0: int, y0: int, x1: int, y1: int, prof: MotionProfile):
        pp = to_pw_profile(prof)
        self._lib.pw_travel(self._h, int(x0), int(y0), int(x1), int(y1), ctypes.byref(pp))

    def __len__(self) -> int:
        return int(self._lib.pw_size(self._h))

    def finish(self) -> bytes:
        cap = len(self) + 1 + 1024
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.pw_finalize(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if n < 0:
            raise RuntimeError("finalize capacity error")
        return out[:n].tobytes()


# adaptive pw_trace output-capacity factor (points per foreground pixel);
# raised after any overflow so sibling layers avoid the dry-count walk
_TRACE_CAP_FACTOR = 16


def trace_skeleton_native(
    skel: np.ndarray, labeler=None
) -> Optional[List[np.ndarray]]:
    """Native centerline tracer; returns None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from .loader import bind_skeleton_ops  # noqa: PLC0415
    from ..vector.trace import default_labeler  # noqa: PLC0415

    bind_skeleton_ops(lib)
    # the host here is memory-bandwidth-poor: avoid every avoidable full-res
    # pass/copy (cv2 treats any nonzero as foreground, so 0/1 or 0/255 uint8
    # input goes to the labeler as-is; the degree map is computed natively)
    if skel.dtype == np.uint8:
        m8 = np.ascontiguousarray(skel)
    else:
        m8 = np.ascontiguousarray((skel > 0).astype(np.uint8))
    fg = int(np.count_nonzero(m8))
    if fg == 0:
        return []
    num, labels = (labeler or default_labeler)(m8)
    labels = np.ascontiguousarray(labels.astype(np.int32, copy=False))
    h, w = labels.shape
    deg = np.empty((h, w), np.uint8)
    lib.pw_degree(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h,
        w,
        deg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    # cycle walks may legitimately revisit pixels (guarded at 4× per walk,
    # reference semantics), so total output can far exceed fg.  On overflow
    # pw_trace dry-counts the rest and returns -(points needed): exactly one
    # re-walk with the right capacity (spin-heavy posters used to pay 2-3
    # geometric blind retries here).  The capacity factor tracks the LAST
    # call's need — sibling layers of a spin-heavy poster size right on
    # their first walk, and one heavy layer doesn't make every later call
    # over-allocate forever (worst case per transition: one dry-count
    # retry, i.e. ≤2× walk cost).
    global _TRACE_CAP_FACTOR
    cap_pts = fg * _TRACE_CAP_FACTOR + 64
    cap_paths = max(fg + 16, cap_pts // 2)
    n = -1
    for _ in range(2):
        out_xy = np.empty((cap_pts, 2), dtype=np.int32)
        out_lens = np.empty(cap_paths, dtype=np.int32)
        n = lib.pw_trace(
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            deg.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            h,
            w,
            int(num),
            out_xy.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap_pts,
            out_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            cap_paths,
        )
        if n >= 0:
            break
        cap_pts = -n + 8
        cap_paths = cap_pts  # npaths ≤ npts/2 — always covered
        _TRACE_CAP_FACTOR = min(256, max(_TRACE_CAP_FACTOR, cap_pts // max(1, fg) + 1))
    if n < 0:
        return None  # pathological: fall back to the Python tracer
    lens = out_lens[:n].astype(np.int64, copy=False)
    offs = np.concatenate([[0], np.cumsum(lens)])
    used = int(offs[-1])
    # track the factor this call actually needed (+1 period headroom) instead
    # of ratcheting to the process-wide max forever: one spin-heavy layer
    # must not make every later layer/image allocate fg*256 points up front.
    # Benign data race under thread_map (worst case: one extra dry-count
    # retry on a lost update).
    _TRACE_CAP_FACTOR = min(256, max(2, used // max(1, fg) + 2))
    # disjoint views into the walk buffer (no compaction copy when the
    # buffer is near-exactly sized — a large memcpy costs real page-fault
    # time on this host).  When the adaptive capacity overshot, compact so
    # the returned contours don't pin the oversized walk buffer for their
    # whole lifetime.
    if used * 4 < cap_pts:
        out_xy = out_xy[:used].copy()
    return [out_xy[offs[i] : offs[i + 1]].reshape(-1, 1, 2) for i in range(n)]


class LineStampTable:
    """Span table of cv2 thick-line rasterizations for every integer delta in
    [-R..R]²: cv2 thick lines are translation-invariant, so the native loop
    can stamp by translating pre-rendered spans — bit-identical to cv2.line.
    """

    def __init__(self, thickness: int, R: int):
        import cv2  # noqa: PLC0415

        self.thickness = int(thickness)
        self.R = int(R)
        side = 2 * R + 1
        m = R + thickness + 4
        rows, x0s, x1s = [], [], []
        start = np.zeros(side * side, np.int64)
        count = np.zeros(side * side, np.int32)
        scratch = np.zeros((2 * m + 1, 2 * m + 1), np.uint8)
        for dy in range(-R, R + 1):
            for dx in range(-R, R + 1):
                scratch[:] = 0
                cv2.line(scratch, (m, m), (m + dx, m + dy), 255,
                         thickness=self.thickness, lineType=cv2.LINE_8)
                key = (dy + R) * side + (dx + R)
                start[key] = len(rows)
                ys, xs = np.nonzero(scratch)
                if len(ys):
                    # exact run-length spans per row (cv2 thick lines are NOT
                    # always row-convex: the round end caps can leave in-row
                    # gaps to the body quad, so each contiguous run is kept)
                    order = np.lexsort((xs, ys))
                    ys, xs = ys[order], xs[order]
                    brk = np.nonzero((np.diff(ys) != 0) | (np.diff(xs) != 1))[0]
                    starts_i = np.concatenate([[0], brk + 1])
                    ends_i = np.concatenate([brk, [len(ys) - 1]])
                    for a, b in zip(starts_i, ends_i):
                        rows.append(int(ys[a]) - m)
                        x0s.append(int(xs[a]) - m)
                        x1s.append(int(xs[b]) - m)
                count[key] = len(rows) - start[key]
        self.span_start = np.ascontiguousarray(start)
        self.span_count = np.ascontiguousarray(count)
        self.span_row = np.ascontiguousarray(np.asarray(rows, np.int32))
        self.span_x0 = np.ascontiguousarray(np.asarray(x0s, np.int32))
        self.span_x1 = np.ascontiguousarray(np.asarray(x1s, np.int32))
        # translation invariance holds only for UNCLIPPED renders: cv2's
        # thick-line code clips the center segment against the image rect
        # before thickening, so a stamp whose unclipped extent crosses the
        # border rasterizes differently than the translated interior stamp
        # (measured: ±1-px diffs both ways).  Callers must route any contour
        # that could anchor a stamp within ``extent`` of the border through
        # the Python cv2 path instead.
        if len(rows):
            self.extent = int(max(
                int(np.abs(self.span_row).max()),
                int(np.abs(self.span_x0).max()),
                int(np.abs(self.span_x1).max()),
            ))
        else:
            self.extent = 0


_STAMP_CACHE: dict = {}


def virtual_draw_native(samples, canvas, grid_radius, grid_cell, tail_len_px, brush, max_delta):
    """Native stage-08 virtual draw.  Returns list of fragments, or None when
    the native path cannot run exactly (library unavailable, samples leave
    the canvas, or a stamp delta outside the table)."""
    from .loader import bind_virtual_draw  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_virtual_draw(lib)

    h, w = canvas.shape
    sx = np.ascontiguousarray(samples[:, 0], dtype=np.float64)
    sy = np.ascontiguousarray(samples[:, 1], dtype=np.float64)

    key = (int(brush), int(max_delta))
    table = _STAMP_CACHE.get(key)
    if table is None:
        table = LineStampTable(int(brush), int(max_delta))
        _STAMP_CACHE[key] = table

    # pre-screen: off-canvas samples break the bounded-delta guarantee, and
    # samples within the stamp extent of the border could anchor a clipped
    # stamp, where cv2's rendering is not translation-invariant (see
    # LineStampTable.extent) — both go through the exact Python path
    e = table.extent
    rx = np.rint(sx)
    ry = np.rint(sy)
    if ((rx < e) | (rx >= w - e) | (ry < e) | (ry >= h - e)).any():
        return None

    n = len(sx)
    cap_pts = n + 8
    cap_frags = n + 8
    out_x = np.empty(cap_pts, np.float64)
    out_y = np.empty(cap_pts, np.float64)
    frag_lens = np.empty(cap_frags, np.int32)

    dp = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    nfrags = lib.pw_virtual_draw(
        sx.ctypes.data_as(dp), sy.ctypes.data_as(dp), n,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        float(tail_len_px), float(grid_radius), float(grid_cell),
        table.R,
        table.span_start.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        table.span_count.ctypes.data_as(i32p),
        table.span_row.ctypes.data_as(i32p),
        table.span_x0.ctypes.data_as(i32p),
        table.span_x1.ctypes.data_as(i32p),
        out_x.ctypes.data_as(dp), out_y.ctypes.data_as(dp), cap_pts,
        frag_lens.ctypes.data_as(i32p), cap_frags,
    )
    if nfrags < 0:
        return None
    frags = []
    off = 0
    for i in range(nfrags):
        ln = int(frag_lens[i])
        pts = np.stack([out_x[off : off + ln], out_y[off : off + ln]], axis=1)
        frags.append(pts.astype(np.int32).reshape(-1, 1, 2))
        off += ln
    return frags


def resample_batch_native(p32s, closed_flags, step: float) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Batched resample_arclen over opened (n, 2) float32 contours.

    Returns (samples_x f64, samples_y f64, offsets int64) concatenated over
    contours, or None when the native library is unavailable.  Bit-exact vs
    the per-contour Python resample (fuzz-pinned, test_native_virtual_draw)."""
    from .loader import bind_virtual_draw  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_virtual_draw(lib)

    k = len(p32s)
    lens = np.fromiter((len(p) for p in p32s), np.int64, count=k)
    offs = np.zeros(k + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    if offs[-1] == 0:
        z = np.zeros(0, np.float64)
        return z, z, offs
    big = np.concatenate([p.reshape(-1, 2) for p in p32s]).astype(np.float32, copy=False)
    px = np.ascontiguousarray(big[:, 0])
    py = np.ascontiguousarray(big[:, 1])
    cl = np.ascontiguousarray(np.asarray(closed_flags, dtype=np.uint8))

    dp = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    # sample count ≈ arc length / step per contour; the L1 segment sum
    # (|dx|+|dy| ≥ √(dx²+dy²) per segment) upper-bounds it without the
    # float64 hypot pass that measured ~0.1 s on a spun 4K layer — the ≤41%
    # buffer overshoot is cheap next to a capacity-retry re-walk
    d = np.diff(big, axis=0)
    est = float(np.abs(d, out=d).sum(dtype=np.float64)) / max(1e-9, float(step))
    cap = int(offs[-1] + est * 1.01 + 8 * k + 64)  # cross-boundary segs only pad
    for _ in range(8):
        out_x = np.empty(cap, np.float64)
        out_y = np.empty(cap, np.float64)
        out_offs = np.empty(k + 1, np.int64)
        n = lib.pw_resample_batch(
            px.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            py.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            offs.ctypes.data_as(i64p), k,
            cl.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            float(step),
            out_x.ctypes.data_as(dp), out_y.ctypes.data_as(dp), cap,
            out_offs.ctypes.data_as(i64p),
        )
        if n >= 0:
            return out_x[:n], out_y[:n], out_offs
        # -n = minimum capacity through the overflowing contour; geometric
        # growth terminates (total need is finite)
        cap = max(int(-n) * 2, cap * 2)
    return None


def virtual_draw_batch_native(
    sx, sy, soffs, canvas, grid_radius, grid_cell, tail_len_px, brush, max_delta
):
    """Batched pass-A virtual draw of contours [soffs[i], soffs[i+1]) against
    the shared ``canvas`` (same per-contour semantics as virtual_draw_native).

    Returns (frags_per_contour, done) where ``done`` counts contours fully
    processed (== len(soffs)-1 normally; fewer when a contour hits a native
    contract edge — the caller replays THAT contour in Python and re-enters
    with the remainder).  None when the library is unavailable."""
    from .loader import bind_virtual_draw  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_virtual_draw(lib)

    k = len(soffs) - 1
    if k <= 0:
        return [], 0

    key = (int(brush), int(max_delta))
    table = _STAMP_CACHE.get(key)
    if table is None:
        table = LineStampTable(int(brush), int(max_delta))
        _STAMP_CACHE[key] = table

    total = int(soffs[-1] - soffs[0])
    base = int(soffs[0])
    sx = np.ascontiguousarray(sx[base : base + total], np.float64)
    sy = np.ascontiguousarray(sy[base : base + total], np.float64)
    rel = np.ascontiguousarray(np.asarray(soffs, np.int64) - base)

    cap_pts = total + 8
    cap_frags = total // 2 + k + 8
    out_x = np.empty(cap_pts, np.float64)
    out_y = np.empty(cap_pts, np.float64)
    frag_lens = np.empty(cap_frags, np.int32)
    frag_counts = np.zeros(k, np.int32)
    done = np.zeros(1, np.int64)

    dp = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    h, w = canvas.shape
    nfrags = lib.pw_virtual_draw_batch(
        sx.ctypes.data_as(dp), sy.ctypes.data_as(dp),
        rel.ctypes.data_as(i64p), k,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w,
        float(tail_len_px), float(grid_radius), float(grid_cell),
        table.R,
        table.span_start.ctypes.data_as(i64p),
        table.span_count.ctypes.data_as(i32p),
        table.span_row.ctypes.data_as(i32p),
        table.span_x0.ctypes.data_as(i32p),
        table.span_x1.ctypes.data_as(i32p),
        out_x.ctypes.data_as(dp), out_y.ctypes.data_as(dp), cap_pts,
        frag_lens.ctypes.data_as(i32p), cap_frags,
        frag_counts.ctypes.data_as(i32p),
        done.ctypes.data_as(i64p),
    )
    ndone = int(done[0])
    if nfrags < 0 and ndone == 0:
        return [], 0
    total_frags = int(frag_counts[:ndone].sum()) if nfrags < 0 else int(nfrags)
    lens = frag_lens[:total_frags].astype(np.int64)
    used = int(lens.sum())
    # one bulk float64 → int32 truncation, then per-fragment views
    pts = np.empty((used, 2), np.float64)
    pts[:, 0] = out_x[:used]
    pts[:, 1] = out_y[:used]
    ptsi = pts.astype(np.int32)
    frag_offs = np.concatenate([[0], np.cumsum(lens)])
    per_contour = []
    fi = 0
    for c in range(ndone):
        nfc = int(frag_counts[c])
        frags = [
            ptsi[frag_offs[fi + j] : frag_offs[fi + j + 1]].reshape(-1, 1, 2)
            for j in range(nfc)
        ]
        fi += nfc
        per_contour.append(frags)
    return per_contour, ndone


def cv_kmeans_native(
    data: np.ndarray, K: int, max_count: int, epsilon: float, attempts: int, state: int
) -> Optional[Tuple[float, np.ndarray, np.ndarray]]:
    """Native cv2-exact kmeans (see ops/cvkmeans.py); None if unavailable."""
    from .loader import bind_cv_kmeans  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_cv_kmeans(lib)
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, dims = data.shape
    centers = np.empty((K, dims), dtype=np.float32)
    labels = np.empty(n, dtype=np.int32)
    comp = lib.pw_cv_kmeans(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        dims,
        int(K),
        int(max_count),
        float(epsilon),
        int(attempts),
        ctypes.c_uint64(state),
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if np.isnan(comp):
        # kmeans++ found no finite trial cost (all-NaN data): OpenCV raises
        # CV_Error here and the Python fallback raises RuntimeError — match it
        raise RuntimeError("kmeans++ seeding failed (non-finite data?)")
    return float(comp), labels, centers


def km_assign_native(lab_u8: np.ndarray, centers: np.ndarray) -> Optional[np.ndarray]:
    """Nearest-center labels for (N, dims) uint8 data; None if unavailable."""
    from .loader import bind_cv_kmeans  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_cv_kmeans(lib)
    lab_u8 = np.ascontiguousarray(lab_u8, dtype=np.uint8)
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    n, dims = lab_u8.shape
    out = np.empty(n, dtype=np.uint8)
    lib.pw_km_assign(
        lab_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        centers.shape[0],
        dims,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out


def thin_native(roi: np.ndarray, max_iter: int, rotated: bool) -> Optional[np.ndarray]:
    """Native Zhang–Suen; 0/1 uint8 skeleton, or None if unavailable.
    Bit-identical to ops.thinning.zhang_suen (fuzz-tested)."""
    from .loader import bind_skeleton_ops  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_skeleton_ops(lib)
    h, w = roi.shape
    buf = np.array(roi, dtype=np.uint8, order="C")  # one owning copy
    lib.pw_thin(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        int(max_iter),
        1 if rotated else 0,
    )
    return buf


def component_path_native(
    labels: np.ndarray,
    cc: int,
    a: Optional[Tuple[int, int]],
    b: Optional[Tuple[int, int]],
    min_len: int,
) -> Optional[np.ndarray]:
    """Native _component_path over a connected-component label image.
    ``a``/``b`` are (y, x) anchors or None.  Returns the path as an (n, 2)
    int32 [y, x] array (length 0 when no admissible path), or None if the
    library is missing."""
    from .loader import bind_skeleton_ops  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_skeleton_ops(lib)
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = lab.shape
    out = np.empty(((h * w), 2), dtype=np.int32)
    ay, ax = (a if a is not None else (0, 0))
    by, bx = (b if b is not None else (0, 0))
    n = lib.pw_comp_path(
        lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h,
        w,
        int(cc),
        int(ay),
        int(ax),
        1 if a is not None else 0,
        int(by),
        int(bx),
        1 if b is not None else 0,
        int(min_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h * w,
    )
    return out[:n] if n > 0 else out[:0]


def component_paths_all_native(
    labels: np.ndarray,
    num: int,
    a: Optional[Tuple[int, int]],
    b: Optional[Tuple[int, int]],
    min_len: int,
) -> Optional[list]:
    """All components' :func:`component_path_native` results in ONE call
    (pw_comp_paths_all): list of (n, 2) int32 [y, x] paths indexed by
    ``cc - 1`` (length 0 = no admissible path, exactly like the per-cc
    call's empty return), or None if the library is missing.  The batched
    entry shares stamped BFS buffers and one seed pass across components —
    the per-call full-ROI clears dominated stage 08's skeleton merge."""
    from .loader import bind_skeleton_ops  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_skeleton_ops(lib)
    lab = np.ascontiguousarray(labels, dtype=np.int32)
    h, w = lab.shape
    cap = h * w + 16  # total path points are bounded by the foreground count
    out = np.empty((cap, 2), dtype=np.int32)
    lens = np.zeros(max(1, int(num) - 1), dtype=np.int64)
    ay, ax = (a if a is not None else (0, 0))
    by, bx = (b if b is not None else (0, 0))
    lib.pw_comp_paths_all(
        lab.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        h,
        w,
        int(num),
        int(ay),
        int(ax),
        1 if a is not None else 0,
        int(by),
        int(bx),
        1 if b is not None else 0,
        int(min_len),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        cap,
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    paths, off = [], 0
    for i in range(int(num) - 1):
        ln = int(lens[i])
        paths.append(out[off : off + ln].copy())
        off += ln
    return paths


# NOTE: no native RDP — the reference's keep-mask distances go through
# numpy's f32 matmul, whose BLAS kernels are size-dispatched with mixed
# per-element fma forms (measured round 5); those bytes are oracle-pinned,
# so the Python rdp_simplify stays (see vector/geometry.py).


# verdict marker: the document has a non-finite value (inf/nan literal or
# overflow — CPython float("1e999") saturates to ±inf, it does NOT raise)
# on a token the exact G-code parser would float(); the caller must
# dispatch the document to the exact line-by-line parser
GCODE_NEEDS_EXACT = object()


def gcode_tokens_native(text: str):
    """Native tokenizer for the vectorized G-code parser.

    Input is the "\\n"-normalized document text.  Returns
    ``(cmds uint8 uppercased-first-chars, vals float64, line_id int32)``
    post-comment-strip, exactly the arrays the regex tokenizer in
    frontends/gcode.py computes (fuzz-pinned); None when the library is
    missing or the text is non-ASCII (Python's str whitespace/float()
    accept Unicode the C scanner must not guess at); or
    :data:`GCODE_NEEDS_EXACT` when a G/M/X/Y/Z token carries a non-finite
    value — inf (literal or overflow) or a nan coordinate literal — whose
    CPython semantics (int(inf) → OverflowError on G/M, nan/inf flowing
    into the geometry on X/Y/Z) only the exact parser reproduces.
    """
    from .loader import bind_skeleton_ops  # noqa: PLC0415

    lib = get_lib()
    if lib is None or not text.isascii() or "\x00" in text:
        return None  # c_char_p would truncate at a literal NUL
    # ASCII information separators are regex-\s whitespace for str patterns
    # but \x1f survives str.splitlines() normalization (\x1c-\x1e do not;
    # gated anyway in case of un-normalized input) — the C scanner only
    # splits on {' ', '\t'}, so these must take the regex path
    if any(c in text for c in "\x1c\x1d\x1e\x1f"):
        return None
    bind_skeleton_ops(lib)
    raw = text.encode("ascii")
    cap = len(raw) // 2 + 2
    cmds = np.empty(cap, np.uint8)
    vals = np.empty(cap, np.float64)
    line_id = np.empty(cap, np.int32)
    n = lib.pw_gcode_tokens(
        raw,
        len(raw),
        cmds.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        line_id.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if n == -2:
        return GCODE_NEEDS_EXACT
    if n < 0:
        return None
    return cmds[:n], vals[:n], line_id[:n]


def order_l1_native(starts: np.ndarray, ends: np.ndarray,
                    sx: int, sy: int):
    """Greedy nearest-start L1 ordering (no flip) over (n, 2) int64
    start/end arrays from ``(sx, sy)``; returns the order as an int32
    array, or None when the library is missing.  Ascending strict-<
    scan == np.argmin first-min tie-break (fuzz-pinned in
    tests/test_frontends.py)."""
    from .loader import bind_skeleton_ops  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_skeleton_ops(lib)
    s = np.ascontiguousarray(starts, dtype=np.int64)
    e = np.ascontiguousarray(ends, dtype=np.int64)
    n = len(s)
    order = np.empty(n, np.int32)
    lib.pw_order_l1(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        e.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        int(sx),
        int(sy),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return order


def gcode_text_native(v: np.ndarray, first: np.ndarray, last: np.ndarray,
                      decimals: int):
    """Render the SVG front-end's G-code body (all vertex rows, newline-
    terminated) in one native pass; returns the text or None (library
    missing / non-finite values / buffer overflow → numpy formatter)."""
    from .loader import bind_skeleton_ops  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return None
    bind_skeleton_ops(lib)
    v = np.ascontiguousarray(v, dtype=np.float64)
    if not np.isfinite(v).all():
        return None  # Python formats inf/nan as 'inf'/'nan'; don't guess
    n = len(v)
    if n == 0:
        return ""
    m = float(np.abs(v).max())
    width = len(f"{-m:.{int(decimals)}f}") + 2
    cap = n * (4 + 2 * width + 2 + 3 + 1) + 16
    out = ctypes.create_string_buffer(cap)
    f8 = np.ascontiguousarray(first, dtype=np.uint8)
    l8 = np.ascontiguousarray(last, dtype=np.uint8)
    w = lib.pw_gcode_text(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n,
        f8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        l8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(decimals),
        out,
        cap,
    )
    if w < 0:
        return None
    return out.raw[:w].decode("ascii")


def find_period_native(v: np.ndarray):
    """Native viz/previews.py::_find_period over the int64-packed vertex
    view; returns (s, T, k), None (no period), or the string "unavailable"
    when the library is missing (callers fall back to the numpy detector).
    Parity with the Python detector is fuzz-pinned
    (tests/test_previews_periodic.py)."""
    from .loader import bind_find_period  # noqa: PLC0415

    lib = get_lib()
    if lib is None:
        return "unavailable"
    bind_find_period(lib)
    v = np.ascontiguousarray(v, dtype=np.int64)
    out = np.empty(3, dtype=np.int64)
    found = lib.pw_find_period(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        int(v.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if not found:
        return None
    return int(out[0]), int(out[1]), int(out[2])
