"""Plot-order planning (stage 12): build the per-layer op list.

Greedy routing with tap draining (reference 12_optimize_plot_order.py:85-187):
seed with the longest polyline (reversed if its end is nearer the origin),
after every chosen op accept all taps within ``tap_insert_radius`` of the pen
(in candidate order, pen moving tap to tap), then take the nearest op among
line-starts, line-ends (flip) and taps.  Scan order and strict-< updates make
ties deterministic: earlier candidate wins, line start beats its end.

Copy of ``plotweave/vector/planner.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np

from .geometry import as_pts, poly_len_f32

Op = Dict[str, Any]


def _d(a: Tuple[float, float], b: Tuple[float, float]) -> float:
    return math.hypot(float(a[0] - b[0]), float(a[1] - b[1]))


def plan_layer_ops(
    lines: List[np.ndarray],
    taps: List[Tuple[int, int]],
    tap_insert_radius: float,
) -> List[Op]:
    ops: List[Op] = []

    line_cands = []
    for c in lines:
        p = as_pts(c).astype(np.float32)
        if p.shape[0] < 2:
            continue
        line_cands.append(
            {
                "points": p,
                "start": (float(p[0, 0]), float(p[0, 1])),
                "end": (float(p[-1, 0]), float(p[-1, 1])),
                "len": poly_len_f32(p),
            }
        )
    tap_cands = [{"pt": (float(x), float(y))} for x, y in taps]

    if not line_cands and not tap_cands:
        return ops

    pos = (0.0, 0.0)

    def emit_line(cand: Dict, flipped: bool) -> None:
        nonlocal pos
        pts = cand["points"][::-1].copy() if flipped else cand["points"]
        ops.append({"type": "line", "points": pts})
        pos = cand["start"] if flipped else cand["end"]

    def drain_taps() -> None:
        nonlocal pos, tap_cands
        remaining = []
        for t in tap_cands:
            if _d(pos, t["pt"]) <= tap_insert_radius:
                ops.append({"type": "tap", "x": int(round(t["pt"][0])), "y": int(round(t["pt"][1]))})
                pos = t["pt"]
            else:
                remaining.append(t)
        tap_cands = remaining

    if line_cands:
        s = max(range(len(line_cands)), key=lambda k: line_cands[k]["len"])
        first = line_cands.pop(s)
        emit_line(first, flipped=_d(pos, first["end"]) < _d(pos, first["start"]))
        drain_taps()
    else:
        s = min(range(len(tap_cands)), key=lambda k: _d(pos, tap_cands[k]["pt"]))
        first = tap_cands.pop(s)
        ops.append({"type": "tap", "x": int(round(first["pt"][0])), "y": int(round(first["pt"][1]))})
        pos = first["pt"]

    while line_cands or tap_cands:
        best_kind, best_idx, best_cost, best_flip = None, -1, 1e20, False
        for k, c in enumerate(line_cands):
            d1 = _d(pos, c["start"])
            d2 = _d(pos, c["end"])
            if d1 < best_cost:
                best_kind, best_idx, best_cost, best_flip = "line", k, d1, False
            if d2 < best_cost:
                best_kind, best_idx, best_cost, best_flip = "line", k, d2, True
        for k, t in enumerate(tap_cands):
            if _d(pos, t["pt"]) < best_cost:
                best_kind, best_idx, best_cost, best_flip = "tap", k, _d(pos, t["pt"]), False

        if best_kind == "line":
            emit_line(line_cands.pop(best_idx), best_flip)
            drain_taps()
        else:
            t = tap_cands.pop(best_idx)
            ops.append({"type": "tap", "x": int(round(t["pt"][0])), "y": int(round(t["pt"][1]))})
            pos = t["pt"]

    return ops


def layer_color_index(name: str) -> int:
    """Manifest color index hardcoded by layer-name substring (12:210-219)."""
    if "dark" in name:
        return 3
    if "skin" in name:
        return 0
    if "mid" in name:
        return 1
    if "light" in name:
        return 2
    return 0



def _op_entry(op: Op) -> Tuple[float, float]:
    if op["type"] == "tap":
        return (float(op["x"]), float(op["y"]))
    p = op["points"]
    return (float(p[0, 0]), float(p[0, 1]))


def _op_exit(op: Op) -> Tuple[float, float]:
    if op["type"] == "tap":
        return (float(op["x"]), float(op["y"]))
    p = op["points"]
    return (float(p[-1, 0]), float(p[-1, 1]))


def _op_flip(op: Op) -> Op:
    if op["type"] == "tap":
        return op
    return {"type": "line", "points": op["points"][::-1].copy()}


def two_opt_refine(ops: List[Op], max_passes: int = 10) -> List[Op]:
    """Optional travel-tour improvement over the greedy plan (the reference
    has no refinement pass; BASELINE names 2-opt as the target improvement).

    Treats each op as a node with entry/exit points; repeatedly applies the
    best segment reversal (classic 2-opt on the pen-up travel graph, with
    line ops allowed to flip) until no pass improves.  Only the ORDER and
    orientations change — pen-down geometry is untouched, so the drawing is
    identical while pen-up travel shrinks below the reference's greedy tour.
    """
    if len(ops) < 3:
        return ops

    entry, exit_, flip = _op_entry, _op_exit, _op_flip

    cur = list(ops)
    for _ in range(max_passes):
        improved = False
        n = len(cur)
        for i in range(n - 1):
            prev_pt = (0.0, 0.0) if i == 0 else exit_(cur[i - 1])
            for j in range(i + 1, n):
                nxt = entry(cur[j + 1]) if j + 1 < n else None
                # current cost of the two travel edges around segment [i, j]
                d_now = _d(prev_pt, entry(cur[i]))
                d_new = _d(prev_pt, exit_(cur[j]))
                if nxt is not None:
                    d_now += _d(exit_(cur[j]), nxt)
                    d_new += _d(entry(cur[i]), nxt)
                if d_new + 1e-9 < d_now:
                    cur[i : j + 1] = [flip(o) for o in reversed(cur[i : j + 1])]
                    improved = True
        if not improved:
            break
    return cur


def or_opt_refine(ops: List[Op], max_passes: int = 10) -> List[Op]:
    """Or-opt: relocate chains of 1–3 consecutive ops (optionally reversed)
    wherever that shortens pen-up travel — catches moves 2-opt cannot express.
    Like :func:`two_opt_refine`, only order/orientation change."""
    if len(ops) < 3:
        return ops

    entry, exit_, flip = _op_entry, _op_exit, _op_flip

    cur = list(ops)
    for _ in range(max_passes):
        improved = False
        for size in (1, 2, 3):
            n = len(cur)
            i = 0
            while i + size <= n:
                chain = cur[i : i + size]
                before = (0.0, 0.0) if i == 0 else exit_(cur[i - 1])
                after = entry(cur[i + size]) if i + size < n else None
                # cost of keeping the chain in place
                d_keep = _d(before, entry(chain[0]))
                gap = _d(before, after) if after is not None else 0.0
                if after is not None:
                    d_keep += _d(exit_(chain[-1]), after)
                rest = cur[:i] + cur[i + size :]
                best_gain, best_k, best_rev = 1e-9, -1, False
                # try inserting between every pair in the remaining tour
                m = len(rest)
                for k in range(m + 1):
                    if k == i:  # same slot = no move
                        continue
                    b = (0.0, 0.0) if k == 0 else exit_(rest[k - 1])
                    a = entry(rest[k]) if k < m else None
                    base = _d(b, a) if a is not None else 0.0
                    for rev in (False, True):
                        h = exit_(chain[-1]) if rev else entry(chain[0])
                        t = entry(chain[0]) if rev else exit_(chain[-1])
                        d_ins = _d(b, h) + (_d(t, a) if a is not None else 0.0)
                        gain = (d_keep - gap) - (d_ins - base)
                        if gain > best_gain:
                            best_gain, best_k, best_rev = gain, k, rev
                if best_k >= 0:
                    moved = [flip(o) for o in reversed(chain)] if best_rev else chain
                    cur = rest[:best_k] + moved + rest[best_k:]
                    improved = True
                    n = len(cur)
                else:
                    i += 1
        if not improved:
            break
    return cur


def refine_tour(ops: List[Op], max_rounds: int = 5, device_min_n: int = 0, device=None) -> List[Op]:
    """Alternate 2-opt and Or-opt until neither shortens the tour.

    ``device_min_n`` > 0 routes op lists of at least that many entries
    through the device refiner (vector/refine_device.py: K10, every 2-opt
    and relocation move evaluated each iteration) when ``device`` is a CUDA
    device — the host scan is O(n²) Python per pass and becomes the stage
    bottleneck in the low hundreds of ops; on the CPU the host refiner runs.
    Both paths only reorder/flip ops; the device result is length-verified
    on host and never worse than the input."""
    if device_min_n and len(ops) >= device_min_n:
        from .planner_device import on_cuda  # noqa: PLC0415
        from .refine_device import MAX_N, refine_ops_device  # noqa: PLC0415

        if on_cuda(device):
            dev = refine_ops_device(ops, max_moves=max(4096, 4 * len(ops)), device=device)
            if dev is not None:
                return dev
            print(f"[plot-opt] n={len(ops)} is outside the device refiner's 3..{MAX_N}: host refiner")
    cur = ops
    for _ in range(max_rounds):
        length0 = tour_length(cur)
        cur = or_opt_refine(two_opt_refine(cur))
        if tour_length(cur) >= length0 - 1e-9:
            break
    return cur


def tour_length(ops: List[Op], start: Tuple[float, float] = (0.0, 0.0)) -> float:
    """Total pen-up travel distance of an op list (benchmark metric)."""
    pos = start
    total = 0.0
    for op in ops:
        if op["type"] == "tap":
            q = (float(op["x"]), float(op["y"]))
            total += _d(pos, q)
            pos = q
        else:
            p = op["points"]
            total += _d(pos, (float(p[0, 0]), float(p[0, 1])))
            pos = (float(p[-1, 0]), float(p[-1, 1]))
    return total
