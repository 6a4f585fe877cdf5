"""Stream encoder: speed-ramp planning + byte serialization.

Design: every motion (draw segment, pen-up travel) is planned as a list of
*runs* — ``(divider, code_slice)`` pairs — and a run list is serialized as
``speed byte (deduplicated) + packed step bytes``.  Direction codes for a
whole segment come from the closed-form Bresenham in ``protocol.dir_codes``,
so per-motor-step Python work is eliminated; only the (short) run list is
iterated.

Byte output is bit-identical to the reference emitter (verified by golden
tests): speed-byte deduplication (reference helper:151-156), per-run packing
boundaries (helper:166-167), triangle/s-curve ramp count distribution
(helper:72-100), corner windows with the split-half overlap rule
(helper:251-292), quantized travel ramps (helper:322-380), EOF + 1024-byte
padding (helper:169-174) — including quirks like the trailing cruise speed
byte emitted for odd one-step remainders even when the following slice is
empty.

Copy of ``plotweave/stream/encoder.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .protocol import (
    SPI_CHUNK_SIZE,
    B_EOF,
    B_PEN_DOWN,
    B_PEN_UP,
    B_TAP,
    color_byte,
    dir_codes,
    pack_dir_codes,
    speed_byte,
)

Runs = List[Tuple[int, np.ndarray]]


@dataclass
class MotionProfile:
    """Speed/ramp parameters (mirrors reference helper Config, :112-139)."""

    steps_per_mm: float = 40.0
    invert_y: bool = True

    # pen-down drawing
    div_start: int = 28
    div_fast: int = 15
    profile: str = "triangle"

    # corner handling
    corner_deg: float = 85.0
    corner_div: int = 28
    corner_window_steps: int = 300

    # short edges
    short_len_steps: int = 120
    short_div: int = 16

    # pen-up travel
    travel_div_fast: int = 10
    travel_start_div: int = 28
    travel_window_steps: int = 240
    travel_quant_step: int = 4

    soft_tail_steps: int = 0
    soft_tail_div: int = 20

    def to_steps(self, mm: float) -> int:
        return int(round(mm * self.steps_per_mm))


class StreamBuilder:
    """Accumulates protocol bytes; dedups consecutive identical speed setting."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._divider: Optional[int] = None

    def speed(self, divider: int) -> None:
        if self._divider != divider:
            self._buf.append(speed_byte(divider))
            self._divider = divider

    def steps(self, codes: np.ndarray) -> None:
        self._buf += pack_dir_codes(codes)

    def runs(self, runs: Runs) -> None:
        for div, codes in runs:
            self.speed(div)
            self.steps(codes)

    def pen_up(self) -> None:
        self._buf.append(B_PEN_UP)

    def pen_down(self) -> None:
        self._buf.append(B_PEN_DOWN)

    def tap(self) -> None:
        self._buf.append(B_TAP)

    def select_color(self, index: int) -> None:
        self._buf.append(color_byte(index))

    def __len__(self) -> int:
        return len(self._buf)

    def finish(self) -> bytes:
        """Append EOF and zero-pad to the SPI chunk size."""
        self._buf.append(B_EOF)
        pad = (-len(self._buf)) % SPI_CHUNK_SIZE
        if pad:
            self._buf += b"\x00" * pad
        return bytes(self._buf)


# ------------------------------ ramp planning ------------------------------


def _even_split(total: int, levels: int) -> np.ndarray:
    """Distribute ``total`` across ``levels`` buckets; remainder → first buckets."""
    if levels <= 0:
        return np.empty(0, dtype=np.int64)
    base, rem = divmod(total, levels)
    out = np.full(levels, base, dtype=np.int64)
    out[:rem] += 1
    return out


def _ramp_level_counts(profile: str, length: int, div_fast: int, div_slow: int) -> np.ndarray:
    """Step counts per divider level, indexed slow→fast (index 0 = div_slow)."""
    levels = div_slow - div_fast + 1
    if profile == "triangle":
        return _even_split(length, levels)
    if profile == "scurve":
        # smoothstep 3t²−2t³ over step midpoints, rounded to a divider
        t = (np.arange(length, dtype=np.float64) + 0.5) / length
        s = 3.0 * t * t - 2.0 * t * t * t
        div = np.rint(div_slow - s * (div_slow - div_fast)).astype(np.int64)
        div = np.clip(div, div_fast, div_slow)
        counts = np.bincount(div_slow - div, minlength=levels)
        return counts.astype(np.int64)
    raise ValueError("profile must be 'triangle' or 'scurve'")


def plan_accel(codes: np.ndarray, profile: str, div_fast: int, start_div: int) -> Runs:
    """Runs accelerating from ``start_div`` (slow) down to ``div_fast``."""
    n = len(codes)
    if n == 0:
        return []
    if start_div <= div_fast:
        return [(div_fast, codes)]
    counts = _ramp_level_counts(profile, n, div_fast, start_div)
    out: Runs = []
    idx = 0
    for i, cnt in enumerate(counts):  # slow → fast
        if cnt > 0:
            out.append((start_div - i, codes[idx : idx + cnt]))
            idx += int(cnt)
    return out


def plan_decel(codes: np.ndarray, profile: str, div_fast: int, end_div: int) -> Runs:
    """Runs decelerating from ``div_fast`` up to ``end_div`` (slow)."""
    n = len(codes)
    if n == 0:
        return []
    if end_div <= div_fast:
        return [(div_fast, codes)]
    counts = _ramp_level_counts(profile, n, div_fast, end_div)
    out: Runs = []
    idx = 0
    for i in range(len(counts) - 1, -1, -1):  # fast → slow
        cnt = counts[i]
        if cnt > 0:
            out.append((end_div - i, codes[idx : idx + cnt]))
            idx += int(cnt)
    return out


# --------------------------- pen-down segments -----------------------------


def _vertex_angle_deg(ax, ay, bx, by, cx, cy) -> float:
    """Interior angle at vertex b between rays b→a and b→c, in degrees."""
    v1x, v1y = ax - bx, ay - by
    v2x, v2y = cx - bx, cy - by
    n1 = math.hypot(v1x, v1y)
    n2 = math.hypot(v2x, v2y)
    if n1 == 0 or n2 == 0:
        return 180.0
    d = (v1x * v2x + v1y * v2y) / (n1 * n2)
    d = max(-1.0, min(1.0, d))
    return math.degrees(math.acos(d))


def emit_draw_segment(
    sb: StreamBuilder,
    codes: np.ndarray,
    prof: MotionProfile,
    slow_in: bool,
    slow_out: bool,
) -> None:
    """One pen-down segment with optional corner-entry/exit speed windows.

    Decision tree matches reference helper:251-292: short no-corner segments
    ride ``short_div``; overlapping corner windows use a split-half triangle
    with a single cruise step for odd lengths; otherwise accel-window /
    cruise / decel-window.
    """
    n = len(codes)
    if n == 0:
        return

    if not slow_in and not slow_out:
        sb.speed(prof.short_div if n <= prof.short_len_steps else prof.div_fast)
        sb.steps(codes)
        return

    entry = min(prof.corner_window_steps if slow_in else 0, n)
    exit_ = min(prof.corner_window_steps if slow_out else 0, max(0, n - entry))
    mid = max(0, n - entry - exit_)

    if entry + exit_ >= n:
        half = n // 2
        if half > 0:
            sb.runs(
                plan_accel(
                    codes[:half],
                    prof.profile,
                    prof.div_fast,
                    prof.corner_div if slow_in else prof.div_start,
                )
            )
        if n % 2 == 1:
            sb.speed(prof.div_fast)
            sb.steps(codes[half : half + 1])
            half += 1
        rest = codes[half:]
        if len(rest):
            sb.runs(
                plan_decel(
                    rest,
                    prof.profile,
                    prof.div_fast,
                    prof.corner_div if slow_out else prof.div_start,
                )
            )
        return

    if entry > 0:
        sb.runs(plan_accel(codes[:entry], prof.profile, prof.div_fast, prof.corner_div))
    if mid > 0:
        sb.speed(prof.div_fast)
        sb.steps(codes[entry : entry + mid])
    if exit_ > 0:
        sb.runs(plan_decel(codes[-exit_:], prof.profile, prof.div_fast, prof.corner_div))


def emit_polyline(
    sb: StreamBuilder,
    prof: MotionProfile,
    pts: Sequence[Tuple[int, int]],
    color_index: Optional[int] = None,
) -> None:
    """Pen-down polyline with corner-aware slow-in/slow-out per vertex.

    A vertex is a corner when its interior angle is below ``corner_deg``
    (reference helper:294-318).
    """
    if pts is None or len(pts) < 2:
        return
    if color_index is not None:
        sb.select_color(color_index)

    m = len(pts)
    for i in range(m - 1):
        b, c = pts[i], pts[i + 1]
        slow_in = False
        if i > 0:
            a = pts[i - 1]
            slow_in = _vertex_angle_deg(a[0], a[1], b[0], b[1], c[0], c[1]) < prof.corner_deg
        slow_out = False
        if i + 2 < m:
            d = pts[i + 2]
            slow_out = _vertex_angle_deg(b[0], b[1], c[0], c[1], d[0], d[1]) < prof.corner_deg
        codes = dir_codes(b[0], b[1], c[0], c[1])
        emit_draw_segment(sb, codes, prof, slow_in, slow_out)


# ------------------------------ pen-up travel -------------------------------


def _quantized_levels(div_slow: int, div_fast: int, step: int) -> List[int]:
    """Coarse divider levels slow→fast inclusive (e.g. 28,24,20,16,12,10)."""
    if div_slow < div_fast:
        div_slow, div_fast = div_fast, div_slow
    levels = list(range(div_slow, div_fast - 1, -step))
    if levels[-1] != div_fast:
        levels.append(div_fast)
    return levels


def _even_runs(codes: np.ndarray, levels: List[int]) -> Runs:
    """Split codes evenly across the given divider levels, in order."""
    if len(codes) == 0 or not levels:
        return []
    parts = _even_split(len(codes), len(levels))
    out: Runs = []
    idx = 0
    for div, cnt in zip(levels, parts):
        if cnt > 0:
            out.append((div, codes[idx : idx + cnt]))
            idx += int(cnt)
    return out


def travel_ramped(sb: StreamBuilder, x0: int, y0: int, x1: int, y1: int, prof: MotionProfile) -> None:
    """Pen-up travel with quantized accel / cruise / decel (helper:340-380).

    Short moves (≤ 2×window) use a half/half triangle ramp; long moves use
    even splits over quantized divider levels, cruise at ``travel_div_fast``.
    """
    codes = dir_codes(x0, y0, x1, y1)
    n = len(codes)
    if n == 0:
        return

    win = int(prof.travel_window_steps)
    div_fast = int(prof.travel_div_fast)
    div_start = max(int(prof.travel_start_div), div_fast)

    if n <= 2 * win:
        half = max(1, n // 2)
        sb.runs(plan_accel(codes[:half], prof.profile, div_fast, div_start))
        if n % 2 == 1:
            sb.speed(div_fast)
            sb.steps(codes[half : half + 1])
            half += 1
        sb.runs(plan_decel(codes[half:], prof.profile, div_fast, div_start))
        return

    levels_down = _quantized_levels(div_start, div_fast, step=max(1, int(prof.travel_quant_step)))
    levels_up = list(reversed(levels_down))

    sb.runs(_even_runs(codes[:win], levels_down))
    cruise = codes[win : n - win]
    if len(cruise):
        sb.speed(div_fast)
        sb.steps(cruise)
    sb.runs(_even_runs(codes[n - win :], levels_up))
