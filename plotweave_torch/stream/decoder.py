"""Stream decoder + replay simulator — the executable spec of the protocol.

Decodes a binary plotter stream into a command sequence with invariant
statistics (EOF seen, tail after EOF, off-canvas step count, final position,
byte/step/service totals).  This is the natural oracle for round-trip tests:
encode → decode → compare geometry (reference previewer:72-171 plays the same
role for the reference pipeline).

Copy of ``plotweave/stream/decoder.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from .protocol import DIR_VECTORS, B_EOF, B_PEN_DOWN, B_PEN_UP, B_TAP


@dataclass
class StreamStats:
    total_bytes: int = 0
    step_bytes: int = 0
    service_bytes: int = 0
    single_steps: int = 0
    double_steps: int = 0
    steps_total: int = 0
    pen_down_segments: int = 0
    taps: int = 0
    color_changes: int = 0
    speed_changes: int = 0
    eof_seen: bool = False
    tail_after_eof: int = 0
    off_canvas_steps: int = 0
    final_x: int = 0
    final_y: int = 0


# command kinds
STEP = "step"
PEN = "pen"
COLOR = "color"
SPEED = "speed"


class StreamDecoder:
    """Parse a byte stream into (kind, value) commands with statistics."""

    def __init__(self, data: bytes):
        self.data = data
        self.stats = StreamStats(total_bytes=len(data))
        self.commands: List[Tuple[str, int]] = []
        self._parse()

    def _parse(self) -> None:
        st = self.stats
        cmds = self.commands
        data = self.data
        n = len(data)
        i = 0
        while i < n:
            b = data[i]
            if b & 0x80:  # step byte
                st.step_bytes += 1
                if b & 0x40:
                    cmds.append((STEP, (b >> 3) & 0x07))
                    cmds.append((STEP, b & 0x07))
                    st.double_steps += 1
                    st.steps_total += 2
                else:
                    cmds.append((STEP, (b >> 3) & 0x07))
                    st.single_steps += 1
                    st.steps_total += 1
                i += 1
                continue

            st.service_bytes += 1
            if b == B_EOF:
                st.eof_seen = True
                st.tail_after_eof = n - (i + 1)
                return
            if b in (B_PEN_UP, B_PEN_DOWN, B_TAP):
                cmds.append((PEN, b))
            elif 0x08 <= b <= 0x0F:
                cmds.append((COLOR, b & 0x07))
                st.color_changes += 1
            elif (b & 0xC0) == 0x40:
                cmds.append((SPEED, b & 0x3F))
                st.speed_changes += 1
            # unknown service bytes are skipped
            i += 1


@dataclass
class ReplayResult:
    """Geometry extracted by replaying a decoded stream."""

    polylines: List[np.ndarray] = field(default_factory=list)  # pen-down paths, (N,2) int32
    taps: List[Tuple[int, int]] = field(default_factory=list)
    colors: List[int] = field(default_factory=list)  # color per polyline
    tap_colors: List[int] = field(default_factory=list)  # color per tap
    final_pos: Tuple[int, int] = (0, 0)


def replay(decoder: StreamDecoder, canvas_w: int = 0, canvas_h: int = 0) -> ReplayResult:
    """Simulate the plotter state machine; collect pen-down geometry.

    Also fills the decoder's off-canvas / pen-segment / tap statistics the
    way the reference previewer does (previewer:305-345).
    """
    st = decoder.stats
    res = ReplayResult()
    x = y = 0
    pen_down = False
    color = 0
    cur: List[Tuple[int, int]] = []

    def flush() -> None:
        nonlocal cur
        if len(cur) >= 2:
            res.polylines.append(np.asarray(cur, dtype=np.int32))
            res.colors.append(color)
        cur = []

    for kind, v in decoder.commands:
        if kind == STEP:
            dx, dy = int(DIR_VECTORS[v][0]), int(DIR_VECTORS[v][1])
            nx, ny = x + dx, y + dy
            if canvas_w and canvas_h and not (0 <= nx < canvas_w and 0 <= ny < canvas_h):
                st.off_canvas_steps += 1
            if pen_down:
                if not cur:
                    cur.append((x, y))
                cur.append((nx, ny))
            x, y = nx, ny
        elif kind == PEN:
            if v == B_PEN_DOWN:
                if not pen_down:
                    st.pen_down_segments += 1
                pen_down = True
            elif v == B_PEN_UP:
                flush()
                pen_down = False
            elif v == B_TAP:
                st.taps += 1
                res.taps.append((x, y))
                res.tap_colors.append(color)
                flush()
                pen_down = False
        elif kind == COLOR:
            flush()
            color = v

    flush()
    st.final_x, st.final_y = x, y
    res.final_pos = (x, y)
    return res
