"""Unified stream emitter: native C++ writer when available, Python fallback.

One interface for all producers (stage 13, G-code front-end, manifest
creator, demo generator): pen/color/speed services plus profile-aware
polyline/travel emission.  Both backends are byte-identical (fuzz-tested).

Copy of ``plotweave/stream/emitter.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from .encoder import MotionProfile, StreamBuilder, emit_polyline, travel_ramped


class StreamEmitter:
    def __init__(self, use_native: bool = True):
        self._native = None
        if use_native:
            try:
                from ..native.api import NativeStreamBuilder  # noqa: PLC0415

                self._native = NativeStreamBuilder()
            except (RuntimeError, OSError):
                self._native = None
        self._py = None if self._native is not None else StreamBuilder()
        # explicit reference: `or` would misroute when len(backend) == 0
        self._b = self._native if self._native is not None else self._py

    @property
    def backend(self) -> str:
        return "native" if self._native is not None else "python"

    def pen_up(self):
        self._b.pen_up()

    def pen_down(self):
        self._b.pen_down()

    def tap(self):
        self._b.tap()

    def select_color(self, idx: int):
        self._b.select_color(idx)

    def speed(self, divider: int):
        self._b.speed(divider)

    def polyline(self, pts: Sequence[Tuple[int, int]], prof: MotionProfile):
        if self._native is not None:
            self._native.polyline(pts, prof)
        else:
            emit_polyline(self._py, prof, pts)

    def travel(self, x0: int, y0: int, x1: int, y1: int, prof: MotionProfile):
        if self._native is not None:
            self._native.travel(x0, y0, x1, y1, prof)
        else:
            travel_ramped(self._py, x0, y0, x1, y1, prof)

    def __len__(self) -> int:
        return len(self._b)

    def finish(self) -> bytes:
        return self._b.finish()
