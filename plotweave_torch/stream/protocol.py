"""Byte-level protocol primitives, fully vectorized.

Direction rasterization uses a closed-form Bresenham: instead of walking the
error accumulator one motor step at a time (reference helper:183-207 does a
Python loop per step), we compute the minor-axis advance positions for the
whole segment at once from the integer ceil-threshold solution of the error
recurrence.  Output is bit-identical to the classic loop (property-tested
exhaustively in tests/test_stream_protocol.py) but runs as a handful of
NumPy ops per segment — this is hot loop #3 of the pipeline (SURVEY §3.4).

Copy of ``plotweave/stream/protocol.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import numpy as np

SPI_CHUNK_SIZE = 1024
WORK_MAX_X = 13210
WORK_MAX_Y = 13019

# Direction codes 0..7: 0=+Y, 1=NE, 2=+X, 3=SE, 4=-Y, 5=SW, 6=-X, 7=NW
DIR_VECTORS = np.array(
    [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1)],
    dtype=np.int32,
)

# code lookup tables: [sx>0, sy>0] → code
_DIAG_CODE = np.array([[5, 7], [3, 1]], dtype=np.uint8)  # (SW,NW),(SE,NE)
_X_CODE = (6, 2)  # −X, +X
_Y_CODE = (4, 0)  # −Y, +Y

# service bytes
B_PEN_UP = 0x01
B_PEN_DOWN = 0x02
B_TAP = 0x03
B_EOF = 0x3F


def speed_byte(divider: int) -> int:
    """Service byte 0x40|div with the divider clamped to 0..63."""
    d = int(divider)
    d = 63 if d > 63 else (0 if d < 0 else d)
    return 0x40 | d


def color_byte(index: int) -> int:
    if not 0 <= int(index) <= 7:
        raise ValueError("color index must be 0..7")
    return 0x08 | (int(index) & 0x07)


def pack_dir_codes(codes: np.ndarray) -> bytes:
    """Pack direction codes two-per-byte (``11 FFF SSS``; odd tail ``10 SSS 000``).

    Pairing restarts at every call — a run boundary is also a byte boundary,
    matching the per-chunk packing of the reference writer (helper:166-167).
    """
    c = np.asarray(codes, dtype=np.uint8) & 0x07
    n = c.size
    if n == 0:
        return b""
    npairs = n // 2
    out = np.empty(npairs + (n & 1), dtype=np.uint8)
    if npairs:
        out[:npairs] = 0xC0 | (c[0 : 2 * npairs : 2] << 3) | c[1 : 2 * npairs : 2]
    if n & 1:
        out[-1] = 0x80 | (c[-1] << 3)
    return out.tobytes()


def _minor_counts(n: int, dmaj: int, dmin: int) -> np.ndarray:
    """Cumulative minor-axis advances after each of n iterations.

    Solves the Bresenham error recurrence in closed form: the number of
    minor-axis advances within the first k iterations is
    ``max(0, ceil((2*dmin*k - dmaj) / (2*dmaj)))``.
    """
    k = np.arange(1, n + 1, dtype=np.int64)
    num = 2 * dmin * k - dmaj
    den = 2 * dmaj
    f = -((-num) // den)  # ceil division for any sign of num
    return np.maximum(0, f)


def dir_codes(x0: int, y0: int, x1: int, y1: int) -> np.ndarray:
    """Direction codes for one unit-step segment, as a uint8 array.

    Bit-identical to a per-step Bresenham walk with combined diagonal moves;
    the dominant axis advances every iteration, the minor axis at closed-form
    positions.
    """
    x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
    dx, dy = abs(x1 - x0), abs(y1 - y0)
    sx = 1 if x0 < x1 else 0  # index into lookup tables (1 = positive)
    sy = 1 if y0 < y1 else 0
    n = max(dx, dy)
    if n == 0:
        return np.empty(0, dtype=np.uint8)

    if dx == dy:
        return np.full(n, _DIAG_CODE[sx, sy], dtype=np.uint8)

    if dx > dy:
        f = _minor_counts(n, dx, dy)
        minor_adv = np.diff(f, prepend=0) > 0
        codes = np.full(n, _X_CODE[sx], dtype=np.uint8)
        codes[minor_adv] = _DIAG_CODE[sx, sy]
    else:
        f = _minor_counts(n, dy, dx)
        minor_adv = np.diff(f, prepend=0) > 0
        codes = np.full(n, _Y_CODE[sy], dtype=np.uint8)
        codes[minor_adv] = _DIAG_CODE[sx, sy]
    return codes


def clamp_to_workspace(x: int, y: int, wmax: int = WORK_MAX_X, hmax: int = WORK_MAX_Y):
    return min(max(int(x), 0), wmax), min(max(int(y), 0), hmax)
