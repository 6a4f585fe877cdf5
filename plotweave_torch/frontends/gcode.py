"""G-code front-end: parse a plotter G-code subset and emit streams.

Dialect (reference svg_to_stream/gcode2stream.py:201-299): G0/G1 implicit
moves via bare X/Y words, G90/G91 absolute/relative, G20/G21 units,
M3/M4 = pen down, M5 = pen up, and Z ≤ 0 infers pen-down when no M-code is
present on the line.  Comments: ``;`` to end of line and non-nested ``(...)``.

The mm→step mapping applies mm-space scale/offset, then steps/mm, an
optional Y flip around the canvas, rounding and clamping; consecutive
duplicate step points are dropped (gcode2stream.py:79-110,317-339).

Parsing is vectorized: one native C pass tokenizes the whole document
(comment strip + whitespace split + CPython-exact float(), native/
encoder.cpp ``pw_gcode_tokens``; regex+float() fallback when the library
is missing or the text is non-ASCII), then numpy forward-fill/grouping
runs the per-line state machine — ~40× the line-by-line parser on large
documents.  G20/G21 unit switches are handled vectorized (token-time unit
state, elementwise inch→mm scale); G91 relative mode keeps the vectorized
tokenizer and replays only the x/y accumulation in a tight loop over move
lines (bit-identical float op order).  Only documents whose G/M/X/Y/Z
tokens carry non-finite values (inf/nan literals, 1e999-style overflow —
detected per token AFTER comment stripping, so "info"-style comments
stay fast) dispatch to the exact Python state machine; all paths are
fuzz-pinned equal (tests/test_frontends.py::test_fast_parser_matches_exact,
::test_native_tokenizer_matches_regex).

Copy of ``plotweave/frontends/gcode.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..stream import MotionProfile
from ..stream.emitter import StreamEmitter

INCH_TO_MM = 25.4
A4_W_MM = 210.0
A4_H_MM = 297.0
DEFAULT_STEPS_PER_MM = 40.0

Point = Tuple[int, int]
PointMM = Tuple[float, float]


def strip_comment(line: str) -> str:
    if ";" in line:
        line = line.split(";", 1)[0]
    out = []
    depth = False
    for ch in line:
        if ch == "(":
            depth = True
        elif ch == ")":
            depth = False
        elif not depth:
            out.append(ch)
    return "".join(out).strip()


@dataclass
class _State:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    absolute: bool = True
    mm_units: bool = True
    pen_down: bool = False


def parse_polylines_mm(text: str):
    """All pen-down polylines in mm + the pen-down move count.

    Dispatches to the vectorized parser; only documents whose G/M/X/Y/Z
    tokens carry non-finite values (nan/inf literals or overflow — where
    CPython's int(inf)/nan-coordinate semantics apply) take the exact
    line-by-line state machine.  Both return the same geometry — polylines
    come back as (N, 2) float arrays from the fast path and lists of
    (x, y) tuples from the exact path; every consumer accepts either."""
    fast = _parse_polylines_mm_fast(text)
    if fast is not None:
        return fast
    return _parse_polylines_mm_py(text)


# one whitespace-delimited chunk → (first char, rest): replicates the
# reference's `tok[0], tok[1:]` split over `line.split()`
_TOKEN_RE = re.compile(r"(?<!\S)(\S)(\S*)")
# reference strip_comment: ';' first (whole tail), then chars inside
# non-nested (...) dropped [unclosed ( drops the rest of the line], and
# stray ')' dropped
_SEMI_RE = re.compile(r";[^\n]*")
_PAREN_RE = re.compile(r"\([^)\n]*\)?|\)")

# tokenizer verdict: the document has a non-finite value on a token the
# exact parser would float() — dispatch to the exact state machine
_NEEDS_EXACT = object()
# CPython float()'s nan literal (inf literals parse to inf and are caught
# numerically; nan needs a text check because NaN doubles also mean
# "invalid token" in the fast path)
_NAN_LIT_RE = re.compile(r"[+-]?nan", re.IGNORECASE)


def _ffill(vals: np.ndarray, init: float) -> np.ndarray:
    """Forward-fill NaNs (float64), seeding with ``init``."""
    idx = np.arange(len(vals))
    ok = ~np.isnan(vals)
    last = np.maximum.accumulate(np.where(ok, idx, -1))
    filled = np.where(last >= 0, vals[np.clip(last, 0, None)], init)
    return filled


def _tok_result(cmds_u8, vals, line_id):
    """Shared tail of both tokenizers: per-command masks + line count.

    ``cmds_u8`` is the uppercased-first-char byte per token; ``n_lines`` is
    the last token's 0-based line index + 1 (exactly what the sentinel
    cumsum used to produce)."""
    if not len(cmds_u8):
        return None
    n_lines = int(line_id[-1]) + 1
    is_g, is_m, is_x, is_y, is_z = (cmds_u8 == ord(c) for c in "GMXYZ")
    return is_g, is_m, is_x, is_y, is_z, vals, line_id, n_lines


def _tokenize_native(text: str):
    """One C pass over the normalized document: comment strip + whitespace
    split + CPython-float() per token (native/encoder.cpp pw_gcode_tokens,
    fuzz-pinned equal to :func:`_tokenize_regex`).  None → use the regex
    tokenizer (library missing or non-ASCII text); _NEEDS_EXACT → a
    G/M/X/Y/Z token carries a non-finite value (inf/nan literal or
    1e999-style overflow, which CPython float() saturates to ±inf), so the
    document takes the exact line-by-line parser."""
    from ..native.api import GCODE_NEEDS_EXACT, gcode_tokens_native  # noqa: PLC0415

    nat = gcode_tokens_native(text)
    if nat is GCODE_NEEDS_EXACT:
        return _NEEDS_EXACT
    if nat is None:
        return None
    return _tok_result(*nat)


def _tokenize_regex(text: str):
    """Regex/np.fromiter tokenizer (the pre-native fast path).  Applies the
    same non-finite dispatch rule as the native tokenizer (returns
    _NEEDS_EXACT)."""
    body = _PAREN_RE.sub("", _SEMI_RE.sub("", text))
    body = body.replace("\n", " \x00 ")
    pairs = _TOKEN_RE.findall(body)
    if not pairs:
        return None

    def _f(s: str) -> float:
        try:
            return float(s)
        except ValueError:
            return np.nan

    cmds = np.array([c for c, _ in pairs], dtype="U1")
    vals = np.fromiter((_f(r) for _, r in pairs), np.float64, count=len(pairs))
    line_id = np.cumsum(cmds == "\x00")
    keep = cmds != "\x00"
    cmds = np.char.upper(cmds[keep])
    vals = vals[keep]
    line_id = line_id[keep]
    if not len(cmds):
        return None
    # non-finite dispatch (post-comment-strip, per token — a "nan"/"inf"
    # inside a comment never lands here): ±inf on any G/M/X/Y/Z value
    # (inf literals and 1e999-style overflow both parse to inf in CPython;
    # the exact parser raises OverflowError at int(inf) on G/M and trips
    # the non-finite guard on coordinates) or a literal nan on X/Y/Z
    # (float("nan") IS a value to the exact parser, but NaN means "invalid
    # token" in the fast path).  G/M nan literals stay fast: the exact
    # parser's int(nan) raises ValueError and ignores the token, exactly
    # like the fast path's NaN mask.
    if np.isinf(vals[np.isin(cmds, tuple("GMXYZ"))]).any():
        return _NEEDS_EXACT
    xyz_nan = np.isin(cmds, tuple("XYZ")) & np.isnan(vals)
    if xyz_nan.any():
        rests = [pairs[i][1] for i in np.flatnonzero(keep)]
        if any(_NAN_LIT_RE.fullmatch(rests[i]) for i in np.flatnonzero(xyz_nan)):
            return _NEEDS_EXACT
    # U1 → codepoint so both tokenizers share the mask tail; non-ASCII
    # first chars are fine (they just never equal ord('G')..ord('Z'))
    cmds_u8 = cmds.view(np.uint32)
    return _tok_result(cmds_u8, vals, line_id)


def _parse_polylines_mm_fast(text: str):
    """Vectorized parser (full dialect: G20/G21 units, G90/G91 modes);
    None → caller falls back to exact (non-finite G/M/X/Y/Z values)."""
    if "\x00" in text:
        return None  # literal NULs would collide with the line sentinel

    # the exact state machine iterates str.splitlines(); normalize every
    # terminator it recognizes (\r\n, bare \r, \f, \v, \x85, U+2028/29, …)
    # to \n so both parsers see identical line structure
    text = "\n".join(text.splitlines())
    tok = _tokenize_native(text)
    if tok is None:
        tok = _tokenize_regex(text)
    if tok is _NEEDS_EXACT:
        return None
    if tok is None:
        return [], 0
    is_g, is_m, is_x, is_y, is_z, vals, line_id, n_lines = tok

    g_ok = is_g & ~np.isnan(vals)
    gv = np.trunc(vals[g_ok])  # int(float(val)) truncates: "G91.5" → 91

    # G20/G21 units: the exact parser scales each X/Y/Z value at TOKEN
    # time by the unit state after any earlier G20/G21 token (mid-line
    # switches included) — a token-order forward fill + one elementwise
    # multiply per value reproduces the scalar `v *= INCH_TO_MM` exactly
    if (gv == 20.0).any():
        uevt = np.full(len(vals), np.nan)
        gidx = np.flatnonzero(g_ok)
        uevt[gidx[gv == 20.0]] = 0.0
        uevt[gidx[gv == 21.0]] = 1.0
        inch = _ffill(uevt, 1.0) == 0.0
        sc = (is_x | is_y | is_z) & inch
        vals = np.where(sc, vals * INCH_TO_MM, vals)

    def last_per_line(mask) -> np.ndarray:
        out = np.full(n_lines, np.nan)
        m = mask & ~np.isnan(vals)
        out[line_id[m]] = vals[m]  # document order: later assignment wins
        return out

    x_line = last_per_line(is_x)
    y_line = last_per_line(is_y)
    z_line = last_per_line(is_z)

    # pen events per line: last relevant M (3/4 down, 5 up) wins over the
    # Z ≤ 0 inference (the reference only infers when no M set pen)
    evt = np.full(n_lines, -1, np.int8)
    zl = ~np.isnan(z_line)
    evt[zl] = (z_line[zl] <= 0.0).astype(np.int8)
    m_mask = is_m & ~np.isnan(vals)
    m_codes = np.trunc(vals[m_mask]).astype(np.int64)
    rel = np.isin(m_codes, (3, 4, 5))
    m_lines = line_id[m_mask][rel]
    evt[m_lines] = (m_codes[rel] != 5).astype(np.int8)

    # pen state after each line's tokens (applies before that line's move)
    pen = _ffill(np.where(evt >= 0, evt.astype(np.float64), np.nan), 0.0) > 0.5

    # G90/G91: st.absolute is read AFTER the line's token loop, so a
    # line's move uses the state set by its LAST G90/G91 token (or carried
    # from earlier lines); "last wins" assignment + line-order forward fill
    absl = None
    if (gv == 91.0).any():
        aevt = np.full(n_lines, np.nan)
        g_lines = line_id[g_ok]
        sw = np.isin(gv, (90.0, 91.0))
        aevt[g_lines[sw]] = (gv[sw] == 90.0)  # document order: later wins
        absl = _ffill(aevt, 1.0) > 0.5

    move = ~np.isnan(x_line) | ~np.isnan(y_line)
    if not move.any():
        return [], 0
    if absl is None or absl[move].all():
        xs = _ffill(x_line[move], 0.0)
        ys = _ffill(y_line[move], 0.0)
    else:
        xs, ys = _replay_moves(x_line[move], y_line[move], absl[move])
    pd = pen[move]
    pen_moves = int(pd.sum())
    if pen_moves == 0:
        return [], 0

    # polyline grouping: a flush happens on each pen down→up transition, so
    # the era index (count of such transitions) groups each cur polyline;
    # the start vertex is the position before the group's first move
    down_up = np.flatnonzero(pen[:-1] & ~pen[1:]) + 1
    era = np.zeros(n_lines, np.int64)
    np.add.at(era, down_up, 1)
    era = np.cumsum(era)
    ids = era[move][pd]

    px = np.concatenate([[0.0], xs[:-1]])
    py = np.concatenate([[0.0], ys[:-1]])
    pts = np.stack([xs, ys], axis=1)[pd]
    prev = np.stack([px, py], axis=1)[pd]
    cuts = np.flatnonzero(np.diff(ids)) + 1
    firsts = np.concatenate([[0], cuts])
    paths = [
        np.vstack([prev[f : f + 1], seg])
        for f, seg in zip(firsts, np.split(pts, cuts))
    ]
    return paths, pen_moves


def _replay_moves(xl: np.ndarray, yl: np.ndarray, am: np.ndarray):
    """x/y position after each move line when G91 relative lines are
    present — a tight loop over MOVE LINES ONLY (the vectorized tokenizer
    and per-line reductions still did the heavy lifting), preserving the
    exact parser's float op order bit-for-bit: plain reassignment in
    absolute mode, `st.x += nx or 0.0` in relative mode — including the
    `or`'s -0.0 → +0.0 coercion (X-0 accumulates +0.0, not -0.0)."""
    n = len(xl)
    xs = np.empty(n)
    ys = np.empty(n)
    x = y = 0.0
    for i in range(n):
        nx, ny = xl[i], yl[i]
        if am[i]:
            if nx == nx:  # not NaN ("no X on this line")
                x = float(nx)
            if ny == ny:
                y = float(ny)
        else:
            x += (float(nx) if nx == nx else None) or 0.0
            y += (float(ny) if ny == ny else None) or 0.0
        xs[i] = x
        ys[i] = y
    return xs, ys


def _parse_polylines_mm_py(text: str) -> Tuple[List[List[PointMM]], int]:
    """Exact line-by-line state machine (the executable spec for the fast
    parser; handles G91/G20)."""
    st = _State()
    paths: List[List[PointMM]] = []
    cur: List[PointMM] = []
    pen_moves = 0

    def flush():
        nonlocal cur
        if len(cur) >= 2:
            paths.append(cur)
        cur = []

    for raw in text.splitlines():
        line = strip_comment(raw)
        if not line:
            continue
        pen: Optional[bool] = None
        nx = ny = nz = None

        for tok in line.split():
            if len(tok) < 2:
                continue
            cmd, val = tok[0].upper(), tok[1:]
            if cmd == "G":
                try:
                    g = int(float(val))
                except ValueError:
                    continue
                if g == 90:
                    st.absolute = True
                elif g == 91:
                    st.absolute = False
                elif g == 21:
                    st.mm_units = True
                elif g == 20:
                    st.mm_units = False
            elif cmd == "M":
                try:
                    m = int(float(val))
                except ValueError:
                    continue
                if m in (3, 4):
                    pen = True
                elif m == 5:
                    pen = False
            elif cmd in ("X", "Y", "Z"):
                try:
                    v = float(val)
                except ValueError:
                    continue
                if not st.mm_units:
                    v *= INCH_TO_MM
                if cmd == "X":
                    nx = v
                elif cmd == "Y":
                    ny = v
                else:
                    nz = v

        if nz is not None:
            st.z = nz
            if pen is None:
                pen = st.z <= 0.0
        if pen is not None and pen != st.pen_down:
            if st.pen_down and not pen:
                flush()
            st.pen_down = pen

        if nx is not None or ny is not None:
            ox, oy = st.x, st.y
            if st.absolute:
                st.x = nx if nx is not None else st.x
                st.y = ny if ny is not None else st.y
            else:
                st.x += nx or 0.0
                st.y += ny or 0.0
            if st.pen_down:
                if not cur:
                    cur = [(ox, oy)]
                cur.append((st.x, st.y))
                pen_moves += 1

    flush()
    return paths, pen_moves


def mm_polylines_to_steps(
    paths_mm: Sequence,
    steps_per_mm: float,
    canvas_w: int,
    canvas_h: int,
    invert_y: bool,
    offset_mm: Tuple[float, float] = (0.0, 0.0),
    scale: Tuple[float, float] = (1.0, 1.0),
) -> List[np.ndarray]:
    """mm → clamped integer steps with consecutive-duplicate dedup
    (gcode2stream.py:79-110,317-339), vectorized per polyline.

    Float semantics match the scalar reference exactly: the same float64
    expression per coordinate (elementwise, no reassociation) and
    round-half-even (np.rint == Python round on floats) before the clamp."""
    out: List[np.ndarray] = []
    for poly in paths_mm:
        if len(poly) < 2:
            continue
        a = np.asarray(poly, dtype=np.float64)
        if not np.isfinite(a).all():
            # the scalar reference's int(round(nan)) raises here; silently
            # casting nan would emit INT64_MIN step coordinates instead
            raise ValueError("non-finite coordinate in polyline")
        xf = (a[:, 0] * scale[0] + offset_mm[0]) * steps_per_mm
        yf = (a[:, 1] * scale[1] + offset_mm[1]) * steps_per_mm
        if invert_y:
            yf = (canvas_h - 1) - yf
        xi = np.clip(np.rint(xf), 0, canvas_w - 1).astype(np.int64)
        yi = np.clip(np.rint(yf), 0, canvas_h - 1).astype(np.int64)
        keep = np.ones(len(xi), bool)
        keep[1:] = (xi[1:] != xi[:-1]) | (yi[1:] != yi[:-1])
        pts = np.stack([xi[keep], yi[keep]], axis=1)
        if len(pts) >= 2:
            out.append(pts)
    return out


def order_nearest_l1(paths: List, start: Point = (0, 0)) -> List:
    """Greedy nearest-start ordering by L1 distance, no reversal
    (gcode2stream.py:151-172).  Vectorized inner scan: np.argmin's
    first-min tie-break over the live list order equals the reference's
    strict `d < best` scan over `remaining`, and pop() preserves that
    order; distances are integers, so equality is exact."""
    remaining = [p for p in paths if len(p) >= 2]
    if not remaining:
        return []
    starts = np.array([[int(p[0][0]), int(p[0][1])] for p in remaining], np.int64)
    ends = np.array([[int(p[-1][0]), int(p[-1][1])] for p in remaining], np.int64)

    from ..native.api import order_l1_native  # noqa: PLC0415

    order = order_l1_native(starts, ends, int(start[0]), int(start[1]))
    if order is not None:
        return [remaining[i] for i in order]

    alive = list(range(len(remaining)))
    out: List = []
    cur = np.array(start, np.int64)
    while alive:
        d = np.abs(starts[alive] - cur).sum(axis=1)
        i = alive.pop(int(np.argmin(d)))
        out.append(remaining[i])
        cur = ends[i]
    return out


def emit_stream(
    paths: List[List[Point]],
    prof: MotionProfile,
    color_index: int = 3,
) -> bytes:
    """Streams begin with pen_up + explicit initial speed + color select
    (unlike step 13; gcode2stream.py:399-423)."""
    sb = StreamEmitter()
    if not paths:
        return sb.finish()
    sb.pen_up()
    sb.speed(prof.div_start)
    sb.select_color(color_index)
    pos = (0, 0)
    for path in paths:
        if len(path) < 2:
            continue
        first = (int(path[0][0]), int(path[0][1]))
        if pos != first:
            sb.travel(pos[0], pos[1], first[0], first[1], prof)
        sb.pen_down()
        sb.polyline(path, prof)
        sb.pen_up()
        pos = (int(path[-1][0]), int(path[-1][1]))
    return sb.finish()


def scale_profile_speeds(prof: MotionProfile, speed_scale: float) -> MotionProfile:
    """Global feed-rate-style divider scaling with the reference's constraint
    clamps (gcode2stream.py:546-587)."""
    if speed_scale <= 0.0:
        raise ValueError("speed scale must be > 0")
    if abs(speed_scale - 1.0) < 1e-6:
        return prof

    def s(v: int) -> int:
        return max(1, int(round(v / speed_scale)))

    p = MotionProfile(**{**prof.__dict__})
    p.div_start = s(prof.div_start)
    p.div_fast = s(prof.div_fast)
    p.corner_div = s(prof.corner_div)
    p.short_div = s(prof.short_div)
    p.travel_div_fast = s(prof.travel_div_fast)
    p.travel_start_div = s(prof.travel_start_div)
    p.div_start = max(p.div_start, p.div_fast)
    p.corner_div = max(p.corner_div, p.div_fast)
    p.short_div = max(p.short_div, p.div_fast)
    p.travel_start_div = max(p.travel_start_div, p.travel_div_fast)
    p.div_start = max(p.div_start, p.travel_div_fast)
    return p


def gcode_to_stream(
    text: str,
    *,
    steps_per_mm: float = DEFAULT_STEPS_PER_MM,
    canvas_w: Optional[int] = None,
    canvas_h: Optional[int] = None,
    invert_y: bool = False,
    offset_mm: Tuple[float, float] = (0.0, 0.0),
    scale: Tuple[float, float] = (1.0, 1.0),
    color_index: int = 3,
    reorder: bool = True,
    profile: Optional[MotionProfile] = None,
    speed_scale: float = 1.0,
) -> Tuple[bytes, dict]:
    """Full G-code → stream conversion; returns (bytes, info dict)."""
    if canvas_w is None:
        canvas_w = int(round(A4_W_MM * steps_per_mm))
    if canvas_h is None:
        canvas_h = int(round(A4_H_MM * steps_per_mm))
    prof = profile or MotionProfile(steps_per_mm=steps_per_mm, invert_y=invert_y)
    prof = scale_profile_speeds(prof, speed_scale)

    paths_mm, pen_moves = parse_polylines_mm(text)
    paths = mm_polylines_to_steps(
        paths_mm, steps_per_mm, canvas_w, canvas_h, invert_y, offset_mm, scale
    )
    if reorder:
        paths = order_nearest_l1(paths, (0, 0))
    data = emit_stream(paths, prof, color_index)
    info = {
        "polylines_mm": len(paths_mm),
        "pen_down_moves": pen_moves,
        "polylines_steps": len(paths),
        "canvas_steps": [canvas_w, canvas_h],
        "bytes": len(data),
    }
    return data, info
