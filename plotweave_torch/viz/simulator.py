"""Stream simulator: decode + replay a plotter stream, render to an image or
drive an interactive pygame playback (reference
shared/omnirevolve_plotter_stream_previewer.py).

The decoder statistics (EOF, tail-after-EOF, off-canvas steps, final
position, byte/step/service totals) are the protocol's invariant counters —
printable via --stats and used as the executable spec in tests.

Copy of ``plotweave/viz/simulator.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

import numpy as np

from ..stream.decoder import StreamDecoder, replay

BGR = Tuple[int, int, int]
DEFAULT_PALETTE: List[BGR] = [(0, 0, 255), (0, 255, 0), (255, 0, 0), (0, 0, 0)]  # R,G,B,K in BGR
TAP_DIAM_PX = 10


def parse_color(spec: str) -> Tuple[int, int, int]:
    """'r'/'red'/'#rrggbb'/'r,g,b' → RGB tuple."""
    s = spec.strip().lower()
    named = {
        "r": (255, 0, 0), "red": (255, 0, 0),
        "g": (0, 255, 0), "green": (0, 255, 0),
        "b": (0, 0, 255), "blue": (0, 0, 255),
        "k": (0, 0, 0), "black": (0, 0, 0),
        "w": (255, 255, 255), "white": (255, 255, 255),
        "y": (255, 255, 0), "yellow": (255, 255, 0),
        "c": (0, 255, 255), "cyan": (0, 255, 255),
        "m": (255, 0, 255), "magenta": (255, 0, 255),
    }
    if s in named:
        return named[s]
    if s.startswith("#") and len(s) == 7:
        return (int(s[1:3], 16), int(s[3:5], 16), int(s[5:7], 16))
    if "," in s:
        r, g, b = (max(0, min(255, int(p))) for p in s.split(","))
        return (r, g, b)
    raise ValueError(f"Bad color spec: {spec}")


def render_stream(
    data: bytes,
    canvas_w: int,
    canvas_h: int,
    render_w: int = 1200,
    render_h: int = 900,
    invert_y: bool = True,
    palette: Optional[List[BGR]] = None,
    render_taps: bool = True,
    white_bg: bool = True,
) -> Tuple[np.ndarray, StreamDecoder]:
    """Headless render: replay the stream onto a BGR image."""
    import cv2  # noqa: PLC0415

    palette = palette or DEFAULT_PALETTE
    dec = StreamDecoder(data)
    res = replay(dec, canvas_w, canvas_h)

    scale = min(render_w / max(1, canvas_w), render_h / max(1, canvas_h))
    used_w, used_h = int(canvas_w * scale), int(canvas_h * scale)
    ox, oy = (render_w - used_w) // 2, (render_h - used_h) // 2
    img = np.full((render_h, render_w, 3), 255 if white_bg else 0, np.uint8)

    def to_px(x: int, y: int) -> Tuple[int, int]:
        px = int(ox + x * scale)
        py = int(oy + (canvas_h - 1 - y) * scale) if invert_y else int(oy + y * scale)
        return px, py

    for poly, cidx in zip(res.polylines, res.colors):
        color = palette[min(cidx, len(palette) - 1)]
        pts = np.array([to_px(int(x), int(y)) for x, y in poly], np.int32).reshape(-1, 1, 2)
        cv2.polylines(img, [pts], False, color, 1, cv2.LINE_8)
    if render_taps:
        for (x, y), cidx in zip(res.taps, res.tap_colors):
            color = palette[min(cidx, len(palette) - 1)]
            cv2.circle(img, to_px(int(x), int(y)), max(1, TAP_DIAM_PX // 2), color, -1)
    cv2.rectangle(img, (ox, oy), (ox + used_w - 1, oy + used_h - 1), (30, 30, 30), 1)
    return img, dec


def print_stats(dec: StreamDecoder, file=sys.stderr) -> None:
    s = dec.stats
    print("=== Stream statistics ===", file=file)
    print(f"bytes={s.total_bytes} step_bytes={s.step_bytes} service_bytes={s.service_bytes}", file=file)
    print(f"steps={s.steps_total} singles={s.single_steps} doubles={s.double_steps}", file=file)
    print(f"pen_down_segments={s.pen_down_segments} taps={s.taps}", file=file)
    print(f"color_changes={s.color_changes} speed_changes={s.speed_changes}", file=file)
    print(f"off_canvas_steps={s.off_canvas_steps} eof={s.eof_seen} tail_after_eof={s.tail_after_eof}", file=file)
    print(f"final=({s.final_x}, {s.final_y})", file=file)


class PlaybackEngine:
    """Headless playback core for the interactive simulator (reference
    previewer's play/pause/step/seek/zoom, previewer:412-503).

    Maintains the pen state machine over the decoded command list and calls
    ``draw_line(x0, y0, x1, y1, color_idx)`` / ``draw_tap(x, y, color_idx)``
    for visible marks.  Backward seeks restore the nearest (state, canvas)
    snapshot — ``save_canvas``/``restore_canvas`` callbacks own the pixels —
    then replay forward, so any position is reachable deterministically."""

    def __init__(self, commands, draw_line, draw_tap, save_canvas, restore_canvas, snapshot_every: int = 50_000):
        from ..stream.decoder import COLOR, PEN, STEP  # noqa: PLC0415
        from ..stream.protocol import DIR_VECTORS, B_PEN_DOWN, B_PEN_UP, B_TAP  # noqa: PLC0415

        self._c = (STEP, PEN, COLOR, DIR_VECTORS, B_PEN_DOWN, B_PEN_UP, B_TAP)
        self.commands = commands
        self.draw_line = draw_line
        self.draw_tap = draw_tap
        self.save_canvas = save_canvas
        self.restore_canvas = restore_canvas
        self.snapshot_every = max(1, snapshot_every)
        self._snaps = {}  # i -> (x, y, pen, color_idx, canvas token)
        self.reset()

    def reset(self) -> None:
        self.i = 0
        self.x = self.y = 0
        self.pen = False
        self.color_idx = 0

    def clear_snapshots(self) -> None:
        """Call after any viewport change — cached canvases are stale."""
        self._snaps.clear()

    def _step_one(self) -> None:
        STEP, PEN, COLOR, DIRV, DOWN, UP, TAP = self._c
        kind, v = self.commands[self.i]
        if kind == STEP:
            nx, ny = self.x + int(DIRV[v][0]), self.y + int(DIRV[v][1])
            if self.pen:
                self.draw_line(self.x, self.y, nx, ny, self.color_idx)
            self.x, self.y = nx, ny
        elif kind == PEN:
            if v == DOWN:
                self.pen = True
            elif v == UP:
                self.pen = False
            elif v == TAP:
                self.draw_tap(self.x, self.y, self.color_idx)
                self.pen = False
        elif kind == COLOR:
            self.color_idx = v
        self.i += 1

    def seek(self, target: int) -> None:
        """Move the cursor to ``target`` (clamped), replaying as needed."""
        target = max(0, min(target, len(self.commands)))
        if target < self.i:
            # restore the nearest snapshot at or before target
            cand = [k for k in self._snaps if k <= target]
            if cand:
                k = max(cand)
                self.i, self.x, self.y, self.pen, self.color_idx, tok = self._snaps[k]
                self.restore_canvas(tok)
            else:
                self.reset()
                self.restore_canvas(None)  # None = blank canvas
        while self.i < target:
            self._step_one()
            if self.i % self.snapshot_every == 0 and self.i not in self._snaps:
                self._snaps[self.i] = (self.i, self.x, self.y, self.pen, self.color_idx, self.save_canvas())

    def advance(self, n: int) -> None:
        self.seek(self.i + n)

    @property
    def done(self) -> bool:
        return self.i >= len(self.commands)


def run_interactive(data: bytes, canvas_w: int, canvas_h: int, invert_y: bool, palette: List[BGR]) -> None:
    """Interactive pygame playback (reference previewer parity):

    SPACE play/pause · RIGHT/LEFT step ±500 · PgDn/PgUp seek ±50k ·
    HOME/END start/end · UP/DOWN playback speed ×2/÷2 · +/- zoom ·
    W/A/S/D pan · R reset view+position · ESC quit."""
    import pygame  # noqa: PLC0415

    dec = StreamDecoder(data)
    pygame.init()
    W, Hpx = 1200, 900
    screen = pygame.display.set_mode((W, Hpx))
    base_scale = min(W / canvas_w, Hpx / canvas_h)
    zoom = 1.0
    off_x = off_y = 0.0
    surf = pygame.Surface((W, Hpx))
    surf.fill((255, 255, 255))

    def to_px(x, y):
        yy = (canvas_h - 1 - y) if invert_y else y
        return (int(x * base_scale * zoom + off_x), int(yy * base_scale * zoom + off_y))

    def draw_line(x0, y0, x1, y1, ci):
        pygame.draw.line(surf, palette[min(ci, len(palette) - 1)], to_px(x0, y0), to_px(x1, y1), 1)

    def draw_tap(x, y, ci):
        pygame.draw.circle(surf, palette[min(ci, len(palette) - 1)], to_px(x, y), max(2, int(5 * zoom)))

    def save_canvas():
        return surf.copy()

    def restore_canvas(tok):
        if tok is None:
            surf.fill((255, 255, 255))
        else:
            surf.blit(tok, (0, 0))

    eng = PlaybackEngine(
        dec.commands, draw_line, draw_tap, save_canvas, restore_canvas,
        snapshot_every=max(50_000, len(dec.commands) // 16),
    )

    def rerender():
        """Re-render up to the current position after a viewport change."""
        pos = eng.i
        eng.clear_snapshots()
        eng.reset()
        restore_canvas(None)
        eng.seek(pos)

    playing = False
    speed = 5_000
    clock = pygame.time.Clock()
    font = pygame.font.SysFont(None, 22)
    running = True
    while running:
        for e in pygame.event.get():
            if e.type == pygame.QUIT:
                running = False
            elif e.type == pygame.KEYDOWN:
                k = e.key
                if k == pygame.K_ESCAPE:
                    running = False
                elif k == pygame.K_SPACE:
                    playing = not playing
                elif k == pygame.K_RIGHT:
                    eng.advance(500)
                elif k == pygame.K_LEFT:
                    eng.seek(eng.i - 500)
                elif k == pygame.K_PAGEDOWN:
                    eng.advance(50_000)
                elif k == pygame.K_PAGEUP:
                    eng.seek(eng.i - 50_000)
                elif k == pygame.K_HOME:
                    eng.seek(0)
                elif k == pygame.K_END:
                    eng.seek(len(dec.commands))
                elif k == pygame.K_UP:
                    speed = min(200_000, speed * 2)
                elif k == pygame.K_DOWN:
                    speed = max(100, speed // 2)
                elif k in (pygame.K_PLUS, pygame.K_EQUALS, pygame.K_KP_PLUS):
                    zoom = min(32.0, zoom * 1.25)
                    rerender()
                elif k in (pygame.K_MINUS, pygame.K_KP_MINUS):
                    zoom = max(0.1, zoom / 1.25)
                    rerender()
                elif k == pygame.K_a:
                    off_x += 80; rerender()
                elif k == pygame.K_d:
                    off_x -= 80; rerender()
                elif k == pygame.K_w:
                    off_y += 80; rerender()
                elif k == pygame.K_s:
                    off_y -= 80; rerender()
                elif k == pygame.K_r:
                    zoom, off_x, off_y = 1.0, 0.0, 0.0
                    eng.clear_snapshots()
                    eng.reset()
                    restore_canvas(None)
        if playing:
            eng.advance(speed)
            if eng.done:
                playing = False
        screen.blit(surf, (0, 0))
        hud = f"{eng.i}/{len(dec.commands)} cmds  speed {speed}/frame  zoom {zoom:.2f}  [SPACE ←→ PgUp/Dn HOME END +/- WASD R ESC]"
        screen.blit(font.render(hud, True, (40, 40, 40), (255, 255, 255)), (8, Hpx - 24))
        pygame.display.flip()
        clock.tick(60)
    pygame.quit()
    print_stats(dec)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="plotweave stream simulator")
    ap.add_argument("input")
    ap.add_argument("-o", "--output", help="render PNG headlessly instead of interactive playback")
    ap.add_argument("--canvas-w-steps", type=int, default=13210)
    ap.add_argument("--canvas-h-steps", type=int, default=13019)
    ap.add_argument("--invert-y", type=int, choices=[0, 1], default=1)
    ap.add_argument("--render-width", type=int, default=1200)
    ap.add_argument("--render-height", type=int, default=900)
    ap.add_argument("--render-taps", type=int, choices=[0, 1], default=1)
    ap.add_argument("--background-white", type=int, choices=[0, 1], default=1)
    ap.add_argument("--tick-freq", type=int, default=10000)
    ap.add_argument("--c0", default="R")
    ap.add_argument("--c1", default="G")
    ap.add_argument("--c2", default="B")
    ap.add_argument("--c3", default="K")
    args = ap.parse_args(argv)

    rgb = [parse_color(args.c0), parse_color(args.c1), parse_color(args.c2), parse_color(args.c3)]
    data = open(args.input, "rb").read()

    if args.output:
        bgr = [(b, g, r) for (r, g, b) in rgb]
        img, dec = render_stream(
            data,
            args.canvas_w_steps,
            args.canvas_h_steps,
            args.render_width,
            args.render_height,
            bool(args.invert_y),
            bgr,
            bool(args.render_taps),
            bool(args.background_white),
        )
        import cv2  # noqa: PLC0415

        cv2.imwrite(args.output, img)
        print(f"Image saved: {args.output}")
        print_stats(dec)
    else:
        run_interactive(data, args.canvas_w_steps, args.canvas_h_steps, bool(args.invert_y), rgb)


if __name__ == "__main__":
    main()
