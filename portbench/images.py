"""The one traffic generator: seeded BGR images made on the device, of the
kind and with the parameters of a traffic mix's ``image`` group.  The same
seed, index, size, parameters and device give the same image.

Each image is a shot of a scene.  The scene is drawn from the mix's
``scene_seed`` and the image's index, ``shift_px`` pixels larger than the
image each way; the shot, drawn from the run's seed and the index, takes the
image's window of it at an offset of 0 to ``shift_px`` pixels in each
direction, and flips its rows and its columns, each with probability 1/2.
So every seed gives other bytes, another alignment of the scene to the
program's 32-pixel words and tiles, and other edges at the image's borders,
while the work stays that of the same scenes: how long the hysteresis and
the thinning run on a call is set by its scenes' widest tangles of edges,
and new scenes (or new sensor noise) would change it from seed to seed.

``"kind": "poster"`` — flat colours, as ``bench.py::synth_image`` draws them:
``shapes`` filled circles of radius r or squares of side r + 1 with the corner
at a uniform position, half of each kind, later shapes over earlier ones, on
white; r uniform in ``radius_px``, scaled by the image's longer side over
``radius_side_px``; each colour uniform over the BGR cube.

``"kind": "photo"`` — what a camera gives: smooth gradients (a ``base_grid``
of uniform colours, bicubically interpolated), ``objects`` sharp-edged
ellipses, each with its own linear colour gradient (semi-axes uniform in
``radius_px``, scaled as above), a luminance texture (a ``texture_grid`` of
normal values, bilinearly interpolated, times ``texture_amp``), and sensor
noise (normal, ``noise_sigma`` levels a channel), rounded to bytes.

No colour is moved off a near tie of two Lab centres: the comparison that
decides ``correct`` takes either label there (``reference/raster.py``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _generator(seed: int, index: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0]))
    return g


def _radii(params: dict, side: int):
    scale = side / float(params["radius_side_px"])
    return tuple(max(1, int(round(r * scale))) for r in params["radius_px"])


def poster(seed: int, index: int, h: int, w: int, side: int, params: dict, device=None) -> torch.Tensor:
    rng = np.random.default_rng([seed, index])
    n = int(params["shapes"])
    lo, hi = _radii(params, side)
    colours = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    xs, ys, rs = rng.integers(0, w, n), rng.integers(0, h, n), rng.integers(lo, hi, n)
    circles = rng.random(n) < 0.5
    img = torch.full((h, w, 3), 255, dtype=torch.uint8, device=device)
    for c, x, y, r, circle in zip(torch.from_numpy(colours).to(device), xs.tolist(), ys.tolist(), rs.tolist(),
                                  circles.tolist()):
        if circle:
            y0, y1, x0, x1 = max(y - r, 0), min(y + r + 1, h), max(x - r, 0), min(x + r + 1, w)
            yy = torch.arange(y0, y1, device=device)[:, None] - y
            xx = torch.arange(x0, x1, device=device)[None, :] - x
            inside = (yy * yy + xx * xx <= r * r)[..., None]
            img[y0:y1, x0:x1] = torch.where(inside, c, img[y0:y1, x0:x1])
        else:
            img[y : y + r + 1, x : x + r + 1] = c
    return img


def photo(seed: int, index: int, h: int, w: int, side: int, params: dict, device=None) -> torch.Tensor:
    g = _generator(seed, index, device)
    gh, gw = params["base_grid"]
    img = F.interpolate(torch.rand((1, 3, gh, gw), generator=g, device=device) * 255.0, size=(h, w),
                        mode="bicubic", align_corners=True)[0]
    lo, hi = _radii(params, side)
    n = int(params["objects"])
    # each object: centre (2), semi-axes (2), angle, colour (3), gradient along each axis (6)
    u = torch.rand((n, 14), generator=g, device=device).double().tolist()
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    for cy, cx, ra, rb, turn, *rest in u:
        a, b = lo + ra * (hi - lo), lo + rb * (hi - lo)
        cos, sin = np.cos(np.pi * turn), np.sin(np.pi * turn)
        dy, dx = yy - cy * h, xx - cx * w
        s, t = (cos * dx + sin * dy) / a, (cos * dy - sin * dx) / b
        inside = s * s + t * t <= 1.0
        colour = torch.tensor(rest[:3], device=device)[:, None, None] * 255.0
        slope = (torch.tensor(rest[3:], device=device).view(3, 2) - 0.5) * 160.0
        fill = colour + slope[:, :1, None] * s + slope[:, 1:, None] * t
        img = torch.where(inside, fill, img)
    th, tw = params["texture_grid"]
    img = img + F.interpolate(torch.randn((1, 1, th, tw), generator=g, device=device), size=(h, w),
                              mode="bilinear", align_corners=True)[0] * float(params["texture_amp"])
    img = img + torch.randn((3, h, w), generator=g, device=device) * float(params["noise_sigma"])
    return img.round().clamp(0, 255).to(torch.uint8).permute(1, 2, 0).contiguous()


KINDS = {"poster": poster, "photo": photo}


def shot(seed: int, index: int, shift: int) -> tuple:
    """(row offset, column offset, flip the rows, flip the columns) of image
    ``index`` of the ring of ``seed``."""
    dy, dx, fy, fx = np.random.default_rng([seed, index]).integers(0, [shift + 1, shift + 1, 2, 2]).tolist()
    return dy, dx, bool(fy), bool(fx)


def image(seed: int, index: int, h: int, w: int, params: dict, device=None) -> torch.Tensor:
    """Image ``index`` of the ring of ``seed``: (h, w, 3) uint8 BGR on ``device``."""
    m = int(params["shift_px"])
    scene = KINDS[params["kind"]](int(params["scene_seed"]), index, h + m, w + m, max(h, w), params, device)
    dy, dx, fy, fx = shot(seed, index, m)
    return scene[dy : dy + h, dx : dx + w].flip([d for d, f in ((0, fy), (1, fx)) if f]).contiguous()
