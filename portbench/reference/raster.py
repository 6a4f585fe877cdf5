"""Plain reference of the raster front-end: plain PyTorch on dense pixels, on
whatever device its inputs are on.

It imports nothing of the program.  It states the operations as the
published pipeline and the program's documented contract define them:

- Lab from BGR bytes: sRGB → linear → XYZ (D65) → L*a*b*, packed as OpenCV's
  8-bit scaling (L·255/100, a + 128, b + 128), in float64; each pixel takes
  the centre of least squared distance, the first on a tie.  Where the
  nearest two lie within ``near_tie`` (squared 8-bit Lab units), float32
  arithmetic may take either, and the configuration allows it: the
  comparison (:func:`judge`) bounds what such a pixel can change.
- Binary morphology with a rect or ellipse element of OpenCV's geometry, the
  anchor at its centre: a dilation ORs the element's shifts, reading 0
  outside the plane; an erosion is the complement's dilation complemented, so
  a read outside reads set.  A row is worked ⌈W/32⌉·32 pixels wide, as the
  program's 32-pixel words hold it: a dilation writes the columns past W, an
  erosion clears them.
- The blur: OpenCV's fixed-point Gaussian (Q8 taps summing to 256), a row
  pass then a column pass over a reflect-101 border, one rounding
  ``(acc + 2^15) >> 16`` at the end.
- Canny on the blurred bytes: 3×3 Sobel over a replicated border, the L1
  magnitude, OpenCV's Q15 sector non-maximum suppression (a magnitude past the
  border reads 0), candidates above ``low``, strong above ``high``; the
  hysteresis keeps each candidate 8-connected through candidates to a strong
  pixel.
- Zhang–Suen thinning, its neighbour ring rotated by 180° (stage 04's), at
  most ``max_iter`` iterations of both subpasses; a plane's count is the
  iterations it runs until one that changes nothing in it, that one included.

``lab_dtype`` runs the same functions with Lab in a lower precision: the
benchmark's control, which must come out as not correct.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# sRGB → XYZ (D65) and the white point
_M = ((0.412453, 0.357580, 0.180423), (0.212671, 0.715160, 0.072169), (0.019334, 0.119193, 0.950227))
_WHITE = (0.950456, 1.0, 1.088754)
_D3 = (6.0 / 29.0) ** 3
_TAPS = {1: (256,), 3: (64, 128, 64), 5: (16, 64, 96, 64, 16), 7: (8, 28, 56, 72, 56, 28, 8)}
_TG22 = 13573  # tan(22.5°) in Q15
# the neighbours P2..P9 (N, NE, E, SE, S, SW, W, NW) as (dy, dx), rotated by 180°
_RING = tuple((-dy, -dx) for dy, dx in ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)))
HYSTERESIS_CHECK = 16  # sweeps between two looks at whether the edges still grow


def lab8(bgr: torch.Tensor, dtype=torch.float64):
    """(..., 3) uint8 BGR → ((..., 3) Lab in 8-bit scaling, the XYZ values
    above (6/29)^3, where the cube root is taken)."""
    u = bgr.to(dtype) / 255.0
    lin = [torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4) for c in (u[..., 2], u[..., 1], u[..., 0])]
    xyz = [(m[0] * lin[0] + m[1] * lin[1] + m[2] * lin[2]) / white for m, white in zip(_M, _WHITE)]
    above = sum(int((t > _D3).sum()) for t in xyz)
    fx, fy, fz = (torch.where(t > _D3, t.clamp(min=0) ** (1.0 / 3.0), t / (3 * (6.0 / 29.0) ** 2) + 4.0 / 29.0)
                  for t in xyz)
    lab = torch.stack([(116.0 * fy - 16.0) * 255.0 / 100.0, 500.0 * (fx - fy) + 128.0, 200.0 * (fy - fz) + 128.0], -1)
    return lab, above


def squared_distances(lab: torch.Tensor, centres) -> torch.Tensor:
    """(..., 3) Lab, (k, 3) centres → (..., k) squared distances in Lab's dtype."""
    c = torch.as_tensor(centres, dtype=lab.dtype, device=lab.device)
    return ((lab[..., None, :] - c) ** 2).sum(-1)


def nearest(image: torch.Tensor, centres, near_tie: float, dtype=torch.float64):
    """(H, W, 3) uint8 BGR → ((H, W) int64 nearest centre, (H, W, k) bool: the
    centres within ``near_tie`` of the nearest, the cube roots taken)."""
    lab, above = lab8(image, dtype)
    d = squared_distances(lab, centres)
    best = d.min(-1, keepdim=True)
    return best.indices[..., 0], d <= best.values + near_tie, above


def element(shape: str, ksize: int) -> torch.Tensor:
    """OpenCV's rect or ellipse structuring element, (ksize, ksize) bool."""
    if shape == "rect":
        return torch.ones((ksize, ksize), dtype=torch.bool)
    if shape != "ellipse":
        raise ValueError(f"unknown element {shape!r}")
    r = ksize // 2
    se = torch.zeros((ksize, ksize), dtype=torch.bool)
    for i in range(ksize):
        dy = i - r
        dx = round(r * ((r * r - dy * dy) / (r * r)) ** 0.5) if r else 0
        se[i, max(r - dx, 0) : min(r + dx + 1, ksize)] = True
    return se


def _shifted(p: torch.Tensor, r: int, dy: int, dx: int, h: int, w: int) -> torch.Tensor:
    """x[..., y + dy, x + dx] of the plane padded by ``r`` into ``p``."""
    return p[..., r + dy : r + dy + h, r + dx : r + dx + w]


def dilate(x: torch.Tensor, se: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 0/1 dilated by ``se``; 0 outside the plane."""
    r = se.shape[0] // 2
    h, w = x.shape[-2:]
    p = F.pad(x, (r, r, r, r))
    out = torch.zeros_like(x)
    for dy, dx in se.nonzero().tolist():
        out |= _shifted(p, r, dy - r, dx - r, h, w)
    return out


def morphology(masks: torch.Tensor, steps, width: int) -> torch.Tensor:
    """A step list ((shape, ksize, 'e' or 'd'), ...) on (..., H, W) uint8 0/1
    masks, each row worked ⌈W/32⌉·32 pixels wide → (..., H, W) uint8 0/1."""
    x = F.pad(masks, (0, -(-width // 32) * 32 - width))
    valid = torch.zeros(x.shape[-1], dtype=torch.uint8, device=x.device)
    valid[:width] = 1
    for shape, ksize, op in steps:
        se = element(shape, ksize)
        x = dilate(x, se) if op == "d" else (dilate((x ^ 1) & valid, se) ^ 1) & valid
    return x[..., :width].contiguous()


def _reflect101(n: int, r: int, device) -> torch.Tensor:
    i = torch.arange(-r, n + r, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i.abs() % period
    return torch.where(i >= n, period - i, i)


def blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """OpenCV's fixed-point Gaussian of (..., H, W) uint8, sigma 0, ksize 1 to 7."""
    taps = _TAPS[ksize]
    r = ksize // 2
    if r == 0:
        return img
    h, w = img.shape[-2:]
    p = img.to(torch.int32).index_select(-1, _reflect101(w, r, img.device))
    rows = sum(taps[i] * p[..., :, i : i + w] for i in range(ksize))
    p = rows.index_select(-2, _reflect101(h, r, img.device))
    acc = sum(taps[i] * p[..., i : i + h, :] for i in range(ksize))
    return ((acc + (1 << 15)) >> 16).clamp(0, 255).to(torch.uint8)


def _zero_border(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = x.shape[-2:]
    return _shifted(F.pad(x, (1, 1, 1, 1)), 1, dy, dx, h, w)


def canny_candidates(img: torch.Tensor, low: int, high: int):
    """Sobel, the L1 magnitude, sector NMS and the double threshold of
    (..., H, W) uint8 → (candidates, strong), uint8 0/1."""
    h, w = img.shape[-2:]
    rows = torch.arange(-1, h + 1, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=img.device).clamp(0, w - 1)
    p = img.to(torch.int32).index_select(-2, rows).index_select(-1, cols)

    def at(dy, dx):
        return _shifted(p, 1, dy, dx, h, w)

    gx = (at(-1, 1) + 2 * at(0, 1) + at(1, 1)) - (at(-1, -1) + 2 * at(0, -1) + at(1, -1))
    gy = (at(1, -1) + 2 * at(1, 0) + at(1, 1)) - (at(-1, -1) + 2 * at(-1, 0) + at(-1, 1))
    mag = gx.abs() + gy.abs()
    low, high = min(low, high), max(low, high)
    ax, ay = gx.abs(), gy.abs() << 15
    tg22 = ax * _TG22
    tg67 = tg22 + (ax << 16)
    m = {(dy, dx): _zero_border(mag, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx}
    keep_h = (mag > m[0, -1]) & (mag >= m[0, 1])
    keep_v = (mag > m[-1, 0]) & (mag >= m[1, 0])
    keep_d = torch.where((gx ^ gy) < 0, (mag > m[-1, 1]) & (mag > m[1, -1]), (mag > m[-1, -1]) & (mag > m[1, 1]))
    keep = torch.where(ay < tg22, keep_h, torch.where(ay > tg67, keep_v, keep_d))
    cand = (mag > low) & keep
    return cand.to(torch.uint8), (cand & (mag > high)).to(torch.uint8)


def dilate8(e: torch.Tensor) -> torch.Tensor:
    row = e | _zero_border(e, 0, -1) | _zero_border(e, 0, 1)
    return row | _zero_border(row, -1, 0) | _zero_border(row, 1, 0)


def hysteresis(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """The candidates 8-connected through candidates to a strong pixel."""
    edges = strong & cand
    while True:
        before = edges
        for _ in range(HYSTERESIS_CHECK):
            edges = cand & dilate8(edges)
        if torch.equal(edges, before):
            return edges


def _subpass(x: torch.Tensor, first: bool) -> torch.Tensor:
    h, w = x.shape[-2:]
    pad = F.pad(x, (1, 1, 1, 1))
    p = [_shifted(pad, 1, dy, dx, h, w) for dy, dx in _RING]
    b = sum(p[1:], p[0].clone())
    a = sum(((p[i] == 0) & (p[(i + 1) % 8] == 1)).to(torch.uint8) for i in range(8))
    if first:
        dir_ok = ((p[0] & p[2] & p[4]) == 0) & ((p[2] & p[4] & p[6]) == 0)
    else:
        dir_ok = ((p[0] & p[2] & p[6]) == 0) & ((p[0] & p[4] & p[6]) == 0)
    kill = (x == 1) & (a == 1) & (b >= 2) & (b <= 6) & dir_ok
    return x & (~kill).to(torch.uint8)


def thin(x: torch.Tensor, max_iter: int = 120):
    """Zhang–Suen of (..., H, W) uint8 0/1 planes → (the skeletons, a list of
    each plane's iterations, in the planes' order)."""
    planes = x.reshape(-1, *x.shape[-2:])
    iters = torch.zeros(planes.shape[0], dtype=torch.int64, device=x.device)
    active = torch.ones_like(iters, dtype=torch.bool)
    for i in range(max_iter):
        nxt = _subpass(_subpass(planes, True), False)
        iters[active] = i + 1
        active &= (nxt != planes).flatten(1).any(1)
        planes = nxt
        if not bool(active.any()):
            break
    return planes.reshape(x.shape), iters.tolist()


def program(shape: str, ksize: int, iterations: int, ops: str) -> list:
    """Each of ``ops`` ('e' erode, 'd' dilate) ``iterations`` times, in order."""
    return [(shape, ksize, op) for op in ops for _ in range(iterations)]


def frontend_steps(extract_iters: int = 1, edge_kernel: int = 3, edge_iters: int = 1) -> list:
    """The front-end's morphology: a 3×3 rect open and close of the masks,
    then an ellipse open and close."""
    return (program("rect", 3, extract_iters, "ed") + program("rect", 3, extract_iters, "de")
            + program("ellipse", edge_kernel, edge_iters, "ed") + program("ellipse", edge_kernel, edge_iters, "de"))


def dilate_square(x: torch.Tensor, r: int) -> torch.Tensor:
    """(..., H, W) uint8 0/1 dilated by a (2r + 1)-square; 0 outside."""
    h, w = x.shape[-2:]
    p = F.pad(x, (r, r, 0, 0))
    row = torch.zeros_like(x)
    for dx in range(2 * r + 1):
        row |= p[..., :, dx : dx + w]
    p = F.pad(row, (0, 0, r, r))
    out = torch.zeros_like(x)
    for dy in range(2 * r + 1):
        out |= p[..., dy : dy + h, :]
    return out


def reconstruct(mask: torch.Tensor, seeds: torch.Tensor, steps: int) -> torch.Tensor:
    """The pixels of ``mask`` that ``steps`` 3×3 dilations of ``seeds`` reach
    through ``mask`` (fewer where it stops growing)."""
    z = seeds & mask
    done = 0
    while done < steps:
        before = z
        for _ in range(min(HYSTERESIS_CHECK, steps - done)):
            z = mask & dilate8(z)
        done += HYSTERESIS_CHECK
        if torch.equal(z, before):
            break
    return z


def frontend(images: torch.Tensor, centres, k: int, *, extract_iters: int = 1, edge_kernel: int = 3,
             edge_iters: int = 1, blur_kernel: int = 7, low: int = 22, high: int = 70, thin_iters: int = 120,
             near_tie: float = 0.0, lab_dtype=torch.float64) -> dict:
    """(B, H, W, 3) uint8 BGR → the raster front-end, image by image, as a
    dict of (B, k, H, W) uint8 0/1 planes and counts:

    - ``edges``, ``skeletons``: each pixel labelled by its nearest centre;
    - ``edges_lo``, ``edges_hi``: the least and the most edges that any
      choice among the centres within ``near_tie`` gives.  The morphology
      and the hysteresis are monotone, so the masks' bounds bound the
      morphology's; the blur, Sobel and NMS read within ``blur_kernel // 2 +
      2`` px, so a candidate or strong pixel farther than that from where the
      bounds differ is settled, and one nearer is taken as not a candidate
      (lo) or as a strong one (hi);
    - ``counts``: ``k6_iterations`` (each image's layers in turn),
      ``k7_cube_roots`` (XYZ values above (6/29)^3) and ``near_ties``
      (pixels with more than one centre within ``near_tie``)."""
    steps = frontend_steps(extract_iters, edge_kernel, edge_iters)
    b, h, w = images.shape[:3]
    out = {name: torch.empty((b, k, h, w), dtype=torch.uint8, device=images.device)
           for name in ("edges", "skeletons", "edges_lo", "edges_hi")}
    counts = {"k6_iterations": [], "k7_cube_roots": 0, "near_ties": 0}
    layer = torch.arange(k, device=images.device)
    for i in range(b):
        best, near, above = nearest(images[i], centres[:k], near_tie, lab_dtype)
        m = morphology((best == layer[:, None, None]).to(torch.uint8), steps, w)
        del best
        cand, strong = canny_candidates(blur(m * 255, blur_kernel), low, high)
        edges = hysteresis(cand, strong)
        skel, iters = thin(edges, thin_iters)
        out["edges"][i], out["skeletons"][i] = edges, skel
        counts["k6_iterations"] += iters
        counts["k7_cube_roots"] += above
        several = near.sum(-1) > 1
        ties = int(several.sum())
        counts["near_ties"] += ties
        if ties:
            near = near.permute(2, 0, 1)
            unsure = morphology(near.to(torch.uint8), steps, w) ^ morphology((near & ~several).to(torch.uint8),
                                                                               steps, w)
            unsure = dilate_square(unsure, blur_kernel // 2 + 2)
            out["edges_lo"][i] = hysteresis(cand & (unsure ^ 1), strong & (unsure ^ 1))
            out["edges_hi"][i] = hysteresis(cand | unsure, strong | unsure)
        else:
            out["edges_lo"][i] = out["edges_hi"][i] = edges
        del near, several, m, cand, strong
    out["counts"] = counts
    return out


def judge(edges: torch.Tensor, skeletons: torch.Tensor, ref: dict, thin_iters: int) -> dict:
    """Bytes of the program's (..., k, H, W) edges (0/255) and skeletons (0/1)
    that the reference rules out: an edge byte off 0/255 or outside
    [``edges_lo``, ``edges_hi``]; a skeleton byte off 0/1, or unequal to the
    reference's where no thinning could have carried a difference of the two
    edge maps.  A subpass changes a pixel only from its 3×3 ring, and only
    from set to clear, so the thinnings of two edge maps can differ only
    where ``2 * thin_iters`` 3×3 dilations of where the maps differ reach
    through the pixels set in either.  With the reference's edges, none."""
    if edges.shape != ref["edges"].shape or skeletons.shape != ref["edges"].shape or edges.dtype != torch.uint8 \
            or skeletons.dtype != torch.uint8:
        return {"edges_off": ref["edges"].numel(), "skeletons_off": ref["edges"].numel()}
    edges, skeletons = edges.to(ref["edges"].device), skeletons.to(ref["edges"].device)
    on = (edges != 0).to(torch.uint8)
    edges_off = ((edges != on * 255) | (on > ref["edges_hi"]) | (on < ref["edges_lo"])).sum()
    differ = on ^ ref["edges"]
    zone = reconstruct(on | ref["edges"], differ, 2 * thin_iters) if bool(differ.any()) else differ
    skeletons_off = ((skeletons > 1) | ((skeletons != ref["skeletons"]) & (zone == 0))).sum()
    return {"edges_off": int(edges_off), "skeletons_off": int(skeletons_off)}
