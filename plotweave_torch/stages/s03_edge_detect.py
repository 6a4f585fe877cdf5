"""[03] Edge detection → <layer>/edges.png + edges_composite.png
(twin of ``plotweave/stages/s03_edge_detect.py``).

In a chained run stage 02 has computed the edges already (the fused chain's
blob); otherwise — a resumed run — the same ops run here, layer-batched, on
the raster device, over the masks that stage 02's device mode left there in
this process (the device-artifact registry) or else read from disk.  The
edges stay on the device for stage 04 the same way.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.thinning import dense_from_boards, pack_bitboards
from ..utils import (fetch_derived_artifact, fetch_device_artifact, read_image, register_derived_artifact,
                     register_device_artifact, thread_map, write_image)
from ..utils.devices import raster_device
from .common import chain_key, edge_params, layer_dir, palette_bgr
from .s02_color_extract import edges_from_boards


def device_boards(paths, device: torch.device):
    """The (L, H, ⌈W/32⌉) bitboards and width that an earlier stage of this
    process registered for ``paths`` on ``device``, or None where any is
    missing, stale or elsewhere."""
    held = [fetch_device_artifact(p) for p in paths]
    if not held or not all(isinstance(b, tuple) and b[0].device.type == device.type for b in held):
        return None
    return torch.stack([b for b, _ in held]), held[0][1]


def run(cfg: PipelineConfig) -> None:
    names = list(cfg.color_names)
    mask_paths = [os.path.join(cfg.output_dir, n, "mask.png") for n in names]
    fused = fetch_derived_artifact(chain_key(cfg, "edges+skels"), pop=True)
    edges_b = None
    if fused is not None:
        packed_edges, packed_skels, w = fused
        edges = np.unpackbits(packed_edges, axis=-1)[..., :w] * np.uint8(255)
    else:
        device = raster_device(cfg)
        held = device_boards(mask_paths, device)
        if held is None:
            masks = []
            for p in mask_paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Mask not found: {p}")
                masks.append(read_image(p, gray=True))
            batch = torch.from_numpy(np.stack(masks, axis=0)).to(device)
            held = pack_bitboards(batch), batch.shape[-1]
        edges_b = edges_from_boards(*held, *edge_params(cfg))
        edges = dense_from_boards(edges_b, held[1], 255).cpu().numpy()
        packed_skels = None

    # PNG encode dominates the host cost at large sizes; cv2 releases the GIL
    def write_one(i_name):
        i, name = i_name
        out = os.path.join(layer_dir(cfg, name), "edges.png")
        write_image(out, edges[i])
        return out, int(np.count_nonzero(edges[i]))

    results = thread_map(write_one, list(enumerate(names)))
    if edges_b is not None:
        # the device copy for stage 04 (the values of the PNG), as (bitboard, width)
        for i, (out, _nz) in enumerate(results):
            register_device_artifact(out, (edges_b[i], edges.shape[-1]))

    edges_by_name = {}
    for i, (name, (_out, nz)) in enumerate(zip(names, results)):
        edges_by_name[name] = edges[i]
        print(f"Edges extracted: {name} | nz={nz}")

    if packed_skels is not None:
        # republish the chain's skeletons keyed to the edge files just written
        register_derived_artifact(
            chain_key(cfg, "skels"), [r[0] for r in results], (packed_skels, edges.shape[-1])
        )

    _composite(cfg, names, edges_by_name)


def _composite(cfg: PipelineConfig, names, edges_by_name=None) -> None:
    """Overlay per-layer edges in layer colors on white (03:60-111).

    Keeps the reference's palette quirk: it looks up key "bgr", which the
    stage-02 palette never writes, so colors always fall back to cfg.colors.
    """
    edges_by_name = edges_by_name or {}
    try:
        base = read_image(os.path.join(cfg.output_dir, "resized.png"))
        h, w = base.shape[:2]
    except FileNotFoundError:
        h = w = None
        for name in names:
            p = os.path.join(cfg.output_dir, name, "edges.png")
            if os.path.exists(p):
                h, w = read_image(p, gray=True).shape[:2]
                break
        if h is None:
            raise FileNotFoundError("No edges found to build edges_composite.png")
    canvas = np.full((h, w, 3), 255, np.uint8)
    colors = palette_bgr(cfg, key="bgr")
    for name in names:
        e = edges_by_name.get(name)
        if e is None:
            p = os.path.join(cfg.output_dir, name, "edges.png")
            if not os.path.exists(p):
                continue
            e = read_image(p, gray=True)
        m = e > 0
        if m.any():
            canvas[m] = colors[name]
    out = os.path.join(cfg.output_dir, "edges_composite.png")
    write_image(out, canvas)
    print(f"Edges composite saved: {out}")
