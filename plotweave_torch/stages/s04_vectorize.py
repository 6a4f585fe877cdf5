"""[04] Vectorization: edges → skeleton → centerline polylines →
<layer>/contours.pkl (twin of ``plotweave/stages/s04_vectorize.py``).

In a chained run the skeletons come from the fused chain's blob; otherwise
the edges that stage 03 left on the raster device in this process (the
device-artifact registry), or else read from disk, are thinned here,
layer-batched.  Tracing runs on the host per layer (``vector/trace.py``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import PipelineConfig
from ..ops.thinning import dense_from_boards, pack_bitboards, zhang_suen_packed
from ..utils import fetch_derived_artifact, read_image, save_pickle, thread_map
from ..utils.devices import raster_device
from ..utils.io import save_pickle_async
from ..vector.trace import trace_skeleton_fast
from .common import chain_key, layer_dir
from .s03_edge_detect import device_boards


def run(cfg: PipelineConfig) -> None:
    names = list(cfg.color_names)

    t0 = time.perf_counter()
    fused = fetch_derived_artifact(chain_key(cfg, "skels"), pop=True)
    if fused is not None:
        packed_skels, w = fused
        skeletons = np.unpackbits(packed_skels, axis=-1)[..., :w]
        print(f"[vectorize] thinning (fused-chain handoff, {len(names)} layers)")
    else:
        device = raster_device(cfg)
        edge_paths = [os.path.join(cfg.output_dir, name, "edges.png") for name in names]
        held = device_boards(edge_paths, device)
        if held is None:
            edge_imgs = []
            for p in edge_paths:
                if not os.path.exists(p):
                    raise FileNotFoundError(f"Edges not found: {p}")
                edge_imgs.append(read_image(p, gray=True))
            batch = torch.from_numpy(np.stack(edge_imgs, axis=0)).to(device)
            held = pack_bitboards(batch), batch.shape[-1]
        skel_b = zhang_suen_packed(held[0], max_iter=120, rotated=True)
        skeletons = dense_from_boards(skel_b, held[1], 1).cpu().numpy()
        print(f"[vectorize] thinning (batched, {len(names)} layers): {time.perf_counter() - t0:.2f}s")

    min_len = int(cfg.thinning_min_segment_len)

    # inside a pipeline chain the contours.pkl dumps go write-behind; the
    # runner's finally flushes them before it returns.  A stage run alone
    # writes synchronously.
    from ..pipeline import chain_hint  # noqa: PLC0415

    save = save_pickle_async if chain_hint() else save_pickle

    def trace_one(args):
        name, skel = args
        t1 = time.perf_counter()
        paths = trace_skeleton_fast(skel)  # 0/1 uint8: tracers accept any nonzero
        paths = [p for p in paths if len(p) >= min_len]
        out = os.path.join(layer_dir(cfg, name), "contours.pkl")
        save(paths, out)
        return f"[{name}] traced {len(paths)} polylines in {time.perf_counter() - t1:.2f}s → {out}"

    for line in thread_map(trace_one, list(zip(names, skeletons))):
        print(line)
