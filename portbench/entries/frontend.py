"""The fused raster front-end, ``plotweave_torch.ops.frontend.raster_frontend``:
a batch of BGR images on the card → each layer's edges (0/255) and
skeletons (0/1), as dense bytes on the card.

The mix's ``call_images`` sets the images a call and ``ring_images`` the
distinct images, made from the seed on the card in set-up
(``portbench/images.py``, the mix's ``image`` group); the calls take the
ring's batches in turn.  ``check`` holds every kept call's two outputs to
the reference's (``reference.raster.judge``)."""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

from portbench.images import image
from portbench.reference import raster


def frontend_params(config: dict) -> dict:
    """``raster_frontend``'s keywords for the configuration."""
    for a, b in (("extract_open_iters", "extract_close_iters"), ("edge_morph_open_iters", "edge_morph_close_iters")):
        if config[a] != config[b]:
            raise ValueError(f"raster_frontend takes one count for {a} and {b}")
    return {"k": len(config["centers_lab"]), "extract_iters": config["extract_open_iters"],
            "edge_kernel": config["edge_morph_kernel"], "edge_iters": config["edge_morph_open_iters"],
            "blur_kernel": config["edge_kernel_size"], "low": config["edge_low_threshold"],
            "high": config["edge_high_threshold"], "thin_iters": config["thin_iters"]}


class Entry:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        self.config, self.mix, self.seed, self.device = config, mix, seed, device
        self.h, self.w = int(config["image_height"]), int(config["image_width"])
        self.per_call = int(mix["call_images"])
        self.ring = max(1, int(mix["ring_images"]) // self.per_call)
        self.mpx_per_call = self.per_call * self.h * self.w / 1e6
        self.params = frontend_params(config)
        self.centres = np.asarray(config["centers_lab"], np.float32)

    def setup(self) -> None:
        n = self.ring * self.per_call
        self.images = torch.stack([image(self.seed, i, self.h, self.w, self.mix["image"], self.device)
                                   for i in range(n)])
        self.batches = [self.images[j * self.per_call : (j + 1) * self.per_call] for j in range(self.ring)]
        self.centres_dev = torch.from_numpy(self.centres).to(self.device)

    def call(self, j: int):
        from plotweave_torch.ops.frontend import raster_frontend  # noqa: PLC0415

        return raster_frontend(self.batches[j], self.centres_dev, **self.params)

    def reference(self, j: int, control: bool = False) -> dict:
        """Ring input j by the reference (``raster.frontend``); the control
        computes Lab and its distances in bfloat16."""
        return raster.frontend(self.batches[j], self.centres, **self.params, near_tie=float(self.config["near_tie"]),
                               lab_dtype=torch.bfloat16 if control else torch.float64)

    @staticmethod
    def as_output(ref: dict):
        """The reference's answer in the program's form: (edges 0/255, skeletons 0/1)."""
        return ref["edges"] * 255, ref["skeletons"]

    def judge(self, out, ref: dict) -> dict:
        return raster.judge(out[0], out[1], ref, self.params["thin_iters"])

    def work(self, counts: dict) -> dict:
        p = self.params
        return {"images": self.per_call, "layers": p["k"], "height": self.h, "width": self.w, "ksize": p["blur_kernel"],
                "steps": raster.frontend_steps(p["extract_iters"], p["edge_kernel"], p["edge_iters"]),
                "k2_input": "boards", "k6_store": "dense", **counts}

    def check(self, kept):
        totals = {"edges_off": 0, "skeletons_off": 0}
        wrong, works = 0, []
        for j in range(self.ring):
            ref = self.reference(j)
            works.append(self.work(ref["counts"]))
            for i, out in kept:
                if i % self.ring == j:
                    off = self.judge(out, ref)
                    wrong += any(off.values())
                    for name, v in off.items():
                        totals[name] += v
            del ref
        iters = [n for w in works for n in w["k6_iterations"]]
        print(f"portbench: the reference on the ring's {self.ring * self.per_call} images: K6 iterations a plane "
              f"min {min(iters)}, median {statistics.median(iters)}, max {max(iters)}, mean "
              f"{statistics.mean(iters):.3f}; near-tie pixels {sum(w['near_ties'] for w in works)}", file=sys.stderr)
        return {name: (v, 0) for name, v in totals.items()}, wrong, works
