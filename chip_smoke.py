#!/usr/bin/env python3
"""Smoke test of plotweave_torch on one CUDA card: ``python3 chip_smoke.py``.

Run from the root of a checkout.  It builds the hand-written kernels from the
sources, checks each against its plain PyTorch version on the card, runs the
stage 02→04 chain, the fused raster front-end and the main path, image →
``plot_stream.bin``, on the card and on the CPU, and fails on any mismatch.
Phases:

1. probe: torch / CUDA / card / nvcc / OpenCV / g++;
2. build the kernels with nvcc, one library per source, all at once (K1 the
   layout conversions, K2 packed morphology, K3+K4 blur, Sobel, NMS and
   thresholds, K5 hysteresis and K6 packed Zhang–Suen, K7 Lab + nearest
   centre, K8 k-means, K9 greedy tour, K10 tour refiner, K11 gray
   morphology, K12 dense Zhang–Suen, K13 INTER_AREA resize, K14 Bézier
   sampler), and the port's native host library with g++, which must load;
3. each kernel vs its plain version on the card: K5 and K6 on all three
   routes (resident in a thread block cluster of 16 CTAs; banded, each layer
   cut into three bands by ``band_rows``; multi-launch), each named to the
   wrapper, byte-equal on seeded random boards, at 4 × 1500 × 2000 and on
   ``thinning_cases.npz``, on a 1 × 4400 × 4400 layer (too large for a
   cluster: the banded route by size, K6 one launch, K5 one a round; the
   bands and the clusters that fit on the card printed), and K5 on a
   1500 × 2000 spiral of weak pixels with one strong seed (resident and
   banded) and a 4400 × 4400 one (banded, by size) against OpenCV's
   connected components; K2 byte-equal to its plain version on
   step lists (the front-end's 8 steps, the main path's open+close, mixed
   rect/ellipse/cross at ksize 3/5/7, iterations 0-3, a list long enough
   for two launches) on seeded random boards of odd shapes; K12 against
   ``thinning_cases.npz``, its plain version and K6 on both rings, with
   ``max_iter`` 1, 7, 8, 9, 48, 120, inputs that need more than one launch
   (a filled square, dilated spiral rings), uint8, int32 and (H, W) inputs;
   K7 over all 2^24 BGR colours with the near-tie rule, and its one-hot
   boards byte-equal to the packed one-hot of its own labels (also on ragged
   widths, batches, k = 1 and 8, and an image off a 16-byte boundary); K1's
   conversions (rows ↔ boards, boards → dense uint8 and int32, dense uint8,
   bool and int32 → boards, labels → boards, into a blob at an odd offset)
   on ragged widths (W mod 32 and mod 8 ≠ 0, W < 32, H = 1) and at
   4 × 1500 × 2000; K1 folded into K2 and K6 (``fold_cases``): K2 from packed
   rows and its packed-row store, K6 writing the edges and skeletons as
   packed rows into a blob at an odd offset and as dense bytes, on every
   route, against K1 plus the unfused kernels and the plain composites, on
   ragged widths and groups of images, every byte outside the outputs kept;
   K3+K4 byte-equal to its plain version on seeded gray
   images (rows on and off a word boundary) and on binary boards, on every
   template instance (``ksize`` 1, 3, 5, 7, 9) and on the general path
   (``ksize`` 4, 11, 63 and 301, a ``sigma`` so small that the centre tap is
   256), ``sigma`` > 0, thresholds swapped, above 2041 and 0, shapes
   smaller than the radius, below one tile, of exactly one tile, of rim
   tiles only and of several tiles each way, its blur-only mode, and
   1 × 4400 × 4400 from a board and from a dense image;
4. ``chain_from_clean`` at 4 × 1500 × 2000 on the card vs on the CPU: its
   launches (one each of K2, K3+K4, K5 and K6; no K1), a ``torch.profiler``
   trace of one call whose device kernels must all be the port's own (copies
   and memsets apart), device times (CUDA events) of the chain, of K2 from
   the packed rows, K3+K4 (from the chain's boards and from the same masks
   as a dense image, at blur 5 and 7, a call and the kernel alone), K5 and
   K6 on each route and K6 storing the blob, beside their plain versions on
   the card and the count of device kernels those launch, K1's two boards →
   rows launches at 1 × 4400 × 4400 (the multi-launch route's blob), and
   (``big_cases``) K5 and K6 storing the blob at 1 × 4400 × 4400 on the
   chain's own inputs, by the banded route and the multi-launch route
   named, and the 4400 × 4400 chain's call;
5. ``plotweave_torch.pipeline.main`` steps 1–13 on a seeded synthetic
   2000 × 1500 image and on the four configs of ``tests/golden/e2e``, and
   steps 1–4 on a seeded 4400 × 4400 image (``max_dimension`` 4400, so K5
   and K6 take the banded route), with ``--raster-device auto`` (the
   card) and ``cpu``; every mask.png, edges.png, contours.pkl and
   plot_stream.bin must be byte-equal.  The launch counts are set to 0 just
   before the synthetic image's card run and read just after it (the
   chain's launches exactly: K2, K3+K4 and the resident K5 and K6 once, K1
   never), and likewise around the 4400 × 4400 card run (K6 banded once,
   K5 banded once a round, K1 and the multi-launch kernels never);
6. ``raster_frontend`` on a seeded 2000 × 1500 image, k = 4, through both
   thinning routes on the card and on the CPU: labels by the near-tie rule,
   edges and skeletons byte-equal from the same labels, the launches of each
   route (K7, K2, K3+K4, K5 once each, then K6 storing both dense outputs
   and no K1, or K12 in at most two launches and three K1), a
   ``torch.profiler`` trace of one call per
   route whose device kernels must all be the port's own, with device times
   of each route and of every kernel at the front-end's shapes beside its
   plain version, K2's, K3+K4's, K7's and K12's kernel time alone
   (``torch.profiler``; K2 and K12 also by CUDA events around a loop of bare
   launches) and K2's host time per call;
7. ``plotweave_torch.entry.entry("auto")`` once;
8. the kernels of stage 02's other modes vs their plain versions on the card:
   K8's draw (``pw_subsample``) index for index against the plain version on
   the CPU (the poster's 3,000,000 pixels -> 200,000 on 8 seeds, n = limit +
   1, limit = 1, limit = n - 1, 2 pixels, 4400 x 4400 pixels); K8's sampler
   (``pw_lab_sample``) against K7 over all 2^24 colours (its
   Lab, put through K7's distance rule in plain PyTorch, must give K7's
   labels exactly; within 1e-3 of the plain Lab), a gather by index, and
   indices outside the image on the card refused by ``lab_sample``;
   ``pw_kmeans_fit``'s seeds (the launch with no iteration: the same picked
   rows and centres as the plain version for 16 seeds, k = 1, 2, 4, 8, on the
   poster's sample drawn on the card, on integer rows with duplicates, 777
   rows, 5 rows, an all-coincident sample, 231,697 and 250,000 rows, each on
   the route its size takes (the last two streamed, the others resident),
   and at the edges of u: 0, the least float, 2^-24, 0.999999, the float
   below 1, and 1); ``pw_kmeans_fit``, seeds and fits in one launch, against
   ``kpp_init_plain`` + ``lloyd_fits_plain`` at 200,000 rows (resident) and
   250,000 (streamed), k = 1 and 4 on the poster, k = 8 on eight blobs and on
   four distinct rows (empty clusters), iterations 0, 1 and 40 (picks equal,
   centres within 1e-3, compactness within 1e-5 relative at its own centres,
   iterations and the winning attempt equal, two runs bit-equal);
   ``pw_lloyd_fit`` at 200,000 x 3, 777 x 3 and 250,000 x 3, k = 1,
   4, 8, ``iters`` 1 and 40 and an init that leaves a cluster empty (centres
   within 1e-3, compactness within 1e-5 relative of the plain version's at
   the same centres and within 1e-3 of the plain fit's, iterations equal,
   the choice of the best attempt, twice in a row bit-equal, the one-launch
   loop bit-equal to its own single-iteration launches, and a fit whose
   seeds split a blob held step by step to the plain step); ``pw_assign_points``
   and ``ops.kmeans.kmeans`` card vs CPU; K7's counts equal to a bincount of
   its own labels; K11 byte-equal to its plain version on gray and binary
   images, rect / ellipse / cross, ``ksize`` 1, 2, 3, 5, 7, 31, iterations
   0-3, all four programs, odd shapes, H or W below the radius, a batch,
   lists that take several launches (by the halo cap, by the parameter
   block's room, a rect 31 step alone), widths 1999 and 1011 and a base at
   an odd offset (the byte route), 4 x 1500 x 2000, and the swatch path's
   stacked call of four masks in one launch, beside ``max_pool2d``'s time
   for the rect element and the trace of that call;
9. the device-k-means path: ``pipeline.main`` with ``kmeans_init: "device"``
   on the synthetic 2000 x 1500 poster, steps 1-13, on the card and with
   ``--raster-device cpu``: each mask against the host-exact run's by IoU >=
   0.98 and card against cpu by IoU >= 0.99, edges, contours and stream
   byte-equal where the masks are, the stream decoding either way; the
   stage's launches exactly, and a trace of ``device_init_stage`` whose device
   kernels must all be the port's own;
10. the swatch path: ``extraction_mode: "swatch"`` on the poster with its four
   generating colours, steps 1-13, card == cpu on every artifact, K11
   launched once for all the layers, its trace the port's own;
11. the batch path: ``run_pipeline_batch`` over 8 seeded 2000 x 1500 images and
   2 of another shape, steps 1-4, 4 workers: every mask, edges and contours
   file byte-equal to sequential runs, fewer grouped calls than images, a
   grouped chain call of 8 images row by row equal to the solo calls and to
   the CPU, and its device time beside the sum of the solo calls';
12. stage 07's and stage 12's device kernels vs their plain versions on the
   card: K9 (the greedy tour) byte-equal in order and flips to the port's
   host C++ planner at n = 2 to 65,536 and to its plain version up to 4,500 (both
   routes: one CTA below ``kernels.GREEDY_CLUSTER_MIN_N``, a cluster of 16
   CTAs from there, and the one-CTA route at 4,500 and at its limit
   ``kernels.GREEDY_CTA_MAX_N`` against the cluster route),
   closed-aware on and off, duplicate points and d²(start) == d²(end) ties,
   float coordinates against the host alone, every case twice (the host
   planner runs on four threads beside the card's work); K10 (the
   2-opt / relocate refiner) equal in perm, flips and moves to its plain
   version at n = 3 to 8,192 (``max_moves`` 256 from 2,000 up), one full
   run at 8,192 on a greedy tour (its moves, time and travel), one CTA an
   SM at 8,192 ops, and its microseconds an iteration at 600, 2,000 and
   8,192 ops (CUDA events) beside its bound;
13. the quality path: ``pipeline.main --preset quality`` on a seeded
   2000 x 1500 poster of 2,000 small discs and rings, steps 1-13, on the
   card: K9 launched once per layer over ``planner_device_min_n`` and K10
   once per op list over ``refine_device_min_n``, ``contours_sorted.pkl``
   byte-equal to a ``--raster-device cpu`` run of steps 1-7, each refined
   layer's ``ops.pkl`` equal to the tour of the plain refiner run once on
   the card from the same stage-12 input (the full move budget), and K10
   called alone equal to that run, the same drawn geometry, no longer
   travel in float64, the stream decoding; at the largest gated layer K9
   equal to its plain version and to the host C++ planner, each run once; a
   ``torch.profiler`` trace of each device call, in a fresh process, whose
   kernels are the port's own; K9's and K10's times at the largest gated
   layer beside the plain versions', the host C++ planner's and their
   bounds (K10's also an iteration); the phase's seconds, part by part;
14. vector inputs and resize, its kernels run right after phase 2 (late in
   a long process the profiler there loses a trace's events):
   ``ops.resize_if_needed(img, 2000)`` on a 4032 x 3024 phone photo and a
   4000 x 3000 image (K13's two routes, one launch each, counted), then K13
   byte-equal to its plain versions on the card and to ``cv2.resize(...,
   INTER_AREA)`` on the photo (fractional), 4000 x 3000 (2 x 2), 3000 x 3000
   to 1000 x 1000 (3 x 3), a gray 8000 x 6000 to 100 x 75 (an 80 x 80 box)
   and to 97 x 73 (fractional, over 16 taps) and ten seeded random sizes and
   channel counts, with both routes' times beside their plain versions',
   ``interpolate(mode="area")`` and their bounds, and K14 in one launch over
   60,000 seeded cubics at 128 samples against its plain version and
   ``torch.einsum``; after phase 13, ``svg2stream`` (``python -m
   plotweave_torch.frontends.svg2stream``'s ``main``) on a seeded A3 traced
   poster (1,500 paths of 40 C/S/Q/T/A/L segments, absolute and relative,
   and 500 circles, ellipses and rects) with ``--sampling-backend torch``
   (K14, one launch a curve family, counted) and ``numpy``: the same path
   count, polylines within rtol 1e-4 / atol 1e-3 of numpy float64, the
   stream decoding to EOF on the canvas, K14 within 1e-5 of the largest
   |coordinate| of its plain version on every family, the seconds of the
   parse, the sampling, the copy back, the G-code and the stream;
   ``gcode_to_stream`` on the G-code goldens; and the main path on the card
   with ``--shard-rows 4`` (one card: the unsharded chain), its
   ``plot_stream.bin`` byte-equal to phase 5's.
15. the JAX package's meshes, after phase 14: ``frontend_batch`` over a data
   mesh that names the card twice on four seeded 2000 x 1500 posters, k = 4,
   both thinning routes, byte-equal to one ``raster_frontend`` call over the
   batch, its launches those of one call a shard (K7, K2, K3+K4, K5 and K6 or
   K12 once a shard), a ``torch.profiler`` trace of one call whose device
   kernels are the port's own (the gather is copies); ``run_pipeline_batch``
   over four of phase 11's images, steps 1-4, ``devices=[cuda:0, cuda:0]``,
   every artifact byte-equal to phase 11's sequential runs and its "[batch]
   mesh data-parallelism over 2 device(s)" line; ``sharded_chain`` over a
   4-shard CPU space mesh on the chain's 4 x 1500 x 2000 masks, byte-equal to
   the card's ``chain_from_clean`` blob, its host seconds beside the CPU's
   model name and the card chain's ms; the main path with ``--raster-device
   cpu --shard-rows 4`` in a process whose ``XLA_FLAGS`` sets 4 CPU devices,
   row-sharded over 4 and ``plot_stream.bin`` byte-equal to phase 5's card
   run.
16. the ``space`` axis on the card (``phase_space_mesh``): each slab mode
   (K3+K4 from boards and dense images, blur-only too; K5; K6 storing packed
   rows and dense bytes at a row) against its plain slab version on the same
   buffers at 2 x 256 x 1000, every slab position (top, middle, bottom,
   alone), a weak edge crossing all four slabs (at least 5 hysteresis
   rounds), a thick disc thinned in rounds, also capped mid-round, and
   K11's gray programs over four slabs against the unsharded K11;
   ``sharded_chain`` over ``[cuda:0] * 4`` and over the 6 shards that 8 fit
   to at 4 x 1500 x 2000, byte-equal to the card's ``chain_from_clean``,
   K2 and K3+K4 launched once a shard and K5 and K6 once a shard a round,
   a trace of the port's own kernels, its ms beside the unsharded chain's;
   over ``[cuda:0] * 4`` on a 4400 x 4400 layer (every slab one band,
   where the layer takes the banded route), byte-equal to the unsharded
   chain; over ``[cuda:0] * 2`` on a 4400 x 8800 layer whose slabs hold
   more rows than one cluster (each slab mode runs its slab as bands:
   until the banded route such a slab raised), byte-equal to the unsharded
   chain; ``spatial_frontend`` over ``[cuda:0]
   * 4`` and ``grid_frontend`` data 2 x space 2 on phase 6's posters,
   byte-equal to ``raster_frontend``; ``dryrun_multichip(4, [cuda:0] * 4)``.

The line before the last is ``{"kernels": [...]}``, with each kernel's
launches in the one run of phase 5 or 6 that drives it (the synthetic
2000 × 1500 image for K2, K3+K4 and the resident K5 and K6, the
4400 × 4400 image for the banded K5 and K6 (and for the rows of kernels
that no main path launches any more, which must show 0 there: the
multi-launch K5 and K6 and K1's boards → rows), the
front-end calls for K7, K12 and K1's dense side, the device-k-means run for K8 and K7's counts,
the tools' k-means call for K8's assignment, the swatch run for K11, the
quality run for K9 and K10, phase 14's resize path for K13 and its poster
run for K14), its
device time, its plain version's, and its bound: the larger of its bytes (each input read once, each output written
once) at 3.35 TB/s and its operations, counted for these inputs, at the
card's rate for their type.  The last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA card, or without the repo beside it, it exits
non-zero and prints no result.

Measurements stand beside the phases and are not part of the smoke:
``phase_k34_times()`` (K3+K4's times alone; with ``ROOT`` set to an older
checkout before ``phase_probe`` it times that tree), ``phase_k34_sweep()``
(K3+K4's tile rows and minimum blocks per SM), ``phase_k10_ab(other)`` and
``phase_k10_phases()`` (K10 against another checkout's, in turns, and its
clock64 cycles by phase), ``phase_k9_phases()`` and ``phase_k9_ab(other)``
(the same for K9, with its chain floor: run the phases first),
``phase_k1_fold_ab(other)`` (the chain, K2 and K6 alone, the grouped call
of 8 and the front-end against another checkout's, in turns),
``phase_kmeans_ab(other)`` and ``phase_k8_phases()`` (K8's seeds and fits
and stage 02's device mode against another checkout's, in turns, and the
launch's clock64 cycles by phase), ``phase_banded_ab(other)`` (K5, K6
storing the blob and the chain at 1 × 4400 × 4400 against another
checkout's, in turns: the banded route against the parent's multi-launch
route and K1).  Each phase's wall seconds
are printed before the ``kernels`` line.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
E2E_CONFIGS = ["base_cfg.json", "base_cfg2.json", "cfg3_8layers.json", "cfg4_gray1layer.json"]
E2E_REFS = ["ref_artifacts.tar.gz", "ref_artifacts2.tar.gz", "ref_artifacts3.tar.gz", "ref_artifacts4.tar.gz"]
CHAIN_SHAPE = (4, 1500, 2000)  # layers, H, W: the default max_dimension, 4 layers
EDGE_PARAMS = (3, 1, 1, 5, 22, 70)  # (mk, oi, ci, bk, lo, hi): the default config's
FRONTEND_SHAPE = (1500, 2000)  # H, W: bench.py --frontend's image size
BENCH_CENTERS = [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]]  # bench.py:509-511
NEAR_TIE = 0.01  # a label may differ only where the two nearest centres are this close (float64)
# K2, K3+K4, K5, K6 (resident): every device step of the chain between the upload and the blob
MAIN_PATH_KERNELS = ("morph_bits", "edge_candidates", "hysteresis", "zhang_suen_packed")
# launches of one chain call: K2 loading the packed rows, K3+K4, K5, K6 storing the blob's two halves; no K1
CHAIN_LAUNCHES = {"morph_bits": 1, "edge_candidates": 1, "hysteresis": 1, "zhang_suen_packed": 1}
# the kernels of plotweave_torch/csrc by a part of their names, as a profiler's trace shows them
# PyTorch's kernel of ``copy_`` between strided views on one card: row sharding's halo exchange (``widen``)
COPY_KERNELS = ("direct_copy_kernel",)
OWN_KERNELS = ("rows_to_boards", "boards_to_rows", "boards_to_dense", "dense_to_boards", "labels_to_boards",
               "morph_steps", "edge_tiles", "hysteresis_cluster", "hysteresis_sweep", "zs_cluster", "zs_subpass",
               "assign_nearest", "zs_tiles", "subsample", "lab_sample", "kmeans_fit", "lloyd_fit", "assign_points", "morph_runs",
               "greedy_tour", "refine_tour", "area_frac", "area_int", "bezier_sample")
# stage 03's mask open and close at the default config (ellipse 3, 1 and 1): K2's step list on the main path
MAIN_PATH_STEPS = (("ellipse", 3, "e"), ("ellipse", 3, "d"), ("ellipse", 3, "d"), ("ellipse", 3, "e"))
POSTER_PALETTE = [[30, 25, 20], [70, 90, 190], [140, 175, 220], [225, 220, 215]]  # synthetic_image's four tones, BGR
KMEANS_SAMPLE = 200_000  # the default kmeans_sample_limit
# one run of stage 02 in device mode, fused: K8 three times (the draw, the sampler, the seeds and fits in one
# launch), K7 with counts, K2 for the masks (storing their packed rows too) and for the chain, then the chain's
# K3+K4, K5 and K6 (storing its two halves); no K1
DEVICE_KMEANS_LAUNCHES = {"subsample": 1, "lab_sample": 1, "kmeans_fit": 1, "assign_nearest": 1, "morph_bits": 2,
                          "edge_candidates": 1, "hysteresis": 1, "zhang_suen_packed": 1}
# float operations of K8 per point: per centre and pass 9 (the dot product 5, the expanded distance 3, the
# compare); the seeding per draw 12: the distance 8, the min, the scaling, the cap and the conversion
LLOYD_FLOPS_PER_CENTER, KPP_FLOPS_PER_DRAW, POWF_FLOPS = 9, 12, 40
# K8's draw: integer operations per key, the hash (a multiply-add, two multiplies, three shifts and three XORs) and
# the compare with the threshold; the draw needs each key once (the kernel recomputes it in five passes)
DRAW_OPS_PER_KEY = 10
BANDED_KERNELS = ("hysteresis_banded", "zhang_suen_packed_banded")  # K5, K6 on layers too large for a cluster
MULTI_KERNELS = ("hysteresis_multi", "zhang_suen_packed_multi")  # K5, K6 multi-launch: only where a caller names it
OFF_PATH = ("K1 rows", "K5 multi", "K6 multi")  # rows of the kernels line that no main path launches
BIG_SIDE = 4400  # px: a layer of 4400 rows of 138 words does not fit one cluster's shared memory
PATH_RUNS = {"main": "main path, synthetic 2000x1500, steps 1-13, card run",
             "big": f"main path, synthetic {BIG_SIDE}x{BIG_SIDE}, steps 1-4, card run",
             "front-end": "raster_frontend 2000x1500 k=4, one call on the default route",
             "front-end dense": "raster_frontend 2000x1500 k=4, one call with pallas_thinning=True",
             "device-kmeans": "main path with kmeans_init=device, synthetic 2000x1500, steps 1-13, card run",
             "kmeans-tool": "ops.kmeans.kmeans on the card, 50,000 points, k=4",
             "swatch": "main path with extraction_mode=swatch, synthetic 2000x1500, steps 1-13, card run",
             "quality": "main path with --preset quality, dot-field poster 2000x1500, steps 1-13, card run",
             "resize": "resize_if_needed(img, 2000) on a 4032x3024 and a 4000x3000 image on the card",
             "vector": "svg2stream --sampling-backend torch on the seeded A3 traced poster, card run",
             "sharded": "sharded_chain over [cuda:0] x 4, 4x1500x2000, one call",
             "blur slab": "blur_halo over [cuda:0] x 4, 2x1500x2000 gray, one call"}

# the card's peaks (H100 SXM): HBM bytes/s, float32 outside the tensor cores,
# INT32 lanes (132 SMs x 64 lanes x 1.98 GHz)
HBM_BPS, FP32_OPS, INT32_OPS = 3.35e12, 67e12, 132 * 64 * 1.98e9
# integer operations per 32-pixel word, counted from
# csrc/bitboard_fixpoints.cu with a three-input logic op (LOP3) or a funnel
# shift as one: zs_word per subpass (6 shifts, 16 for the neighbour count,
# 23 for the transitions, 4 for the direction test and the clear); one
# hysteresis update (6 shifts, 3 ORs of three rows, the OR and AND with cand)
ZS_OPS_PER_WORD = 49
HYST_OPS_PER_WORD = 10
# K3+K4, from csrc/edge_candidates.cu: per pixel 2 ksize multiply-adds and 4 operations of rounding and
# clamping for the blur, 12 for Sobel, 3 for the magnitude, 18 for the NMS and thresholds
EDGE_OPS_FIXED = 37
# K7, float operations per pixel from csrc/assign_nearest.cu: the gamma is a 256-entry table, so no powf;
# XYZ 15, 3 divisions by the white point, 3 compares, Lab 9; 9 per centre (3 differences, 3 squares, 2 adds,
# the compare); per XYZ value a cbrtf (20: exponent split, polynomial, two Newton steps) where it exceeds
# (6/29)^3, else a division and an add
K7_FLOPS_FIXED, K7_FLOPS_PER_CENTER, CBRT_FLOPS, LINEAR_FLOPS = 30, 9, 20, 2


def bound(nbytes: float, ops: float, rate: float) -> dict:
    """The least time for the work: the larger of bytes at the HBM rate and
    operations at ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def k11_bound(numel: int, steps) -> dict:
    """K11's bound on ``numel`` pixels: each read once and written once, and
    the separable form's min/max at four bytes a 32-bit INT32 operation.  Per
    step and pixel, a run of L pixels takes min(L - 1, 3) across (direct, or
    van Herk / Gil-Werman's prefix, suffix and join past three), the run's R
    rows min(R - 1, 3) down, and the runs one each to fold: rect 3 2 + 2,
    rect 31 3 + 3."""
    from plotweave_torch.ops import kernels

    per_pixel = 0
    for shape, ksize, _ in steps:
        runs = kernels.element_runs(shape, ksize)[1]
        per_pixel += sum(min(dx1 - dx0, 3) + min(len(dys) - 1, 3) for dx0, dx1, dys in runs) + len(runs) - 1
    return bound(2 * numel, numel * per_pixel / 4, INT32_OPS)


def kmeans_fit_bound(n: int, k: int, attempts: int, passes: int) -> dict:
    """K8's seeds and fits of ``attempts`` attempts on n rows: the sample read
    once (12 bytes a row), the draws, picks, centres, compactness and
    iterations moved once, against the seeding's operations (n a draw and
    attempt) and the fit's (n k a pass, ``passes`` over all attempts) at the
    float32 rate."""
    nbytes = 12 * n + 4 * attempts * k + 16 * attempts * k + 8 * attempts + 12 * k
    return bound(nbytes, (attempts * (k - 1) * KPP_FLOPS_PER_DRAW + passes * k * LLOYD_FLOPS_PER_CENTER) * n, FP32_OPS)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn`` (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


TRACE_CALLS = 3  # calls inside one profiler window: the trace may miss the device work right after it starts
TRACE_PAUSE = 0.02  # seconds between them, so that each call's device events stand apart in time


def traced(fn, calls: int = TRACE_CALLS) -> list:
    """``torch.profiler``'s CUDA activity over ``calls`` calls of ``fn``: one
    list of device kernel events per call the trace caught, in time order
    (the events of a call lie within microseconds, the calls TRACE_PAUSE
    apart).  The trace may miss the device work that runs right after it
    starts, so a 1 MB upload and a pause come first, and only the last list
    is sure to be a whole call.  Copies and memsets are left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    host = torch.zeros(1 << 20, dtype=torch.uint8)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        host.to("cuda")
        for _ in range(calls):
            torch.cuda.synchronize()
            time.sleep(TRACE_PAUSE)
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("Memcpy", "Memset"))), key=lambda e: e.time_range.start)
    groups: list = []
    for e in events:
        if not groups or e.time_range.start - groups[-1][-1].time_range.end > TRACE_PAUSE * 1e6 / 2:
            groups.append([])
        groups[-1].append(e)
    return groups


def device_us(e) -> float:
    return getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)


def profiled_ms(fn, name: str, reps: int):
    """Device milliseconds per call of ``fn`` in the kernels whose name holds
    ``name``, from ``torch.profiler``'s CUDA activity: the mean over the
    whole calls the trace caught (all but the first); None where it caught
    none."""
    try:
        groups = traced(fn, reps + 1)[1:]
    except RuntimeError as e:  # a measurement only: say so and go on
        print(f"  torch.profiler failed: {e}")
        return None
    us = sum(device_us(e) for g in groups for e in g if name in e.name)
    return us / len(groups) / 1e3 if us else None


def profiled_each(fn, names, reps: int):
    """Device milliseconds of each kernel launch of one call of ``fn`` whose
    name holds one of ``names``, in launch order, from ``torch.profiler``:
    the mean over the whole calls the trace caught (all but the first) that
    show the same number of such launches; None where it caught none."""
    try:
        groups = traced(fn, reps + 1)[1:]
    except RuntimeError as e:  # a measurement only: say so and go on
        print(f"  torch.profiler failed: {e}")
        return None
    per = [[device_us(e) for e in g if any(n in e.name for n in names)] for g in groups]
    most = max((len(p) for p in per), default=0)
    per = [p for p in per if len(p) == most and most]
    return [sum(p[i] for p in per) / len(per) / 1e3 for i in range(most)] if per else None


def device_kernels(fn) -> dict:
    """{kernel name: launches} of the device kernels one call of ``fn`` runs
    (the last call of a trace; empty where the trace caught nothing)."""
    counts: dict = {}
    for e in (traced(fn) or [[]])[-1]:
        counts[e.name] = counts.get(e.name, 0) + 1
    return counts


def only_own_kernels(fn, what: str, expect: dict, timed: str = "", calls: int = TRACE_CALLS,
                     copies: bool = False) -> dict:
    """Fail if a trace of ``calls`` calls of ``fn`` shows a device kernel
    that is not one of ``plotweave_torch/csrc``'s (with ``copies``, nor
    PyTorch's ``copy_`` kernel, which moves rows between strided views and
    is counted apart, under "copies"), or if the last call's
    kernels are not ``expect`` ({part of the name: launches}) in any of three
    traces (a trace that lost events is taken again); returns those.  With
    ``timed``, returns {"kernels": those, "alone_ms": the device ms a call of
    the kernels whose name holds ``timed``, over the calls after the first},
    from the same trace (a profiler session fewer than ``profiled_ms``)."""
    for attempt in range(3):
        groups = traced(fn, calls)
        allowed = OWN_KERNELS + (COPY_KERNELS if copies else ())
        foreign = sorted({e.name for g in groups for e in g if not any(own in e.name for own in allowed)})
        check(not foreign, f"{what}: device kernels that are not the port's own: {foreign}")
        short: dict = {}
        n_copies = 0
        for e in (groups or [[]])[-1]:
            own = next((own for own in OWN_KERNELS if own in e.name), None)
            if own is None:
                n_copies += 1
            else:
                short[own] = short.get(own, 0) + 1
        if short == expect:
            break
        print(f"  {what}: trace {attempt + 1} shows {short} in its last call, expected {expect}")
    check(short == expect, f"{what}: the trace's last call ran {short}, expected {expect}")
    print(f"{what}: every device kernel in the trace of {len(groups)} calls is the port's own"
          + (" or a copy" if copies else "") + f", and the last call ran {short}"
          + (f" and {n_copies} copy kernels" if copies else "") + " (torch.profiler)")
    if copies:
        short = {**short, "copies": n_copies}
    if not timed:
        return short
    us = sum(device_us(e) for g in groups[1:] for e in g if timed in e.name)
    return {"kernels": short, "alone_ms": us / (len(groups) - 1) / 1e3 if us else None}


def bare_k2(x, valid, steps):
    """One launch of K2's kernel on ``steps`` with nothing of the wrapper's
    host work around it (one segment)."""
    import torch

    from plotweave_torch.ops import kernels

    table, radii = kernels._step_table(steps, x.device)
    (start, stop, band, radius), = kernels.morph_schedule(radii, x.shape[-2], x.shape[-1])
    lib, out = kernels.load("morph_bits"), torch.empty_like(x)
    args = (x.data_ptr(), None, out.data_ptr(), None, valid.data_ptr(), table.data_ptr(), start, stop - start, radius,
            band, *x.shape, 0, torch.cuda.current_stream().cuda_stream)

    def launch(keep=(x, out, valid, table)):  # the tensors live as long as the launches
        check(lib.pw_morph_steps_run(*args) == 0, "K2: a bare launch failed")

    return launch


def bare_k12(planes):
    """The first launch of K12's kernel on uint8 (k, H, W) planes, ZS_CHUNK
    iterations, with nothing of the wrapper's host work around it."""
    import torch

    from plotweave_torch.ops import kernels

    lib, planes = kernels.load("zs_dense"), planes.contiguous()
    out = torch.empty(planes.shape, dtype=torch.int32, device=planes.device)
    flags = torch.zeros(kernels.ZS_CHUNK, dtype=torch.int32, device=planes.device)
    args = (planes.data_ptr(), 0, None, out.data_ptr(), flags.data_ptr(), *planes.shape, kernels.ZS_CHUNK, 1,
            torch.cuda.current_stream().cuda_stream)

    def launch(keep=(planes, out, flags)):  # the tensors live as long as the launches
        check(lib.pw_zs_tiles_run(*args) == 0, "K12: a bare launch failed")

    return launch


def max_abs_err(a, b) -> int:
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max().item()) if a.numel() else 0


def synthetic_image(seed: int, h: int, w: int):
    """A seeded BGR poster: four palette tones over smooth curved regions,
    discs and mild noise (numpy only)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    field = np.zeros((h, w), np.float32)
    for _ in range(6):
        fy, fx = rng.uniform(1.0, 6.0, 2) * 2 * np.pi / np.array([h, w])
        field += np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi)).astype(np.float32)
    for _ in range(40):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(15, 120)
        field[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = rng.uniform(-4, 4)
    bins = np.digitize(field, np.quantile(field, [0.25, 0.5, 0.75]))
    palette = np.array(POSTER_PALETTE, np.int16)
    img = palette[bins] + rng.integers(-6, 7, (h, w, 3), dtype=np.int16)
    return np.clip(img, 0, 255).astype(np.uint8), bins


_BIG_BINS: list = []


def big_bins():
    """The tone bins of the seeded 4400 x 4400 poster of phases 4 and 16,
    made once (several seconds of host time)."""
    if not _BIG_BINS:
        _BIG_BINS.append(synthetic_image(7, BIG_SIDE, BIG_SIDE)[1])
    return _BIG_BINS[0]


def random_boards(rng, k: int, h: int, w: int):
    """Seeded (k, h, w) binary images: blobs and strokes thick enough to thin."""
    import numpy as np

    x = rng.random((k, h + 4, w + 4)) < rng.uniform(0.3, 0.6)
    # a 3×3 majority vote grows the noise into connected blobs
    s = sum(np.roll(np.roll(x, dy, 1), dx, 2) for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    return (s[:, 2 : h + 2, 2 : w + 2] >= 5).astype(np.uint8) * 255


def near_tie_flips(img, centers, got, ref, what: str) -> int:
    """Count the labels that differ; fail unless each is a near tie (the
    float64 distances of its two nearest centres differ by <= NEAR_TIE)."""
    from plotweave_torch.ops.frontend import nearest_gaps

    diff = (got.cpu() != ref.cpu()).numpy()
    if not diff.any():
        return 0
    gap = float(nearest_gaps(img.cpu().numpy()[diff], centers).max())
    check(gap <= NEAR_TIE, f"{what}: {int(diff.sum())} labels differ, largest float64 gap {gap} > {NEAR_TIE}")
    print(f"  {what}: {int(diff.sum())} near-tie flips, largest float64 gap {gap:.6f}")
    return int(diff.sum())


def phase_probe() -> dict:
    import torch

    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    if not (ROOT / "plotweave_torch").is_dir():
        fail(f"run from the root of a plotweave checkout (no plotweave_torch beside {__file__})")
    sys.path.insert(0, str(ROOT))
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"device: {name}  count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi}")
    from plotweave_torch.ops.kernels import _nvcc

    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import cv2

        print("cv2:", cv2.__version__)
    except ImportError:
        fail("OpenCV (cv2) is missing: the host stages of the main path need it")
    print("g++:", shutil.which("g++") or "absent")
    return {"name": name, "smi": smi}


def phase_build() -> None:
    from plotweave_torch.native.loader import get_lib, library_path
    from plotweave_torch.ops import kernels

    t0 = time.perf_counter()
    paths = kernels.build()
    for name in paths:
        kernels.load(name)
    print(f"built {len(paths)} libraries in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(str(p.relative_to(ROOT)) for p in paths.values()))
    for name, log in kernels.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}:", line.strip())
    # the port's native host library (g++), built here so that no timed stage pays for it
    t0 = time.perf_counter()
    check(get_lib() is not None, "the port's native host library did not build or load")
    print(f"native host library: {library_path().relative_to(ROOT)} loaded in {time.perf_counter() - t0:.1f} s")


ROUTES = {"resident": "resident", "banded": "banded", "multi-launch": "multi"}  # name → K5's and K6's ``route``
FORCED_BANDS = 3  # where a check names the banded route on a layer that fits one cluster: ⌈h / 3⌉ own rows a band


def route_args(name: str, h: int) -> dict:
    """The keywords of K5's and K6's wrappers for the route ``name`` on a
    layer of ``h`` rows: the banded route cut into FORCED_BANDS bands."""
    route = ROUTES[name]
    return {"route": route, "band_rows": -(-h // FORCED_BANDS)} if route == "banded" else {"route": route}


FIXPOINT_KERNELS = ("hysteresis", "zhang_suen_packed") + BANDED_KERNELS + MULTI_KERNELS  # K5 and K6 on every route


def launched(before: dict, after: dict) -> set:
    """The routes of K5 and K6 launched between two readings of the counts."""
    return {n for n in FIXPOINT_KERNELS if after[n] > before[n]}


def spiral(h: int, w: int, step: int = 4):
    """A rectangular spiral of 1-px lines ``step`` px apart, from (0, 0)
    inwards, cut once half way in: (uint8 0/1 image, number of rings)."""
    import numpy as np

    img = np.zeros((h, w), np.uint8)
    t, l, b, r, start, rings = 0, 0, h - 1, w - 1, 0, 0
    while t <= b and l <= r:
        img[t, start : r + 1] = 1
        img[t : b + 1, r] = 1
        img[b, l : r + 1] = 1
        img[t + step : b + 1, l] = 1
        start, rings = l, rings + 1
        t, l, b, r = t + step, l + step, b - step, r - step
    cut = (rings // 2) * step  # the top row of the middle ring
    img[cut, cut + step : w - cut - step] = 0
    return img, rings


def phase_kernels_vs_plain(stats: dict) -> None:
    import cv2
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.canny import canny_candidates, hysteresis_plain
    from plotweave_torch.ops.kernels import hysteresis_cuda, zhang_suen_packed_cuda
    from plotweave_torch.ops.thinning import pack_bitboards, unpack_bitboards, zhang_suen_packed_plain

    dev = torch.device("cuda")
    z = np.load(GOLDEN / "thinning_cases.npz")
    n_cases = len([f for f in z.files if f.startswith("edges_")])
    shapes = [(1, 1, 40), (1, 37, 33), (2, 64, 31), (3, 100, 95), (5, 50, 257), (8, 73, 130), (4, 200, 1),
              (6, 20, 3000)]
    runs = ((True, 120), (False, 48), (True, 2), (True, 3), (False, 11))  # 2, 3, 11 stop at max_iter
    expect = {"resident": {"zhang_suen_packed", "hysteresis"}, "banded": set(BANDED_KERNELS),
              "multi-launch": set(MULTI_KERNELS)}
    for name in ROUTES:
        rng = np.random.default_rng(7)
        before = dict(kernels.LAUNCHES)
        for t in range(n_cases):
            edges = torch.from_numpy(z[f"edges_{t}"]).to(dev)
            for key, rotated, it in ((f"skel04_{t}", True, 120), (f"skel08_{t}", False, 48)):
                got = zhang_suen_packed_cuda(pack_bitboards(edges), it, rotated, **route_args(name, edges.shape[-2]))
                got = unpack_bitboards(got, edges.shape[-1])
                check(np.array_equal(got.cpu().numpy(), z[key].astype(np.int32)), f"K6 {name} vs golden {key}")
        for k, h, w in shapes + [CHAIN_SHAPE]:
            x = torch.from_numpy(random_boards(rng, k, h, w)).to(dev)
            b = pack_bitboards(x)
            for rotated, it in runs:
                ref = zhang_suen_packed_plain(b, it, rotated)
                check(torch.equal(zhang_suen_packed_cuda(b, it, rotated, **route_args(name, h)), ref),
                      f"K6 {name} {k}x{h}x{w} rot={rotated} it={it}")
            cand, strong = canny_candidates(x, 20, 60)
            check(torch.equal(hysteresis_cuda(cand, strong, **route_args(name, h)), hysteresis_plain(cand, strong)),
                  f"K5 {name} {k}x{h}x{w}")
            # strong outside cand: the first sweep drops it
            strong2 = pack_bitboards(torch.from_numpy(rng.random((k, h, w)) < 0.01).to(dev))
            check(torch.equal(hysteresis_cuda(cand, strong2, **route_args(name, h)), hysteresis_plain(cand, strong2)),
                  f"K5 {name} {k}x{h}x{w}, strong not in cand")
        # long weak chains: full columns of cand, one strong pixel
        cand = torch.full((2, 300, 4), -1, dtype=torch.int32, device=dev)
        strong = torch.zeros_like(cand)
        strong[0, 0, 0] = 1
        check(torch.equal(hysteresis_cuda(cand, strong, **route_args(name, 300)), hysteresis_plain(cand, strong)),
              f"K5 {name} long chain")
        got = launched(before, kernels.LAUNCHES)
        check(got == expect[name], f"{name}: launched {sorted(got)}, expected {sorted(expect[name])}")
        print(f"K6 and K5 {name} == plain: thinning_cases.npz ({n_cases} x 2 rings), {len(shapes)} random shapes and "
              f"{'x'.join(map(str, CHAIN_SHAPE))} x {len(runs)} (ring, max_iter), K5 with strong outside cand and a "
              f"300-row chain" + (f"; each layer in {FORCED_BANDS} bands (band_rows)" if name == "banded" else ""))

    # a layer larger than one cluster holds takes the banded route by size: K6 one launch, K5 one a round
    rng = np.random.default_rng(8)
    x = torch.from_numpy(random_boards(rng, 1, BIG_SIDE, BIG_SIDE)).to(dev)
    b = pack_bitboards(x)
    nw = b.shape[-1]
    check(kernels.fixpoint_route("zhang_suen_packed", BIG_SIDE, nw) == "banded"
          and kernels.fixpoint_route("hysteresis", BIG_SIDE, nw) == "banded", "the big layer fits a cluster")
    before = dict(kernels.LAUNCHES)
    check(torch.equal(zhang_suen_packed_cuda(b, 120, True), zhang_suen_packed_plain(b, 120, True)),
          f"K6 1x{BIG_SIDE}x{BIG_SIDE}")
    k6_rounds, k6_iters = kernels.STATS["zhang_suen_packed_banded"]
    cand, strong = canny_candidates(x, 20, 60)
    check(torch.equal(hysteresis_cuda(cand, strong), hysteresis_plain(cand, strong)), f"K5 1x{BIG_SIDE}x{BIG_SIDE}")
    k5_rounds = kernels.STATS["hysteresis_banded"][0]
    n = {name: kernels.LAUNCHES[name] - before[name] for name in FIXPOINT_KERNELS}
    check(n == {**dict.fromkeys(FIXPOINT_KERNELS, 0), "zhang_suen_packed_banded": k6_rounds,
                "hysteresis_banded": k5_rounds} and k6_rounds == 1, f"1x{BIG_SIDE}x{BIG_SIDE}: launched {n}")
    sched6, sched5 = (kernels.band_schedule(name, BIG_SIDE, nw, 120) for name in ("zhang_suen_packed", "hysteresis"))
    fit = {name: kernels.cluster_fit(name, max(w1 - w0 for *_, w0, w1 in sc.bands), nw)
           for name, sc in (("zhang_suen_packed", sched6), ("hysteresis", sched5))}
    stats["bands"] = {"K6": [list(b) for b in sched6.bands], "K6 m": sched6.m, "K5": [list(b) for b in sched5.bands],
                      "clusters that fit": fit}
    print(f"K6 and K5 at 1x{BIG_SIDE}x{BIG_SIDE} == plain, by the banded route: K6 {len(sched6.bands)} bands "
          f"{sched6.bands}, m {sched6.m}, {k6_rounds} round, {k6_iters.tolist()} iterations; K5 {len(sched5.bands)} "
          f"bands, {k5_rounds} rounds (one launch and one flag read each); clusters that fit on the card at once "
          f"(cudaOccupancyMaxActiveClusters) {fit}; launches {({k: v for k, v in n.items() if v})}")

    # a full-size long weak chain: a spiral of cand with one strong seed at its outer end, on the resident and
    # banded routes (the multi-launch route's sweeps took 2 s here), and at 4400 x 4400 on the banded route
    out = {}
    for (h, w), names in ((FRONTEND_SHAPE, ("resident", "banded")), ((BIG_SIDE, BIG_SIDE), ("banded",))):
        img, rings = spiral(h, w)
        _, labels = cv2.connectedComponents(img, connectivity=8)
        expected = (labels == labels[0, 0]).astype(np.uint8)
        cand = pack_bitboards(torch.from_numpy(img[None]).to(dev))
        seed = np.zeros_like(img)
        seed[0, 0] = 1
        strong = pack_bitboards(torch.from_numpy(seed[None]).to(dev))
        ref = pack_bitboards(torch.from_numpy(expected[None]).to(dev))
        for name in names:
            args = route_args(name, h) if h < BIG_SIDE else {}  # 4400 rows: banded by size
            before = dict(kernels.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = hysteresis_cuda(cand, strong, **args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(torch.equal(got, ref), f"K5 {name} {h}x{w}: spiral != OpenCV's connected component of the seed")
            n = sum(kernels.LAUNCHES[k] - before[k] for k in ("hysteresis", "hysteresis_banded"))
            if name == "banded":
                rounds, st = kernels.STATS["hysteresis_banded"]
                sweeps = int(st[0, 1])
                check(n == rounds, f"K5 banded {h}x{w}: {n} launches in {rounds} rounds")
            else:
                rounds, sweeps = kernels.STATS["hysteresis"][0].tolist()
            out[f"{name} {h}x{w}"] = {"ms": cuda_ms(lambda: hysteresis_cuda(cand, strong, **args), 1) if n < 50
                                      else wall * 1e3, "launches": n, "rounds": rounds, "sweeps": sweeps}
        print(f"K5 spiral {h}x{w} ({rings} rings, {int(img.sum())} weak px, {int(expected.sum())} reached from the "
              f"seed) == OpenCV's connected component on the " + " and ".join(names) + " routes: " + "; ".join(
                  f"{key} {o['ms']:.3f} ms, {o['launches']} launches, {o['rounds']} "
                  + ("host rounds, most sweeps of a CTA in the last" if key.startswith("banded")
                     else "rounds, most sweeps of a CTA") + f" {o['sweeps']}"
                  for key, o in out.items() if key.endswith(f"{h}x{w}")))
    stats["K5 spiral"] = out


def phase_new_kernels_vs_plain(stats: dict) -> None:
    """K2, K12 and K7 against their plain versions on the card."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.frontend import assign_nearest_plain, frontend_steps, onehot_boards_plain
    from plotweave_torch.ops.kernels import (
        assign_boards_cuda, assign_nearest_cuda, morph_steps_cuda, zhang_suen_dense_cuda, zhang_suen_packed_cuda)
    from plotweave_torch.ops.morphology import (
        _valid_bits, morph_bits, morph_bits_plain, morph_program, morph_steps_plain)
    from plotweave_torch.ops.thinning import pack_bitboards, unpack_bitboards, zhang_suen_dense_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    shapes = [(1, 1, 40), (1, 37, 33), (2, 64, 31), (3, 100, 95), (5, 50, 257), (8, 73, 130)]
    # K2 on step lists; W = 1, 31, 32, 33 and 2000 (nw = 1 for the first three), H not a multiple of the band
    lists = {"front-end": frontend_steps(), "main path": MAIN_PATH_STEPS}
    for it in range(4):
        lists[f"rect 3 ed x{it}"] = morph_program("rect", 3, it, "ed")
    for i, shape in enumerate(("rect", "ellipse", "cross")):
        for j, ksize in enumerate((3, 5, 7)):
            lists[f"{shape} {ksize} x{1 + (i + j) % 3}"] = (morph_program(shape, ksize, 1 + (i + j) % 3, "ed")
                                                           + morph_program(shape, ksize, 1, "de"))
    elements = [(shape, ksize) for shape in ("rect", "ellipse", "cross") for ksize in (3, 5, 7)]
    for i in range(3):
        picks = rng.choice(len(elements), 6)
        lists[f"mixed {i}"] = tuple((*elements[p], "ed"[int(rng.integers(2))]) for p in picks)
    k2_shapes = shapes + [(1, 45, 1), (2, 33, 32), (1, 97, 2000), (4, 70, 63), (3, 129, 2000)]
    n = 0
    for k, h, w in k2_shapes:
        for dense in (False, True):
            if dense:  # uniformly random words, the padding bits beyond W included
                b = torch.from_numpy(rng.integers(0, 2**32, (k, h, -(-w // 32)), dtype=np.uint64)
                                     .astype(np.uint32).view(np.int32)).to(dev)
            else:
                b = pack_bitboards(torch.from_numpy(random_boards(rng, k, h, w)).to(dev))
            valid = _valid_bits(w, dev)
            for name, steps in lists.items():
                n += 1
                got = morph_steps_cuda(b, valid, steps)
                check(torch.equal(got, morph_steps_plain(b, valid, steps)), f"K2 {k}x{h}x{w} {name}: {steps}")
                check((got is b) == (not steps), f"K2 {name}: an empty list returns its input, else a new board")
            for shape, ksize, program, it in (("rect", 3, "ed", 1), ("ellipse", 5, "de", 2), ("cross", 7, "e", 3)):
                check(torch.equal(morph_bits(b, valid, shape, ksize, it, program),  # K2 on a CUDA board
                                  morph_bits_plain(b, valid, shape, ksize, it, program)),
                      f"K2 {k}x{h}x{w} morph_bits {shape} {ksize} {program}x{it}")
    # a list whose halo does not fit one block: two launches
    steps = morph_program("cross", 63, 4, "ed")
    b = pack_bitboards(torch.from_numpy(random_boards(rng, 1, 100, 2000)).to(dev))
    valid = _valid_bits(2000, dev)
    segments = kernels.morph_schedule(kernels._step_table(steps, dev)[1], 100, b.shape[-1])
    before = kernels.LAUNCHES["morph_bits"]
    got = morph_steps_cuda(b, valid, steps)
    check(len(segments) == 2 and kernels.LAUNCHES["morph_bits"] - before == 2,
          f"K2: 8 radius-31 steps at 2000 px: segments {segments}, launches {kernels.LAUNCHES['morph_bits'] - before}")
    check(torch.equal(got, morph_steps_plain(b, valid, steps)), "K2: 8 radius-31 steps at 2000 px (two launches)")
    print(f"K2 == plain: {len(lists)} step lists x {len(k2_shapes)} shapes x 2 boards ({n} lists; front-end, main "
          f"path, rect/ellipse/cross at ksize 3/5/7, iterations 0-3, mixed), morph_bits programs, and 8 radius-31 "
          f"steps in two launches {segments}")

    z = np.load(GOLDEN / "thinning_cases.npz")
    n_cases = len([f for f in z.files if f.startswith("edges_")])
    for t in range(n_cases):
        edges = torch.from_numpy(z[f"edges_{t}"]).to(dev)
        for key, rotated, it in ((f"skel04_{t}", True, 120), (f"skel08_{t}", False, 48)):
            got = zhang_suen_dense_cuda(edges, it, rotated)
            check(np.array_equal(got.cpu().numpy(), z[key].astype(np.int32)), f"K12 vs golden {key}")
            k6 = unpack_bitboards(zhang_suen_packed_cuda(pack_bitboards(edges), it, rotated), edges.shape[-1])
            check(torch.equal(got, k6), f"K12 != K6 on golden {key}")
    print(f"K12 == thinning_cases.npz == unpack(K6): {n_cases} cases x 2 rings")
    # inputs that need more than one launch: a filled square, spiral rings dilated to 5 px
    square = np.zeros((230, 261), np.uint8)
    square[13:213, 30:230] = 255
    rings = torch.nn.functional.max_pool2d(torch.from_numpy(spiral(190, 301, step=9)[0][None].astype(np.float32)),
                                           5, 1, 2)[0].to(torch.uint8).numpy()
    inputs = [(f"random {k}x{h}x{w}", random_boards(rng, k, h, w)) for k, h, w in shapes + [(4, 200, 1), (2, 130, 700)]]
    inputs += [("square 200x200 in 230x261", square[None]), ("dilated spiral 190x301", rings[None] * 7)]
    runs = ((True, 120), (False, 48), (True, 1), (True, 7), (True, 8), (True, 9), (False, 9))
    launches = {}
    for name, x_np in inputs:
        x8 = torch.from_numpy(x_np).to(dev)
        # int32 input: the zeros become -3, which binarises to 0 as well
        for kind, x in (("uint8", x8), ("int32", x8.to(torch.int32) - 3 * (x8 == 0).to(torch.int32))):
            for rotated, it in runs:
                before = kernels.LAUNCHES["zhang_suen_dense"]
                got = zhang_suen_dense_cuda(x, it, rotated)
                launches[(name, rotated, it)] = kernels.LAUNCHES["zhang_suen_dense"] - before
                check(torch.equal(got, zhang_suen_dense_plain(x, it, rotated)),
                      f"K12 {name} {kind} rot={rotated} it={it}")
                if kind == "uint8":
                    k6 = unpack_bitboards(zhang_suen_packed_cuda(pack_bitboards(x), it, rotated), x.shape[-1])
                    check(torch.equal(got, k6), f"K12 != K6 {name} rot={rotated} it={it}")
            check(torch.equal(zhang_suen_dense_cuda(x[0]), zhang_suen_dense_cuda(x)[0]), f"K12 (H, W) input {name}")
    check(all(n == 1 for (_, _, it), n in launches.items() if it <= kernels.ZS_CHUNK),
          f"K12: max_iter <= {kernels.ZS_CHUNK} takes more than one launch: {launches}")
    square_launches = launches[("square 200x200 in 230x261", True, 120)]
    check(square_launches > 1, "K12: the filled square converged in one launch")
    print(f"K12 == plain == unpack(K6): {len(inputs)} inputs (uint8 and int32) x {len(runs)} (ring, max_iter), (H, W) "
          f"inputs; one launch where max_iter <= {kernels.ZS_CHUNK}; the filled square took {square_launches} "
          f"launches at max_iter 120, the dilated spiral {launches[('dilated spiral 190x301', True, 120)]}")

    # every BGR colour once, against the bench's centres
    v = torch.arange(2**24, dtype=torch.int32, device=dev)
    img = torch.stack([v & 255, (v >> 8) & 255, v >> 16], dim=-1).to(torch.uint8).reshape(4096, 4096, 3)
    c = torch.tensor(BENCH_CENTERS, dtype=torch.float32, device=dev)
    got = assign_nearest_cuda(img, c)
    ref = assign_nearest_plain(img, c, 4)
    flips = near_tie_flips(img, BENCH_CENTERS, got, ref, "K7 vs plain, all 2^24 colours")
    check(torch.equal(assign_boards_cuda(img, c), onehot_boards_plain(got, 4)),
          "K7 boards != the one-hot boards of its labels, all 2^24 colours")
    stats["K7"] = {"max_abs_err": flips}
    print(f"K7 == plain up to near ties: {flips} of 16777216 labels flip (near-tie rule {NEAR_TIE}); its boards == "
          f"the one-hot boards of its labels")


def random_words(rng, shape, dev):
    """int32 boards of uniformly random bits, the padding bits beyond W included."""
    import numpy as np
    import torch

    return torch.from_numpy(rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)).to(dev)


def phase_layout_and_edge_kernels(stats: dict) -> None:
    """K1's conversions, K3+K4 and K7's boards against their plain versions
    on the card, on ragged and tiny shapes (byte-equal: all integer)."""
    import numpy as np
    import torch

    from plotweave_torch.ops import bitpack, kernels, thinning
    from plotweave_torch.ops.canny import canny_candidates, canny_candidates_plain, edge_candidates_plain
    from plotweave_torch.ops.filters import gaussian_blur_u8, gaussian_blur_u8_plain
    from plotweave_torch.ops.frontend import assign_nearest_plain, onehot_boards_plain

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    # W mod 32 and mod 8 != 0, W < 32, W < 8, H = 1, whole words, and the main path's width
    shapes = [(1, 1, 40), (2, 5, 13), (3, 17, 31), (1, 4, 64), (2, 9, 33), (1, 7, 7), (2, 3, 100), (1, 1, 1),
              (3, 2, 257), (2, 3, 2000), (2, 2, 3, 45), CHAIN_SHAPE]
    for shape in shapes:
        *lead, w = shape
        nw, wb = -(-w // 32), -(-w // 8)
        u8 = torch.from_numpy((rng.random(shape) < 0.5) * rng.integers(1, 256, shape)).to(torch.uint8).to(dev)
        i32 = u8.to(torch.int32) - 7 * (u8 % 3 == 0).to(torch.int32)  # zeros and a third of the rest go <= 0
        for name, dense in (("uint8", u8), ("bool", u8 > 127), ("int32", i32)):
            check(torch.equal(kernels.dense_to_boards_cuda(dense), thinning.pack_bitboards_plain(dense)),
                  f"K1 dense -> boards {name} {shape}")
        boards = random_words(rng, (*lead, nw), dev)  # padding bits set: every conversion must drop them
        rows = torch.from_numpy(rng.integers(0, 256, (*lead, wb), dtype=np.uint8)).to(dev)
        check(torch.equal(kernels.rows_to_boards_cuda(rows, w), bitpack.rows_to_boards_plain(rows, w)),
              f"K1 rows -> boards {shape}")
        ref_rows = bitpack.boards_to_rows_plain(boards, w)
        check(torch.equal(kernels.boards_to_rows_cuda(boards, w), ref_rows), f"K1 boards -> rows {shape}")
        check(np.array_equal(ref_rows.cpu().numpy(),
                             np.packbits(thinning.unpack_bitboards_plain(boards, w).cpu().numpy() > 0, axis=-1)),
              f"plain boards -> rows != np.packbits {shape}")
        # into the second half of a blob that is not 4-byte aligned there, leaving the first half alone
        blob = torch.full((2 * ref_rows.numel() + 3,), 0xAB, dtype=torch.uint8, device=dev)
        half = blob[ref_rows.numel() + 3:]
        kernels.boards_to_rows_cuda(boards, w, out=half)
        check(torch.equal(half, ref_rows.reshape(-1)) and bool((blob[: ref_rows.numel() + 3] == 0xAB).all()),
              f"K1 boards -> rows into a blob {shape}")
        for value, dtype in ((255, torch.uint8), (1, torch.uint8), (1, torch.int32)):
            ref = thinning.unpack_bitboards_plain(boards, w).to(dtype) * value
            check(torch.equal(kernels.boards_to_dense_cuda(boards, w, value, dtype), ref),
                  f"K1 boards -> dense {dtype} x{value} {shape}")
        # the public functions on CUDA tensors
        check(torch.equal(bitpack.bitpack_rows(u8), bitpack.bitpack_rows_plain(u8))
              and torch.equal(bitpack.bitunpack_rows(rows, w), bitpack.bitunpack_rows_plain(rows, w))
              and torch.equal(bitpack.bitpack_rows(u8.reshape(-1, w)[0]),
                              bitpack.bitpack_rows_plain(u8.reshape(-1, w)[0]))
              and torch.equal(thinning.unpack_bitboards(boards, w), thinning.unpack_bitboards_plain(boards, w))
              and torch.equal(thinning.pack_bitboards(u8), thinning.pack_bitboards_plain(u8)),
              f"K1 through bitpack_rows, bitunpack_rows, pack_bitboards, unpack_bitboards {shape}")
        if len(shape) >= 3:
            labels = torch.from_numpy(rng.integers(0, 5, shape).astype(np.int32)).to(dev)
            check(torch.equal(kernels.labels_to_boards_cuda(labels, 4), onehot_boards_plain(labels, 4)),
                  f"K1 labels -> boards {shape}")
    print(f"K1 == plain: rows <-> boards, boards -> dense (uint8 x255, x1, int32), dense (uint8, bool, int32) -> "
          f"boards, labels -> boards, into a blob at an odd offset, {len(shapes)} shapes incl. {CHAIN_SHAPE}")

    # K3+K4: gray images and binary boards on every template instance (ksize 1, 3, 5, 7, 9) and on the
    # general path (even ksize, 11, a sigma so small that the centre tap is 256), one sigma > 0, radii beyond
    # the axis, thresholds swapped, above 2041 and 0; shapes below one tile, of exactly one tile, of rim
    # tiles only (H or W below the halo) and of several tiles each way (interior tiles; 399: rows off the
    # word boundary, so the dense loader moves bytes)
    gray_shapes = [(1, 1, 1), (1, 2, 2), (2, 3, 40), (1, 40, 3), (3, 37, 33), (2, 64, 100), (1, 33, 257),
                   (2, 2, 45, 70), (1, 32, 128), (2, 100, 400), (1, 70, 399), (1, 3, 600), (1, 200, 2)]
    cases = [(ks, 0.0, lo, hi) for ks in (1, 3, 5, 7, 9) for lo, hi in ((22, 70), (70, 22))]
    cases += [(5, 1.4, 22, 70), (7, 0.0, 5, 3000), (3, 0.0, 0, 0), (4, 0.0, 30, 90), (9, 2.0, 2500, 2100),
              (11, 0.0, 22, 70), (5, 0.1, 22, 70)]
    check([kernels.edge_fast(ks, sg) for ks, sg, _, _ in cases[-3:]] == [True, False, False]
          and not kernels.edge_fast(4) and kernels.edge_fast(5, 1.4), "K3+K4: which cases take the general path")
    n = 0
    for shape in gray_shapes:
        *lead, h, w = shape
        # one byte beyond a 16-byte boundary: the dense loader may not move words
        buf = torch.empty(int(np.prod(shape)) + 1, dtype=torch.uint8, device=dev)
        gray = torch.from_numpy(np.clip(random_boards(rng, int(np.prod(lead)), h, w).reshape(shape) // 2 + 40
                                        + rng.integers(-40, 41, shape), 0, 255).astype(np.uint8)).to(dev)
        odd = buf[1:].view(shape).copy_(gray)
        board = random_words(rng, (*lead, h, -(-w // 32)), dev)  # the padding bits must not be read
        for ks, sigma, lo, hi in cases:
            for what, x in (("gray", gray), ("gray off a word boundary", odd), ("board", board)):
                n += 1
                got = kernels.edge_candidates_cuda(x, w, ks, lo, hi, sigma)
                ref = edge_candidates_plain(x, w, ks, lo, hi, sigma)
                check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                      f"K3+K4 {what} {shape} ksize {ks} sigma {sigma} thresholds {lo}, {hi}")
            for what, x in (("", gray), (" off a word boundary", odd)):
                check(torch.equal(gaussian_blur_u8(x, ks, sigma), gaussian_blur_u8_plain(x, ks, sigma)),
                      f"K3+K4 blur only{what} {shape} ksize {ks} sigma {sigma}")
        got, ref = canny_candidates(gray, 30, 90), canny_candidates_plain(gray, 30, 90)
        check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), f"K3+K4 canny_candidates {shape}")
    # radii whose halo takes a smaller tile (and more than 48 KB of shared memory), from bytes and from a board
    for ks, shape in ((63, (1, 100, 300)), (301, (2, 50, 70))):
        gray = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        board = random_words(rng, (*shape[:-1], -(-shape[-1] // 32)), dev)
        for what, x in (("gray", gray), ("board", board)):
            tile = kernels.edge_schedule(ks, shape[0], shape[-2], -(-shape[-1] // 32), what == "board", False)
            got = kernels.edge_candidates_cuda(x, shape[-1], ks, 1, 3)
            ref = edge_candidates_plain(x, shape[-1], ks, 1, 3)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]) and bool(ref[0].any()),
                  f"K3+K4 {what} ksize {ks} {shape}, tile {tile}")
            print(f"K3+K4 ksize {ks} on {shape} from a {what}: tile {tile}, "
                  f"{kernels.edge_smem_bytes(*tile, ks, what == 'board', False)} B of shared memory")
        check(torch.equal(gaussian_blur_u8(gray, ks), gaussian_blur_u8_plain(gray, ks)), f"K3+K4 blur ksize {ks}")
    x = torch.from_numpy(random_boards(rng, 1, BIG_SIDE, BIG_SIDE)).to(dev)
    xb = thinning.pack_bitboards(x)
    for ks in (5, 7):
        ref = edge_candidates_plain(x, BIG_SIDE, ks, 22, 70)
        for what, src in (("board", xb), ("dense image", x)):
            got = kernels.edge_candidates_cuda(src, BIG_SIDE, ks, 22, 70)
            check(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]),
                  f"K3+K4 1x{BIG_SIDE}x{BIG_SIDE} ksize {ks} from a {what}")
    print(f"K3+K4 == plain: {n} (input, ksize, sigma, thresholds) cases on {len(gray_shapes)} shapes from gray "
          f"images (on and off a word boundary) and boards, every template instance and the general path, blur "
          f"only, canny_candidates, ksize 63 and 301, 1x{BIG_SIDE}x{BIG_SIDE} from a board and a dense image")

    # K7's boards: byte-equal to the packed one-hot of its own labels, ragged widths, batches, k = 8,
    # and an image that does not start on a 16-byte boundary
    pens = torch.tensor([[30, 128, 128], [60, 150, 100], [90, 110, 160], [120, 170, 170], [150, 90, 120],
                         [180, 140, 200], [210, 120, 90], [245, 128, 128]], dtype=torch.float32, device=dev)
    bench = torch.tensor(BENCH_CENTERS, dtype=torch.float32, device=dev)
    for shape in ((1, 1, 3), (5, 33, 3), (37, 45, 3), (2, 19, 257, 3), (3, 2, 8, 300, 3), (64, 2000, 3)):
        for c in (bench, pens, bench[:1]):
            buf = torch.from_numpy(rng.integers(0, 256, int(np.prod(shape)) + 5, dtype=np.uint8)).to(dev)
            for off in (0, 5):
                img = buf[off : off + int(np.prod(shape))].view(shape)
                labels = kernels.assign_nearest_cuda(img, c)
                check(torch.equal(kernels.assign_boards_cuda(img, c), onehot_boards_plain(labels, len(c))),
                      f"K7 boards != the one-hot boards of its labels, {shape} k={len(c)} offset {off}")
                check(torch.equal(labels, kernels.assign_nearest_cuda(img.clone(), c)),
                      f"K7 labels depend on the image's alignment, {shape} k={len(c)} offset {off}")
                near_tie_flips(img.reshape(-1, 3), c.cpu().numpy(), labels.reshape(-1),
                               assign_nearest_plain(img, c, len(c)).reshape(-1), f"K7 {shape} k={len(c)}")
    print("K7 boards == one-hot boards of K7's labels: 6 shapes x k = 4, 8, 1, aligned and 5 bytes off")
    fold_cases()


# (images, layers an image, H, W) of the fold's checks: ragged widths (W mod 32 and mod 8 != 0, W < 8), groups of
# images, rows fewer than K6's 16 CTAs, and the main path's width
FOLD_SHAPES = [(1, 1, 1, 1), (1, 2, 5, 7), (3, 4, 11, 8), (1, 3, 17, 31), (2, 1, 40, 32), (3, 4, 33, 33),
               (1, 4, 64, 250), (2, 4, 100, 2000), (8, 4, 45, 2000)]


def fold_cases() -> int:
    """K1 folded into K2's load and store and K6's stores, against K1 plus
    the unfused kernels and against the plain composites on the card, on
    :data:`FOLD_SHAPES`: K2 from packed rows (step lists of 0, 4 and 8
    steps), its packed-row store from rows and from boards, into a buffer of
    sentinels at an odd offset; K6 writing the edges and the skeletons as
    packed rows into a blob at an odd offset (max_iter 120, 1 and 0) and as
    dense bytes (aligned, and one byte off so that the byte stores run), on
    the resident route, the banded route (each layer in FORCED_BANDS bands,
    each band storing its own rows) and by the multi-launch route with K1.
    Every byte outside the outputs must keep its sentinel.  Returns the cases held."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels, morphology, thinning
    from plotweave_torch.ops.frontend import frontend_steps

    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    n = 0

    def sentinel_buf(numel: int, offset: int):
        """A buffer of sentinels and the contiguous ``numel`` bytes at ``offset`` in it."""
        buf = torch.full((offset + numel + 7,), 0xAB, dtype=torch.uint8, device=dev)
        return buf, buf[offset : offset + numel]

    def untouched(buf, offset: int, numel: int) -> bool:
        return bool((buf[:offset] == 0xAB).all() and (buf[offset + numel :] == 0xAB).all())

    for b, k, h, w in FOLD_SHAPES:
        shape = (b, k, h, -(-w // 8))
        rows = torch.from_numpy(np.packbits(random_boards(rng, b * k, h, w).reshape(b, k, h, w) > 0, axis=-1)).to(dev)
        rows[..., -1] |= (1 << (-w % 8)) - 1  # padding bits set: the load drops them
        valid = morphology._valid_bits(w, dev)
        for steps in ((), MAIN_PATH_STEPS, frontend_steps()):
            n += 1
            buf, out = sentinel_buf(rows.numel(), 3)
            got = kernels.morph_steps_cuda(rows, valid, steps, w, out.view(shape))
            base = kernels.rows_to_boards_cuda(rows, w)
            ref = kernels.morph_steps_cuda(base, valid, steps) if steps else base
            check(torch.equal(got, ref) and torch.equal(got, morphology.morph_steps_plain(rows, valid, steps, w)),
                  f"K2 from packed rows {shape} {len(steps)} steps != K1 then K2, or != plain")
            check(torch.equal(out.view(shape), kernels.boards_to_rows_cuda(ref, w)) and untouched(buf, 3, out.numel()),
                  f"K2's packed-row store {shape} {len(steps)} steps != K2 then K1, or wrote outside its rows")
            buf2, out2 = sentinel_buf(rows.numel(), 5)
            got2 = kernels.morph_steps_cuda(base, valid, steps, w, out2.view(shape))  # boards in, rows out
            check(torch.equal(got2, ref) and torch.equal(out2, out) and untouched(buf2, 5, out2.numel()),
                  f"K2 boards in, packed rows out {shape} {len(steps)} steps")
        edges = thinning.pack_bitboards(torch.from_numpy(random_boards(rng, b * k, h, w)).to(dev))
        for name in ROUTES:
            route, band_rows = route_args(name, h)["route"], route_args(name, h).get("band_rows")
            for max_iter in ((120, 1, 0) if route != "multi" else (120,)):
                n += 1
                skel = (kernels.zhang_suen_packed_cuda(edges, max_iter, True, route=route) if max_iter else edges)
                buf, blob = sentinel_buf(2 * rows.numel(), 3)
                halves = blob.view(b, 2, k, h, -1)
                kernels.zhang_suen_into_cuda(edges, w, halves[:, 0], halves[:, 1], "rows", max_iter, True, route,
                                             band_rows)
                ref_e = kernels.boards_to_rows_cuda(edges, w).view(shape)
                ref_s = kernels.boards_to_rows_cuda(skel, w).view(shape)
                plain = torch.empty_like(halves)
                thinning.zhang_suen_into_plain(edges, w, plain[:, 0], plain[:, 1], "rows", max_iter, True)
                check(torch.equal(halves[:, 0], ref_e) and torch.equal(halves[:, 1], ref_s) and torch.equal(halves, plain)
                      and untouched(buf, 3, blob.numel()),
                      f"K6 into a blob {shape} {route} max_iter {max_iter} != K6 then K1, or != plain, or wrote outside")
                for offset in (0, 1):  # a 16-byte aligned output, and one byte off it (byte stores)
                    dense = b * k * h * w
                    buf_e, out_e = sentinel_buf(dense, 16 + offset)
                    buf_s, out_s = sentinel_buf(dense, 16 + offset)
                    kernels.zhang_suen_into_cuda(edges, w, out_e.view(-1, 1, h, w), out_s.view(-1, 1, h, w), "dense",
                                                 max_iter, True, route, band_rows)
                    check(torch.equal(out_e.view(-1, h, w), kernels.boards_to_dense_cuda(edges, w, 255))
                          and torch.equal(out_s.view(-1, h, w), kernels.boards_to_dense_cuda(skel, w, 1))
                          and untouched(buf_e, 16 + offset, dense) and untouched(buf_s, 16 + offset, dense),
                          f"K6 dense {shape} {route} max_iter {max_iter} offset {offset} != K6 then K1, or wrote outside")
    print(f"K1 fold == K1 plus the unfused kernels == plain: {n} cases on {len(FOLD_SHAPES)} shapes (K2 from packed "
          f"rows with 0, 4 and 8 steps and its packed-row store; K6 into a blob at an odd offset, max_iter 120, 1, 0, "
          f"and dense, aligned and one byte off, on every route); no byte outside the outputs written")
    return n


def k34_times(m, w: int) -> dict:
    """K3+K4 at the main path's shape from the chain's mask boards ``m`` and
    from the same masks as a dense image, at the chain's blur (ksize 5) and
    the front-end's (7): {(input, ksize): (ms a call by CUDA events, ms of the
    kernel alone by torch.profiler or None)}.  Uses only what every version
    of the wrapper offers, so the same function times an older tree (set
    ``ROOT`` to its checkout before ``phase_probe``)."""
    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.thinning import dense_from_boards

    dense = dense_from_boards(m, w, 255)
    times = {}
    for ks in (5, 7):
        for what, x in (("board", m), ("dense", dense)):
            def call(x=x, ks=ks):
                return kernels.edge_candidates_cuda(x, w, ks, 22, 70)

            times[what, ks] = (cuda_ms(call, 20), profiled_ms(call, "edge_tiles", 20))
            alone = times[what, ks][1]
            print(f"K3+K4 at {tuple(m.shape[:-1])} x {w} px from a {what}, ksize {ks}: {times[what, ks][0]:.4f} ms a "
                  f"call, " + (f"{alone:.4f} ms alone (torch.profiler)" if alone else "alone: not measured"))
    return times


def chain_masks(shape=CHAIN_SHAPE):
    """The chain's opened and closed mask boards (k, h, ceil(w/32)) on the
    card, from the seeded synthetic partition, as ``phase_chain`` makes them."""
    import numpy as np
    import torch

    from plotweave_torch.stages.s02_color_extract import open_close_boards

    k, h, w = shape
    _, bins = synthetic_image(1, h, w)
    packed = np.packbits(np.stack([bins == j for j in range(k)]), axis=-1)
    mk, oi, ci, *_ = EDGE_PARAMS
    return open_close_boards(torch.from_numpy(packed).to("cuda"), w, oi, ci, "ellipse", mk)


def phase_k34_times() -> dict:
    """:func:`k34_times` on the chain's masks."""
    return k34_times(chain_masks(), CHAIN_SHAPE[-1])


def phase_k34_sweep(blocks=(1, 2, 3, 4), rows=(16, 32, 64, 128, 256), shapes=(CHAIN_SHAPE,)) -> None:
    """K3+K4's two free constants, timed on the chain's masks at ``shapes``:
    the tile's rows (``kernels.EDGE_TILE_ROWS``; the kernel takes them as an
    argument) and the blocks an SM must hold (``PW_EDGE_MIN_BLOCKS``, a
    rebuild), each result held to the plain version.  A measurement, not
    part of the smoke."""
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.canny import edge_candidates_plain

    flags, tile_rows = list(kernels.NVCC_FLAGS["edge_candidates"]), kernels.EDGE_TILE_ROWS
    try:
        for shape in shapes:
            m, w = chain_masks(shape), shape[-1]
            refs = {ks: edge_candidates_plain(m, w, ks, 22, 70) for ks in (5, 7)}
            for n in blocks:
                kernels.NVCC_FLAGS["edge_candidates"] = flags + [f"-DPW_EDGE_MIN_BLOCKS={n}"]
                kernels._libs.pop("edge_candidates", None)
                kernels.load("edge_candidates")
                log = kernels.build_log.get("edge_candidates", "").splitlines()
                regs = sorted({int(line.split("Used ")[1].split(" registers")[0]) for line in log if "registers" in line})
                for th in rows:
                    kernels.EDGE_TILE_ROWS = (th, th)
                    kernels.edge_schedule.cache_clear()
                    for ks in (5, 7):
                        def call(ks=ks):
                            return kernels.edge_candidates_cuda(m, w, ks, 22, 70)

                        got = call()
                        check(torch.equal(got[0], refs[ks][0]) and torch.equal(got[1], refs[ks][1]),
                              f"K3+K4 sweep: {shape}, blocks {n}, tile rows {th}, ksize {ks} != plain")
                        alone = profiled_ms(call, "edge_tiles", 20)
                        print(f"K3+K4 sweep {shape}: min blocks {n} (registers {regs[:1]}-{regs[-1:]}), tile rows {th}, "
                              f"ksize {ks}: {cuda_ms(call, 20):.4f} ms a call, "
                              + (f"{alone:.4f} ms alone" if alone else "alone: not measured"))
    finally:
        kernels.NVCC_FLAGS["edge_candidates"], kernels.EDGE_TILE_ROWS = flags, tile_rows
        kernels.edge_schedule.cache_clear()
        kernels._libs.pop("edge_candidates", None)


def phase_chain(stats: dict) -> None:
    import numpy as np
    import torch

    from plotweave_torch.ops import bitpack, kernels
    from plotweave_torch.ops.canny import canny_candidates_plain, edge_candidates_plain, hysteresis_plain
    from plotweave_torch.ops.filters import gaussian_blur_u8_plain
    from plotweave_torch.ops.kernels import hysteresis_cuda, zhang_suen_packed_cuda
    from plotweave_torch.ops.morphology import _valid_bits, morph_steps_plain
    from plotweave_torch.ops.thinning import dense_from_boards_plain, zhang_suen_into_plain, zhang_suen_packed_plain
    from plotweave_torch.stages.s02_color_extract import chain_from_clean, open_close_boards

    k, h, w = CHAIN_SHAPE
    _, bins = synthetic_image(1, h, w)
    masks = np.stack([(bins == j).astype(np.uint8) * 255 for j in range(k)])
    packed = np.packbits(masks > 0, axis=-1)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    t0 = time.perf_counter()
    ref = chain_from_clean(packed, w, *EDGE_PARAMS, device=cpu)
    cpu_s = time.perf_counter() - t0
    kernels.reset_launches()
    got = chain_from_clean(packed, w, *EDGE_PARAMS, device=cuda)
    torch.cuda.synchronize()
    n = {key: c for key, c in kernels.LAUNCHES.items() if c}
    check(n == CHAIN_LAUNCHES, f"one chain call launched {n}, expected {CHAIN_LAUNCHES}")
    check(torch.equal(got.cpu(), ref), "chain_from_clean: card != CPU at 4x1500x2000")
    nz = int(np.unpackbits(ref.numpy()).sum())
    print(f"chain {k}x{h}x{w}: card == CPU ({ref.numel()} blob bytes, {nz} set bits); launches {n}")
    stats["chain trace"] = only_own_kernels(
        lambda: chain_from_clean(packed, w, *EDGE_PARAMS, device=cuda), f"chain {k}x{h}x{w}, one call",
        {"morph_steps": 1, "edge_tiles": 1, "hysteresis_cluster": 1, "zs_cluster": 1})

    # the kernels' inputs at the main path's shapes, as the chain makes them
    mk, oi, ci, bk, lo, hi = EDGE_PARAMS
    rows = torch.from_numpy(packed).to(cuda)
    valid = _valid_bits(w, cuda)
    m = open_close_boards(rows, w, oi, ci, "ellipse", mk)
    cand, strong = kernels.edge_candidates_cuda(m, w, bk, lo, hi)
    cand_p, strong_p = edge_candidates_plain(m, w, bk, lo, hi)
    check(torch.equal(cand, cand_p) and torch.equal(strong, strong_p), f"K3+K4 != plain at {k}x{h}x{w}")
    board_bytes, row_bytes = m.numel() * 4, rows.numel()

    # K2 as the chain calls it: the cleaned masks' packed rows in, the open and close, boards out
    def k2():
        return kernels.morph_steps_cuda(rows, valid, MAIN_PATH_STEPS, w)

    def k2_plain():
        return morph_steps_plain(rows, valid, MAIN_PATH_STEPS, w)

    taps = sum(bin(t).count("1") for shape, ksize, _ in MAIN_PATH_STEPS for t in kernels.element_rows(shape, ksize)[1])
    stats["K2"] = {"max_abs_err": max_abs_err(k2(), k2_plain()), "ms": cuda_ms(k2, 20), "plain_ms": cuda_ms(k2_plain, 5),
                   "alone_ms": profiled_ms(k2, "morph_steps", 20),
                   # a funnel shift and an OR per tap and word
                   **bound(row_bytes + board_bytes + valid.numel() * 4, m.numel() * 2 * taps, INT32_OPS)}
    check(stats["K2"]["max_abs_err"] == 0 and torch.equal(k2(), m), f"K2 from packed rows != plain at {k}x{h}x{w}")

    def k34():
        return kernels.edge_candidates_cuda(m, w, bk, lo, hi)

    stats["K3+K4"] = {"max_abs_err": 0, "ms": cuda_ms(k34, 20),
                      "plain_ms": cuda_ms(lambda: edge_candidates_plain(m, w, bk, lo, hi), 3),
                      "alone_ms": profiled_ms(k34, "edge_tiles", 20),
                      "plain_device_kernels": sum(
                          device_kernels(lambda: edge_candidates_plain(m, w, bk, lo, hi)).values()),
                      **bound(3 * board_bytes, k * h * w * (2 * bk + EDGE_OPS_FIXED), INT32_OPS)}
    # the two halves of the plain version apart: the blur (K3) of the dense mask, then Sobel, NMS, thresholds (K4)
    dense_m = dense_from_boards_plain(m, w, 255)
    blurred = gaussian_blur_u8_plain(dense_m, bk)
    check(torch.equal(kernels.gaussian_blur_cuda(dense_m, bk), blurred), f"K3+K4 blur only != plain at {k}x{h}x{w}")
    stats["K3+K4"].update(
        blur_only_ms=cuda_ms(lambda: kernels.gaussian_blur_cuda(dense_m, bk), 20),
        k3_plain_ms=cuda_ms(lambda: gaussian_blur_u8_plain(dense_m, bk), 3),
        k3_plain_device_kernels=sum(device_kernels(lambda: gaussian_blur_u8_plain(dense_m, bk)).values()),
        k4_plain_ms=cuda_ms(lambda: canny_candidates_plain(blurred, lo, hi), 3),
        k4_plain_device_kernels=sum(device_kernels(lambda: canny_candidates_plain(blurred, lo, hi)).values()))
    stats["K3+K4 inputs"] = {f"{what} {ks}": t for (what, ks), t in k34_times(m, w).items()}
    st = stats["K3+K4"]
    print(f"  plain K3 (blur, ksize {bk}) {st['k3_plain_ms']:.4f} ms in {st['k3_plain_device_kernels']} device "
          f"kernels, plain K4 (Sobel, NMS, thresholds) {st['k4_plain_ms']:.4f} ms in {st['k4_plain_device_kernels']}; "
          f"the kernel's blur-only mode on the dense mask {st['blur_only_ms']:.4f} ms a call")

    # K1's boards -> rows, the chain's store after K6's multi-launch route until the banded route stored the
    # 4400 x 4400 blob itself: on no main path now, timed where it ran (two launches at 1 x 4400 x 4400)
    big = kernels.dense_to_boards_cuda(torch.from_numpy(random_boards(np.random.default_rng(9), 1, BIG_SIDE,
                                                                      BIG_SIDE)).to(cuda))
    big_blob = torch.empty((2, *big.shape[:-1], -(-BIG_SIDE // 8)), dtype=torch.uint8, device=cuda)

    def k1_store():
        kernels.boards_to_rows_cuda(big, BIG_SIDE, out=big_blob[0])
        kernels.boards_to_rows_cuda(big, BIG_SIDE, out=big_blob[1])

    def k1_store_plain():
        return torch.stack([bitpack.boards_to_rows_plain(big, BIG_SIDE)] * 2)

    k1_store()
    each = profiled_each(k1_store, ("boards_to_rows",), 20)
    one = bound(big.numel() * 4 + big_blob[0].numel(), 0, INT32_OPS)["bound_ms"]
    stats["K1 rows"] = {"max_abs_err": max_abs_err(big_blob, k1_store_plain()), "ms": cuda_ms(k1_store, 20),
                        "plain_ms": cuda_ms(k1_store_plain, 3),
                        "plain_device_kernels": sum(device_kernels(k1_store_plain).values()),
                        "alone_ms_each": each, "bound_ms_each": one, "alone_ms": sum(each) if each else None,
                        **bound(2 * (big.numel() * 4 + big_blob[0].numel()), 0, INT32_OPS)}
    check(stats["K1 rows"]["max_abs_err"] == 0, f"K1 boards -> rows != plain at 1x{BIG_SIDE}x{BIG_SIDE}")
    if each:
        print(f"  K1's two boards -> rows launches of the {BIG_SIDE}x{BIG_SIDE} route alone (torch.profiler): "
              + ", ".join(f"{t:.4f} ms ({100 * one / t:.1f} % of its bound {one:.5f} ms)" for t in each))
    for key, what in (("K2", f"{k}x{h}x{w}, the chain's {len(MAIN_PATH_STEPS)} steps from packed rows"),
                      ("K3+K4", f"{k}x{h}x{w} from a board, ksize {bk}"),
                      ("K1 rows", f"boards -> rows twice at 1x{BIG_SIDE}x{BIG_SIDE}")):
        st = stats[key]
        print(f"{key} ({what}): kernel {st['ms']:.4f} ms, plain PyTorch on the card "
              f"{st['plain_ms']:.4f} ms" + (f" in {st['plain_device_kernels']} device kernels" if "plain_device_kernels"
                                              in st else "")
              + f", bound {st['bound_ms']:.5f} ms by {st['bound_by']}" + (f", kernel alone {st['alone_ms']:.4f} ms "
                                                                          f"(torch.profiler)" if st.get("alone_ms") else ""))
    edges_p = hysteresis_plain(cand, strong)
    skel_p = zhang_suen_packed_plain(edges_p, 120, True)
    plain = {"K5": cuda_ms(lambda: hysteresis_plain(cand, strong), 3),
             "K6": cuda_ms(lambda: zhang_suen_packed_plain(edges_p, 120, True), 3)}
    board = edges_p.numel() * 4
    times = {}
    for name in ROUTES:
        args = route_args(name, h)
        before = dict(kernels.LAUNCHES)
        edges_k = hysteresis_cuda(cand, strong, **args)
        skel_k = zhang_suen_packed_cuda(edges_p, 120, True, **args)
        n = {key: kernels.LAUNCHES[key] - before[key] for key in kernels.LAUNCHES}
        err = {"K5": max_abs_err(edges_k, edges_p), "K6": max_abs_err(skel_k, skel_p)}
        check(err == {"K5": 0, "K6": 0}, f"{name}: kernel != plain at {k}x{h}x{w}: {err}")
        if name == "resident":
            check(n["hysteresis"] == 1 and n["zhang_suen_packed"] == 1 and sum(n.values()) == 2,
                  f"{name}: the resident route made {n} launches, not one per call")
            k6_iters = kernels.STATS["zhang_suen_packed"].tolist()
            k5_stats = kernels.STATS["hysteresis"].tolist()
        elif name == "banded":
            rounds = kernels.STATS["hysteresis_banded"][0]
            check(n["zhang_suen_packed_banded"] == 1 and n["hysteresis_banded"] == rounds and sum(n.values()) ==
                  1 + rounds, f"banded, {FORCED_BANDS} bands a layer: {n} launches, not one for K6 and one a round "
                  "for K5")
            print(f"chain banded ({FORCED_BANDS} bands a layer): launches "
                  f"{({key: c for key, c in n.items() if c})}, K5 in {rounds} rounds")
        else:
            print(f"chain {name}: launches {({key: c for key, c in n.items() if c})}")
        times[name] = {"K5": cuda_ms(lambda: hysteresis_cuda(cand, strong, **args), 20),
                       "K6": cuda_ms(lambda: zhang_suen_packed_cuda(edges_p, 120, True, **args), 20)}
    words = edges_p.numel()
    k6_ops = sum(k6_iters) * (words // k) * 2 * ZS_OPS_PER_WORD

    # K6 as the chain calls it: the edges' board in, both halves of the blob out, no board
    blob = torch.empty((2, k, h, -(-w // 8)), dtype=torch.uint8, device=cuda)

    def k6():
        kernels.zhang_suen_into_cuda(edges_p, w, blob[None, 0], blob[None, 1], "rows", 120, True)
        return blob

    def k6_plain():
        out = torch.empty_like(blob)
        zhang_suen_into_plain(edges_p, w, out[None, 0], out[None, 1], "rows", 120, True)
        return out

    bounds = {"K5": bound(3 * board, words * HYST_OPS_PER_WORD, INT32_OPS),
              "K6": bound(board + blob.numel(), k6_ops, INT32_OPS),
              "K6 multi": bound(2 * board, k6_ops, INT32_OPS)}
    stats["K5"] = {"max_abs_err": 0, "ms": times["resident"]["K5"], "plain_ms": plain["K5"], **bounds["K5"]}
    stats["K5 multi"] = {"max_abs_err": 0, "ms": times["multi-launch"]["K5"], "plain_ms": plain["K5"], **bounds["K5"]}
    stats["K6"] = {"max_abs_err": max_abs_err(k6(), k6_plain()), "ms": cuda_ms(k6, 20), "plain_ms": cuda_ms(k6_plain, 3),
                   "alone_ms": profiled_ms(k6, "zs_cluster", 20), "board_out_ms": times["resident"]["K6"],
                   **bounds["K6"]}
    stats["K6 multi"] = {"max_abs_err": 0, "ms": times["multi-launch"]["K6"], "plain_ms": plain["K6"],
                         **bounds["K6 multi"]}
    check(stats["K6"]["max_abs_err"] == 0, f"K6 into the blob != plain at {k}x{h}x{w}")
    stats["chain routes"] = times
    chain_ms = cuda_ms(lambda: chain_from_clean(packed, w, *EDGE_PARAMS, device=cuda), 20)
    stats["chain ms"] = chain_ms
    print(f"chain device time {chain_ms:.3f} ms/call (CUDA events, H2D of the masks included); "
          f"CPU plain version {cpu_s * 1e3:.1f} ms wall")
    print(f"K6 iterations per layer {k6_iters}; K5 (rounds, most sweeps of a CTA) per layer {k5_stats}")
    for key in ("K5", "K6"):
        s = stats[key]
        print(f"{key} at {k}x{h}x{w}, board out: " + ", ".join(f"{name} {times[name][key]:.4f} ms" for name in ROUTES)
              + f" (banded: {FORCED_BANDS} bands a layer); plain PyTorch on the card {plain[key]:.4f} ms; bound "
              f"{s['bound_ms']:.5f} ms by {s['bound_by']}")
    s = stats["K6"]
    print(f"K6 at {k}x{h}x{w} as the chain calls it (both halves of the blob out): {s['ms']:.4f} ms a call, "
          + (f"{s['alone_ms']:.4f} ms alone, " if s.get("alone_ms") else "")
          + f"plain {s['plain_ms']:.4f} ms, bound {s['bound_ms']:.5f} ms by {s['bound_by']}")
    big_cases(stats)


def big_inputs():
    """The 4400 x 4400 layer of phase 16 (c) as the chain makes it on the
    card: its packed mask, the open and close (K2), the candidates (K3+K4)
    and the edges (K5), the same for every checkout."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.morphology import _valid_bits

    cuda = torch.device("cuda")
    bk, lo, hi = EDGE_PARAMS[3:]
    packed = torch.from_numpy(np.packbits((big_bins() == 0)[None], axis=-1)).to(cuda)
    m = kernels.morph_steps_cuda(packed, _valid_bits(BIG_SIDE, cuda), MAIN_PATH_STEPS, BIG_SIDE)
    cand, strong = kernels.edge_candidates_cuda(m, BIG_SIDE, bk, lo, hi)
    edges = kernels.hysteresis_cuda(cand, strong)
    return packed, cand, strong, edges


def big_cases(stats: dict) -> None:
    """K5 and K6 at 1 x 4400 x 4400 as the chain calls them (the banded
    route by size: K6 storing the blob), on the chain's own inputs, against
    their plain versions on the card and the multi-launch route named; the
    rows of the ``kernels`` line for the banded K5 and K6 (bounds on the own
    rows: the layer's, each input read once and each output written once)."""
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.canny import hysteresis_plain
    from plotweave_torch.ops.thinning import zhang_suen_into_plain
    from plotweave_torch.stages.s02_color_extract import chain_from_clean

    packed, cand, strong, edges = big_inputs()
    cuda = torch.device("cuda")
    check(torch.equal(edges, hysteresis_plain(cand, strong)), f"K5 banded != plain at 1x{BIG_SIDE}x{BIG_SIDE}")
    blob = torch.empty((2, 1, 1, BIG_SIDE, -(-BIG_SIDE // 8)), dtype=torch.uint8, device=cuda)
    blob_p = torch.empty_like(blob)
    zhang_suen_into_plain(edges, BIG_SIDE, blob_p[0], blob_p[1], "rows", 120, True)

    def k5(route=None):
        return kernels.hysteresis_cuda(cand, strong, route=route)

    def k6(route=None):
        kernels.zhang_suen_into_cuda(edges, BIG_SIDE, blob[0], blob[1], "rows", 120, True, route)
        return blob

    before = dict(kernels.LAUNCHES)
    check(torch.equal(k6(), blob_p), f"K6 banded into the blob != plain at 1x{BIG_SIDE}x{BIG_SIDE}")
    k6_rounds, iters = kernels.STATS["zhang_suen_packed_banded"]
    iters = iters.tolist()
    k5()
    k5_rounds = kernels.STATS["hysteresis_banded"][0]
    n = {name: kernels.LAUNCHES[name] - before[name] for name in kernels.LAUNCHES if kernels.LAUNCHES[name] - before[name]}
    check(n == {"zhang_suen_packed_banded": 1, "hysteresis_banded": k5_rounds} and k6_rounds == 1,
          f"1x{BIG_SIDE}x{BIG_SIDE} as the chain calls K5 and K6: launches {n}")
    words, board = edges.numel(), edges.numel() * 4
    multi = {"K5": cuda_ms(lambda: k5("multi"), 3), "K6": cuda_ms(lambda: k6("multi"), 3)}
    check(torch.equal(k6("multi"), blob_p) and torch.equal(k5("multi"), edges), "the multi-launch route at "
          f"1x{BIG_SIDE}x{BIG_SIDE} != plain")
    stats["K5 banded"] = {"max_abs_err": 0, "ms": cuda_ms(k5, 10), "alone_ms": profiled_ms(k5, "hysteresis_cluster", 5),
                          "plain_ms": cuda_ms(lambda: hysteresis_plain(cand, strong), 2), "rounds": k5_rounds,
                          "multi_ms": multi["K5"], **bound(3 * board, words * HYST_OPS_PER_WORD, INT32_OPS)}
    stats["K6 banded"] = {"max_abs_err": 0, "ms": cuda_ms(k6, 10), "alone_ms": profiled_ms(k6, "zs_cluster", 5),
                          "plain_ms": cuda_ms(lambda: zhang_suen_into_plain(edges, BIG_SIDE, blob_p[0], blob_p[1],
                                                                             "rows", 120, True), 2),
                          "iterations": iters, "multi_ms": multi["K6"],
                          **bound(board + blob.numel(), sum(iters) * words * 2 * ZS_OPS_PER_WORD, INT32_OPS)}
    stats["big chain ms"] = cuda_ms(lambda: chain_from_clean(packed, BIG_SIDE, *EDGE_PARAMS, device=cuda), 10)
    for key, what in (("K5 banded", f"{k5_rounds} rounds"), ("K6 banded", f"one round, {iters} iterations")):
        st = stats[key]
        print(f"{key} at 1x{BIG_SIDE}x{BIG_SIDE} as the chain calls it ({what}): {st['ms']:.4f} ms a call, "
              + (f"{st['alone_ms']:.4f} ms alone, " if st.get("alone_ms") else "")
              + f"multi-launch route {st['multi_ms']:.4f} ms, plain {st['plain_ms']:.4f} ms, bound "
              f"{st['bound_ms']:.5f} ms by {st['bound_by']}")
    print(f"chain 1x{BIG_SIDE}x{BIG_SIDE}: {stats['big chain ms']:.3f} ms a call (CUDA events, H2D of the mask "
          "included)")


def run_main(image: str, out: Path, device: str, config: Path | None = None, end_step: int = 13,
             settings: dict | None = None, preset: str | None = None, flags: tuple = ()) -> dict:
    """The CLI entry point, steps 1 to ``end_step``; its stage log goes to
    ``<out>.log``.  ``settings`` are written to a config file of the run;
    ``preset`` names a preset; ``flags`` are further CLI arguments."""
    from plotweave_torch.pipeline import main

    argv = [image, "--output", str(out), "--end-step", str(end_step), "--raster-device", device, *flags]
    if preset is not None:
        argv += ["--preset", preset]
    if settings is not None:
        out.mkdir(exist_ok=True)
        config = out / "config.json"
        config.write_text(json.dumps(settings))
    if config is not None:
        argv += ["--config", str(config)]
    with open(f"{out}.log", "w") as log, contextlib.redirect_stdout(log):
        return main(argv)


def same_artifacts(a: Path, b: Path, names, stream: bool = True) -> list:
    """Relative paths of the compared artifacts that differ between two runs."""
    rel = ["plot_stream.bin"] * stream + [f"{n}/{f}" for n in names for f in ("mask.png", "edges.png", "contours.pkl")]
    return [r for r in rel if (a / r).read_bytes() != (b / r).read_bytes()]


def phase_main_path(work: Path) -> dict:
    import cv2
    import numpy as np

    from plotweave_torch.config import PipelineConfig
    from plotweave_torch.ops import kernels

    img, _ = synthetic_image(2, 1500, 2000)
    image = str(work / "synthetic.png")
    cv2.imwrite(image, img)
    names = list(PipelineConfig().color_names)

    kernels.reset_launches()
    t0 = time.perf_counter()
    times_cuda = run_main(image, work / "synthetic_cuda", "auto")
    wall_cuda = time.perf_counter() - t0
    first = dict(kernels.LAUNCHES)
    check(all(first[n] > 0 for n in MAIN_PATH_KERNELS), f"main path did not launch K2, K5 and K6: {first}")
    check({n: first[n] for n in CHAIN_LAUNCHES} == CHAIN_LAUNCHES and first["bitpack"] == 0,
          f"main path: the chain's launches are {first}, expected {CHAIN_LAUNCHES} and no K1")
    check(all(first[n] == 0 for n in BANDED_KERNELS + MULTI_KERNELS),
          f"main path at 2000x1500 left the resident route: {first}")
    t0 = time.perf_counter()
    times_cpu = run_main(image, work / "synthetic_cpu", "cpu")
    wall_cpu = time.perf_counter() - t0
    diff = same_artifacts(work / "synthetic_cuda", work / "synthetic_cpu", names)
    check(not diff, f"synthetic 2000x1500: card run != CPU run: {diff}")
    size = decodes(work / "synthetic_cuda")
    print(f"main path, synthetic 2000x1500: card == CPU ({size} stream bytes, decodes to EOF); "
          f"launches {first}; wall {wall_cuda:.2f} s (card) vs {wall_cpu:.2f} s (cpu)")
    print("  stage wall seconds (card | cpu): " + ", ".join(
        f"{m[:3]} {times_cuda[m]:.3f}|{times_cpu[m]:.3f}" for m in times_cuda))

    import tarfile

    for cfg_name, ref_name in zip(E2E_CONFIGS, E2E_REFS):
        cfg = json.loads((GOLDEN / "e2e" / cfg_name).read_text())
        image = str(GOLDEN / "e2e" / Path(cfg["input_image"]).name)
        runs = {}
        for device in ("auto", "cpu"):
            out = work / f"{cfg_name}_{device}"
            out.mkdir()
            (out / "config.json").write_text(json.dumps(dict(cfg, output_dir=str(out))))
            before = dict(kernels.LAUNCHES)
            runs[device] = run_main(image, out, device, out / "config.json")
            if device == "auto":
                check(all(kernels.LAUNCHES[n] > before[n] for n in MAIN_PATH_KERNELS),
                      f"{cfg_name}: K2, K5 and K6 not launched")
        diff = same_artifacts(work / f"{cfg_name}_auto", work / f"{cfg_name}_cpu", cfg["color_names"])
        check(not diff, f"{cfg_name}: card run != CPU run: {diff}")
        ref = work / f"{cfg_name}_ref"
        with tarfile.open(GOLDEN / "e2e" / ref_name) as tf:
            tf.extractall(ref, filter="data")
        golden = (ref / "plot_stream.bin").read_bytes() == (work / f"{cfg_name}_auto" / "plot_stream.bin").read_bytes()
        print(f"main path, {cfg_name}: card == CPU; plot_stream.bin == golden: {golden}; "
              f"card stage seconds {sum(runs['auto'].values()):.3f}")

    # steps 1-4 on an image whose layers do not fit one cluster: K5 and K6
    # take the banded route
    img, _ = synthetic_image(4, BIG_SIDE, BIG_SIDE)
    image = str(work / "big.png")
    cv2.imwrite(image, img)
    runs = {}
    for device in ("auto", "cpu"):
        out = work / f"big_{device}"
        out.mkdir()
        (out / "config.json").write_text(json.dumps({"max_dimension": BIG_SIDE}))
        if device == "auto":
            kernels.reset_launches()
        runs[device] = run_main(image, out, device, out / "config.json", end_step=4)
        if device == "auto":
            big = dict(kernels.LAUNCHES)
            k5_rounds = kernels.STATS["hysteresis_banded"][0]
    # K2 loads the packed rows; the banded K6 stores the blob in its one launch, K5 launches once a round;
    # no K1 and no multi-launch kernel
    check(big["morph_bits"] == 1 and big["edge_candidates"] == 1 and big["zhang_suen_packed_banded"] == 1
          and big["hysteresis_banded"] == k5_rounds and big["bitpack"] == 0
          and all(big[n] == 0 for n in ("hysteresis", "zhang_suen_packed") + MULTI_KERNELS),
          f"{BIG_SIDE}x{BIG_SIDE}: launches {big}, K5 in {k5_rounds} rounds")
    diff = same_artifacts(work / "big_auto", work / "big_cpu", names, stream=False)
    check(not diff, f"{BIG_SIDE}x{BIG_SIDE} steps 1-4: card run != CPU run: {diff}")
    print(f"main path, steps 1-4 on {BIG_SIDE}x{BIG_SIDE} (max_dimension {BIG_SIDE}): card == CPU, K5 and K6 by "
          f"the banded route (K6 one launch, K5 {k5_rounds} rounds, no K1, no multi-launch kernel); launches "
          f"{ {n: c for n, c in big.items() if c} }; card stage seconds {sum(runs['auto'].values()):.3f}")
    return {"main": first, "big": big}


def k7_flops(img, k: int) -> float:
    """The float operations K7's function needs on this image: the fixed
    part and the distances per pixel, and per XYZ value a cbrtf or the linear
    branch, counted from the data."""
    import torch

    from plotweave_torch.ops.colorspace import _D, _M, _WHITE, _div, _srgb_gamma_inv

    bgr = _div(img.to(torch.float32), 255.0)
    lin = [_srgb_gamma_inv(bgr[..., 2 - c]) for c in range(3)]
    cbrts = sum(int((_div(float(m[0]) * lin[0] + float(m[1]) * lin[1] + float(m[2]) * lin[2], float(white))
                     > _D**3).sum()) for m, white in zip(_M, _WHITE))
    px = img.numel() // 3
    return px * (K7_FLOPS_FIXED + k * K7_FLOPS_PER_CENTER) + cbrts * CBRT_FLOPS + (3 * px - cbrts) * LINEAR_FLOPS


def phase_frontend(stats: dict) -> dict:
    """``raster_frontend`` at 2000 x 1500, k = 4, both routes, card vs CPU."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.canny import edge_candidates_plain
    from plotweave_torch.ops.frontend import (
        assign_boards_plain, assign_nearest, assign_nearest_plain, frontend_from_labels, frontend_steps,
        onehot_boards_plain, raster_frontend)
    from plotweave_torch.ops.morphology import _valid_bits, morph_steps_plain
    from plotweave_torch.ops.thinning import (
        dense_from_boards_plain, pack_bitboards_plain, unpack_bitboards_plain, zhang_suen_dense_plain)

    h, w = FRONTEND_SHAPE
    img_np, _ = synthetic_image(3, h, w)
    centers = np.array(BENCH_CENTERS, np.float32)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    img, c = torch.from_numpy(img_np).to(cuda), torch.from_numpy(centers).to(cuda)

    t0 = time.perf_counter()
    labels_cpu = assign_nearest(torch.from_numpy(img_np), centers, 4)
    ref = {route: frontend_from_labels(labels_cpu, 4, pallas_thinning=route) for route in (False, True)}
    cpu_s = time.perf_counter() - t0

    launches = {}
    out = {}
    for route in (False, True):
        kernels.reset_launches()
        out[route] = raster_frontend(img, c, k=4, pallas_thinning=route)
        torch.cuda.synchronize()
        launches[route] = dict(kernels.LAUNCHES)
    # K7, K2, K3+K4, K5, then K6 storing both dense outputs, or K1, K12 and two more K1
    need = {False: {"assign_nearest": 1, "morph_bits": 1, "edge_candidates": 1, "hysteresis": 1, "zhang_suen_packed": 1,
                    "bitpack": 0},
            True: {"assign_nearest": 1, "morph_bits": 1, "edge_candidates": 1, "hysteresis": 1, "zhang_suen_packed": 0,
                   "bitpack": 3}}
    for route, counts in need.items():
        check(all(launches[route][n] == v for n, v in counts.items()),
              f"front-end route {route}: launches {launches[route]}, expected {counts}")
    check(launches[False]["zhang_suen_dense"] == 0 and 1 <= launches[True]["zhang_suen_dense"] <= 2,
          f"front-end: K12 made {launches[False]['zhang_suen_dense']} launches on the default route and "
          f"{launches[True]['zhang_suen_dense']} on the dense route (expected 0, and 1 or 2)")
    check(torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1]),
          "front-end: the K12 route's output != the K6 route's on the card")
    labels = assign_nearest(img, c, 4)
    flips = near_tie_flips(img, centers, labels, labels_cpu, "front-end labels, card vs CPU")
    for route in (False, True):
        e, sk = frontend_from_labels(labels_cpu.to(cuda), 4, pallas_thinning=route)
        check(torch.equal(e.cpu(), ref[route][0]) and torch.equal(sk.cpu(), ref[route][1]),
              f"front-end from the same labels: card != CPU (pallas_thinning={route})")
        if flips == 0:
            check(torch.equal(out[route][1].cpu(), ref[route][1]), f"front-end: card != CPU (pallas_thinning={route})")
    edges, skel = out[False]
    print(f"front-end {h}x{w} k=4: card == CPU from the same labels, both routes; K12 route == K6 route; "
          f"{int(edges.count_nonzero())} edge px, {int(skel.count_nonzero())} skeleton px; "
          f"launches default {launches[False]}, dense {launches[True]}")
    common = {"assign_nearest": 1, "morph_steps": 1, "edge_tiles": 1, "hysteresis_cluster": 1}
    for route, name, rest in ((False, "default route", {"zs_cluster": 1}),
                              (True, "dense route", {"zs_tiles": launches[True]["zhang_suen_dense"], "boards_to_dense": 2,
                                                     "dense_to_boards": 1})):
        stats[f"front-end trace {route}"] = only_own_kernels(
            lambda route=route: raster_frontend(img, c, k=4, pallas_thinning=route),
            f"front-end {h}x{w}, {name}, one call", {**common, **rest})

    # device times at the front-end's shapes
    route_ms = {route: cuda_ms(lambda route=route: raster_frontend(img, c, k=4, pallas_thinning=route), 20)
                for route in (False, True)}
    stats["front-end ms"] = route_ms
    masks_b = kernels.assign_boards_cuda(img, c)
    check(torch.equal(masks_b, onehot_boards_plain(labels, 4)), "K7 boards != the one-hot boards of its labels")
    px = h * w
    stats["K7"].update(ms=cuda_ms(lambda: kernels.assign_boards_cuda(img, c), 20),
                       plain_ms=cuda_ms(lambda: assign_boards_plain(img, c, 4), 5),
                       labels_ms=cuda_ms(lambda: kernels.assign_nearest_cuda(img, c), 20),
                       labels_plain_ms=cuda_ms(lambda: assign_nearest_plain(img, c, 4), 5),
                       alone_ms=profiled_ms(lambda: kernels.assign_boards_cuda(img, c), "assign_nearest", 20),
                       labels_alone_ms=profiled_ms(lambda: kernels.assign_nearest_cuda(img, c), "assign_nearest", 20))
    flops = k7_flops(img, 4)
    stats["K7"].update(bound(img.numel() + masks_b.numel() * 4, flops, FP32_OPS))
    stats["K7"]["labels_bound"] = bound(img.numel() + px * 4, flops, FP32_OPS)
    valid = _valid_bits(w, cuda)
    steps = frontend_steps()

    def k2_call():
        return kernels.morph_steps_cuda(masks_b, valid, steps)

    def k12_call():
        return kernels.zhang_suen_dense_cuda(edges)

    k2_b = k2_call()
    k2 = unpack_bitboards_plain(k2_b, w)
    taps = sum(bin(m).count("1") for shape, ksize, _ in steps for m in kernels.element_rows(shape, ksize)[1])
    board = masks_b.numel() * 4
    stats["K2 front-end"] = {
        "max_abs_err": max_abs_err(k2, unpack_bitboards_plain(morph_steps_plain(masks_b, valid, steps), w)),
        "ms": cuda_ms(k2_call, 20), "plain_ms": cuda_ms(lambda: morph_steps_plain(masks_b, valid, steps), 5),
        # a funnel shift and an OR per tap and word
        **bound(2 * board + valid.numel() * 4, masks_b.numel() * 2 * taps, INT32_OPS)}

    # K3+K4 at the front-end's blur (ksize 7) and K1's dense side at 4 x H x W
    def k34():
        return kernels.edge_candidates_cuda(k2_b, w, 7, 22, 70)

    got, plain = k34(), edge_candidates_plain(k2_b, w, 7, 22, 70)
    check(torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]), "K3+K4 != plain at the front-end's shapes")
    stats["K3+K4 front-end"] = {"ms": cuda_ms(k34, 20), "alone_ms": profiled_ms(k34, "edge_tiles", 20),
                                "plain_ms": cuda_ms(lambda: edge_candidates_plain(k2_b, w, 7, 22, 70), 3),
                                **bound(3 * board, 4 * px * (2 * 7 + EDGE_OPS_FIXED), INT32_OPS)}
    edges_b = kernels.dense_to_boards_cuda(edges)
    check(torch.equal(edges_b, pack_bitboards_plain(edges))
          and torch.equal(kernels.boards_to_dense_cuda(edges_b, w, 255), edges),
          "K1 != plain at the front-end's shapes")

    def k1_dense():  # the K12 route's two conversions back to dense
        kernels.boards_to_dense_cuda(edges_b, w, 255)
        kernels.boards_to_dense_cuda(k2_b, w, 1)

    def k1_dense_plain():
        dense_from_boards_plain(edges_b, w, 255)
        dense_from_boards_plain(k2_b, w, 1)

    stats["K1 dense"] = {"max_abs_err": 0, "ms": cuda_ms(k1_dense, 20), "plain_ms": cuda_ms(k1_dense_plain, 3),
                         "plain_device_kernels": sum(device_kernels(k1_dense_plain).values()),
                         "alone_ms": profiled_ms(k1_dense, "boards_to_dense", 20),
                         **bound(2 * (board + edges.numel()), 0, INT32_OPS)}
    skel32 = k12_call()
    stats["K1 pack"] = {"max_abs_err": 0,
                        "ms": cuda_ms(lambda: kernels.dense_to_boards_cuda(edges), 20),
                        "plain_ms": cuda_ms(lambda: pack_bitboards_plain(edges), 3),
                        "int32_ms": cuda_ms(lambda: kernels.dense_to_boards_cuda(skel32), 20),
                        "int32_plain_ms": cuda_ms(lambda: pack_bitboards_plain(skel32), 3),
                        "plain_device_kernels": sum(device_kernels(lambda: pack_bitboards_plain(edges)).values()),
                        **bound(board + edges.numel(), 0, INT32_OPS)}
    k12 = skel32
    k12_iters = kernels.STATS["zhang_suen_dense"]
    # the iterations these edges need, per layer (K6 runs the same fixpoint),
    # at the bit-sliced count of 32 pixels a word: the least work of the function
    kernels.zhang_suen_packed_cuda(edges_b, 120, True)
    iters = kernels.STATS["zhang_suen_packed"].tolist()
    stats["K12"] = {"max_abs_err": max_abs_err(k12, zhang_suen_dense_plain(edges)),
                    "ms": cuda_ms(k12_call, 10),
                    "plain_ms": cuda_ms(lambda: zhang_suen_dense_plain(edges), 2),
                    **bound(edges.numel() * edges.element_size() + k12.numel() * 4,
                            sum(iters) * h * -(-w // 32) * 2 * ZS_OPS_PER_WORD, INT32_OPS)}
    check(stats["K2 front-end"]["max_abs_err"] == 0 and stats["K12"]["max_abs_err"] == 0,
          "K2 or K12 != plain at full size")

    # K2's host time per call (no sync: the card keeps up), and the kernels' device time alone
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        k2_call()
    host_us = (time.perf_counter() - t0) / 50 * 1e6
    torch.cuda.synchronize()
    alone = {"K2": (profiled_ms(k2_call, "morph_steps", 20), cuda_ms(bare_k2(masks_b, valid, steps), 200)),
             "K12": (profiled_ms(k12_call, "zs_tiles", 10), cuda_ms(bare_k12(edges), 50))}
    stats["K2 alone"] = {"host_us": host_us, "profiler_ms": alone["K2"][0], "bare_ms": alone["K2"][1]}
    stats["K12 alone"] = {"profiler_ms": alone["K12"][0], "bare_ms": alone["K12"][1]}

    mpx = h * w / 1e6
    for route, name in ((False, "K6 route"), (True, "K12 route")):
        print(f"front-end {name}: {route_ms[route]:.3f} ms/call (CUDA events), {mpx / route_ms[route] * 1e3:.1f} Mpx/s")
    print(f"front-end on the CPU (plain versions, labels + both routes): {cpu_s * 1e3:.1f} ms wall")
    st = stats["K7"]
    print(f"K7 at {h}x{w} px, k=4: boards {st['ms']:.4f} ms a call ({st['alone_ms'] or float('nan'):.4f} alone), plain "
          f"{st['plain_ms']:.4f} ms, bound {st['bound_ms']:.5f} ms by {st['bound_by']}; labels {st['labels_ms']:.4f} ms "
          f"a call ({st['labels_alone_ms'] or float('nan'):.4f} alone), plain {st['labels_plain_ms']:.4f} ms, bound "
          f"{st['labels_bound']['bound_ms']:.5f} ms by {st['labels_bound']['bound_by']}; {flops / px:.1f} float "
          f"operations a pixel")
    for name, what in (("K2 front-end", "the front-end's 8 steps, one call"), ("K12", f"4x{h}x{w}"),
                       ("K3+K4 front-end", f"4x{h}x{w} from a board, ksize 7"),
                       ("K1 dense", f"two boards -> dense uint8 at 4x{h}x{w}"),
                       ("K1 pack", f"dense uint8 -> boards at 4x{h}x{w}")):
        st = stats[name]
        print(f"{name} at {what}: kernel {st['ms']:.4f} ms, plain PyTorch on the card {st['plain_ms']:.4f} ms, "
              f"bound {st['bound_ms']:.5f} ms by {st['bound_by']}"
              + (f", alone {st['alone_ms']:.4f} ms (torch.profiler)" if st.get("alone_ms") else "")
              + (f", plain in {st['plain_device_kernels']} device kernels" if "plain_device_kernels" in st else ""))
    st = stats["K1 pack"]
    print(f"  K1 dense int32 -> boards (K12's output): {st['int32_ms']:.4f} ms, plain {st['int32_plain_ms']:.4f} ms")
    for name, (prof_ms, bare_ms) in alone.items():
        print(f"{name} kernel alone: " + (f"{prof_ms:.4f} ms a call by torch.profiler" if prof_ms is not None
                                          else "not measured by torch.profiler (no device time in its trace)")
              + f"; {bare_ms:.4f} ms a launch by CUDA events around a loop of bare launches")
    print(f"K2 wrapper host time: {host_us:.1f} us a call (perf_counter over 50 calls, no sync)")
    print(f"K12's edges need {iters} iterations per layer; a dense call launched {k12_iters} iterations in "
          f"{launches[True]['zhang_suen_dense']} launch(es)")
    return launches


def poster_sample(seed: int = 2, limit: int = KMEANS_SAMPLE):
    """The device mode's subsample of the synthetic 2000 x 1500 poster, drawn
    on the card as stage 02 draws it: (image tensor, sample indices, float
    Lab sample (limit, 3)), all on the card."""
    import torch

    from plotweave_torch.ops.kmeans import lab_sample, subsample_indices

    img = torch.from_numpy(synthetic_image(seed, 1500, 2000)[0]).to("cuda")
    idx = subsample_indices(42, 1500 * 2000, limit, img.device)
    return img, idx, lab_sample(img, idx)


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def phase_kmeans_and_dense_kernels(stats: dict) -> dict:
    """K8 (sampler, seeding, fit, assignment), K7's counts and K11 against
    their plain versions on the card; returns the launch counts of one
    ``ops.kmeans.kmeans`` call on the card."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels, kmeans, morphology
    from plotweave_torch.ops.colorspace import bgr_to_lab_u8
    from plotweave_torch.ops.frontend import (
        assign_boards_counts_plain, assign_nearest_plain, nearest_of_lab, onehot_boards_plain)

    dev = torch.device("cuda")
    rng = np.random.default_rng(31)

    # --- K8's sampler against K7, over every BGR colour once
    v = torch.arange(2**24, dtype=torch.int32, device=dev)
    img = torch.stack([v & 255, (v >> 8) & 255, v >> 16], dim=-1).to(torch.uint8).reshape(4096, 4096, 3)
    pens = torch.tensor([[30, 128, 128], [60, 150, 100], [90, 110, 160], [120, 170, 170], [150, 90, 120],
                         [180, 140, 200], [210, 120, 90], [245, 128, 128]], dtype=torch.float32, device=dev)
    lab = kernels.lab_sample_cuda(img)
    check(torch.equal(nearest_of_lab(lab.view(4096, 4096, 3), pens, 8), kernels.assign_nearest_cuda(img, pens)),
          "K8 lab_sample: its Lab through K7's distance rule != K7's labels, all 2^24 colours, 8 centres")
    lab_err = float((lab.view(4096, 4096, 3) - bgr_to_lab_u8(img)).abs().max())
    check(lab_err <= 1e-3, f"K8 lab_sample vs plain Lab: max abs err {lab_err} > 1e-3")
    idx = torch.from_numpy(rng.integers(0, 2**24, KMEANS_SAMPLE).astype(np.int32))
    check(torch.equal(kmeans.lab_sample(img, idx), lab[idx.long().to(dev)]),
          "K8 lab_sample: a gather by index != the same pixels in place")
    for bad in ([-1], [2**24], [0, 2**24 + 5]):  # indices on the card, outside the image: refused before any launch
        try:
            kmeans.lab_sample(img, torch.tensor(bad, dtype=torch.int32, device=dev))
            fail(f"K8 lab_sample: indices {bad} on the card, outside the image's 2^24 pixels, were not refused")
        except ValueError:
            pass
    torch.cuda.synchronize()
    del v, img, lab
    print(f"K8 lab_sample: its Lab gives K7's labels exactly on all 2^24 colours (8 centres), within {lab_err:.2e} "
          f"of the plain Lab (tolerance 1e-3); a gather of {KMEANS_SAMPLE} indices == the pixels in place; indices "
          f"outside the image on the card refused")

    # --- K8's draw against its plain version on the CPU, index for index
    n_px = 1500 * 2000
    draws = [(n_px, KMEANS_SAMPLE, seed) for seed in range(8)] + [
        (KMEANS_SAMPLE + 1, KMEANS_SAMPLE, 8), (n_px, 1, 9), (2, 1, 10), (5000, 700, 11),
        (BIG_SIDE * BIG_SIDE, KMEANS_SAMPLE, 12), (n_px, n_px - 1, 13), (100_000, 999, 14), (70_000, 3, 15)]
    for n, limit, seed in draws:
        got = kmeans.subsample_indices(seed, n, limit, dev)
        check(torch.equal(got.cpu(), kmeans.subsample_indices(seed, n, limit, "cpu")),
              f"K8 subsample n={n} limit={limit} seed={seed}: the card's draw != the plain draw")
    print(f"K8 subsample == plain on the CPU index for index: {len(draws)} draws (3,000,000 -> 200,000 on 8 seeds, "
          f"n = limit + 1, limit = 1, limit = n - 1, 2 pixels, {BIG_SIDE} x {BIG_SIDE}, 100,000 -> 999, 70,000 -> 3)")

    # --- the poster's sample, drawn on the card: what the main path gives the fit
    poster, idx, sample = poster_sample()
    quant = torch.round(sample)  # integer Lab: many duplicate rows
    small = torch.from_numpy(np.concatenate([rng.normal(c, 2.0, (194, 3)) for c in
                                             ((20, 20, 20), (80, 100, 120), (200, 128, 128), (240, 200, 180))] +
                                            [np.full((1, 3), 7.0)]).astype(np.float32)).to(dev)  # 777 rows
    same = torch.full((5000, 3), 7.0, device=dev)  # every weight is the floor 1
    # too large to stay resident: the first size the streamed route takes, and more
    edge = kmeans.subsample_lab(poster, 44, 231_697)
    wide = kmeans.subsample_lab(poster, 43, 250_000)
    # the seeds: the seeds-and-fits launch with no iteration (ops.kmeans.kpp_init on the card)
    n_kpp = 0
    for name, data in (("200,000 poster rows", sample), ("200,000 integer rows", quant), ("777 rows", small),
                       ("5 rows", small[:5].contiguous()), ("5,000 coincident rows", same), ("231,697 rows", edge),
                       ("250,000 rows", wide)):
        route = kernels.kpp_schedule(data.shape[0])["route"]
        check(route == ("streamed" if data.shape[0] > 231_696 else "resident"), f"K8 kmeans_fit {name}: route {route}")
        for k in (1, 2, 4, 8):
            first, uniforms = kmeans.seed_stream(1000 + k, 16, k, data.shape[0])  # 16 seeds
            got_c, got_p = kmeans.kpp_init(data, k, first, uniforms)
            for a in range(16):
                ref_c, ref_p = kmeans.kpp_init_plain(data, k, int(first[a]), uniforms[a])
                check(torch.equal(got_p[a], ref_p) and torch.equal(got_c[a], ref_c),
                      f"K8 seeds {name} {route} k={k} seed {a}: picked {got_p[a].tolist()}, plain {ref_p.tolist()}")
                n_kpp += 1
    edges = (0.0, 1e-45, 2.0**-24, 0.999999, float(np.nextafter(np.float32(1), np.float32(0))), 1.0)
    for name, data in (("200,000 poster rows", sample), ("250,000 rows", wide)):  # one sample on each route
        for u in edges:
            first = torch.tensor([0, 17, data.shape[0] - 1], dtype=torch.int32)
            uniforms = torch.full((3, 3), u, dtype=torch.float32)
            got = kmeans.kpp_init(data, 4, first, uniforms)[1]
            for a in range(3):
                ref = kmeans.kpp_init_plain(data, 4, int(first[a]), uniforms[a])[1]
                check(torch.equal(got[a], ref),
                      f"K8 seeds {name} u={u} attempt {a}: picked {got[a].tolist()}, plain {ref.tolist()}")
                n_kpp += 1
    print(f"K8 kmeans_fit's seeds (no iteration) == plain (the same picked rows and centres): {n_kpp} (sample, route, "
          f"k, seed) cases on the poster's sample drawn on the card, integer rows with duplicates, 777 and 5 rows, "
          f"5,000 coincident rows and 231,697 and 250,000 rows (streamed), each on the route its size takes, k = 1, "
          f"2, 4, 8, and u at {edges} on a sample of each route")
    del edge

    def fit_checks(name, data, got, ref):
        """A fit (best, centres, compactness, iterations) against its plain version's: centres within 1e-3,
        compactness within 1e-5 relative at its own centres and 1e-3 of the plain fit's, the same iterations and
        the same winning attempt."""
        err = float((got[1] - ref[1]).abs().max())
        check(err <= 1e-3, f"K8 {name}: centres off by {err} > 1e-3")
        # the kernel's last pass against the plain version's AT THE KERNEL'S CENTRES: only the sum's order differs
        comp = max(rel_err(float(c), float(kmeans.lloyd_plain(data, cen, 0)[1])) for c, cen in zip(got[2], got[1]))
        check(comp <= 1e-5, f"K8 {name}: compactness off by {comp} > 1e-5 relative at its own centres")
        # against the plain fit's: before convergence a centre is not the mean of its final members, so the
        # centres' last digits (within 1e-3) move the compactness in first order
        loose = max(rel_err(float(a), float(b)) for a, b in zip(got[2], ref[2]))
        check(loose <= 1e-3, f"K8 {name}: compactness off the plain fit's by {loose} > 1e-3 relative")
        check(torch.equal(got[3], ref[3]), f"K8 {name}: iterations {got[3].tolist()} != {ref[3].tolist()}")
        check(float((got[0] - ref[0]).abs().max()) <= 1e-3, f"K8 {name}: another attempt won")
        return err, comp

    # --- the seeds and fits in one launch against kpp_init_plain + lloyd_fits_plain on both routes.  k = 8 on
    # eight separable blobs whose k-means++ seeds fall one a blob (where two seeds share a blob, the boundary between
    # them runs through dense rows and the last digits of a sum decide which rows a centre wins: that case is held
    # step by step below), and an empty cluster: four distinct rows repeated, k = 8
    def eight_blobs(n: int):
        g = np.random.default_rng(8)
        parts = [g.normal(c, 2.0, (n // 8, 3)) for c in pens.cpu().numpy()]
        return torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(dev)

    def four_rows(n: int):
        """Four distinct integer rows, repeated: every sum of them is exact, so every attempt's compactness is
        exactly 0 and the first attempt wins (an inexact mean would leave the expanded form's rounding to decide)."""
        return pens[[0, 2, 5, 7]].repeat(n // 4, 1).contiguous()

    worst, n_fused = (0.0, 0.0), 0
    for data_4, n in ((sample, KMEANS_SAMPLE), (wide, 250_000)):
        route = kernels.kpp_schedule(n)["route"]
        for label, data, k in (("poster", data_4, 1), ("poster", data_4, 4), ("eight blobs", eight_blobs(n), 8),
                               ("four distinct rows, empty clusters", four_rows(n), 8)):
            first, uniforms = kmeans.seed_stream(7, 3, k, n)
            draws = kmeans.seed_draws(first, uniforms).to(dev)
            for iters in (0, 1, 40):
                name = f"kmeans_fit {n} rows {route} {label} k={k} iters={iters}"
                got = kernels.kmeans_fit_cuda(data, draws, iters)
                best_idx = int(kernels.STATS["kmeans_fit"][2])
                again = kernels.kmeans_fit_cuda(data, draws, iters)
                check(all(torch.equal(x, y) for x, y in zip(got, again)), f"K8 {name}: two runs differ")
                ref = kmeans.kmeans_fit_plain(data, k, first, uniforms, iters)
                check(torch.equal(got[4], ref[4]), f"K8 {name}: picked {got[4].tolist()}, plain {ref[4].tolist()}")
                worst = tuple(max(x, y) for x, y in zip(worst, fit_checks(name, data, got, ref)))
                ref_idx = min(range(3), key=lambda a: (float(ref[2][a]), a))
                check(best_idx == ref_idx, f"K8 {name}: attempt {best_idx} won, plain {ref_idx}")
                if iters == 0:
                    check(torch.equal(got[1], data[got[4].long()]), f"K8 {name}: no iteration moved the seeds")
                if label.startswith("four"):  # the last four seeds repeat earlier ones: their clusters stay empty
                    check(torch.equal(got[1][:, 4:], data[got[4][:, 4:].long()]), f"K8 {name}: an empty cluster moved")
                n_fused += 1
    print(f"K8 kmeans_fit == kpp_init_plain + lloyd_fits_plain: {n_fused} cases at 200,000 rows (resident) and "
          f"250,000 (streamed), k = 1 and 4 on the poster, 8 on eight blobs and on four distinct rows (empty "
          f"clusters), iterations 0, 1 and 40; picks equal, centres within {worst[0]:.2e} (tolerance 1e-3), "
          f"compactness within {worst[1]:.2e} relative at its own centres (tolerance 1e-5), iterations and the "
          f"winning attempt equal, two runs bit-equal")

    # --- the fit alone from given seeds (the tools' kmeans): the same body
    def fit_case(name, data, inits, iters):
        got = kernels.lloyd_fit_cuda(data, inits, iters)
        again = kernels.lloyd_fit_cuda(data, inits, iters)
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"K8 lloyd_fit {name}: two runs differ")
        out = fit_checks(f"lloyd_fit {name}", data, got, kmeans.lloyd_fits_plain(data, inits, iters))
        stepwise_case(name, data, inits, iters, got)
        return out

    def stepwise_case(name, data, inits, iters, got, plain_steps: int = 0):
        """The fused loop against its own single-iteration launches with the
        stop test taken here in plain PyTorch: bit-equal centres and the same
        iteration count; the first ``plain_steps`` steps also against the
        plain version's step from the same centres, within 1e-4."""
        for a in range(inits.shape[0]):
            c, it = inits[a], 0
            while it < iters:
                new = kernels.lloyd_fit_cuda(data, c[None].contiguous(), 1)[1][0]
                if it < plain_steps:
                    step = float((new - kmeans.lloyd_plain(data, c, 1)[0]).abs().max())
                    check(step <= 1e-4, f"K8 lloyd_fit {name}: step {it} of attempt {a} off the plain step by {step}")
                move = new - c
                shift = float(torch.sqrt(kmeans._sum_cols(move * move)).max())
                c, it = new, it + 1
                if not shift > 0.5:
                    break
            check(torch.equal(c, got[1][a]) and it == int(got[3][a]),
                  f"K8 lloyd_fit {name}: attempt {a} ran {int(got[3][a])} iterations in one launch, {it} as single "
                  f"steps, or the centres differ")

    # k = 8 on eight separable blobs, seeded near them: where a boundary between two centres runs through dense
    # rows (eight centres on four tones, or two k-means++ seeds in one blob), the last digits of a sum decide which
    # rows a centre wins, and no tolerance on the centres survives 40 iterations that stop at a shift of 0.5.  That
    # case is held step by step instead (below).
    def blobs8(rows: int, extra: int):
        parts = [rng.normal(c, 5.0, (rows, 3)) for c in pens.cpu().numpy()] + [np.full((extra, 3), 7.0)]
        return torch.from_numpy(np.concatenate(parts).astype(np.float32)).to(dev)

    eight = {"200,000 x 3": blobs8(25_000, 0), "777 x 3": blobs8(97, 1), "250,000 x 3": blobs8(31_250, 0)}
    n_fit = 0
    for name, four in (("200,000 x 3", sample), ("777 x 3", small), ("250,000 x 3", wide)):
        for k in (1, 4, 8):
            data = eight[name] if k == 8 else four
            first, uniforms = kmeans.seed_stream(7, 3, k, data.shape[0])
            inits = kmeans.kpp_init(data, k, first, uniforms)[0]
            if k == 8:
                hard = (data, inits)
                inits = (pens[None] + torch.from_numpy(rng.normal(0, 3.0, (3, 8, 3)).astype(np.float32)).to(dev)).contiguous()
            for iters in (1, 40):
                worst = tuple(max(a, b) for a, b in zip(worst, fit_case(f"{name} k={k} iters={iters}", data, inits, iters)))
                n_fit += 1
        # two seeds in one blob: every step against the plain step, the loop against its own steps
        stepwise_case(f"{name} k=8 from k-means++ seeds", *hard, 40, kernels.lloyd_fit_cuda(*hard, 40), plain_steps=6)
        n_fit += 1
        # an init that leaves a cluster empty: the far centre keeps its place
        data = four
        inits = torch.stack([torch.cat([data[:3], torch.full((1, 3), -5000.0, device=dev)])] * 2)
        fit_case(f"{name} with an empty cluster", data, inits, 40)
        check(torch.equal(kernels.lloyd_fit_cuda(data, inits, 40)[1][0, 3], inits[0, 3]),
              f"K8 lloyd_fit {name}: an empty cluster moved")
        n_fit += 1
    print(f"K8 lloyd_fit == plain: {n_fit} cases at 200,000 x 3 and 777 x 3 (resident) and 250,000 x 3 (streamed), "
          f"k = 1, 4, 8, iters 1 and 40, an empty cluster; centres within {worst[0]:.2e} (tolerance 1e-3), "
          f"compactness within {worst[1]:.2e} relative (tolerance 1e-5), iterations and the winning attempt equal, "
          f"two runs bit-equal, the one-launch loop bit-equal to its own single steps, k = 8 from k-means++ seeds "
          f"step by step within 1e-4 of the plain step")
    del wide

    # K8 at the main path's shape: 3,000,000 pixels -> 200,000 rows, k = 4, 3 attempts, 40 iterations
    def draw():
        return kmeans.subsample_indices(42, n_px, KMEANS_SAMPLE, dev)

    stats["K8 subsample"] = {
        "max_abs_err": 0, "ms": cuda_ms(draw, 20),
        "plain_ms": cuda_ms(lambda: kmeans.subsample_indices_plain(42, n_px, KMEANS_SAMPLE, dev), 3),
        "alone_ms": profiled_ms(draw, "subsample", 20),
        **bound(4 * KMEANS_SAMPLE, n_px * DRAW_OPS_PER_KEY, INT32_OPS)}
    n, k, attempts = sample.shape[0], 4, 3
    first, uniforms = kmeans.seed_stream(42, attempts, k, n)
    draws_d, idx_d = kmeans.seed_draws(first, uniforms).to(dev), idx.to(dev)
    inits = kernels.kmeans_fit_cuda(sample, draws_d, 0)[1]
    fused = kernels.kmeans_fit_cuda(sample, draws_d, 40)
    torch.cuda.synchronize()
    passes = int(fused[3].sum()) + attempts  # every iteration and the last assignment
    err = float((fused[1] - kmeans.kmeans_fit_plain(sample, k, first, uniforms, 40)[1]).abs().max())
    px = poster.reshape(-1, 3)[idx_d.long()]
    stats["K8 lab_sample"] = {
        "max_abs_err": lab_err, "ms": cuda_ms(lambda: kernels.lab_sample_cuda(poster, idx_d), 20),
        "plain_ms": cuda_ms(lambda: bgr_to_lab_u8(poster.reshape(-1, 3)[idx_d.long()]), 5),
        "alone_ms": profiled_ms(lambda: kernels.lab_sample_cuda(poster, idx_d), "lab_sample", 20),
        **bound(n * (4 + 3 + 12), k7_flops(px, 0) + 3 * n * POWF_FLOPS, FP32_OPS)}
    stats["K8 kmeans_fit"] = {
        "max_abs_err": err, "ms": cuda_ms(lambda: kernels.kmeans_fit_cuda(sample, draws_d, 40), 10),
        "plain_ms": cuda_ms(lambda: kmeans.kmeans_fit_plain(sample, k, first, uniforms, 40), 1),
        "alone_ms": profiled_ms(lambda: kernels.kmeans_fit_cuda(sample, draws_d, 40), "kmeans_fit", 10),
        "passes": passes, "iterations": fused[3].tolist(), **kmeans_fit_bound(n, k, attempts, passes)}
    stats["K8 lloyd_fit"] = {
        "max_abs_err": worst[0], "ms": cuda_ms(lambda: kernels.lloyd_fit_cuda(sample, inits, 40), 10),
        "plain_ms": cuda_ms(lambda: kmeans.lloyd_fits_plain(sample, inits, 40), 1),
        "alone_ms": profiled_ms(lambda: kernels.lloyd_fit_cuda(sample, inits, 40), "lloyd_fit", 10),
        "passes": passes, **bound(12 * n + 24 * attempts * k, passes * n * k * LLOYD_FLOPS_PER_CENTER, FP32_OPS)}
    for key in ("K8 subsample", "K8 lab_sample", "K8 kmeans_fit", "K8 lloyd_fit"):
        st = stats[key]
        print(f"{key} at {n_px} -> {n} x 3, k = {k}, {attempts} attempts: {st['ms']:.4f} ms a call"
              + (f" ({st['alone_ms']:.4f} alone)" if st.get("alone_ms") else "")
              + f", plain PyTorch on the card {st['plain_ms']:.3f} ms, bound {st['bound_ms']:.5f} ms by {st['bound_by']}"
              + (f"; iterations {st['iterations']}, the sample scanned {passes} times" if "iterations" in st else ""))

    # --- the tools' k-means on the card: K8's fit and assignment, card vs CPU
    data = np.concatenate([rng.normal(c, 6.0, (12500, 3)) for c in POSTER_PALETTE]).astype(np.float32)
    kernels.reset_launches()
    got_c, got_l = kmeans.kmeans(data, 4, sample_limit=20_000)
    tool = dict(kernels.LAUNCHES)
    ref_c, ref_l = kmeans.kmeans(data, 4, sample_limit=20_000, device="cpu")
    check(np.abs(got_c - ref_c).max() <= 1e-3, f"kmeans(): card centres off by {np.abs(got_c - ref_c).max()}")
    d = np.sort(((data[:, None, :].astype(np.float64) - ref_c.astype(np.float64)) ** 2).sum(-1), axis=1)
    diff = got_l != ref_l
    check(not diff.any() or float((d[:, 1] - d[:, 0])[diff].max()) <= 1.0,
          f"kmeans(): {int(diff.sum())} labels differ between card and CPU beyond near ties")
    check(tool["lloyd_fit"] == 1 and tool["assign_points"] == 1, f"kmeans() on the card launched {tool}")
    data_d, cen_d = torch.from_numpy(data).to(dev), torch.from_numpy(got_c).to(dev)
    check(torch.equal(kernels.assign_points_cuda(data_d, cen_d), kmeans.assign_points_plain(data_d, cen_d)),
          "K8 assign_points != plain on the card")
    stats["K8 assign_points"] = {
        "max_abs_err": 0, "ms": cuda_ms(lambda: kernels.assign_points_cuda(data_d, cen_d), 20),
        "plain_ms": cuda_ms(lambda: kmeans.assign_points_plain(data_d, cen_d), 5),
        **bound(16 * len(data), len(data) * 4 * LLOYD_FLOPS_PER_CENTER, FP32_OPS)}
    print(f"ops.kmeans.kmeans on the card == on the CPU (centres within 1e-3, {int(diff.sum())} near-tie labels of "
          f"{len(data)}); launches {({n: c for n, c in tool.items() if c})}; K8 assign_points == plain, "
          f"{stats['K8 assign_points']['ms']:.4f} ms a call")

    # --- K7's counts
    for shape, cs in (((1500, 2000, 3), pens[:4]), ((37, 45, 3), pens), ((5, 33, 3), pens[:1]), ((1, 1, 3), pens[:3])):
        im = poster if shape[0] == 1500 else torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        counts = torch.full((len(cs),), -7, dtype=torch.int32, device=dev)
        boards = kernels.assign_boards_cuda(im, cs, counts)
        labels = kernels.assign_nearest_cuda(im, cs)
        check(torch.equal(counts, torch.bincount(labels.reshape(-1).long(), minlength=len(cs)).to(torch.int32))
              and torch.equal(boards, onehot_boards_plain(labels, len(cs))),
              f"K7 counts != the bincount of its labels, {shape} k={len(cs)}")
    c4 = pens[:4].contiguous()
    counts = torch.empty(4, dtype=torch.int32, device=dev)
    plain_boards, plain_counts = assign_boards_counts_plain(poster, c4, 4)
    flips = near_tie_flips(poster, c4.cpu().numpy(), kernels.assign_nearest_cuda(poster, c4),
                           assign_nearest_plain(poster, c4, 4), "K7 with counts vs plain, poster")
    kernels.assign_boards_cuda(poster, c4, counts)
    check(int((counts - plain_counts).abs().sum()) <= 2 * flips, "K7 counts differ from plain beyond the near ties")
    stats["K7 counts"] = {
        "max_abs_err": flips, "ms": cuda_ms(lambda: kernels.assign_boards_cuda(poster, c4, counts), 20),
        "plain_ms": cuda_ms(lambda: assign_boards_counts_plain(poster, c4, 4), 5),
        "alone_ms": profiled_ms(lambda: kernels.assign_boards_cuda(poster, c4, counts), "assign_nearest", 20),
        **bound(poster.numel() + plain_boards.numel() * 4 + 16, k7_flops(poster, 4), FP32_OPS)}
    st = stats["K7 counts"]
    print(f"K7 with counts == the bincount of its own labels on 4 shapes, k = 1, 3, 4, 8; at 1500x2000, k = 4: "
          f"{st['ms']:.4f} ms a call" + (f" ({st['alone_ms']:.4f} alone)" if st.get("alone_ms") else "")
          + f", plain {st['plain_ms']:.3f} ms, bound {st['bound_ms']:.5f} ms by {st['bound_by']}")

    # --- K11
    def gray(*shape):
        x = rng.integers(0, 256, shape).astype(np.float32)
        for axis in (-1, -2):
            x = (np.roll(x, 1, axis) + x + np.roll(x, -1, axis)) / 3
        return torch.from_numpy(np.clip(x * 1.6 - 70 + rng.integers(-20, 21, shape), 0, 255).astype(np.uint8)).to(dev)

    n_k11 = 0
    shapes = [(50, 70), (3, 20, 33), (2, 2, 9, 40), (1, 5), (4, 1), (33, 64), (100, 257), (7, 3)]
    for shape in shapes:
        x = gray(*shape)
        for src in (x, (x > 128).to(torch.uint8) * 255):
            for el in ("rect", "ellipse", "cross"):
                for ksize in (1, 2, 3, 5, 7, 31):
                    for program, iterations in (("e", 1), ("d", 2), ("ed", 1), ("de", 3), ("ed", 0)):
                        if ksize == 31 and (iterations > 1 or shape not in shapes[:3] + shapes[-1:]):
                            continue  # 961 taps: the plain version is slow, a few shapes do
                        steps = morphology.morph_program(el, ksize, iterations, program)
                        got = kernels.morph_dense_cuda(src, steps)
                        check(torch.equal(got, morphology.morph_dense_plain(src, steps)),
                              f"K11 {shape} {el} {ksize} {program} x{iterations}")
                        check((got is src) == (not steps), "K11: an empty list returns its input, else a new tensor")
                        n_k11 += 1
    x = gray(60, 90)
    for name, fn in (("erode", morphology.erode), ("dilate", morphology.dilate), ("morph_open", morphology.morph_open),
                     ("morph_close", morphology.morph_close)):
        check(torch.equal(fn(x, "ellipse", 5, 2), fn(x.cpu(), "ellipse", 5, 2).to(dev)), f"K11 through {name}")
    binary = (x > 128).to(torch.uint8) * 255
    check(torch.equal(morphology.morph_binary_packed(binary, "rect", 3, 1, "ed"),
                      morphology.morph_plain(binary, "rect", 3, 1, "ed")), "morph_binary_packed (K1, K2, K1) != K11's plain")
    # lists longer than one launch: by the halo cap, by the parameter block's room, and a step alone
    launches = []
    for long_list in (morphology.morph_program("rect", 3, kernels.DENSE_HALO_CAP + 2, "ed"),
                      morphology.morph_program("cross", 1, kernels.DENSE_MAX_STEPS // 2 + 4, "ed"),
                      morphology.morph_program("ellipse", 5, 3, "ed") + (("rect", 31, "d"),)):
        want = len(kernels.dense_morph_schedule(kernels.dense_morph_sizes(long_list)))
        before = kernels.LAUNCHES["morph_dense"]
        got = kernels.morph_dense_cuda(x, long_list)
        took = kernels.LAUNCHES["morph_dense"] - before
        check(took == want > 1 and torch.equal(got, morphology.morph_dense_plain(x, long_list)),
              f"K11: {len(long_list)} steps took {took} launches (expected {want} > 1) or != plain")
        launches.append(took)
        n_k11 += 1
    big = gray(*CHAIN_SHAPE)
    big_bin = (big > 128).to(torch.uint8) * 255
    swatch = morphology.morph_program("rect", 3, 1, "ed") + morphology.morph_program("rect", 3, 1, "de")
    for src in (big, big_bin):
        for el, ksize, program, iterations in (("rect", 3, "ed", 1), ("rect", 3, "de", 1), ("ellipse", 5, "ed", 2),
                                               ("cross", 7, "d", 1)):
            steps = morphology.morph_program(el, ksize, iterations, program)
            check(torch.equal(kernels.morph_dense_cuda(src, steps), morphology.morph_dense_plain(src, steps)),
                  f"K11 {CHAIN_SHAPE} {el} {ksize} {program} x{iterations}")
            n_k11 += 1
        # widths that are not multiples of 16 (the byte route), an odd offset (16-byte rows, a misaligned base)
        for cut in (src[:, :, :1999], src[:, :777, 3:1014], src.flatten()[5:5 + 2 * 1500 * 1984].view(2, 1500, 1984)):
            cut = cut.contiguous()
            for steps in (swatch, morphology.morph_program("ellipse", 5, 2, "ed")):
                check(torch.equal(kernels.morph_dense_cuda(cut, steps), morphology.morph_dense_plain(cut, steps)),
                      f"K11 {tuple(cut.shape)} at offset {cut.storage_offset()} {steps[0]} x{len(steps)}")
                n_k11 += 1
    # the swatch path's call: the four masks stacked, opened and closed in one launch of four steps
    before = kernels.LAUNCHES["morph_dense"]
    got = kernels.morph_dense_cuda(big_bin, swatch)
    check(kernels.LAUNCHES["morph_dense"] - before == 1 and torch.equal(got, morphology.morph_dense_plain(big_bin, swatch)),
          "K11: the stacked swatch call != plain or not one launch")
    n_k11 += 1
    mask = big_bin[0].contiguous()

    def swatch_call(m=big_bin):
        return morphology.morph_dense(m, swatch)

    def swatch_plain(m=big_bin):
        return morphology.morph_dense_plain(m, swatch)

    def swatch_pool(m=big_bin):  # the one case a library call covers: a rect element is a max pooling
        import torch.nn.functional as F

        t = m.to(torch.float16)[:, None]
        t = F.max_pool2d(-F.max_pool2d(-t, 3, 1, 1), 3, 1, 1)
        t = -F.max_pool2d(-F.max_pool2d(t, 3, 1, 1), 3, 1, 1)
        return t[:, 0].to(torch.uint8)

    check(torch.equal(swatch_call(), swatch_plain()) and torch.equal(swatch_call(), swatch_pool()),
          "K11 swatch call at 4x1500x2000 != plain or != max_pool2d")
    # the kernel alone and the trace's check of its launches from one profiler session (a long process has
    # lost every event of its later sessions; phase_k11_ab times one mask alone)
    trace = only_own_kernels(swatch_call, "swatch mode's open and close, four masks", {"morph_runs": 1},
                             timed="morph_runs", calls=21)
    stats["K11 trace"] = trace["kernels"]
    stats["K11"] = {"max_abs_err": 0, "ms": cuda_ms(swatch_call, 20), "plain_ms": cuda_ms(swatch_plain, 5),
                    "alone_ms": trace["alone_ms"], **k11_bound(big_bin.numel(), swatch)}
    stats["K11"]["library_ms"] = cuda_ms(swatch_pool, 10)
    one = {**k11_bound(mask.numel(), swatch), "ms": cuda_ms(lambda: swatch_call(mask), 20),
           "library_ms": cuda_ms(lambda: swatch_pool(mask[None]), 10)}
    stats["K11 one mask"] = one
    st = stats["K11"]
    print(f"K11 == plain: {n_k11} (shape, element, ksize, program, iterations) cases on {len(shapes)} shapes and "
          f"{CHAIN_SHAPE}, gray and binary, ksize 1, 2, 3, 5, 7, 31, through erode/dilate/morph_open/morph_close, "
          f"lists of {launches} launches, widths 1999, 1011 and 1984 at an odd offset, the stacked swatch call")
    for what, r in (("4x1500x2000, the swatch call (one launch of four steps)", st),
                    ("one 1500x2000 mask, open then close (one launch)", one)):
        print(f"K11 at {what}: {r['ms']:.4f} ms a call" + (f" ({r['alone_ms']:.4f} alone)" if r.get("alone_ms") else "")
              + (f", plain {r['plain_ms']:.3f} ms" if "plain_ms" in r else "")
              + f", max_pool2d (float16, conversions included) {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms by "
              f"{r['bound_by']}" + (f", {100 * r['bound_ms'] / r['alone_ms']:.1f} % of it alone" if r.get("alone_ms") else ""))
    return tool


def mask_iou(a: Path, b: Path, names) -> dict:
    import cv2
    import numpy as np

    out = {}
    for n in names:
        x, y = cv2.imread(str(a / n / "mask.png"), 0) > 0, cv2.imread(str(b / n / "mask.png"), 0) > 0
        out[n] = float((x & y).sum() / max(1, (x | y).sum()))
    return out


def decodes(run: Path) -> int:
    from plotweave_torch.stream.decoder import StreamDecoder, replay

    data = (run / "plot_stream.bin").read_bytes()
    dec = StreamDecoder(data)
    replay(dec, *json.loads((run / "vector_manifest.json").read_text())["image_size"])
    check(dec.stats.eof_seen and dec.stats.off_canvas_steps == 0, f"{run.name}: plot_stream.bin does not decode cleanly")
    return len(data)


def phase_device_kmeans_path(work: Path, stats: dict) -> dict:
    """``kmeans_init: "device"`` through the CLI on the synthetic poster, card
    and cpu, against the host-exact run of phase 5."""
    import torch

    from plotweave_torch.config import PipelineConfig
    from plotweave_torch.ops import kernels
    from plotweave_torch.stages.s02_color_extract import device_init_stage

    names = list(PipelineConfig().color_names)
    image = str(work / "synthetic.png")
    kernels.reset_launches()
    t0 = time.perf_counter()
    times = run_main(image, work / "devk_cuda", "auto", settings={"kmeans_init": "device"})
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check({n: c for n, c in counts.items() if c} == DEVICE_KMEANS_LAUNCHES,
          f"device-k-means path: launches {counts}, expected {DEVICE_KMEANS_LAUNCHES}")
    times_cpu = run_main(image, work / "devk_cpu", "cpu", settings={"kmeans_init": "device"})
    exact = mask_iou(work / "devk_cuda", work / "synthetic_cuda", names)
    cross = mask_iou(work / "devk_cuda", work / "devk_cpu", names)
    check(min(exact.values()) >= 0.98, f"device k-means vs host-exact: mask IoU {exact} < 0.98")
    check(min(cross.values()) >= 0.99, f"device k-means, card vs cpu: mask IoU {cross} < 0.99")
    size = decodes(work / "devk_cuda")
    decodes(work / "devk_cpu")
    equal_masks = all((work / "devk_cuda" / n / "mask.png").read_bytes() == (work / "devk_cpu" / n / "mask.png").read_bytes()
                      for n in names)
    if equal_masks:
        diff = same_artifacts(work / "devk_cuda", work / "devk_cpu", names)
        check(not diff, f"device k-means: equal masks, but card run != cpu run: {diff}")
    print(f"device-k-means path, synthetic 2000x1500: mask IoU vs host-exact {min(exact.values()):.4f}, card vs cpu "
          f"{min(cross.values()):.4f} (masks {'equal: every artifact byte-equal' if equal_masks else 'differ at near ties'}); "
          f"stream {size} bytes, decodes to EOF; launches {({n: c for n, c in counts.items() if c})}; wall {wall:.2f} s, "
          f"stage 02 {times['s02_color_extract']:.3f} s on the card, {times_cpu['s02_color_extract']:.3f} s on the cpu")
    poster = torch.from_numpy(synthetic_image(2, 1500, 2000)[0]).to("cuda")

    def stage():
        return device_init_stage(poster, 4, 40, 3, KMEANS_SAMPLE, 42, True, *EDGE_PARAMS)

    stats["device-kmeans trace"] = only_own_kernels(
        stage, "device_init_stage 2000x1500, fused, one call",
        {"subsample": 1, "lab_sample": 1, "kmeans_fit": 1, "assign_nearest": 1, "morph_steps": 2,
         "edge_tiles": 1, "hysteresis_cluster": 1, "zs_cluster": 1})
    stats["device-kmeans stage ms"] = cuda_ms(stage, 5)
    print(f"device_init_stage 2000x1500, fused: {stats['device-kmeans stage ms']:.3f} ms a call (CUDA events; the "
          f"subsample drawn on the card, only the seeds' random numbers uploaded)")
    return counts


def phase_swatch_path(work: Path) -> dict:
    """``extraction_mode: "swatch"`` through the CLI on the synthetic poster
    with its four generating colours, card and cpu."""
    from plotweave_torch.config import PipelineConfig
    from plotweave_torch.ops import kernels

    names = list(PipelineConfig().color_names)
    image = str(work / "synthetic.png")
    settings = {"extraction_mode": "swatch", "colors": POSTER_PALETTE, "color_names": names}
    kernels.reset_launches()
    times = run_main(image, work / "swatch_cuda", "auto", settings=settings)
    counts = dict(kernels.LAUNCHES)
    check(counts["morph_dense"] == 1, f"swatch path: K11 launched {counts['morph_dense']} times, expected one for "
          f"the {len(names)} masks: {counts}")
    run_main(image, work / "swatch_cpu", "cpu", settings=settings)
    diff = same_artifacts(work / "swatch_cuda", work / "swatch_cpu", names)
    check(not diff, f"swatch path: card run != cpu run: {diff}")
    check(not (work / "swatch_cuda" / "palette_by_name.json").exists(), "swatch mode wrote a palette")
    size = decodes(work / "swatch_cuda")
    iou = mask_iou(work / "swatch_cuda", work / "synthetic_cuda", sorted(names))
    print(f"swatch path, synthetic 2000x1500: card == cpu on every artifact ({size} stream bytes, decodes to EOF); "
          f"launches {({n: c for n, c in counts.items() if c})}; stage 02 {times['s02_color_extract']:.3f} s; mask IoU "
          f"against the k-means run, layer by layer: {({n: round(v, 3) for n, v in iou.items()})}")
    return counts


def phase_batch_path(work: Path, stats: dict) -> None:
    """``run_pipeline_batch`` over 8 images of 2000 x 1500 and 2 of another
    shape, steps 1-4, against sequential runs; one grouped chain call of 8
    images against the solo calls."""
    import cv2
    import numpy as np
    import torch

    from plotweave_torch.config import load_config
    from plotweave_torch.ops import kernels
    from plotweave_torch.pipeline import run_pipeline, run_pipeline_batch
    from plotweave_torch.stages.s02_color_extract import chain_blob_batch, chain_from_clean

    images = []
    for i in range(10):
        h, w = (1500, 2000) if i < 8 else (1200, 1600)
        path = work / f"batch{i}.png"
        cv2.imwrite(str(path), synthetic_image(100 + i, h, w)[0])
        images.append(path)

    def build(tag: str):
        cfgs = []
        for i, img in enumerate(images):
            out = work / tag / f"run{i}"
            out.mkdir(parents=True)
            (out / "config.json").write_text(json.dumps({"input_image": str(img), "output_dir": str(out)}))
            cfgs.append(load_config(str(out / "config.json")))
        return cfgs

    seq, par = build("batch_seq"), build("batch_par")
    with open(work / "batch.log", "w") as log, contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        for c in seq:
            run_pipeline(c, 1, 4)
        seq_s = time.perf_counter() - t0
        kernels.reset_launches()
        t0 = time.perf_counter()
        times = run_pipeline_batch(par, 1, 4, workers=4)
        par_s = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    check(all(t > 0 for t in times), f"batch path: an image failed: {times}")
    text = (work / "batch.log").read_text()
    import re

    m = re.search(r"grouped: (\d+) image chain\(s\) in (\d+) grouped call", text)
    check(m is not None and int(m.group(1)) == len(images), "batch path: not every image's chain went through the batcher")
    groups = int(m.group(2))
    check(groups < len(images), f"batch path: {groups} grouped calls for {len(images)} images")
    check(counts["morph_bits"] == counts["edge_candidates"] == counts["hysteresis"] == counts["zhang_suen_packed"]
          == groups, f"batch path: {groups} grouped calls, launches {counts}")
    names = list(seq[0].color_names)
    for a, b in zip(seq, par):
        diff = same_artifacts(Path(a.output_dir), Path(b.output_dir), names, stream=False)
        check(not diff, f"batch path: {Path(b.output_dir).name} != its sequential run: {diff}")
    print(f"batch path: {len(images)} images (8 of 2000x1500, 2 of 1600x1200), steps 1-4, 4 workers: every mask, "
          f"edges and contours file == the sequential runs; {len(images)} chains in {groups} grouped calls; launches "
          f"{({n: c for n, c in counts.items() if c})}; wall {par_s:.2f} s against {seq_s:.2f} s sequential")

    # one group of 8 at full width: B k = 32 layers, 32 clusters of 16 CTAs for K5 and K6
    packed = np.stack([np.packbits(np.stack([cv2.imread(str(Path(c.output_dir) / n / "mask.png"), 0) > 0
                                             for n in names]), axis=-1) for c in seq[:8]])
    w = 2000
    kernels.reset_launches()
    got = chain_blob_batch(packed, w, *EDGE_PARAMS, device=torch.device("cuda"))
    torch.cuda.synchronize()
    group = {n: c for n, c in kernels.LAUNCHES.items() if c}
    check(group == CHAIN_LAUNCHES, f"a grouped chain call of 8 launched {group}, expected {CHAIN_LAUNCHES}")
    for b in range(8):
        check(torch.equal(got[b], chain_from_clean(packed[b], w, *EDGE_PARAMS, device=torch.device("cuda"))),
              f"grouped chain call: row {b} != the solo call's blob")
    check(torch.equal(got[:2].cpu(), chain_blob_batch(packed[:2], w, *EDGE_PARAMS, device=torch.device("cpu"))),
          "grouped chain call: card != CPU")
    group_ms = cuda_ms(lambda: chain_blob_batch(packed, w, *EDGE_PARAMS, device=torch.device("cuda")), 5)
    solo_ms = sum(cuda_ms(lambda b=b: chain_from_clean(packed[b], w, *EDGE_PARAMS, device=torch.device("cuda")), 5)
                  for b in range(8))
    stats["batch"] = {"group_ms": group_ms, "solo_sum_ms": solo_ms, "groups": groups, "images": len(images)}
    print(f"grouped chain call, 8 x 4 x 1500 x 2000 (32 layers): every row == its solo call == the CPU; launches "
          f"{group}; {group_ms:.3f} ms a call against {solo_ms:.3f} ms for the 8 solo calls (CUDA events, uploads "
          f"included)")


# --- phases 12 and 13: stage 07's device planner (K9) and stage 12's device refiner (K10) --------------------------

TOUR_SIDE = 2000  # px: integer coordinates below it, as a poster's contours have
REFINE_CAP = 256  # moves: the budget of the K10 vs plain checks at n >= 2,000
QUALITY_OBJECTS = 2000  # discs and rings of the dot-field poster
SFU_OPS = 132 * 16 * 1.98e9  # square roots a second: 16 a clock on each of 132 SMs
K9_FLOPS_PER_POINT = 10  # two squared distances (2 differences, 2 squares, 1 add each)
K10_FLOPS_PER_DIST = 5  # a distance's differences, squares and sum
K10_FLOPS_PER_CANDIDATE = 3  # a delta's three adds


def tour_points(rng, n: int, ties: bool = True, integer: bool = True):
    """Seeded contour ends (starts, ends (n, 2) float32, closed (n,) bool):
    integers below TOUR_SIDE, or floats where ``integer`` is false; with
    ``ties`` a third of the points repeat others and every fifth contour is
    mirrored around the first end (d²(start) == d²(end) from there)."""
    import numpy as np

    if integer:
        s = rng.integers(0, TOUR_SIDE, (n, 2)).astype(np.float32)
        e = rng.integers(0, TOUR_SIDE, (n, 2)).astype(np.float32)
    else:
        s = rng.uniform(0, 2 * TOUR_SIDE, (n, 2)).astype(np.float32)
        e = rng.uniform(0, 2 * TOUR_SIDE, (n, 2)).astype(np.float32)
    closed = rng.random(n) < 0.3
    if ties and n > 2:
        k = n // 3
        s[-k:], e[-k:] = s[:k], e[:k]
        d = rng.integers(1, 40, (len(range(1, n, 5)), 2)).astype(np.float32)
        s[1::5], e[1::5] = e[0] + d, e[0] - d
    return s, e, closed


def tour_length64(E, X, start=(0.0, 0.0)) -> float:
    """Pen-up travel of a tour of entries and exits, in float64."""
    import numpy as np

    E, X = np.asarray(E, np.float64), np.asarray(X, np.float64)
    prev = np.vstack([np.asarray(start, np.float64)[None], X[:-1]])
    return float(np.sqrt(((E - prev) ** 2).sum(1)).sum())


def applied(E, X, perm, flip):
    """The tour ``perm``/``flip`` make of entries ``E`` and exits ``X``."""
    import numpy as np

    perm, flip = np.asarray(perm), np.asarray(flip, bool)[:, None]
    return np.where(flip, X[perm], E[perm]), np.where(flip, E[perm], X[perm])


def k9_bound(n: int) -> dict:
    """K9's least time: n (16 + 1) bytes in, n (4 + 1) out; the d² of every
    unused point at every step, n (n - 1) / 2 of them, in float32."""
    return bound(22 * n, K9_FLOPS_PER_POINT * n * (n - 1) / 2, FP32_OPS)


def k10_sqrts(n: int) -> int:
    """The distinct distances, a square root each, that one iteration of the
    refiner over n ops needs: every entry-exit pair (n^2), every unordered
    exit-exit and entry-entry pair once (n(n - 1)/2 each; d is symmetric bit
    for bit) and the start's 2n.  (K10 computes four a (row, column), about
    twice this.)"""
    return 2 * n * n + n


def k10_bound(n: int, iterations: int) -> dict:
    """K10's least time: the distances its iterations need at the SFU's rate,
    or their float operations and the candidates' adds (2-opt n(n + 1)/2,
    each relocate family n(n - 1)) at the float32 rate, or its bytes (21 an
    op), whichever is larger: the SFU's at every n."""
    sqrts = iterations * k10_sqrts(n)
    flops = sqrts * K10_FLOPS_PER_DIST + iterations * K10_FLOPS_PER_CANDIDATE * (n * (n + 1) // 2 + 2 * n * (n - 1))
    out = bound(21 * n, sqrts, SFU_OPS)
    if flops / FP32_OPS * 1e3 > out["bound_ms"]:
        out = bound(21 * n, flops, FP32_OPS)
    return out


def k10_iterations(n: int, ms: float, moves: int) -> dict:
    """K10's microseconds an iteration (``moves`` + 1 iterations in ``ms``),
    its bound an iteration and its share of it."""
    b = k10_bound(n, moves + 1)
    return {"n": n, "moves": moves, "ms": ms, "us_per_iteration": ms * 1e3 / (moves + 1),
            "bound_us_per_iteration": b["bound_ms"] * 1e3 / (moves + 1), "bound_by": b["bound_by"],
            "share": b["bound_ms"] / ms}


def k10_iterations_line(rows) -> str:
    return "; ".join(f"n = {r['n']}: {r['ms']:.3f} ms a call, {r['moves']} moves, {r['us_per_iteration']:.2f} us an "
                     f"iteration, bound {r['bound_us_per_iteration']:.2f} us ({r['bound_by']}), "
                     f"{100 * r['share']:.1f} % of it" for r in rows)


def refine_cases(stats: dict, rng) -> None:
    """Phase 12's K10 part: K10 against its plain version at n = 3 to 8,192,
    each twice bit-equal, one CTA an SM at 8,192 ops, one full run at 8,192
    on a greedy tour, and its microseconds an iteration at 600, 2,000 and
    8,192 ops (CUDA events) beside its bound."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.vector.refine_device import refine_order_plain

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = kernels.load("refine_tour").pw_refine_blocks(kernels.REFINE_MAX_N)
    check(blocks == sms, f"K10: {blocks} CTAs of 8,192 ops fit the card, not one on each of its {sms} SMs")
    t0 = time.perf_counter()
    cases, timed_cases = [], {}
    for n, kind in ((3, "int"), (4, "int"), (64, "int"), (600, "int"), (600, "float"), (2000, "greedy"),
                    (2000, "float"), (kernels.REFINE_MAX_N, "greedy")):
        s, e, closed = tour_points(rng, n, ties=kind != "float", integer=kind != "float")
        if kind == "greedy":  # the tour stage 07's planner would give these ends
            S, E, C = (torch.from_numpy(a).to(dev) for a in (s, e, closed))
            order, flips = (t.cpu().numpy() for t in kernels.greedy_order_cuda(S, E, C, False, 0))
            s, e = applied(s, e, order, flips)
        Ed, Xd = torch.from_numpy(np.ascontiguousarray(s)).to(dev), torch.from_numpy(np.ascontiguousarray(e)).to(dev)
        cap = REFINE_CAP if n >= 2000 else max(4096, 4 * n)
        got = [t.cpu() for t in kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), cap)]
        again = [t.cpu() for t in kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), cap)]
        check(all(torch.equal(a, b) for a, b in zip(got, again)), f"K10 n={n} {kind}: two runs differ")
        perm, flip, moves = refine_order_plain(Ed, Xd, torch.zeros(2, device=dev), cap)
        check(torch.equal(got[0], perm.cpu()) and torch.equal(got[1], flip.cpu()) and int(got[2]) == moves,
              f"K10 n={n} {kind} max_moves={cap}: {int(got[2])} moves, plain {moves}, or perm/flip differ")
        cases.append(f"{n} {kind}: {moves} moves" + (" (capped)" if moves == cap else ""))
        if (n, kind) in ((600, "int"), (2000, "greedy")):
            timed_cases[n] = (Ed, Xd, cap, moves)
    print(f"K10 == its plain version on the card (perm, flip and moves; max_moves {REFINE_CAP} at n >= 2,000), each "
          f"twice bit-equal: {'; '.join(cases)} ({time.perf_counter() - t0:.1f} s); one CTA on each of the {sms} SMs "
          f"at {kernels.REFINE_MAX_N} ops")

    # one full run on a greedy tour of the largest size
    n = kernels.REFINE_MAX_N
    s, e, closed = tour_points(rng, n)
    S, E, C = (torch.from_numpy(a).to(dev) for a in (s, e, closed))
    order, flips = (t.cpu().numpy() for t in kernels.greedy_order_cuda(S, E, C, False, 0))
    s, e = applied(s, e, order, flips)
    Ed, Xd = torch.from_numpy(np.ascontiguousarray(s)).to(dev), torch.from_numpy(np.ascontiguousarray(e)).to(dev)
    budget = max(4096, 4 * n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm, flip, moves = kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), budget)
    moves = int(moves.item())
    full_s = time.perf_counter() - t0
    perm, flip = perm.cpu().numpy(), flip.cpu().numpy()
    check(sorted(perm.tolist()) == list(range(n)), "K10 full run: perm is not a permutation")
    before, after = tour_length64(s, e), tour_length64(*applied(s, e, perm, flip))
    check(after <= before, f"K10 full run: the tour grew from {before:.1f} to {after:.1f}")
    stats["K10 full"] = {"n": n, "moves": moves, "s": full_s, "before": before, "after": after,
                         **k10_bound(n, moves + 1)}
    print(f"K10 full run, n = {n} on a greedy tour, max_moves {budget}: {moves} moves in {full_s:.3f} s (host clock "
          f"around one call), {full_s / (moves + 1) * 1e6:.1f} us an iteration; travel {before:.0f} -> {after:.0f} px "
          f"(float64); bound {stats['K10 full']['bound_ms']:.2f} ms by {stats['K10 full']['bound_by']}")
    timed_cases[n] = (Ed, Xd, budget, moves)
    rows = [k10_iterations(n, cuda_ms(lambda: kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), cap), 1 if n > 2000 else 3),
                           moves) for n, (Ed, Xd, cap, moves) in timed_cases.items()]
    stats["K10 iterations"] = rows
    print("K10 an iteration (CUDA events around whole calls): " + k10_iterations_line(rows))


def phase_tour_kernels(stats: dict) -> None:
    """Phase 12: K9 against its plain version and the port's host C++
    planner (on four threads, held to K9 at the end), on both routes; K10
    against its plain version."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.vector.planner_device import greedy_order_plain
    from plotweave_torch.vector.sort import _greedy_order_native

    dev = torch.device("cuda")
    rng = np.random.default_rng(12)
    t0 = time.perf_counter()
    m = kernels.GREEDY_CTA_MAX_N
    n_k9, n_plain, step_us, host_jobs = 0, 0, {}, []
    zeros = np.zeros((2, 2), np.float32)
    _greedy_order_native(zeros, zeros, np.zeros(2, bool), True, 0)  # loads the native library before the threads
    # the host planner is O(n^2), some 30 s at 65,536: it releases the GIL, so its calls run on four threads beside
    # the card's work, the largest first, and are held to K9 at the end of the phase
    pool = ThreadPoolExecutor(4)
    for n in (kernels.GREEDY_MAX_N, 20000, m + 1, m, 13000, 4500, 1000, 3, 2):
        for closed_aware in (True, False):
            s, e, closed = tour_points(rng, n)
            seed = int(rng.integers(0, n))
            S, E, C = (torch.from_numpy(a).to(dev) for a in (s, e, closed))
            route = kernels.greedy_route(n)
            what = f"K9 n={n} closed_aware={closed_aware} ({route})"
            host = None
            if n < kernels.GREEDY_MAX_N or closed_aware:  # 65,536 takes the host planner once
                host = pool.submit(_greedy_order_native, s, e, closed, closed_aware, seed)
            got = [t.tolist() for t in kernels.greedy_order_cuda(S, E, C, closed_aware, seed)]
            again = [t.tolist() for t in kernels.greedy_order_cuda(S, E, C, closed_aware, seed)]
            check(got == again, f"{what}: two runs differ")
            if host is not None:
                host_jobs.append((what, host, got))
            if n <= 4500:  # the plain version is n - 1 steps of some 25 launches, 0.45 ms a step
                plain = [t.tolist() for t in greedy_order_plain(S, E, C, closed_aware, seed)]
                check(got == plain, f"{what} != its plain version")
                n_plain += 1
            if n in (4500, m):  # the one-CTA route where the cluster is the default, up to its limit
                other = [t.tolist() for t in kernels.greedy_order_cuda(S, E, C, closed_aware, seed, route="cta")]
                check(other == got, f"K9 n={n}: the one-CTA route != the cluster route")
            check(sorted(got[0]) == list(range(n)), f"K9 n={n}: the order is not a permutation")
            if closed_aware and n in (m, m + 1, kernels.GREEDY_MAX_N):  # each route at its limits
                for r in ("cta", "cluster") if n == m else (route,):
                    step_us[f"{n} {r}"] = cuda_ms(lambda: kernels.greedy_order_cuda(S, E, C, True, seed, route=r),
                                                  2) / n * 1e3
            n_k9 += 1
    for n in (20000, 5000):  # float coordinates: an FMA would flip ulps of d² here
        for closed_aware in (True, False):
            s, e, closed = tour_points(rng, n, ties=False, integer=False)
            S, E, C = (torch.from_numpy(a).to(dev) for a in (s, e, closed))
            host_jobs.append((f"K9 n={n} float coordinates, closed_aware={closed_aware}",
                              pool.submit(_greedy_order_native, s, e, closed, closed_aware, 1),
                              [t.tolist() for t in kernels.greedy_order_cuda(S, E, C, closed_aware, 1)]))
            n_k9 += 1
    k9_s = time.perf_counter() - t0

    refine_cases(stats, rng)

    t0 = time.perf_counter()
    for what, job, got in host_jobs:
        host = job.result()
        check(host is not None and got == list(host), f"{what} != the host C++ planner")
    pool.shutdown()
    wait_s = time.perf_counter() - t0
    print(f"K9 on {n_k9} cases, == the host C++ planner on {len(host_jobs)} (n = 2 to {kernels.GREEDY_MAX_N}, one-CTA "
          f"route below {kernels.GREEDY_CLUSTER_MIN_N}, cluster from there; integer coordinates with duplicates and "
          f"d2s == d2e ties, float coordinates at 5,000 and 20,000; closed-aware on and off), == its plain version on "
          f"{n_plain}, each twice bit-equal, the one-CTA route == the cluster route at 4,500 and {m} "
          f"({k9_s:.1f} s on the card's side, then {wait_s:.1f} s waiting "
          f"for the host planner's threads); microseconds a step (CUDA events): "
          + ", ".join(f"n = {k} {v:.3f}" for k, v in step_us.items()))
    stats["K9 steps"] = step_us


K10_AB_SIZES = (600, 1214, 2000, 8192)  # ops: a short list, the quality poster's largest, phase 12's, the largest
K10_PHASES = ("candidates", "CTA minima", "grid barrier", "grid minima", "move", "prologue")


def k10_tours():
    """(n, entries, exits, move budget) on the card for each of K10_AB_SIZES:
    a seeded greedy tour (K9) and the full budget."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels

    rng, dev = np.random.default_rng(1214), torch.device("cuda")
    for n in K10_AB_SIZES:
        s, e, closed = tour_points(rng, n)
        S, E, C = (torch.from_numpy(a).to(dev) for a in (s, e, closed))
        order, flips = (t.cpu().numpy() for t in kernels.greedy_order_cuda(S, E, C, False, 0))
        s, e = applied(s, e, order, flips)
        yield (n, torch.from_numpy(np.ascontiguousarray(s)).to(dev), torch.from_numpy(np.ascontiguousarray(e)).to(dev),
               max(4096, 4 * n))


def k10_times() -> dict:
    """K10 of the checkout that ``ROOT`` names, through that checkout's own
    ``kernels.refine_order_cuda`` (whatever C interface lies behind it), on
    :func:`k10_tours`: per size the moves, a digest of perm and flips, ms a
    call (CUDA events around whole calls) and alone (``torch.profiler``).
    Run after ``phase_probe``."""
    import hashlib

    from plotweave_torch.ops import kernels

    out = {}
    for n, Ed, Xd, budget in k10_tours():
        def call(Ed=Ed, Xd=Xd, budget=budget):
            return kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), budget)

        perm, flip, moves = (t.cpu() for t in call())
        digest = hashlib.sha256(perm.numpy().tobytes() + flip.numpy().tobytes()).hexdigest()
        out[n] = {"moves": int(moves), "digest": digest, "ms": cuda_ms(call, 2 if n > 2000 else 10),
                  "alone_ms": profiled_ms(call, "refine_tour", 2)}
    return out


def ab_turns(other: str, times: str, what: str) -> dict:
    """{"other": [...], "this": [...]}: what this module's ``times`` function
    returns for the checkout at ``other`` and for this one, in turns other,
    this, this, other, each in a process of its own with ``ROOT`` set to its
    checkout, so that each runs that checkout's own wrapper."""
    runs = {"other": [], "this": []}
    for key, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        root = str(Path(root).resolve())
        child = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import json; "
                                f"from pathlib import Path; import chip_smoke as c; c.ROOT = Path({root!r}); "
                                f"c.phase_probe(); print(json.dumps(c.{times}()))"],
                               capture_output=True, text=True, timeout=900, cwd=root)
        check(child.returncode == 0, f"{what} A/B: the run of {root} failed:\n{child.stdout[-3000:]}{child.stderr[-3000:]}")
        runs[key].append(json.loads(child.stdout.splitlines()[-1]))
    return runs


def phase_k10_ab(other: str) -> dict:
    """K10 of this checkout against the one at ``other`` (another commit's:
    ``git archive <rev> | tar -x -C .checkout/other``), in turns other, this,
    this, other, each in a process of its own that runs :func:`k10_times`
    with ``ROOT`` set to its checkout: both must give the same moves, perm
    and flips at every size; per size ms a call, alone, microseconds an
    iteration, the bound and the share."""
    runs = ab_turns(other, "k10_times", "K10")
    result = {}
    for n in K10_AB_SIZES:
        rows = {k: [r[str(n)] for r in v] for k, v in runs.items()}
        seen = {(r["moves"], r["digest"]) for v in rows.values() for r in v}
        check(len(seen) == 1, f"K10 A/B n={n}: the two checkouts differ (moves, digest): {sorted(seen)}")
        moves = rows["this"][0]["moves"]
        b = k10_bound(n, moves + 1)
        row = {"n": n, "moves": moves, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        for k, v in rows.items():
            ms = [r["ms"] for r in v]
            row[k] = {"ms": ms, "alone_ms": [r["alone_ms"] for r in v],
                      "us_per_iteration": [m * 1e3 / (moves + 1) for m in ms], "share": [b["bound_ms"] / m for m in ms]}
        result[n] = row
        print(f"K10 A/B n = {n}, {moves} moves, bound {b['bound_ms']:.4f} ms ({b['bound_ms'] * 1e3 / (moves + 1):.3f} us "
              f"an iteration, {b['bound_by']}): "
              + "; ".join(f"{k} " + " / ".join(f"{m:.4f}" for m in row[k]["ms"]) + " ms a call ("
                          + " / ".join(f"{u:.2f}" for u in row[k]["us_per_iteration"]) + " us an iteration, "
                          + " / ".join(f"{100 * x:.1f}" for x in row[k]["share"]) + " % of the bound), alone "
                          + " / ".join(f"{a:.4f}" if a else "not caught" for a in row[k]["alone_ms"]) + " ms"
                          for k in ("other", "this")), flush=True)
    print(json.dumps({"k10_ab": result}))
    return result


def phase_k10_phases() -> dict:
    """CTA 0's clock64 cycles an iteration in each phase of K10's loop
    (K10_PHASES; thread 0's view, the others wait at the barriers that end
    each phase) on :func:`k10_tours`, from a build of ``csrc/refine_tour.cu``
    with ``-DPW_REFINE_PHASES`` held bit-equal to the wrapper's.  Run after
    ``phase_probe``."""
    import ctypes

    import torch

    from plotweave_torch.ops import kernels

    dev = torch.device("cuda")
    out_dir = Path(tempfile.mkdtemp(prefix="pw_k10_phases_"))
    path = out_dir / "refine_tour_phases.so"
    built = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS["refine_tour"], "-DPW_REFINE_PHASES", "-o", str(path),
                            str(kernels.CSRC / "refine_tour.cu")], capture_output=True, text=True)
    check(built.returncode == 0, f"K10 with -DPW_REFINE_PHASES did not build:\n{built.stdout}{built.stderr}")
    for line in (built.stdout + built.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas refine_tour -DPW_REFINE_PHASES:", line.strip())
    lib = ctypes.CDLL(str(path))
    lib.pw_refine_tour.argtypes = kernels._SIGNATURES["refine_tour"]["pw_refine_tour"]
    lib.pw_refine_blocks.argtypes = kernels._SIGNATURES["refine_tour"]["pw_refine_blocks"]
    result = {}
    for n, Ed, Xd, budget in k10_tours():
        blocks = lib.pw_refine_blocks(n)
        check(blocks > 0, f"K10 phases: no CTA fits ({blocks})")
        partial = torch.empty(2 * 3 * blocks, dtype=torch.int64, device=dev)
        perm, flip = torch.empty(n, dtype=torch.int32, device=dev), torch.empty(n, dtype=torch.uint8, device=dev)
        moves = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.pw_refine_tour(Ed.data_ptr(), Xd.data_ptr(), partial.data_ptr(), blocks, n, 0.0, 0.0, budget,
                                 perm.data_ptr(), flip.data_ptr(), moves.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"K10 phases: launch failed ({err})")
        want = kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), budget)
        check(all(torch.equal(a.cpu(), b.cpu()) for a, b in zip((perm, flip.view(torch.bool), moves), want)),
              f"K10 phases n={n}: the phases build differs from the wrapper's")
        out = (ctypes.c_ulonglong * 7)()
        check(lib.pw_refine_phases(out) == 0, "K10 phases: the phase cycles could not be read")
        per = [out[i] / out[6] for i in range(6)]
        result[n] = {"moves": int(moves.item()), **dict(zip(K10_PHASES, per))}
        print(f"K10 phases n = {n}, {result[n]['moves']} moves, cycles an iteration (CTA 0, thread 0; {sum(per):.0f} "
              "in all): " + ", ".join(f"{name} {c:.0f} ({100 * c / sum(per):.0f} %)" for name, c in zip(K10_PHASES, per)),
              flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"k10_phases": result}))
    return result


K9_AB_SIZES = (4500, 9451, 13643, 13644, 65536)  # points: the gate, the quality poster's, the routes' old limits, the largest
K9_PHASE_SIZES = (1000, 2000) + K9_AB_SIZES  # and two short tours, below and at the routes' crossover
K9_PHASES = ("scan", "minima", "exchange", "move")
K9_FLOOR: dict = {}  # (n, route) -> ms a call with the scan removed, set by phase_k9_phases


def k9_tours(sizes=K9_AB_SIZES):
    """(n, starts, ends, closed, seed) on the card for each of ``sizes``:
    seeded ``tour_points`` with ties (each size its own seed)."""
    import numpy as np
    import torch

    dev = torch.device("cuda")
    for n in sizes:
        rng = np.random.default_rng(n)
        s, e, closed = tour_points(rng, n)
        seed = int(rng.integers(0, n))
        yield (n, *(torch.from_numpy(a).to(dev) for a in (s, e, closed)), seed)


def k9_times() -> dict:
    """K9 of the checkout that ``ROOT`` names, through that checkout's own
    ``kernels.greedy_order_cuda`` on its own route, on :func:`k9_tours`: per
    size a digest of order and flips, ms a call (CUDA events around whole
    calls) and alone (``torch.profiler``).  Run after ``phase_probe``."""
    import hashlib

    from plotweave_torch.ops import kernels

    out = {}
    for n, S, E, C, seed in k9_tours():
        def call(S=S, E=E, C=C, seed=seed):
            return kernels.greedy_order_cuda(S, E, C, True, seed)

        order, flips = (t.cpu() for t in call())
        digest = hashlib.sha256(order.numpy().tobytes() + flips.numpy().tobytes()).hexdigest()
        out[n] = {"route": kernels.greedy_route(n), "digest": digest, "ms": cuda_ms(call, 2 if n > 20000 else 5),
                  "alone_ms": profiled_ms(call, "greedy_tour", 2)}
    return out


def phase_k9_ab(other: str) -> dict:
    """K9 of this checkout against the one at ``other`` (another commit's:
    ``git archive <rev> | tar -x -C .checkout/other``), in turns other, this,
    this, other, each in a process of its own that runs :func:`k9_times`
    with ``ROOT`` set to its checkout: both must give the same order and
    flips at every size; per size ms a call, alone, microseconds a step, the
    share of ``k9_bound`` and of this checkout's measured chain floor (from
    :func:`phase_k9_phases`, when it ran before in this process)."""
    runs = ab_turns(other, "k9_times", "K9")
    result = {}
    for n in K9_AB_SIZES:
        rows = {k: [r[str(n)] for r in v] for k, v in runs.items()}
        seen = {r["digest"] for v in rows.values() for r in v}
        check(len(seen) == 1, f"K9 A/B n={n}: the two checkouts differ in order or flips: {sorted(seen)}")
        b = k9_bound(n)
        floor = K9_FLOOR.get((n, rows["this"][0]["route"]))
        row = {"n": n, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "floor_ms": floor}
        for k, v in rows.items():
            ms = [r["ms"] for r in v]
            row[k] = {"route": v[0]["route"], "ms": ms, "alone_ms": [r["alone_ms"] for r in v],
                      "us_per_step": [m * 1e3 / (n - 1) for m in ms], "share": [b["bound_ms"] / m for m in ms],
                      "floor_share": [floor / m for m in ms] if floor else None}
        result[n] = row
        print(f"K9 A/B n = {n}, bound {b['bound_ms']:.5f} ms ({b['bound_by']}), chain floor "
              + (f"{floor:.4f} ms ({floor * 1e3 / (n - 1):.3f} us a step)" if floor else "not measured") + ": "
              + "; ".join(f"{k} ({row[k]['route']}) " + " / ".join(f"{m:.4f}" for m in row[k]["ms"]) + " ms a call ("
                          + " / ".join(f"{u:.3f}" for u in row[k]["us_per_step"]) + " us a step, "
                          + " / ".join(f"{100 * x:.3f}" for x in row[k]["share"]) + " % of the bound"
                          + (", " + " / ".join(f"{100 * x:.1f}" for x in row[k]["floor_share"]) + " % of the floor"
                             if floor else "") + "), alone "
                          + " / ".join(f"{a:.4f}" if a else "not caught" for a in row[k]["alone_ms"]) + " ms"
                          for k in ("other", "this")), flush=True)
    print(json.dumps({"k9_ab": result}))
    return result


K11_AB_CASES = (("one mask, rect 3 open then close", 1, ("rect", 3, 1, "ed"), ("rect", 3, 1, "de")),
                ("four masks stacked, the swatch call", 4, ("rect", 3, 1, "ed"), ("rect", 3, 1, "de")),
                ("one mask, ellipse 5 x 2 open", 1, ("ellipse", 5, 2, "ed")),
                ("one mask, rect 31 open", 1, ("rect", 31, 1, "ed")))


def k11_masks():
    """The swatch path's four masks on the card: the synthetic 2000 x 1500
    poster's layers, 0 / 255, stacked."""
    import numpy as np
    import torch

    k, h, w = CHAIN_SHAPE
    _, bins = synthetic_image(1, h, w)
    return torch.from_numpy(np.stack([(bins == j).astype(np.uint8) * 255 for j in range(k)])).to("cuda")


def k11_case(masks, case):
    """(input, step list) of a K11_AB_CASES row."""
    from plotweave_torch.ops import morphology

    _, k, *programs = case
    steps = sum((morphology.morph_program(*p) for p in programs), ())
    return (masks[0] if k == 1 else masks[:k].contiguous()), steps


def k11_times() -> dict:
    """K11 of the checkout that ``ROOT`` names, through that checkout's own
    ``morphology.morph_dense``, on :data:`K11_AB_CASES`: per case a digest of
    the output, ms a call (CUDA events) and alone (``torch.profiler``, every
    kernel of the call).  Run after ``phase_probe``."""
    import hashlib

    from plotweave_torch.ops import morphology

    masks = k11_masks()
    out = {}
    for case in K11_AB_CASES:
        x, steps = k11_case(masks, case)

        def call(x=x, steps=steps):
            return morphology.morph_dense(x, steps)

        out[case[0]] = {"digest": hashlib.sha256(call().cpu().numpy().tobytes()).hexdigest(),
                        "ms": cuda_ms(call, 3 if "31" in case[0] else 20),
                        "alone_ms": profiled_ms(call, "morph_", 3 if "31" in case[0] else 10)}
    return out


def phase_k11_ab(other: str) -> dict:
    """K11 of this checkout against the one at ``other`` (another commit's:
    ``git archive <rev> | tar -x -C .checkout/other``), in turns other, this,
    this, other, each in a process of its own that runs :func:`k11_times`
    with ``ROOT`` set to its checkout: both must give the same bytes in every
    case; per case ms a call, alone, the bound (``k11_bound``) and the share."""
    runs = ab_turns(other, "k11_times", "K11")
    masks = k11_masks()
    result = {}
    for case in K11_AB_CASES:
        name = case[0]
        rows = {k: [r[name] for r in v] for k, v in runs.items()}
        seen = {r["digest"] for v in rows.values() for r in v}
        check(len(seen) == 1, f"K11 A/B {name}: the two checkouts differ: {sorted(seen)}")
        x, steps = k11_case(masks, case)
        b = k11_bound(x.numel(), steps)
        row = {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"]}
        for k, v in rows.items():
            row[k] = {"ms": [r["ms"] for r in v], "alone_ms": [r["alone_ms"] for r in v],
                      "share_alone": [b["bound_ms"] / r["alone_ms"] if r["alone_ms"] else None for r in v]}
        result[name] = row
        print(f"K11 A/B {name}, bound {b['bound_ms']:.5f} ms ({b['bound_by']}): "
              + "; ".join(f"{k} " + " / ".join(f"{m:.4f}" for m in row[k]["ms"]) + " ms a call, alone "
                          + " / ".join(f"{a:.4f}" if a else "not caught" for a in row[k]["alone_ms"]) + " ms ("
                          + " / ".join(f"{100 * x:.1f}" if x else "-" for x in row[k]["share_alone"])
                          + " % of the bound)" for k in ("other", "this")), flush=True)
    print(json.dumps({"k11_ab": result}))
    return result


K1_FOLD_GROUP = 8  # images of the A/B's grouped chain call
K1_FOLD_CALLS = ("chain", "grouped call of 8", "front-end")


def k1_fold_inputs():
    """The K1 fold A/B's inputs, the same for every checkout: the chain's
    packed masks (4 x 1500 x 2000 px, as ``phase_chain``), a group of 8 (those
    masks rolled down 37 rows an image), and the front-end's image and
    centres on the card."""
    import numpy as np
    import torch

    k, h, w = CHAIN_SHAPE
    _, bins = synthetic_image(1, h, w)
    packed = np.packbits(np.stack([bins == j for j in range(k)]), axis=-1)
    group = np.stack([np.roll(packed, 37 * i, axis=-2) for i in range(K1_FOLD_GROUP)])
    img = torch.from_numpy(synthetic_image(3, *FRONTEND_SHAPE)[0]).to("cuda")
    return packed, group, img, torch.tensor(BENCH_CENTERS, dtype=torch.float32, device="cuda")


def kernel_ms(fn, reps: int) -> dict:
    """{kernel, by its ``OWN_KERNELS`` name: device ms a call} of ``fn``, from
    ``torch.profiler`` over the whole calls the trace caught (all but the
    first); empty where it caught none."""
    try:
        groups = traced(fn, reps + 1)[1:]
    except RuntimeError as e:  # a measurement only: say so and go on
        print(f"  torch.profiler failed: {e}")
        return {}
    out: dict = {}
    for g in groups:
        for e in g:
            own = next((o for o in OWN_KERNELS if o in e.name), e.name)
            out[own] = out.get(own, 0.0) + device_us(e) / 1e3 / len(groups)
    return out


def k1_fold_times() -> dict:
    """The chain call, the grouped call of 8 and the front-end call (K6
    route) of the checkout that ``ROOT`` names, through that checkout's own
    code, on :func:`k1_fold_inputs`: per call a digest of its output, its
    launches by wrapper, ms a call (CUDA events, the chain's upload included)
    and each kernel's ms alone (``torch.profiler``: K2 ``morph_steps``, K6
    ``zs_cluster``, K1's conversions).  Run after ``phase_probe``."""
    import hashlib

    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.frontend import raster_frontend
    from plotweave_torch.stages.s02_color_extract import chain_blob_batch, chain_from_clean

    packed, group, img, centers = k1_fold_inputs()
    w, cuda = CHAIN_SHAPE[-1], torch.device("cuda")
    calls = {"chain": (lambda: chain_from_clean(packed, w, *EDGE_PARAMS, device=cuda), 20),
             "grouped call of 8": (lambda: chain_blob_batch(group, w, *EDGE_PARAMS, device=cuda), 5),
             "front-end": (lambda: raster_frontend(img, centers, k=4), 20)}
    out = {}
    for name, (fn, reps) in calls.items():
        kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        launches = {n: c for n, c in kernels.LAUNCHES.items() if c}
        data = b"".join(t.cpu().numpy().tobytes() for t in (res if isinstance(res, tuple) else (res,)))
        out[name] = {"digest": hashlib.sha256(data).hexdigest(), "launches": launches, "ms": cuda_ms(fn, reps),
                     "alone_ms": kernel_ms(fn, min(reps, 10))}
    return out


def phase_k1_fold_ab(other: str) -> dict:
    """The K1 fold of this checkout against the one at ``other`` (the
    parent's: ``git archive <rev> | tar -x -C .checkout/other``): first
    :func:`fold_cases` (the fused bytes against K1 plus the unfused kernels),
    then :func:`k1_fold_times` in turns other, this, this, other, each in a
    process of its own with ``ROOT`` set to its checkout.  Both must give
    the same bytes on every call; per call the launches, ms a call and each
    kernel's ms alone."""
    fold_cases()
    runs = ab_turns(other, "k1_fold_times", "K1 fold")
    result = {}
    for name in K1_FOLD_CALLS:
        rows = {key: [r[name] for r in v] for key, v in runs.items()}
        seen = {r["digest"] for v in rows.values() for r in v}
        check(len(seen) == 1, f"K1 fold A/B {name}: the two checkouts differ: {sorted(seen)}")
        row = {}
        for key, v in rows.items():
            names = sorted({n for r in v for n in r["alone_ms"]})
            row[key] = {"launches": v[0]["launches"], "ms": [r["ms"] for r in v],
                        "alone_ms": {n: [r["alone_ms"].get(n) for r in v] for n in names}}
        result[name] = row
        print(f"K1 fold A/B {name}: " + "; ".join(
            f"{key} {row[key]['launches']}, " + " / ".join(f"{m:.4f}" for m in row[key]["ms"]) + " ms a call, alone "
            + ", ".join(f"{n} " + " / ".join(f"{a:.4f}" if a else "-" for a in t) for n, t in row[key]["alone_ms"].items())
            for key in ("other", "this")), flush=True)
    print(json.dumps({"k1_fold_ab": result}))
    return result


def banded_times() -> dict:
    """K5, K6 storing the blob, and the chain, each at 1 x 4400 x 4400 on
    :func:`big_inputs` by the route the size takes, through the code of the
    checkout that ``ROOT`` names (the banded route here, the multi-launch
    route and K1 before it): per call a digest of its output, its launches
    by wrapper, ms a call (CUDA events, the chain's upload included) and each
    kernel's ms alone (``torch.profiler``).  Run after ``phase_probe``."""
    import hashlib

    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.stages.s02_color_extract import chain_from_clean

    packed, cand, strong, edges = big_inputs()
    cuda = torch.device("cuda")
    blob = torch.empty((2, 1, 1, BIG_SIDE, -(-BIG_SIDE // 8)), dtype=torch.uint8, device=cuda)

    def k6():
        kernels.zhang_suen_into_cuda(edges, BIG_SIDE, blob[0], blob[1], "rows", 120, True)
        return blob

    calls = {"K5": (lambda: kernels.hysteresis_cuda(cand, strong), 10), "K6 into the blob": (k6, 10),
             "chain": (lambda: chain_from_clean(packed, BIG_SIDE, *EDGE_PARAMS, device=cuda), 10)}
    out = {}
    for name, (fn, reps) in calls.items():
        kernels.reset_launches()
        res = fn()
        torch.cuda.synchronize()
        launches = {n: c for n, c in kernels.LAUNCHES.items() if c}
        out[name] = {"digest": hashlib.sha256(res.cpu().numpy().tobytes()).hexdigest(), "launches": launches,
                     "ms": cuda_ms(fn, reps), "alone_ms": kernel_ms(fn, 5)}
    return out


def phase_banded_ab(other: str) -> dict:
    """K5 and K6 on the 4400 x 4400 layer, and its chain, of this checkout
    (the banded route) against the one at ``other`` (the parent's, whose
    size rule takes the multi-launch route: ``git archive <rev> | tar -x -C
    .checkout/other``): :func:`banded_times` in turns other, this, this,
    other, each in a process of its own.  Both must give the same bytes."""
    runs = ab_turns(other, "banded_times", "banded")
    result = {}
    for name in ("K5", "K6 into the blob", "chain"):
        rows = {key: [r[name] for r in v] for key, v in runs.items()}
        seen = {r["digest"] for v in rows.values() for r in v}
        check(len(seen) == 1, f"banded A/B {name}: the two checkouts differ: {sorted(seen)}")
        row = {}
        for key, v in rows.items():
            names = sorted({n for r in v for n in r["alone_ms"]})
            row[key] = {"launches": v[0]["launches"], "ms": [r["ms"] for r in v],
                        "alone_ms": {n: [r["alone_ms"].get(n) for r in v] for n in names}}
        result[name] = row
        print(f"banded A/B {name} at 1x{BIG_SIDE}x{BIG_SIDE}: " + "; ".join(
            f"{key} {row[key]['launches']}, " + " / ".join(f"{m:.4f}" for m in row[key]["ms"]) + " ms a call, alone "
            + ", ".join(f"{n} " + " / ".join(f"{a:.4f}" if a else "-" for a in t) for n, t in row[key]["alone_ms"].items())
            for key in ("other", "this")), flush=True)
    print(json.dumps({"banded_ab": result}))
    return result


K8_AB_REPS = 7  # stage 02 runs a turn


def kmeans_times() -> dict:
    """K8's seeds and fits and stage 02's device mode of the checkout that
    ``ROOT`` names, through that checkout's own code, on the synthetic
    2000 x 1500 poster: the seeds and fits of 3 attempts, k = 4, 40
    iterations, on a 200,000-row sample of it (the same rows for every
    checkout: numpy's draw, gathered by ``lab_sample_cuda``), through
    ``kmeans_fit_cuda`` where the checkout has it (one launch), else through
    ``kpp_init_cuda`` and ``lloyd_fit_cuda`` (two): ms a call (CUDA events),
    the kernels' ms alone (``torch.profiler``, summed over the call's
    kernels), the launches, the picks' digest, the iterations and the best
    centres; ``device_init_stage`` (fused, as the runner calls it) in host
    wall ms a call, synchronised, K8_AB_REPS calls; and stage 02's seconds of
    the CLI, steps 1-4 with ``kmeans_init: "device"``, three runs.  Run after
    ``phase_probe``."""
    import hashlib

    import cv2
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels, kmeans
    from plotweave_torch.stages.s02_color_extract import device_init_stage

    kernels.build()
    dev = torch.device("cuda")
    img_np = synthetic_image(2, 1500, 2000)[0]
    img = torch.from_numpy(img_np).to(dev)
    idx = np.sort(np.random.default_rng(42).choice(1500 * 2000, KMEANS_SAMPLE, replace=False)).astype(np.int32)
    sample = kernels.lab_sample_cuda(img, torch.from_numpy(idx).to(dev))
    first, uniforms = kmeans.seed_stream(42, 3, 4, KMEANS_SAMPLE)
    if hasattr(kernels, "kmeans_fit_cuda"):
        draws = kmeans.seed_draws(first, uniforms).to(dev)

        def fit():
            got = kernels.kmeans_fit_cuda(sample, draws, 40)
            return got[4], got[0], got[3]
    else:
        fd, ud = first.to(dev), uniforms.to(dev)

        def fit():
            centers, picks = kernels.kpp_init_cuda(sample, 4, fd, ud)
            got = kernels.lloyd_fit_cuda(sample, centers, 40)
            return picks, got[0], got[3]

    kernels.reset_launches()
    picks, best, its = fit()
    torch.cuda.synchronize()
    launches = {n: c for n, c in kernels.LAUNCHES.items() if c}
    alone = kernel_ms(fit, 10)
    out = {"fit": {"digest": hashlib.sha256(picks.cpu().numpy().tobytes()).hexdigest(), "best": best.cpu().tolist(),
                   "iterations": its.cpu().tolist(), "launches": launches, "ms": cuda_ms(fit, 20),
                   "alone_ms": sum(alone.values()) if alone else None, "kernels_alone_ms": alone}}

    def stage():
        device_init_stage(img, 4, 40, 3, KMEANS_SAMPLE, 42, True, *EDGE_PARAMS)
        torch.cuda.synchronize()

    stage()
    walls = []
    for _ in range(K8_AB_REPS):
        t0 = time.perf_counter()
        stage()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["stage_wall_ms"] = walls
    with tempfile.TemporaryDirectory(prefix="pw_k8ab_") as tmp:
        image = str(Path(tmp) / "poster.png")
        cv2.imwrite(image, img_np)
        out["s02_s"] = [run_main(image, Path(tmp) / f"run{i}", "auto", end_step=4,
                                 settings={"kmeans_init": "device"})["s02_color_extract"] for i in range(3)]
    return out


def phase_kmeans_ab(other: str) -> dict:
    """K8's seeds and fits and stage 02's device mode of this checkout against
    the one at ``other`` (``git archive <rev> | tar -x -C .checkout/other``),
    in turns other, this, this, other, each in a process of its own that runs
    :func:`kmeans_times` with ``ROOT`` set to its checkout.  The seeding's
    picks are the same function in both, so they must be equal, and so must
    the iterations; the best centres within 1e-3 (the fits' sums run in
    another order).  The bound is phase 8's at the same shape."""
    runs = ab_turns(other, "kmeans_times", "K8")
    fits = [r["fit"] for v in runs.values() for r in v]
    check(len({f["digest"] for f in fits}) == 1, "K8 A/B: the picks differ between turns or checkouts")
    check(len({tuple(f["iterations"]) for f in fits}) == 1, "K8 A/B: the iterations differ")
    err = max(abs(x - y) for f in fits for rx, ry in zip(f["best"], fits[0]["best"]) for x, y in zip(rx, ry))
    check(err <= 1e-3, f"K8 A/B: the best centres differ by {err} > 1e-3")
    n, k, attempts = KMEANS_SAMPLE, 4, 3
    b = kmeans_fit_bound(n, k, attempts, sum(fits[0]["iterations"]) + attempts)
    result = {"bound_ms": b["bound_ms"], "bound_by": b["bound_by"], "best_err": err}
    for key, v in runs.items():
        result[key] = {"launches": v[0]["fit"]["launches"], "ms": [r["fit"]["ms"] for r in v],
                       "alone_ms": [r["fit"]["alone_ms"] for r in v],
                       "kernels_alone_ms": [r["fit"]["kernels_alone_ms"] for r in v],
                       "share_alone": [b["bound_ms"] / r["fit"]["alone_ms"] if r["fit"]["alone_ms"] else None
                                       for r in v],
                       "stage_wall_ms": [r["stage_wall_ms"] for r in v], "s02_s": [r["s02_s"] for r in v]}

    def ms_list(xs):
        return " / ".join(f"{x:.4f}" if x else "not caught" for x in xs)

    for key in ("other", "this"):
        r = result[key]
        med = [sorted(w)[len(w) // 2] for w in r["stage_wall_ms"]]
        print(f"K8 A/B {key}: launches {r['launches']}; seeds and fits {ms_list(r['ms'])} ms a call, alone "
              f"{ms_list(r['alone_ms'])} ms (bound {b['bound_ms']:.5f} ms, {b['bound_by']}; by kernel "
              + "; ".join(", ".join(f"{n} {t:.4f}" for n, t in d.items()) for d in r["kernels_alone_ms"])
              + "); device_init_stage wall median " + " / ".join(f"{m:.2f}" for m in med) + " ms a call; stage 02 "
              "of the CLI " + " / ".join("[" + ", ".join(f"{x:.3f}" for x in s) + "]" for s in r["s02_s"]) + " s",
              flush=True)
    print(f"K8 A/B: picks and iterations equal in every turn, best centres within {err:.2e}")
    print(json.dumps({"k8_ab": result}))
    return result


# csrc/kmeans.cu's phase slots: passes run, compactness, total, the first draw's, the first pass's
K8_PHASE_SLOTS, K8_PHASE_PASSES, K8_PHASE_COMP, K8_PHASE_TOTAL, K8_PHASE_DRAW, K8_PHASE_PASS = 128, 8, 9, 11, 16, 64


def phase_k8_phases() -> dict:
    """CTA 0's clock64 cycles in each phase of K8's seeds-and-fits launch
    (the row load; each draw's update, its totals and barrier, its search
    and barrier; each Lloyd pass's scan and its reduction, new centres and
    barriers; the compactness; thread 0's view, the others wait at the
    barriers that end each phase), from a build of ``csrc/kmeans.cu`` with
    ``-DPW_KMEANS_PHASES`` held bit-equal to the wrapper's, on the poster's
    200,000-row sample (resident) and a 250,000-row one (streamed), k = 1, 4
    and 8, 3 attempts, 40 iterations, and of the fit alone from the same seeds
    at k = 4; each launch's ms by CUDA events around bare launches, which
    turns the cycles into microseconds.  Run after ``phase_probe``."""
    import ctypes

    import torch

    from plotweave_torch.ops import kernels, kmeans

    out_dir = Path(tempfile.mkdtemp(prefix="pw_k8_phases_"))
    path = out_dir / "kmeans_phases.so"
    built = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS["kmeans"], "-DPW_KMEANS_PHASES", "-o", str(path),
                            str(kernels.CSRC / "kmeans.cu")], capture_output=True, text=True)
    check(built.returncode == 0, f"K8 with -DPW_KMEANS_PHASES did not build:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(path))
    for fn in ("pw_kmeans_fit", "pw_lloyd_fit"):
        getattr(lib, fn).argtypes = kernels._SIGNATURES["kmeans"][fn]
    lib.pw_kmeans_phases.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    poster, _, sample = poster_sample()
    result = {}
    for data in (sample, kmeans.subsample_lab(poster, 43, 250_000)):
        n = data.shape[0]
        route = kernels.kpp_schedule(n)["route"]
        for k, fused in ((1, True), (4, True), (8, True), (4, False)):
            first, uniforms = kmeans.seed_stream(42, 3, k, n)
            draws = kmeans.seed_draws(first, uniforms).to(dev)
            seeds = kernels.kmeans_fit_cuda(data, draws, 0)[1]
            want = kernels.kmeans_fit_cuda(data, draws, 40) if fused else kernels.lloyd_fit_cuda(data, seeds, 40)
            best, centers, comp, picks, its, done, best_idx, d2 = kernels._fit_outputs(
                3, k, 0 if route == "resident" else 3 * n, dev)
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                if fused:
                    err = lib.pw_kmeans_fit(data.data_ptr(), n, k, 3, draws.data_ptr(), 40, 0.5,
                                            int(route == "resident"), d2.data_ptr() if d2.numel() else None,
                                            picks.data_ptr(), centers.data_ptr(), comp.data_ptr(), its.data_ptr(),
                                            done.data_ptr(), best.data_ptr(), best_idx.data_ptr(), stream)
                else:
                    err = lib.pw_lloyd_fit(data.data_ptr(), n, k, 3, seeds.data_ptr(), 40, 0.5,
                                           int(route == "resident"), centers.data_ptr(), comp.data_ptr(),
                                           its.data_ptr(), done.data_ptr(), best.data_ptr(), best_idx.data_ptr(), stream)
                check(err == 0, f"K8 phases: launch failed ({err})")

            launch()
            torch.cuda.synchronize()
            name = f"{'kmeans_fit' if fused else 'lloyd_fit'} {route} {n} k={k}"
            same = [best.view(k, 3), centers.view(3, k, 3), comp, its] + ([picks.view(3, k)] if fused else [])
            check(all(torch.equal(x, y) for x, y in zip(same, want)), f"K8 phases {name}: the phases build differs "
                  "from the wrapper's")
            cyc = (ctypes.c_ulonglong * K8_PHASE_SLOTS)()
            check(lib.pw_kmeans_phases(cyc) == 0, "K8 phases: the phase cycles could not be read")
            passes, total = int(cyc[K8_PHASE_PASSES]), int(cyc[K8_PHASE_TOTAL])
            ms = cuda_ms(launch, 10)
            us = ms * 1e3 / total  # microseconds a cycle of CTA 0
            draws = [[cyc[K8_PHASE_DRAW + 3 * (j - 1) + i] * us for i in range(3)] for j in range(1, k)] if fused else []
            row = {"ms": ms, "cycles": total, "passes": passes, "load_us": cyc[0] * us, "draws_us": draws,
                   "scan_us": [cyc[K8_PHASE_PASS + 2 * i] * us for i in range(passes)],
                   "reduce_us": [cyc[K8_PHASE_PASS + 2 * i + 1] * us for i in range(passes)],
                   "comp_us": [cyc[K8_PHASE_COMP] * us, cyc[K8_PHASE_COMP + 1] * us]}
            result[name] = row
            fit_us = sum(row["scan_us"]) + sum(row["reduce_us"]) + sum(row["comp_us"])
            print(f"K8 phases {name}: {ms:.4f} ms a bare launch ({total} cycles of CTA 0); load "
                  f"{row['load_us']:.2f} us, draws (update + totals + search) "
                  + " / ".join("+".join(f"{x:.2f}" for x in d) for d in row["draws_us"]) + " us, "
                  f"{passes} passes: scan " + " / ".join(f"{x:.2f}" for x in row["scan_us"]) + " us, reduction and "
                  "barrier " + " / ".join(f"{x:.2f}" for x in row["reduce_us"]) + f" us; compactness "
                  f"{row['comp_us'][0]:.2f} + {row['comp_us'][1]:.2f} us; the fit {fit_us:.2f} us", flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"k8_phases": result}))
    return result


def phase_k9_phases() -> dict:
    """CTA 0's clock64 cycles a step in each phase of K9's loop (K9_PHASES;
    thread 0's view, the others wait at the barriers that end each phase) on
    :func:`k9_tours`, on each route where the size fits, from a build of
    ``csrc/greedy_tour.cu`` with ``-DPW_GREEDY_PHASES`` held bit-equal to the
    wrapper's; and the chain floor: the same launch with the scan removed
    (every thread offers a fixed key), n - 1 steps of minima, exchange and
    move, timed by CUDA events.  Run after ``phase_probe``."""
    import ctypes

    import torch

    from plotweave_torch.ops import kernels

    out_dir = Path(tempfile.mkdtemp(prefix="pw_k9_phases_"))
    path = out_dir / "greedy_tour_phases.so"
    built = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS["greedy_tour"], "-DPW_GREEDY_PHASES", "-o", str(path),
                            str(kernels.CSRC / "greedy_tour.cu")], capture_output=True, text=True)
    check(built.returncode == 0, f"K9 with -DPW_GREEDY_PHASES did not build:\n{built.stdout}{built.stderr}")
    for line in (built.stdout + built.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas greedy_tour -DPW_GREEDY_PHASES:", line.strip())
    lib = ctypes.CDLL(str(path))
    lib.pw_greedy_tour.argtypes = kernels._SIGNATURES["greedy_tour"]["pw_greedy_tour"]
    lib.pw_greedy_set_floor.argtypes = [ctypes.c_int]
    result = {}
    for n, S, E, C, seed in k9_tours(K9_PHASE_SIZES):
        for route in kernels.GREEDY_ROUTES:
            if route == "cta" and n > kernels.GREEDY_CTA_MAX_N:
                continue
            order = torch.empty(n, dtype=torch.int32, device=S.device)
            flips = torch.empty(n, dtype=torch.uint8, device=S.device)

            def launch():
                err = lib.pw_greedy_tour(S.data_ptr(), E.data_ptr(), C.data_ptr(), n, 1, seed,
                                         1 if route == "cta" else kernels.GREEDY_CLUSTER, order.data_ptr(),
                                         flips.data_ptr(), torch.cuda.current_stream().cuda_stream)
                check(err == 0, f"K9 phases: launch failed ({err})")

            check(lib.pw_greedy_set_floor(0) == 0, "K9 phases: the floor switch could not be set")
            launch()
            want = kernels.greedy_order_cuda(S, E, C, True, seed, route=route)
            check(torch.equal(order, want[0]) and torch.equal(flips.view(torch.bool), want[1]),
                  f"K9 phases n={n} {route}: the phases build differs from the wrapper's")
            cyc = (ctypes.c_ulonglong * 5)()
            check(lib.pw_greedy_phases(cyc) == 0, "K9 phases: the phase cycles could not be read")
            per = [cyc[i] / cyc[4] for i in range(4)]
            ms = cuda_ms(lambda: kernels.greedy_order_cuda(S, E, C, True, seed, route=route), 2)
            check(lib.pw_greedy_set_floor(1) == 0, "K9 phases: the floor switch could not be set")
            floor_ms = cuda_ms(launch, 2)
            check(lib.pw_greedy_phases(cyc) == 0, "K9 phases: the phase cycles could not be read")
            floor = [cyc[i] / cyc[4] for i in range(4)]
            check(lib.pw_greedy_set_floor(0) == 0, "K9 phases: the floor switch could not be set")
            K9_FLOOR[(n, route)] = floor_ms
            result[f"{n} {route}"] = {"cycles": dict(zip(K9_PHASES, per)), "ms": ms, "us_per_step": ms * 1e3 / (n - 1),
                                      "floor_cycles": dict(zip(K9_PHASES, floor)), "floor_ms": floor_ms,
                                      "floor_us_per_step": floor_ms * 1e3 / (n - 1)}
            print(f"K9 phases n = {n} {route}: {ms * 1e3 / (n - 1):.3f} us a step (CUDA events), cycles a step (CTA 0, "
                  f"thread 0; {sum(per):.0f} in all): "
                  + ", ".join(f"{k} {c:.0f} ({100 * c / sum(per):.0f} %)" for k, c in zip(K9_PHASES, per))
                  + f"; chain floor (no scan) {floor_ms * 1e3 / (n - 1):.3f} us a step, cycles "
                  + ", ".join(f"{k} {c:.0f}" for k, c in zip(K9_PHASES, floor)), flush=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps({"k9_phases": result}))
    return result


def dot_field(seed: int, h: int, w: int, count: int):
    """A seeded BGR poster of about ``count`` small discs and rings in the
    three darker poster tones on the lightest, on a jittered grid, with mild
    noise: thousands of contours in a layer, as a dotted or stippled poster
    gives."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    img = np.empty((h, w, 3), np.uint8)
    img[:] = POSTER_PALETTE[3]
    pitch = (h * w / count) ** 0.5
    for y in np.arange(pitch / 2, h, pitch):
        for x in np.arange(pitch / 2, w, pitch):
            cx, cy = x + rng.uniform(-0.2, 0.2) * pitch, y + rng.uniform(-0.2, 0.2) * pitch
            r = rng.uniform(0.22, 0.34) * pitch
            tone = tuple(int(v) for v in POSTER_PALETTE[int(rng.integers(0, 3))])
            ring = rng.random() < 0.3
            cv2.circle(img, (int(round(cx)), int(round(cy))), int(round(r)), tone, max(2, int(r / 3)) if ring else -1)
    return np.clip(img.astype(np.int16) + rng.integers(-6, 7, (h, w, 3), dtype=np.int16), 0, 255).astype(np.uint8)


def op_ends(ops):
    """(entries, exits) (n, 2) float32 of a stage-12 op list, as the refiner takes them."""
    import numpy as np

    from plotweave_torch.vector.planner import _op_entry, _op_exit

    return np.array([_op_entry(o) for o in ops], np.float32), np.array([_op_exit(o) for o in ops], np.float32)


def _op_key(op):
    if op["type"] == "tap":
        return ("tap", op["x"], op["y"])
    p = op["points"]
    return ("line", min(p.tobytes(), p[::-1].copy().tobytes()))


def trace_tours(path: str, layer9: str, layer10: str) -> None:
    """One ``torch.profiler`` trace each of stage 07's device planner and
    stage 12's device refiner on the arrays saved at ``path`` (phase 13 runs
    it in a fresh process); fails unless every device kernel is the port's
    own, and times each kernel alone; prints {"K9 trace": ..., "K9
    alone_ms": ..., "K10 trace": ..., "K10 alone_ms": ...} as its last line."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.vector.planner_device import greedy_order_device
    from plotweave_torch.vector.refine_device import refine_order_device

    a, dev = np.load(path), torch.device("cuda")
    seed, budget = int(a["seed"]), int(a["budget"])
    S, E, C, Ed, Xd = (torch.from_numpy(np.ascontiguousarray(a[k], np.float32 if k != "closed" else bool)).to(dev)
                       for k in ("starts", "ends", "closed", "entries", "exits"))
    out = {"K9 trace": only_own_kernels(lambda: greedy_order_device(a["starts"], a["ends"], a["closed"], True, seed, dev),
                                        f"stage 07's device planner, {layer9}, one call", {"greedy_tour": 1}),
           "K9 alone_ms": profiled_ms(lambda: kernels.greedy_order_cuda(S, E, C, True, seed), "greedy_tour", 3),
           "K10 trace": only_own_kernels(lambda: refine_order_device(a["entries"], a["exits"], max_moves=budget,
                                                                     device=dev),
                                         f"stage 12's device refiner, {layer10}, one call", {"refine_tour": 1}),
           "K10 alone_ms": profiled_ms(lambda: kernels.refine_order_cuda(Ed, Xd, (0.0, 0.0), budget), "refine_tour", 3)}
    print(json.dumps(out), flush=True)


def phase_quality_path(work: Path, stats: dict) -> dict:
    """Phase 13: ``pipeline.main --preset quality`` on the dot-field poster,
    steps 1-13, on the card: K9 on every layer over the planner's gate, K10
    on every op list over the refiner's, stage 07 byte-equal to a
    ``--raster-device cpu`` run of steps 1-7, stage 12 equal to the plain
    refiner from the same input, geometry kept, travel not longer, the
    stream decoding; K9 against its plain version and the host planner at
    the largest gated layer; traces of both device calls; K9's and K10's
    times at the largest gated layers."""
    import re

    import cv2
    import numpy as np
    import torch

    from plotweave_torch.config import PipelineConfig
    from plotweave_torch.ops import kernels
    from plotweave_torch.pipeline import load_preset
    from plotweave_torch.utils import load_pickle
    from plotweave_torch.vector import sort as tsort
    from plotweave_torch.vector.planner import _op_flip, plan_layer_ops, tour_length
    from plotweave_torch.vector.planner_device import greedy_order_plain
    from plotweave_torch.vector.refine_device import refine_order_device, refine_order_plain

    dev = torch.device("cuda")
    cfg = PipelineConfig(**load_preset("quality"))
    names = list(cfg.color_names)
    image = str(work / "quality.png")
    cv2.imwrite(image, dot_field(3, 1500, 2000, QUALITY_OBJECTS))
    card, cpu = work / "quality_cuda", work / "quality_cpu"
    kernels.reset_launches()
    t0 = time.perf_counter()
    times = run_main(image, card, "auto", preset="quality")
    wall = time.perf_counter() - t0
    counts = dict(kernels.LAUNCHES)
    log = Path(f"{card}.log").read_text()
    planned = [int(v) for v in re.findall(r"\[sort\] device planner: n=(\d+)", log)]
    check(not re.search(r"outside the device (planner|refiner)", log), "quality path: a gated layer left the card")

    # which layers cross each gate, from the run's own artifacts
    sorted_n = {n: len(load_pickle(str(card / n / "contours_sorted.pkl"))) for n in names}
    inputs, r_insert = {}, cfg.resolve_tap_insert_radius()
    for n in names:
        lines = load_pickle(str(card / n / "lines_cross.pkl"))
        taps = [tuple(int(v) for v in np.asarray(t).reshape(-1)[:2]) for t in load_pickle(str(card / n / "taps_cross.pkl"))
                if np.asarray(t).size >= 2]
        inputs[n] = plan_layer_ops(lines, taps, r_insert)
    k9_layers = [n for n in names if sorted_n[n] >= cfg.planner_device_min_n]
    k10_layers = [n for n in names if len(inputs[n]) >= cfg.refine_device_min_n]
    check(k9_layers and k10_layers, f"quality path: no layer crosses a gate: contours {sorted_n}, ops "
          f"{({n: len(v) for n, v in inputs.items()})}")
    check(counts["greedy_tour"] == len(k9_layers) and sorted(planned) == sorted(sorted_n[n] for n in k9_layers),
          f"quality path: K9 launched {counts['greedy_tour']} times for {len(k9_layers)} gated layers, n {planned}")
    check(counts["refine_tour"] == len(k10_layers),
          f"quality path: K10 launched {counts['refine_tour']} times for {len(k10_layers)} gated layers")
    size = decodes(card)

    # stage 07: byte-equal to the CPU's host planner
    t0 = time.perf_counter()
    run_main(image, cpu, "cpu", end_step=7, preset="quality")
    cpu_s = time.perf_counter() - t0
    diff = [n for n in names if (card / n / "contours_sorted.pkl").read_bytes() != (cpu / n / "contours_sorted.pkl").read_bytes()]
    check(not diff, f"quality path: contours_sorted.pkl of the card != the CPU's in {diff}")

    # stage 12: each gated layer against its plain refiner on the card (run once, timed by CUDA events) and K10
    # called alone on the same input; geometry and travel
    t0 = time.perf_counter()
    plain_cases, k10 = [], {}
    ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for n in k10_layers:
        ops, got = inputs[n], load_pickle(str(card / n / "ops.pkl"))
        check(sorted(map(_op_key, ops)) == sorted(map(_op_key, got)), f"quality path, {n}: stage 12 changed the geometry")
        check(tour_length(got) <= tour_length(ops), f"quality path, {n}: stage 12 lengthened the travel")
        entries, exits = op_ends(ops)
        budget = max(4096, 4 * len(ops))
        Ed, Xd = torch.from_numpy(entries).to(dev), torch.from_numpy(exits).to(dev)
        torch.cuda.synchronize()
        ev[0].record()
        perm, flip, moves = refine_order_plain(Ed, Xd, torch.zeros(2, device=dev), budget)
        ev[1].record()
        torch.cuda.synchronize()
        perm, flip = perm.cpu().numpy(), flip.cpu().numpy()
        k_perm, k_flip, k_moves = refine_order_device(entries, exits, max_moves=budget, device=dev)
        err = max(int(np.abs(k_perm.astype(np.int64) - perm).max()), int((k_flip != flip).sum()), abs(k_moves - moves))
        check(err == 0, f"quality path, {n}: K10 ({k_moves} moves) != the plain refiner ({moves})")
        # what stage 12 keeps of the plain refiner's tour: it, where it is shorter in float64, else the input
        tour = [_op_flip(ops[int(i)]) if f else ops[int(i)] for i, f in zip(perm, flip)]
        tour = tour if tour_length(tour) < tour_length(ops) else ops
        check([_op_key(o) for o in tour] == [_op_key(o) for o in got] and all(
            a["type"] == b["type"] and (a["type"] == "tap" or np.array_equal(a["points"], b["points"]))
            for a, b in zip(tour, got)), f"quality path, {n}: ops.pkl != the plain refiner's tour")
        k10[n] = {"moves": moves, "max_abs_err": err, "plain_ms": ev[0].elapsed_time(ev[1]), "E": Ed, "X": Xd,
                  "budget": budget}
        plain_cases.append(f"{n} {len(ops)} ops, {moves} moves, travel {tour_length(ops):.0f} -> {tour_length(got):.0f} px")
    checks_s = time.perf_counter() - t0
    print(f"quality path, dot-field poster 2000x1500 ({QUALITY_OBJECTS} discs and rings), --preset quality, steps "
          f"1-13 on the card: contours at stage 07 {sorted_n}, ops at stage 12 {({n: len(v) for n, v in inputs.items()})}; "
          f"K9 on {k9_layers} (n {planned}), K10 on {k10_layers}; launches "
          f"{({n: c for n, c in counts.items() if c})}; stream {size} bytes, decodes to EOF; wall {wall:.2f} s, stage 07 "
          f"{times['s07_sort']:.3f} s, stage 12 {times['s12_plot_order']:.3f} s")
    print(f"  stage 07 contours_sorted.pkl == the --raster-device cpu run's (steps 1-7 in {cpu_s:.1f} s); stage 12 == "
          f"the plain refiner's tour on the card == K10 called alone, full budget: {'; '.join(plain_cases)}")
    print("  stage wall seconds (card): " + ", ".join(f"{m[:3]} {v:.3f}" for m, v in times.items()))

    # the largest gated layers: K9 against its plain version and the host C++ planner, each run once; times
    t0 = time.perf_counter()
    big9 = max(k9_layers, key=lambda n: sorted_n[n])
    ptss = [c.reshape(-1, 2) for c in load_pickle(str(card / big9 / "contours_scaled.pkl"))]
    starts, ends, closed = tsort._batch_endpoints(ptss, strip_closed=True)
    seed = int(np.argmax(tsort.batch_arc_length(ptss, np.ones(len(ptss), bool))))
    n9 = len(ptss)
    S, E, C = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (starts.astype(np.float32),
                                                                          ends.astype(np.float32), closed))
    order, flips = kernels.greedy_order_cuda(S, E, C, True, seed)
    torch.cuda.synchronize()
    ev[0].record()
    p_order, p_flips = greedy_order_plain(S, E, C, True, seed)
    ev[1].record()
    torch.cuda.synchronize()
    err = max(int((order.long() - p_order.long()).abs().max()), int((flips != p_flips).sum()))
    check(err == 0, f"quality path, {big9}: K9 != its plain version at n = {n9}")
    t1 = time.perf_counter()
    host = tsort._greedy_order_native(starts, ends, closed, True, seed)
    host_ms = (time.perf_counter() - t1) * 1e3
    check([order.tolist(), flips.tolist()] == list(host), f"quality path, {big9}: K9 != the host C++ planner")
    stats["K9"] = {"max_abs_err": err, "n": n9, "tour_route": kernels.greedy_route(n9),
                   "ms": cuda_ms(lambda: kernels.greedy_order_cuda(S, E, C, True, seed), 3),
                   "plain_ms": ev[0].elapsed_time(ev[1]), "host_cpp_ms": host_ms, **k9_bound(n9)}
    k9_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    big10 = max(k10_layers, key=lambda n: len(inputs[n]))
    b10 = k10[big10]
    entries, exits, n10, budget, moves = b10["E"].cpu().numpy(), b10["X"].cpu().numpy(), len(inputs[big10]), \
        b10["budget"], b10["moves"]
    stats["K10"] = {"max_abs_err": b10["max_abs_err"], "n": n10, "moves": moves,
                    "ms": cuda_ms(lambda: kernels.refine_order_cuda(b10["E"], b10["X"], (0.0, 0.0), budget), 3),
                    "plain_ms": b10["plain_ms"], **k10_bound(n10, moves + 1)}
    it = k10_iterations(n10, stats["K10"]["ms"], moves)
    stats["K10"]["us_per_iteration"] = it["us_per_iteration"]
    stats["K10"]["bound_us_per_iteration"] = it["bound_us_per_iteration"]
    print("K10 an iteration at the quality path's largest gated layer (CUDA events around whole calls): "
          + k10_iterations_line([it]))
    k10_s = time.perf_counter() - t0
    # the traces and the times alone in a fresh process: late in a long one the profiler there has lost every event
    tours = work / "tours.npz"
    np.savez(tours, starts=starts, ends=ends, closed=closed, seed=seed, entries=entries, exits=exits, budget=budget)
    t0 = time.perf_counter()
    child = subprocess.run([sys.executable, "-c", f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
                            f"chip_smoke.trace_tours({str(tours)!r}, {big9!r}, {big10!r})"],
                           capture_output=True, text=True, timeout=600)
    print("\n".join(f"  {line}" for line in child.stdout.splitlines()[:-1]))
    check(child.returncode == 0, f"quality path: the traces of K9 and K10 failed:\n{child.stdout[-3000:]}{child.stderr[-3000:]}")
    traces = json.loads(child.stdout.splitlines()[-1])
    trace_s = time.perf_counter() - t0
    for key in ("K9", "K10"):
        stats[f"{key} trace"] = traces[f"{key} trace"]
        stats[key]["alone_ms"] = traces[f"{key} alone_ms"]
    for key, what in (("K9", f"{big9}, n = {n9} ({stats['K9']['tour_route']} route)"),
                      ("K10", f"{big10}, n = {n10}, {moves} moves")):
        st = stats[key]
        print(f"{key} at the quality path's largest gated layer, {what}: {st['ms']:.3f} ms a call"
              + (f" ({st['alone_ms']:.3f} alone)" if st.get("alone_ms") else "")
              + f", plain PyTorch on the card {st['plain_ms']:.1f} ms"
              + (f", the host C++ planner {st['host_cpp_ms']:.1f} ms" if key == "K9" else "")
              + f", bound {st['bound_ms']:.4f} ms by {st['bound_by']}")
    print(f"phase 13 seconds: card run {wall:.1f}, --raster-device cpu steps 1-7 {cpu_s:.1f}, stage 12 against the plain "
          f"refiner {checks_s:.1f}, K9 at {big9} {k9_s:.1f}, K10 at {big10} {k10_s:.1f}, traces in a fresh process "
          f"{trace_s:.1f}")
    return counts


# --- phase 14: vector inputs and resize ---------------------------------------------------------------------------

# K13's cases: (input shape, (new_w, new_h), what); phase 14's resize path runs resize_if_needed(img, 2000) on the
# first two (the fractional and the 2 x 2 route)
RESIZE_CASES = [((3024, 4032, 3), (2000, 1500), "a 4032x3024 phone photo, fractional"),
                ((3000, 4000, 3), (2000, 1500), "4000x3000, 2x2"),
                ((3000, 3000, 3), (1000, 1000), "3000x3000, 3x3 (the reciprocal route)"),
                ((6000, 8000), (100, 75), "gray 8000x6000 to 100x75, an 80x80 box"),
                ((6000, 8000), (97, 73), "gray 8000x6000 to 97x73, fractional over 16 taps")]
POSTER_VIEWBOX = (4200, 2970)  # user units: an A3 sheet at 10 units a millimetre


def vector_poster(seed: int, paths: int = 1500, segments: int = 40, shapes: int = 500) -> str:
    """A seeded A3 "traced poster" SVG, as Inkscape or potrace would send it
    to the plotter: ``paths`` paths of ``segments`` short segments each,
    mixing C S Q T A L in absolute and relative form (about 60,000 curve
    segments), some closed, and ``shapes`` circles, ellipses and rects."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w, h = POSTER_VIEWBOX
    kinds = list("CcSsQqTtAaLl")
    weights = np.array([12, 12, 8, 8, 8, 8, 5, 5, 4, 4, 3, 3], float)
    points = {"C": 3, "S": 2, "Q": 2, "T": 1, "A": 1, "L": 1}
    body = []
    for _ in range(paths):
        cur = rng.uniform([200, 200], [w - 200, h - 200])
        d = [f"M{cur[0]:.2f} {cur[1]:.2f}"]
        for cmd in rng.choice(kinds, segments, p=weights / weights.sum()):
            pts = cur + np.cumsum(rng.normal(0, 5, (points[cmd.upper()], 2)), axis=0)
            end = pts[-1]
            if cmd in "Aa":
                r = rng.uniform(3, 12, 2)
                tgt = end if cmd == "A" else end - cur
                d.append(f"{cmd}{r[0]:.2f} {r[1]:.2f} {rng.uniform(0, 90):.1f} {int(rng.integers(0, 2))} "
                         f"{int(rng.integers(0, 2))} {tgt[0]:.2f} {tgt[1]:.2f}")
            else:
                d.append(cmd + " ".join(f"{x:.2f},{y:.2f}" for x, y in (pts if cmd.isupper() else pts - cur)))
            cur = end
        if rng.random() < 0.4:
            d.append("z")
        body.append(f'<path d="{"".join(d)}"/>')
    for i in range(shapes):
        x, y = rng.uniform([100, 100], [w - 100, h - 100])
        r = rng.uniform(3, 40, 2)
        body.append((f'<circle cx="{x:.2f}" cy="{y:.2f}" r="{r[0]:.2f}"/>',
                     f'<ellipse cx="{x:.2f}" cy="{y:.2f}" rx="{r[0]:.2f}" ry="{r[1]:.2f}"/>',
                     f'<rect x="{x:.2f}" y="{y:.2f}" width="{2 * r[0]:.2f}" height="{2 * r[1]:.2f}"/>')[i % 3])
    return (f'<svg xmlns="http://www.w3.org/2000/svg" width="420mm" height="297mm" viewBox="0 0 {w} {h}">'
            + "".join(body) + "</svg>")


def resize_bound(shape: tuple, nw: int, nh: int, taps: tuple | None) -> dict:
    """K13's least time: each input byte read once, each output byte written
    once; the fractional route's float32 operations (per output value and
    vertical tap, a product and an add per horizontal tap, then a product and
    an add) or the integer route's adds, one an input byte."""
    c = shape[2] if len(shape) == 3 else 1
    nbytes = shape[0] * shape[1] * c + nh * nw * c
    if taps is None:
        return bound(nbytes, shape[0] * shape[1] * c, INT32_OPS)
    th, tv = taps
    return bound(nbytes, nh * nw * c * tv * (2 * th + 2), FP32_OPS)


def area_library(x, nw: int, nh: int):
    """The yardstick: ``interpolate(mode="area")`` of a uint8 (H, W[, C])
    image with the conversions to float and back (not bit-exact with cv2)."""
    import torch.nn.functional as F

    t = (x.permute(2, 0, 1)[None] if x.dim() == 3 else x[None, None]).float()
    o = F.interpolate(t, size=(nh, nw), mode="area").round_().clamp_(0, 255).to(x.dtype)
    return o[0].permute(1, 2, 0) if x.dim() == 3 else o[0, 0]


def phase_vector_kernels(stats: dict) -> dict:
    """Phase 14, its first part (run right after the build: late in a long
    process the profiler there loses the events of a trace): K13 on the
    card.  Its path (the launch counts zeroed just before and read just
    after): ``resize_if_needed(img, 2000)`` on a 4032x3024 phone photo (the
    fractional route) and on a 4000x3000 image (2 x 2).  Then every case of
    RESIZE_CASES and ten seeded random sizes byte for byte against the plain
    versions on the card and ``cv2.resize(..., INTER_AREA)``; the times of
    both routes beside their plain versions, ``interpolate(mode="area")`` and
    their bounds.  K14 in one launch over 60,000 seeded cubics at n = 128
    against its plain version, timed beside ``torch.einsum``."""
    import cv2
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels, resize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)

    def image(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    photo, four_k = image(RESIZE_CASES[0][0]), image(RESIZE_CASES[1][0])
    kernels.reset_launches()
    (small_photo, r1), (small_4k, r2) = resize.resize_if_needed(photo, 2000), resize.resize_if_needed(four_k, 2000)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(r1 and r2 and tuple(small_photo.shape) == tuple(small_4k.shape) == (1500, 2000, 3),
          "resize_if_needed(img, 2000) on 4032x3024 and 4000x3000 did not give 2000x1500")
    check(launches["area_resize_frac"] == 1 and launches["area_resize_int"] == 1
          and sum(launches.values()) == 2, f"the resize path launched {launches}")
    same, r0 = resize.resize_if_needed(small_photo, 2000)
    check(same is small_photo and not r0, "resize_if_needed(img, 2000) on a 2000x1500 image is not a no-op")

    def plain(x, nw, nh):
        x3 = x if x.dim() == 3 else x[:, :, None]
        h, w = x.shape[:2]
        o = (resize.area_resize_int_plain(x3, h // nh, w // nw) if h % nh == 0 and w % nw == 0
             else resize.area_resize_frac_plain(x3, nw, nh))
        return o if x.dim() == 3 else o[:, :, 0]

    rng = np.random.default_rng(14)
    cases = [(photo, *RESIZE_CASES[0][1:]), (four_k, *RESIZE_CASES[1][1:])]
    cases += [(image(shape), size, what) for shape, size, what in RESIZE_CASES[2:]]
    for i in range(10):
        c = [None, 1, 3, 4][i % 4]
        if i % 3 == 0:  # an integer ratio
            sy, sx = (int(v) for v in rng.integers(1, 7, 2))
            nh, nw = (int(v) for v in rng.integers(8, 400, 2))
            h, w = nh * sy, nw * sx
            if (sy, sx) == (1, 1):
                h, w = h * 2, w * 2
        else:
            h, w = (int(v) for v in rng.integers(16, 3000, 2))
            nh, nw = int(rng.integers(1, h)), int(rng.integers(1, w))
        cases.append((image((h, w) if c is None else (h, w, c)), (nw, nh), f"random {h}x{w}x{c or 1} to {nw}x{nh}"))
    err = 0
    for x, (nw, nh), what in cases:
        got = (small_photo if x is photo else small_4k if x is four_k else resize.area_resize(x, nw, nh))
        ref = cv2.resize(x.cpu().numpy(), (nw, nh), interpolation=cv2.INTER_AREA).reshape(got.shape)
        want = plain(x, nw, nh)
        err = max(err, int((got.int() - want.int()).abs().max()))
        check(torch.equal(got, want), f"K13 != plain: {what}")
        check(np.array_equal(got.cpu().numpy(), ref), f"K13 != cv2.resize(INTER_AREA): {what}")
    print(f"K13 == plain == cv2.resize(INTER_AREA) on {len(cases)} cases: " + "; ".join(w for *_, w in cases))

    for key, x, fn_name in (("K13 frac", photo, "area_frac"), ("K13 int", four_k, "area_int")):
        h, w = x.shape[:2]
        integer = key.endswith("int")
        taps = None if integer else (resize._resize_area_tab(w, 2000)[0].shape[1],
                                     resize._resize_area_tab(h, 1500)[0].shape[1])
        st = {"max_abs_err": err, "case": f"{w}x{h}x3 -> 2000x1500",
              "ms": cuda_ms(lambda x=x: resize.area_resize(x, 2000, 1500), 20),
              "alone_ms": profiled_ms(lambda x=x: resize.area_resize(x, 2000, 1500), fn_name, 3),
              "plain_ms": cuda_ms(lambda x=x: plain(x, 2000, 1500), 3), **resize_bound(tuple(x.shape), 2000, 1500, taps)}
        st["library_ms"] = cuda_ms(lambda x=x: area_library(x, 2000, 1500), 20)
        stats[key] = st
        print(f"{key} at {st['case']}: {st['ms']:.4f} ms a call"
              + (f", {st['alone_ms']:.4f} alone" if st["alone_ms"] else "")
              + f", launches on the path {launches['area_resize_' + key[4:]]}, bound {st['bound_ms']:.4f} ms by "
              f"{st['bound_by']} ({st['bound_ms'] / (st['alone_ms'] or st['ms']):.0%} of it), plain PyTorch on the "
              f"card {st['plain_ms']:.3f} ms, interpolate(mode=\"area\") with its conversions {st['library_ms']:.4f} ms"
              + (f"; taps {taps[0]} x {taps[1]}" if taps else ""))

    from plotweave_torch.ops import bezier

    cubics = torch.rand((60000, 4, 2), device=dev, generator=gen) * torch.tensor(POSTER_VIEWBOX, device=dev)
    got, want = kernels.bezier_sample_cuda(cubics, 128), bezier.sample_bezier_plain(cubics, 128)
    err = float((got - want).abs().max())
    check(err <= 1e-5 * float(cubics.abs().max()), f"K14 != plain at 60,000 cubics x 128: {err}")
    bt = {"curves": 60000, "n": 128, "max_abs_err": err, "ms": cuda_ms(lambda: kernels.bezier_sample_cuda(cubics, 128), 20),
          "alone_ms": profiled_ms(lambda: kernels.bezier_sample_cuda(cubics, 128), "bezier_sample", 3),
          "plain_ms": cuda_ms(lambda: bezier.sample_bezier_plain(cubics, 128), 3),
          **bound(cubics.numel() * 4 + 60000 * 128 * 8, 60000 * 128 * 28, FP32_OPS)}
    bt["library_ms"] = cuda_ms(lambda b=bezier.bernstein_basis(128, 4, dev): torch.einsum("nk,skc->snc", b, cubics), 20)
    stats["K14 batched"] = bt
    print(f"K14 in one launch, 60,000 cubics x 128 samples: == plain within {err:.3e}; {bt['ms']:.4f} ms a call"
          + (f", {bt['alone_ms']:.4f} alone" if bt["alone_ms"] else "")
          + f", bound {bt['bound_ms']:.4f} ms by {bt['bound_by']} ({bt['bound_ms'] / (bt['alone_ms'] or bt['ms']):.0%} "
          f"of it), plain PyTorch on the card {bt['plain_ms']:.4f} ms, torch.einsum {bt['library_ms']:.4f} ms")
    return launches


def phase_vector_path(work: Path, stats: dict) -> dict:
    """Phase 14, its second part: the vector entry point.  ``python -m
    plotweave_torch.frontends.svg2stream`` (its ``main``, in this process) on
    a seeded A3 traced poster with ``--sampling-backend torch`` on the card
    (the launch counts zeroed just before and read just after) and with
    ``numpy``: the same path count, polylines within rtol 1e-4 and atol 1e-3
    of numpy float64, the torch stream decoding to EOF on the canvas; every
    curve family K14 sampled there against its plain version on the card
    (within 1e-5 of the largest |coordinate| of the call); the G-code
    goldens through ``gcode_to_stream``; the seconds of the parse, the
    sampling, the copy back, the G-code and the stream."""
    import unittest.mock as mock

    import numpy as np
    import torch

    from plotweave_torch.frontends import gcode, svg2gcode, svg2stream
    from plotweave_torch.ops import bezier, kernels
    from plotweave_torch.stream import MotionProfile
    from plotweave_torch.stream.decoder import StreamDecoder, replay

    t0 = time.perf_counter()
    poster = work / "poster.svg"
    poster.write_text(vector_poster(14))
    gen_s = time.perf_counter() - t0

    def run(backend: str) -> dict:
        """svg2stream's main, with timers around its parts and the sampler kept."""
        rec: dict = {"svg": 0.0, "gcode": 0.0, "stream": 0.0, "samplers": []}

        class Recording(bezier.BezierSampler):
            def __init__(self, device: str = "auto"):
                super().__init__(device)
                self.families: list = []
                rec["samplers"].append(self)

            def sample(self, ctrl, n):
                self.families.append((ctrl, n))
                return super().sample(ctrl, n)

        def timer(fn, key, keep=False):
            def wrapped(*args, **kwargs):
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                rec[key] += time.perf_counter() - t
                if keep:
                    rec[f"{key} out"] = out
                return out
            return wrapped

        out = work / f"poster_{backend}"
        with mock.patch.object(bezier, "BezierSampler", Recording), \
                mock.patch.object(svg2gcode, "svg_to_polylines", timer(svg2gcode.svg_to_polylines, "svg", True)), \
                mock.patch.object(svg2gcode, "polylines_to_gcode", timer(svg2gcode.polylines_to_gcode, "gcode")), \
                mock.patch.object(svg2stream, "gcode_to_stream", timer(svg2stream.gcode_to_stream, "stream")), \
                open(f"{out}.log", "w") as log, contextlib.redirect_stdout(log):
            kernels.reset_launches()
            t = time.perf_counter()
            svg2stream.main([str(poster), "-o", f"{out}.bin", "--gcode-out", f"{out}.gcode",
                             "--sampling-backend", backend])
            torch.cuda.synchronize()
            rec["wall"] = time.perf_counter() - t
            rec["launches"] = dict(kernels.LAUNCHES)
        rec["bin"], rec["gcode text"] = Path(f"{out}.bin").read_bytes(), Path(f"{out}.gcode").read_text()
        return rec

    card, host = run("torch"), run("numpy")
    launches = card["launches"]
    sampler = card["samplers"][0]
    check(launches["bezier_sample"] == sampler.calls > 0 and sum(launches.values()) == sampler.calls,
          f"the vector path launched {launches} for {sampler.calls} curve families")
    check(not host["samplers"] and host["launches"]["bezier_sample"] == 0, "the numpy backend sampled on the card")
    paths = card["gcode text"].count("M3")
    check(paths == host["gcode text"].count("M3") > 0, "torch and numpy G-code differ in their path counts")
    polys_t, polys_n = card["svg out"], host["svg out"]
    check(len(polys_t) == len(polys_n), "torch and numpy differ in their polyline counts")
    worst = 0.0
    for a, b in zip(polys_t, polys_n):
        check(a.shape == b.shape, "torch and numpy polylines differ in shape")
        worst = max(worst, float((np.abs(a - b) - 1e-4 * np.abs(b)).max()))
    check(worst <= 1e-3, f"torch polylines off numpy float64 by {worst} beyond rtol 1e-4 (atol 1e-3)")
    dec = StreamDecoder(card["bin"])
    meta = json.loads(Path(work / "poster_torch.json").read_text())
    replay(dec, *meta["canvas_steps"])
    check(dec.stats.eof_seen and dec.stats.off_canvas_steps == 0, "the torch poster stream does not decode cleanly")
    n_points = sum(len(p) for p in polys_t)
    print(f"vector path, A3 traced poster ({poster.stat().st_size / 1e6:.2f} MB SVG, {len(polys_t)} polylines, "
          f"{n_points} points): svg2stream --sampling-backend torch == numpy in paths ({paths}); polylines within "
          f"rtol 1e-4 (worst excess {worst:.2e} of atol 1e-3); stream {len(card['bin'])} bytes decodes to EOF on the "
          f"canvas; launches {launches}")

    # every family the path sampled: K14 against its plain version on the card, each call within 1e-5 of its
    # largest |coordinate|; then the whole path's families again for the times
    dev = torch.device("cuda")
    fams = [(torch.from_numpy(np.ascontiguousarray(c, dtype=np.float32)).to(dev), n) for c, n in sampler.families]
    err, rel = 0.0, 0.0
    for c, n in fams:
        d = float((kernels.bezier_sample_cuda(c, n) - bezier.sample_bezier_plain(c, n)).abs().max())
        err, rel = max(err, d), max(rel, d / max(float(c.abs().max()), 1e-30))
    check(rel <= 1e-5, f"K14 != plain beyond 1e-5 of the largest |coordinate|: {rel}")
    bases = [bezier.bernstein_basis(n, c.shape[1], dev) for c, n in fams]
    nbytes = sum(c.numel() * 4 + c.shape[0] * n * 8 for c, n in fams)
    flops = sum(c.shape[0] * n * (2 * 2 * c.shape[1] + 12) for c, n in fams)  # the basis about 12, 2 a term a coordinate
    st = {"max_abs_err": err, "max_rel_err": rel, "families": len(fams),
          "curves": sum(c.shape[0] for c, _ in fams), "points": sum(c.shape[0] * n for c, n in fams),
          "ms": cuda_ms(lambda: [kernels.bezier_sample_cuda(c, n) for c, n in fams], 3),
          "plain_ms": cuda_ms(lambda: [bezier.sample_bezier_plain(c, n) for c, n in fams], 1),
          **bound(nbytes, flops, FP32_OPS), "batched": stats.pop("K14 batched")}
    st["library_ms"] = cuda_ms(lambda: [torch.einsum("nk,skc->snc", b, c) for b, (c, _) in zip(bases, fams)], 1)
    stats["K14"] = st
    print(f"K14 == plain on the card on all {st['families']} curve families of the poster ({st['curves']} curves, "
          f"{st['points']} points; largest error {err:.3e}, {rel:.2e} of the largest |coordinate|); their "
          f"{st['families']} launches {st['ms']:.3f} ms, plain {st['plain_ms']:.3f} ms, torch.einsum "
          f"{st['library_ms']:.3f} ms, bound {st['bound_ms']:.4f} ms by {st['bound_by']}")
    parse = card["svg"] - sampler.seconds["sample"] - sampler.seconds["copy"]
    print(f"vector path seconds (torch | numpy): wall {card['wall']:.2f} | {host['wall']:.2f}; parse {parse:.2f} | "
          f"{host['svg']:.2f} (numpy's sampling inside); sampling on the card {sampler.seconds['sample']:.3f} "
          f"(upload, {sampler.calls} launches, synchronised); copy back {sampler.seconds['copy']:.3f}; G-code "
          f"{card['gcode']:.2f} | {host['gcode']:.2f}; stream {card['stream']:.2f} | {host['stream']:.2f}; the "
          f"poster's generation {gen_s:.2f}")

    text = (GOLDEN / "gcode" / "sample.gcode").read_text()
    g1, _ = gcode.gcode_to_stream(text, invert_y=True, profile=MotionProfile(invert_y=True), speed_scale=1.3)
    g2, _ = gcode.gcode_to_stream(text, reorder=False, profile=MotionProfile())
    check(g1 == (GOLDEN / "gcode" / "ref_g.bin").read_bytes() and g2 == (GOLDEN / "gcode" / "ref_g2.bin").read_bytes(),
          "gcode_to_stream != the G-code goldens")
    print("gcode_to_stream(sample.gcode) == ref_g.bin (invert_y, speed 1.3) and ref_g2.bin (no reorder)")
    return launches


def phase_shard_path(work: Path) -> None:
    """Phase 14, its last part: the main path on the card with
    ``--shard-rows 4`` (one card: the unsharded chain), ``plot_stream.bin``
    byte-equal to phase 5's card run."""
    from plotweave_torch.ops import kernels

    out = work / "synthetic_shard4"
    kernels.reset_launches()
    run_main(str(work / "synthetic.png"), out, "auto", flags=("--shard-rows", "4"))
    launched = {n: kernels.LAUNCHES[n] for n in CHAIN_LAUNCHES}
    check(launched == CHAIN_LAUNCHES and kernels.LAUNCHES["bitpack"] == 0,
          f"--shard-rows 4 on one card: the chain launched {launched}, K1 {kernels.LAUNCHES['bitpack']}")
    check("row-sharded over 1 device(s)" in Path(f"{out}.log").read_text(), "--shard-rows 4: no [shard] line")
    check((out / "plot_stream.bin").read_bytes() == (work / "synthetic_cuda" / "plot_stream.bin").read_bytes(),
          "--shard-rows 4 on one card: plot_stream.bin != phase 5's card run")
    print(f"main path with --shard-rows 4 on one card: the unsharded chain ({launched}); plot_stream.bin == phase 5's")


def phase_vector_and_shard(work: Path, stats: dict) -> dict:
    """Phase 14 after phase 13: the vector entry point with K14, the G-code
    goldens, and row sharding on one card; the seconds of each part."""
    seconds = {}
    launches = {}
    for name, fn, args in (("vector", phase_vector_path, (work, stats)), ("shard", phase_shard_path, (work,))):
        t0 = time.perf_counter()
        launches[name] = fn(*args)
        seconds[name] = time.perf_counter() - t0
    print("phase 14 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    return launches


# --- phase 15: the JAX package's meshes ----------------------------------------------------------------------------

MESH_POSTERS = 4  # frontend_batch's batch: posters of phase 6's size, two on each data shard
SHARD_CPUS = 4  # the CPU pool of (c) and (d): --shard-rows 4 over four CPU devices


def cpu_model() -> str:
    """The host CPU's model name: /proc/cpuinfo's, else lscpu's, else the
    architecture's."""
    import platform

    lines = Path("/proc/cpuinfo").read_text().splitlines()
    with contextlib.suppress(OSError):
        lines += subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30).stdout.splitlines()
    for line in lines:
        key, _, value = line.partition(":")
        if key.strip().lower() == "model name" and value.strip():
            return value.strip()
    return platform.processor() or platform.machine()


def launched_now() -> dict:
    from plotweave_torch.ops import kernels

    return {n: c for n, c in kernels.LAUNCHES.items() if c}


def phase_mesh(work: Path, stats: dict) -> dict:
    """Phase 15: (a) ``frontend_batch`` over a data mesh that names the card
    twice, both thinning routes, against one ``raster_frontend`` call; (b)
    ``run_pipeline_batch(devices=[cuda:0, cuda:0])`` against phase 11's
    sequential runs; (c) ``sharded_chain`` over a 4-shard CPU space mesh
    against the card's ``chain_from_clean``; (d) the main path with
    ``--raster-device cpu --shard-rows 4`` in a process whose ``XLA_FLAGS``
    sets 4 CPU devices, against phase 5's card run."""
    import os
    import re

    import numpy as np
    import torch

    from plotweave_torch.config import load_config
    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.frontend import raster_frontend
    from plotweave_torch.parallel import frontend_batch, make_mesh, sharded_chain
    from plotweave_torch.pipeline import run_pipeline_batch
    from plotweave_torch.stages.s02_color_extract import chain_from_clean

    card, cpu = torch.device("cuda", 0), torch.device("cpu")
    twice = [card, card]
    seconds, out = {}, {}

    # (a) two images a data shard, each shard one raster_frontend call on the card
    t0 = time.perf_counter()
    h, w = FRONTEND_SHAPE
    imgs = torch.from_numpy(np.stack([synthetic_image(200 + i, h, w)[0] for i in range(MESH_POSTERS)])).to(card)
    c = torch.from_numpy(np.array(BENCH_CENTERS, np.float32)).to(card)
    data = make_mesh((2,), ("data",), devices=twice)
    half = MESH_POSTERS // 2
    for route in (False, True):
        solo = raster_frontend(imgs, c, k=4, pallas_thinning=route)
        kernels.reset_launches()
        got = frontend_batch(data, imgs, c, k=4, pallas_thinning=route)
        torch.cuda.synchronize()
        launches = launched_now()
        kernels.reset_launches()
        for part in (imgs[:half], imgs[half:]):
            raster_frontend(part, c, k=4, pallas_thinning=route)
        torch.cuda.synchronize()
        check(launches == launched_now(), f"frontend_batch (pallas_thinning={route}): launches {launches}, its two "
              f"shards' raster_frontend calls {launched_now()}")
        once = ("assign_nearest", "morph_bits", "edge_candidates", "hysteresis") + (() if route else ("zhang_suen_packed",))
        check(all(launches.get(n) == 2 for n in once) and launches.get("bitpack", 0) == (6 if route else 0)
              and (launches.get("zhang_suen_dense", 0) >= 2) == route,
              f"frontend_batch (pallas_thinning={route}): launches {launches}, expected each front-end kernel once a "
              "data shard")
        check(torch.equal(got[0].cpu(), solo[0].cpu()) and torch.equal(got[1].cpu(), solo[1].cpu()),
              f"frontend_batch (pallas_thinning={route}) != one raster_frontend call over the batch")
        common = {"assign_nearest": 2, "morph_steps": 2, "edge_tiles": 2, "hysteresis_cluster": 2}
        rest = ({"zs_tiles": launches.get("zhang_suen_dense"), "boards_to_dense": 4, "dense_to_boards": 2} if route
                else {"zs_cluster": 2})
        only_own_kernels(lambda route=route: frontend_batch(data, imgs, c, k=4, pallas_thinning=route),
                         f"frontend_batch, {MESH_POSTERS} x {h}x{w} over [cuda:0, cuda:0], pallas_thinning={route}",
                         {**common, **rest})
        out[f"frontend_batch ms {route}"] = cuda_ms(lambda route=route: frontend_batch(
            data, imgs, c, k=4, pallas_thinning=route), 5)
        out[f"raster_frontend ms {route}"] = cuda_ms(lambda route=route: raster_frontend(
            imgs, c, k=4, pallas_thinning=route), 5)
        print(f"frontend_batch, {MESH_POSTERS} posters {h}x{w} k=4 over [cuda:0, cuda:0], pallas_thinning={route}: == "
              f"one raster_frontend call; launches {launches}; {out[f'frontend_batch ms {route}']:.3f} ms a call "
              f"against {out[f'raster_frontend ms {route}']:.3f} for the one call (CUDA events)")
    seconds["a"] = time.perf_counter() - t0

    # (b) phase 11's first four images through the batch runner, the data axis naming the card twice
    t0 = time.perf_counter()
    cfgs = []
    for i in range(4):
        run = work / "mesh_batch" / f"run{i}"
        run.mkdir(parents=True)
        (run / "config.json").write_text(json.dumps({"input_image": str(work / f"batch{i}.png"), "output_dir": str(run)}))
        cfgs.append(load_config(str(run / "config.json")))
    kernels.reset_launches()
    with open(work / "mesh_batch.log", "w") as log, contextlib.redirect_stdout(log):
        times = run_pipeline_batch(cfgs, 1, 4, devices=twice)
    launches = launched_now()
    text = (work / "mesh_batch.log").read_text()
    check(all(t > 0 for t in times), f"run_pipeline_batch over [cuda:0, cuda:0]: an image failed: {times}")
    check("[batch] mesh data-parallelism over 2 device(s)" in text, "run_pipeline_batch: no data-parallelism line")
    m = re.search(r"grouped: (\d+) image chain\(s\) in (\d+) grouped call", text)
    check(m is not None and int(m.group(1)) == 4, "run_pipeline_batch over [cuda:0, cuda:0]: not every chain grouped")
    groups = int(m.group(2))
    chain = [launches.get(n, 0) for n in CHAIN_LAUNCHES]
    check(len(set(chain)) == 1 and groups <= chain[0] <= 2 * groups,
          f"run_pipeline_batch: {groups} groups over two data shards, launches {launches}")
    names = list(cfgs[0].color_names)
    for i, cfg in enumerate(cfgs):
        diff = same_artifacts(work / "batch_seq" / f"run{i}", Path(cfg.output_dir), names, stream=False)
        check(not diff, f"run_pipeline_batch over [cuda:0, cuda:0]: image {i} != phase 11's sequential run: {diff}")
    seconds["b"] = time.perf_counter() - t0
    print(f"run_pipeline_batch, 4 images 2000x1500, steps 1-4, devices [cuda:0, cuda:0]: every mask, edges and "
          f"contours file == phase 11's sequential runs; 4 chains in {groups} groups, launches {launches}; "
          f"{seconds['b']:.2f} s")

    # (c) the chain's masks row-sharded over four CPU devices against the card's blob
    t0 = time.perf_counter()
    k, h, w = CHAIN_SHAPE
    _, bins = synthetic_image(1, h, w)
    packed = np.packbits(np.stack([bins == j for j in range(k)]), axis=-1)
    blob = chain_from_clean(packed, w, *EDGE_PARAMS, device=card).cpu()
    out["card chain ms"] = cuda_ms(lambda: chain_from_clean(packed, w, *EDGE_PARAMS, device=card), 5)
    space = make_mesh((SHARD_CPUS,), ("space",), devices=[cpu] * SHARD_CPUS)
    t1 = time.perf_counter()
    host = sharded_chain(space, packed, w, *EDGE_PARAMS)
    out["host sharded chain s"] = time.perf_counter() - t1
    out["cpu"] = cpu_model()
    check(torch.equal(host, blob), f"sharded_chain over {SHARD_CPUS} CPU shards != the card's chain_from_clean blob")
    seconds["c"] = time.perf_counter() - t0
    print(f"sharded_chain over a {SHARD_CPUS}-shard CPU space mesh, {k}x{h}x{w}: == the card's chain_from_clean "
          f"blob; {out['host sharded chain s']:.3f} s on the host ({out['cpu']}, {os.cpu_count()} logical CPUs) "
          f"against {out['card chain ms']:.3f} ms a call on the card (CUDA events, upload included)")

    # (d) the main path on the CPU pool, in a process of its own whose XLA_FLAGS sets its size
    t0 = time.perf_counter()
    run = work / "synthetic_cpu_shard4"
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARD_CPUS}")
    proc = subprocess.run([sys.executable, "-m", "plotweave_torch", str(work / "synthetic.png"), "--output", str(run),
                           "--raster-device", "cpu", "--shard-rows", "4"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    Path(f"{run}.log").write_text(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"--raster-device cpu --shard-rows 4: exit {proc.returncode}: {proc.stderr[-2000:]}")
    check(f"[shard] raster chain row-sharded over {SHARD_CPUS} device(s)" in proc.stdout,
          "--raster-device cpu --shard-rows 4: no [shard] line for 4 devices")
    check((run / "plot_stream.bin").read_bytes() == (work / "synthetic_cuda" / "plot_stream.bin").read_bytes(),
          "--raster-device cpu --shard-rows 4: plot_stream.bin != phase 5's card run")
    seconds["d"] = time.perf_counter() - t0
    print(f"main path, synthetic 2000x1500, --raster-device cpu --shard-rows 4 over {SHARD_CPUS} CPU devices: "
          f"row-sharded over 4; plot_stream.bin == phase 5's card run; {seconds['d']:.1f} s in its own process")

    print("phase 15 seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    stats["mesh"] = out
    return out


SPACE_SHARDS = (4, 8)  # phase 16: the shards asked for the chain (fit_shard_rows: 1500 rows take 4 and 6)
SLAB_CASE = (2, 256, 1000)  # layers, H, W: four slabs of 64 rows, 31.25 words a row


def space_rounds() -> dict:
    """The rounds of the last sharded program's fixpoints."""
    from plotweave_torch.ops import kernels

    return {"hysteresis": kernels.STATS["hysteresis_rounds"], "thinning": kernels.STATS["thinning_rounds"]}


def slab_positions(x, halo: int):
    """The four slabs of ``x`` widened by ``halo`` rows (top, two middles,
    bottom) and ``x`` alone, on the card: (buffer, top, bottom) each."""
    import torch

    from plotweave_torch.parallel.spatial import split_rows, widen

    return widen(split_rows(x, [torch.device("cuda", 0)] * 4), halo) + [(x, 0, 0)]


def slab_cases(stats: dict) -> None:
    """Each slab kernel against its plain slab version on the card, on the
    same buffers: every slab position, a width of 31.25 words, a weak edge
    that crosses every shard, a thick disc that needs many iterations."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.canny import edge_candidates_plain, edge_candidates_slab_plain, hysteresis_slab_plain
    from plotweave_torch.ops.filters import gaussian_blur_slab_plain
    from plotweave_torch.ops.morphology import morph_dense, morph_program
    from plotweave_torch.ops.thinning import zhang_suen_slab_plain
    from plotweave_torch.parallel.spatial import canny_halo, morph_prog_halo, split_rows, thin_halo

    card = torch.device("cuda", 0)
    k, h, w = SLAB_CASE
    mk, oi, ci, bk, lo, hi = EDGE_PARAMS
    rng = np.random.default_rng(16)
    yy, xx = np.mgrid[0:h, 0:w]
    gray = np.stack([synthetic_image(16 + i, h, w)[0][..., i] for i in range(k)])
    boards = kernels.dense_to_boards_cuda(torch.from_numpy(random_boards(rng, k, h, w)).to(card))
    dense = torch.from_numpy(gray).to(card)
    n = 0
    for x, what in ((boards, "a board"), (dense, "a dense image")):
        for ksize in (bk, 7):
            for buf, top, bottom in slab_positions(x, ksize // 2 + 2):
                got = kernels.edge_candidates_slab_cuda(buf, w, ksize, lo, hi, top, bottom)
                ref = edge_candidates_slab_plain(buf, w, ksize, lo, hi, top, bottom)
                check(all(torch.equal(a, b) for a, b in zip(got, ref)),
                      f"K3+K4 slab mode != plain: {what}, ksize {ksize}, halos {top}, {bottom}")
                n += 1
            for buf, top, bottom in slab_positions(x, ksize // 2):
                got = kernels.gaussian_blur_slab_cuda(buf, ksize, top, bottom, w)
                check(torch.equal(got, gaussian_blur_slab_plain(buf, ksize, top, bottom, w)),
                      f"K3+K4 blur-only slab mode != plain: {what}, ksize {ksize}, halos {top}, {bottom}")
                n += 1
    # the hysteresis of a weak step down every row, strong only in the last rows: each slab's seeds come from below
    weak = np.zeros((k, h, w), np.uint8)
    weak[:, :, 300:] = 10
    weak[:, -6:, 300:] = 40
    weak_c = torch.from_numpy(weak).to(card)
    cand, strong = (t.contiguous() for t in edge_candidates_plain(weak_c, w, 1, lo, hi))
    flag_k, flag_p = torch.empty(1, dtype=torch.int32, device=card), torch.empty(1, dtype=torch.int32, device=card)
    for source in (strong, kernels.hysteresis_cuda(cand, strong)):
        for (buf, top, bottom), c in zip(slab_positions(source, 1), split_rows(cand, [card] * 4) + [cand]):
            got = kernels.hysteresis_slab_cuda(c, buf, top, bottom, flag_k)
            ref = hysteresis_slab_plain(c, buf, top, bottom, flag_p)
            check(torch.equal(got, ref) and int(flag_k) == int(flag_p),
                  f"K5 slab mode != plain: halos {top}, {bottom}, flag {int(flag_k)} against {int(flag_p)}")
            n += 1
    # the gray morphology (K11, no slab mode) on slabs widened by the program's summed radius
    for shape, ksize, iterations, program in (("ellipse", 7, 2, "ed"), ("rect", 3, 1, "de"), ("cross", 5, 1, "ed")):
        got = torch.cat(morph_prog_halo(split_rows(dense, [card] * 4), shape, ksize, iterations, program), dim=-2)
        check(torch.equal(got, morph_dense(dense, morph_program(shape, ksize, iterations, program))),
              f"morph_prog_halo over 4 card slabs, {shape} {ksize} x {iterations} {program}: != unsharded K11")
        n += 1
    edges = torch.cat(canny_halo(split_rows(weak_c, [card] * 4), lo, hi), dim=-2)
    rounds = kernels.STATS["hysteresis_rounds"]
    ref = kernels.boards_to_dense_cuda(kernels.hysteresis_cuda(cand, strong), w, 255)
    check(torch.equal(edges, ref) and bool(ref[:, 0].any()) and rounds >= 5,
          f"the weak edge over 4 card slabs: != unsharded, or {rounds} rounds")
    # thinning of a thick disc, 80 px across, in rounds of at most 32 iterations; also capped mid-round
    disc = ((yy - 128) ** 2 + (xx - 500) ** 2 <= 80**2) | ((yy > 10) & (yy < 246) & (xx > 100) & (xx < 160))
    disc_d = torch.from_numpy(np.stack([disc] * k).astype(np.uint8)).to(card)
    disc_b = kernels.dense_to_boards_cuda(disc_d)
    rb = -(-w // 8)
    for layout in ("rows", "dense"):
        width = rb if layout == "rows" else w
        for buf, top, bottom in slab_positions(disc_b, 2 * 16):
            own = buf.shape[-2] - top - bottom
            outs = [torch.full((2, 1, k, h, width), 0xA5, dtype=torch.uint8, device=card) for _ in range(2)]
            got = kernels.zhang_suen_slab_cuda(buf, top, bottom, 16, flag_k, w, outs[0][0], outs[0][1], layout, h - own)
            ref = zhang_suen_slab_plain(buf, top, bottom, 16, flag_p, w, outs[1][0], outs[1][1], layout, h - own)
            check(torch.equal(got, ref) and int(flag_k) == int(flag_p) and torch.equal(outs[0], outs[1]),
                  f"K6 slab mode != plain: {layout}, halos {top}, {bottom}, row {h - own}")
            n += 1
    for max_iter in (120, 45):
        skels = thin_halo(split_rows(disc_d, [card] * 4), max_iter)
        ref = kernels.boards_to_dense_cuda(kernels.zhang_suen_packed_cuda(disc_b, max_iter), w, 1, torch.int32)
        check(torch.equal(torch.cat(skels, dim=-2), ref), f"the thick disc over 4 card slabs, max_iter {max_iter}: "
              "!= unsharded K6")
        print(f"  thin_halo over 4 card slabs, max_iter {max_iter}: == unsharded K6 in {kernels.STATS['thinning_rounds']} rounds")
    print(f"slab modes: {n} cases of K3+K4 (boards, dense, blur only), K5 and K6 (rows, dense) == their plain slab "
          f"versions on the card at {k}x{h}x{w} (top, middle, bottom, alone), and K11's programs over 4 card slabs == "
          f"unsharded; the weak edge over 4 card slabs == unsharded in {rounds} hysteresis rounds")


WIDE_SHARDS = 2  # phase 16 (c): a 4400 x 8800 layer over two slabs of 2,200 rows, too large for one cluster


def wide_slabs(out: dict) -> None:
    """``sharded_chain`` over ``[cuda:0] * 2`` on a 4400 x 8800 layer (the
    4400 x 4400 poster's mask beside its mirror image): slabs of 2,200 rows
    of 275 words, widened, hold more rows than one cluster (1,664 for K6,
    1,632 for K5), so each slab mode runs its slab as bands (K6 in one
    launch a shard and round, K5 by rounds inside its call); byte-equal to
    the unsharded chain (itself banded).  Until the banded route, such a
    slab raised."""
    import numpy as np
    import torch

    from plotweave_torch.ops import kernels
    from plotweave_torch.parallel import make_mesh, sharded_chain
    from plotweave_torch.stages.s02_color_extract import chain_from_clean

    card = torch.device("cuda", 0)
    bins = big_bins() == 0
    w = 2 * BIG_SIDE
    wide = torch.from_numpy(np.packbits(np.concatenate([bins, bins[:, ::-1]], axis=1)[None], axis=-1)).to(card)
    rows, nw = BIG_SIDE // WIDE_SHARDS, -(-w // 32)
    m = kernels.thinning_round(rows, nw, 120)
    k6 = kernels.slab_bands("zhang_suen_packed", rows + 2 * m, nw, 0, rows, m)
    k5 = kernels.slab_bands("hysteresis", rows + 1, nw, 0, rows)
    check(len(k6.bands) > 1 and len(k5.bands) > 1, f"the {BIG_SIDE}x{w} slabs fit one cluster: {k6}, {k5}")
    solo = chain_from_clean(wide, w, *EDGE_PARAMS, device=card)
    space = make_mesh((WIDE_SHARDS,), ("space",), devices=[card] * WIDE_SHARDS)
    kernels.reset_launches()
    blob = sharded_chain(space, wide, w, *EDGE_PARAMS)
    torch.cuda.synchronize()
    launches, rounds = launched_now(), space_rounds()
    check(torch.equal(blob, solo), f"sharded_chain over [cuda:0] x {WIDE_SHARDS} != chain_from_clean at "
          f"1x{BIG_SIDE}x{w}")
    check(launches.get("zhang_suen_packed_slab") == WIDE_SHARDS * rounds["thinning"]
          and launches.get("hysteresis_slab", 0) >= WIDE_SHARDS * rounds["hysteresis"]
          and launches.get("morph_bits") == launches.get("edge_candidates_slab") == WIDE_SHARDS
          and not any(name in launches for name in MULTI_KERNELS + BANDED_KERNELS),
          f"sharded_chain over [cuda:0] x {WIDE_SHARDS} at 1x{BIG_SIDE}x{w}: launches {launches}, rounds {rounds}")
    out["wide"] = {"sharded ms": cuda_ms(lambda: sharded_chain(space, wide, w, *EDGE_PARAMS), 3),
                   "unsharded ms": cuda_ms(lambda: chain_from_clean(wide, w, *EDGE_PARAMS, device=card), 3),
                   "launches": launches, "rounds": rounds, "m": m, "K6 bands": len(k6.bands),
                   "K5 bands": len(k5.bands)}
    print(f"sharded_chain over [cuda:0] x {WIDE_SHARDS} at 1x{BIG_SIDE}x{w} (slabs of {rows} rows, too large for "
          f"one cluster: K6 {len(k6.bands)} bands a slab at m = {m}, K5 {len(k5.bands)}): == chain_from_clean; "
          f"launches {launches}, rounds {rounds}; {out['wide']['sharded ms']:.3f} ms a call against the unsharded "
          f"chain's {out['wide']['unsharded ms']:.3f} (CUDA events)")


def phase_space_mesh(work: Path, stats: dict) -> dict:
    """Phase 16: the ``space`` axis on the card.  (a) each slab kernel
    against its plain slab version; (b) ``sharded_chain`` over ``[cuda:0] *
    4`` and ``* 8`` on the chain's 4 x 1500 x 2000 masks against the card's
    ``chain_from_clean``, launches per shard and round, a trace; (c) over
    ``[cuda:0] * 4`` on the 4400 x 4400 layer against the unsharded
    chain's banded route, and over ``[cuda:0] * 2`` on a 4400 x 8800 layer
    whose slabs do not fit one cluster (:func:`wide_slabs`); (d) ``spatial_frontend`` and ``grid_frontend``
    against ``raster_frontend``; (e) ``dryrun_multichip(4, [cuda:0] * 4)``."""
    import numpy as np
    import torch

    from plotweave_torch.entry import dryrun_multichip
    from plotweave_torch.ops import kernels
    from plotweave_torch.ops.canny import edge_candidates_slab_plain, hysteresis_slab_plain
    from plotweave_torch.ops.filters import gaussian_blur_slab_plain
    from plotweave_torch.ops.frontend import raster_frontend
    from plotweave_torch.ops.morphology import _valid_bits
    from plotweave_torch.ops.thinning import zhang_suen_slab_plain
    from plotweave_torch.parallel import make_mesh, sharded_chain
    from plotweave_torch.parallel.spatial import (
        blur_halo, fit_shard_rows, grid_frontend, spatial_frontend, split_rows, widen)
    from plotweave_torch.stages.s02_color_extract import chain_from_clean

    card = torch.device("cuda", 0)
    seconds, out = {}, {}

    t0 = time.perf_counter()
    slab_cases(stats)
    seconds["a"] = time.perf_counter() - t0

    # (b) the chain's masks over 4 and 8 card slabs
    t0 = time.perf_counter()
    k, h, w = CHAIN_SHAPE
    mk, oi, ci, bk, lo, hi = EDGE_PARAMS
    _, bins = synthetic_image(1, h, w)
    packed = torch.from_numpy(np.packbits(np.stack([bins == j for j in range(k)]), axis=-1)).to(card)
    solo = chain_from_clean(packed, w, *EDGE_PARAMS, device=card)
    out["chain ms"] = cuda_ms(lambda: chain_from_clean(packed, w, *EDGE_PARAMS, device=card), 10)
    for asked in SPACE_SHARDS:
        n = fit_shard_rows(h, asked, asked, max(2, mk // 2, bk // 2))
        space = make_mesh((n,), ("space",), devices=[card] * n)
        kernels.reset_launches()
        blob = sharded_chain(space, packed, w, *EDGE_PARAMS)
        torch.cuda.synchronize()
        launches, rounds = launched_now(), space_rounds()
        check(torch.equal(blob, solo), f"sharded_chain over [cuda:0] x {n} != the card's chain_from_clean")
        want = {"morph_bits": n, "edge_candidates_slab": n, "hysteresis_slab": n * rounds["hysteresis"],
                "zhang_suen_packed_slab": n * rounds["thinning"]}
        check(launches == want, f"sharded_chain over [cuda:0] x {n}: launches {launches}, expected {want}")
        trace = only_own_kernels(lambda space=space: sharded_chain(space, packed, w, *EDGE_PARAMS),
                                 f"sharded_chain over [cuda:0] x {n}, {k}x{h}x{w}",
                                 {"morph_steps": n, "edge_tiles": n, "hysteresis_cluster": want["hysteresis_slab"],
                                  "zs_cluster": want["zhang_suen_packed_slab"]}, timed="", copies=True)
        ms = cuda_ms(lambda space=space: sharded_chain(space, packed, w, *EDGE_PARAMS), 10)
        alone = profiled_ms(lambda space=space: sharded_chain(space, packed, w, *EDGE_PARAMS), "", 5)
        out[f"sharded {n}"] = {"ms": ms, "kernels alone ms": alone, "launches": launches, "rounds": rounds,
                               "trace": trace}
        if asked == SPACE_SHARDS[0]:
            out["sharded launches"] = launches
        print(f"sharded_chain over [cuda:0] x {n} ({asked} asked), {k}x{h}x{w}: == chain_from_clean; hysteresis {rounds['hysteresis']} "
              f"rounds, thinning {rounds['thinning']} (m = {kernels.thinning_round(h // n, -(-w // 32), 120)}); "
              f"launches {launches}; {ms:.3f} ms a call (CUDA events), kernels alone "
              + (f"{alone:.3f} ms" if alone else "not measured")
              + f"; the unsharded chain {out['chain ms']:.3f} ms a call")
    seconds["b"] = time.perf_counter() - t0

    # the kernels' rows at the 4-shard chain's shapes: the slabs as sharded_chain hands them over
    n = fit_shard_rows(h, SPACE_SHARDS[0], SPACE_SHARDS[0])
    steps = MAIN_PATH_STEPS
    radius = sum(ks // 2 for _, ks, _ in steps) + bk // 2 + 2
    bufs = [(kernels.morph_steps_cuda(buf, _valid_bits(w, card), steps, w), top, bottom)
            for buf, top, bottom in widen(split_rows(packed, [card] * n), radius)]
    mid, top, bottom = bufs[1]
    words = k * (h // n) * -(-w // 32)

    def k34():
        return kernels.edge_candidates_slab_cuda(mid, w, bk, lo, hi, top, bottom)

    cand, strong = k34()
    ref = edge_candidates_slab_plain(mid, w, bk, lo, hi, top, bottom)
    stats["K3+K4 slab"] = {"max_abs_err": max(max_abs_err(cand, ref[0]), max_abs_err(strong, ref[1])),
                           "ms": cuda_ms(k34, 20), "plain_ms": cuda_ms(
                               lambda: edge_candidates_slab_plain(mid, w, bk, lo, hi, top, bottom), 3),
                           "alone_ms": profiled_ms(k34, "edge_tiles", 20),
                           **bound(mid.numel() * 4 + 2 * words * 4, k * (h // n) * w * (2 * bk + EDGE_OPS_FIXED),
                                   INT32_OPS)}
    dense_mid = torch.from_numpy(np.stack([synthetic_image(5, mid.shape[-2], w)[0][..., 0]] * k)).to(card)

    def blur():
        return kernels.gaussian_blur_slab_cuda(dense_mid, bk, bk // 2, bk // 2)

    stats["K3+K4 blur slab"] = {"max_abs_err": max_abs_err(blur(), gaussian_blur_slab_plain(dense_mid, bk, bk // 2,
                                                                                            bk // 2)),
                                "ms": cuda_ms(blur, 20),
                                "plain_ms": cuda_ms(lambda: gaussian_blur_slab_plain(dense_mid, bk, bk // 2, bk // 2), 3),
                                "alone_ms": profiled_ms(blur, "edge_tiles", 20),
                                **bound(dense_mid.numel() + k * (dense_mid.shape[-2] - 2 * (bk // 2)) * w, k * (
                                    dense_mid.shape[-2] - 2 * (bk // 2)) * w * (2 * bk + 4), INT32_OPS)}
    e_buf = torch.cat([strong[:, -1:], strong, strong[:, :1]], dim=1)  # a one-row halo on each side
    flag = torch.empty(1, dtype=torch.int32, device=card)

    def k5():
        return kernels.hysteresis_slab_cuda(cand, e_buf, 1, 1, flag)

    stats["K5 slab"] = {"max_abs_err": max_abs_err(k5(), hysteresis_slab_plain(cand, e_buf, 1, 1, flag.clone())),
                        "ms": cuda_ms(k5, 20), "plain_ms": cuda_ms(
                            lambda: hysteresis_slab_plain(cand, e_buf, 1, 1, flag.clone()), 3),
                        "alone_ms": profiled_ms(k5, "hysteresis_cluster", 20),
                        **bound(2 * words * 4 + e_buf.numel() * 4, words * HYST_OPS_PER_WORD, INT32_OPS)}
    m = kernels.thinning_round(h // n, -(-w // 32), 120)
    z_buf = widen(split_rows(kernels.hysteresis_cuda(*kernels.edge_candidates_cuda(
        kernels.morph_steps_cuda(packed, _valid_bits(w, card), steps, w), w, bk, lo, hi)), [card] * n), 2 * m)[1]
    zb, ztop, zbottom = z_buf
    blob = torch.empty((2, 1, k, h, -(-w // 8)), dtype=torch.uint8, device=card)

    def k6():
        return kernels.zhang_suen_slab_cuda(zb, ztop, zbottom, m, flag, w, blob[0], blob[1], "rows", h // n)

    blob_p = blob.clone()
    got6 = k6()
    ref6 = zhang_suen_slab_plain(zb, ztop, zbottom, m, flag.clone(), w, blob_p[0], blob_p[1], "rows", h // n)
    iters = kernels.STATS["zhang_suen_packed_slab"].tolist()  # each layer's iterations
    stats["K6 slab"] = {"max_abs_err": max(max_abs_err(got6, ref6), max_abs_err(blob, blob_p)), "ms": cuda_ms(k6, 20),
                        "plain_ms": cuda_ms(lambda: zhang_suen_slab_plain(zb, ztop, zbottom, m, flag.clone(), w,
                                                                          blob_p[0], blob_p[1], "rows", h // n), 3),
                        "alone_ms": profiled_ms(k6, "zs_cluster", 20), "iterations": iters,
                        **bound(zb.numel() * 4 + 2 * k * (h // n) * -(-w // 8) + words * 4,
                                sum(iters) * (words // k) * 2 * ZS_OPS_PER_WORD, INT32_OPS)}
    for key in ("K3+K4 slab", "K3+K4 blur slab", "K5 slab", "K6 slab"):
        st = stats[key]
        check(st["max_abs_err"] == 0, f"{key} != plain at the 4-shard chain's middle slab")
        print(f"{key} at the 4-shard chain's middle slab: {st['ms']:.4f} ms a call, "
              + (f"{st['alone_ms']:.4f} ms alone, " if st.get("alone_ms") else "")
              + f"plain {st['plain_ms']:.4f} ms, bound {st['bound_ms']:.5f} ms by {st['bound_by']}")

    # blur_halo over [cuda:0] x 4: the path of the blur-only slab mode's launches
    dense = torch.from_numpy(np.stack([synthetic_image(6, h, w)[0][..., 0]] * k)).to(card)
    slabs = split_rows(dense, [card] * 4)
    kernels.reset_launches()
    blurred = blur_halo(slabs, bk)
    torch.cuda.synchronize()
    out["blur launches"] = launched_now()
    check(torch.equal(torch.cat(blurred, dim=-2), kernels.gaussian_blur_cuda(dense, bk)),
          "blur_halo over [cuda:0] x 4 != the unsharded blur")

    # (c) the 4400 x 4400 layer: one cluster per slab where the whole layer takes the banded route
    t0 = time.perf_counter()
    big = torch.from_numpy(np.packbits((big_bins() == 0)[None], axis=-1)).to(card)
    solo = chain_from_clean(big, BIG_SIDE, *EDGE_PARAMS, device=card)
    space = make_mesh((4,), ("space",), devices=[card] * 4)
    kernels.reset_launches()
    blob = sharded_chain(space, big, BIG_SIDE, *EDGE_PARAMS)
    torch.cuda.synchronize()
    launches = launched_now()
    check(torch.equal(blob, solo), f"sharded_chain over [cuda:0] x 4 != chain_from_clean at 1x{BIG_SIDE}x{BIG_SIDE}")
    check(not any(name in launches for name in MULTI_KERNELS + BANDED_KERNELS), f"the 4400 x 4400 slabs left the "
          f"slab modes: {launches}")
    out["big"] = {"sharded ms": cuda_ms(lambda: sharded_chain(space, big, BIG_SIDE, *EDGE_PARAMS), 5),
                  "unsharded ms": cuda_ms(lambda: chain_from_clean(big, BIG_SIDE, *EDGE_PARAMS, device=card), 5),
                  "launches": launches, "rounds": space_rounds()}
    print(f"sharded_chain over [cuda:0] x 4 at 1x{BIG_SIDE}x{BIG_SIDE}: == chain_from_clean; launches {launches}, "
          f"rounds {out['big']['rounds']}; {out['big']['sharded ms']:.3f} ms a call against the unsharded chain's "
          f"{out['big']['unsharded ms']:.3f} (banded route; CUDA events)")
    wide_slabs(out)
    seconds["c"] = time.perf_counter() - t0

    # (d) the sharded front-ends against raster_frontend
    t0 = time.perf_counter()
    fh, fw = FRONTEND_SHAPE
    imgs = torch.from_numpy(np.stack([synthetic_image(3 + i, fh, fw)[0] for i in range(2)])).to(card)
    c = torch.from_numpy(np.array(BENCH_CENTERS, np.float32)).to(card)
    kernels.reset_launches()
    e, s = spatial_frontend(make_mesh((4,), ("space",), devices=[card] * 4), imgs[0], c, k=4)
    torch.cuda.synchronize()
    launches = launched_now()
    e1, s1 = raster_frontend(imgs[0], c, k=4)
    check(torch.equal(e, e1) and torch.equal(s, s1), f"spatial_frontend over [cuda:0] x 4 != raster_frontend at "
          f"{fh}x{fw}")
    grid = make_mesh((2, 2), ("data", "space"), devices=[card] * 4)
    eg, sg = grid_frontend(grid, imgs, c, k=4)
    e2, s2 = raster_frontend(imgs, c, k=4)
    check(torch.equal(eg, e2) and torch.equal(sg, s2), "grid_frontend data 2 x space 2 != one raster_frontend call")
    out["front-ends"] = {"spatial ms": cuda_ms(lambda: spatial_frontend(
        make_mesh((4,), ("space",), devices=[card] * 4), imgs[0], c, k=4), 5),
        "raster ms": cuda_ms(lambda: raster_frontend(imgs[0], c, k=4), 5), "launches": launches}
    print(f"spatial_frontend over [cuda:0] x 4, {fh}x{fw} k=4: == raster_frontend; launches {launches}; "
          f"{out['front-ends']['spatial ms']:.3f} ms a call against {out['front-ends']['raster ms']:.3f}; "
          f"grid_frontend data 2 x space 2 over two posters == one raster_frontend call")
    seconds["d"] = time.perf_counter() - t0

    # (e) the dry run's twin over one card named four times
    t0 = time.perf_counter()
    with open(work / "dryrun.log", "w") as log, contextlib.redirect_stdout(log):
        dryrun_multichip(4, [card] * 4)
    lines = [ln for ln in (work / "dryrun.log").read_text().splitlines() if ln.startswith("[dryrun]")]
    check(lines and lines[-1].startswith("[dryrun] ALL OK"), f"dryrun_multichip(4): {lines[-3:]}")
    print("dryrun_multichip(4, [cuda:0] x 4): " + "; ".join(ln.removeprefix("[dryrun] ") for ln in lines))
    seconds["e"] = time.perf_counter() - t0
    print("phase 16 seconds: " + ", ".join(f"{key} {v:.1f}" for key, v in seconds.items()))
    stats["space"] = out
    return out


def phase_entry() -> None:
    import torch

    from plotweave_torch.entry import entry

    fn, args = entry("auto")
    edges, skel = fn(*args)
    torch.cuda.synchronize()
    check(edges.is_cuda and tuple(edges.shape) == tuple(skel.shape) == (4, 512, 512), "entry('auto'): bad output")
    print(f"entry('auto'): edges {tuple(edges.shape)} {edges.dtype}, skeletons {tuple(skel.shape)} {skel.dtype} "
          f"on {edges.device}")


def main() -> None:
    seconds: dict = {}

    def timed(fn, *args):
        """``fn(*args)``, its wall seconds kept under its name."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__.removeprefix("phase_")] = time.perf_counter() - t0
        return out

    info = timed(phase_probe)
    import torch

    timed(phase_build)
    stats: dict = {}
    resize_launches = timed(phase_vector_kernels, stats)  # phase 14's kernels, while the profiler catches every event
    timed(phase_kernels_vs_plain, stats)
    timed(phase_new_kernels_vs_plain, stats)
    timed(phase_layout_and_edge_kernels, stats)
    timed(phase_chain, stats)
    with tempfile.TemporaryDirectory(prefix="pw_smoke_") as tmp:
        paths = timed(phase_main_path, Path(tmp))
        launches = timed(phase_frontend, stats)
        paths["front-end"], paths["front-end dense"] = launches[False], launches[True]
        timed(phase_entry)
        paths["kmeans-tool"] = timed(phase_kmeans_and_dense_kernels, stats)
        paths["device-kmeans"] = timed(phase_device_kmeans_path, Path(tmp), stats)
        paths["swatch"] = timed(phase_swatch_path, Path(tmp))
        timed(phase_batch_path, Path(tmp), stats)
        timed(phase_tour_kernels, stats)
        paths["quality"] = timed(phase_quality_path, Path(tmp), stats)
        paths["vector"] = timed(phase_vector_and_shard, Path(tmp), stats)["vector"]
        timed(phase_mesh, Path(tmp), stats)
        space = timed(phase_space_mesh, Path(tmp), stats)
        paths["sharded"], paths["blur slab"] = space["sharded launches"], space["blur launches"]
        paths["resize"] = resize_launches
    print("phase wall seconds: " + ", ".join(f"{name} {s:.1f}" for name, s in seconds.items()))

    # (name, path whose run counted its launches, launch name, source, TPU kernel, stats key)
    src = "plotweave_torch/csrc/bitboard_fixpoints.cu"
    k1 = "plotweave_torch/csrc/bitpack.cu"
    k8 = "plotweave_torch/csrc/kmeans.cu"
    # K1 where a path still launches it: K12's route of the front-end; the chain (the 4400 x 4400 one too, since
    # the banded K6 stores its blob) and the front-end's K6 route fold it into K2 and K6.  The rows of OFF_PATH
    # are kernels that no main path launches any more: their launches in the 4400 x 4400 run must be 0
    rows = [("K1 bitpack, boards -> rows (no main path: the 4400x4400 chain's blob after K6's multi-launch route "
             "until the banded K6 stored it)", "big", "bitpack", k1, "plotweave/ops/bitpack.py:15", "K1 rows"),
            ("K1 bitpack, boards -> dense (two of the K12 route's three K1 launches)", "front-end dense", "bitpack", k1,
             "plotweave/ops/thinning.py:178", "K1 dense"),
            ("K1 bitpack, dense -> boards (one of the K12 route's three K1 launches)", "front-end dense",
             "bitpack", k1, "plotweave/ops/thinning.py:166", "K1 pack"),
            ("K2 morph_bits (its load converting the packed rows)", "main", "morph_bits",
             "plotweave_torch/csrc/morph_bits.cu", "plotweave/ops/morphology.py:133", "K2"),
            ("K3+K4 edge_candidates", "main", "edge_candidates", "plotweave_torch/csrc/edge_candidates.cu",
             "plotweave/ops/canny.py:59", "K3+K4"),
            ("K5 hysteresis, resident", "main", "hysteresis", src, "plotweave/ops/canny.py:133", "K5"),
            ("K5 hysteresis, banded (one launch a round)", "big", "hysteresis_banded", src,
             "plotweave/ops/canny.py:133", "K5 banded"),
            ("K5 hysteresis, multi-launch (named route only, on no main path)", "big", "hysteresis_multi", src,
             "plotweave/ops/canny.py:133", "K5 multi"),
            ("K6 zhang_suen_packed, resident (storing the blob's two halves)", "main", "zhang_suen_packed", src,
             "plotweave/ops/pallas_kernels.py:179", "K6"),
            ("K6 zhang_suen_packed, banded (one launch storing the blob's two halves)", "big",
             "zhang_suen_packed_banded", src, "plotweave/ops/pallas_kernels.py:179", "K6 banded"),
            ("K6 zhang_suen_packed, multi-launch (named route only, on no main path)", "big",
             "zhang_suen_packed_multi", src, "plotweave/ops/pallas_kernels.py:179", "K6 multi"),
            ("K3+K4 edge_candidates, slab mode", "sharded", "edge_candidates_slab",
             "plotweave_torch/csrc/edge_candidates.cu", "plotweave/parallel/spatial.py:164", "K3+K4 slab"),
            ("K3+K4 blur only, slab mode", "blur slab", "edge_candidates_slab",
             "plotweave_torch/csrc/edge_candidates.cu", "plotweave/parallel/spatial.py:151", "K3+K4 blur slab"),
            ("K5 hysteresis, slab mode", "sharded", "hysteresis_slab", src, "plotweave/parallel/spatial.py:199",
             "K5 slab"),
            ("K6 zhang_suen_packed, slab mode (storing the blob's rows at the slab's row)", "sharded",
             "zhang_suen_packed_slab", src, "plotweave/parallel/spatial.py:215", "K6 slab"),
            ("K7 assign_nearest (boards)", "front-end", "assign_nearest", "plotweave_torch/csrc/assign_nearest.cu",
             "plotweave/ops/frontend.py:24", "K7"),
            ("K12 zhang_suen_dense", "front-end dense", "zhang_suen_dense", "plotweave_torch/csrc/zs_dense.cu",
             "plotweave/ops/pallas_kernels.py:99", "K12"),
            ("K7 assign_nearest (boards with counts)", "device-kmeans", "assign_nearest",
             "plotweave_torch/csrc/assign_nearest.cu", "plotweave/stages/s02_color_extract.py:50", "K7 counts"),
            ("K8 kmeans, subsample", "device-kmeans", "subsample", k8, "plotweave/stages/s02_color_extract.py:127",
             "K8 subsample"),
            ("K8 kmeans, lab_sample", "device-kmeans", "lab_sample", k8, "plotweave/stages/s02_color_extract.py:123",
             "K8 lab_sample"),
            ("K8 kmeans, seeds and fits in one launch (kmeans_fit)", "device-kmeans", "kmeans_fit", k8,
             "plotweave/ops/kmeans.py:149", "K8 kmeans_fit"),
            ("K8 kmeans, the fits from the host's seeds (lloyd_fit)", "kmeans-tool", "lloyd_fit", k8,
             "plotweave/ops/kmeans.py:24", "K8 lloyd_fit"),
            ("K8 kmeans, assign_points", "kmeans-tool", "assign_points", k8, "plotweave/ops/kmeans.py:114",
             "K8 assign_points"),
            ("K11 morph_dense", "swatch", "morph_dense", "plotweave_torch/csrc/morph_dense.cu",
             "plotweave/ops/morphology.py:62", "K11"),
            ("K9 greedy_tour", "quality", "greedy_tour", "plotweave_torch/csrc/greedy_tour.cu",
             "plotweave/vector/planner_device.py:45", "K9"),
            ("K10 refine_tour", "quality", "refine_tour", "plotweave_torch/csrc/refine_tour.cu",
             "plotweave/vector/refine_device.py:55", "K10"),
            ("K13 area_resize, fractional", "resize", "area_resize_frac", "plotweave_torch/csrc/area_resize.cu",
             "plotweave/ops/resize.py:150", "K13 frac"),
            ("K13 area_resize, integer", "resize", "area_resize_int", "plotweave_torch/csrc/area_resize.cu",
             "plotweave/ops/resize.py:180", "K13 int"),
            ("K14 bezier_sample", "vector", "bezier_sample", "plotweave_torch/csrc/bezier_sample.cu",
             "plotweave/frontends/svg.py:82", "K14")]
    print("launches counted in: " + "; ".join(f"{name}: {PATH_RUNS[path]}" for name, path, *_ in rows))
    # the contract's keys last, so that no measurement's key can stand in for one of them
    table = [{**stats[key], "name": name, "route": "cuda", "source": source, "replaces": replaces,
              "launches": paths[path][count]} for name, path, count, source, replaces, key in rows]
    off = {name for name, *_, key in rows if key in OFF_PATH}
    idle = [row["name"] for row in table if row["launches"] < 1 and row["name"] not in off]
    check(not idle, f"kernels that their path's run did not launch: {idle}")
    ran = [row["name"] for row in table if row["launches"] and row["name"] in off]
    check(not ran, f"kernels on no main path that the 4400x4400 run launched: {ran}")
    print(json.dumps({"kernels": table}))
    print(info["smi"])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
