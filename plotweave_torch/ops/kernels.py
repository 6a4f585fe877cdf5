"""Hand-written CUDA kernels: build, binding and wrappers.

- K1 ``dense_to_rows_cuda``, ``rows_to_dense_cuda``, ``rows_to_boards_cuda``,
  ``boards_to_rows_cuda``, ``boards_to_dense_cuda``, ``dense_to_boards_cuda``
  and ``labels_to_boards_cuda`` (``csrc/bitpack.cu``): the conversions
  between packed rows (8 px a byte), bitboards (32 px a word) and dense
  pixels; replace the XLA fusions of ``bitpack_rows``, ``bitunpack_rows``
  (one launch each, straight between pixels and packed rows),
  ``pack_bitboards`` and ``unpack_bitboards``.  A warp forms a run of 32
  words and moves the span of pixels or row bytes they cover as 16-byte
  vectors.  The raster chain, the device k-means stage and the front-end's
  K6 route launch none of them: K2's load and store and K6's stores convert
  (``csrc/bitlayout.cuh``).  :data:`K1_LAUNCHES` counts K1 by kernel.
- K2 ``morph_steps_cuda`` (``csrc/morph_bits.cu``): a whole sequence of
  packed dilations and erosions in one launch, each block holding a band of
  rows and the sequence's halo in shared memory; replaces the XLA fusion of
  ``morph_bits`` and chains of its calls.  It takes packed rows as well as
  boards and can store packed rows beside its boards.  :func:`morph_schedule`
  splits a sequence whose halo does not fit into segments, one launch each,
  before any launch (the defaults are one segment).
- K3+K4 ``edge_candidates_cuda`` and ``gaussian_blur_cuda``
  (``csrc/edge_candidates.cu``): the Q8 blur, Sobel, magnitude, sector NMS
  and double threshold in one launch, from a bitboard or a uint8 image to
  the candidate and strong boards (or the blurred image); replaces the XLA
  fusions of ``gaussian_blur_u8`` and of ``canny_packed`` before its
  hysteresis.  A board stays words in shared memory; a thread walks down a
  strip of four columns with the blur's row sums, then three rows of Sobel
  parts, in registers; only tiles on the image's rim reflect and clamp.
  :func:`edge_schedule` picks the tile and :func:`edge_fast` the path before
  any launch.  Its slab mode (``edge_candidates_slab_cuda``,
  ``gaussian_blur_slab_cuda``; row sharding) reads a shard's rows between
  halo rows and writes only its own.
- K5 ``hysteresis_cuda`` and K6 ``zhang_suen_packed_cuda``
  (``csrc/bitboard_fixpoints.cu``): the bitboard fixpoints; K6 replaces
  ``zhang_suen_packed_pallas``.  One cluster kernel each runs a band table,
  every band resident in one thread block cluster's shared memory
  (:func:`band_schedule`).  The route is chosen by size before any launch
  unless the caller names one: a layer that fits one cluster is one band,
  the whole fixpoint in one launch per call (launch names
  ``zhang_suen_packed``, ``hysteresis``); a larger layer runs banded
  (``zhang_suen_packed_banded``, ``hysteresis_banded``), its bands reading
  their halo rows in place from the whole layer, every band of every layer
  in one launch: K6 by rounds of m iterations (one at 4400 × 4400), K5 by
  rounds with one host read of a flag each.  The multi-launch kernels (one
  launch per subpass or sweep, ``zhang_suen_packed_multi``,
  ``hysteresis_multi``) run only where a caller names ``route="multi"``.
  ``zhang_suen_into_cuda`` is K6 writing its input, the edges, and its
  result, the skeletons, as packed rows or dense bytes from its own
  launches (the multi-launch route: K6, then K1).  Their slab modes
  (``hysteresis_slab_cuda``, ``zhang_suen_slab_cuda``; row sharding) run
  the same kernels over bands of a shard's own rows between halo rows
  (:func:`slab_bands`), write only its own rows (K6 also into the unsharded
  outputs at the shard's row) and a changed flag for the host's one read a
  round.
- K7 ``assign_nearest_cuda`` and ``assign_boards_cuda``
  (``csrc/assign_nearest.cu``): Lab and the nearest centre in one pass, as
  int32 labels or as the k one-hot bitboards, the latter also with the k
  pixel counts of one image; replaces the XLA fusion of ``assign_nearest``
  and the argmin and counts of stage 02's ``_assign_tail``.
- K8 ``subsample_cuda``, ``lab_sample_cuda``, ``kmeans_fit_cuda``,
  ``lloyd_fit_cuda`` and ``assign_points_cuda`` (``csrc/kmeans.cu``): the
  device k-means of ``kmeans_init: "device"``: the subsample's draw (a radix
  select over hashed keys and a compaction in index order, one cooperative
  launch in clusters: three hashing passes, two grid barriers), the float
  Lab of the subsample (K7's arithmetic through ``csrc/lab.cuh``), then in
  ONE launch the k-means++ seeds of every attempt
  from host-drawn random numbers and every attempt's whole Lloyd loop with
  the choice of the best (one thread block cluster per attempt over rows
  held in shared memory where they fit, :func:`kpp_schedule`; integer
  running sums for the seeds, float sums in a fixed order, the stop test on
  the device); ``lloyd_fit_cuda`` runs the same fit from the host's seeds
  (the tools' ``kmeans``).  Replaces the subsample of
  ``_device_init_stage`` and the XLA programs of ``_lloyd``,
  ``_kpp_init_device`` and ``kmeans_fit_device``.
- K11 ``morph_dense_cuda`` (``csrc/morph_dense.cu``): a whole list of gray
  (uint8) erosions and dilations by rect, ellipse or cross elements in one
  launch, every plane of a stack too: each element cut into row runs
  (:func:`element_runs`), a horizontal and a vertical pass a run over 16
  packed pixels a thread, persistent CTAs that load the next tile and its
  halo by ``cp.async`` while they run the steps on this one; replaces the XLA
  fusion of ``_morph``.  :func:`dense_morph_schedule` splits a list into
  segments before any launch.
- K12 ``zhang_suen_dense_cuda`` (``csrc/zs_dense.cu``): dense Zhang–Suen,
  packed to 32 pixels a word on load and bit-sliced in shared memory, up to
  :data:`ZS_CHUNK` iterations per launch on tiles with a halo of two rows
  per iteration; replaces ``zhang_suen_pallas``.
- K9 ``greedy_order_cuda`` (``csrc/greedy_tour.cu``): stage 07's greedy
  nearest-endpoint tour in one persistent launch, one CTA for a short tour,
  else a cluster of 16 CTAs that push their minima into each other
  (:func:`greedy_route`); replaces the XLA loop of ``_greedy_device_impl``.
- K10 ``refine_order_cuda`` (``csrc/refine_tour.cu``): stage 12's 2-opt /
  relocate refiner, every iteration (all candidate moves, the best one, the
  stop test, the move applied) in one cooperative launch, the tour resident
  in every CTA's shared memory and one grid barrier an iteration; replaces
  the XLA loop of ``_refine_impl``.
- K13 ``area_resize_frac_cuda`` and ``area_resize_int_cuda``
  (``csrc/area_resize.cu``): the INTER_AREA downscale, bit-exact with cv2;
  the fractional route through the tap tables of ``ops/resize.py``, every
  product rounded before its add, a CTA a band of output rows and a tile of
  columns that streams its source rows through shared memory and forms each
  (source row, output column) horizontal sum once (:func:`area_frac_schedule`);
  the integer route one thread an output pixel.  Replaces the XLA programs of
  ``_area_resize_frac`` and ``_area_resize_int``.
- K14 ``bezier_families_cuda`` (``csrc/bezier_sample.cu``): every curve
  family of an SVG document (the cubic or quadratic Bézier segments of a
  path at its n parameters) in one launch over a family table, one thread a
  point; ``bezier_sample_cuda`` is one family as a table of one.  Replaces
  the device program of ``sample_cubics_batched`` / ``sample_quads_batched``
  under the JAX package's ``--sampling-backend jax``.

Each source notes its design and bound.  Each is compiled with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, at
first use, under ``plotweave_torch/_build/`` keyed on a hash of the source,
the headers of ``csrc/`` and its flags, and loaded with ctypes.  Importing
this module compiles and loads nothing, so it imports where there is no
``nvcc`` and no card.

Bitboards are CUDA ``int32`` tensors (the bits of the JAX package's ``uint32``
boards).  Each wrapper launches on ``torch.cuda.current_stream()``, raises on
a tensor it does not take and on any launch error, and counts in
:data:`LAUNCHES` every kernel launch that its call into the library makes.
The plain versions live beside their callers (``ops/bitpack.py``,
``ops/morphology.py``, ``ops/filters.py``, ``ops/canny.py``,
``ops/thinning.py``, ``ops/frontend.py``, ``vector/planner_device.py``,
``vector/refine_device.py``, ``ops/resize.py``, ``ops/bezier.py``); nothing
here falls back to them.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .filters import gaussian_kernel_q8, slab_rows
from .morphology import structuring_element
from .resize import _resize_area_tab
from .thinning import _dense_planes

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SM90A = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# one library per source, each with its own flags: K7's float arithmetic
# must not be contracted into FMAs
NVCC_FLAGS = {
    "bitpack": _SM90A,  # K1
    "edge_candidates": _SM90A,  # K3+K4
    "bitboard_fixpoints": _SM90A,  # K5, K6
    "morph_bits": _SM90A,  # K2
    "assign_nearest": _SM90A + ["--fmad=false"],  # K7
    "zs_dense": _SM90A,  # K12
    "kmeans": _SM90A + ["--fmad=false"],  # K8: shares csrc/lab.cuh with K7, and its sums keep their written order
    "morph_dense": _SM90A,  # K11
    "greedy_tour": _SM90A + ["--fmad=false"],  # K9: d2 rounded product by product, as the host planner's
    "refine_tour": _SM90A + ["--fmad=false"],  # K10: every delta in its plain version's order
    "area_resize": _SM90A + ["--fmad=false"],  # K13: cv2's float32 tap sums, every product rounded
    "bezier_sample": _SM90A + ["--fmad=false"],  # K14: the basis and sums rounded as the plain version's
}

# the multi-launch routes and K12: iterations per host check of the
# convergence flags (K12: per launch, ``kT`` in csrc/zs_dense.cu)
ZS_CHUNK = 8
HYSTERESIS_CHUNK = 32  # even: the sweeps ping-pong between two buffers

# K12's tile of output, rows x 32-pixel words (``kTR``, ``kTW`` in
# csrc/zs_dense.cu); its halo is 2 * ZS_CHUNK rows and one word on each side
ZS_TILE_ROWS, ZS_TILE_WORDS = 64, 16

# K2's band of output rows per block (fewer for a shorter layer, or for a
# single step that does not fit a full band), and the static shared memory
# of its masks: two steps of at most 63 rows of taps, 8 bytes each
MORPH_BAND = 32
MORPH_MASK_BYTES = 2 * 63 * 8

# K3+K4's tile of output, rows x 32-pixel words, where it fits (a smaller
# one for a blur radius whose halo does not): the taller tile, whose threads
# walk longer row segments and so redo fewer warm-up rows, where it still
# leaves EDGE_TALL_BLOCKS blocks (measured on the H100, PERF.md: 64 rows win
# at 1,024 and 1,536 blocks, 32 rows at 384 and below); and the ``ksize``
# that have a template instance in csrc/edge_candidates.cu (``pick``)
EDGE_TILE_ROWS, EDGE_TILE_WORDS = (32, 64), 4
EDGE_TALL_BLOCKS = 1024
EDGE_FAST_KSIZES = (1, 3, 5, 7, 9)

# the resident routes: CTAs per thread block cluster (``kCluster`` in
# csrc/bitboard_fixpoints.cu), and the shared memory one CTA may take (227 KB
# on Hopper)
CLUSTER_SIZE = 16
MAX_SMEM = 232448
ROUTES = ("resident", "banded", "multi")

# K8: the centres one fit holds in registers (``kMaxK`` in csrc/kmeans.cu); the
# seeds-and-fits launch's threads a CTA (``kThreads``: a tile is one row a
# thread), a bound on its static shared memory (``kStaticSmem``), the fit's
# shared scratch, which takes the place of the dead d² column (``kFitScratch``),
# and the tiles the streamed route stages at once (``kStageTiles``);
# the seeding's weights max(floor(d2 2^16), 1) capped at 2^36, and the rows it
# takes (n 2^36 < 2^63)
KMEANS_MAX_K = 8
KPP_THREADS = 512
KPP_STATIC_SMEM = 512
FIT_SCRATCH_BYTES = 4 * (4 * KMEANS_MAX_K * 16 + 3 * 4 * KMEANS_MAX_K + 5 * KMEANS_MAX_K)
FIT_STAGE_TILES = 8
KPP_SCALE_BITS = 16
KPP_WEIGHT_CAP = 1 << 36
KPP_MAX_N = 1 << 27
KPP_ROUTES = ("resident", "streamed")

# K8's draw (csrc/kmeans.cu): threads a CTA (also the most CTAs), CTAs a
# cluster and the most clusters, the top digit's buckets and their coarse
# sums read back first (``kDrawThreads``, ``kDrawCluster``,
# ``kMaxDrawClusters``, ``kDigits``, ``kCoarse``), the candidates the selection
# copies into shared memory (``kListCap``) and the most one bucket holds (keys
# are distinct: 2^21 of one top digit); its scratch, a row of the bins and
# coarse sums a cluster and a count a CTA, then the candidates
DRAW_THREADS, DRAW_CLUSTER, DRAW_MAX_CLUSTERS = 1024, 8, 32
DRAW_DIGITS, DRAW_COARSE = 2048, 64
DRAW_LIST_CAP, DRAW_MAX_BUCKET = 16384, 1 << 21
DRAW_SCRATCH_WORDS = DRAW_MAX_CLUSTERS * (DRAW_DIGITS + DRAW_COARSE) + DRAW_THREADS

# K14: points a CTA (``kThreads`` in csrc/bezier_sample.cu), the unit of its
# start table
BEZIER_THREADS = 256

# K8's sampler (``kSampleThreads``, ``kSamplePer`` in csrc/kmeans.cu): threads a
# CTA, one pixel of a chunk each, and the pixels each of the chunk's loaders
# gathers (one int4 of indices)
SAMPLE_THREADS, SAMPLE_PER_THREAD = 512, 4
SAMPLE_CHUNK = SAMPLE_THREADS

# K13's fractional route (csrc/area_resize.cu, ``area_frac_bands``): output rows
# an item where the CTAs the card holds are not known, and the most an item
# takes when its rows are fitted to them; output columns a tile (one thread a
# column, a power of two up to ``kMaxTile``); source rows staged at once; the
# shared memory a CTA may take before a wide ratio narrows the group and then
# the tile (past it, up to MAX_SMEM); and the events' room (16 bytes a source
# row of a band) past which a band takes the ring's route
# (measured on the H100, PERF.md: 256 columns and 8 rows a group the fastest
# of 64 to 256 and 4 to 16)
AREA_BAND_ROWS, AREA_MAX_BAND_ROWS, AREA_TILE, AREA_GROUP = 16, 64, 256, 8
AREA_MAX_TILE = 256
AREA_SMEM_CAP = 64 * 1024
AREA_EVENTS_CAP = 32 * 1024

# K11's tile of output, rows x pixels (pixels a multiple of 16): the larger
# one for a launch whose steps need no H plane (rects that roll their rows in
# registers), whose CTAs take less shared memory; and the halo (the summed
# radius of the steps of one launch) beyond which a further step starts a
# launch of its own: past it a CTA recomputes more than a launch costs.
# Measured on the H100 (PERF.md): 32 rect-3 steps on one mask took 0.116,
# 0.108, 0.106 and 0.173 ms alone under caps 4, 8, 16 and 32 (8 and 16
# within noise: 16 kept); the swatch call 0.038 ms on 128 x 128 tiles
# against 0.051 on 64 x 128, an ellipse 5 x 2 0.038 against 0.043 ms the
# other way round.  Then the bytes of slack on each side
# of a shared row (``kSlack``), and the parameter block's room (``kMaxSteps``,
# ``kMaxGroups``, ``kMaxDys`` in csrc/morph_dense.cu)
DENSE_TILE = (64, 128)
DENSE_ROLL_TILE = (128, 128)
DENSE_HALO_CAP = 16
DENSE_SLACK = 32
DENSE_MAX_STEPS, DENSE_MAX_GROUPS, DENSE_MAX_DYS = 32, 128, 640

# K9: the CTAs of its cluster route (``kCluster`` in csrc/greedy_tour.cu), the
# shared memory a point takes (start and end, and a meta word) and a bound on
# its static shared memory (two sets of warp slots and of 16 received slots, 16
# bytes each, two mbarriers); the largest tour one CTA holds, the size from
# which the cluster route is the faster (measured on the H100, PERF.md), and
# the largest of either route (the JAX package's largest bucket)
GREEDY_CLUSTER = 16
GREEDY_POINT_BYTES = 20
GREEDY_STATIC_SMEM = 1024
GREEDY_CTA_MAX_N = (MAX_SMEM - GREEDY_STATIC_SMEM) // GREEDY_POINT_BYTES
GREEDY_CLUSTER_MIN_N = 2000
GREEDY_MAX_N = 65536
GREEDY_ROUTES = ("cta", "cluster")

# K10: the tours it takes (the JAX package's smallest plan and largest bucket)
REFINE_MIN_N, REFINE_MAX_N = 3, 8192

# kernel launches per wrapper and route, counted where each wrapper calls into its library
LAUNCHES = {"bitpack": 0, "edge_candidates": 0, "zhang_suen_packed": 0, "zhang_suen_packed_banded": 0,
            "zhang_suen_packed_multi": 0, "hysteresis": 0, "hysteresis_banded": 0, "hysteresis_multi": 0, "edge_candidates_slab": 0, "hysteresis_slab": 0,
            "zhang_suen_packed_slab": 0, "morph_bits": 0, "assign_nearest": 0, "zhang_suen_dense": 0,
            "subsample": 0, "lab_sample": 0, "kmeans_fit": 0, "lloyd_fit": 0, "assign_points": 0, "morph_dense": 0,
            "greedy_tour": 0, "refine_tour": 0, "area_resize_frac": 0, "area_resize_int": 0, "bezier_sample": 0}

# K1's launches by kernel (dense -> boards and dense -> rows from bytes and from int32 are two each),
# each also counted under "bitpack" in LAUNCHES
K1_LAUNCHES = {"rows_to_boards": 0, "boards_to_rows": 0, "boards_to_dense": 0, "dense_to_boards_bytes": 0,
               "dense_to_boards_words": 0, "labels_to_boards": 0, "dense_to_rows_bytes": 0,
               "dense_to_rows_words": 0, "rows_to_dense": 0}

# what the last call of each fixpoint route took: for the resident routes a
# device tensor, K6 (k,) iterations per layer, K5 (k, 2) rounds and the most
# sweeps one CTA ran per layer; for the banded routes (host rounds, that
# tensor of the last round); for the multi-launch routes and K12 the
# iterations or sweeps launched; for K8's fits (``kmeans_fit``, ``lloyd_fit``)
# the device tensors (iterations per attempt, compactness per attempt, index of
# the best attempt); for row sharding's fixpoints (``parallel/spatial.py``)
# the rounds the last sharded program took (``hysteresis_rounds``,
# ``thinning_rounds``).  Only read by ``chip_smoke.py``.
STATS: dict = {}

build_log: dict = {}  # library → nvcc's output (ptxas register and spill report) of its last build

_libs: dict = {}
_lock = threading.Lock()  # guards the library loads and the launch counts


def _guard(device: torch.device):
    """The device guard of a launch: nothing where ``device`` is already the
    current one (the usual case, and cheaper on the host)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        for name in K1_LAUNCHES:
            K1_LAUNCHES[name] = 0


def _count(name: str, n: int = 1) -> None:
    with _lock:
        LAUNCHES[name] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built, keyed on a hash of
    its source, the headers of ``csrc/`` and its flags."""
    data = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.sha256(data + " ".join(NVCC_FLAGS[name]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names=None) -> dict:
    """Compile the libraries ``names`` (default: all) that are not built yet,
    one ``nvcc`` per source, all started together; return {name: path}.
    Raises after every ``nvcc`` has ended if any of them failed."""
    names = list(NVCC_FLAGS) if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = [name for name in names if not paths[name].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in todo:
        tmp = paths[name].with_name(f"{paths[name].name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[name], "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in jobs.items():
        build_log[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}.cu: nvcc failed ({proc.returncode}):\n{build_log[name]}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


_P, _I, _U, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_long, ctypes.c_float
_SIGNATURES = {
    "bitpack": {"pw_rows_to_boards": [_P, _P, _L, _I, _P],
                "pw_boards_to_rows": [_P, _P, _L, _I, _P],
                "pw_boards_to_dense": [_P, _P, _L, _I, _I, _I, _P],
                "pw_dense_to_boards": [_P, _P, _L, _I, _I, _P],
                "pw_labels_to_boards": [_P, _P, _L, _I, _I, _I, _P],
                "pw_dense_to_rows": [_P, _P, _L, _I, _I, _P],
                "pw_rows_to_dense": [_P, _P, _L, _I, _P]},
    "edge_candidates": {"pw_edge_candidates": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                               _P]},
    "bitboard_fixpoints": {"pw_zs_cluster_run": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                                                 _I, _I, _I, _I, _P],
                           "pw_hysteresis_cluster_run": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
                           "pw_cluster_fit": [_I, _I, _I, _P],
                           "pw_zs_packed_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                           "pw_hysteresis_run": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "morph_bits": {"pw_morph_steps_run": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "assign_nearest": {"pw_assign_nearest": [_P, _P, _P, _I, _L, _P],
                       "pw_assign_boards": [_P, _P, _P, _P, _I, _L, _I, _I, _P]},
    "zs_dense": {"pw_zs_tiles_run": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
    "kmeans": {"pw_subsample": [_I, _I, _U, _U, _P, _P, _P],
               "pw_lab_sample": [_P, _P, _P, _I, _L, _P],
               "pw_kmeans_fit": [_P, _I, _I, _I, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P],
               "pw_lloyd_fit": [_P, _I, _I, _I, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P],
               "pw_assign_points": [_P, _L, _P, _I, _P, _P]},
    "morph_dense": {"pw_morph_dense_run": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "greedy_tour": {"pw_greedy_tour": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P]},
    "refine_tour": {"pw_refine_tour": [_P, _P, _P, _I, _I, _F, _F, _I, _P, _P, _P, _P],
                    "pw_refine_blocks": [_I]},
    "area_resize": {"pw_area_resize_frac": [_P, _P, _P, _P, _I, _P, _P] + [_I] * 15 + [_P],
                    "pw_area_frac_smem": [_I] * 7,
                    "pw_area_frac_ctas": [_I] * 8,
                    "pw_area_resize_int": [_P, _P, _I, _I, _I, _I, _I, _I, _P]},
    "bezier_sample": {"pw_bezier_sample": [_P, _P, _I, _I, _I, _P],
                      "pw_bezier_families": [_P, _I, _I, _I, _I, _P, _P]},
}


def load(name: str):
    """The bound library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = _I
            lib.pw_error_string.argtypes = [_I]
            lib.pw_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return _libs[name]


def _check(name: str, *boards: torch.Tensor):
    """(k, h, nw) of CUDA int32 contiguous boards of one shape (leading dims
    flattened into k)."""
    first = boards[0]
    for t in boards:
        if not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 bitboards, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"{name}: boards differ in shape or device")
    if first.dim() < 2:
        raise ValueError(f"{name}: expected (..., H, NW) boards, got {tuple(first.shape)}")
    h, nw = first.shape[-2], first.shape[-1]
    if first.numel() >= 2**31:
        raise ValueError(f"{name}: {first.numel()} words exceed the kernel's index range")
    return (first.numel() // (h * nw) if h * nw else 0), h, nw


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.pw_error_string(err).decode()})")


def _check_dense(name: str, t: torch.Tensor, dtypes) -> None:
    """A CUDA contiguous tensor of one of ``dtypes``, inside the kernels' index range."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: expected one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.dim() < 1:
        raise ValueError(f"{name}: expected (..., W), got {tuple(t.shape)}")
    if t.numel() >= 2**31:
        raise ValueError(f"{name}: {t.numel()} elements exceed the kernel's index range")


def _check_width(name: str, boards: torch.Tensor, w: int) -> None:
    if -(-w // 32) != boards.shape[-1] or w >= 2**31:
        raise ValueError(f"{name}: rows of {boards.shape[-1]} words do not hold {w} px")


def _bitpack(fn: str, shape, dtype, src: torch.Tensor, n_rows: int, *args, out: torch.Tensor | None = None,
             kernel: str | None = None):
    """One launch of ``csrc/bitpack.cu``'s ``fn`` from ``src`` into a new
    tensor of ``shape`` and ``dtype`` on its device, or into ``out``, counted
    in :data:`K1_LAUNCHES` under ``kernel`` (default ``fn`` without its
    prefix)."""
    with _guard(src.device):
        if out is None:
            out = torch.empty(shape, dtype=dtype, device=src.device)
        if out.numel():
            lib = load("bitpack")
            err = getattr(lib, fn)(src.data_ptr(), out.data_ptr(), n_rows, *args,
                                   torch.cuda.current_stream().cuda_stream)
            _count("bitpack")
            with _lock:
                K1_LAUNCHES[kernel or fn.removeprefix("pw_")] += 1
            _raise_on(lib, fn, err)
    return out


def _packed_rows(name: str, rows: torch.Tensor, w: int) -> int:
    """The number of packed rows of ``w`` px in CUDA ``rows`` (..., ⌈w/8⌉) uint8."""
    _check_dense(name, rows, (torch.uint8,))
    if w <= 0 or rows.shape[-1] != -(-w // 8):
        raise ValueError(f"{name}: rows of {rows.shape[-1]} bytes do not hold {w} px")
    return rows.numel() // rows.shape[-1]


def rows_to_boards_cuda(rows: torch.Tensor, w: int) -> torch.Tensor:
    """K1: CUDA packed rows (..., ⌈w/8⌉) uint8, 8 px a byte MSB first → (...,
    ⌈w/32⌉) int32 bitboards, bits at and beyond ``w`` zero; any alignment of
    ``data_ptr()``."""
    n_rows = _packed_rows("rows_to_boards", rows, w)
    return _bitpack("pw_rows_to_boards", (*rows.shape[:-1], -(-w // 32)), torch.int32, rows, n_rows, w)


def rows_to_dense_cuda(rows: torch.Tensor, w: int) -> torch.Tensor:
    """K1: CUDA packed rows (..., ⌈w/8⌉) uint8 → (..., w) 0/1 uint8 in one
    launch (``ops.bitpack.bitunpack_rows``); any alignment of ``data_ptr()``."""
    n_rows = _packed_rows("rows_to_dense", rows, w)
    if n_rows * w >= 2**31:
        raise ValueError(f"rows_to_dense: {n_rows * w} pixels exceed the kernel's index range")
    return _bitpack("pw_rows_to_dense", (*rows.shape[:-1], w), torch.uint8, rows, n_rows, w)


def boards_to_rows_cuda(boards: torch.Tensor, w: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """K1: CUDA bitboards (..., ⌈w/32⌉) int32 → packed rows (..., ⌈w/8⌉)
    uint8, written into ``out`` (a contiguous uint8 tensor of that many
    bytes on the boards' device, e.g. a slice of a blob) when given."""
    _check("boards_to_rows", boards)
    _check_width("boards_to_rows", boards, w)
    shape = (*boards.shape[:-1], -(-w // 8))
    if out is not None:
        _check_dense("boards_to_rows", out, (torch.uint8,))
        if out.device != boards.device or out.numel() != boards.numel() // boards.shape[-1] * shape[-1]:
            raise ValueError(f"boards_to_rows: out {tuple(out.shape)} on {out.device} does not take {shape}")
    return _bitpack("pw_boards_to_rows", shape, torch.uint8, boards, boards.numel() // boards.shape[-1], w, out=out)


def boards_to_dense_cuda(boards: torch.Tensor, w: int, value: int = 1, dtype=torch.uint8,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """K1: CUDA bitboards (..., H, ⌈w/32⌉) → dense (..., H, w) uint8 or int32,
    ``value`` where the bit is set and 0 elsewhere; written into ``out`` (a
    contiguous tensor of ``dtype`` of that many elements on the boards'
    device) when given."""
    _check("boards_to_dense", boards)
    _check_width("boards_to_dense", boards, w)
    if dtype not in (torch.uint8, torch.int32) or not 0 <= value <= 255:
        raise ValueError(f"boards_to_dense: expected uint8 or int32 and a value in 0..255, got {dtype}, {value}")
    n_rows = boards.numel() // boards.shape[-1]
    if n_rows * w >= 2**31:
        raise ValueError(f"boards_to_dense: {n_rows * w} pixels exceed the kernel's index range")
    if out is not None:
        _check_dense("boards_to_dense", out, (dtype,))
        if out.device != boards.device or out.numel() != n_rows * w:
            raise ValueError(f"boards_to_dense: out {tuple(out.shape)} on {out.device} does not take {n_rows} rows "
                             f"of {w} px")
    return _bitpack("pw_boards_to_dense", (*boards.shape[:-1], w), dtype, boards, n_rows, w, value,
                    1 if dtype == torch.uint8 else 4, out=out)


def dense_to_boards_cuda(dense: torch.Tensor) -> torch.Tensor:
    """K1: CUDA dense (..., W) uint8, bool (set where nonzero) or int32 (set
    where > 0) → (..., ⌈W/32⌉) int32 bitboards, bits at and beyond W zero;
    any alignment of the rows and of ``data_ptr()``."""
    _check_dense("dense_to_boards", dense, (torch.uint8, torch.bool, torch.int32))
    w = dense.shape[-1]
    src = dense.view(torch.uint8) if dense.dtype == torch.bool else dense
    return _bitpack("pw_dense_to_boards", (*dense.shape[:-1], -(-w // 32)), torch.int32, src,
                    dense.numel() // max(w, 1), w, src.element_size(),
                    kernel="dense_to_boards_bytes" if src.element_size() == 1 else "dense_to_boards_words")


def dense_to_rows_cuda(dense: torch.Tensor) -> torch.Tensor:
    """K1: CUDA dense (..., W) uint8, bool (set where nonzero) or int32 (set
    where > 0) → (..., ⌈W/8⌉) packed rows, 8 px a byte MSB first, in one
    launch (``ops.bitpack.bitpack_rows``); any alignment of the rows and of
    ``data_ptr()``."""
    _check_dense("dense_to_rows", dense, (torch.uint8, torch.bool, torch.int32))
    w = dense.shape[-1]
    src = dense.view(torch.uint8) if dense.dtype == torch.bool else dense
    return _bitpack("pw_dense_to_rows", (*dense.shape[:-1], -(-w // 8)), torch.uint8, src,
                    dense.numel() // max(w, 1), w, src.element_size(),
                    kernel="dense_to_rows_bytes" if src.element_size() == 1 else "dense_to_rows_words")


def labels_to_boards_cuda(labels: torch.Tensor, k: int) -> torch.Tensor:
    """K1: CUDA int32 labels (..., H, W) → the ``k`` one-hot bitboards (...,
    k, H, ⌈W/32⌉): bit x of layer c is set where the label is c (none for a
    label < 0 or >= k)."""
    _check_dense("labels_to_boards", labels, (torch.int32,))
    if labels.dim() < 2 or k <= 0:
        raise ValueError(f"labels_to_boards: expected (..., H, W) labels and k > 0, got {tuple(labels.shape)}, {k}")
    h, w = labels.shape[-2:]
    nw = -(-w // 32)
    if labels.numel() // max(w, 1) * nw * k >= 2**26:
        raise ValueError(f"labels_to_boards: {k} layers of {tuple(labels.shape)} exceed the kernel's index range")
    return _bitpack("pw_labels_to_boards", (*labels.shape[:-2], k, h, nw), torch.int32, labels,
                    labels.numel() // max(h * w, 1), k, h, w)


@functools.lru_cache(maxsize=None)
def edge_fast(ksize: int, sigma: float = 0.0) -> bool:
    """Whether K3+K4 takes its fast path for these taps: a template instance
    of ``csrc/edge_candidates.cu`` (:data:`EDGE_FAST_KSIZES`: row sums from a
    window table or ``__dp4a``, the column pass in registers) and every tap a
    byte.  ``ksize`` 1 blurs nothing, whatever its one tap.  Anything else
    (an even or larger ``ksize``, a sigma so small that one tap is 256) takes
    the general path."""
    if ksize not in EDGE_FAST_KSIZES:
        return False
    taps = gaussian_kernel_q8(ksize, sigma)
    return ksize == 1 or bool(taps.min() >= 0 and taps.max() <= 255)


def edge_smem_bytes(th: int, tww: int, ksize: int, boards: bool, fast: bool) -> int:
    """Shared memory one block of K3+K4 takes for a tile of ``th`` rows of
    ``tww`` words (``csrc/edge_candidates.cu``'s ``make_layout``), all in
    32-bit words: the blurred bytes of the tile and 2 px around it; the input
    with a halo of ``ksize // 2 + 2`` px, a board as words with whole halo
    words, a dense image as bytes (on the fast path from the word boundary
    before the halo, and one word to spare); the fast path's table of
    ``2 ** ksize`` uint16 window sums (boards only) or the general path's
    uint16 row sums; the taps."""
    halo, tw = ksize // 2 + 2, 32 * tww
    ah = th + 2 * halo
    if boards:
        in_words = tww + 2 * -(-halo // 32)
    elif fast:
        in_words = tw // 4 + -(-halo // 4) * 2 + 1
    else:
        in_words = -(-(tw + 2 * halo) // 4)
    if fast:
        aux_words = ((1 << ksize) + 1) // 2 if boards else 0
    else:
        aux_words = ah * (tw + 4) // 2
    return 4 * ((th + 4) * (tw // 4 + 1) + ah * in_words + aux_words + ksize)


@functools.lru_cache(maxsize=None)
def edge_schedule(ksize: int, k: int, h: int, nw: int, boards: bool, fast: bool) -> tuple:
    """K3+K4's tile (rows, words) for ``k`` layers of ``h`` rows of ``nw``
    words: :data:`EDGE_TILE_WORDS` words (fewer for a narrower layer) by the
    taller of :data:`EDGE_TILE_ROWS` where the grid keeps
    :data:`EDGE_TALL_BLOCKS` blocks, else the shorter (fewer for a shorter
    layer); halved, rows first, while the tile and the halo of ``ksize`` do
    not fit :data:`MAX_SMEM` on that input and path.  Raises where no tile
    fits or the grid cannot hold the layer."""
    short, tall = EDGE_TILE_ROWS
    tww = max(1, min(EDGE_TILE_WORDS, nw))
    th = tall if k * -(-h // tall) * -(-nw // tww) >= EDGE_TALL_BLOCKS else short
    th = max(1, min(th, h))
    while edge_smem_bytes(th, tww, ksize, boards, fast) > MAX_SMEM:
        if th > 1:
            th = -(-th // 2)
        elif tww > 1:
            tww = -(-tww // 2)
        else:
            raise ValueError(f"edge_candidates: the halo of ksize {ksize} does not fit one block's shared memory")
    if -(-h // th) > 65535:
        raise ValueError(f"edge_candidates: {h} rows in tiles of {th} exceed the kernel's grid")
    return th, tww


_taps: dict = {}  # (ksize, sigma, device) → the Q8 taps on the device


def _taps_on(ksize: int, sigma: float, device: torch.device) -> torch.Tensor:
    key = (ksize, float(sigma), device)
    if key not in _taps:
        _taps[key] = torch.tensor(gaussian_kernel_q8(ksize, sigma).tolist(), dtype=torch.int32, device=device)
    return _taps[key]


def _edge_launch(x: torch.Tensor, w: int | None, ksize: int, sigma: float, low: int, high: int, blur_only: bool,
                 top: int = 0, bottom: int = 0):
    """One launch of K3+K4 on int32 bitboards (..., H, ⌈w/32⌉) or a uint8
    image (..., H, W) → (cand, strong) boards, or the blurred image, of rows
    [top, H - bottom) (slab mode where a halo is not 0: ``ops.filters.slab_rows``
    checks the halos)."""
    name = ("gaussian_blur" if blur_only else "edge_candidates") + ("_slab" if top or bottom else "")
    if x.dtype == torch.int32:
        k, h, nw = _check(name, x)
        if w is None:
            raise ValueError(f"{name}: bitboards need their width in pixels")
        _check_width(name, x, w)
        lead = x.shape[:-2]
    else:
        _check_dense(name, x, (torch.uint8,))
        if x.dim() < 2 or (w is not None and w != x.shape[-1]):
            raise ValueError(f"{name}: expected a (..., H, W) image of width {w}, got {tuple(x.shape)}")
        h, w = x.shape[-2:]
        nw, lead = -(-w // 32), x.shape[:-2]
        k = x.numel() // (h * w) if h * w else 0
    if ksize < 1:
        raise ValueError(f"{name}: ksize {ksize} < 1")
    if k * h * w >= 2**31 or k > 65535:
        raise ValueError(f"{name}: {k} layers of {h} x {w} px exceed the kernel's grid")
    own = slab_rows(name, h, top, bottom, ksize // 2 + (0 if blur_only else 2)) if h else 0
    with _guard(x.device):
        if blur_only:
            outs = (torch.empty((*lead, own, w), dtype=torch.uint8, device=x.device),)
        else:
            both = torch.empty((2, *lead, own, nw), dtype=torch.int32, device=x.device)
            outs = (both[0], both[1])
        if outs[0].numel():
            boards, fast = x.dtype == torch.int32, edge_fast(ksize, sigma)
            th, tww = edge_schedule(ksize, k, own, nw, boards, fast)
            taps = _taps_on(ksize, sigma, x.device)
            lib = load("edge_candidates")
            cand, strong, blurred = (None, None, outs[0].data_ptr()) if blur_only else (
                outs[0].data_ptr(), outs[1].data_ptr(), None)
            err = lib.pw_edge_candidates(x.data_ptr(), int(boards), cand, strong, blurred, taps.data_ptr(), ksize,
                                         ksize if fast else 0, th, tww, k, h, w, low, high, top, own,
                                         torch.cuda.current_stream().cuda_stream)
            _count("edge_candidates_slab" if top or bottom else "edge_candidates")
            _raise_on(lib, name, err)
    return outs


def edge_candidates_cuda(x: torch.Tensor, w: int | None, ksize: int, low: int, high: int, sigma: float = 0.0):
    """K3+K4: ``ops.canny.edge_candidates_plain`` in one launch.  ``x`` is a
    CUDA int32 bitboard (..., H, ⌈w/32⌉), a set bit reading as 255, or a CUDA
    uint8 image (..., H, W) → the (candidate, strong) int32 bitboards."""
    if low > high:
        low, high = high, low
    return _edge_launch(x, w, ksize, sigma, min(low, 2041), min(high, 2041), False)


def gaussian_blur_cuda(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """K3+K4's blur alone: ``ops.filters.gaussian_blur_u8_plain`` of a CUDA
    uint8 image (..., H, W) in one launch."""
    if img.dtype != torch.uint8:
        raise TypeError(f"gaussian_blur: expected a uint8 image, got {img.dtype}")
    return _edge_launch(img, None, ksize, sigma, 0, 0, True)[0]


def edge_candidates_slab_cuda(x: torch.Tensor, w: int, ksize: int, low: int, high: int, top: int, bottom: int,
                              sigma: float = 0.0):
    """K3+K4's slab mode: ``ops.canny.edge_candidates_slab_plain`` in one
    launch.  ``x`` is a CUDA slab of ``top`` + rows + ``bottom`` rows (a
    bitboard or a uint8 image), each side 0 or at least ``ksize // 2 + 2``
    halo rows → the own rows' (candidate, strong) bitboards."""
    if low > high:
        low, high = high, low
    return _edge_launch(x, w, ksize, sigma, min(low, 2041), min(high, 2041), False, top, bottom)


def gaussian_blur_slab_cuda(x: torch.Tensor, ksize: int, top: int, bottom: int, w: int | None = None,
                            sigma: float = 0.0) -> torch.Tensor:
    """K3+K4's blur-only slab mode: ``ops.filters.gaussian_blur_slab_plain``
    of a CUDA uint8 slab, or a bitboard slab of width ``w``, in one launch."""
    if x.dtype == torch.int32 and w is None:
        raise ValueError("gaussian_blur_slab: bitboards need their width in pixels")
    return _edge_launch(x, w, ksize, sigma, 0, 0, True, top, bottom)[0]


def resident_smem_bytes(kernel: str, h: int, nw: int) -> int:
    """Shared memory one CTA of a cluster takes for a band window of ``h``
    rows of ``nw`` words (``csrc/bitboard_fixpoints.cu``'s layout): rows of
    ``nw + 2`` words, ``ceil(h / CLUSTER_SIZE)`` of each board, K6 two boards
    and a zero row, K5 two boards, four published rows and a zero row; two
    int flags."""
    rpc = -(-h // CLUSTER_SIZE)
    rows = 2 * rpc + (1 if kernel == "zhang_suen_packed" else 5)
    return rows * (nw + 2) * 4 + 8


def resident(kernel: str, h: int, nw: int) -> bool:
    """Whether a window of ``h`` rows (a whole layer: the resident route) fits one cluster."""
    return resident_smem_bytes(kernel, h, nw) <= MAX_SMEM


def cluster_rows(kernel: str, nw: int) -> int:
    """The most rows of ``nw`` words a band window of K5 or K6 holds in one cluster."""
    per_cta = (MAX_SMEM - 8) // ((nw + 2) * 4) - (1 if kernel == "zhang_suen_packed" else 5)
    return CLUSTER_SIZE * max(0, per_cta // 2)


class BandSchedule(NamedTuple):
    """K5's or K6's launch over a layer (``csrc/bitboard_fixpoints.cu``'s
    ``Band``): ``bands`` ((r0, rows, w0, w1), ...), each band's own rows
    [r0, r0 + rows) and the window [w0, w1) that its cluster loads; ``halo``,
    the rows a window reads beyond its own on each side inside the layer (the
    whole layer for one band); ``m``, K6's iterations a launch (its halo is 2
    m; 1 for K5)."""

    bands: tuple
    halo: int
    m: int


def band_table(h: int, top: int, own: int, n: int, halo: int) -> tuple:
    """``n`` bands over the own rows [top, top + own) of a layer of ``h``
    rows, their own rows evenly split, each window ``halo`` rows a side
    inside the layer → ((r0, rows, w0, w1), ...)."""
    out = []
    for j in range(n):
        r0, r1 = top + j * own // n, top + (j + 1) * own // n
        out.append((r0, r1 - r0, max(0, r0 - halo), min(h, r1 + halo)))
    return tuple(out)


def _widest(table: tuple) -> int:
    return max(w1 - w0 for _, _, w0, w1 in table)


def _fewest_bands(kernel: str, h: int, nw: int, top: int, own: int, halo: int, least: int = 1) -> tuple:
    """The fewest bands, at least ``least``, whose windows fit one cluster
    (one band's window is the whole layer) → (table, halo as launched)."""
    cap = cluster_rows(kernel, nw)
    if least <= 1 and h <= cap:
        return band_table(h, top, own, 1, h), h
    for n in range(max(2, least, -(-own // max(1, cap))), own + 1):
        table = band_table(h, top, own, n, halo)
        if _widest(table) <= cap:
            return table, halo
    raise ValueError(f"{kernel}: no band of rows of {nw} words with {halo} halo rows a side fits one cluster "
                     f"({cap} rows)")


def band_schedule(kernel: str, h: int, nw: int, max_iter: int = 120, band_rows: int | None = None) -> BandSchedule:
    """K5's or K6's bands over a whole layer of ``h`` rows of ``nw`` words:
    the fewest bands whose windows fit one cluster (at least ⌈h /
    ``band_rows``⌉ where given), their own rows evenly split.  One band is
    the resident route.  K5 reads one halo row a side.  K6 runs rounds of m
    iterations with 2 m halo rows: the bands are the fewest that fit with m
    = min(``max_iter``, cap / 8) (cap: :func:`cluster_rows`), so that a band
    keeps at least half its window, and m is then the largest up to
    ``max_iter`` for which they fit (at 4400 × 4400 px and ``max_iter`` 120:
    two bands of 2,200 rows, m 120, one round)."""
    least = -(-h // band_rows) if band_rows else 1
    if kernel == "hysteresis":
        table, halo = _fewest_bands(kernel, h, nw, 0, h, 1, least)
        return BandSchedule(table, halo, 1)
    max_iter = max(0, max_iter)
    cap = cluster_rows(kernel, nw)
    table, halo = _fewest_bands(kernel, h, nw, 0, h, 2 * min(max_iter, cap // 8), least)
    if len(table) == 1:
        return BandSchedule(table, halo, max_iter)
    n, lo, hi = len(table), halo // 2, max_iter  # the largest m that fits, by bisection
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if _widest(band_table(h, 0, h, n, 2 * mid)) <= cap else (lo, mid - 1)
    return BandSchedule(band_table(h, 0, h, n, 2 * lo), 2 * lo, lo)


def slab_bands(kernel: str, h: int, nw: int, top: int, own: int, iters: int = 1,
               band_rows: int | None = None) -> BandSchedule:
    """The bands of a slab-mode call over the own rows [top, top + own) of
    a slab of ``h`` rows: one band whose window is the whole slab where it
    fits one cluster, else the fewest whose windows, ``2 * iters`` halo rows
    a side for K6 and 1 for K5, do (at least ⌈own / ``band_rows``⌉)."""
    least = -(-own // band_rows) if band_rows else 1
    halo = 1 if kernel == "hysteresis" else 2 * iters
    table, halo = _fewest_bands(kernel, h, nw, top, own, halo, least)
    return BandSchedule(table, halo, 1 if kernel == "hysteresis" else iters)


def cluster_fit(kernel: str, rows: int, nw: int) -> int:
    """The clusters of K6 or K5 with band windows of ``rows`` rows of ``nw``
    words that fit on the current card at once
    (``cudaOccupancyMaxActiveClusters``): a launch runs min(layers × bands,
    this) clusters, each looping over its (layer, band) items."""
    lib = load("bitboard_fixpoints")
    fit = ctypes.c_int(0)
    err = lib.pw_cluster_fit(0 if kernel == "zhang_suen_packed" else 1, -(-rows // CLUSTER_SIZE), nw,
                             ctypes.byref(fit))
    _raise_on(lib, "cluster_fit", err)
    return fit.value


def _whole(h: int, m: int) -> BandSchedule:
    """The resident route's one band: the whole layer."""
    return BandSchedule(((0, h, 0, h),), h, m)


def fixpoint_route(kernel: str, h: int, nw: int, route: str | None = None) -> str:
    """The route of K5 or K6 for a layer: ``route`` when given (one of
    :data:`ROUTES`), else ``"resident"`` where the layer fits one cluster,
    else ``"banded"``.  No size takes ``"multi"``.  Raises for a resident
    route that does not fit."""
    if route is None:
        return "resident" if resident(kernel, h, nw) else "banded"
    if route not in ROUTES:
        raise ValueError(f"{kernel}: route {route!r} is none of {ROUTES}")
    if route == "resident" and not resident(kernel, h, nw):
        raise ValueError(f"{kernel}: a layer of {h} rows of {nw} words does not fit one cluster")
    return route


def _check_grid(name: str, k: int, h: int) -> None:
    if k > 65535 or h > 65535:
        raise ValueError(f"{name}: {k} layers of {h} rows exceed the multi-launch kernels' grid")


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _flag_set(flag: torch.Tensor) -> bool:
    """The host's read of a changed flag on the device (one copy)."""
    return bool(flag.cpu()[0])


def _zs_launch(name: str, x, out, iters, edges, skels, changed, img_stride: int, group: int, layout: int, h: int,
               nw: int, width: int, n_iter: int, rotated: bool, top: int, own: int, out_row0: int, out_h: int,
               sched: BandSchedule) -> None:
    """One launch of K6's cluster kernel (``pw_zs_cluster_run``) over
    ``sched``'s bands of every layer of ``x`` (k, h, nw), counted as
    ``name``."""
    lib = load("bitboard_fixpoints")
    err = lib.pw_zs_cluster_run(x.data_ptr(), _ptr(out), iters.data_ptr(), _ptr(edges), _ptr(skels), _ptr(changed),
                                img_stride, group, layout, iters.numel(), h, nw, width, n_iter, int(rotated), top,
                                own, out_row0, out_h, len(sched.bands), sched.halo,
                                torch.cuda.current_stream().cuda_stream)
    _count(name)
    _raise_on(lib, name, err)


def _hysteresis_launch(name: str, cand, strong, prev, out, stats, changed, h: int, nw: int, top: int, own: int,
                       sched: BandSchedule) -> None:
    """One launch of K5's cluster kernel (``pw_hysteresis_cluster_run``)
    over ``sched``'s bands of every layer, counted as ``name``."""
    lib = load("bitboard_fixpoints")
    err = lib.pw_hysteresis_cluster_run(cand.data_ptr(), strong.data_ptr(), _ptr(prev), out.data_ptr(),
                                        stats.data_ptr(), _ptr(changed), stats.shape[0], h, nw, top, own,
                                        len(sched.bands), sched.halo, torch.cuda.current_stream().cuda_stream)
    _count(name)
    _raise_on(lib, name, err)


def _zs_banded(packed: torch.Tensor, max_iter: int, rotated: bool, band_rows: int | None, store: tuple | None):
    """K6's banded route: rounds of m iterations (:func:`band_schedule`),
    one launch each, two boards in turn, one flag read a round where another
    may follow, until ``max_iter`` or a round whose last iteration changed no
    band's own rows.  ``store`` = (edges, skels, layout, width, group, image
    stride): the input's own rows go to ``edges`` from the first round, each
    round's result to ``skels``.  Returns the last round's board (None where
    only the stores were asked for and one round sufficed)."""
    k, h, nw = packed.numel() // (packed.shape[-2] * packed.shape[-1]), packed.shape[-2], packed.shape[-1]
    sched = band_schedule("zhang_suen_packed", h, nw, max_iter, band_rows)
    edges, skels, layout, width, group, img_stride = store or (None, None, 0, 0, 1, 0)
    iters, flag = packed.new_empty(k), packed.new_empty(1)
    boards, src, done, rounds = [None, None], packed, 0, 0
    while True:
        n = min(sched.m, max_iter - done)
        last = done + n >= max_iter
        dst = None
        if store is None or not last:  # a board for the result, or for the next round's input
            if boards[rounds % 2] is None:
                boards[rounds % 2] = packed.new_empty(packed.shape)
            dst = boards[rounds % 2]
        _zs_launch("zhang_suen_packed_banded", src, dst, iters, edges if rounds == 0 else None, skels,
                   None if last else flag, img_stride, group, layout, h, nw, width, n, rotated, 0, h, 0, h, sched)
        done, rounds = done + n, rounds + 1
        if last or not _flag_set(flag):
            break
        src = dst
    STATS["zhang_suen_packed_banded"] = (rounds, iters)
    return dst


def _hysteresis_banded(cand: torch.Tensor, edges: torch.Tensor, top: int, own: int, sched: BandSchedule,
                       changed: torch.Tensor | None, name: str) -> torch.Tensor:
    """K5 over bands by rounds, one launch each: the own rows of the last
    round's result are the next round's edges (two boards in turn), read by
    the host once a round, until no band's own rows changed.  ``changed``
    (slab mode), where given, keeps the first round's answer: whether the
    own rows of the result differ from ``edges``."""
    k, h, nw = cand.numel() // (cand.shape[-2] * cand.shape[-1]), edges.shape[-2], edges.shape[-1]
    stats = edges.new_empty((k, 2))
    flag = changed if changed is not None else edges.new_empty(1)
    boards, prev, rounds = [None, None], None, 0
    while True:
        if boards[rounds % 2] is None:
            boards[rounds % 2] = cand.new_empty(cand.shape)
        out = boards[rounds % 2]
        _hysteresis_launch(name, cand, edges, prev, out, stats, flag, h, nw, top, own, sched)
        rounds += 1
        if not _flag_set(flag):
            STATS[name] = (rounds, stats)
            return out
        if rounds > 32 * cand.numel() + 1:  # every round after the first adds a bit of cand
            raise RuntimeError(f"{name}: no fixpoint within the rounds cand allows")
        if flag is changed:
            flag = edges.new_empty(1)
        prev = out


def zhang_suen_packed_cuda(packed: torch.Tensor, max_iter: int = 120, rotated: bool = True,
                           route: str | None = None, band_rows: int | None = None) -> torch.Tensor:
    """K6: the Zhang–Suen fixpoint of ``ops.thinning.zhang_suen_packed`` on
    CUDA bitboards, by :func:`fixpoint_route`; returns a new board.
    ``band_rows`` bounds a band's own rows on the banded route."""
    k, h, nw = _check("zhang_suen_packed", packed)
    route = fixpoint_route("zhang_suen_packed", h, nw, route)
    if max_iter <= 0 or packed.numel() == 0:
        return packed.clone()
    with _guard(packed.device):
        if route == "resident":
            out, iters = packed.new_empty(packed.shape), packed.new_empty(k)
            _zs_launch("zhang_suen_packed", packed, out, iters, None, None, None, 0, 1, 0, h, nw, 0, max_iter,
                       rotated, 0, h, 0, h, _whole(h, max_iter))
            STATS["zhang_suen_packed"] = iters
            return out
        if route == "banded":
            return _zs_banded(packed, max_iter, rotated, band_rows, None)
        _check_grid("zhang_suen_packed", k, h)
        lib = load("bitboard_fixpoints")
        stream = torch.cuda.current_stream().cuda_stream
        out, b = torch.empty_like(packed), torch.empty_like(packed)
        flags = torch.empty(ZS_CHUNK, dtype=torch.int32, device=packed.device)
        src, done = packed, 0
        while done < max_iter:
            n = min(ZS_CHUNK, max_iter - done)
            err = lib.pw_zs_packed_run(src.data_ptr(), out.data_ptr(), b.data_ptr(), flags.data_ptr(),
                                       k, h, nw, n, int(rotated), stream)
            _count("zhang_suen_packed_multi", 2 * n)  # two subpasses per iteration
            _raise_on(lib, "zhang_suen_packed_multi", err)
            src, done = out, done + n
            if not int(flags[n - 1].item()):
                break
        STATS["zhang_suen_packed_multi"] = done
    return out


# K6's layouts of the edges and skeletons it writes (``kRows``, ``kDense`` in csrc/bitboard_fixpoints.cu)
LAYOUTS = {"rows": 1, "dense": 2}


def row_bytes(layout: str, w: int) -> int:
    """Bytes of one output row of ``w`` px: packed rows ⌈w/8⌉, dense w."""
    return -(-w // 8) if layout == "rows" else w


def layer_offset(layer: int, group: int, h: int, rb: int, img_stride: int, row0: int = 0) -> int:
    """Where K6's store puts layer ``layer`` = b·group + l of its input in
    an output of ``h`` rows of ``rb`` bytes a layer, from row ``row0`` (a
    band's or slab's first own row): byte b·img_stride + (l·h + row0)·rb
    (``zs_cluster``'s ``half``)."""
    return (layer // group) * img_stride + ((layer % group) * h + row0) * rb


def _check_halves(name: str, packed: torch.Tensor, w: int, edges: torch.Tensor, skels: torch.Tensor,
                  layout: str) -> tuple:
    """(k, h, nw) of the boards and (B, group, image stride) of two uint8
    outputs (B, group, H, row bytes) on their device, each image's (group, H,
    row bytes) contiguous and the two with one image stride."""
    k, h, nw = _check(name, packed)
    _check_width(name, packed, w)
    if layout not in LAYOUTS:
        raise ValueError(f"{name}: layout {layout!r} is none of {tuple(LAYOUTS)}")
    rb = row_bytes(layout, w)
    for t in (edges, skels):
        if not (t.device == packed.device and t.dtype == torch.uint8 and t.dim() == 4 and t.shape[2:] == (h, rb)
                and t.shape == edges.shape and t.stride()[1:] == (h * rb, rb, 1) and t.stride(0) == edges.stride(0)):
            raise ValueError(f"{name}: expected two uint8 (B, group, {h}, {rb}) outputs on {packed.device} with "
                             f"contiguous images and one image stride, got {tuple(t.shape)} {t.stride()} {t.dtype}")
    b, group = edges.shape[:2]
    if b * group != k:
        raise ValueError(f"{name}: outputs of {b} x {group} layers for {k} layers of boards")
    return k, h, nw, b, group, edges.stride(0)


def zhang_suen_into_cuda(packed: torch.Tensor, w: int, edges: torch.Tensor, skels: torch.Tensor,
                         layout: str = "rows", max_iter: int = 120, rotated: bool = True,
                         route: str | None = None, band_rows: int | None = None) -> None:
    """K6 with its stores: ``ops.thinning.zhang_suen_into_plain`` on CUDA
    bitboards.  Writes the input's layers (the edges) into ``edges`` and
    their fixpoint (the skeletons) into ``skels``, layer b·group + l at
    ``[b, l]`` of each, in ``layout`` (:data:`LAYOUTS`: packed rows, or dense
    bytes 255 / 1), by :func:`fixpoint_route`: the resident route in its one
    launch (max_iter 0 too), the banded route from its launches (one at
    4400 × 4400), the multi-launch route by K6's launches and then K1 for
    each image's edges and skeletons."""
    k, h, nw, b, group, img_stride = _check_halves("zhang_suen_into", packed, w, edges, skels, layout)
    route = fixpoint_route("zhang_suen_packed", h, nw, route)
    if packed.numel() == 0:
        return
    if route == "multi":
        skel_b = zhang_suen_packed_cuda(packed, max_iter, rotated, route)
        for src, dst, value in ((packed, edges, 255), (skel_b, skels, 1)):
            for i, layers in enumerate(src.view(b, group, h, nw)):
                if layout == "rows":
                    boards_to_rows_cuda(layers, w, out=dst[i])
                else:
                    boards_to_dense_cuda(layers, w, value, out=dst[i])
        return
    with _guard(packed.device):
        if route == "banded":
            _zs_banded(packed, max(0, max_iter), rotated, band_rows,
                       (edges, skels, LAYOUTS[layout], w, group, img_stride))
            return
        iters = packed.new_empty(k)
        _zs_launch("zhang_suen_packed", packed, None, iters, edges, skels, None, img_stride, group, LAYOUTS[layout],
                   h, nw, w, max_iter, rotated, 0, h, 0, h, _whole(h, max_iter))
        STATS["zhang_suen_packed"] = iters


def hysteresis_cuda(cand: torch.Tensor, strong: torch.Tensor, route: str | None = None,
                    band_rows: int | None = None) -> torch.Tensor:
    """K5: the hysteresis fixpoint of ``ops.canny.hysteresis`` on CUDA
    bitboards, by :func:`fixpoint_route`; returns a new board.  The banded
    route runs one launch a round and reads one flag a round (its rounds in
    ``STATS["hysteresis_banded"]``); ``band_rows`` bounds a band's own rows
    there."""
    k, h, nw = _check("hysteresis", cand, strong)
    route = fixpoint_route("hysteresis", h, nw, route)
    if cand.numel() == 0:
        return cand.clone()
    with _guard(cand.device):
        if route == "resident":
            out, stats = cand.new_empty(cand.shape), cand.new_empty((k, 2))  # stats zeroed by the library
            _hysteresis_launch("hysteresis", cand, strong, None, out, stats, None, h, nw, 0, h, _whole(h, 1))
            STATS["hysteresis"] = stats
            return out
        if route == "banded":
            return _hysteresis_banded(cand, strong, 0, h, band_schedule("hysteresis", h, nw, band_rows=band_rows),
                                      None, "hysteresis_banded")
        _check_grid("hysteresis", k, h)
        lib = load("bitboard_fixpoints")
        stream = torch.cuda.current_stream().cuda_stream
        e0, e1 = torch.empty_like(cand), torch.empty_like(cand)
        flags = torch.empty(HYSTERESIS_CHUNK, dtype=torch.int32, device=cand.device)
        init, done = strong, 0
        # every sweep but the last adds a bit of cand, so this bounds the loop
        while done <= 32 * cand.numel():
            err = lib.pw_hysteresis_run(cand.data_ptr(), init.data_ptr(), e0.data_ptr(), e1.data_ptr(),
                                        flags.data_ptr(), k, h, nw, HYSTERESIS_CHUNK, stream)
            _count("hysteresis_multi", HYSTERESIS_CHUNK)
            _raise_on(lib, "hysteresis_multi", err)
            init, done = e0, done + HYSTERESIS_CHUNK
            if not int(flags[-1].item()):
                STATS["hysteresis_multi"] = done
                return e0
    raise RuntimeError("hysteresis: no fixpoint within the sweeps cand allows")


def _slab_flag(name: str, changed: torch.Tensor, device: torch.device) -> None:
    if not (changed.device == device and changed.dtype == torch.int32 and changed.numel() == 1
            and changed.is_contiguous()):
        raise ValueError(f"{name}: the changed flag must be one contiguous int32 on {device}")


def hysteresis_slab_cuda(cand: torch.Tensor, edges: torch.Tensor, top: int, bottom: int,
                         changed: torch.Tensor, band_rows: int | None = None) -> torch.Tensor:
    """K5's slab mode: ``ops.canny.hysteresis_slab_plain`` on CUDA
    bitboards.  ``changed`` (one int32 on the device, e.g. a shard's slot of
    a round's flags) is set where an own row gained a bit; the host reads
    it.  A slab that fits one cluster takes one launch; a larger one (or one
    cut by ``band_rows``) runs as bands, by rounds inside the call until no
    band's own rows changed, one launch and one flag read each."""
    k, h, nw = _check("hysteresis_slab", edges)
    own = slab_rows("hysteresis_slab", h, top, bottom, 1)
    kc, hc, nwc = _check("hysteresis_slab", cand)
    if (kc, hc, nwc) != (k, own, nw) or cand.device != edges.device:
        raise ValueError(f"hysteresis_slab: candidates {tuple(cand.shape)} are not the own rows of edges "
                         f"{tuple(edges.shape)} with halos {top}, {bottom}")
    _slab_flag("hysteresis_slab", changed, edges.device)
    sched = slab_bands("hysteresis", h, nw, top, own, band_rows=band_rows)
    with _guard(edges.device):
        if len(sched.bands) > 1:
            return _hysteresis_banded(cand, edges, top, own, sched, changed, "hysteresis_slab")
        out, stats = cand.new_empty(cand.shape), edges.new_empty((k, 2))  # rounds and sweeps, not read
        _hysteresis_launch("hysteresis_slab", cand, edges, None, out, stats, changed, h, nw, top, own, sched)
    return out


def zhang_suen_slab_cuda(x: torch.Tensor, top: int, bottom: int, iters: int, changed: torch.Tensor,
                         w: int | None = None, edges: torch.Tensor | None = None, skels: torch.Tensor | None = None,
                         layout: str = "rows", row0: int = 0, rotated: bool = True,
                         band_rows: int | None = None) -> torch.Tensor:
    """K6's slab mode: ``ops.thinning.zhang_suen_slab_plain`` on CUDA
    bitboards in one launch → the own rows' boards: one band where the slab
    fits one cluster, else the fewest bands whose windows of ``2 * iters``
    halo rows a side do (:func:`slab_bands`).  ``changed`` (one int32 on the
    device) is set where the last iteration changed an own row.  ``edges``
    (optional) and ``skels`` (B, group, H, row bytes) uint8 on the device,
    each image contiguous and both with one image stride, receive the own
    rows at rows [row0, row0 + rows) of each layer, from the same launch."""
    k, h, nw = _check("zhang_suen_slab", x)
    own = slab_rows("zhang_suen_slab", h, top, bottom, 2 * iters)
    _slab_flag("zhang_suen_slab", changed, x.device)
    if iters < 0:
        raise ValueError(f"zhang_suen_slab: {iters} iterations")
    sched = slab_bands("zhang_suen_packed", h, nw, top, own, iters, band_rows)
    img_stride, group = 0, 1
    if skels is not None:
        if w is None or layout not in LAYOUTS:
            raise ValueError(f"zhang_suen_slab: stores need the width and a layout of {tuple(LAYOUTS)}")
        _check_width("zhang_suen_slab", x, w)
        rb = row_bytes(layout, w)
        for t in (skels,) if edges is None else (edges, skels):
            if not (t.device == x.device and t.dtype == torch.uint8 and t.dim() == 4 and t.shape[3] == rb
                    and t.shape == skels.shape and t.stride()[1:] == (t.shape[2] * rb, rb, 1)
                    and t.stride(0) == skels.stride(0) and 0 <= row0 and row0 + own <= t.shape[2]):
                raise ValueError(f"zhang_suen_slab: expected uint8 (B, group, H, {rb}) outputs on {x.device} with "
                                 f"contiguous images and one image stride, holding rows {row0}..{row0 + own}, got "
                                 f"{tuple(t.shape)} {t.stride()} {t.dtype}")
        group, img_stride = skels.shape[1], skels.stride(0)
        if skels.shape[0] * group != k:
            raise ValueError(f"zhang_suen_slab: outputs of {skels.shape[0]} x {group} layers for {k} layers")
    elif edges is not None:
        raise ValueError("zhang_suen_slab: edges are stored beside the skeletons only")
    with _guard(x.device):
        out = x.new_empty((*x.shape[:-2], own, nw))
        iter_counts = x.new_empty(k)
        _zs_launch("zhang_suen_packed_slab", x, out, iter_counts, edges, skels, changed, img_stride, group,
                   LAYOUTS[layout] if skels is not None else 0, h, nw, w or 0, iters, rotated, top, own, row0,
                   skels.shape[2] if skels is not None else own, sched)
        STATS["zhang_suen_packed_slab"] = iter_counts
    return out


def thinning_round(rows: int, nw: int, max_iter: int) -> int:
    """Row sharding's Zhang–Suen round, ``m`` iterations on slabs of
    ``rows`` own rows of ``nw`` words widened by 2 m rows a side: as long as
    the neighbours can give (m ≤ rows / 2) and ``max_iter`` allows.  Where
    the widened slab does not fit one cluster, K6 runs it as bands
    (:func:`slab_bands`), and m is fitted to a band: at most cap / 8 (cap:
    :func:`cluster_rows`), so that a band keeps at least half its window.
    Each launch stops at its bands' fixpoints, so a longer round costs rows,
    not iterations, and saves rounds: a launch and a flag read each."""
    m = max(1, min(max_iter, rows // 2))
    if resident("zhang_suen_packed", rows + 4 * m, nw):
        return m
    return max(1, min(m, cluster_rows("zhang_suen_packed", nw) // 8))


@functools.lru_cache(maxsize=None)
def element_rows(shape: str, ksize: int):
    """The structuring element as K2 takes it: (dy0, (one mask per row of
    taps, bit dx + 31 set for each tap)).  Raises for |dx| > 31."""
    se = structuring_element(shape, ksize)
    r = se.shape[0] // 2
    ys, xs = np.nonzero(se)
    if len(xs) == 0 or np.abs(xs - r).max() > 31:
        raise ValueError(f"morph_bits: {shape} {ksize}: the kernel takes 1 to 63 columns (|dx| <= 31)")
    rows = [0] * se.shape[0]
    for y, x in zip(ys.tolist(), xs.tolist()):
        rows[y] |= 1 << (x - r + 31)
    return -r, tuple(rows)


def morph_smem_bytes(band: int, radius: int, nw: int) -> int:
    """Shared memory one block of K2 takes (``csrc/morph_bits.cu``): two
    boards of ``band + 2 * radius`` rows and the valid row, each of ``nw +
    2`` words, and the masks of two steps."""
    return (2 * (band + 2 * radius) + 1) * (nw + 2) * 4 + MORPH_MASK_BYTES


@functools.lru_cache(maxsize=None)
def morph_schedule(radii: tuple, h: int, nw: int) -> tuple:
    """K2's launches for steps of row radii ``radii`` on layers of ``h``
    rows of ``nw`` words: ((first step, end step, band rows, summed radius),
    ...), one launch each.  Consecutive steps share a launch while a block
    of :data:`MORPH_BAND` rows (fewer for a shorter layer) and their summed
    radius fits :data:`MAX_SMEM`; a step that does not fit alone takes a
    shorter band, and raises where no band fits."""
    full = max(1, min(MORPH_BAND, h))
    segments, start = [], 0
    while start < len(radii):
        stop, radius = start, 0
        while stop < len(radii) and morph_smem_bytes(full, radius + radii[stop], nw) <= MAX_SMEM:
            radius, stop = radius + radii[stop], stop + 1
        band = full
        if stop == start:
            radius, stop = radii[start], start + 1
            band = ((MAX_SMEM - MORPH_MASK_BYTES) // ((nw + 2) * 4) - 1) // 2 - 2 * radius
            if band < 1:
                raise ValueError(f"morph_bits: a step of row radius {radius} on rows of {nw} words does not fit "
                                 f"one block's shared memory")
        segments.append((start, stop, band, radius))
        start = stop
    return tuple(segments)


_tables: dict = {}  # (steps, device) → K2's step table on the device and the steps' row radii


def _step_table(steps: tuple, device: torch.device):
    """K2's step table (``csrc/morph_bits.cu``): per step (erode, row radius,
    rows of taps, index of its first mask), then the masks, int64 on
    ``device``; built once per step list and device."""
    key = (steps, device)
    if key not in _tables:
        heads, masks, radii = [], [], []
        for shape, ksize, op in steps:
            dy0, rows = element_rows(shape, ksize)
            heads += [int(op != "d"), -dy0, len(rows), 4 * len(steps) + len(masks)]
            masks += rows
            radii.append(-dy0)
        _tables[key] = torch.tensor(heads + masks, dtype=torch.int64, device=device), tuple(radii)
    return _tables[key]


def _check_rows(name: str, rows: torch.Tensor, w: int) -> tuple:
    """(layers, h) of CUDA uint8 packed rows (..., H, ⌈w/8⌉)."""
    _check_dense(name, rows, (torch.uint8,))
    if rows.dim() < 2 or w <= 0 or rows.shape[-1] != -(-w // 8):
        raise ValueError(f"{name}: expected (..., H, ⌈{w}/8⌉) packed rows, got {tuple(rows.shape)}")
    h = rows.shape[-2]
    return (rows.numel() // (h * rows.shape[-1]) if h else 0), h


def morph_steps_cuda(x: torch.Tensor, valid: torch.Tensor, steps, width: int | None = None,
                     rows_out: torch.Tensor | None = None) -> torch.Tensor:
    """K2: ``ops.morphology.morph_steps_plain``'s step list on CUDA bitboards,
    or on uint8 packed rows (..., H, ⌈width/8⌉) that its load converts, one
    launch per segment of :func:`morph_schedule` (one at the defaults) → a
    new board.  ``rows_out`` (a contiguous uint8 tensor of as many bytes as
    the rows, on that device, e.g. a view into a blob) receives the result's
    packed rows from the same launch.  An empty list returns ``x`` itself for
    a board and no ``rows_out``, else it is one launch that converts."""
    rows_in = x.dtype == torch.uint8
    if rows_in:
        if width is None:
            raise ValueError("morph_bits: packed rows need their width")
        k, h = _check_rows("morph_bits", x, width)
        nw = -(-width // 32)
    else:
        k, h, nw = _check("morph_bits", x)
    if not (valid.is_cuda and valid.device == x.device and valid.dtype == torch.int32
            and valid.is_contiguous() and tuple(valid.shape) == (nw,)):
        raise ValueError(f"morph_bits: valid must be a contiguous ({nw},) int32 tensor on {x.device}")
    if rows_out is not None:
        if width is None or -(-width // 32) != nw:
            raise ValueError(f"morph_bits: rows_out needs the width of rows of {nw} words")
        _check_dense("morph_bits", rows_out, (torch.uint8,))
        if rows_out.device != x.device or rows_out.numel() != k * h * -(-width // 8):
            raise ValueError(f"morph_bits: rows_out {tuple(rows_out.shape)} on {rows_out.device} does not take "
                             f"{k} x {h} rows of {width} px")
    steps = tuple(steps)
    if not steps and not rows_in and rows_out is None:
        return x
    table, radii = _step_table(steps, x.device)
    shape = (*x.shape[:-1], nw)
    if x.numel() == 0:
        return torch.empty(shape, dtype=torch.int32, device=x.device)
    if k > 65535:
        raise ValueError(f"morph_bits: {k} layers exceed the kernel's grid")
    # a list of no steps is one launch that converts
    segments = morph_schedule(radii, h, nw) or ((0, 0, max(1, min(MORPH_BAND, h)), 0),)
    lib = load("morph_bits")
    with _guard(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        bufs = [torch.empty(shape, dtype=torch.int32, device=x.device) for _ in range(min(2, len(segments)))]
        src = x
        for j, (start, stop, band, radius) in enumerate(segments):
            dst = bufs[j % 2]
            first_rows = rows_in and j == 0
            last_rows = rows_out is not None and j == len(segments) - 1
            err = lib.pw_morph_steps_run(None if first_rows else src.data_ptr(), src.data_ptr() if first_rows else None,
                                         dst.data_ptr(), rows_out.data_ptr() if last_rows else None, valid.data_ptr(),
                                         table.data_ptr(), start, stop - start, radius, band, k, h, nw, width or 0,
                                         stream)
            _count("morph_bits")
            _raise_on(lib, "morph_bits", err)
            src = dst
    return src


def _check_k7(name: str, image: torch.Tensor, centers: torch.Tensor) -> None:
    if not image.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {image.device}")
    if image.dtype != torch.uint8 or image.dim() < 1 or image.shape[-1] != 3 or not image.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous (..., 3) uint8 image, got "
                         f"{image.dtype} {tuple(image.shape)}")
    if not (centers.device == image.device and centers.dtype == torch.float32 and centers.dim() == 2
            and centers.shape[1] == 3 and centers.is_contiguous()):
        raise ValueError(f"{name}: expected contiguous (k, 3) float32 centers on {image.device}")
    if 16 * centers.shape[0] + 2048 > MAX_SMEM:
        raise ValueError(f"{name}: {centers.shape[0]} centres do not fit one block's shared memory")


def assign_nearest_cuda(image: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """K7: ``ops.frontend.assign_nearest`` of a CUDA (..., H, W, 3) uint8
    image and (k, 3) float32 centres on its device → (..., H, W) int32."""
    _check_k7("assign_nearest", image, centers)
    lib = load("assign_nearest")
    with _guard(image.device):
        labels = torch.empty(image.shape[:-1], dtype=torch.int32, device=image.device)
        err = lib.pw_assign_nearest(image.data_ptr(), centers.data_ptr(), labels.data_ptr(),
                                    centers.shape[0], labels.numel(), torch.cuda.current_stream().cuda_stream)
        _count("assign_nearest")
        _raise_on(lib, "assign_nearest", err)
    return labels


def assign_boards_cuda(image: torch.Tensor, centers: torch.Tensor, counts: torch.Tensor | None = None) -> torch.Tensor:
    """K7, its boards: ``ops.frontend.assign_boards_plain`` of a CUDA (...,
    H, W, 3) uint8 image and (k, 3) float32 centres → the one-hot int32
    bitboards (..., k, H, ⌈W/32⌉) of the nearest centre, with no labels in
    device memory.  ``counts``, a contiguous (k,) int32 tensor on the image's
    device (e.g. a view into a blob), receives the pixels of each centre; one
    (H, W, 3) image only."""
    _check_k7("assign_boards", image, centers)
    if image.dim() < 3:
        raise ValueError(f"assign_boards: expected (..., H, W, 3), got {tuple(image.shape)}")
    if counts is not None and not (image.dim() == 3 and counts.device == image.device and counts.dtype == torch.int32
                                   and counts.is_contiguous() and tuple(counts.shape) == (centers.shape[0],)):
        raise ValueError(f"assign_boards: counts need one (H, W, 3) image and a contiguous ({centers.shape[0]},) "
                         f"int32 tensor on {image.device}")
    h, w = image.shape[-3], image.shape[-2]
    k, nw = centers.shape[0], -(-w // 32)
    n_img = image.numel() // (h * w * 3) if h * w else 0
    if n_img * k * h * nw >= 2**31 or n_img * h * w >= 2**31:
        raise ValueError(f"assign_boards: {k} layers of {tuple(image.shape)} exceed the kernel's index range")
    lib = load("assign_nearest")
    with _guard(image.device):
        boards = torch.empty((*image.shape[:-3], k, h, nw), dtype=torch.int32, device=image.device)
        err = lib.pw_assign_boards(image.data_ptr(), centers.data_ptr(), boards.data_ptr(),
                                   None if counts is None else counts.data_ptr(), k, n_img, h, w,
                                   torch.cuda.current_stream().cuda_stream)
        _count("assign_nearest")
        _raise_on(lib, "assign_boards", err)
    return boards


def zhang_suen_dense_cuda(binary: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """K12: ``ops.thinning.zhang_suen_dense`` on a CUDA (k, H, W) or (H, W)
    0/nonzero tensor → int32 0/1 of the same shape.  Each launch runs up to
    :data:`ZS_CHUNK` iterations; the host reads one flag per launch where
    another may follow, and launches again only while the last iteration
    changed a pixel."""
    if not binary.is_cuda:
        raise ValueError(f"zhang_suen_dense: expected a CUDA tensor, got {binary.device}")
    planes, squeeze = _dense_planes(binary, "zhang_suen_dense")
    k, h, w = planes.shape
    if planes.numel() >= 2**31 or k > 65535 or -(-h // ZS_TILE_ROWS) > 65535:
        raise ValueError(f"zhang_suen_dense: {tuple(planes.shape)} exceeds the kernel's grid")
    # the kernel reads bytes and binarises them (v != 0) as it packs them
    if planes.dtype == torch.uint8:
        src = planes.contiguous()
    elif planes.dtype == torch.bool:
        src = planes.contiguous().view(torch.uint8)
    else:
        src = (planes > 0).view(torch.uint8)
    with _guard(binary.device):
        out = torch.empty((k, h, w), dtype=torch.int32, device=binary.device)
        if out.numel():
            lib = load("zs_dense")
            stream = torch.cuda.current_stream().cuda_stream
            flags = torch.empty(max(max_iter, 1), dtype=torch.int32, device=binary.device)  # zeroed per launch
            # the packed state between launches; none where one launch runs every iteration
            state = torch.empty((2 if max_iter > ZS_CHUNK else 0, k, h, -(-w // 32)), dtype=torch.int32,
                                device=binary.device)
            packed_in, done, j = 0, 0, 0
            while True:
                n = max(0, min(ZS_CHUNK, max_iter - done))
                last = done + n >= max_iter
                dst = None if last else state[j % 2]
                err = lib.pw_zs_tiles_run(src.data_ptr(), packed_in, None if dst is None else dst.data_ptr(),
                                          out.data_ptr(), flags.data_ptr() + 4 * done, k, h, w, n, int(rotated),
                                          stream)
                _count("zhang_suen_dense")
                _raise_on(lib, "zhang_suen_dense", err)
                done, j = done + n, j + 1
                if last or not int(flags[done - 1].item()):
                    break
                src, packed_in = dst, 1
            STATS["zhang_suen_dense"] = done
    return out[0] if squeeze else out


def _check_f32(name: str, t: torch.Tensor, shape_tail: tuple, device=None) -> None:
    """A CUDA contiguous float32 tensor whose last dims are ``shape_tail``."""
    if not t.is_cuda or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a CUDA tensor" + (f" on {device}" if device is not None else "")
                         + f", got {t.device}")
    if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape[t.dim() - len(shape_tail):]) != shape_tail:
        raise ValueError(f"{name}: expected a contiguous float32 tensor (..., {shape_tail}), got {t.dtype} "
                         f"{tuple(t.shape)}")


def lab_sample_cuda(image: torch.Tensor, idx: torch.Tensor | None = None) -> torch.Tensor:
    """K8's sampler: the float Lab (K7's arithmetic, bit for bit) of the
    pixels ``idx`` ((n,) int32 on the image's device, indices into the
    flattened pixels, which the caller has checked or drawn below the pixel
    count: ``ops.kmeans.lab_sample``, ``subsample_lab``) of a CUDA (..., 3)
    uint8 image → (n, 3) float32; every pixel in order where ``idx`` is
    None."""
    _check_dense("lab_sample", image, (torch.uint8,))
    if image.shape[-1] != 3:
        raise ValueError(f"lab_sample: expected a (..., 3) image, got {tuple(image.shape)}")
    px = image.numel() // 3
    if idx is not None:
        if not (idx.device == image.device and idx.dtype == torch.int32 and idx.dim() == 1 and idx.is_contiguous()):
            raise ValueError(f"lab_sample: expected contiguous (n,) int32 indices on {image.device}")
    n = px if idx is None else idx.numel()
    with _guard(image.device):
        out = torch.empty((n, 3), dtype=torch.float32, device=image.device)
        if n:
            lib = load("kmeans")
            err = lib.pw_lab_sample(image.data_ptr(), None if idx is None else idx.data_ptr(), out.data_ptr(), n, px,
                                    torch.cuda.current_stream().cuda_stream)
            _count("lab_sample")
            _raise_on(lib, "lab_sample", err)
    return out


def kpp_schedule(n: int) -> dict:
    """K8's seeds and fits of n rows, as ``pw_kmeans_fit`` and
    ``pw_lloyd_fit`` run them: ``rows`` a CTA of the cluster (``⌈n /
    CLUSTER_SIZE⌉``), ``tiles`` of :data:`KPP_THREADS` rows each, and the route
    by size: ``resident`` (each CTA's rows and their d², 16 bytes a row, in
    shared memory after the tiles' totals, the fit's scratch in place of d²
    once the seeds are drawn) where that fits, about 230,000 rows, else
    ``streamed`` (the rows read as coalesced tiles each draw and pass, d² in
    device scratch)."""
    rows = -(-n // CLUSTER_SIZE)
    tiles = -(-rows // KPP_THREADS)
    fits = 8 * tiles + 12 * rows + max(4 * rows, FIT_SCRATCH_BYTES) + KPP_STATIC_SMEM <= MAX_SMEM
    return {"route": "resident" if fits else "streamed", "rows": rows, "tiles": tiles}


def _fit_outputs(attempts: int, k: int, extra: int, device) -> tuple:
    """One float32 allocation for K8's fit outputs: the best centres (k, 3),
    centres (attempts, k, 3), compactness (attempts,), then int32 picks
    (attempts, k), iterations (attempts,), the done counter and the best
    attempt's index, then ``extra`` floats of scratch, all flat."""
    sizes = (3 * k, 3 * attempts * k, attempts, attempts * k, attempts, 1, 1, extra)
    parts = list(torch.split(torch.empty(sum(sizes), dtype=torch.float32, device=device), sizes))
    for i in (3, 4, 5, 6):
        parts[i] = parts[i].view(torch.int32)
    return tuple(parts)


def kmeans_fit_cuda(sample: torch.Tensor, draws: torch.Tensor, iters: int, eps: float = 0.5,
                    out: torch.Tensor | None = None):
    """K8's seeds and fits in one launch: ``ops.kmeans.kmeans_fit_plain``
    (``kpp_init_plain``, then ``lloyd_fits_plain`` from its seeds) on the
    route :func:`kpp_schedule` gives.  ``sample`` (n, 3) float32, n <
    :data:`KPP_MAX_N` (the weights' sum stays below 2^63); ``draws``
    (attempts, k) float32 on its device, k <= :data:`KMEANS_MAX_K`: each
    attempt's first row as int32 bits, then its k − 1 uniforms in [0, 1]
    (``ops.kmeans.seed_draws``) → (best centres (k, 3), written into ``out``
    when given: a contiguous float32 tensor of 3 k elements on that device;
    centres (attempts, k, 3), the seeds where ``iters`` is 0; compactness
    (attempts,); iterations (attempts,) int32; the seeds' rows (attempts, k)
    int32), all on the device.  Nothing is read back here."""
    _check_f32("kmeans_fit", sample, (3,))
    if draws.dim() != 2:
        raise ValueError(f"kmeans_fit: expected (attempts, k) draws, got {tuple(draws.shape)}")
    n, (attempts, k) = sample.shape[0], draws.shape
    _check_f32("kmeans_fit", draws, (attempts, k), sample.device)
    if sample.dim() != 2 or not 0 < n < KPP_MAX_N or attempts < 1 or not 1 <= k <= KMEANS_MAX_K or iters < 0:
        raise ValueError(f"kmeans_fit: expected an (n, 3) sample of 1 to {KPP_MAX_N - 1} rows (a sum of weights "
                         f"below 2^63), 1 to {KMEANS_MAX_K} centres and iterations >= 0, got {tuple(sample.shape)}, "
                         f"k = {k}, {iters}")
    if out is not None:
        _check_f32("kmeans_fit", out.reshape(-1), (3 * k,), sample.device)
    resident = kpp_schedule(n)["route"] == "resident"
    lib = load("kmeans")
    with _guard(sample.device):
        best, centers, comp, picks, its, done, best_idx, d2 = _fit_outputs(attempts, k, 0 if resident else attempts * n,
                                                                           sample.device)
        best = best if out is None else out
        err = lib.pw_kmeans_fit(sample.data_ptr(), n, k, attempts, draws.data_ptr(), int(iters), float(eps),
                                int(resident), None if resident else d2.data_ptr(), picks.data_ptr(),
                                centers.data_ptr(), comp.data_ptr(), its.data_ptr(), done.data_ptr(), best.data_ptr(),
                                best_idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _count("kmeans_fit")
        _raise_on(lib, "kmeans_fit", err)
        STATS["kmeans_fit"] = (its, comp, best_idx)
    return best.view(k, 3), centers.view(attempts, k, 3), comp, its, picks.view(attempts, k)


def subsample_cuda(words: tuple, n: int, limit: int, device) -> torch.Tensor:
    """K8's draw: ``ops.kmeans.subsample_indices_plain`` on a CUDA device in
    one cooperative launch in clusters, nothing zeroed before it and nothing
    read back.  ``words``: the key words (a, b) of ``ops.kmeans.draw_words``;
    1 <= ``limit`` < ``n`` < 2^31 → (limit,) int32 indices, increasing."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"subsample: expected a CUDA device, got {device}")
    if not 1 <= limit < n < 2**31:
        raise ValueError(f"subsample: expected 1 <= limit < n < 2^31, got {limit}, {n}")
    lib = load("kmeans")
    with _guard(device):
        out = torch.empty(limit, dtype=torch.int32, device=device)
        scratch = torch.empty(DRAW_SCRATCH_WORDS + min(n, DRAW_MAX_BUCKET), dtype=torch.int32, device=device)
        err = lib.pw_subsample(n, limit, int(words[0]), int(words[1]), out.data_ptr(), scratch.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
        _count("subsample")
        _raise_on(lib, "subsample", err)
    return out


def lloyd_fit_cuda(sample: torch.Tensor, init: torch.Tensor, iters: int, eps: float = 0.5,
                   out: torch.Tensor | None = None):
    """K8's fits from given seeds: ``ops.kmeans.lloyd_plain`` from each of
    ``init``'s (attempts, k, 3) seeds on the CUDA (n, 3) float32 ``sample``
    and the choice of the first attempt of least compactness, all in one
    launch of the fit body of :func:`kmeans_fit_cuda`, on the route
    :func:`kpp_schedule` gives → (best centres (k, 3), written into ``out``
    when given: a contiguous float32 tensor of 3 k elements on that device;
    centres (attempts, k, 3); compactness (attempts,); iterations (attempts,)
    int32), all on the device.  Nothing is read back here."""
    _check_f32("lloyd_fit", sample, (3,))
    if init.dim() != 3:
        raise ValueError(f"lloyd_fit: expected (attempts, k, 3) seeds, got {tuple(init.shape)}")
    attempts, k = init.shape[:2]
    _check_f32("lloyd_fit", init, (attempts, k, 3), sample.device)
    n = sample.shape[0]
    if sample.dim() != 2 or not 0 < n < 2**31 or attempts < 1 or not 1 <= k <= KMEANS_MAX_K or iters < 0:
        raise ValueError(f"lloyd_fit: expected an (n, 3) sample, 1 to {KMEANS_MAX_K} centres and iterations >= 0, "
                         f"got {tuple(sample.shape)}, k = {k}, {iters}")
    if out is not None:
        _check_f32("lloyd_fit", out.reshape(-1), (3 * k,), sample.device)
    resident = kpp_schedule(n)["route"] == "resident"
    lib = load("kmeans")
    with _guard(sample.device):
        best, centers, comp, _, its, done, best_idx, _ = _fit_outputs(attempts, k, 0, sample.device)
        best = best if out is None else out
        err = lib.pw_lloyd_fit(sample.data_ptr(), n, k, attempts, init.data_ptr(), int(iters), float(eps),
                               int(resident), centers.data_ptr(), comp.data_ptr(), its.data_ptr(), done.data_ptr(),
                               best.data_ptr(), best_idx.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _count("lloyd_fit")
        _raise_on(lib, "lloyd_fit", err)
        STATS["lloyd_fit"] = (its, comp, best_idx)
    return best.view(k, 3), centers.view(attempts, k, 3), comp, its


def assign_points_cuda(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """K8's assignment: ``ops.kmeans.assign_points_plain`` of CUDA (n, 3)
    float32 points and (k, 3) centres on their device → (n,) int32."""
    _check_f32("assign_points", data, (3,))
    if data.dim() != 2 or centers.dim() != 2 or not 1 <= centers.shape[0] <= 3072:
        raise ValueError(f"assign_points: expected (n, 3) points and 1 to 3072 centres, got {tuple(data.shape)}, "
                         f"{tuple(centers.shape)}")
    _check_f32("assign_points", centers, (centers.shape[0], 3), data.device)
    with _guard(data.device):
        labels = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
        if labels.numel():
            lib = load("kmeans")
            err = lib.pw_assign_points(data.data_ptr(), data.shape[0], centers.data_ptr(), centers.shape[0],
                                       labels.data_ptr(), torch.cuda.current_stream().cuda_stream)
            _count("assign_points")
            _raise_on(lib, "assign_points", err)
    return labels


@functools.lru_cache(maxsize=None)
def element_runs(shape: str, ksize: int):
    """The structuring element as K11 takes it: (radius, ((dx0, dx1, (dy, ...)),
    ...)), each row's runs of consecutive set cells [dx0, dx1] around the
    anchor ``ksize // 2``, with the rows dy that hold each run, by run."""
    se = structuring_element(shape, ksize)
    ry, rx = se.shape[0] // 2, se.shape[1] // 2
    rows: dict = {}
    for i, row in enumerate(se.tolist()):
        j = 0
        while j < len(row):
            if row[j]:
                end = j
                while end + 1 < len(row) and row[end + 1]:
                    end += 1
                rows.setdefault((j - rx, end - rx), []).append(i - ry)
                j = end + 1
            else:
                j += 1
    if not rows:
        raise ValueError(f"morph: {shape} {ksize} has no set cell")
    return max(ry, rx), tuple((dx0, dx1, tuple(dys)) for (dx0, dx1), dys in sorted(rows.items()))


def dense_morph_smem_bytes(th: int, tw: int, halo: int, first_radius: int, h_first, prefetch: bool) -> int:
    """Shared memory one CTA of K11 takes (``csrc/morph_dense.cu``): rows of
    the tile, ``halo`` rows and ``halo`` rounded up to 16 columns on each
    side and DENSE_SLACK bytes before and after; one or two load buffers, the
    odd steps' buffer (the window after the first step) and the H plane from
    region row ``h_first`` to as far from the bottom (none for None)."""
    hx = -(-halo // 16) * 16
    rh = th + 2 * halo
    h_rows = 0 if h_first is None else rh - 2 * h_first
    return (tw + 2 * hx + 2 * DENSE_SLACK) * (rh * (2 if prefetch else 1) + rh - 2 * first_radius + h_rows)


def _rolls(runs) -> bool:
    """A rect of side 2 to 5, one run [-K/2, (K-1)/2] over the same rows: the
    steps ``roll_step`` runs in registers, without the H plane."""
    if len(runs) != 1:
        return False
    dx0, dx1, dys = runs[0]
    side = dx1 - dx0 + 1
    return 2 <= side <= 5 and dx0 == -(side // 2) and tuple(dys) == tuple(range(dx0, dx1 + 1))


@functools.lru_cache(maxsize=None)
def dense_morph_sizes(steps: tuple) -> tuple:
    """Per step what :func:`dense_morph_schedule` needs: (radius, runs, rows
    of runs, reach): reach is the largest |dy| of a run that takes an H pass
    (one other than [0, 0], in a step that does not roll), -1 for none."""
    sizes = []
    for shape, ksize, _ in steps:
        radius, runs = element_runs(shape, ksize)
        reach = -1 if _rolls(runs) else max(
            (abs(dy) for dx0, dx1, dys in runs if (dx0, dx1) != (0, 0) for dy in dys), default=-1)
        sizes.append((radius, len(runs), sum(len(dys) for *_, dys in runs), reach))
    return tuple(sizes)


@functools.lru_cache(maxsize=None)
def dense_morph_schedule(sizes: tuple) -> tuple:
    """K11's launches for steps of ``sizes`` (:func:`dense_morph_sizes`):
    ((first step, end step, tile rows, tile pixels, summed radius,
    prefetch), ...), one launch each.  Consecutive steps share a launch while
    their summed radius stays within :data:`DENSE_HALO_CAP`, their runs and
    rows fit the kernel's parameter block (:data:`DENSE_MAX_STEPS`,
    :data:`DENSE_MAX_GROUPS`, :data:`DENSE_MAX_DYS`) and a CTA of
    :data:`DENSE_TILE` with two load buffers fits :data:`MAX_SMEM`; a step
    that fits none of these alone starts a launch of its own, with one load
    buffer and on a smaller tile where it must, and raises where nothing fits.
    A launch with no H plane takes :data:`DENSE_ROLL_TILE` where it fits."""
    th, tw = DENSE_TILE
    segments, start = [], 0
    while start < len(sizes):
        stop, halo, groups, dys, h_first = start, 0, 0, 0, None
        r1 = sizes[start][0]
        while stop < len(sizes):
            radius, g, d, reach = sizes[stop]
            h = h_first if h_first is not None or reach < 0 else halo + radius - reach
            if (halo + radius > DENSE_HALO_CAP or stop - start + 1 > DENSE_MAX_STEPS
                    or groups + g > DENSE_MAX_GROUPS or dys + d > DENSE_MAX_DYS
                    or dense_morph_smem_bytes(th, tw, halo + radius, r1, h, True) > MAX_SMEM):
                break
            halo, groups, dys, stop, h_first = halo + radius, groups + g, dys + d, stop + 1, h
        sh, sw, prefetch = th, tw, True
        if stop == start:
            halo, g, d, reach = sizes[start]
            if g > DENSE_MAX_GROUPS or d > DENSE_MAX_DYS:
                raise ValueError(f"morph: a step of {g} runs over {d} rows exceeds the kernel's parameter block")
            h_first = None if reach < 0 else halo - reach
            stop, prefetch = start + 1, dense_morph_smem_bytes(sh, sw, halo, halo, h_first, True) <= MAX_SMEM
            while not prefetch and dense_morph_smem_bytes(sh, sw, halo, halo, h_first, False) > MAX_SMEM:
                if sh > 1:
                    sh = -(-sh // 2)
                elif sw > 16:
                    sw = -(-sw // 32) * 16
                else:
                    raise ValueError(f"morph: a step of radius {halo} does not fit one CTA's shared memory")
        if h_first is None and (sh, sw) == (th, tw) and prefetch and dense_morph_smem_bytes(
                *DENSE_ROLL_TILE, halo, r1, None, True) <= MAX_SMEM:
            sh, sw = DENSE_ROLL_TILE
        segments.append((start, stop, sh, sw, halo, prefetch))
        start = stop
    return tuple(segments)


_dense_tables: dict = {}  # (steps, first, end) -> K11's step table of that segment, host int32


def _dense_table(steps: tuple, start: int, stop: int) -> np.ndarray:
    """K11's step table of steps ``start`` to ``stop`` (``csrc/morph_dense.cu``,
    ``pw_morph_dense_run``): the number of steps, then per step (is a
    dilation, radius, runs) and per run (dx0, dx1, rows, the rows' dy ...);
    host int32, built once per segment."""
    key = (steps, start, stop)
    if key not in _dense_tables:
        words = [stop - start]
        for shape, ksize, op in steps[start:stop]:
            radius, runs = element_runs(shape, ksize)
            words += [int(op == "d"), radius, len(runs)]
            for dx0, dx1, dys in runs:
                words += [dx0, dx1, len(dys), *dys]
        _dense_tables[key] = np.array(words, dtype=np.int32)
    return _dense_tables[key]


def morph_dense_cuda(x: torch.Tensor, steps) -> torch.Tensor:
    """K11: ``ops.morphology.morph_dense_plain``'s step list ((shape, ksize,
    op), ...; op 'd' dilates, any other erodes) on a CUDA (..., H, W) uint8
    tensor, one launch per segment of :func:`dense_morph_schedule` (one at
    the defaults); returns ``x`` itself for an empty list, else a new tensor."""
    _check_dense("morph", x, (torch.uint8,))
    if x.dim() < 2:
        raise ValueError(f"morph: expected (..., H, W), got {tuple(x.shape)}")
    steps = tuple(steps)
    if not steps:
        return x
    sizes = dense_morph_sizes(steps)
    if any(radius > 32767 for radius, *_ in sizes):
        raise ValueError("morph: a ksize exceeds the kernel's range")
    segments = dense_morph_schedule(sizes)
    if x.numel() == 0:
        return x.clone()
    h, w = x.shape[-2:]
    k = x.numel() // (h * w)
    lib = load("morph_dense")
    with _guard(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        bufs = [torch.empty_like(x) for _ in range(min(2, len(segments)))]
        src = x
        for j, (start, stop, sh, sw, halo, prefetch) in enumerate(segments):
            dst = bufs[j % 2]
            table = _dense_table(steps, start, stop)
            aligned = w % 16 == 0 and src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
            err = lib.pw_morph_dense_run(src.data_ptr(), dst.data_ptr(), table.ctypes.data, len(table), k, h, w, sh,
                                         sw, halo, int(prefetch), int(aligned), stream)
            _count("morph_dense")
            _raise_on(lib, "morph", err)
            src = dst
    return src


def greedy_route(n: int, route: str | None = None) -> str:
    """K9's route for a tour of ``n`` points: ``route`` when given (one of
    :data:`GREEDY_ROUTES`), else ``"cta"`` below
    :data:`GREEDY_CLUSTER_MIN_N` points and ``"cluster"`` from there.
    Raises outside 2 to :data:`GREEDY_MAX_N`, and for a one-CTA route that
    does not fit (above :data:`GREEDY_CTA_MAX_N`)."""
    if not 2 <= n <= GREEDY_MAX_N:
        raise ValueError(f"greedy_tour: {n} points is outside 2 to {GREEDY_MAX_N}")
    if route is None:
        return "cta" if n < GREEDY_CLUSTER_MIN_N else "cluster"
    if route not in GREEDY_ROUTES:
        raise ValueError(f"greedy_tour: route {route!r} is none of {GREEDY_ROUTES}")
    if route == "cta" and n > GREEDY_CTA_MAX_N:
        raise ValueError(f"greedy_tour: {n} points do not fit one CTA (at most {GREEDY_CTA_MAX_N})")
    return route


def greedy_order_cuda(starts: torch.Tensor, ends: torch.Tensor, closed: torch.Tensor, closed_aware: bool, seed: int,
                      route: str | None = None):
    """K9: ``vector.planner_device.greedy_order_plain`` in one launch, on the
    route of :func:`greedy_route`.  CUDA (n, 2) float32 starts and ends and
    (n,) bool ``closed`` on one device → (order (n,) int32, flips (n,) bool)
    on it; nothing is read back here."""
    _check_f32("greedy_tour", starts, (2,))
    n = starts.shape[0]
    _check_f32("greedy_tour", ends, (n, 2), starts.device)
    if starts.dim() != 2 or starts.data_ptr() % 8 or ends.data_ptr() % 8:
        raise ValueError(f"greedy_tour: expected 8-byte aligned (n, 2) points, got {tuple(starts.shape)}")
    if not (closed.device == starts.device and closed.dtype == torch.bool and tuple(closed.shape) == (n,)
            and closed.is_contiguous()):
        raise ValueError(f"greedy_tour: expected a contiguous ({n},) bool tensor on {starts.device}")
    route = greedy_route(n, route)
    if not 0 <= seed < n:
        raise ValueError(f"greedy_tour: seed {seed} is outside 0 to {n - 1}")
    lib = load("greedy_tour")
    with _guard(starts.device):
        order = torch.empty(n, dtype=torch.int32, device=starts.device)
        flips = torch.empty(n, dtype=torch.uint8, device=starts.device)
        err = lib.pw_greedy_tour(starts.data_ptr(), ends.data_ptr(), closed.data_ptr(), n, int(closed_aware), int(seed),
                                 1 if route == "cta" else GREEDY_CLUSTER, order.data_ptr(), flips.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        _count("greedy_tour")
        _raise_on(lib, "greedy_tour", err)
    return order, flips.view(torch.bool)


def refine_order_cuda(entries: torch.Tensor, exits: torch.Tensor, start, max_moves: int):
    """K10: ``vector.refine_device.refine_order_plain`` in one cooperative
    launch.  CUDA (n, 2) float32 entries and exits in tour order (3 <= n <=
    :data:`REFINE_MAX_N`), the pen's start (x, y) and a move budget → (perm
    (n,) int32, flip (n,) bool, moves (1,) int32) on the device; nothing is
    read back here."""
    _check_f32("refine_tour", entries, (2,))
    n = entries.shape[0]
    _check_f32("refine_tour", exits, (n, 2), entries.device)
    if entries.dim() != 2 or not REFINE_MIN_N <= n <= REFINE_MAX_N:
        raise ValueError(f"refine_tour: expected {REFINE_MIN_N} to {REFINE_MAX_N} ops, got {tuple(entries.shape)}")
    lib = load("refine_tour")
    dev = entries.device
    with _guard(dev):
        blocks = lib.pw_refine_blocks(n)
        if blocks <= 0:
            _raise_on(lib, "refine_tour", -blocks)
            raise RuntimeError("refine_tour: no block of the kernel fits an SM")
        # the tour lives in the CTAs' shared memory; scratch is the CTAs' partial minima, two slots by parity
        partial = torch.empty(2 * 3 * blocks, dtype=torch.int64, device=dev)
        perm = torch.empty(n, dtype=torch.int32, device=dev)
        flip = torch.empty(n, dtype=torch.uint8, device=dev)
        moves = torch.empty(1, dtype=torch.int32, device=dev)
        err = lib.pw_refine_tour(entries.data_ptr(), exits.data_ptr(), partial.data_ptr(), blocks, n,
                                 float(start[0]), float(start[1]), int(max_moves), perm.data_ptr(), flip.data_ptr(),
                                 moves.data_ptr(), torch.cuda.current_stream().cuda_stream)
        _count("refine_tour")
        _raise_on(lib, "refine_tour", err)
    return perm, flip.view(torch.bool), moves


def _check_image(name: str, img: torch.Tensor) -> tuple:
    """(H, W, C) of a CUDA contiguous (H, W, C) uint8 image, C from 1 to 4."""
    _check_dense(name, img, (torch.uint8,))
    if img.dim() != 3 or not 1 <= img.shape[2] <= 4:
        raise ValueError(f"{name}: expected an (H, W, C) uint8 image with C from 1 to 4, got {tuple(img.shape)}")
    return tuple(img.shape)


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def area_frac_smem(band_rows: int, tile: int, group: int, pitch: int, slots: int, events: int, c: int) -> int:
    """The dynamic shared memory of K13's fractional CTA (``pw_area_frac_smem``
    in csrc/area_resize.cu): two stages of ``group`` source rows at ``pitch``
    bytes, the band's staged output rows (each at its destination's alignment
    to 16 bytes), on the pair route ``events`` source rows of 16 bytes, else a
    ring of ``slots`` rows of float sums a thread and channel, an int4 of each
    band row's taps and stage, four bounds and the two stages' mbarriers."""
    ring = _round16(4 * slots * c * max(32, tile)) if events == 0 else 0
    return 2 * group * pitch + band_rows * _round16(tile * c + 15) + ring + 16 * events + 16 * band_rows + 32


def area_spans(si: np.ndarray, al: np.ndarray) -> tuple:
    """(first, last) real source index of each destination index of a tap
    table (``ops.resize._resize_area_tab``): its taps of alpha > 0, a prefix
    of the row on consecutive indices; (-1, -2) where it has none."""
    n = (al > 0).sum(axis=1)
    first = np.where(n > 0, si[:, 0], -1)
    last = np.where(n > 0, si[np.arange(len(n)), np.maximum(n - 1, 0)], -2)
    return first, last


def _open_rows(first: np.ndarray, last: np.ndarray, ssize: int) -> int:
    """The most output rows that a walk up the source rows holds open at once,
    counted as the span of their indices (a row of no tap inside it too):
    the ring of sums the ring's route needs."""
    rows = np.flatnonzero(first >= 0)
    f, l = first[rows], last[rows]
    sy = np.arange(ssize)
    lo, hi = np.searchsorted(l, sy, "left"), np.searchsorted(f, sy, "right") - 1
    live = hi >= lo
    return int((rows[hi[live]] - rows[lo[live]] + 1).max()) if live.any() else 1


def _band_spans(first: np.ndarray, last: np.ndarray, band_rows: int) -> int:
    """The most source rows a band of ``band_rows`` output rows walks."""
    starts = np.arange(0, len(first), band_rows)
    stops = np.minimum(starts + band_rows, len(first)) - 1
    return int((last[stops] - first[starts] + 1).max())


@functools.lru_cache(maxsize=64)
def area_frac_schedule(h: int, w: int, nh: int, nw: int, c: int, ctas: int = 0) -> dict:
    """K13's fractional launch for an (h, w, c) image to (nh, nw): items of
    ``band_rows`` output rows and ``tile`` output columns (``threads`` =
    max(32, tile) a CTA), ``bands`` x ``tiles`` = ``items``; given ``ctas``,
    the CTAs that the card holds at once, each band takes the rows that make
    the items fit them (one item a CTA, up to :data:`AREA_MAX_BAND_ROWS`),
    else :data:`AREA_BAND_ROWS`; ``group`` source rows staged at once at
    ``pitch`` bytes a row (the widest tile's source span, from its 16-byte
    boundary).  The pair route (``events``: the most source rows a band
    walks, each a 16-byte event in shared memory) where every output row and
    column has a tap and a row shares at most its first source row with the
    row before it (a downscale), so that two rows are open at once at most,
    their sums in registers; else the ring's route (``events`` 0; ``slots`` the most rows
    open at once, a ring of sums in shared memory).  ``kh``, on the pair
    route where no column has more than 4 real taps, the widest column's
    taps (every column's first ``kh`` taps read as words, alpha 0 past its
    own), else 0 (byte by byte); ``smem`` bytes; the
    tables' widths
    ``taps`` (th, tv).  The widest tile and group whose shared memory stays
    within :data:`AREA_SMEM_CAP`, else within :data:`MAX_SMEM`; raises where
    not even one column's span fits."""
    xsi, xal = _resize_area_tab(w, nw)
    ysi, yal = _resize_area_tab(h, nh)
    xf, xl = area_spans(xsi, xal)
    yf, yl = area_spans(ysi, yal)
    open_rows = _open_rows(yf, yl, h)
    pair = bool((yf >= 0).all() and (yl[:-1] <= yf[1:]).all() and open_rows <= 2 and (xf >= 0).all())
    widest = int(np.where(xf >= 0, xl - xf + 1, 0).max())
    top = min(AREA_TILE, 1 << (nw - 1).bit_length())  # no wider than the output
    for cap in (AREA_SMEM_CAP, MAX_SMEM):
        tile = top
        while tile >= 1:
            pad = -nw % tile
            f = np.concatenate([xf, np.full(pad, -1)]).reshape(-1, tile)
            l = np.concatenate([xl, np.full(pad, -2)]).reshape(-1, tile)
            some = (f >= 0).any(axis=1)
            lo = np.where(f >= 0, f, np.iinfo(np.int64).max).min(axis=1)
            span = int((l.max(axis=1) - lo + 1)[some].max()) if some.any() else 0
            pitch = _round16(span * c + 15)
            tiles = -(-nw // tile)
            most = max(1, min(AREA_MAX_BAND_ROWS, 0xFFFF // _round16(tile * c + 15), nh))
            band_rows = min(most, -(-nh // max(1, ctas // tiles)) if ctas else AREA_BAND_ROWS, nh)
            events = _band_spans(yf, yl, band_rows) if pair else 0
            if 16 * events > AREA_EVENTS_CAP:
                events = 0
            slots = max(2, min(open_rows, band_rows)) if events == 0 else 2
            kh = widest if events and widest <= 4 else 0
            group = AREA_GROUP
            while group >= 1:
                smem = area_frac_smem(band_rows, tile, group, pitch, slots, events, c)
                if smem <= cap:
                    bands = -(-nh // band_rows)
                    return {"band_rows": band_rows, "tile": tile, "threads": max(32, tile), "group": group,
                            "pitch": pitch, "slots": slots, "events": events, "kh": kh, "smem": smem,
                            "bands": bands, "tiles": tiles, "items": bands * tiles, "ctas": ctas,
                            "taps": (xsi.shape[1], ysi.shape[1])}
                group //= 2
            tile //= 2
    raise ValueError(f"area_resize_frac: one output column's source span at {w} -> {nw} x {c} channels does not fit "
                     f"the shared memory of a CTA")


# pw_area_resize_frac's schedule arguments, in its order
AREA_FRAC_ARGS = ("band_rows", "tile", "group", "pitch", "slots", "events", "kh", "smem", "ctas")
_area_plans: dict = {}  # (device, h, w, nh, nw, c) → K13's fractional schedule fitted there and its tables there


def _area_frac_plan(lib, device: torch.device, h: int, w: int, nh: int, nw: int, c: int) -> tuple:
    """K13's fractional launch of an (h, w, c) image to (nh, nw) on a card:
    (:func:`area_frac_schedule` with its items fitted to the CTAs of its
    instance that the card holds at once, the tap tables that schedule was
    made from on the card: ``_resize_area_tab(w, nw)`` then ``(h, nh)``).
    The CTAs' count comes from the occupancy of the schedule's own shared
    memory, which the fit changes: refitted until the items fit or the count
    stays the same."""
    key = (device, h, w, nh, nw, c)
    if key not in _area_plans:
        sched, ctas = area_frac_schedule(h, w, nh, nw, c), 0
        for _ in range(4):
            n = lib.pw_area_frac_ctas(c, *(sched[k] for k in AREA_FRAC_ARGS[:7]))
            if n < 1:
                raise RuntimeError(f"area_resize_frac: no CTA of the schedule {sched} fits the card ({n})")
            if n == ctas or sched["items"] <= n and sched["ctas"]:
                break
            ctas = n
            sched = area_frac_schedule(h, w, nh, nw, c, ctas)
        tables = tuple(torch.from_numpy(a).to(device) for a in _resize_area_tab(w, nw) + _resize_area_tab(h, nh))
        _area_plans[key] = dict(sched, ctas=n), tables
    return _area_plans[key]


def _area_frac_launch(lib, img: torch.Tensor, out: torch.Tensor, plan: tuple) -> int:
    """One ``pw_area_resize_frac`` of ``lib`` (the wrapper's library or a
    measurement build of it) from ``img`` into ``out`` on ``plan``
    (:func:`_area_frac_plan`) → its CUDA error code."""
    sched, (xsi, xal, ysi, yal) = plan
    return lib.pw_area_resize_frac(img.data_ptr(), out.data_ptr(), xsi.data_ptr(), xal.data_ptr(), xsi.shape[1],
                                   ysi.data_ptr(), yal.data_ptr(), ysi.shape[1], *img.shape, *out.shape[:2],
                                   *(sched[k] for k in AREA_FRAC_ARGS), torch.cuda.current_stream().cuda_stream)


def area_resize_frac_cuda(img: torch.Tensor, new_w: int, new_h: int) -> torch.Tensor:
    """K13, fractional ratios: ``ops.resize.area_resize_frac_plain`` of a
    CUDA (H, W, C) uint8 image → (new_h, new_w, C) uint8, in one launch on
    the tap tables of its width and height and :func:`area_frac_schedule`
    made from them, fitted to the card (:func:`_area_frac_plan`)."""
    h_in, w_in, c = _check_image("area_resize_frac", img)
    if not (new_w >= 1 and new_h >= 1):
        raise ValueError(f"area_resize_frac: expected an output of at least 1 x 1, got {new_w} x {new_h}")
    lib = load("area_resize")
    with _guard(img.device):
        plan = _area_frac_plan(lib, img.device, h_in, w_in, new_h, new_w, c)
        out = torch.empty((new_h, new_w, c), dtype=torch.uint8, device=img.device)
        err = _area_frac_launch(lib, img, out, plan)
        _count("area_resize_frac")
        _raise_on(lib, "area_resize_frac", err)
    return out


def area_resize_int_cuda(img: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    """K13, integer ratios: ``ops.resize.area_resize_int_plain`` of a CUDA
    (H, W, C) uint8 image whose sides ``sy`` and ``sx`` divide → (H/sy, W/sx,
    C) uint8."""
    h_in, w_in, c = _check_image("area_resize_int", img)
    if sy < 1 or sx < 1 or h_in % sy or w_in % sx or sy * sx * 255 >= 2**31:
        raise ValueError(f"area_resize_int: a {sy} x {sx} box does not tile {h_in} x {w_in}")
    nh, nw = h_in // sy, w_in // sx
    lib = load("area_resize")
    with _guard(img.device):
        out = torch.empty((nh, nw, c), dtype=torch.uint8, device=img.device)
        err = lib.pw_area_resize_int(img.data_ptr(), out.data_ptr(), w_in, c, sy, sx, nh, nw,
                                     torch.cuda.current_stream().cuda_stream)
        _count("area_resize_int")
        _raise_on(lib, "area_resize_int", err)
    return out


def bezier_sample_cuda(ctrl: torch.Tensor, n: int) -> torch.Tensor:
    """K14 on one family, a table of one: ``ops.bezier.sample_bezier_plain``
    of CUDA (S, K, 2) float32 control points (K = 4 cubics, 3 quadratics) at
    ``n`` parameters → (S, n, 2) float32, one launch."""
    _check_f32("bezier_sample", ctrl, (2,))
    if ctrl.dim() != 3 or ctrl.shape[1] not in (3, 4) or n < 1 or ctrl.shape[0] * n >= 2**31:
        raise ValueError(f"bezier_sample: expected (S, 3 or 4, 2) control points and n >= 1, got "
                         f"{tuple(ctrl.shape)}, {n}")
    s, k = ctrl.shape[:2]
    lib = load("bezier_sample")
    with _guard(ctrl.device):
        out = torch.empty((s, n, 2), dtype=torch.float32, device=ctrl.device)
        err = lib.pw_bezier_sample(ctrl.data_ptr(), out.data_ptr(), s, k, n, torch.cuda.current_stream().cuda_stream)
        _count("bezier_sample")
        _raise_on(lib, "bezier_sample", err)
    return out


def bezier_families_cuda(words: torch.Tensor, n_fam: int, n_points: int) -> torch.Tensor:
    """K14 on a document: ``ops.bezier.sample_families_plain`` of the CUDA
    int32 buffer ``words`` that ``ops.bezier.pack_families`` made for
    ``n_fam`` non-empty families of ``n_points`` points in all → (n_points,
    2) float32, every family's points back to back, one launch."""
    if not words.is_cuda or words.dtype != torch.int32 or not words.is_contiguous() or words.dim() != 1:
        raise ValueError(f"bezier_families: expected a contiguous CUDA int32 buffer, got {words.dtype} "
                         f"{tuple(words.shape)} on {words.device}")
    table_off, first_off = bezier_layout(words.numel(), n_fam, n_points)
    lib = load("bezier_sample")
    with _guard(words.device):
        out = torch.empty((n_points, 2), dtype=torch.float32, device=words.device)
        if n_points:
            err = lib.pw_bezier_families(words.data_ptr(), table_off, first_off, n_fam, n_points, out.data_ptr(),
                                         torch.cuda.current_stream().cuda_stream)
            _count("bezier_sample")
            _raise_on(lib, "bezier_sample", err)
    return out


def bezier_layout(n_words: int, n_fam: int, n_points: int) -> tuple:
    """(word of the family table, word of the CTAs' first families) in a
    K14 buffer of ``n_words`` words for ``n_fam`` families and ``n_points``
    points: the control points, padded to 4 words, then ``n_fam`` entries of
    4 words, then ⌈n_points / BEZIER_THREADS⌉ + 1 start words, at the end."""
    if not 0 <= n_points < 2**31 or n_fam < 0 or (n_points and not n_fam):
        raise ValueError(f"bezier_families: expected fewer than 2^31 points in non-empty families, got "
                         f"{n_points} in {n_fam}")
    first_off = n_words - (-(-n_points // BEZIER_THREADS) + 1)
    table_off = first_off - 4 * n_fam
    if table_off < 0 or table_off % 4:
        raise ValueError(f"bezier_families: {n_words} words do not hold {n_fam} families and {n_points} points")
    return table_off, first_off
