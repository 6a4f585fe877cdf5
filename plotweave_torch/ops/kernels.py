"""Hand-written CUDA kernels: build, binding and wrappers.

- K2 ``morph_steps_cuda`` (``csrc/morph_bits.cu``): a whole sequence of
  packed dilations and erosions in one launch, each block holding a band of
  rows and the sequence's halo in shared memory; replaces the XLA fusion of
  ``morph_bits`` and chains of its calls.  :func:`morph_schedule` splits a
  sequence whose halo does not fit into segments, one launch each, before
  any launch (the defaults are one segment).
- K5 ``hysteresis_cuda`` and K6 ``zhang_suen_packed_cuda``
  (``csrc/bitboard_fixpoints.cu``): the bitboard fixpoints; K6 replaces
  ``zhang_suen_packed_pallas``.  Each has two routes, chosen by size before
  any launch unless the caller names one: a layer that fits in one thread
  block cluster's shared memory runs the whole fixpoint resident there, one
  launch per call (launch names ``zhang_suen_packed``, ``hysteresis``); a
  larger layer runs the multi-launch kernels, one launch per subpass or
  sweep and one host check per chunk (``zhang_suen_packed_multi``,
  ``hysteresis_multi``).
- K7 ``assign_nearest_cuda`` (``csrc/assign_nearest.cu``): Lab and the
  nearest centre in one pass; replaces the XLA fusion of ``assign_nearest``.
- K12 ``zhang_suen_dense_cuda`` (``csrc/zs_dense.cu``): dense Zhang–Suen,
  packed to 32 pixels a word on load and bit-sliced in shared memory, up to
  :data:`ZS_CHUNK` iterations per launch on tiles with a halo of two rows
  per iteration; replaces ``zhang_suen_pallas``.

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
The plain versions live beside their callers (``ops/morphology.py``, ``ops/canny.py``,
``ops/thinning.py``, ``ops/frontend.py``); nothing here falls back to them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from .morphology import structuring_element
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
    "bitboard_fixpoints": _SM90A,  # K5, K6
    "morph_bits": _SM90A,  # K2
    "assign_nearest": _SM90A + ["--fmad=false"],  # K7
    "zs_dense": _SM90A,  # K12
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

# the resident routes: CTAs per thread block cluster (``kCluster`` in
# csrc/bitboard_fixpoints.cu), and the shared memory one CTA may take (227 KB
# on Hopper)
CLUSTER_SIZE = 16
MAX_SMEM = 232448
ROUTES = ("resident", "multi")

# kernel launches per wrapper and route, counted where each wrapper calls into its library
LAUNCHES = {"zhang_suen_packed": 0, "zhang_suen_packed_multi": 0, "hysteresis": 0,
            "hysteresis_multi": 0, "morph_bits": 0, "assign_nearest": 0, "zhang_suen_dense": 0}

# what the last call of each fixpoint route took: for the resident routes a
# device tensor, K6 (k,) iterations per layer, K5 (k, 2) rounds and the most
# sweeps one CTA ran per layer; for the multi-launch routes and K12 the
# iterations or sweeps launched.  Only read by ``chip_smoke.py``.
STATS: dict = {}

build_log: dict = {}  # library → nvcc's output (ptxas register and spill report) of its last build

_libs: dict = {}
_lock = threading.Lock()  # guards the library loads and the launch counts


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


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


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_SIGNATURES = {
    "bitboard_fixpoints": {"pw_zs_cluster_run": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
                           "pw_hysteresis_cluster_run": [_P, _P, _P, _P, _I, _I, _I, _P],
                           "pw_zs_packed_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                           "pw_hysteresis_run": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]},
    "morph_bits": {"pw_morph_steps_run": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
    "assign_nearest": {"pw_assign_nearest": [_P, _P, _P, _I, _L, _P]},
    "zs_dense": {"pw_zs_tiles_run": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
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


def resident_smem_bytes(kernel: str, h: int, nw: int) -> int:
    """Shared memory one CTA of the resident route takes for a layer of
    ``h`` rows of ``nw`` words (``csrc/bitboard_fixpoints.cu``'s layout):
    rows of ``nw + 2`` words, ``ceil(h / CLUSTER_SIZE)`` of each board, K6
    two boards and a zero row, K5 two boards, four published rows and a zero
    row; two int flags."""
    rpc = -(-h // CLUSTER_SIZE)
    rows = 2 * rpc + (1 if kernel == "zhang_suen_packed" else 5)
    return rows * (nw + 2) * 4 + 8


def resident(kernel: str, h: int, nw: int) -> bool:
    """Whether a layer fits the resident route."""
    return resident_smem_bytes(kernel, h, nw) <= MAX_SMEM


def fixpoint_route(kernel: str, h: int, nw: int, route: str | None = None) -> str:
    """The route of K5 or K6 for a layer: ``route`` when given (one of
    :data:`ROUTES`), else ``"resident"`` where the layer fits, else
    ``"multi"``.  Raises for a resident route that does not fit."""
    if route is None:
        return "resident" if resident(kernel, h, nw) else "multi"
    if route not in ROUTES:
        raise ValueError(f"{kernel}: route {route!r} is none of {ROUTES}")
    if route == "resident" and not resident(kernel, h, nw):
        raise ValueError(f"{kernel}: a layer of {h} rows of {nw} words does not fit one cluster")
    return route


def _check_grid(name: str, k: int, h: int) -> None:
    if k > 65535 or h > 65535:
        raise ValueError(f"{name}: {k} layers of {h} rows exceed the multi-launch kernels' grid")


def zhang_suen_packed_cuda(packed: torch.Tensor, max_iter: int = 120, rotated: bool = True,
                           route: str | None = None) -> torch.Tensor:
    """K6: the Zhang–Suen fixpoint of ``ops.thinning.zhang_suen_packed`` on
    CUDA bitboards, by :func:`fixpoint_route`; returns a new board."""
    k, h, nw = _check("zhang_suen_packed", packed)
    route = fixpoint_route("zhang_suen_packed", h, nw, route)
    if max_iter <= 0 or packed.numel() == 0:
        return packed.clone()
    lib = load("bitboard_fixpoints")
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        out = torch.empty_like(packed)
        if route == "resident":
            iters = torch.empty(k, dtype=torch.int32, device=packed.device)
            err = lib.pw_zs_cluster_run(packed.data_ptr(), out.data_ptr(), iters.data_ptr(), k, h, nw,
                                        max_iter, int(rotated), stream)
            _count("zhang_suen_packed")
            _raise_on(lib, "zhang_suen_packed", err)
            STATS["zhang_suen_packed"] = iters
            return out
        _check_grid("zhang_suen_packed", k, h)
        b = torch.empty_like(packed)
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


def hysteresis_cuda(cand: torch.Tensor, strong: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """K5: the hysteresis fixpoint of ``ops.canny.hysteresis`` on CUDA
    bitboards, by :func:`fixpoint_route`; returns a new board."""
    k, h, nw = _check("hysteresis", cand, strong)
    route = fixpoint_route("hysteresis", h, nw, route)
    if cand.numel() == 0:
        return cand.clone()
    lib = load("bitboard_fixpoints")
    with torch.cuda.device(cand.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "resident":
            out = torch.empty_like(cand)
            stats = torch.zeros((k, 2), dtype=torch.int32, device=cand.device)
            err = lib.pw_hysteresis_cluster_run(cand.data_ptr(), strong.data_ptr(), out.data_ptr(),
                                                stats.data_ptr(), k, h, nw, stream)
            _count("hysteresis")
            _raise_on(lib, "hysteresis", err)
            STATS["hysteresis"] = stats
            return out
        _check_grid("hysteresis", k, h)
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


def morph_steps_cuda(x: torch.Tensor, valid: torch.Tensor, steps) -> torch.Tensor:
    """K2: ``ops.morphology.morph_steps_plain``'s step list on CUDA
    bitboards, one launch per segment of :func:`morph_schedule` (one at the
    defaults); returns ``x`` itself for an empty list, else a new board."""
    k, h, nw = _check("morph_bits", x)
    if not (valid.is_cuda and valid.device == x.device and valid.dtype == torch.int32
            and valid.is_contiguous() and tuple(valid.shape) == (nw,)):
        raise ValueError(f"morph_bits: valid must be a contiguous ({nw},) int32 tensor on {x.device}")
    steps = tuple(steps)
    if not steps:
        return x
    table, radii = _step_table(steps, x.device)
    if x.numel() == 0:
        return x.clone()
    if k > 65535:
        raise ValueError(f"morph_bits: {k} layers exceed the kernel's grid")
    segments = morph_schedule(radii, h, nw)
    lib = load("morph_bits")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        bufs = [torch.empty_like(x) for _ in range(min(2, len(segments)))]
        src = x
        for j, (start, stop, band, radius) in enumerate(segments):
            dst = bufs[j % 2]
            err = lib.pw_morph_steps_run(src.data_ptr(), dst.data_ptr(), valid.data_ptr(), table.data_ptr(), start,
                                         stop - start, radius, band, k, h, nw, stream)
            _count("morph_bits")
            _raise_on(lib, "morph_bits", err)
            src = dst
    return src


def assign_nearest_cuda(image: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """K7: ``ops.frontend.assign_nearest`` of a CUDA (..., H, W, 3) uint8
    image and (k, 3) float32 centres on its device → (..., H, W) int32."""
    if not image.is_cuda:
        raise ValueError(f"assign_nearest: expected a CUDA tensor, got {image.device}")
    if image.dtype != torch.uint8 or image.dim() < 1 or image.shape[-1] != 3 or not image.is_contiguous():
        raise ValueError(f"assign_nearest: expected a contiguous (..., 3) uint8 image, got "
                         f"{image.dtype} {tuple(image.shape)}")
    if not (centers.device == image.device and centers.dtype == torch.float32 and centers.dim() == 2
            and centers.shape[1] == 3 and centers.is_contiguous()):
        raise ValueError(f"assign_nearest: expected contiguous (k, 3) float32 centers on {image.device}")
    lib = load("assign_nearest")
    with torch.cuda.device(image.device):
        labels = torch.empty(image.shape[:-1], dtype=torch.int32, device=image.device)
        err = lib.pw_assign_nearest(image.data_ptr(), centers.data_ptr(), labels.data_ptr(),
                                    centers.shape[0], labels.numel(), torch.cuda.current_stream().cuda_stream)
        _count("assign_nearest")
        _raise_on(lib, "assign_nearest", err)
    return labels


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
    with torch.cuda.device(binary.device):
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
