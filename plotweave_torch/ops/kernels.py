"""Hand-written CUDA kernels K5 and K6: build, binding and wrappers.

Port of ``plotweave/ops/pallas_kernels.py``.  The sources are
``plotweave_torch/csrc/bitboard_fixpoints.cu`` (design and bound are noted
there); they are compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, at first use, under ``plotweave_torch/_build/``
keyed on a hash of the sources and flags, and loaded with ctypes.  Importing
this module compiles and loads nothing, so it imports where there is no
``nvcc`` and no card.

Each wrapper takes CUDA ``int32`` bitboards (the bits of the JAX package's
``uint32`` boards), launches on ``torch.cuda.current_stream()``, raises on any
launch error, and counts its launches in :data:`LAUNCHES` (one per call into
the library).  The plain versions live beside their callers
(``ops/thinning.py``, ``ops/canny.py``); nothing here falls back to them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "bitboard_fixpoints.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# iterations per host check of the convergence flags
ZS_CHUNK = 8
HYSTERESIS_CHUNK = 32  # even: the sweeps ping-pong between two buffers

# launches per wrapper, counted where each wrapper calls into the library
LAUNCHES = {"zhang_suen_packed": 0, "hysteresis": 0}

build_log = ""  # nvcc's output (ptxas register and spill report) of the last build

_lib = None
_lock = threading.Lock()  # guards the library load and the launch counts


def reset_launches() -> None:
    with _lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
    return path


def build() -> Path:
    """Compile the kernels unless a library for these sources exists; return its path."""
    global build_log
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"bitboard_fixpoints-{key}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, out)
    return out


def load():
    """The bound library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.pw_zs_packed_run.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.pw_zs_packed_run.restype = i
            lib.pw_hysteresis_run.argtypes = [p, p, p, p, i, i, i, i, p]
            lib.pw_hysteresis_run.restype = i
            lib.pw_error_string.argtypes = [i]
            lib.pw_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


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


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({load().pw_error_string(err).decode()})")


def zhang_suen_packed_cuda(packed: torch.Tensor, max_iter: int = 120, rotated: bool = True) -> torch.Tensor:
    """K6: the Zhang–Suen fixpoint of ``ops.thinning.zhang_suen_packed`` on
    CUDA bitboards; returns a new board."""
    k, h, nw = _check("zhang_suen_packed", packed)
    lib = load()
    with torch.cuda.device(packed.device):
        a = packed.clone()
        b = torch.empty_like(a)
        stream = torch.cuda.current_stream().cuda_stream
        done = 0
        while done < max_iter:
            n = min(ZS_CHUNK, max_iter - done)
            flags = torch.zeros(n, dtype=torch.int32, device=a.device)
            err = lib.pw_zs_packed_run(a.data_ptr(), b.data_ptr(), flags.data_ptr(),
                                       k, h, nw, n, int(rotated), stream)
            with _lock:
                LAUNCHES["zhang_suen_packed"] += 1
            _raise_on("zhang_suen_packed", err)
            done += n
            if not int(flags[-1].item()):
                break
    return a


def hysteresis_cuda(cand: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """K5: the hysteresis fixpoint of ``ops.canny.hysteresis`` on CUDA
    bitboards; returns a new board."""
    k, h, nw = _check("hysteresis", cand, strong)
    lib = load()
    with torch.cuda.device(cand.device):
        e0 = strong.clone()
        e1 = torch.empty_like(e0)
        stream = torch.cuda.current_stream().cuda_stream
        # every sweep but the last adds a bit of cand, so this bounds the loop
        for _ in range(0, 32 * cand.numel() + HYSTERESIS_CHUNK, HYSTERESIS_CHUNK):
            flags = torch.zeros(HYSTERESIS_CHUNK, dtype=torch.int32, device=e0.device)
            err = lib.pw_hysteresis_run(cand.data_ptr(), e0.data_ptr(), e1.data_ptr(),
                                        flags.data_ptr(), k, h, nw, HYSTERESIS_CHUNK, stream)
            with _lock:
                LAUNCHES["hysteresis"] += 1
            _raise_on("hysteresis", err)
            if not int(flags[-1].item()):
                return e0
    raise RuntimeError("hysteresis: no fixpoint within the sweeps cand allows")
