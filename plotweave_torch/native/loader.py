"""Build + load the native library via ctypes.

Copy of ``plotweave/native/loader.py``; the port imports nothing of
``plotweave``.  One change: the library is built into
``plotweave_torch/_build/`` under a name keyed on a hash of the source and
the compiler flags (not on mtime), and each process compiles to a temporary
name of its own and then renames it into place with ``os.replace``.  So
processes that build at the same moment (test workers, say) each end with a
whole library; the one that renames last wins, and every file it replaces
is byte-for-byte the same build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

_SRC = Path(__file__).resolve().parent / "encoder.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
# -ffp-contract=off: the encoder/greedy float math must match numpy
# bit-for-bit; FMA contraction (default at -O3 on FMA-baseline targets)
# would change last-ulp results and flip near-tie selections.
# -march=native widens the auto-vectorized elementwise loops (the library
# always builds on the machine that runs it); it cannot change float
# results: contraction stays off, and GCC never vectorizes FP reductions
# without -fassociative-math, so sequential accumulation orders are
# preserved.  The build falls back to the baseline ISA if the compiler
# rejects the flag.
FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library is built: keyed on a hash of the source and flags."""
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libplotweave-{key}.so"


class PwProfile(ctypes.Structure):
    _fields_ = [
        ("div_start", ctypes.c_int32),
        ("div_fast", ctypes.c_int32),
        ("profile_scurve", ctypes.c_int32),
        ("corner_deg", ctypes.c_double),
        ("corner_div", ctypes.c_int32),
        ("corner_window_steps", ctypes.c_int32),
        ("short_len_steps", ctypes.c_int32),
        ("short_div", ctypes.c_int32),
        ("travel_div_fast", ctypes.c_int32),
        ("travel_start_div", ctypes.c_int32),
        ("travel_window_steps", ctypes.c_int32),
        ("travel_quant_step", ctypes.c_int32),
    ]


def _build() -> bool:
    lib = library_path()
    if lib.exists():
        return True
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        cmd = ["g++", *FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        except subprocess.CalledProcessError:
            cmd.remove("-march=native")
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        os.replace(tmp, lib)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        print(f"[plotweave_torch.native] build failed, using Python fallback: {e}", file=sys.stderr)
        return False


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.pw_writer_new.restype = ctypes.c_void_p
    lib.pw_writer_free.argtypes = [ctypes.c_void_p]
    for f in ("pw_pen_up", "pw_pen_down", "pw_tap"):
        getattr(lib, f).argtypes = [ctypes.c_void_p]
    lib.pw_color.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pw_set_speed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.pw_size.argtypes = [ctypes.c_void_p]
    lib.pw_size.restype = ctypes.c_int64
    lib.pw_finalize.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.pw_finalize.restype = ctypes.c_int64
    lib.pw_polyline.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(PwProfile),
    ]
    lib.pw_travel.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(PwProfile),
    ]
    lib.pw_trace.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pw_trace.restype = ctypes.c_int64
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        if os.environ.get("PLOTWEAVE_NO_NATIVE"):
            return None
        if _build():
            try:
                _lib = _bind(ctypes.CDLL(str(library_path())))
            except OSError as e:
                print(f"[plotweave_torch.native] load failed: {e}", file=sys.stderr)
    return _lib


def available() -> bool:
    return get_lib() is not None


def bind_virtual_draw(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_vd_bound"):
        return
    lib.pw_virtual_draw.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pw_virtual_draw.restype = ctypes.c_int64
    lib.pw_resample_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_resample_batch.restype = ctypes.c_int64
    lib.pw_virtual_draw_batch.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_virtual_draw_batch.restype = ctypes.c_int64
    lib._pw_vd_bound = True


def bind_cv_kmeans(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_km_bound"):
        return
    lib.pw_cv_kmeans.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pw_cv_kmeans.restype = ctypes.c_double
    lib.pw_km_assign.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib._pw_km_bound = True


def bind_skeleton_ops(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_skel_bound"):
        return
    lib.pw_thin.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.pw_thin.restype = ctypes.c_int
    lib.pw_comp_path.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pw_comp_path.restype = ctypes.c_int64
    lib.pw_comp_paths_all.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_comp_paths_all.restype = ctypes.c_int64
    lib.pw_degree.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pw_arc_batch.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.pw_arc_batch_ptrs.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.pw_scale_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.c_float,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pw_greedy_order.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.pw_gcode_tokens.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.pw_gcode_tokens.restype = ctypes.c_int64
    lib.pw_gcode_text.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.pw_gcode_text.restype = ctypes.c_int64
    lib.pw_order_l1.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib._pw_skel_bound = True


def bind_find_period(lib: ctypes.CDLL) -> None:
    if hasattr(lib, "_pw_period_bound"):
        return
    lib.pw_find_period.argtypes = [
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pw_find_period.restype = ctypes.c_int
    lib._pw_period_bound = True
