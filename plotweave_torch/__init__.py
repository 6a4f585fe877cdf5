"""plotweave_torch — the PyTorch / CUDA port of plotweave for NVIDIA Hopper.

The JAX package ``plotweave`` stays the reference.  This package mirrors its
module names (``plotweave_torch/ops/thinning.py`` ↔ ``plotweave/ops/thinning.py``)
and stands alone: it imports neither jax nor anything of ``plotweave``, and
carries its own copies of the host code it needs (``config``, ``utils/io``,
the native C++ library in ``native/``, ``stream``, ``vector``, ``viz`` and
the host stages).

It runs the main path, image → ``plot_stream.bin``, in every mode of stage 02
(row sharding too), for one image or a directory of them, and
the vector entry point, SVG or G-code → stream:

- ``ops``      — the stage 02→04 raster chain, the fused raster front-end
  (``ops/frontend.py``), the device k-means (``ops/kmeans.py``) and the gray
  morphology as plain tensor functions, with hand-written CUDA kernels
  (``ops/kernels.py``, ``csrc/``) for the layout conversions, the packed and
  the gray morphology, the blur and Canny, the two bit-packed fixpoints
  (Canny hysteresis, Zhang–Suen thinning), the fused Lab + nearest-centre
  assign with its counts, the k-means sampler, seeding and fit, the
  dense, bit-sliced Zhang–Suen, the INTER_AREA resize (``ops/resize.py``)
  and the Bézier sampler (``ops/bezier.py``).
- ``stages``   — all 14 stages: 01–04 the port's own, 05–14 copies of the
  JAX package's host stages.
- ``parallel`` — meshes: the batch runner's grouping of concurrent images'
  chain calls, the ``data`` axis, and row sharding over a ``space`` axis.
- ``pipeline`` — the in-process runner, the batch runner and the CLI
  (``python -m plotweave_torch``).
- ``frontends``— the SVG and G-code inputs (``python -m
  plotweave_torch.frontends.svg2stream``), their curve sampling on the card
  with ``--sampling-backend torch`` (``ops/bezier.py``).
- ``demo``     — procedural demo streams.
- ``tools``    — the colour analysis and layer-splitting tools.
- ``entry``    — the front-end's entry point, ``entry(device) → (fn, args)``,
  and the meshes' dry run, ``dryrun_multichip``.
"""

__version__ = "0.1.0"

# The JAX package's heap retention (``plotweave/__init__.py``), copied with its
# opt-out: the port's host stages allocate the same large numpy temporaries.
import os as _os  # noqa: E402


def _retain_heap() -> None:
    """Keep freed large buffers in the process heap (glibc mallopt).

    By default glibc serves multi-MB numpy temporaries via mmap and munmaps
    them on free, so every stage's big temporary re-pays fresh page faults.
    On this class of host that cost is pathological and EPISODIC: measured
    55 ms/MB during bad phases (a 240 MB first-touch took 13 s) vs ~0.3 ms/MB
    warm — reusing warm heap pages is 100×+ cheaper than re-faulting.  Raising
    the mmap/trim thresholds makes the heap grow to the pipeline's peak
    working set once and stay there (hundreds of MB against 128 GB RAM).
    Opt out with PLOTWEAVE_NO_MALLOC_TUNE=1.
    """
    if _os.environ.get("PLOTWEAVE_NO_MALLOC_TUNE"):
        return
    try:
        import ctypes as _ctypes

        libc = _ctypes.CDLL(None)
        GB = 1 << 30
        libc.mallopt(-3, GB)  # M_MMAP_THRESHOLD: heap-serve allocations < 1 GB
        libc.mallopt(-1, GB)  # M_TRIM_THRESHOLD: never return freed heap < 1 GB
    except (OSError, AttributeError):  # pragma: no cover — non-glibc hosts
        pass


_retain_heap()
