"""The fused front-end's entry point and the meshes' dry run (twin of
``__graft_entry__.py``).

``entry(device)`` returns ``(fn, example_args)``: ``fn(image, centers)`` is
:func:`plotweave_torch.ops.frontend.raster_frontend` with k=4, and the
arguments are the JAX entry's seeded 512×512 BGR image and its example
centres, as tensors on ``device``.  ``"auto"`` is the CUDA card or raises;
``"cpu"`` runs the plain versions.

:func:`dryrun_multichip` certifies the meshes over ``n`` devices byte for
byte against the unsharded programs: ``grid_frontend`` over data × space,
``sharded_chain``, the chain at three adversarial shapes and the batch
runner.  ``python -m plotweave_torch.entry [auto|cpu]`` runs ``entry()``,
then the dry run over the devices it finds: every card once, or with
``cpu`` the CPU pool (``XLA_FLAGS``'s count, at least 2).
"""

from __future__ import annotations

import json
import shutil
import tempfile
from pathlib import Path

import numpy as np
import torch

from .ops.frontend import raster_frontend
from .utils.devices import device_for


def _example_centers(k: int = 4) -> np.ndarray:
    """Dark→light Lab centres in the pipeline's 8-bit scaling (copied from
    ``__graft_entry__.py``, whose package imports jax)."""
    return np.array(
        [[40, 128, 128], [110, 140, 120], [180, 150, 140], [240, 128, 126]],
        dtype=np.float32,
    )[:k]


def entry(device: str = "auto"):
    """(fn, example_args): one image → per-layer edges + skeletons on ``device``."""
    dev = device_for(device)

    def forward(image, centers):
        return raster_frontend(image, centers, k=4)

    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (512, 512, 3)).astype(np.uint8)
    return forward, (torch.from_numpy(image).to(dev), torch.from_numpy(_example_centers()).to(dev))


def _dryrun_devices(n_devices: int, devices) -> list:
    """The dry run's devices: a list as given, ``"cpu"`` the host ``n``
    times, else (None, ``"cuda"``) every card once."""
    if devices == "cpu":
        return [torch.device("cpu")] * n_devices
    if devices is None or devices == "cuda":
        from .parallel.mesh import default_devices  # noqa: PLC0415

        devices = default_devices("cuda")
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise ValueError(f"dryrun_multichip: {n_devices} devices wanted, {len(devices)} given")
    return devices[:n_devices]


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run the sharded programs once over ``n_devices`` mesh devices and hold
    each byte for byte against its unsharded counterpart (twin of
    ``__graft_entry__.py::dryrun_multichip``): ``grid_frontend`` over data ×
    space (data 2 where ``n_devices`` is even and at least 4) on (B, 16 ·
    space, 64, 3) seeded images against one ``raster_frontend`` call,
    ``sharded_chain`` over ``fit_shard_rows`` shards against
    ``chain_from_clean``, the chain at three adversarial shapes
    (:func:`_dryrun_adversarial_shapes`) and the batch runner
    (:func:`_dryrun_batch_runner`).  ``devices``: a list (it may name one
    card several times), ``"cpu"``, or None for every card once.  Raises on
    the first difference."""
    from .parallel.mesh import make_mesh  # noqa: PLC0415
    from .parallel.spatial import fit_shard_rows, grid_frontend, sharded_chain  # noqa: PLC0415
    from .stages.s02_color_extract import chain_from_clean  # noqa: PLC0415

    devs = _dryrun_devices(n_devices, devices)
    data = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    space = n_devices // data
    mesh = make_mesh((data, space), ("data", "space"), devices=devs)
    rng = np.random.default_rng(0)
    b, h = data * 2, space * 16
    images = rng.integers(0, 256, (b, h, 64, 3)).astype(np.uint8)
    edges, skels = grid_frontend(mesh, images, _example_centers(), k=4)
    if tuple(edges.shape) != (b, 4, h, 64) or tuple(skels.shape) != (b, 4, h, 64):
        raise AssertionError(f"grid_frontend: shapes {tuple(edges.shape)}, {tuple(skels.shape)}")
    e1, s1 = raster_frontend(torch.from_numpy(images).to(devs[0]), _example_centers(), k=4)
    if not (torch.equal(edges.cpu(), e1.cpu()) and torch.equal(skels.cpu(), s1.cpu())):
        raise AssertionError("grid_frontend diverged from the unsharded raster_frontend")
    print(f"[dryrun] mesh data={data} × space={space}: batch {b} images of {h}x64 → edges "
          f"{tuple(edges.shape)}, skeletons {tuple(skels.shape)} byte-equal ok")

    k, h, w = 4, max(16, n_devices) * 8, 48
    ns = fit_shard_rows(h, n_devices, n_devices)
    labels = rng.integers(0, k, (h, w))
    packed = np.stack([np.packbits(labels == i, axis=-1) for i in range(k)])
    blob = sharded_chain(make_mesh((ns,), ("space",), devices=devs[:ns]), packed, w, 3, 1, 1, 7, 22, 70)
    if tuple(blob.shape) != (2 * k * h * -(-w // 8),):
        raise AssertionError(f"sharded_chain: blob {tuple(blob.shape)}")
    if not torch.equal(blob.cpu(), chain_from_clean(packed, w, 3, 1, 1, 7, 22, 70, device=devs[0]).cpu()):
        raise AssertionError("sharded_chain diverged from chain_from_clean")
    print(f"[dryrun] sharded 02-04 chain over space={ns}: ({k},{h},{w}) → blob {tuple(blob.shape)} byte-equal ok")

    n_shapes = _dryrun_adversarial_shapes(devs, n_devices)
    n_batch = _dryrun_batch_runner(devs, n_devices)
    print(f"[dryrun] ALL OK: grid-2d=eq chain=eq shapes={n_shapes}/3 batch={n_batch}/3 (all byte-certified vs "
          "unsharded/sequential)")


def _dryrun_adversarial_shapes(devs: list, n_devices: int) -> int:
    """The sharded chain byte-equal to ``chain_from_clean`` at 64 rows over 8
    shards (the ``MIN_ROWS_PER_SHARD`` floor), 61 rows (prime: one shard) and
    a 2 × 2160 × 3840 plane (twin of ``_dryrun_adversarial_shapes``)."""
    from .parallel.mesh import make_mesh  # noqa: PLC0415
    from .parallel.spatial import fit_shard_rows, sharded_chain  # noqa: PLC0415
    from .stages.s02_color_extract import chain_from_clean  # noqa: PLC0415

    cases = [("rows≈halo-floor", 4, 64, 48), ("poor-divisor", 4, 61, 48), ("4k-class", 2, 2160, 3840)]
    params = (3, 1, 1, 7, 22, 70)  # mk, oi, ci, bk, lo, hi
    for label, k, h, w in cases:
        yy, xx = np.mgrid[0:h, 0:w]
        labels = ((yy // 16 + xx // 16) + (yy * xx) % 3) % k  # structured + speckle
        packed = np.ascontiguousarray(np.stack([np.packbits(labels == i, axis=-1) for i in range(k)]))
        ns = fit_shard_rows(h, n_devices, n_devices, max_radius=3)
        if label == "poor-divisor" and ns != 1:
            raise AssertionError(f"a prime row count must fall back to 1 shard, got {ns}")
        blob_s = sharded_chain(make_mesh((ns,), ("space",), devices=devs[:ns]), packed, w, *params)
        blob_1 = chain_from_clean(packed, w, *params, device=devs[0])
        if not torch.equal(blob_s.cpu(), blob_1.cpu()):
            raise AssertionError(f"{label}: the sharded blob diverged from the unsharded")
        print(f"[dryrun] sharded chain {label}: ({k},{h},{w}) over space={ns} — byte-equal ok")
    return len(cases)


def _dryrun_batch_runner(devs: list, n_devices: int) -> int:
    """``run_pipeline_batch`` over the devices as its data axis, three
    seeded images through steps 1–13, each ``plot_stream.bin`` byte-equal
    to a sequential run (twin of ``_dryrun_batch_runner``)."""
    import cv2  # noqa: PLC0415

    from .config import load_config  # noqa: PLC0415
    from .pipeline import run_pipeline, run_pipeline_batch  # noqa: PLC0415

    raster = "cpu" if devs[0].type == "cpu" else "auto"
    base = Path(tempfile.mkdtemp(prefix="pw_dryrun_batch_"))
    try:
        imgs = []
        for i in range(3):  # an odd count: a group that does not fill the mesh
            rng = np.random.default_rng(100 + i)
            img = np.zeros((120, 160, 3), np.uint8)
            img[:, :] = (235, 230, 225)
            colors = [(20, 20, 20), (40, 60, 200), (140, 180, 220)]
            for _ in range(10):
                c = colors[int(rng.integers(0, 3))]
                x, y = int(rng.integers(0, 160)), int(rng.integers(0, 120))
                cv2.circle(img, (x, y), int(rng.integers(6, 30)), c, -1)
            cv2.imwrite(str(base / f"img{i}.png"), img)
            imgs.append(base / f"img{i}.png")

        def build(tag):
            cfgs = []
            for i, img in enumerate(imgs):
                out = base / tag / f"run{i}"
                out.mkdir(parents=True)
                cfg = {"input_image": str(img), "output_dir": str(out), "raster_device": raster,
                       "colors": [[20, 20, 20], [40, 60, 200], [140, 180, 220], [235, 230, 225]],
                       "color_names": ["layer_dark", "layer_mid", "layer_skin", "layer_light"],
                       "target_width_mm": 80, "target_height_mm": 60, "pixels_per_mm": 2,
                       "pen_width_px": 8, "pen_radius_px": 4}
                (out / "config.json").write_text(json.dumps(cfg))
                cfgs.append(load_config(str(out / "config.json")))
            return cfgs

        for cfg in build("seq"):
            run_pipeline(cfg, 1, 13)
        times = run_pipeline_batch(build("par"), 1, 13, workers=3, mesh_dp=True, devices=devs)
        if not all(t > 0 for t in times):
            raise AssertionError(f"run_pipeline_batch: an image failed: {times}")
        for i in range(3):
            a = (base / "seq" / f"run{i}" / "plot_stream.bin").read_bytes()
            if a != (base / "par" / f"run{i}" / "plot_stream.bin").read_bytes():
                raise AssertionError(f"image {i}: the batch runner's stream diverged from the sequential run's")
        print(f"[dryrun] batch runner mesh-DP over {n_devices} device(s): 3 images byte-equal ok")
        return 3
    finally:
        shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    import sys

    mode = sys.argv[1] if len(sys.argv) > 1 else "auto"
    fn, args = entry(mode)
    print("entry ok:", [tuple(o.shape) for o in fn(*args)])
    if mode == "cpu":
        from .parallel.mesh import cpu_device_count  # noqa: PLC0415

        dryrun_multichip(max(2, cpu_device_count()), "cpu")
    else:
        dryrun_multichip(torch.cuda.device_count())
