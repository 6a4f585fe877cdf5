"""Device policy for the raster programs (twin of ``plotweave/utils/devices.py``).

``cfg.raster_device``:

- ``"auto"`` (the default): the CUDA card, where the bitboard fixpoints run
  as hand-written kernels.  Raises when ``torch.cuda.is_available()`` is false.
- ``"cpu"``: the plain PyTorch versions on the host.  The chain is integer
  only, so its bytes are the same on either device.

Nothing switches to the CPU by itself.
"""

from __future__ import annotations

import torch

CHOICES = ("auto", "cpu")


def device_for(mode: str) -> torch.device:
    """``"auto"`` → the CUDA card (raises without one); ``"cpu"`` → the host."""
    mode = str(mode or "auto").lower()
    if mode == "cpu":
        return torch.device("cpu")
    if mode != "auto":
        raise ValueError(f"raster_device must be one of {CHOICES}, got {mode!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "raster_device='auto' runs the raster chain on a CUDA device, and "
            "torch.cuda.is_available() is false; pass --raster-device cpu to "
            "run the plain PyTorch versions on the host"
        )
    return torch.device("cuda")


def raster_device(cfg) -> torch.device:
    """The device the stage 02–04 raster chain runs on for ``cfg``."""
    return device_for(getattr(cfg, "raster_device", "auto"))


def add_raster_device_flag(parser) -> None:
    """The ``--raster-device {auto,cpu}`` CLI flag."""
    parser.add_argument(
        "--raster-device",
        choices=list(CHOICES),
        dest="raster_device",
        help="placement for the stage 02-04 raster chain: auto = the CUDA "
        "card (hand-written kernels; raises without one); cpu = the plain "
        "PyTorch versions on the host (same bytes)",
    )
