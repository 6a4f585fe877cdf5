"""Raster ops of the port as tensor functions (twin of ``plotweave/ops``).

Every op runs on the device of its tensor: on a CUDA tensor the hand-written
kernels of ``ops/kernels.py`` (``csrc/``), on a CPU tensor the plain PyTorch
versions beside them.  This file exports what ``plotweave/ops/__init__.py``
exports.  Importing it builds and loads no kernel.
"""

from .resize import area_resize, resize_if_needed
from .filters import gaussian_blur_u8
from .morphology import structuring_element, erode, dilate, morph_open, morph_close
from .canny import canny
from .thinning import zhang_suen

__all__ = [
    "area_resize",
    "resize_if_needed",
    "gaussian_blur_u8",
    "structuring_element",
    "erode",
    "dilate",
    "morph_open",
    "morph_close",
    "canny",
    "zhang_suen",
]
