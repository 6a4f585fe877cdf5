"""Plotter byte-stream protocol: planning, encoding, decoding.

Protocol summary (executable spec in decoder.py; reference:
shared/omnirevolve_plotter_stream_creator_helper.py:5-19):

- step byte, MSB set:   ``11 FFF SSS`` = two steps, ``10 SSS 000`` = one step
- service byte, MSB clear: ``0x40|div`` speed, ``0x01/0x02/0x03`` pen
  up/down/tap, ``0x08..0x0F`` color select, ``0x3F`` EOF
- streams are zero-padded to 1024-byte SPI chunks after EOF

Copy of ``plotweave/stream/__init__.py``; the port imports nothing of ``plotweave``.
"""

from .protocol import (
    SPI_CHUNK_SIZE,
    WORK_MAX_X,
    WORK_MAX_Y,
    DIR_VECTORS,
    dir_codes,
    pack_dir_codes,
)
from .encoder import StreamBuilder, MotionProfile, emit_polyline, travel_ramped
from .decoder import StreamDecoder, StreamStats

__all__ = [
    "SPI_CHUNK_SIZE",
    "WORK_MAX_X",
    "WORK_MAX_Y",
    "DIR_VECTORS",
    "dir_codes",
    "pack_dir_codes",
    "StreamBuilder",
    "MotionProfile",
    "emit_polyline",
    "travel_ramped",
    "StreamDecoder",
    "StreamStats",
]
