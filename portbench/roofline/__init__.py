"""The yardstick of the kernels' roofline shares: the card's published peaks
and the least time for a piece of work.  Each kernel's bytes and operations
are counted in ``roofline/<kernel>.py`` from the shapes of a call and the
counts that the reference makes on its inputs (``call`` below).

Each module names the kernel as the profiler's trace shows it (``TRACE``,
parts of the kernel's name), the program's launch counters that count it
(``COUNTERS``, keys of ``plotweave_torch.ops.kernels.LAUNCHES``), and
``work(call) -> (bytes, operations, operations a second)``.  A call is a
dict: ``images``, ``layers``, ``height``, ``width`` of the planes the call
works on, and what the entry's module adds (the blur's ``ksize``, the
morphology's ``steps``, K2's input ``k2_input``, K6's store ``k6_store``,
the reference's ``k6_iterations`` and ``k7_cube_roots``).
"""

# one NVIDIA H100 SXM (data sheet, dense rates, 700 W): HBM bytes a second,
# float32 outside the tensor cores, INT32 lanes (132 SMs x 64 lanes x 1.98 GHz)
HBM_BPS = 3.35e12
FP32_OPS = 67e12
INT32_OPS = 132 * 64 * 1.98e9


def bound_s(nbytes: float, ops: float, rate: float) -> float:
    """The least seconds for the work: the larger of the bytes at the HBM
    rate and the operations at ``rate``."""
    return max(nbytes / HBM_BPS, ops / rate)


def words(width: int) -> int:
    """32-pixel words of a row."""
    return -(-width // 32)


def planes(call: dict) -> int:
    return call["images"] * call["layers"]


def board_bytes(call: dict) -> int:
    """Bytes of the call's bitboards: 4 a word."""
    return planes(call) * call["height"] * words(call["width"]) * 4
