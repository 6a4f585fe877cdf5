"""K3+K4 (``csrc/edge_candidates.cu``): the Q8 blur and Canny's Sobel, NMS
and double threshold in one launch, from a bitboard mask to the candidate
and strong boards.  The mask read once, both boards written once; integer
operations a pixel: 2·ksize multiply-adds and 4 of rounding and clamping for
the blur, 12 for Sobel, 3 for the magnitude, 18 for the NMS and thresholds."""

from portbench.roofline import INT32_OPS, board_bytes, planes

TRACE = ("edge_tiles",)
COUNTERS = ("edge_candidates",)
FIXED = 37


def work(call: dict):
    px = planes(call) * call["height"] * call["width"]
    return 3 * board_bytes(call), px * (2 * call["ksize"] + FIXED), INT32_OPS
