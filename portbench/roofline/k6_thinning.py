"""K6 (``csrc/bitboard_fixpoints.cu``, resident or banded): the Zhang–Suen
fixpoint on bitboards, storing the edges and the skeletons itself (packed
rows into the chain's blob, or dense bytes on the front-end).  The edge
boards read once, both outputs written once.  Operations: each plane's
iterations (the reference's count on the same edges, the last one that
changes nothing included) × its words × 2 subpasses × 49 integer operations
a word and subpass (6 shifts, 16 for the neighbour count, 23 for the
transitions, 4 for the direction test and the clear; a three-input logic
operation or a funnel shift counted as one).  That count is the bit-sliced
way of computing the thinning; another way may need it restated."""

from portbench.roofline import INT32_OPS, board_bytes, words

TRACE = ("zs_cluster", "zs_subpass")
COUNTERS = ("zhang_suen_packed", "zhang_suen_packed_banded", "zhang_suen_packed_multi")
OPS_PER_WORD = 49


def work(call: dict):
    h, w = call["height"], call["width"]
    n_planes = call["images"] * call["layers"]
    row_bytes = -(-w // 8) if call["k6_store"] == "rows" else w
    ops = sum(call["k6_iterations"]) * h * words(w) * 2 * OPS_PER_WORD
    return board_bytes(call) + 2 * n_planes * h * row_bytes, ops, INT32_OPS
