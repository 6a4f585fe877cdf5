"""K5 (``csrc/bitboard_fixpoints.cu``, resident or banded): the hysteresis
fixpoint on bitboards.  The candidate and strong boards read once, the edges
written once; one update a word (6 shifts, 3 ORs of three rows, the OR and
the AND with the candidates: 10 operations).  The function needs each word
once, as a flood fill from the strong pixels does; sweeps and rounds are one
way of computing it, and counting them would credit a slower schedule."""

from portbench.roofline import INT32_OPS, board_bytes, planes, words

TRACE = ("hysteresis_cluster", "hysteresis_sweep")
COUNTERS = ("hysteresis", "hysteresis_banded", "hysteresis_multi")
OPS_PER_WORD = 10


def work(call: dict):
    return 3 * board_bytes(call), planes(call) * call["height"] * words(call["width"]) * OPS_PER_WORD, INT32_OPS
