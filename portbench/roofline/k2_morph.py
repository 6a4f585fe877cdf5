"""K2 (``csrc/morph_bits.cu``): a morphology step list on bitboards in one
launch.  The input read once (bitboards, or packed rows of 8 pixels a byte
on the chain), the result's boards written once, the valid-bit row read
once; a funnel shift and an OR a tap of the element and a word, each step."""

from portbench.reference.raster import element
from portbench.roofline import INT32_OPS, board_bytes, planes, words

TRACE = ("morph_steps",)
COUNTERS = ("morph_bits",)


def work(call: dict):
    taps = sum(int(element(shape, ksize).sum()) for shape, ksize, _ in call["steps"])
    n_words = planes(call) * call["height"] * words(call["width"])
    rows = call["k2_input"] == "rows"
    read = planes(call) * call["height"] * -(-call["width"] // 8) if rows else board_bytes(call)
    return read + board_bytes(call) + 4 * words(call["width"]), n_words * 2 * taps, INT32_OPS
