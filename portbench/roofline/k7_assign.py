"""K7 (``csrc/assign_nearest.cu``): BGR bytes → Lab → the nearest of k
centres, stored as one-hot bitboards.  Each pixel's 3 bytes read once and
the boards written once; float operations a pixel counted from the kernel's
arithmetic (a 256-entry gamma table, no ``powf``): XYZ 15, 3 divisions by
the white point, 3 compares, Lab 9; 9 a centre (3 differences, 3 squares, 2
adds, the compare); a cube root (20: exponent split, polynomial, two Newton
steps) for each XYZ value above (6/29)^3, else a division and an add (2).
Which branch each value takes is the reference's count on the same image."""

from portbench.roofline import FP32_OPS, board_bytes

TRACE = ("assign_nearest",)
COUNTERS = ("assign_nearest",)
FIXED, PER_CENTRE, CUBE_ROOT, LINEAR = 30, 9, 20, 2


def work(call: dict):
    px = call["images"] * call["height"] * call["width"]
    roots = call["k7_cube_roots"]
    ops = px * (FIXED + call["layers"] * PER_CENTRE) + roots * CUBE_ROOT + (3 * px - roots) * LINEAR
    return 3 * px + board_bytes(call), ops, FP32_OPS
