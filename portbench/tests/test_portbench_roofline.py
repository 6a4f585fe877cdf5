"""portbench/roofline/ against the bounds that PERF.md's kernel table gives at
chip_smoke.py's shapes (4 x 1500 x 2000)."""

from __future__ import annotations

import pytest

from portbench.reference.raster import frontend_steps, program
from portbench.roofline import bound_s, k2_morph, k5_hysteresis, k6_thinning, k7_assign, k34_edges

# stage 02's chain: packed rows in, stage 03's 3x3 ellipse open and close, the blob's packed rows out
CHAIN = {"images": 1, "layers": 4, "height": 1500, "width": 2000, "ksize": 7, "k2_input": "rows", "k6_store": "rows",
         "steps": program("ellipse", 3, 1, "ed") + program("ellipse", 3, 1, "de")}
FRONT_STEPS = frontend_steps()


def ms(module, call):
    return bound_s(*module.work(call)) * 1e3


def test_portbench_roofline_chain_bounds():
    assert ms(k2_morph, CHAIN) == pytest.approx(0.00090, abs=5e-6)
    assert ms(k34_edges, CHAIN) == pytest.approx(0.03659, abs=5e-6)
    assert ms(k34_edges, dict(CHAIN, ksize=5)) == pytest.approx(0.03372, abs=5e-6)
    assert ms(k5_hysteresis, CHAIN) == pytest.approx(0.00135, abs=5e-6)
    # 122 layer-iterations (chip_smoke.py's chain inputs), both halves of the blob stored
    assert ms(k6_thinning, dict(CHAIN, k6_iterations=[30, 30, 31, 31])) == pytest.approx(0.06755, abs=5e-6)


def test_portbench_roofline_frontend_bounds():
    call = dict(CHAIN, steps=FRONT_STEPS, k2_input="boards", k6_store="dense")
    assert ms(k2_morph, call) == pytest.approx(0.00253, abs=5e-6)
    # K7: 3,000,000 px, 4 centres; every XYZ value through the cube root is the most work, none the least
    most = dict(call, k7_cube_roots=9_000_000)
    least = dict(call, k7_cube_roots=0)
    assert ms(k7_assign, least) < 0.00549 < ms(k7_assign, most)
    assert k7_assign.work(least)[0] == 3 * 3_000_000 + 4 * 1500 * 63 * 4


def test_portbench_roofline_counts_scale_with_the_batch():
    one = dict(CHAIN, k6_iterations=[3, 3, 3, 3])
    four = dict(one, images=4, k6_iterations=[3] * 16)
    for module in (k2_morph, k34_edges, k5_hysteresis, k6_thinning):
        b1, o1, _ = module.work(one)
        b4, o4, _ = module.work(four)
        assert (b4 - 4 * b1, o4) == ((-3 * 4 * 63 if module is k2_morph else 0), 4 * o1)
