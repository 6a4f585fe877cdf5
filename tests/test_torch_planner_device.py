"""Stage 07's device planner in the port (``plotweave_torch/vector/planner_device.py``,
the plain version of kernel K9) on the CPU, against the JAX package.

- ``greedy_order_plain`` gives the order and flips of
  ``plotweave.vector.planner_device._greedy_device_impl`` (jitted on jax's
  CPU) and of the JAX package's host planner (``plotweave.vector.sort.greedy_order``,
  its native C++ loop or, where that library is missing, its Python loop)
  exactly, at n = 2, 3, 300 and 1,500, closed-aware on and off, with ties
  made on purpose (duplicate points, d²(start) == d²(end)).  Coordinates are
  integers below 2000, so every d² is exact and XLA:CPU's fused multiply-adds
  cannot matter.  On float coordinates, where an FMA could flip an ulp, it is
  held to the host planner alone.
- :func:`emulate_k9` repeats K9's reduction in numpy (64-bit keys of d²'s
  bits and the index, per thread over a strided share of one CTA's points,
  warp, CTA and the cluster's 16 slots) and must give the plain version's
  order on both routes.
- The routing: the size limits of the JAX package (2 to 65,536), the CPU
  path silent and equal to the host planner, a CUDA device with no card
  raising, and :func:`kernels.greedy_route`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.vector import planner_device as jpd
from plotweave.vector import sort as jsort
from plotweave_torch.ops import kernels
from plotweave_torch.vector import planner_device as tpd
from plotweave_torch.vector import sort as tsort

SIZES = [2, 3, 300, 1500]


def plan(n: int, ties: bool, seed: int = 0, integer: bool = True):
    """Seeded (starts, ends, closed): integer coordinates in [0, 2000) (or
    floats where ``integer`` is false); with ``ties`` a third of the points
    repeat others, and some contours are mirrored around a point so that
    d²(start) == d²(end) from there."""
    rng = np.random.default_rng(seed + 1000 * n + ties)
    if integer:
        s = rng.integers(0, 2000, (n, 2)).astype(np.float32)
        e = rng.integers(0, 2000, (n, 2)).astype(np.float32)
    else:
        s = rng.uniform(0, 4000, (n, 2)).astype(np.float32)
        e = rng.uniform(0, 4000, (n, 2)).astype(np.float32)
    closed = rng.random(n) < 0.3
    if ties and n > 2:
        k = n // 3
        s[-k:] = s[:k]
        e[-k:] = e[:k]
        mid = e[0]
        for i in range(1, n, 5):  # start and end at one distance from the seed's end
            d = rng.integers(1, 40, 2).astype(np.float32)
            s[i], e[i] = mid + d, mid - d
    return s, e, closed


def jax_order(s, e, closed, closed_aware, seed):
    fn = jax.jit(lambda a, b, c, d, m: jpd._greedy_device_impl(a, b, c, d, m, closed_aware))
    order, flips = fn(jnp.asarray(s), jnp.asarray(e), jnp.asarray(closed), jnp.asarray(seed), jnp.asarray(len(s)))
    return np.asarray(order).tolist(), np.asarray(flips).tolist()


def plain_order(s, e, closed, closed_aware, seed):
    order, flips = tpd.greedy_order_plain(torch.from_numpy(s), torch.from_numpy(e), torch.from_numpy(closed),
                                          closed_aware, seed)
    return order.tolist(), flips.tolist()


def host_order(s, e, closed, closed_aware, seed):
    """The JAX package's host planner from contour ``seed`` (its seed is the
    longest contour: every length is 0 but the seed's)."""
    polys = [np.stack([a, b]).reshape(-1, 1, 2) for a, b in zip(s, e)]
    lengths = np.zeros(len(s))
    lengths[seed] = 1.0
    return jsort.greedy_order(polys, lengths, closed, closed_aware, starts=s, ends=e, device_min_n=0)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_device_planner(n, closed_aware, ties):
    s, e, closed = plan(n, ties)
    seed = n // 2
    assert plain_order(s, e, closed, closed_aware, seed) == jax_order(s, e, closed, closed_aware, seed)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_host_planner(n, closed_aware, ties):
    s, e, closed = plan(n, ties, seed=1)
    seed = n - 1
    order, flips = plain_order(s, e, closed, closed_aware, seed)
    assert (order, flips) == host_order(s, e, closed, closed_aware, seed)
    assert sorted(order) == list(range(n))


@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
def test_plain_matches_host_planner_on_float_coordinates(closed_aware):
    s, e, closed = plan(700, ties=False, seed=2, integer=False)
    assert plain_order(s, e, closed, closed_aware, 5) == host_order(s, e, closed, closed_aware, 5)


def emulate_k9(s, e, closed, closed_aware, seed, cluster: int, threads: int = 8):
    """K9's reduction in numpy: CTA r of ``cluster`` holds points [r chunk,
    (r + 1) chunk), thread t of ``threads`` scans its points t, t + threads,
    ..., every minimum is the least 64-bit key (d²'s bits << 32 | index << 2
    | flip << 1 | the pen ends at the start); warps of 32 threads, then the
    CTA's warps, then the cluster's slots."""
    n = len(s)
    chunk = -(-n // cluster)
    flag = np.where(closed_aware & closed, 1, 0).astype(np.uint8)
    flag[seed] |= 2
    cur = s[seed] if flag[seed] & 1 else e[seed]
    order, flips = [seed], [False]
    none = np.uint64(2**64 - 1)
    for _ in range(1, n):
        slots = []
        for r in range(cluster):
            lanes = []
            for t in range(threads):
                best = none
                for i in range(r * chunk + t, min(n, (r + 1) * chunk), threads):
                    if flag[i] & 2:
                        continue
                    d2s = np.float32(np.float32(s[i, 0] - cur[0]) ** 2 + np.float32(s[i, 1] - cur[1]) ** 2)
                    d2e = np.float32(np.float32(e[i, 0] - cur[0]) ** 2 + np.float32(e[i, 1] - cur[1]) ** 2)
                    pref = bool(flag[i] & 1) or d2s <= d2e
                    low = (i << 2) | (0 if pref else 2) | (1 if (flag[i] & 1) or not pref else 0)
                    key = np.uint64((int(np.float32(d2s if pref else d2e).view(np.uint32)) << 32) | low)
                    best = min(best, key)
                lanes.append(best)
            warps = [min(lanes[w:w + 32]) for w in range(0, threads, 32)]
            slots.append(min(warps))
        best = int(min(slots))
        idx, flip, at_start = (best & 0xFFFFFFFF) >> 2, bool(best & 2), bool(best & 1)
        flag[idx] |= 2
        order.append(idx)
        flips.append(flip)
        cur = s[idx] if at_start else e[idx]
    return order, flips


@pytest.mark.parametrize("cluster", [1, 16], ids=["cta", "cluster"])
@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
def test_k9_reduction_emulated(cluster, closed_aware):
    s, e, closed = plan(150, ties=True, seed=3)
    assert emulate_k9(s, e, closed, closed_aware, 7, cluster) == plain_order(s, e, closed, closed_aware, 7)


def test_device_entry_routes_by_size():
    s, e, closed = plan(40, ties=True, seed=4)
    got = tpd.greedy_order_device(s, e, closed, True, 3, torch.device("cpu"))
    assert got == plain_order(s, e, closed, True, 3)
    # the JAX package's limits: fewer than 2, or more than its largest bucket, go to the host
    assert tpd.greedy_order_device(s[:1], e[:1], closed[:1], True, 0, torch.device("cpu")) is None
    big = np.zeros((tpd.MAX_N + 1, 2), np.float32)
    assert tpd.greedy_order_device(big, big, np.zeros(len(big), bool), True, 0, torch.device("cpu")) is None
    assert tpd.MAX_N == jpd.BUCKETS[-1] == kernels.GREEDY_MAX_N


def _contours(n: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts = rng.integers(0, 600, (int(rng.integers(2, 7)), 2)).astype(np.int32)
        if rng.random() < 0.3:
            pts = np.vstack([pts, pts[:1]])
        out.append(pts.reshape(-1, 1, 2))
    return out


def test_sort_contours_on_the_cpu_is_the_silent_host_planner(capsys):
    contours = _contours(80, 5)
    host = jsort.sort_contours(contours)
    capsys.readouterr()
    for device in (None, torch.device("cpu")):
        got = tsort.sort_contours(contours, device_min_n=10, device=device)
        assert capsys.readouterr().out == ""
        assert len(got) == len(host) and all(np.array_equal(a, b) for a, b in zip(got, host))


def test_device_planner_plain_through_sort_contours():
    """The device path's own ordering, driven on the CPU tensors: the same
    contours as the host planner's."""
    contours = _contours(120, 6)
    ptss = [c.reshape(-1, 2) for c in contours]
    starts, ends, closed = tsort._batch_endpoints(ptss, strip_closed=True)
    lengths = tsort.batch_arc_length(ptss, np.ones(len(ptss), bool))
    seed = int(np.argmax(lengths))
    dev = tpd.greedy_order_device(starts, ends, closed, True, seed, torch.device("cpu"))
    host = tsort.greedy_order(contours, lengths, closed, True, starts=starts, ends=ends)
    assert dev == host


def test_sort_contours_on_a_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py drives K9 there")
    contours = _contours(30, 7)
    with pytest.raises(RuntimeError, match="cuda"):
        tsort.sort_contours(contours, device_min_n=10, device=torch.device("cuda"))
    # below the gate the device is never touched
    assert len(tsort.sort_contours(contours, device_min_n=31, device=torch.device("cuda"))) == 30


def test_greedy_route():
    m = kernels.GREEDY_CTA_MAX_N
    assert kernels.GREEDY_POINT_BYTES * m + kernels.GREEDY_STATIC_SMEM <= kernels.MAX_SMEM
    assert kernels.greedy_route(2) == kernels.greedy_route(m) == "cta"
    assert kernels.greedy_route(m + 1) == kernels.greedy_route(kernels.GREEDY_MAX_N) == "cluster"
    assert kernels.greedy_route(100, "cluster") == "cluster"
    for bad in (lambda: kernels.greedy_route(1), lambda: kernels.greedy_route(kernels.GREEDY_MAX_N + 1),
                lambda: kernels.greedy_route(m + 1, "cta"), lambda: kernels.greedy_route(10, "warp")):
        with pytest.raises(ValueError):
            bad()


def test_greedy_kernel_refuses_cpu_tensors():
    pts = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.greedy_order_cuda(pts, pts, torch.zeros(5, dtype=torch.bool), True, 0)
