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
- :func:`emulate_k9` repeats K9's design in numpy: per-thread lists of the
  unused points only, compacted by moving a thread's last live point into the
  winner's slot; each thread's least (d² bits, meta) pair; two-stage 32-bit
  warp minima (the least d² bits, then the least low word beside them) and
  the CTA's over the warp slots; on the cluster route every CTA storing its
  slot into the parity buffer of every peer, each store completing its part
  of the peer's mbarrier phase (an arrival that expects every CTA's slot and
  a transaction count, in either order), each CTA a generator run at its own
  pace between its waits in a seeded order.  It must give the plain
  version's order on both routes, at small thread, warp and CTA counts; with
  one buffer in place of two the same schedules must catch the race.
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


F32 = np.float32
NONE = 0xFFFFFFFF  # a 32-bit word of no candidate
POS_MASK = 0x7FFF  # meta bits 1-15: the row of the slot in its thread's list


class MBarrier:
    """An mbarrier of one arrival a phase and a transaction count (here in
    slots, not bytes): a phase completes when its arrival has come and every
    slot it expects has landed, in either order.  ``phase`` counts the phases
    that have completed."""

    def __init__(self):
        self.pending, self.tx, self.phase = 1, 0, 0

    def arrive_expect_tx(self, slots: int) -> None:
        self.pending, self.tx = self.pending - 1, self.tx + slots
        self._complete()

    def complete_tx(self, slots: int) -> None:
        self.tx -= slots
        self._complete()

    def _complete(self) -> None:
        if self.pending == 0 and self.tx == 0:
            self.pending, self.phase = 1, self.phase + 1

    def passed(self, parity: int) -> bool:
        """``mbarrier.try_wait.parity``: the phase of this parity has completed."""
        return (self.phase & 1) != parity


def d2(x, y, cur):
    """float32 d² with each difference, product and sum rounded on its own."""
    dx, dy = (x - cur[0]).astype(F32), (y - cur[1]).astype(F32)
    return (dx * dx + dy * dy).astype(F32)


def k9_lists(s, e, closed, closed_aware, seed, base: int, cnt: int, threads: int):
    """A CTA's lists as K9 loads them: thread t's k-th live point at row k
    (start and end, the end of a closed contour set to its start) with its
    meta word l << 16 | k << 1, for the local indices l = t, t + threads, ...
    below ``cnt``, the seed left out.  Rows past a thread's count hold
    garbage that would win if read."""
    rows = max(1, -(-cnt // threads))
    rng = np.random.default_rng(cnt)
    L = np.zeros((rows, threads, 4), F32)
    M = rng.integers(0, 2**16, (rows, threads)).astype(np.uint32)  # garbage: a small meta would win
    live = np.zeros(threads, np.int64)
    for l in range(cnt):
        i, t = base + l, l % threads
        if i == seed:
            continue
        end = s[i] if closed_aware and closed[i] else e[i]
        k = live[t]
        L[k, t] = (s[i, 0], s[i, 1], end[0], end[1])
        M[k, t] = (l << 16) | (k << 1)
        live[t] += 1
    return L, M, live


def two_stage_min(hi, lo):
    """The least (hi, lo) pairs along the last axis, as two redux.sync take
    them: the least hi, then the least lo among the lanes that hold it."""
    h = hi.min(-1)
    return h, np.where(hi == h[..., None], lo, NONE).min(-1)


def k9_warp_slots(L, M, live, cur, lanes: int):
    """One step of a CTA up to its warp slots: each thread's least (d² bits,
    meta) over its live rows only (the compare of the pair as one 64-bit
    word), each warp's least pair by :func:`two_stage_min`, and the slot the
    lane that holds it writes: (hi, lo | flip, x, y), with the pen's next
    point; (NONE, NONE, 0, 0) from lane 0 of a warp with no candidate.
    Returns (the threads' least meta words, the slots)."""
    rows, threads = M.shape
    d = np.minimum(d2(L[..., 0], L[..., 1], cur), d2(L[..., 2], L[..., 3], cur))
    key = (d.view(np.uint32).astype(np.uint64) << np.uint64(32)) | M.astype(np.uint64)
    key[np.arange(rows)[:, None] >= live[None, :]] = np.uint64(2**64 - 1)  # only the live rows are scanned
    best = key.min(0)
    hi, lo = (best >> np.uint64(32)).astype(np.int64), (best & np.uint64(NONE)).astype(np.int64)
    whi, wlo = two_stage_min(hi.reshape(-1, lanes), lo.reshape(-1, lanes))
    slots = []
    for w, (h, l) in enumerate(zip(whi.tolist(), wlo.tolist())):
        if l == NONE:
            slots.append((NONE, NONE, F32(0), F32(0)))
            continue
        t = w * lanes + int(np.flatnonzero((hi[w * lanes:(w + 1) * lanes] == h) & (lo[w * lanes:(w + 1) * lanes] == l))[0])
        p = L[(l >> 1) & POS_MASK, t]
        flip = bool(d2(p[2], p[3], cur) < d2(p[0], p[1], cur))
        slots.append((h, l | flip, p[0] if flip else p[2], p[1] if flip else p[3]))
    return lo, slots


def k9_cta(s, e, closed, closed_aware, seed, rank: int, cluster: int, threads: int, lanes: int, recv, bars,
           slots: int, read: dict):
    """CTA ``rank`` of K9 as a generator: its own lists, its warp and CTA
    minima; on the cluster route it arrives on its own mbarrier of this
    step's buffer expecting every CTA's slot, stores its slot into every
    peer's received slots of that buffer, each store completing one slot on
    the peer's mbarrier (yielding between stores), yields until its own
    mbarrier's phase of this step has completed and once more, then reads
    the slots.
    ``read`` keeps the winner the first CTA read at each step: every other
    CTA must read the same.  Returns (order, flips)."""
    n = len(s)
    chunk = -(-n // cluster)
    base = rank * chunk
    cnt = max(0, min(chunk, n - base))
    L, M, live = k9_lists(s, e, closed, closed_aware, seed, base, cnt, threads)
    cur = s[seed] if closed_aware and closed[seed] else e[seed]
    order, flips = [seed], [False]
    for step in range(1, n):
        buf = step % slots
        mine, ws = k9_warp_slots(L, M, live, cur, lanes)
        chi, clo = two_stage_min(np.array([w[0] for w in ws]), np.array([w[1] for w in ws]))
        chi, clo = int(chi), int(clo)
        if cluster == 1:
            idx, flip = clo >> 16, clo & 1
            nxt = ws[(idx % threads) // lanes][2:]
        else:
            win = ws[((clo >> 16) % threads) // lanes] if clo != NONE else (NONE, NONE, F32(0), F32(0))
            c = (chi, NONE if clo == NONE else ((base + (clo >> 16)) << 5) | (rank << 1) | (clo & 1), *win[2:])
            bars[rank][buf].arrive_expect_tx(cluster)  # lane 0 of warp 0: its own mbarrier expects every CTA's slot
            for peer in range(cluster):  # lane `peer` of warp 0: a store that completes one slot on the peer's mbarrier
                recv[peer][buf][rank] = c
                bars[peer][buf].complete_tx(1)
                yield False
            parity = ((step - 1) // slots) & 1
            while not bars[rank][buf].passed(parity):
                yield True
            yield False  # past the wait, before the slots are read
            got = list(recv[rank][buf])
            ghi, glo = two_stage_min(np.array([g[0] for g in got]), np.array([g[1] for g in got]))
            ghi, glo = int(ghi), int(glo)
            assert read.setdefault(step, (ghi, glo)) == (ghi, glo), \
                f"CTA {rank} read another winner than the first CTA at step {step}"
            idx, flip = glo >> 5, glo & 1
            nxt = got[(glo >> 1) & 15][2:]
        l = idx - base
        if 0 <= l < cnt:  # the owner drops the winner, its own least pair, moving its last live point there
            t = l % threads
            k = (int(mine[t]) >> 1) & POS_MASK
            assert k < live[t] and int(M[k, t]) >> 16 == l, f"step {step}: {idx} is not thread {t}'s candidate"
            live[t] -= 1
            last = live[t]
            if k != last:
                L[k, t] = L[last, t]
                M[k, t] = (int(M[last, t]) & 0xFFFF0000) | (k << 1)
        order.append(int(idx))
        flips.append(bool(flip))
        cur = np.asarray(nxt, F32)
    return order, flips


def emulate_k9(s, e, closed, closed_aware, seed, cluster: int, threads: int = 8, lanes: int = 4,
               schedule: int = 0, slots: int = 2):
    """K9 (``csrc/greedy_tour.cu``) in numpy: ``cluster`` CTAs (1: the
    one-CTA route) of ``threads`` threads in warps of ``lanes``, each a
    :func:`k9_cta` run a stretch at a time in a random order seeded by
    ``schedule``, so a CTA past its wait may push the next step's slots
    before a slower one has read this step's.  The received slots start as
    garbage that would win if read.  ``slots`` = 1 models one set of slots
    and one mbarrier without the parity.  Every CTA must give the same tour."""
    rng = np.random.default_rng(schedule)
    recv = [[[(0, int(x), F32(0), F32(0)) for x in rng.integers(0, 32, cluster)] for _ in range(slots)]
            for _ in range(cluster)]
    bars = [[MBarrier() for _ in range(slots)] for _ in range(cluster)]
    read: dict = {}
    programs = [k9_cta(s, e, closed, closed_aware, seed, r, cluster, threads, lanes, recv, bars, slots, read)
                for r in range(cluster)]
    results, blocked = [None] * cluster, 0
    while any(r is None for r in results):
        ready = [r for r in range(cluster) if results[r] is None]
        r = ready[rng.integers(len(ready))]
        try:
            blocked = blocked + 1 if next(programs[r]) else 0
        except StopIteration as stop:
            results[r], blocked = stop.value, 0
        assert blocked < 1000 * cluster, "every CTA left waits on an mbarrier phase that never completes"
    assert all(r == results[0] for r in results), "the CTAs' tours differ"
    return results[0]


EMULATED_SIZES = [2, 3, 17, 300]  # 2, 3 and 300 are also the plain version's cases against JAX and the host


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
@pytest.mark.parametrize("n", EMULATED_SIZES)
def test_k9_one_cta_emulated(n, closed_aware, ties):
    # the inputs of test_plain_matches_jax_device_planner: through the plain version, the JAX device planner
    s, e, closed = plan(n, ties)
    seed = n // 2
    assert emulate_k9(s, e, closed, closed_aware, seed, 1) == plain_order(s, e, closed, closed_aware, seed)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
@pytest.mark.parametrize("n", EMULATED_SIZES)
@pytest.mark.parametrize("cluster", [3, 16])
def test_k9_cluster_emulated(cluster, n, closed_aware, ties):
    # the inputs of test_plain_matches_host_planner: through the plain version, the host planner
    s, e, closed = plan(n, ties, seed=1)
    seed = n - 1
    got = emulate_k9(s, e, closed, closed_aware, seed, cluster, schedule=n + cluster)
    assert got == plain_order(s, e, closed, closed_aware, seed)


@pytest.mark.parametrize("cluster", [1, 16], ids=["cta", "cluster"])
@pytest.mark.parametrize("closed_aware", [True, False], ids=["closed-aware", "open"])
def test_k9_emulated_on_float_coordinates(cluster, closed_aware):
    s, e, closed = plan(120, ties=False, seed=2, integer=False)
    got = emulate_k9(s, e, closed, closed_aware, 5, cluster, threads=4, lanes=2, schedule=7)
    assert got == host_order(s, e, closed, closed_aware, 5)


@pytest.mark.parametrize("schedule", range(4))
def test_k9_cluster_emulated_in_any_order(schedule):
    # a warp of 32 lanes and two warps a CTA, as few points a thread as on the card at 65,536 points
    s, e, closed = plan(200, ties=True, seed=8)
    got = emulate_k9(s, e, closed, True, 11, 16, threads=64, lanes=32, schedule=schedule)
    assert got == plain_order(s, e, closed, True, 11)


@pytest.mark.parametrize("schedule", range(3))
def test_k9_emulated_with_one_slot_races(schedule):
    # what the parity buffers prevent, shown by the same schedules: with one set of slots and one mbarrier, a CTA
    # past its wait pushes its next slot over one that a slower CTA has still to read
    s, e, closed = plan(60, ties=True, seed=9)
    assert emulate_k9(s, e, closed, True, 4, 16, schedule=schedule) == plain_order(s, e, closed, True, 4)
    with pytest.raises(AssertionError, match="read another winner"):
        emulate_k9(s, e, closed, True, 4, 16, schedule=schedule, slots=1)


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
    m, c = kernels.GREEDY_CTA_MAX_N, kernels.GREEDY_CLUSTER_MIN_N
    assert kernels.GREEDY_POINT_BYTES * m + kernels.GREEDY_STATIC_SMEM <= kernels.MAX_SMEM
    assert 2 < c <= m and m < 2**16  # a local index is 16 bits of the kernel's meta word
    assert kernels.greedy_route(2) == kernels.greedy_route(c - 1) == "cta"
    assert kernels.greedy_route(c) == kernels.greedy_route(kernels.GREEDY_MAX_N) == "cluster"
    assert kernels.greedy_route(100, "cluster") == "cluster" and kernels.greedy_route(m, "cta") == "cta"
    for bad in (lambda: kernels.greedy_route(1), lambda: kernels.greedy_route(kernels.GREEDY_MAX_N + 1),
                lambda: kernels.greedy_route(m + 1, "cta"), lambda: kernels.greedy_route(10, "warp")):
        with pytest.raises(ValueError):
            bad()


def test_greedy_kernel_refuses_cpu_tensors():
    pts = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.greedy_order_cuda(pts, pts, torch.zeros(5, dtype=torch.bool), True, 0)
