"""Stage 12's device refiner in the port (``plotweave_torch/vector/refine_device.py``,
the plain version of kernel K10) on the CPU, against the JAX package.

- ``refine_order_plain`` gives the perm, flips and move count of
  ``plotweave.vector.refine_device._refine_impl`` (jitted on jax's CPU)
  exactly, at n = 3, 4, 32, 128 and 256, on random tours and on greedy ones,
  with and without a small move budget.  Coordinates are integers below 2000,
  so every squared distance is exact, each square root is correctly rounded
  on both sides, and no product is left for XLA:CPU to fuse.
- The perm stays a permutation after every move; ``refine_ops_device``
  keeps the drawn geometry (every op's points, up to reversal), never
  lengthens the float64 tour, and hands the input back where it cannot
  shorten it.
- :func:`emulate_k10` repeats K10's whole loop in numpy float32 at small CTA,
  warp and lane counts: every CTA with its own copy of the tour; the (column
  group, row) units cut into equal runs per CTA and per warp; the four
  distances a (row, column) shared by the three families, with d(X_i-1, X_c)
  carried from the row before; each lane's (value, row) minima along a
  column, then 64-bit keys (the delta's ordered bits, row << 14 | column) per
  warp, CTA and grid; the partial minima in two slots by the iteration's
  parity, the other slot full of winning garbage; the stop test; the move
  made in place in each CTA's copy (a relocate's shift in chunks of the
  thread count, from the end that never reads a written slot), then edge and
  gain_rm recomputed only beside the changed slots.  It must give
  the plain version's perm, flips and moves, and each family's argmin over
  the flattened matrix, on tours of 3 to 40 ops with many equal deltas,
  signed zeros and float coordinates, and on tours whose first move is a
  2-opt of the whole tour, a relocate to slot 0 or slot n, or one with dest
  below or above i.  The in-place moves are held to the plain gather for
  every move of small tours, the partial prologue to the full one after
  every move, the unit runs to cover every (row, column) once,
  ``dist`` to be symmetric bit for bit, and the resident tour to fit one
  CTA's shared memory at 8,192 ops.
- The routing: the size limits (3 to 8,192), the CPU path silent and equal
  to the host refiner, and a CUDA device with no card raising.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.vector import planner as jplanner
from plotweave.vector import refine_device as jrd
from plotweave_torch.ops import kernels
from plotweave_torch.vector import planner as tplanner
from plotweave_torch.vector import refine_device as trd

SIZES = [3, 4, 32, 128, 256]


def tour(n: int, kind: str, seed: int = 0):
    """Seeded entries and exits, integer coordinates in [0, 2000): random,
    in the greedy order the planner would give them, or on a small grid
    with repeated points (many equal deltas)."""
    rng = np.random.default_rng(seed + 17 * n)
    if kind == "grid":
        E = rng.integers(0, 6, (n, 2)).astype(np.float32) * 100
        X = rng.integers(0, 6, (n, 2)).astype(np.float32) * 100
        return E, X
    E = rng.integers(0, 2000, (n, 2)).astype(np.float32)
    X = rng.integers(0, 2000, (n, 2)).astype(np.float32)
    if kind == "greedy":  # nearest entry from each exit, from the origin
        order, pos, left = [], np.zeros(2, np.float32), list(range(n))
        while left:
            k = min(left, key=lambda i: float(((E[i] - pos) ** 2).sum()))
            left.remove(k)
            order.append(k)
            pos = X[k]
        E, X = E[order], X[order]
    return E, X


def jax_refine(E, X, max_moves: int, start=(0.0, 0.0)):
    perm, flip, moves = jax.jit(jrd._refine_impl)(jnp.asarray(E), jnp.asarray(X), jnp.asarray(len(E)),
                                                  jnp.asarray(np.asarray(start, np.float32)), jnp.asarray(max_moves))
    return np.asarray(perm).tolist(), np.asarray(flip).tolist(), int(moves)


def plain_refine(E, X, max_moves: int, start=(0.0, 0.0)):
    perm, flip, moves = trd.refine_order_plain(torch.from_numpy(E), torch.from_numpy(X),
                                               torch.tensor(start, dtype=torch.float32), max_moves)
    return perm.tolist(), flip.tolist(), moves


@pytest.mark.parametrize("kind", ["random", "greedy"])
@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_refine_impl(n, kind):
    E, X = tour(n, kind)
    got = plain_refine(E, X, 4096)
    assert got == jax_refine(E, X, 4096)
    assert sorted(got[0]) == list(range(n))


@pytest.mark.parametrize("n", SIZES)
def test_plain_matches_jax_refine_impl_with_a_budget_and_a_start(n):
    E, X = tour(n, "grid", seed=1)
    for max_moves in (0, 1, 3):
        got = plain_refine(E, X, max_moves, start=(150.0, 250.0))
        assert got == jax_refine(E, X, max_moves, start=(150.0, 250.0)), max_moves
        assert got[2] <= max_moves


def test_perm_stays_a_permutation_after_every_move():
    E, X = tour(24, "random", seed=2)
    for mm in range(1, 80):
        perm, flip, moves = plain_refine(E, X, mm)
        assert sorted(perm) == list(range(24)), (mm, perm)
        if moves < mm:
            break
    else:
        raise AssertionError("the refiner did not converge within 80 moves")


def _ops(n_lines: int, n_taps: int, seed: int):
    rng = np.random.default_rng(seed)
    lines = [rng.integers(0, 900, (int(rng.integers(2, 6)), 2)).astype(np.int32).reshape(-1, 1, 2)
             for _ in range(n_lines)]
    taps = [tuple(map(int, rng.integers(0, 900, 2))) for _ in range(n_taps)]
    return tplanner.plan_layer_ops(lines, taps, 30.0)


def _op_key(o):
    if o["type"] == "tap":
        return ("tap", o["x"], o["y"])
    p = o["points"]
    return ("line", min(p.tobytes(), p[::-1].copy().tobytes()))


@pytest.mark.parametrize("seed", [9, 10])
def test_refine_ops_keeps_geometry_and_never_lengthens(seed):
    ops = _ops(60, 15, seed)
    got = trd.refine_ops_device(ops, device=torch.device("cpu"))
    assert sorted(map(_op_key, ops)) == sorted(map(_op_key, got))
    assert tplanner.tour_length(got) <= tplanner.tour_length(ops)
    # the JAX package's device refiner on the same ops: the same list
    jax_got = jrd.refine_ops_device(ops)
    assert [_op_key(o) for o in got] == [_op_key(o) for o in jax_got]


def test_refine_ops_hands_back_a_tour_it_cannot_shorten():
    ops = [{"type": "line", "points": np.array([[10 * i, 0], [10 * i + 5, 0]], np.float32)} for i in range(12)]
    got = trd.refine_ops_device(ops, device=torch.device("cpu"))
    assert got == ops and all(a is b for a, b in zip(got, ops))


def test_size_limits_route_as_the_jax_package():
    E, X = tour(4, "random")
    cpu = torch.device("cpu")
    assert trd.refine_order_device(E[:2], X[:2], device=cpu) is None
    big = np.zeros((trd.MAX_N + 1, 2), np.float32)
    assert trd.refine_order_device(big, big, device=cpu) is None
    assert trd.refine_ops_device(_ops(2, 0, 3)[:2], device=cpu) is None
    assert trd.MAX_N == jrd.BUCKETS[-1] == kernels.REFINE_MAX_N and trd.MIN_GAIN == jrd.MIN_GAIN


def test_refine_tour_on_the_cpu_is_the_silent_host_refiner(capsys):
    ops = _ops(20, 5, 11)
    host = jplanner.refine_tour(list(ops))
    capsys.readouterr()
    for device in (None, torch.device("cpu")):
        got = tplanner.refine_tour(list(ops), device_min_n=5, device=device)
        assert capsys.readouterr().out == ""
        assert [_op_key(o) for o in got] == [_op_key(o) for o in host]


def test_refine_tour_on_a_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py drives K10 there")
    ops = _ops(20, 5, 12)
    with pytest.raises(RuntimeError, match="cuda"):
        tplanner.refine_tour(list(ops), device_min_n=5, device=torch.device("cuda"))
    # below the gate the device is never touched
    assert len(tplanner.refine_tour(list(ops), device_min_n=len(ops) + 1, device=torch.device("cuda"))) == len(ops)


def test_refine_kernel_refuses_cpu_tensors():
    pts = torch.zeros((5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.refine_order_cuda(pts, pts, (0.0, 0.0), 10)


# --- K10's loop, emulated --------------------------------------------------------------------------------------------

F32 = np.float32
NONE = (1 << 64) - 1
NO_INDEX = (1 << 32) - 1
FLIP = 0x8000  # PF's flip bit; the perm is the low 15 bits
REVERSED = [2, 3, 0, 1]  # an op's (entry, exit) as (exit, entry)
STATIC_SMEM = 1024  # a bound on the kernel's static shared memory: warp_key[3][32] uint64, and the grid group's


def _dist(a, b) -> np.ndarray:
    """The kernel's ``dist`` over the last axis: float32, each difference,
    square and sum rounded on its own, then the square root."""
    d = np.asarray(a, F32) - np.asarray(b, F32)
    return np.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def _key(v, flat: int) -> int:
    u = int(np.array(F32(0.0) if v == 0 else v, F32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | int(flat)


def _value(key: int) -> np.float32:
    u = key >> 32
    u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
    return np.array(u, np.uint32).view(F32)[()]


def _take(ok, v, flat, bv, bi) -> None:
    """A candidate per lane, visited in increasing index order: a strict <."""
    upd = ok & (v < bv)
    bv[upd], bi[upd] = v[upd], flat[upd]


def prologue(EX, start) -> np.ndarray:
    """EG: (edge, gain_rm) of every op from the tour EX (n, 4) = (entry, exit)."""
    E, X = EX[:, :2], EX[:, 2:]
    P = np.vstack([start[None], X[:-1]])
    a = _dist(P, E)
    g = a.copy()  # the last op: (a + 0) - 0
    g[:-1] = (a[:-1] + _dist(X[:-1], E[1:])) - _dist(P[:-1], E[1:])
    return np.stack([a, g], 1)


COL_BITS = 14  # a key's index: row << 14 | column, in the order of the flat index


def k10_runs(n: int, blocks: int, warps: int, lanes: int):
    """Per CTA its run [c_lo, c_hi) of the (column group, row) units u = g n
    + i, and per warp its share [u_lo, u_hi) of it, as the kernel cuts them."""
    units = (n + lanes) // lanes * n
    out = []
    for b in range(blocks):
        c_lo, c_hi = b * units // blocks, (b + 1) * units // blocks
        out.append((c_lo, c_hi, [(c_lo + w * (c_hi - c_lo) // warps, c_lo + (w + 1) * (c_hi - c_lo) // warps)
                                 for w in range(warps)]))
    return out


def warp_minima(EX, EG, start, u_lo: int, u_hi: int, lanes: int):
    """One warp's walk of its units: per lane and column group each
    family's (value, row << 14 | column) minimum, the warp's least key of
    each group into the warp's key; -> the warp's three keys."""
    n = len(EX)
    lane = np.arange(lanes)
    warp_key = [NONE] * 3
    u = u_lo
    g, r0 = divmod(u_lo, n)
    while u < u_hi:
        r1 = min(n, r0 + u_hi - u)
        c = g * lanes + lane - 1  # relocate slot c + 1, 2-opt j = c
        col, tail = c < n, c + 1 < n
        Xc = np.where((c < 0)[:, None], start, EX[np.clip(c, 0, n - 1), 2:])
        Ec1 = np.where(tail[:, None], EX[np.clip(c + 1, 0, n - 1), :2], Xc)
        e1 = np.where(tail, EG[np.clip(c + 1, 0, n - 1), 0], F32(0))
        prev = _dist(EX[r0 - 1, 2:] if r0 else start, Xc)  # d(P_i, X_c) of the first row
        v, k = np.full((3, lanes), np.inf, F32), np.full((3, lanes), NO_INDEX, np.int64)
        fr, f2 = (r0 << COL_BITS) + c + 1, (r0 << COL_BITS) + c
        for i in range(r0, r1):
            Ei, Xi = EX[i, :2], EX[i, 2:]
            a, gi = EG[i]
            dEX, dXX = _dist(Ei, Xc), _dist(Xi, Xc)
            dXE = np.where(tail, _dist(Xi, Ec1), F32(0))
            dEE = np.where(tail, _dist(Ei, Ec1), F32(0))
            reloc = col & ((i - c < 0) | (i - c > 1))  # k = c + 1 is neither i nor i + 1
            _take(reloc, ((dEX + dXE) - e1) - gi, fr, v[1], k[1])
            _take(reloc, ((dXX + dEE) - e1) - gi, fr, v[2], k[2])
            _take(col & (c >= i), ((prev + dEE) - a) - e1, f2, v[0], k[0])
            prev = dXX
            fr, f2 = fr + (1 << COL_BITS), f2 + (1 << COL_BITS)
        for f in range(3):  # the group's keys: a warp reduction, then the warp's key in shared memory
            warp_key[f] = min(warp_key[f], *(_key(x, y) for x, y in zip(v[f], k[f])))
        u += r1 - r0
        g, r0 = g + 1, 0
    return warp_key


def apply_move(EX, PF, fam: int, flat: int, chunk: int) -> None:
    """The kernel's in-place move on one CTA's copy, ``chunk`` threads: a
    2-opt swaps pairs, a relocate shifts in chunks, each chunk's reads before
    its writes, from the end that never reads a slot already written."""
    n = len(EX)
    if fam == 0:
        i, j = divmod(flat, n)
        pairs = (j - i) // 2 + 1
        for p0 in range(0, pairs, chunk):
            p = np.arange(p0, min(pairs, p0 + chunk))
            a, b = i + p, j - p
            ea, eb, pa, pb = EX[a].copy(), EX[b].copy(), PF[a].copy(), PF[b].copy()
            EX[a], PF[a] = eb[:, REVERSED], pb ^ FLIP
            EX[b], PF[b] = ea[:, REVERSED], pa ^ FLIP
        return
    i, k = divmod(flat, n + 1)
    dest = k if k < i else k - 1
    moved, pm = EX[i].copy(), PF[i]
    if fam == 2:
        moved, pm = moved[REVERSED], pm ^ FLIP
    if dest < i:  # t in (dest, i] takes t - 1, from the top down
        for hi in range(i, dest, -chunk):
            t = hi - np.arange(chunk)
            t = t[t > dest]
            v, p = EX[t - 1].copy(), PF[t - 1].copy()
            EX[t], PF[t] = v, p
    else:  # t in [i, dest) takes t + 1, from the bottom up
        for lo in range(i, dest, chunk):
            t = lo + np.arange(chunk)
            t = t[t < dest]
            v, p = EX[t + 1].copy(), PF[t + 1].copy()
            EX[t], PF[t] = v, p
    EX[dest], PF[dest] = moved, pm


def changed_slots(fam: int, flat: int, n: int):
    """The slots whose op the move changes, (lo, hi): 2-opt i..j, relocate i..dest."""
    if fam == 0:
        return divmod(flat, n)
    i, k = divmod(flat, n + 1)
    dest = k if k < i else k - 1
    return min(i, dest), max(i, dest)


def update_prologue(EG, EX, start, fam: int, flat: int) -> None:
    """The kernel's prologue after a move: edge and gain_rm recomputed for
    the slots beside a changed one only, the others kept as they were."""
    n = len(EX)
    lo, hi = changed_slots(fam, flat, n)
    t0, t1 = max(lo - 1, 0), min(hi + 1, n - 1)
    EG[t0:t1 + 1] = prologue(EX, start)[t0:t1 + 1]


def gather_move(EX, PF, fam: int, flat: int):
    """The same move as the plain version makes it: a gather from the old tour."""
    n = len(EX)
    idx = np.arange(n)
    if fam == 0:
        i, j = divmod(flat, n)
        swap = (idx >= i) & (idx <= j)
        src = np.where(swap, i + j - idx, idx)
    else:
        i, k = divmod(flat, n + 1)
        dest = k if k < i else k - 1
        src = np.where((idx > dest) & (idx <= i), idx - 1, np.where((idx >= i) & (idx < dest), idx + 1, idx))
        src = np.where(idx == dest, i, src)
        swap = (idx == dest) & (fam == 2)
    e = EX[src]
    return np.where(swap[:, None], e[:, REVERSED], e), PF[src] ^ np.where(swap, FLIP, 0).astype(np.uint16)


def cta_program(E, X, start, max_moves: int, lanes: int, chunk: int, warp_runs, b: int, partial, slots: int,
                read: list):
    """One CTA of K10 as a generator over its own copy of the tour: it
    computes its partial minima, writes them into this iteration's slot and
    yields at the grid barrier; resumed after the barrier, it reads the slot
    itself, decides and applies the move.  ``read`` collects, per iteration,
    the keys the first CTA to read them took; every later CTA must read the
    same.  Returns (EX, PF, moves)."""
    n = len(E)
    EX = np.concatenate([E, X], 1).astype(F32)
    EG, PF = prologue(EX, start), np.arange(n, dtype=np.uint16)
    moves = 0
    while moves < max_moves:
        slot = partial[moves & 1 if slots == 2 else 0]
        keys = [NONE] * 3
        for u_lo, u_hi in warp_runs:
            keys = [min(x, y) for x, y in zip(keys, warp_minima(EX, EG, start, u_lo, u_hi, lanes))]
        slot[:, b] = keys
        yield  # the grid barrier
        best_key = tuple(int(k) for k in slot.min(axis=1))
        if moves == len(read):
            read.append(best_key)
        assert read[moves] == best_key, f"CTA {b} read other minima than the first CTA in iteration {moves}"
        move = decoded(best_key, n)[1]
        if move is None:
            break
        apply_move(EX, PF, *move, chunk)
        update_prologue(EG, EX, start, *move)
        moves += 1
    return EX, PF, moves


def decoded(best_key, n: int):
    """(c2, cf, cr) flat indices and the move (family, flat) of one
    iteration's three keys; the family None where no move gains enough."""
    at = [(k & 0xFFFFFFFF) >> COL_BITS for k in best_key], [k & ((1 << COL_BITS) - 1) for k in best_key]
    flats = [at[0][0] * n + at[1][0]] + [at[0][f] * (n + 1) + at[1][f] for f in (1, 2)]
    vals = [_value(k) for k in best_key]
    fam, best = 0, vals[0]  # the first minimum of the three values
    for f in (1, 2):
        if vals[f] < best:
            fam, best = f, vals[f]
    return tuple(flats), ((fam, flats[fam]) if best < F32(-1e-2) else None)


def emulate_k10(E, X, start, max_moves: int, blocks: int, warps: int, lanes: int, argmins=None, log=None,
                seed: int = 0, slots: int = 2):
    """K10 (``csrc/refine_tour.cu``) in numpy float32: ``blocks`` CTAs of
    ``warps`` warps of ``lanes`` lanes, each a :func:`cta_program` with its
    own copy of the tour, run one stretch between barriers at a time in a
    seeded random order that a grid barrier constrains.  So a CTA past the
    barrier may make its move and write the next iteration's partial minima
    before a slower one reads this iteration's.  The partial slots start as
    the wrapper leaves them, uninitialised: here garbage that would win if
    read.  ``slots`` = 1 models one slot without the parity.  ``argmins``
    collects each iteration's (c2, cf, cr), ``log`` each applied move's
    (family, flat index)."""
    n = len(E)
    start = np.asarray(start, F32)
    rng = np.random.default_rng(seed)
    partial = np.array([[[_key(F32(-1e30), int(x)) for x in rng.integers(0, n, blocks)] for _ in range(3)]
                        for _ in range(2)], np.uint64)
    read = []
    programs = [cta_program(E, X, start, max_moves, lanes, warps * lanes, warp_runs, b, partial, slots, read)
                for b, (_, _, warp_runs) in enumerate(k10_runs(n, blocks, warps, lanes))]
    arrived = [0] * blocks  # the grid barriers each CTA has reached
    held = [False] * blocks  # waiting at its last one
    results = [None] * blocks
    while any(r is None for r in results):
        ready = [b for b in range(blocks) if results[b] is None and not held[b]]
        assert ready, "every CTA left waits at a grid barrier that an exited CTA never reaches"
        b = ready[rng.integers(len(ready))]
        try:
            next(programs[b])
            arrived[b], held[b] = arrived[b] + 1, True
        except StopIteration as stop:
            results[b] = stop.value
        # a grid barrier opens when every CTA has reached it
        held = [h and arrived[c] > min(arrived) for c, h in enumerate(held)]
    EX, PF, moves = results[0]
    assert all(np.array_equal(EX, r[0]) and np.array_equal(PF, r[1]) and moves == r[2] for r in results)
    for best_key in read:
        flats, move = decoded(best_key, n)
        if argmins is not None:
            argmins.append(flats)
        if log is not None and move is not None:
            log.append(move)
    return (PF & 0x7FFF).astype(np.int64).tolist(), (PF >> 15).astype(bool).tolist(), moves


def _plain_argmins(E, X, start, max_moves: int):
    """Each iteration's (c2, cf, cr) of the plain version, by torch.argmin
    over the flattened matrices, recorded through a wrapped argmin."""
    seen, real = [], torch.argmin

    def argmin(m, *a, **k):
        out = real(m, *a, **k)
        if m.dim() == 2:
            seen.append(int(out))
        return out

    torch.argmin = argmin
    try:
        trd.refine_order_plain(torch.from_numpy(E), torch.from_numpy(X), torch.tensor(start, dtype=torch.float32),
                               max_moves)
    finally:
        torch.argmin = real
    return [tuple(seen[k:k + 3]) for k in range(0, len(seen), 3)]


def emulated_tour(n: int, kind: str, seed: int):
    """A tour for the emulation: :func:`tour`'s kinds, float coordinates, or
    signed zeros and a few repeated values (many equal deltas and zero
    distances)."""
    rng = np.random.default_rng(seed + 31 * n)
    if kind == "float":
        return rng.uniform(0, 2000, (n, 2)).astype(F32), rng.uniform(0, 2000, (n, 2)).astype(F32)
    if kind == "zeros":
        vals = np.array([-0.0, 0.0, 100.0, 200.0], F32)
        return vals[rng.integers(0, 4, (n, 2))], vals[rng.integers(0, 4, (n, 2))]
    return tour(n, kind, seed)


def line_tour(kind: str):
    """Taps (entry == exit) on the x axis whose first best move is of
    ``kind``, with many equal deltas: the tour visits x in the order given."""
    n = 12
    xs = {"whole_2opt": [100 * (n - t) for t in range(n)],  # far end first: 2-opt(0, n - 1)
          "slot_0": [1000 + 100 * t for t in range(n - 1)] + [10],  # the last tap belongs before the first
          "slot_n": [5000] + [100 * t for t in range(1, n)],  # the first tap belongs after the last
          "dest_below": [100 * t for t in range(1, n)] + [150],  # the last tap belongs at slot 1
          "dest_above": [100, 850] + [100 * t for t in range(2, n)]}[kind]  # the second belongs at 850
    E = np.stack([np.asarray(xs, F32), np.zeros(n, F32)], 1)
    return E, E.copy()


def first_move_kind(fam: int, flat: int, n: int) -> str:
    if fam == 0:
        i, j = divmod(flat, n)
        return "whole_2opt" if (i, j) == (0, n - 1) else "2opt"
    i, k = divmod(flat, n + 1)
    return "slot_0" if k == 0 else "slot_n" if k == n else "dest_below" if k < i else "dest_above"


# (CTAs, warps, lanes): the kernel's 32-lane warps, and narrow ones that give small tours many column groups
SCHEDULES = [(1, 1, 32), (3, 2, 4), (5, 3, 8), (2, 4, 2), (4, 1, 8), (7, 5, 3)]
EMULATED = [(3, "grid"), (4, "random"), (14, "grid"), (17, "zeros"), (23, "float"), (40, "greedy")]


@pytest.mark.parametrize("blocks,warps,lanes", SCHEDULES)
@pytest.mark.parametrize("n,kind", EMULATED)
def test_k10_loop_emulated(n, kind, blocks, warps, lanes):
    E, X = emulated_tour(n, kind, seed=5)
    start = (100.0, 0.0) if kind != "zeros" else (-0.0, 0.0)
    argmins = []
    got = emulate_k10(E, X, start, 4096, min(blocks, n), warps, lanes, argmins, seed=n + blocks)
    assert got == plain_refine(E, X, 4096, start=start)
    assert argmins == _plain_argmins(E, X, start, 4096)


@pytest.mark.parametrize("n,kind,blocks,lanes", [(23, "float", 5, 8), (40, "greedy", 7, 3), (17, "zeros", 3, 4)])
def test_k10_emulated_with_one_partial_slot_races(n, kind, blocks, lanes):
    # what the parity slots prevent, shown by the same schedules: with one slot a CTA past the barrier writes its
    # next minima over the ones a slower CTA has still to read
    E, X = emulated_tour(n, kind, seed=5)
    start = (100.0, 0.0) if kind != "zeros" else (-0.0, 0.0)
    with pytest.raises(AssertionError, match="read other minima"):
        emulate_k10(E, X, start, 4096, blocks, 2, lanes, seed=n + blocks, slots=1)


@pytest.mark.parametrize("kind", ["whole_2opt", "slot_0", "slot_n", "dest_below", "dest_above"])
def test_k10_emulated_takes_each_kind_of_move(kind):
    E, X = line_tour(kind)
    argmins, log = [], []
    got = emulate_k10(E, X, (0.0, 0.0), 4096, 3, 2, 4, argmins, log)
    assert first_move_kind(*log[0], len(E)) == kind, log
    assert got == plain_refine(E, X, 4096)
    assert argmins == _plain_argmins(E, X, (0.0, 0.0), 4096)


@pytest.mark.parametrize("n,blocks,warps,lanes", [(3, 3, 32, 32), (40, 7, 5, 3), (1214, 132, 32, 32),
                                                  (8192, 132, 32, 32)])
def test_k10_runs_cover_every_pair_once_and_evenly(n, blocks, warps, lanes):
    groups = (n + lanes) // lanes  # column groups: slots 0..n in groups of `lanes`, the last partly empty
    assert (groups - 1) * lanes <= n < groups * lanes
    seen = np.zeros((groups, n), np.uint8)  # (column group, row) units: each covers its group's slots of the row
    runs = k10_runs(n, blocks, warps, lanes)
    sizes = [c_hi - c_lo for c_lo, c_hi, _ in runs]
    assert max(sizes) - min(sizes) <= 1  # every CTA takes its share, to a unit
    for _, _, warp_runs in runs:
        sizes = [u_hi - u_lo for u_lo, u_hi in warp_runs]
        assert max(sizes) - min(sizes) <= 1  # and every warp its share of the CTA's
        for u_lo, u_hi in warp_runs:
            u = u_lo
            while u < u_hi:  # as the kernel walks it: a run of rows in each column group it touches
                g, r0 = divmod(u, n)
                r1 = min(n, r0 + u_hi - u)
                seen[g, r0:r1] += 1
                u += r1 - r0
    assert (seen == 1).all()


@pytest.mark.parametrize("chunk", [1, 3, 1024])
@pytest.mark.parametrize("n", [3, 8, 13])
def test_in_place_2opt_is_the_plain_gather(n, chunk):
    rng = np.random.default_rng(n + chunk)
    EX = rng.uniform(-5, 5, (n, 4)).astype(F32)
    PF = (np.arange(n) | (rng.integers(0, 2, n) * FLIP)).astype(np.uint16)
    for i in range(n):
        for j in range(i, n):
            ex, pf = EX.copy(), PF.copy()
            apply_move(ex, pf, 0, i * n + j, chunk)
            want = gather_move(EX, PF, 0, i * n + j)
            assert np.array_equal(ex, want[0]) and np.array_equal(pf, want[1]), (i, j)


@pytest.mark.parametrize("fam", [1, 2])
@pytest.mark.parametrize("chunk", [1, 3, 1024])
@pytest.mark.parametrize("n", [3, 8, 13])
def test_in_place_relocate_is_the_plain_gather(n, chunk, fam):
    rng = np.random.default_rng(n + chunk + fam)
    EX = rng.uniform(-5, 5, (n, 4)).astype(F32)
    PF = (np.arange(n) | (rng.integers(0, 2, n) * FLIP)).astype(np.uint16)
    for i in range(n):
        for k in range(n + 1):
            if k in (i, i + 1):
                continue
            ex, pf = EX.copy(), PF.copy()
            apply_move(ex, pf, fam, i * (n + 1) + k, chunk)
            want = gather_move(EX, PF, fam, i * (n + 1) + k)
            assert np.array_equal(ex, want[0]) and np.array_equal(pf, want[1]), (i, k)


@pytest.mark.parametrize("fam", [0, 1, 2])
@pytest.mark.parametrize("n", [3, 9, 16])
def test_prologue_after_a_move_changes_only_beside_the_moved_slots(n, fam):
    rng = np.random.default_rng(10 * n + fam)
    start = np.array([3.5, -1.25], F32)
    EX = rng.uniform(-50, 50, (n, 4)).astype(F32)
    EG = prologue(EX, start)
    moves = [i * n + j for i in range(n) for j in range(i, n)] if fam == 0 else \
        [i * (n + 1) + k for i in range(n) for k in range(n + 1) if k not in (i, i + 1)]
    for flat in moves:
        ex, eg = EX.copy(), EG.copy()
        apply_move(ex, np.arange(n, dtype=np.uint16), fam, flat, 4)
        update_prologue(eg, ex, start, fam, flat)
        assert np.array_equal(eg.view(np.uint32), prologue(ex, start).view(np.uint32)), (fam, flat)


@pytest.mark.parametrize("impl", ["emulation", "plain"])
def test_dist_is_symmetric_bit_for_bit(impl):
    rng = np.random.default_rng(3)
    a = rng.uniform(-3000, 3000, (20000, 2)).astype(F32)
    b = np.where(rng.random((20000, 1)) < 0.1, a, rng.uniform(-3000, 3000, (20000, 2)).astype(F32))
    if impl == "plain":
        ab = trd._dist(torch.from_numpy(a), torch.from_numpy(b)).numpy()
        ba = trd._dist(torch.from_numpy(b), torch.from_numpy(a)).numpy()
    else:
        ab, ba = _dist(a, b), _dist(b, a)
    assert np.array_equal(ab.view(np.uint32), ba.view(np.uint32))


def test_minima_take_minus_zero_as_plus_zero():
    # a strict < along a column keeps the first of -0 and +0
    bv, bi = np.full(1, np.inf, F32), np.full(1, NO_INDEX, np.int64)
    for v, flat in ((F32(0.0), 7), (F32(-0.0), 9)):
        _take(np.ones(1, bool), np.array([v], F32), np.array([flat]), bv, bi)
    assert bi[0] == 7
    # across columns and lanes the keys: the lower index wins between -0 and +0
    assert min(_key(bv[0], bi[0]), _key(F32(-0.0), 3)) == _key(F32(0.0), 3)
    assert _key(F32(-0.0), 5) == _key(F32(0.0), 5) < _key(F32(0.0), 6) < _key(F32(1e-30), 0)
    assert _key(F32(-1.0), 9) < _key(F32(-0.0), 0) and _value(_key(F32(-2.5), 1)) == F32(-2.5)


def test_k10_shared_memory_fits_one_cta_at_the_largest_tour():
    n = trd.MAX_N
    EX = np.zeros((n, 4), F32)
    per_op = EX.nbytes + prologue(EX, np.zeros(2, F32)).nbytes + np.arange(n, dtype=np.uint16).nbytes
    assert per_op == 26 * n == 212992
    assert per_op + STATIC_SMEM <= kernels.MAX_SMEM == 232448
    assert n - 1 < FLIP  # the perm fits PF's low 15 bits beside the flip
