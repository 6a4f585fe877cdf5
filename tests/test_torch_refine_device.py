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
- :func:`emulate_k10` repeats K10's whole loop in numpy float32 (the
  prologue from one ``edge`` array, every candidate as a 64-bit key of the
  delta's ordered bits and its flat index, per thread over the columns of a
  block's strided rows, warps, blocks, the partial minima, the family, the
  stop test and the gather of the move) at small block and thread counts,
  on tours with many equal deltas, and must give the plain version's perm,
  flips and moves, and each family's argmin over the flattened matrix.
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


def _d(a, b) -> np.float32:
    dx, dy = F32(a[0] - b[0]), F32(a[1] - b[1])
    return np.sqrt(F32(F32(dx * dx) + F32(dy * dy)))


def _key(v: np.float32, flat: int) -> int:
    u = int(np.array(F32(0.0) if v == 0 else v, F32).view(np.uint32))
    u = (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)
    return (u << 32) | flat


def _value(key: int) -> np.float32:
    u = key >> 32
    u = (u & 0x7FFFFFFF) if u & 0x80000000 else (~u & 0xFFFFFFFF)
    return np.array(u, np.uint32).view(F32)[()]


def emulate_k10(E, X, start, max_moves: int, blocks: int, threads: int, argmins=None):
    """K10 (``csrc/refine_tour.cu``) in numpy float32 with ``blocks`` blocks
    of ``threads`` threads (warps of up to 32); ``argmins`` collects each
    iteration's (c2, cf, cr)."""
    n = len(E)
    E, X = E.astype(F32).copy(), X.astype(F32).copy()
    start = np.asarray(start, F32)
    perm, flip = np.arange(n), np.zeros(n, bool)
    moves = 0
    while moves < max_moves:
        P = [start if t == 0 else X[t - 1] for t in range(n)]
        edge = [_d(P[t], E[t]) for t in range(n)]
        gain = [F32(F32(edge[t] + (edge[t + 1] if t < n - 1 else F32(0))) - (_d(P[t], E[t + 1]) if t < n - 1 else F32(0)))
                for t in range(n)]
        partial = []
        for b in range(blocks):
            lanes = [[NONE] * 3 for _ in range(threads)]
            for i in range(b, n, blocks):
                for c in range(n + 1):
                    lane = lanes[c % threads]
                    if c != i and c != i + 1:
                        Bk = start if c == 0 else X[c - 1]
                        tf = tr = base = F32(0)
                        if c < n:
                            tf, tr, base = _d(X[i], E[c]), _d(E[i], E[c]), edge[c]
                        flat = i * (n + 1) + c
                        lane[1] = min(lane[1], _key(F32(F32(F32(_d(E[i], Bk) + tf) - base) - gain[i]), flat))
                        lane[2] = min(lane[2], _key(F32(F32(F32(_d(X[i], Bk) + tr) - base) - gain[i]), flat))
                    if i <= c < n:
                        w = _d(E[i], E[c + 1]) if c < n - 1 else F32(0)
                        bj = edge[c + 1] if c < n - 1 else F32(0)
                        lane[0] = min(lane[0], _key(F32(F32(F32(_d(P[i], X[c]) + w) - edge[i]) - bj), i * n + c))
            warps = [[min(lane[f] for lane in lanes[w:w + 32]) for f in range(3)] for w in range(0, threads, 32)]
            partial.append([min(w[f] for w in warps) for f in range(3)])
        best_key = [min(p[f] for p in partial) for f in range(3)]
        if argmins is not None:
            argmins.append(tuple(k & 0xFFFFFFFF for k in best_key))
        vals = [_value(k) for k in best_key]
        fam, best = 0, vals[0]
        for f in (1, 2):
            if vals[f] < best:
                fam, best = f, vals[f]
        if not best < F32(-1e-2):
            break
        c = best_key[fam] & 0xFFFFFFFF
        src, swap = np.arange(n), np.zeros(n, bool)
        for t in range(n):
            if fam == 0:
                i, j = divmod(c, n)
                swap[t] = i <= t <= j
                src[t] = i + j - t if swap[t] else t
            else:
                i, k = divmod(c, n + 1)
                dest = k if k < i else k - 1
                src[t] = i if t == dest else t - 1 if dest < t <= i else t + 1 if i <= t < dest else t
                swap[t] = fam == 2 and t == dest
        e, x = E[src], X[src]
        E, X = np.where(swap[:, None], x, e), np.where(swap[:, None], e, x)
        perm, flip = perm[src], flip[src] ^ swap
        moves += 1
    return perm.tolist(), flip.tolist(), moves


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


@pytest.mark.parametrize("blocks,threads", [(1, 32), (3, 8), (5, 40)])
@pytest.mark.parametrize("kind", ["grid", "random"])
def test_k10_loop_emulated(kind, blocks, threads):
    E, X = tour(14, kind, seed=5)
    start = (100.0, 0.0)
    argmins = []
    got = emulate_k10(E, X, start, 4096, blocks, threads, argmins)
    assert got == plain_refine(E, X, 4096, start=start)
    assert argmins == _plain_argmins(E, X, start, 4096)
