"""Stage 12's 2-opt ⊕ relocation refiner on the card: K10 and its plain version.

Counterpart of ``plotweave/vector/refine_device.py`` (its ``_refine_impl``);
the port imports nothing of ``plotweave``.

The host refiner (``vector/planner.py``) scans O(n²) candidate moves in
Python per pass: fine for the op counts of typical runs (tens), a stall of
minutes at poster scale (thousands).  Here one iteration evaluates EVERY
candidate move, applies the single best one, and loops until no move
shortens the pen-up travel by more than :data:`MIN_GAIN` or ``max_moves`` are
spent:

- **2-opt(i, j)**: reverse ops [i..j] (each op flips orientation).  Only the
  two boundary travel edges change, so
  ``delta = d(P[i], X[j]) + d(E[i], N[j]) - d(P[i], E[i]) - d(X[j], N[j])``
  with P[i] = previous exit (pen start for i=0) and N[j] = next entry
  (absent for the last op).
- **relocate(i → k, rev)**: move op i (optionally reversed) to sit before
  op k.  ``delta = insertion(k, rev) - removal_gain(i)``, three edges change.

Both move families preserve the pen-down geometry exactly: only order and
orientation change, the contract of the host refiner.  There is NO parity
with the host refiner (it is another search), as in the JAX package;
:func:`refine_ops_device` re-checks the tour length in float64 on the host
and keeps the original ops where the float32 pass did not shorten it.  K10
(``csrc/refine_tour.cu``) and :func:`refine_order_plain` evaluate every delta
in one operation order, so they give the same perm, flips and move count.

Nothing is padded to a bucket; the limits stay the JAX package's: a tour of
fewer than 3 or more than :data:`MAX_N` ops is not taken (``None``), and its
caller runs the host refiner.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .planner_device import to_device

MAX_N = 8192  # the JAX package's largest bucket

# a move must shorten pen-up travel by at least this many pixels to be
# applied — also the float32 noise floor for the matrix evaluation
MIN_GAIN = 1e-2


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    dx, dy = d[..., 0], d[..., 1]
    return torch.sqrt(dx * dx + dy * dy)


def refine_order_plain(E: torch.Tensor, X: torch.Tensor, start: torch.Tensor, max_moves: int):
    """The plain version of K10: (perm (n,) int32, flip (n,) bool, moves) of
    the refined tour over (n, 2) float32 entries ``E`` and exits ``X`` in
    tour order from the pen's ``start`` (2,), on their device.  The JAX
    body as tensor code, one Python iteration a move, with its families,
    masks, flat first-minimum argmins and ``fam`` as the first minimum of
    (2-opt, relocate forward, relocate reversed)."""
    n = E.shape[0]
    dev = E.device
    idx = torch.arange(n, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    big = torch.tensor(1e30, dtype=torch.float32, device=dev)
    stop = torch.tensor(-MIN_GAIN, dtype=torch.float32, device=dev)
    has_next = idx < n - 1  # the last op has no next edge
    ok2 = idx[:, None] <= idx[None, :]
    slot = torch.arange(n + 1, device=dev)
    slot_real = slot <= n - 1  # slots 0..n-1 sit before an op, slot n appends after the last
    okr = (slot[None, :] != idx[:, None]) & (slot[None, :] != idx[:, None] + 1)
    perm = idx.to(torch.int32)
    flip = torch.zeros(n, dtype=torch.bool, device=dev)
    moves = 0
    while moves < max_moves:
        P = torch.cat([start[None], X[:-1]])  # P[i]: exit before op i
        N = torch.cat([E[1:], E[-1:]])  # N[j]: entry after op j
        a_edge = _dist(P, E)  # current edge into op i
        b_edge = torch.where(has_next, _dist(X, N), zero)  # current edge out of op j

        # ---- 2-opt: reverse [i..j], i <= j (i == j = flip one op in place)
        d_px = _dist(P[:, None, :], X[None, :, :])
        d_en = _dist(E[:, None, :], N[None, :, :])
        delta2 = d_px + torch.where(has_next[None, :], d_en, zero) - a_edge[:, None] - b_edge[None, :]
        delta2 = torch.where(ok2, delta2, big)

        # ---- relocate: move op i before slot k (k in 0..n, k != i, i+1)
        gain_rm = a_edge + b_edge - torch.where(has_next, _dist(P, N), zero)
        B = torch.cat([start[None], X])  # (n+1, 2): the exit feeding slot k
        A = torch.cat([E, E[-1:]])  # (n+1, 2): the entry at slot k; A[n] unused
        base = torch.where(slot_real, _dist(B, A), zero)  # the edge an insertion splits
        d_bh = _dist(E[:, None, :], B[None, :, :])  # forward head
        d_xh = _dist(X[:, None, :], B[None, :, :])  # reversed head
        d_ta = _dist(X[:, None, :], A[None, :, :])  # forward tail
        d_ea = _dist(E[:, None, :], A[None, :, :])  # reversed tail
        ins_f = d_bh + torch.where(slot_real[None, :], d_ta, zero) - base[None, :]
        ins_r = d_xh + torch.where(slot_real[None, :], d_ea, zero) - base[None, :]
        delta_f = torch.where(okr, ins_f - gain_rm[:, None], big)
        delta_r = torch.where(okr, ins_r - gain_rm[:, None], big)

        # ---- the single best move across the three families
        c = [torch.argmin(m) for m in (delta2, delta_f, delta_r)]  # over the flattened matrices: first minimum
        vals = torch.stack([m.reshape(-1)[k] for m, k in zip((delta2, delta_f, delta_r), c)])
        fam = int(torch.argmin(vals))
        if not bool(vals[fam] < stop):
            break
        if fam == 0:
            i, j = divmod(int(c[0]), n)
            inseg = (idx >= i) & (idx <= j)  # positions i..j reverse and each op flips
            src = torch.where(inseg, i + j - idx, idx)
            E, X = (torch.where(inseg[:, None], X[src], E[src]), torch.where(inseg[:, None], E[src], X[src]))
            perm, flip = perm[src], flip[src] ^ inseg
        else:
            i, k = divmod(int(c[fam]), n + 1)
            dest = k if k < i else k - 1  # where the moved op lands
            src = torch.where((idx > dest) & (idx <= i), idx - 1, torch.where((idx >= i) & (idx < dest), idx + 1, idx))
            src = torch.where(idx == dest, i, src)
            swap = (idx == dest) & (fam == 2)
            nE, nX = E[src], X[src]
            E, X = torch.where(swap[:, None], nX, nE), torch.where(swap[:, None], nE, nX)
            perm, flip = perm[src], flip[src] ^ swap
        moves += 1
    return perm, flip, moves


def refine_order_device(
    entries: np.ndarray,
    exits: np.ndarray,
    start: Tuple[float, float] = (0.0, 0.0),
    max_moves: int = 4096,
    *,
    device,
) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
    """(perm, flip, n_moves) refining the tour over nodes with the given
    entry/exit points on ``device``: K10 on a CUDA device, the plain version
    on the CPU; None for fewer than 3 or more than :data:`MAX_N` nodes (the
    caller keeps the host path)."""
    n = len(entries)
    if n < 3 or n > MAX_N:
        return None
    E, X, st = to_device(device, np.asarray(entries, np.float32).reshape(n, 2),
                         np.asarray(exits, np.float32).reshape(n, 2), np.asarray(start, np.float32).reshape(2))
    if E.is_cuda:
        from ..ops.kernels import refine_order_cuda  # noqa: PLC0415

        perm, flip, moves = refine_order_cuda(E, X, st.tolist(), int(max_moves))
        moves = int(moves.item())
    else:
        perm, flip, moves = refine_order_plain(E, X, st, int(max_moves))
    return perm.cpu().numpy(), flip.cpu().numpy(), moves


def refine_ops_device(ops: List[dict], max_moves: int = 4096, *, device) -> Optional[List[dict]]:
    """Device-refined reordering of a stage-12 op list (see planner.refine_tour).

    Returns None outside 3 to :data:`MAX_N` ops (callers run the host
    refiner).  Geometry is preserved exactly: the result is a permutation of
    the input ops with some line ops reversed.  The tour length is re-verified
    on host in float64 — if the float32 pass did not strictly improve it, the
    original list is returned unchanged (never worse)."""
    from .planner import _op_entry, _op_exit, _op_flip, tour_length  # noqa: PLC0415

    if len(ops) < 3:
        return None
    entries = np.array([_op_entry(o) for o in ops], np.float32)
    exits = np.array([_op_exit(o) for o in ops], np.float32)
    r = refine_order_device(entries, exits, max_moves=max_moves, device=device)
    if r is None:
        return None
    perm, flip, _moves = r
    out = [_op_flip(ops[int(p)]) if f else ops[int(p)] for p, f in zip(perm, flip)]
    if tour_length(out) >= tour_length(ops):
        return list(ops)
    return out
