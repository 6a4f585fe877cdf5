"""Bit-exact replication of ``cv2.kmeans`` (KMEANS_PP_CENTERS path).

Copy of ``plotweave/ops/cvkmeans.py``, over the port's own native library
(``plotweave_torch/native``); the port imports nothing of ``plotweave``.
Keep the two files identical otherwise.

The reference clusters the Lab subsample with ``cv2.kmeans`` seeded by
OpenCV's thread-local ``theRNG()`` (reference 02_color_extract.py:46-49);
each pipeline step runs in a fresh subprocess, so the RNG always starts from
its default state 0xffffffff.  This module replays that computation exactly:

- ``CvRNG``: OpenCV's 64-bit multiply-with-carry RNG (state' = lo(state) *
  4164903690 + hi(state)), with the ``operator double()`` two-draw stream.
- ``generate_centers_pp``: kmeans++ seeding with 3 trials per center — the
  first center is ``next() % N``, then d²-weighted picks via a sequential
  ``p -= dist[i]`` scan (replicated exactly; see ``_pp_pick``).
- The Lloyd loop: float32 center accumulation in sample order, the
  empty-cluster fix (steal the farthest point of the biggest cluster,
  last-argmax tie-break), reciprocal-multiply scaling, double-precision
  max-center-shift, and the termination structure where an epsilon stop does
  NOT re-assign labels ("don't re-assign labels to avoid creation of empty
  clusters") — compactness is then the distance of the stale labels to the
  new centers.

Distances use OpenCV's scalar ``normL2Sqr_`` semantics for dims ≤ 3: float32
accumulation ``((t0² ) + t1²) + t2²`` (the SIMD paths need ≥ 4 lanes and are
never taken at dims == 3).  Verified byte-identical against live cv2 5.0
(``tests/test_cvkmeans.py`` oracle fuzz: centers, labels, and compactness).

A native C++ implementation (``pw_cv_kmeans``) carries the production path;
this file is the fuzz-tested fallback and the semantic documentation.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

CV_RNG_COEFF = 4164903690
_MASK64 = (1 << 64) - 1
_MASK32 = (1 << 32) - 1
DEFAULT_RNG_STATE = 0xFFFFFFFF  # cv::RNG::RNG() — fresh-process theRNG()


class CvRNG:
    """OpenCV's MWC RNG (core/include/opencv2/core.hpp RNG)."""

    __slots__ = ("state",)

    def __init__(self, state: int = DEFAULT_RNG_STATE):
        self.state = state & _MASK64

    def next32(self) -> int:
        self.state = ((self.state & _MASK32) * CV_RNG_COEFF + (self.state >> 32)) & _MASK64
        return self.state & _MASK32

    def to_double(self) -> float:
        t = self.next32()
        u = self.next32()
        return ((t << 32) | u) * 5.421010862427522e-20  # 2**-64


def _norml2sqr_rows(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise float32 normL2Sqr_ with scalar accumulation order."""
    t = (A - b[None, :]).astype(np.float32)
    d = np.zeros(A.shape[0], dtype=np.float32)
    for j in range(A.shape[1]):
        d = (d + t[:, j] * t[:, j]).astype(np.float32)
    return d


def _pp_pick(p: float, dist: np.ndarray, n: int) -> int:
    """``for ci in 0..N-2: p -= dist[ci]; if p <= 0: break`` — sequential
    double subtraction.  When every dist value is an exact small integer (the
    production case: Lab uint8 data → all d² are exact float32 integers and
    every partial sum < 2⁵³), the sequential stream equals ``p - cumsum`` and
    a vectorized search is exact; otherwise replay sequentially."""
    lim = n - 1
    if lim <= 0:
        return 0
    d = dist[:lim].astype(np.float64)
    csum = np.cumsum(d)
    if float(csum[-1]) < 2**53 and (d == np.rint(d)).all():
        hits = np.nonzero(p - csum <= 0)[0]
        return int(hits[0]) if hits.size else lim
    for i in range(lim):
        p -= float(dist[i])
        if p <= 0:
            return i
    return lim


def generate_centers_pp(data: np.ndarray, K: int, rng: CvRNG, trials: int = 3) -> np.ndarray:
    """OpenCV generateCentersPP (modules/core/src/kmeans.cpp).

    Exactness scope: trial costs are accumulated with ``np.sum`` (pairwise)
    while OpenCV and the native ``pw_centers_pp`` accumulate sequentially —
    identical whenever the squared distances are exactly representable
    (the uint8-Lab production data: all d² are integers), but on arbitrary
    float data a summation-order ulp can flip a trial pick.  Same scoping as
    the compactness note in :func:`cv_kmeans`."""
    N = data.shape[0]
    idx = np.empty(K, dtype=np.int64)
    idx[0] = rng.next32() % N
    dist = _norml2sqr_rows(data, data[idx[0]])
    sum0 = float(np.sum(dist, dtype=np.float64))

    for k in range(1, K):
        best_sum = np.inf
        best_center = -1
        best_tdist = dist
        for _ in range(trials):
            p = rng.to_double() * sum0
            ci = _pp_pick(p, dist, N)
            tdist2 = np.minimum(_norml2sqr_rows(data, data[ci]), dist)
            s = float(np.sum(tdist2, dtype=np.float64))
            if s < best_sum:
                best_sum = s
                best_center = ci
                best_tdist = tdist2
        if best_center < 0:
            raise RuntimeError("kmeans++ seeding failed")
        idx[k] = best_center
        sum0 = best_sum
        dist = best_tdist
    return data[idx].copy()


def _assign(data: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """KMeansDistanceComputer<false>: nearest center, first-wins ties."""
    N = data.shape[0]
    K = centers.shape[0]
    d2 = np.empty((N, K), dtype=np.float32)
    for k in range(K):
        d2[:, k] = _norml2sqr_rows(data, centers[k])
    return np.argmin(d2, axis=1).astype(np.int32)


def _only_distance(data: np.ndarray, centers: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """KMeansDistanceComputer<true>: distance to the already-assigned center."""
    d = np.empty(data.shape[0], dtype=np.float64)
    for k in range(centers.shape[0]):
        m = labels == k
        if m.any():
            d[m] = _norml2sqr_rows(data[m], centers[k]).astype(np.float64)
    return d


def _compute_centers(
    data: np.ndarray, labels: np.ndarray, K: int, old_centers: np.ndarray, it: int
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Center recomputation: float32 accumulation in sample order (np.add.at
    is an ordered unbuffered loop — matches the C accumulation), the
    empty-cluster fix, reciprocal-multiply scaling, double shift."""
    dims = data.shape[1]
    centers = np.zeros((K, dims), dtype=np.float32)
    np.add.at(centers, labels, data)
    counters = np.bincount(labels, minlength=K).astype(np.int64)

    for k in range(K):
        if counters[k] != 0:
            continue
        # steal the farthest member of the biggest cluster (first max wins);
        # "farthest" by float distance to the reciprocal-scaled center, with
        # `max_dist <= dist` updates → the LAST argmax wins
        max_k = int(np.argmax(counters))
        scale = np.float32(1.0) / np.float32(counters[max_k])
        base = centers[max_k]
        nbase = (base * scale).astype(np.float32)
        members = np.nonzero(labels == max_k)[0]
        dd = _norml2sqr_rows(data[members], nbase).astype(np.float64)
        far = members[dd.size - 1 - int(np.argmax(dd[::-1]))]
        counters[max_k] -= 1
        counters[k] += 1
        labels[far] = k
        sample = data[far]
        centers[max_k] = (base - sample).astype(np.float32)
        centers[k] = (centers[k] + sample).astype(np.float32)

    shift = 0.0
    for k in range(K):
        scale = np.float32(1.0) / np.float32(counters[k])
        centers[k] = (centers[k] * scale).astype(np.float32)
        if it > 0:
            t = centers[k].astype(np.float64) - old_centers[k].astype(np.float64)
            shift = max(shift, float(np.sum(t * t)))
    return centers, labels, shift


def _cv_kmeans_py(
    data: np.ndarray, K: int, max_count: int, epsilon: float, attempts: int, state: int
) -> Tuple[float, np.ndarray, np.ndarray]:
    N = data.shape[0]
    rng = CvRNG(state)
    epsilon = max(float(epsilon), 0.0) ** 2
    # cv2 clamps criteria.maxCount = min(max(maxCount, 2), 100)
    max_count = min(max(int(max_count), 2), 100)
    if K == 1:
        attempts = 1
        max_count = 2

    best_compactness = np.inf
    best_labels: Optional[np.ndarray] = None
    best_centers: Optional[np.ndarray] = None
    labels = np.zeros(N, dtype=np.int32)

    for _ in range(max(attempts, 1)):
        shift = np.inf
        centers: Optional[np.ndarray] = None
        it = 0
        while True:
            old = centers
            if it == 0:
                centers = generate_centers_pp(data, K, rng)
            else:
                centers, labels, shift = _compute_centers(data, labels, K, old, it)
            it += 1
            if it == max_count or shift <= epsilon:
                # epsilon stop does NOT re-assign labels (avoids empty clusters)
                dists = _only_distance(data, centers, labels)
                compactness = float(np.sum(dists, dtype=np.float64))
                break
            labels = _assign(data, centers)

        if compactness < best_compactness:
            best_compactness = compactness
            best_labels = labels.copy()
            best_centers = centers.copy()

    return best_compactness, best_labels, best_centers


def cv_kmeans(
    data: np.ndarray,
    K: int,
    max_count: int = 40,
    epsilon: float = 0.5,
    attempts: int = 3,
    state: int = DEFAULT_RNG_STATE,
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Drop-in for ``cv2.kmeans(data, K, None, (EPS+MAX_ITER, max_count,
    epsilon), attempts, cv2.KMEANS_PP_CENTERS)`` in a fresh process.

    Returns ``(compactness, labels[N] int32, centers[K, dims] float32)``.
    Centers and labels are bit-identical to cv2; compactness matches up to
    summation-order ulps (cv2 discards it too — 02_color_extract.py:47).
    """
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError("data must be (N, dims) float32")
    N, dims = data.shape
    if N < K:
        raise ValueError("need N >= K samples")

    from ..native.api import cv_kmeans_native  # noqa: PLC0415

    out = cv_kmeans_native(data, K, max_count, epsilon, attempts, state)
    if out is not None:
        return out
    return _cv_kmeans_py(data, K, max_count, epsilon, attempts, state)


def assign_labels(lab_u8: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """All-pixel nearest-center assignment with the reference's numpy
    semantics (02_color_extract.py:52-55): float32 ``((t0²+t1²)+t2²)``,
    argmin first-wins.  ``lab_u8`` is (N, dims) uint8, returns (N,) uint8."""
    from ..native.api import km_assign_native  # noqa: PLC0415

    lab_u8 = np.ascontiguousarray(lab_u8, dtype=np.uint8)
    centers = np.ascontiguousarray(centers, dtype=np.float32)
    out = km_assign_native(lab_u8, centers)
    if out is not None:
        return out
    n = lab_u8.shape[0]
    labels = np.empty(n, dtype=np.uint8)
    for lo in range(0, n, 1 << 20):  # chunked: bounds the (N, K) temporary
        chunk = lab_u8[lo : lo + (1 << 20)].astype(np.float32)
        d2 = np.zeros((chunk.shape[0], centers.shape[0]), dtype=np.float32)
        for j in range(lab_u8.shape[1]):
            t = (chunk[:, j : j + 1] - centers[None, :, j]).astype(np.float32)
            d2 = (d2 + t * t).astype(np.float32)
        labels[lo : lo + (1 << 20)] = np.argmin(d2, axis=1).astype(np.uint8)
    return labels
