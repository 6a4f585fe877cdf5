"""Grouped chain calls for the batch runner (twin of
``plotweave/parallel/batchrun.py``).

The batch runner's host threads already overlap one image's host stages with
the others' device work, but each image's fused 02→04 chain would still pay
its own upload, four kernel launches and download.  This module groups the
chain calls that arrive from concurrent worker threads into ONE call over a
leading batch dimension (``stages/s02_color_extract.py::chain_blob_batch``):
the kernels take the images as more layers, so one upload, one launch
sequence and one download carry the whole group, and each image's row is
byte-equal to its solo call (all chain compute is integer).

Scheduling is CONTINUOUS BATCHING (the inference-server pattern), as in the
JAX package: a single dispatcher thread owns the device; whenever it is free
it takes every pending submission for one (shape, params) key and runs
them as one grouped call.  Submissions that arrive while a call is in
flight simply accumulate — groups therefore grow exactly when the device is
the bottleneck and stay small when it is not, with no tuning.  Host work
keeps flowing on the worker threads throughout.  A short accumulation guard
(group ≥ live-worker capacity, all live workers parked, or a small linger)
batches the opening group before the pipeline has warmed.

The group runs over the mesh's ``data`` axis, as the JAX package's
``shard_map`` does: it is split over the axis's devices, one
``chain_blob_batch`` call each (on a card, its kernels), and the rows are
gathered into host memory.  A mesh may name one card more than once.  What
differs from the JAX package: no cache of compiled programs, and groups are
NOT padded.  The JAX batcher pads a group to a power of two a device by
repeating its first image only to bound the number of XLA compiles, one per
distinct batch shape; PyTorch runs eagerly and the kernels take any layer
count, so a group of five over two devices runs as three and two.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .mesh import data_sharding

_ACTIVE: Optional["DeviceBatcher"] = None
_ACTIVE_LOCK = threading.Lock()


def active_batcher() -> Optional["DeviceBatcher"]:
    """The batcher installed by the current ``run_pipeline_batch`` run, if
    any (consulted by stage 02 before its solo chain call)."""
    return _ACTIVE


@contextlib.contextmanager
def batcher_ctx(batcher: "DeviceBatcher"):
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a DeviceBatcher is already active")
        _ACTIVE = batcher
    try:
        yield batcher
    finally:
        with _ACTIVE_LOCK:
            _ACTIVE = None
        batcher.close()


class DeviceBatcher:
    """Continuous-batching dispatcher turning concurrent per-image chain
    submissions into grouped chain calls.  Thread-safe; one per batch run;
    owns a single dispatcher thread, so at most one grouped call is ever in
    flight."""

    def __init__(self, mesh, n_workers: int, n_images: int, linger_s: float = 0.2):
        self.mesh = mesh
        self._sharding = data_sharding(mesh)
        self._workers = max(1, int(n_workers))
        self._images_left = int(n_images)
        self._cv = threading.Condition()
        # key -> list of [arr, result_slot]; slot = [result, error]
        self._pending: Dict[tuple, List[list]] = {}
        self._deadline: Dict[tuple, float] = {}
        self._linger = float(linger_s)
        self._inflight = 0          # submissions popped but not yet delivered
        self._current: Optional[List[list]] = None  # group owned by _dispatch
        self._shutdown = False
        self._thread: Optional[threading.Thread] = None
        self.n_dispatches = 0
        self.n_batched_images = 0

    # ---- lifecycle bookkeeping (called by the batch runner) ----
    def image_finished(self) -> None:
        """One image's pipeline completed (or failed): shrinks the capacity
        bound so trailing groups don't wait for submitters that can never
        arrive."""
        with self._cv:
            self._images_left -= 1
            self._cv.notify_all()

    def close(self) -> None:
        """Stop the dispatcher thread (drains any pending groups first)."""
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
            t = self._thread
        if t is not None:
            t.join()

    def _capacity(self) -> int:
        return max(1, min(self._workers, self._images_left))

    # ---- the stage-02 entry point ----
    def run_chain(self, packed_np: np.ndarray, w: int, params: Tuple[int, ...]) -> np.ndarray:
        """(k, H, ⌈W/8⌉) uint8 packed CLEANED masks → flat uint8 blob
        [packed edges][packed skeletons], identical to stage 02's solo
        ``chain_from_clean`` download.  Blocks until the dispatcher has run
        this submission's group."""
        key = (packed_np.shape, int(w), tuple(int(p) for p in params))
        slot = [None, None]
        with self._cv:
            if self._shutdown:
                raise RuntimeError("DeviceBatcher is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="pw-batch-dispatch", daemon=True
                )
                self._thread.start()
            group = self._pending.setdefault(key, [])
            group.append([packed_np, slot])
            if len(group) == 1:
                self._deadline[key] = time.monotonic() + self._linger
            self._cv.notify_all()
            while slot[0] is None and slot[1] is None:
                self._cv.wait()
        if slot[1] is not None:
            raise slot[1]
        return slot[0]

    # ---- dispatcher thread ----
    def _pick_key(self) -> Optional[tuple]:
        """Expired-linger groups first (largest of those), else the largest
        pending group; ties broken by oldest linger deadline.  Preferring
        expired keys keeps a small group whose window has passed from being
        parked behind a larger still-lingering one."""
        now = time.monotonic()
        best = None
        for key, group in self._pending.items():
            c = (now >= self._deadline[key], len(group), -self._deadline[key])
            if best is None or c > best[0]:
                best = (c, key)
        return None if best is None else best[1]

    def _loop(self) -> None:
        try:
            self._loop_inner()
        finally:
            # fail-safe: if this thread exits while submissions are pending or
            # in flight (only possible via an unexpected error — _dispatch
            # scatters its own exceptions), waiters must not hang forever, and
            # later run_chain calls must raise instead of parking behind a
            # dead thread.
            with self._cv:
                self._shutdown = True
                groups = list(self._pending.values())
                groups.append(self._current or [])
                for group in groups:
                    for _, slot in group:
                        if slot[0] is None and slot[1] is None:
                            slot[1] = RuntimeError("batch dispatcher exited")
                self._pending.clear()
                self._current = None
                self._inflight = 0
                self._cv.notify_all()

    def _loop_inner(self) -> None:
        while True:
            with self._cv:
                while True:
                    key = self._pick_key()
                    if key is None:
                        if self._shutdown:
                            return
                        self._cv.wait()
                        continue
                    npend = len(self._pending[key])
                    # every submitter is parked on its slot, so pending +
                    # in-flight ≥ capacity means no further submission can
                    # arrive until results flow — batch what's here now.
                    parked = self._inflight + sum(len(g) for g in self._pending.values())
                    now = time.monotonic()
                    if (
                        npend >= self._capacity()
                        or parked >= self._capacity()
                        or now >= self._deadline[key]
                        or self._shutdown
                    ):
                        batch = self._pending.pop(key)
                        self._deadline.pop(key, None)
                        self._inflight += len(batch)
                        self._current = batch
                        break
                    # time the wait against the EARLIEST deadline across all
                    # pending keys — a small group whose linger has expired
                    # must not be held for the largest group's full window
                    soonest = min(self._deadline.values())
                    self._cv.wait(timeout=max(0.01, soonest - now))
            # the device round trip runs with the lock RELEASED: holding it
            # would stall submissions, linger bookkeeping and
            # image_finished().  Arrivals during the flight accumulate into
            # the next group.
            self._dispatch(key, batch)

    def _dispatch(self, key, batch: List[list]) -> None:
        """Stack the group to (B, k, H, ⌈W/8⌉), split it over the mesh's
        data devices, make one chain call on each (launched all before the
        first download), gather the rows into host memory and scatter them.

        Called from the dispatcher thread with the condition lock RELEASED;
        the batch list is private to this thread and waiters re-check their
        slots under the lock on notify."""
        from ..stages.s02_color_extract import chain_blob_batch  # noqa: PLC0415

        b = len(batch)
        try:
            _shape, w, params = key
            parts = [chain_blob_batch(part, w, *params, device=dev)
                     for dev, part in self._sharding.split(np.stack([a for a, _ in batch]))]
            out = self._sharding.gather(parts, "cpu").numpy()
        except Exception as ex:  # noqa: BLE001 — deliver to every waiter
            with self._cv:
                for _, slot in batch:
                    slot[1] = ex
                self._inflight -= b
                self._current = None
                self._cv.notify_all()
        else:
            with self._cv:
                for (_, slot), row in zip(batch, out):
                    slot[0] = row
                self._inflight -= b
                self._current = None
                self.n_dispatches += 1
                self.n_batched_images += b
                self._cv.notify_all()
