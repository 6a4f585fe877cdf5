"""Artifact I/O: the on-disk contract (pickles, JSON, PNG) is the interface
between pipeline stages and with the reference's artifacts (SURVEY §1).

Copy of ``plotweave/utils/io.py``; the port imports nothing of ``plotweave``.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any

import numpy as np


def load_pickle(path: str) -> Any:
    # in-process handoff: a stage that just wrote this artifact registered
    # the live object; reuse it instead of re-decoding tens of MB from disk
    # (stat-validated — resume/rerun/external rewrites fall back to the file)
    obj = _fetch_pickle_handoff(path)
    if obj is not _HANDOFF_MISS:
        return obj
    with open(path, "rb") as f:
        return pickle.load(f)


class _FirstByteGuard:
    """Write-through proxy that replaces the stream's first byte with an
    invalid pickle opcode until :meth:`finish` restores it — so a save
    interrupted anywhere mid-dump leaves a loudly-invalid file instead of
    silently-wrong new-prefix+old-suffix bytes (save_pickle overwrites in
    place for tmpfs page reuse)."""

    def __init__(self, f):
        self._f = f
        self._first: bytes | None = None

    def write(self, b) -> int:
        if self._first is None:
            b = bytes(b)
            self._first = b[:1]
            self._f.write(b"\x00")
            if len(b) > 1:
                self._f.write(b[1:])
            return len(b)
        return self._f.write(b)

    def finish(self) -> None:
        if self._first is not None:
            self._f.seek(0)
            self._f.write(self._first)


def save_pickle(obj: Any, path: str) -> None:
    _save_pickle_sync(obj, path)


def _save_pickle_sync(obj: Any, path: str, fsync: bool = False) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # overwrite in place ("r+b") instead of truncating: O_TRUNC frees the
    # file's tmpfs pages, so a re-run into the same output dir re-pays page
    # allocation for tens of MB per artifact — at this host's episodic
    # page-fault cost (measured up to ~55 ms/MB in bad phases) that was
    # the single largest stage cost on the 4K poster (pickle.dump measured
    # 1.2–2.8 s per stage mid-phase).  Writing over existing pages is a
    # plain memcpy; the trailing truncate only trims if the new dump is
    # shorter.  File bytes are identical either way.
    mode = "r+b" if os.path.isfile(path) else "wb"
    try:
        f = open(path, mode)
    except OSError:
        f = open(path, "wb")
    with f:
        # protocol 5: ndarray buffers serialize without the tobytes() copy
        # (measured 0.53 → 0.33 s on a 60 MB spun-layer contour list; four
        # stages dump one of these per 4K layer).  Artifact equality is
        # semantic (tests load both sides), not byte-of-pickle.
        #
        # Crash consistency: overwrite-in-place could leave new-prefix +
        # old-suffix bytes that UNPICKLE WITHOUT ERROR to wrong data.  The
        # guard below holds the first byte back as an invalid opcode
        # (\x00) for the whole dump and only restores the real first byte
        # (\x80, PROTO) after the truncate — any interrupted save leaves a
        # file that pickle.load rejects loudly at byte 0.
        guard = _FirstByteGuard(f)
        pickle.dump(obj, guard, protocol=5)
        f.truncate()
        guard.finish()
        if fsync:  # write-behind path: durable before the flush barrier returns
            f.flush()
            os.fsync(f.fileno())
    # the file on disk stays the source of truth; the registry only skips
    # the redundant re-read while the signature matches.  Consumers must
    # treat loaded artifacts as immutable (they already do — every stage
    # builds new arrays), because a later load_pickle may hand out the
    # same object again.
    _register_pickle_handoff(path, obj)


def load_json(path: str) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def save_json(obj: Any, path: str, indent: int = 2) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=indent)


def read_image(path: str, gray: bool = False) -> np.ndarray:
    import cv2  # noqa: PLC0415

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return img


def write_image(path: str, img: np.ndarray) -> None:
    import cv2  # noqa: PLC0415

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not cv2.imwrite(path, np.asarray(img)):
        raise IOError(f"cannot write image: {path}")


# --------------------------------------------------------------- handoff
#
# In-process device-artifact handoff: when consecutive stages run in one
# process, the producing stage registers the device-resident array backing a
# just-written image artifact, and the consumer fetches it instead of
# re-uploading the file over the (slow, high-variance) host↔device link.
# The on-disk artifact remains the source of truth: entries are validated
# against the file's (mtime_ns, size) signature, so any resume, rerun, or
# external rewrite falls back to disk reads with identical bytes.

import threading  # noqa: E402
from collections import OrderedDict  # noqa: E402

_DEVICE_HANDOFF: "OrderedDict[str, tuple]" = OrderedDict()
_DEVICE_HANDOFF_CAP = 24
_DEVICE_HANDOFF_LOCK = threading.Lock()  # batch mode runs stages from threads


def _stat_sig(path: str):
    st = os.stat(path)
    return (st.st_mtime_ns, st.st_size)


# Host pickle handoff: same contract as the device registry below, for the
# vector-stage artifacts (contours/lines pickles reach ~60 MB per layer at
# 4K; each inter-stage disk round trip costs real time on this host).
#
# Eviction is BYTE-budgeted, not just entry-counted: a single 4K run
# registers ~40 entries where the spun layers are ~60 MB each, so a pure
# entry cap left the PREVIOUS run's arrays pinned across runs — which
# blocks glibc's warm-heap reuse (plotweave/__init__ raises the trim
# threshold precisely so freed big buffers are recycled) and re-exposes
# every run to the host's episodic first-touch page-fault cost.
_PICKLE_HANDOFF: "OrderedDict[str, tuple]" = OrderedDict()
_PICKLE_HANDOFF_CAP = 64
_PICKLE_HANDOFF_BYTE_CAP = 512 * 1024 * 1024
_PICKLE_HANDOFF_BYTES = [0]
_HANDOFF_MISS = object()
# signature marker for write-behind entries whose disk bytes are still queued
_PENDING_SIG = ("__pw_pending__",)


def _approx_nbytes(obj, _depth: int = 3) -> int:
    """Rough ndarray payload size of a stage artifact.  Recurses through
    lists/tuples/dict values to a small depth cap so list-of-dicts-of-arrays
    shapes (contour lists — exactly the large artifacts the byte budget
    exists to evict) are counted, not registered as 0 bytes."""
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if _depth <= 0:
        return 0
    if isinstance(obj, (list, tuple)):
        return sum(_approx_nbytes(a, _depth - 1) for a in obj)
    if isinstance(obj, dict):
        return sum(_approx_nbytes(a, _depth - 1) for a in obj.values())
    return 0


def _register_pickle_handoff(path: str, obj) -> None:
    try:
        sig = _stat_sig(path)
    except OSError:
        return
    key = os.path.abspath(path)
    nb = _approx_nbytes(obj)
    with _DEVICE_HANDOFF_LOCK:
        old = _PICKLE_HANDOFF.get(key)
        if old is not None and old[0] is _PENDING_SIG and old[1] is not obj:
            # a newer write-behind save owns this path; the older dump (this
            # call, from the writer thread) must not clobber its registration
            return
        old = _PICKLE_HANDOFF.pop(key, None)
        if old is not None:
            _PICKLE_HANDOFF_BYTES[0] -= old[2]
        _PICKLE_HANDOFF[key] = (sig, obj, nb)
        _PICKLE_HANDOFF_BYTES[0] += nb
        # evict oldest NON-PENDING entries: a pending entry's file bytes are
        # not on disk yet, so evicting it would send a consumer to a stale /
        # missing file — it becomes evictable once the writer re-registers it
        evictable = [k for k, v in _PICKLE_HANDOFF.items() if v[0] is not _PENDING_SIG]
        for k in evictable:
            if (
                len(_PICKLE_HANDOFF) <= _PICKLE_HANDOFF_CAP
                and _PICKLE_HANDOFF_BYTES[0] <= _PICKLE_HANDOFF_BYTE_CAP
            ):
                break
            _, _, enb = _PICKLE_HANDOFF.pop(k)
            _PICKLE_HANDOFF_BYTES[0] -= enb


def _fetch_pickle_handoff(path: str):
    key = os.path.abspath(path)
    with _DEVICE_HANDOFF_LOCK:
        ent = _PICKLE_HANDOFF.get(key)
    if ent is None:
        return _HANDOFF_MISS
    if ent[0] is _PENDING_SIG:
        # write-behind entry: the dump is queued/in-flight, so the live
        # object IS the file's future contents — fresh by construction
        return ent[1]
    try:
        fresh = _stat_sig(path) == ent[0]
    except OSError:
        fresh = False
    with _DEVICE_HANDOFF_LOCK:
        if not fresh:
            stale = _PICKLE_HANDOFF.pop(key, None)
            if stale is not None:
                _PICKLE_HANDOFF_BYTES[0] -= stale[2]
            return _HANDOFF_MISS
        if key in _PICKLE_HANDOFF:
            _PICKLE_HANDOFF.move_to_end(key)
    return ent[1]


# ---------------------------------------------------------------- write-behind
#
# The vector stages' artifact contract costs more than their algorithms on
# this host (bench_s04_split: stage 04's trace is 0.27 s; the ~60 MB
# layer_light contours.pkl dump is most of the rest).  When a stage runs
# inside a pipeline chain, the dump can happen on a background writer thread
# while the pipeline proceeds — the in-process consumer gets the LIVE object
# from the handoff registry immediately (marked pending until the bytes are
# on disk), and run_pipeline flushes every queued write before returning, so
# the on-disk resume/oracle contract is untouched.  Crash consistency is the
# same _FirstByteGuard story as the synchronous path: an interrupted dump
# leaves a file pickle.load rejects at byte 0.
# Reference contract being kept: 04_find_contours.py:224-229 (contours.pkl
# on disk before the next step starts — here, before run_pipeline returns).


class _AsyncPickleWriter:
    """Single background writer (FIFO); one per process, started lazily."""

    def __init__(self):
        import queue  # noqa: PLC0415

        self._q: "queue.Queue" = queue.Queue()
        self._thread = None
        self._lock = threading.Lock()
        self._errors: list = []

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._loop, name="pw-pickle-writer", daemon=True
                )
                self._thread.start()

    def _loop(self) -> None:
        while True:
            obj, path = self._q.get()
            try:
                # superseded by a newer write-behind save to the same path?
                # skip — dumping the older object would transiently restore a
                # VALID-but-stale file over the newer save's invalid marker
                key = os.path.abspath(path)
                with _DEVICE_HANDOFF_LOCK:
                    ent = _PICKLE_HANDOFF.get(key)
                    superseded = (
                        ent is not None and ent[0] is _PENDING_SIG and ent[1] is not obj
                    )
                if not superseded:
                    _save_pickle_sync(obj, path, fsync=True)
            except BaseException as e:  # noqa: BLE001 — re-raised at flush
                with self._lock:
                    self._errors.append((path, e))
            finally:
                self._q.task_done()

    def submit(self, obj: Any, path: str) -> None:
        self._ensure_thread()
        self._q.put((obj, path))

    def flush(self, scope: str | None = None) -> None:
        """Block until every queued dump is durably on disk; re-raise the
        first writer error (a silent lost artifact would corrupt resume).

        ``scope``: only errors for paths under this directory are raised here
        — the batch runner's per-image pipelines share one writer, and image
        A's dump failure must fail image A's run_pipeline, not whichever
        image happened to flush next (errors outside the scope stay queued
        for their own pipeline's flush)."""
        if self._thread is None:
            return
        self._q.join()
        if not self._errors:
            return
        with self._lock:
            if scope is None:
                mine = list(self._errors)
                self._errors.clear()
            else:
                pref = os.path.join(os.path.abspath(scope), "")
                mine = [t for t in self._errors
                        if os.path.abspath(t[0]).startswith(pref)]
                for t in mine:
                    self._errors.remove(t)
        if mine:
            path, e = mine[0]
            raise RuntimeError(f"write-behind save of {path} failed: {e}") from e


_ASYNC_WRITER = _AsyncPickleWriter()


def save_pickle_async(obj: Any, path: str) -> None:
    """Write-behind :func:`save_pickle`: registers the live object for
    in-process handoff NOW (pending signature) and dumps the bytes on the
    background writer.  Callers inside run_pipeline rely on its finally
    calling :func:`flush_pending_saves` before any resume/--end-step
    boundary; standalone callers must flush themselves."""
    # The artifact path must EXIST the moment this returns: downstream stages
    # gate on os.path.exists before consulting the registry (s05/s07/s08
    # skip-if-missing semantics), so a not-yet-dumped file would silently
    # drop layers.  Make it exist AND loudly invalid (first byte \x00, the
    # _FirstByteGuard convention) until the writer's dump completes — a crash
    # before then fails pickle.load at byte 0 instead of resuming from a
    # stale previous artifact.
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "r+b" if os.path.isfile(path) else "wb") as f:
        f.write(b"\x00")
    key = os.path.abspath(path)
    nb = _approx_nbytes(obj)
    with _DEVICE_HANDOFF_LOCK:
        old = _PICKLE_HANDOFF.pop(key, None)
        if old is not None:
            _PICKLE_HANDOFF_BYTES[0] -= old[2]
        _PICKLE_HANDOFF[key] = (_PENDING_SIG, obj, nb)
        _PICKLE_HANDOFF_BYTES[0] += nb
        # NOTE: no byte-budget eviction of a pending entry — it must stay
        # fetchable until its bytes are on disk (the writer re-registers
        # with the real stat signature on completion)
    _ASYNC_WRITER.submit(obj, path)


def flush_pending_saves(scope: str | None = None) -> None:
    """Barrier: every save_pickle_async dump is on disk (fsynced) or an
    error is raised.  run_pipeline calls this before returning, scoped to
    its own output_dir so concurrent batch pipelines get their OWN dump
    failures (a global raise would misattribute image A's disk error to
    whichever image flushed next)."""
    _ASYNC_WRITER.flush(scope)


def register_device_artifact(path: str, arr) -> None:
    """Associate a device array with an already-written artifact file."""
    try:
        sig = _stat_sig(path)
    except OSError:
        return
    key = os.path.abspath(path)
    with _DEVICE_HANDOFF_LOCK:
        _DEVICE_HANDOFF.pop(key, None)
        _DEVICE_HANDOFF[key] = (sig, arr)
        while len(_DEVICE_HANDOFF) > _DEVICE_HANDOFF_CAP:
            _DEVICE_HANDOFF.popitem(last=False)


def fetch_device_artifact(path: str):
    """Device array registered for ``path``, or None if absent/stale."""
    key = os.path.abspath(path)
    with _DEVICE_HANDOFF_LOCK:
        ent = _DEVICE_HANDOFF.get(key)
    if ent is None:
        return None
    try:
        fresh = _stat_sig(path) == ent[0]
    except OSError:
        fresh = False
    with _DEVICE_HANDOFF_LOCK:
        if not fresh:
            _DEVICE_HANDOFF.pop(key, None)
            return None
        if key in _DEVICE_HANDOFF:
            _DEVICE_HANDOFF.move_to_end(key)
    return ent[1]


def thread_map(fn, items, cap: int = 8) -> list:
    """Ordered ``pool.map`` over ``items`` with ``min(cap, len(items),
    cpu_count)`` workers (the shared worker-sizing policy for per-layer stage
    work — PNG encodes, tracing, renders all release the GIL).  Runs inline
    below 2 workers.

    The cpu_count clamp matters: every call site's body is pure host compute
    (no device waits to overlap), so extra threads can only lose — and on the
    1-core bench host they lose catastrophically: 8 tracers first-touching
    fresh multi-MB walk buffers concurrently serialize on the kernel's mmap
    lock (measured: 8-layer 4K trace 0.9 s sequential vs 23–105 s under an
    8-thread pool, the spread depending on how warm the malloc arenas are)."""
    items = list(items)
    workers = min(cap, len(items), max(1, os.cpu_count() or 1))
    if workers <= 1:
        return [fn(x) for x in items]
    from concurrent.futures import ThreadPoolExecutor  # noqa: PLC0415

    with ThreadPoolExecutor(max_workers=workers) as pool:
        return list(pool.map(fn, items))


# Derived artifacts: device/host values computed from one or more source
# files (e.g. stage 02 speculatively computes stage 03/04's device work in
# the same fused program).  An entry is valid only while EVERY source file's
# (mtime_ns, size) signature is unchanged; the key also encodes the params
# of the derivation.

_DERIVED: "OrderedDict[str, tuple]" = OrderedDict()
_DERIVED_CAP = 16


def register_derived_artifact(key: str, sources, value) -> None:
    try:
        sigs = tuple(_stat_sig(p) for p in sources)
    except OSError:
        return
    with _DEVICE_HANDOFF_LOCK:
        _DERIVED.pop(key, None)
        _DERIVED[key] = (tuple(os.path.abspath(p) for p in sources), sigs, value)
        while len(_DERIVED) > _DERIVED_CAP:
            _DERIVED.popitem(last=False)


def fetch_derived_artifact(key: str, pop: bool = False):
    """``pop=True`` releases the entry on a successful fetch — fused-chain
    blobs are single-consumer and can be tens of MB at 4K, so consumers
    should not leave them pinned in the registry."""
    with _DEVICE_HANDOFF_LOCK:
        ent = _DERIVED.get(key)
    if ent is None:
        return None
    paths, sigs, value = ent
    try:
        fresh = all(_stat_sig(p) == s for p, s in zip(paths, sigs))
    except OSError:
        fresh = False
    with _DEVICE_HANDOFF_LOCK:
        if not fresh:
            _DERIVED.pop(key, None)
            return None
        if pop:
            _DERIVED.pop(key, None)
        elif key in _DERIVED:
            _DERIVED.move_to_end(key)
    return value
