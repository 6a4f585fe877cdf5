"""K1's packed-row kernels (``csrc/bitpack.cu``) emulated in numpy, on the CPU.

``rows_to_boards`` and ``boards_to_rows`` convert between packed rows (8 px
a byte, MSB first) and bitboards; ``dense_to_rows_bytes`` /
``dense_to_rows_words`` (``bitpack_rows``) and ``rows_to_dense``
(``bitunpack_rows``) go straight between pixels and packed rows, one launch
each.  No CUDA runs here, so a fake library takes the place of the built one
under the real wrappers (card tensors mocked by ``tests/mocked_cards.py``,
``_guard`` and the current stream patched): its C entries receive the very
pointers and arguments the real ones receive, and repeat the kernels warp
by warp:

- each warp's run of 32 U words (U = 4 for rows ↔ boards, ``kLaneWords``,
  else 1; lane l words i0 + U l to i0 + U l + U − 1, j wrapping at the row's
  end, a lane past the words moving nothing), the span of row bytes or
  pixels the run covers, from lane 0's first and the last lane's end;
- loads of packed rows: the span's 16-byte vectors of the tensor's aligned
  cover (lane q vectors v0 + q + 32 n, zero past the span), each asserted
  to lie inside that cover, with nonzero garbage in every byte outside the
  tensor; a word a funnel shift of two staged words, bytes reversed
  (``brev_bytes``), masked at W;
- the pixel → word kernels of ``tests/test_torch_k1_pack.py`` for the words
  of ``dense_to_rows_*``;
- stores of packed rows: each word's 1–4 row bytes ORed into a zeroed
  stage of 8 U + 1 vectors at its offset (in a seeded order: the atomics'
  order is free), the vectors inside the span stored whole, the first and the last
  byte by byte, only inside the span; stores of pixels: each word ORed into
  a zeroed 33-word bit stage, a vector 16 bits spread to 0/1 bytes; every
  vector and byte written asserted to lie inside the output tensor, every
  output byte written exactly once, and the bytes of a blob around an
  ``out=`` view left as they were;

against the port's plain versions, the JAX package's
``plotweave.ops.bitpack.bitpack_rows`` / ``bitunpack_rows``, its
``plotweave.ops.thinning.pack_bitboards`` / ``unpack_bitboards`` for rows ↔
boards, and ``np.packbits`` / ``np.unpackbits`` (byte equality: all
integer), at widths 1–100, 257, 2000 and 4400, storage offsets 0–15 bytes
and 0–3 elements for int32 and boards, uint8 0, 1, 2, 127, 128, 255, bool,
int32 INT_MIN, −1, 0, 1, INT_MAX, boards and rows with their padding bits
set, 1-D inputs and ``out=`` into a blob view at an odd offset.
``bitpack_rows`` and ``bitunpack_rows`` each count exactly one K1 launch.

``chip_smoke.py`` phase 3 holds the kernels to the plain versions on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import bitpack as jbitpack
from plotweave.ops import thinning as jthin
from plotweave_torch.ops import bitpack, kernels
from plotweave_torch.ops.thinning import bitboards_to_jax

from mocked_cards import card, cards, plain
from test_torch_k1_pack import (BYTE_WIDTHS, I32_VALUES, INT_MAX, SRC, U8_VALUES, U32, U64, WARPS,
                                FakeBitpack, byte_garbage, cu_constant, emulate_bytes, emulate_words,
                                funnelshift_r, group_id, int_garbage, placed, valid_mask)

RUN_WARPS = cu_constant("kRunThreads") // 32
LANE_WORDS = cu_constant("kLaneWords")  # U, the words a lane of rows <-> boards


def row_vectors(u: int) -> int:
    """``RunStage<U>::kVectors``: the vectors 32 U words of packed rows lie in."""
    return 8 * u + 1


def bit_stage(u: int) -> int:
    """``RunStage<U>::kBits``: the staged bits of 32 U words of pixels, in words."""
    return 32 * u + 1

ORDER_RNG = np.random.default_rng(7)
REVERSED = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)

WIDTHS = [*BYTE_WIDTHS, (4400,)]
LEADS = ((2, 3), (1,), (33,))  # two images of three rows, one row, 33 rows: a run crosses rows and images


# --- the kernels' word operations ------------------------------------------------------------------


def brev_bytes(u: np.ndarray) -> np.ndarray:
    """``bitlayout.cuh``'s brev_bytes: the bits of each byte reversed, the bytes in place."""
    u = np.ascontiguousarray(u, U32)
    return REVERSED[u.view(np.uint8)].view(U32).reshape(u.shape)


def run_of(i0: int, n_words: int, nw: int, u: int = 1):
    """``run_lane<U>`` for every lane of the run at i0: (live words of the
    lane's u, its first word i, that word's row and j, the run's last lane)."""
    lanes = np.arange(32)
    last = min(31, (n_words - 1 - i0) // u)
    i = i0 + u * np.minimum(lanes, last)
    live = np.where(lanes <= last, np.minimum(u, n_words - i), 0)
    row = i // nw
    return live, i, row, i - row * nw, last


def lane_words(live, row, j, u: int, nw: int, wb: int):
    """Each lane's u words as the kernels walk them, (word, lane) arrays: j
    (wrapping at the row's end), the first byte in the stream (the previous
    words' bytes on, live or not), the bytes (0 past the live ones)."""
    jk, sb, nb = np.zeros((u, 32), np.int64), np.zeros((u, 32), np.int64), np.zeros((u, 32), np.int64)
    cur_j, cur = j.copy(), row * wb + 4 * j
    for k in range(u):
        jk[k], sb[k] = cur_j, cur
        nb[k] = np.where(k < live, np.minimum(4, wb - 4 * cur_j), 0)
        cur = cur + np.minimum(4, wb - 4 * cur_j)
        cur_j = np.where(cur_j + 1 == nw, 0, cur_j + 1)
    return jk, sb, nb


class Writer:
    """Stores into the output tensor at ``p`` (``nbytes``) by offsets of its
    16-byte aligned cover: every vector and byte asserted inside the tensor,
    every byte counted."""

    def __init__(self, p: int, nbytes: int):
        self.lo, self.start, self.end = p & ~15, p, p + nbytes
        self.mem = np.ctypeslib.as_array((ctypes.c_uint8 * (self.end - self.lo + 16)).from_address(self.lo))
        self.count = np.zeros(self.end - self.lo + 16, np.int64)

    def vector(self, q: int, data: np.ndarray) -> None:
        a = 16 * q
        assert self.start <= self.lo + a and self.lo + a + 16 <= self.end, "a whole vector stored outside the tensor"
        self.mem[a : a + 16] = data
        self.count[a : a + 16] += 1

    def bytes(self, at: np.ndarray, data: np.ndarray) -> None:
        assert ((self.lo + at >= self.start) & (self.lo + at < self.end)).all(), "a byte stored outside the tensor"
        self.mem[at] = data
        self.count[at] += 1

    def check(self) -> None:
        inside = self.count[self.start - self.lo : self.end - self.lo]
        assert (inside == 1).all(), "an output byte written other than once"


def stage_or(stage: np.ndarray, order, at: np.ndarray, value: np.ndarray, unit: int) -> None:
    """The lanes' two shared atomicOrs: ``value`` (32 bits) at bit ``at`` of
    ``stage`` (``unit`` bits a step of ``at``), lane by lane in ``order``."""
    for lane in order:
        c = int(at[lane]) * unit
        lo = (U64(value[lane]) << U64(c & 31)) & U64(0xFFFFFFFF)
        stage[c >> 5] |= U32(lo)
        if c & 31:
            stage[(c >> 5) + 1] |= U32(U64(value[lane]) >> U64(32 - (c & 31)))


def store_span(out: Writer, stage_bytes: np.ndarray, v0: int, nv: int, start: int, end: int) -> None:
    """The vectors inside the span whole (lane q, 1 <= q <= nv - 2, vector
    v0 + q), the first and the last byte by byte (lane l < 16 byte l of vector
    0, lane 16 + l byte l of vector nv - 1), only inside [start, end)."""
    for q in range(1, nv - 1):
        out.vector(v0 + q, stage_bytes[16 * q : 16 * q + 16])
    lanes = np.arange(32)
    t = np.where(lanes < 16, 0, 16 * (nv - 1)) + (lanes & 15)
    at = 16 * v0 + t
    on = ((lanes < 16) | (nv > 1)) & (at >= start) & (at < end)
    out.bytes(at[on], stage_bytes[t[on]])


def load_rows_run(read, mis: int, i0: int, n_words: int, nw: int, wb: int, w: int, u: int = 1):
    """``load_rows_run<u>``: (live words a lane, first words, the (word, lane) words)."""
    live, i, row, j, last = run_of(i0, n_words, nw, u)
    jk, sb, nb = lane_words(live, row, j, u, nw, wb)
    end = sb[0] + nb.sum(axis=0)
    v0, vlast = (mis + sb[0, 0]) // 16, (mis + end[last] - 1) // 16
    assert vlast - v0 < row_vectors(u)
    q = np.arange(row_vectors(u))
    vec = np.zeros((row_vectors(u), 16), np.uint8)
    vec[v0 + q <= vlast] = read(v0 + q[v0 + q <= vlast])
    st = vec.reshape(-1).view(U32)
    b = mis + sb - 16 * v0
    assert ((b + nb)[nb > 0] <= 16 * (vlast - v0 + 1)).all(), "a word's bytes past the loaded vectors"
    assert ((b >> 2) + 1 < st.size).all(), "a read past the stage"
    word = brev_bytes(funnelshift_r(st[b >> 2], st[(b >> 2) + 1], 8 * (b & 3))) & valid_mask(jk, w)
    return live, i, word


def store_rows_run(out: Writer, mis: int, i0: int, n_words: int, nw: int, wb: int, w: int, words,
                   u: int = 1) -> None:
    """``store_rows_run<u>`` of the run at i0, ``words`` (word, lane)."""
    live, i, row, j, last = run_of(i0, n_words, nw, u)
    jk, sb, nb = lane_words(live, row, j, u, nw, wb)
    start, end = mis + sb[0, 0], mis + sb[0, last] + nb[:, last].sum()
    v0 = start // 16
    nv = (end - 1) // 16 - v0 + 1
    assert nv <= row_vectors(u)
    st = np.zeros(4 * row_vectors(u), U32)
    value = brev_bytes(np.asarray(words, U32) & valid_mask(jk, w)).reshape(-1)
    b = (mis + sb - 16 * v0).reshape(-1)
    on = np.flatnonzero(nb.reshape(-1))
    assert ((b >> 2) + (b & 3 > 0) < st.size)[on].all()
    stage_or(st, ORDER_RNG.permutation(on), b, value, 8)
    store_span(out, st.view(np.uint8), v0, nv, start, end)


def store_dense_run(out: Writer, mis: int, i0: int, n_words: int, nw: int, w: int, words) -> None:
    """``store_dense_run`` of the run at i0, lane l storing ``words[l]``."""
    live, i, row, j, last = run_of(i0, n_words, nw)
    p, n = row * w + 32 * j, np.where(live, np.minimum(32, w - 32 * j), 0)
    start, end = mis + p[0], mis + p[last] + n[last]
    v0 = start // 16
    nv = (end - 1) // 16 - v0 + 1
    assert nv <= 2 * bit_stage(1)
    bits = np.zeros(bit_stage(1), U32)
    c = mis + p - 16 * v0
    assert ((c >> 5) + (c & 31 > 0) < bits.size)[live > 0].all()
    stage_or(bits, ORDER_RNG.permutation(np.flatnonzero(n)), c, np.asarray(words, U32), 1)
    spread = ((bits[:, None] >> np.arange(32, dtype=U32)) & U32(1)).astype(np.uint8).reshape(-1)  # bit t on byte t
    store_span(out, spread, v0, nv, start, end)


def runs(n_words: int, warps: int, u: int = 1):
    """The first word of every warp's run of 32 u words, CTA by CTA."""
    for cta in range(-(-n_words // (32 * u * warps))):
        for warp in range(warps):
            if (cta * warps + warp) * 32 * u < n_words:
                yield (cta * warps + warp) * 32 * u


# --- the fake library -------------------------------------------------------------------------------


class FakeRows(FakeBitpack):
    """``csrc/bitpack.cu``'s packed-row entry points (and the pixel → word
    ones of :class:`FakeBitpack`) on host memory."""

    def _board_reader(self, p: int, n_words: int):
        region = next(((a, n) for a, n in self.regions if a <= p and p + 4 * n_words <= a + n), None)
        assert region is not None and p % 4 == 0
        mem = np.ctypeslib.as_array((ctypes.c_uint32 * n_words).from_address(p))
        return lambda i: mem[i]

    def pw_rows_to_boards(self, p, out, n_rows, w, stream):
        if self._bad(n_rows, w):
            return 1
        self.vectors.append(0)
        nw, wb = -(-w // 32), -(-w // 8)
        n_words = n_rows * nw
        read, boards = self._reader(p, n_rows * wb), self._out(out, n_words)
        written = np.zeros(n_words, np.int64)
        for i0 in runs(n_words, RUN_WARPS, LANE_WORDS):
            live, i, word = load_rows_run(read, p & 15, i0, n_words, nw, wb, w, LANE_WORDS)
            for k in range(LANE_WORDS):  # a lane's words, one vector store where all four are live and aligned
                on = k < live
                boards[i[on] + k] = word[k, on]
                written[i[on] + k] += 1
        assert (written == 1).all(), "an output word written other than once"
        return 0

    def pw_boards_to_rows(self, p, out, n_rows, w, stream):
        if self._bad(n_rows, w):
            return 1
        nw, wb = -(-w // 32), -(-w // 8)
        n_words = n_rows * nw
        read, rows = self._board_reader(p, n_words), Writer(out, n_rows * wb)
        for i0 in runs(n_words, RUN_WARPS, LANE_WORDS):
            live, i, _, _, _ = run_of(i0, n_words, nw, LANE_WORDS)
            k = np.arange(LANE_WORDS)[:, None]
            words = np.zeros((LANE_WORDS, 32), U32)  # (word, lane): a lane's live words, no other word read
            words[k < live] = read((i + k)[k < live])
            store_rows_run(rows, out & 15, i0, n_words, nw, wb, w, words, LANE_WORDS)
        rows.check()
        return 0

    def pw_rows_to_dense(self, p, out, n_rows, w, stream):
        if self._bad(n_rows, w) or n_rows * w >= 2**31:
            return 1
        self.vectors.append(0)
        nw, wb = -(-w // 32), -(-w // 8)
        n_words = n_rows * nw
        read, dense = self._reader(p, n_rows * wb), Writer(out, n_rows * w)
        for i0 in runs(n_words, RUN_WARPS):
            _, _, word = load_rows_run(read, p & 15, i0, n_words, nw, wb, w)
            store_dense_run(dense, out & 15, i0, n_words, nw, w, word[0])
        dense.check()
        return 0

    def pw_dense_to_rows(self, p, out, n_rows, w, elem_size, stream):
        if self._bad(n_rows, w) or elem_size not in (1, 4) or p % elem_size:
            return 1
        self.vectors.append(0)
        nw, wb = -(-w // 32), -(-w // 8)
        n_words = n_rows * nw
        read, rows = self._reader(p, n_rows * w * elem_size), Writer(out, n_rows * wb)
        words, written = np.zeros(n_words, U32), np.zeros(n_words, np.int64)  # each lane's word, in registers
        if elem_size == 1:
            emulate_bytes(read, p & 15, words, written, n_words, nw, w)
        else:
            emulate_words(read, (p & 15) // 4, words, written, n_words, nw, w, 1, 0, False)
        assert (written == 1).all()
        for i0 in runs(n_words, WARPS if elem_size == 1 else cu_constant("kWordThreads") // 32):
            _, i, _, _, _ = run_of(i0, n_words, nw)
            store_rows_run(rows, out & 15, i0, n_words, nw, wb, w, words[i][None])
        rows.check()
        return 0


@pytest.fixture
def fake(monkeypatch):
    """The bitpack library replaced by :class:`FakeRows` under the real wrappers."""
    lib = FakeRows([])
    monkeypatch.setattr(kernels, "load", lambda name: lib if name == "bitpack" else pytest.fail(name))
    monkeypatch.setattr(kernels, "_guard", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: SimpleNamespace(cuda_stream=0))
    kernels.reset_launches()
    return lib


def word_garbage(n: int) -> np.ndarray:
    return np.random.default_rng(n).integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.int32)


def random_words(rng, shape) -> np.ndarray:
    """int32 board words of uniformly random bits, the padding bits beyond W included."""
    return rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32).view(np.int32)


# --- the JAX package over a batch of widths -------------------------------------------------------


def flat_rows(cases: list, width: int, fill=0) -> np.ndarray:
    """Every case's (..., n) rows, padded with ``fill`` to ``width``, stacked."""
    return np.concatenate([np.pad(x.reshape(-1, x.shape[-1]), ((0, 0), (0, width - x.shape[-1])),
                                  constant_values=fill) for x in cases])


def split_rows(out: np.ndarray, cases: list, cut) -> list:
    """``out`` of :func:`flat_rows` back into each case's rows, cut to ``cut(case)``."""
    got, at = [], 0
    for x in cases:
        n = x.size // x.shape[-1]
        got.append(out[at : at + n, : cut(x)].reshape(*x.shape[:-1], -1))
        at += n
    return got


def jax_bitpack(cases: list) -> list:
    """``plotweave.ops.bitpack.bitpack_rows`` of every (..., w) case, one
    call over the cases padded with pixels that set no bit."""
    width = max(x.shape[-1] for x in cases)
    out = np.asarray(jbitpack.bitpack_rows(jnp.asarray(flat_rows(cases, width))))
    return split_rows(out, cases, lambda x: -(-x.shape[-1] // 8))


def jax_bitunpack(cases: list, widths: list) -> list:
    """``bitunpack_rows`` of every case's rows at its width: one call at the
    widest, each row's first pixels its own bytes'."""
    width = max(widths)
    out = np.asarray(jbitpack.bitunpack_rows(jnp.asarray(flat_rows(cases, -(-width // 8))), width))
    it = iter(widths)
    return split_rows(out, cases, lambda x: next(it))


def jax_rows_to_boards(cases: list, widths: list) -> list:
    """``pack_bitboards(bitunpack_rows(rows, w))`` of the JAX package."""
    dense = jax_bitunpack(cases, widths)
    width = max(widths)
    out = np.asarray(jthin.pack_bitboards(jnp.asarray(flat_rows(dense, width))))
    return split_rows(out, dense, lambda x: -(-x.shape[-1] // 32))


def jax_boards_to_rows(cases: list, widths: list) -> list:
    """``bitpack_rows(unpack_bitboards(boards, w))`` of the JAX package."""
    width = max(widths)
    words = [x.view(np.uint32) for x in cases]
    out = np.asarray(jthin.unpack_bitboards(jnp.asarray(flat_rows(words, -(-width // 32))), width))
    it = iter(widths)
    return jax_bitpack(split_rows(out, words, lambda x: next(it)))


# --- rows <-> boards ----------------------------------------------------------------------------------


@pytest.mark.parametrize("lead", LEADS, ids=lambda lead: "x".join(map(str, lead)))
@pytest.mark.parametrize("widths", WIDTHS, ids=group_id)
def test_rows_to_boards_emulated(fake, widths, lead):
    """Packed rows with their padding bits set, at every storage offset 0–15:
    the emulated kernel == plain == JAX's pack_bitboards(bitunpack_rows),
    every vector read inside the tensor's aligned cover."""
    rng = np.random.default_rng(10 * widths[0] + len(lead) + lead[0])
    got, batch, ws = [], [], []
    for w in widths:
        for offset in range(16):
            rows = rng.integers(0, 256, (*lead, -(-w // 8)), dtype=np.uint8)
            rows[..., -1] |= (1 << (-w % 8)) - 1
            t = placed(fake, rows, offset, byte_garbage)
            with cards():
                got.append(plain(kernels.rows_to_boards_cuda(t, w)))
            ref = bitpack.rows_to_boards_plain(torch.from_numpy(rows), w)
            assert torch.equal(got[-1], ref), f"w={w} offset {offset}"
            batch.append(rows)
            ws.append(w)
    for g, ref, w in zip(got, jax_rows_to_boards(batch, ws), ws):
        assert np.array_equal(bitboards_to_jax(g), ref), f"w={w} != JAX"
    assert kernels.K1_LAUNCHES["rows_to_boards"] == kernels.LAUNCHES["bitpack"] == len(widths) * 16


@pytest.mark.parametrize("lead", LEADS, ids=lambda lead: "x".join(map(str, lead)))
@pytest.mark.parametrize("widths", WIDTHS, ids=group_id)
def test_boards_to_rows_emulated(fake, widths, lead):
    """Boards with their padding bits set at element offsets 0–3, stored into
    a new tensor or (out=) into a blob view at byte offsets 1–15: the
    emulated kernel == plain == JAX's bitpack_rows(unpack_bitboards) ==
    np.packbits, the rest of the blob untouched."""
    rng = np.random.default_rng(20 * widths[0] + len(lead) + lead[0])
    got, batch, ws = [], [], []
    for w in widths:
        for offset in range(16):
            words = random_words(rng, (*lead, -(-w // 32)))
            t = placed(fake, words, offset % 4, word_garbage)
            ref = bitpack.boards_to_rows_plain(torch.from_numpy(words), w)
            if offset % 4 == 0:
                with cards():
                    got.append(plain(kernels.boards_to_rows_cuda(t, w)))
            else:  # the blob's bytes around the view keep their garbage
                blob = torch.from_numpy(byte_garbage(offset + ref.numel() + 48))
                before = blob.clone()
                view = card(blob[offset : offset + ref.numel()].view(ref.shape))
                with cards():
                    kernels.boards_to_rows_cuda(t, w, out=view)
                got.append(blob[offset : offset + ref.numel()].view(ref.shape).clone())
                assert torch.equal(blob[:offset], before[:offset]) and torch.equal(
                    blob[offset + ref.numel() :], before[offset + ref.numel() :]), f"w={w}: bytes outside out="
            assert torch.equal(got[-1], ref), f"w={w} offset {offset}"
            bits = np.unpackbits(words.view(np.uint32).view(np.uint8), axis=-1, bitorder="little")[..., :w]
            assert np.array_equal(got[-1].numpy(), np.packbits(bits, axis=-1)), f"w={w} != np.packbits"
            batch.append(words)
            ws.append(w)
    for g, ref, w in zip(got, jax_boards_to_rows(batch, ws), ws):
        assert np.array_equal(g.numpy(), ref), f"w={w} != JAX"
    assert kernels.K1_LAUNCHES["boards_to_rows"] == kernels.LAUNCHES["bitpack"] == len(widths) * 16


# --- bitpack_rows and bitunpack_rows: one launch each ----------------------------------------------


@pytest.mark.parametrize("dtype", ("uint8", "bool", "int32"))
@pytest.mark.parametrize("widths", WIDTHS, ids=group_id)
def test_bitpack_rows_emulated(fake, widths, dtype):
    """``bitpack_rows`` on a card: uint8 (0, 1, 2, 127, 128, 255) and bool at
    storage offsets 0–15, int32 (INT_MIN, -1, 0, 1, INT_MAX) at 0–3 among
    positive garbage: one launch of dense_to_rows_bytes or _words, the
    emulated kernel == plain == JAX's bitpack_rows == np.packbits."""
    rng = np.random.default_rng(30 * widths[0] + len(dtype))
    got, batch = [], []
    for w in widths:
        for offset in range(16 if dtype != "int32" else 4):
            lead = LEADS[offset % len(LEADS)]
            if dtype == "int32":
                x = rng.choice(I32_VALUES, (*lead, w)).astype(np.int32)
                t = placed(fake, x, offset, int_garbage(1, INT_MAX))
            else:
                x = rng.choice(U8_VALUES, (*lead, w)) if dtype == "uint8" else (rng.random((*lead, w)) < 0.5)
                t = placed(fake, x.astype(np.uint8), offset, byte_garbage)
                t = t.view(torch.bool) if dtype == "bool" else t
            before = dict(kernels.K1_LAUNCHES)
            with cards():
                got.append(plain(bitpack.bitpack_rows(t)))
            kernel = "dense_to_rows_words" if dtype == "int32" else "dense_to_rows_bytes"
            assert {k: n - before[k] for k, n in kernels.K1_LAUNCHES.items() if n != before[k]} == {kernel: 1}
            assert torch.equal(got[-1], bitpack.bitpack_rows_plain(torch.from_numpy(x))), f"w={w} offset {offset}"
            assert np.array_equal(got[-1].numpy(), np.packbits(x > 0, axis=-1)), f"w={w} != np.packbits"
            batch.append(x)
    for g, ref, x in zip(got, jax_bitpack(batch), batch):
        assert np.array_equal(g.numpy(), ref), f"{dtype} w={x.shape[-1]} != JAX"


@pytest.mark.parametrize("lead", LEADS, ids=lambda lead: "x".join(map(str, lead)))
@pytest.mark.parametrize("widths", WIDTHS, ids=group_id)
def test_bitunpack_rows_emulated(fake, widths, lead):
    """``bitunpack_rows`` on a card: packed rows with their padding bits set
    at storage offsets 0–15: one launch of rows_to_dense, the emulated
    kernel == plain == JAX's bitunpack_rows == np.unpackbits."""
    rng = np.random.default_rng(40 * widths[0] + len(lead) + lead[0])
    got, batch, ws = [], [], []
    for w in widths:
        for offset in range(16):
            rows = rng.integers(0, 256, (*lead, -(-w // 8)), dtype=np.uint8)
            rows[..., -1] |= (1 << (-w % 8)) - 1
            t = placed(fake, rows, offset, byte_garbage)
            with cards():
                got.append(plain(bitpack.bitunpack_rows(t, w)))
            assert torch.equal(got[-1], bitpack.bitunpack_rows_plain(torch.from_numpy(rows), w)), f"w={w} {offset}"
            assert np.array_equal(got[-1].numpy(), np.unpackbits(rows, axis=-1)[..., :w])
            batch.append(rows)
            ws.append(w)
    for g, ref, w in zip(got, jax_bitunpack(batch, ws), ws):
        assert np.array_equal(g.numpy(), ref), f"w={w} != JAX"
    assert kernels.K1_LAUNCHES == {**dict.fromkeys(kernels.K1_LAUNCHES, 0), "rows_to_dense": len(widths) * 16}


@pytest.mark.parametrize("w", (1, 7, 8, 9, 33, 100, 257, 2000, 4400))
def test_one_dimensional(fake, w):
    """A 1-D row through both public functions (uint8, bool and int32 in,
    packed rows at odd offsets), one launch a call: == plain == JAX."""
    rng = np.random.default_rng(w)
    x = rng.choice(U8_VALUES, w)
    i32 = rng.choice(I32_VALUES, w).astype(np.int32)
    rows = rng.integers(0, 256, -(-w // 8), dtype=np.uint8)
    with cards():
        got = [plain(bitpack.bitpack_rows(placed(fake, x, 3, byte_garbage))),
               plain(bitpack.bitpack_rows(placed(fake, (x > 127).astype(np.uint8), 5, byte_garbage).view(torch.bool))),
               plain(bitpack.bitpack_rows(placed(fake, i32, 1, int_garbage(1, INT_MAX)))),
               plain(bitpack.bitunpack_rows(placed(fake, rows, 7, byte_garbage), w))]
    refs = [np.asarray(jbitpack.bitpack_rows(jnp.asarray(v))) for v in (x, x > 127, i32)]
    refs.append(np.asarray(jbitpack.bitunpack_rows(jnp.asarray(rows), w)))
    for g, ref in zip(got, refs):
        assert g.dim() == 1 and np.array_equal(g.numpy(), ref)
    assert kernels.K1_LAUNCHES == {**dict.fromkeys(kernels.K1_LAUNCHES, 0), "dense_to_rows_bytes": 2,
                                   "dense_to_rows_words": 1, "rows_to_dense": 1}


@pytest.mark.parametrize("call", ("bitpack_rows uint8", "bitpack_rows bool", "bitpack_rows int32",
                                  "bitunpack_rows"))
def test_public_functions_launch_once(fake, call):
    """Each public function on a card is exactly one K1 launch, counted
    under its kernel and once under "bitpack"."""
    x = np.random.default_rng(5).integers(0, 2, (3, 5, 70)).astype(np.int32 if "int32" in call else np.uint8)
    with cards():
        if call == "bitunpack_rows":
            rows = np.packbits(x, axis=-1)
            got = plain(bitpack.bitunpack_rows(placed(fake, rows, 2, byte_garbage), 70))
            assert np.array_equal(got.numpy(), x)
        else:
            t = placed(fake, x, 1, int_garbage(1, 9) if "int32" in call else byte_garbage)
            got = plain(bitpack.bitpack_rows(t.view(torch.bool) if "bool" in call else t))
            assert np.array_equal(got.numpy(), np.packbits(x > 0, axis=-1))
    kernel = {"bitunpack_rows": "rows_to_dense", "bitpack_rows int32": "dense_to_rows_words"}.get(
        call, "dense_to_rows_bytes")
    assert kernels.K1_LAUNCHES == {**dict.fromkeys(kernels.K1_LAUNCHES, 0), kernel: 1}
    assert kernels.LAUNCHES["bitpack"] == 1


# --- the schedule and the reads ---------------------------------------------------------------------


@pytest.mark.parametrize("u", (1, LANE_WORDS))
def test_stages_hold_a_warps_span(u):
    """32 u words of packed rows span at most 128 u bytes, which lie in the
    stage's 8 u + 1 vectors at any offset; 32 words of pixels span 1024,
    whose 65 vectors' 16 bits fit the 33-word bit stage."""
    assert "kVectors = 8 * U + 1;" in SRC and "kBits = 32 * U + 1;" in SRC
    assert 16 * row_vectors(u) >= 128 * u + 15
    assert 32 * bit_stage(1) >= 16 * -(-(1024 + 15) // 16)


@pytest.mark.parametrize("offset", (0, 5))
def test_each_warp_reads_its_span_once(fake, offset):
    """The vectors read are the rows' bytes / 16 and one more a warp at most:
    the span is read once, not 4 bytes a word."""
    rows = np.random.default_rng(offset).integers(0, 256, (4, 40, 250), dtype=np.uint8)
    t = placed(fake, rows, offset, byte_garbage)
    with cards():
        got = plain(kernels.rows_to_boards_cuda(t, 2000))
    assert torch.equal(got, bitpack.rows_to_boards_plain(torch.from_numpy(rows), 2000))
    warps = -(-4 * 40 * 63 // (32 * LANE_WORDS))
    assert rows.size // 16 <= fake.vectors[-1] <= rows.size // 16 + warps


@pytest.mark.parametrize("entry", ("pw_rows_to_boards", "pw_boards_to_rows", "pw_dense_to_rows",
                                   "pw_rows_to_dense"))
def test_a_failed_launch_raises(monkeypatch, fake, entry):
    """An error from the entry point raises; nothing falls back to the plain version."""
    monkeypatch.setattr(fake, entry, lambda *a: 700)
    x = np.ones((3, 40), np.uint8)
    with cards(), pytest.raises(RuntimeError, match="CUDA error 700"):
        if entry == "pw_rows_to_boards":
            kernels.rows_to_boards_cuda(placed(fake, x[:, :5], 0, byte_garbage), 40)
        elif entry == "pw_boards_to_rows":
            kernels.boards_to_rows_cuda(placed(fake, x.astype(np.int32)[:, :2], 0, word_garbage), 40)
        elif entry == "pw_dense_to_rows":
            bitpack.bitpack_rows(placed(fake, x, 0, byte_garbage))
        else:
            bitpack.bitunpack_rows(placed(fake, x[:, :5], 0, byte_garbage), 40)
    assert kernels.LAUNCHES["bitpack"] == 1


def test_wrappers_refuse_what_the_kernels_do_not_take(fake):
    """Rows whose bytes do not hold w px, a width of 0, and dtypes the kernel
    does not take raise before any launch."""
    rows = placed(fake, np.zeros((2, 5), np.uint8), 0, byte_garbage)
    with cards():
        for call in (lambda: bitpack.bitunpack_rows(rows, 48), lambda: kernels.rows_to_dense_cuda(rows, 0),
                     lambda: kernels.rows_to_boards_cuda(rows, 41)):
            with pytest.raises(ValueError, match="do not hold"):
                call()
        with pytest.raises(TypeError):
            bitpack.bitpack_rows(placed(fake, np.zeros((2, 5), np.float32), 0, lambda n: np.ones(n, np.float32)))
    assert kernels.LAUNCHES["bitpack"] == 0
