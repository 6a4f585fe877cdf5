"""K1's pixel → word kernels (``csrc/bitpack.cu``) emulated in numpy, on the CPU.

``dense_to_boards`` (uint8 or bool bytes set where nonzero, int32 set where
> 0) and ``labels_to_boards`` (int32 labels → the k one-hot boards) form
whole 32-pixel words from 16-byte vector loads.  No CUDA runs here, so a fake
library takes the place of the built one under the real wrappers (card
tensors mocked by ``tests/mocked_cards.py``, ``_guard`` and the current
stream patched): its ``pw_dense_to_boards`` and ``pw_labels_to_boards``
receive the very pointers and arguments the C entry points receive, and
repeat the kernels warp by warp:

- each warp's run of 32 output words, its span of pixels and the 16-byte
  vectors of the span's aligned cover that it loads (lane l vector
  v0 + l + 32 r in round r), read from host memory only after asserting that
  the vector lies inside the tensor's 16-byte aligned cover, with nonzero
  garbage in every byte outside the tensor;
- bytes: ``__vcmpne4`` and ``gather4``'s multiply into 16 flag bits a
  vector, one staged bit stream a warp, a word a funnel shift of two staged
  words, masked at W; int32 and labels: the vectors staged as pixels, 32 to
  a row of 33 ints (zero past the span, garbage in the pad ints; every pixel
  kept asserted to come from a loaded vector), a lane reading its own
  word's pixels and forming each layer's word (labels: a one-hot byte a
  pixel for eight layers, layer c's bits gathered by ``gather4``), each
  plane's word stored once;

against the port's plain versions (``pack_bitboards_plain``,
``onehot_boards_plain``) and the JAX package's ``pack_bitboards`` and its
front-end's one-hot pack (byte equality: all integer), at widths 1–100, 257
and 2000, storage offsets 0–15 (bytes) and 0–3 elements (int32), uint8 0,
1, 2, 127, 128, 255, bool, int32 INT_MIN, −1, 0, 1, INT_MAX, labels −1,
0..k−1, k and INT_MAX for k = 1, 2, 4, 8 and 12 (two blocks of eight
layers); each launch counted under its own kernel in ``K1_LAUNCHES``.

``chip_smoke.py`` phase 3 holds the kernels to the plain versions on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import thinning as jthin
from plotweave_torch.ops import frontend, kernels, thinning
from plotweave_torch.ops.frontend import onehot_boards_plain
from plotweave_torch.ops.thinning import bitboards_to_jax, pack_bitboards_plain

from mocked_cards import card, cards, plain

SRC = (kernels.CSRC / "bitpack.cu").read_text()
U32, U64 = np.uint32, np.uint64
INT_MIN, INT_MAX = -(2**31), 2**31 - 1
GARBAGE_RNG = np.random.default_rng(99)


def cu_constant(name: str) -> int:
    """A constant of csrc/bitpack.cu, as the source declares it."""
    return int(re.search(rf"\b{name} = (\d+);", SRC).group(1))


THREADS = cu_constant("kPackThreads")
BYTE_ROUNDS = cu_constant("kByteRounds")
WORD_ROUNDS = cu_constant("kWordRounds")
WORD_WARPS = cu_constant("kWordThreads") // 32
STAGE_INTS = 32 * WORD_ROUNDS * 4 * 33 // 32  # kStageInts: 32 pixels to a row of 33 ints
WARPS = THREADS // 32


# --- the kernels' word operations ------------------------------------------------------------------


def vcmpne4(u: np.ndarray) -> np.ndarray:
    """``__vcmpne4(u, 0)``: each byte 0xff where it is nonzero, else 0."""
    b = u.astype(U32).view(np.uint8).reshape(*u.shape, 4)
    return np.where(b != 0, np.uint8(0xFF), np.uint8(0)).reshape(-1).view(U32).reshape(u.shape)


def gather4(u: np.ndarray) -> np.ndarray:
    """``bitlayout.cuh``'s gather4: ((u & 0x01010101) * 0x01020408) >> 24 in 32 bits."""
    return ((((u.astype(U64) & U64(0x01010101)) * U64(0x01020408)) & U64(0xFFFFFFFF)) >> U64(24)).astype(U32)


def nonzero16(vectors: np.ndarray) -> np.ndarray:
    """(..., 16) bytes → the kernel's 16 flag bits a vector."""
    lanes = gather4(vcmpne4(np.ascontiguousarray(vectors).view(U32)))  # (..., 4)
    return lanes[..., 0] | lanes[..., 1] << 4 | lanes[..., 2] << 8 | lanes[..., 3] << 12


def funnelshift_r(lo, hi, s):
    """``__funnelshift_r``: the low 32 bits of (hi:lo) >> (s & 31)."""
    v = (np.asarray(hi).astype(U64) << U64(32)) | np.asarray(lo).astype(U64)
    return ((v >> (np.asarray(s).astype(U64) & U64(31))) & U64(0xFFFFFFFF)).astype(U32)


def valid_mask(j, w: int):
    """``valid_mask(j, w)``: bits [0, w - 32 j) of word j."""
    n = np.clip(w - 32 * np.asarray(j, np.int64), 0, 32)
    return ((np.left_shift(np.int64(1), n) - 1) & 0xFFFFFFFF).astype(U32)


def span_of(i0: int, i1: int, nw: int, w: int, mis: int, per: int) -> tuple:
    """``span_of``: the first and last vector of words [i0, i1], the first word's row and word."""
    r0, r1 = i0 // nw, i1 // nw
    j0, j1 = i0 - r0 * nw, i1 - r1 * nw
    return (mis + r0 * w + 32 * j0) // per, (mis + r1 * w + min(32 * j1 + 32, w) - 1) // per, r0, j0


# --- the fake library -------------------------------------------------------------------------------


class FakeBitpack:
    """``csrc/bitpack.cu``'s two pixel → word entry points on host memory.
    ``regions`` holds (address, bytes) of the storages the test made; a
    vector must lie inside the tensor's 16-byte aligned cover (computed from
    the entry's own arguments) and inside one of them.  ``vectors`` counts
    the vectors each launch read."""

    def __init__(self, regions: list):
        self.regions = regions
        self.vectors: list = []

    def _reader(self, p: int, nbytes: int):
        lo, hi = p & ~15, (p + nbytes + 15) & ~15
        region = next(((a, n) for a, n in self.regions if a <= lo and hi <= a + n), None)
        assert region is not None, "the tensor's aligned cover lies outside the storage the test made"
        mem = np.ctypeslib.as_array((ctypes.c_uint8 * (hi - lo)).from_address(lo))

        def read(q: np.ndarray) -> np.ndarray:
            """The 16-byte vectors q of the cover (``cover + q``: address (p & ~15) + 16 q)."""
            a = lo + 16 * q.astype(np.int64)
            assert ((a >= lo) & (a + 16 <= hi)).all(), "a vector outside the tensor's aligned cover"
            self.vectors[-1] += q.size
            return mem[(a - lo)[..., None] + np.arange(16)]

        return read

    @staticmethod
    def _out(ptr: int, n: int) -> np.ndarray:
        return np.ctypeslib.as_array((ctypes.c_uint32 * n).from_address(ptr))

    @staticmethod
    def _bad(n_rows: int, w: int) -> bool:
        return n_rows <= 0 or w <= 0 or n_rows * -(-w // 32) >= (1 << 31) // 32

    def pw_dense_to_boards(self, p, out, n_rows, w, elem_size, stream):
        if self._bad(n_rows, w) or elem_size not in (1, 4) or p % elem_size:
            return 1  # cudaErrorInvalidValue
        self.vectors.append(0)
        nw = -(-w // 32)
        n_words = n_rows * nw
        read, boards = self._reader(p, n_rows * w * elem_size), self._out(out, n_words)
        written = np.zeros(n_words, np.int64)
        if elem_size == 1:
            emulate_bytes(read, p & 15, boards, written, n_words, nw, w)
        else:
            emulate_words(read, (p & 15) // 4, boards, written, n_words, nw, w, 1, 0, False)
        assert (written == 1).all(), "an output word written other than once"
        return 0

    def pw_labels_to_boards(self, p, out, n_img, k, h, w, stream):
        if n_img <= 0 or h <= 0 or k <= 0 or self._bad(n_img * h, w) or self._bad(n_img * h * k, w) or p % 4:
            return 1
        self.vectors.append(0)
        nw = -(-w // 32)
        n_words = n_img * h * nw
        read, boards = self._reader(p, n_img * h * w * 4), self._out(out, n_words * k)
        written = np.zeros(n_words * k, np.int64)
        emulate_words(read, (p & 15) // 4, boards, written, n_words, nw, w, k, h * nw, True)
        assert (written == 1).all(), "an output word written other than once"
        return 0

    def pw_error_string(self, err):
        return b"invalid argument"


def emulate_bytes(read, mis: int, boards, written, n_words: int, nw: int, w: int) -> None:
    """``dense_to_boards_bytes``: every CTA's warps, each forming words [i0, i0 + 32), lane l word i0 + l."""
    lanes = np.arange(32)
    for cta in range(-(-n_words // (32 * WARPS))):
        for warp in range(WARPS):
            i0 = (cta * WARPS + warp) * 32
            if i0 >= n_words:
                continue
            v0, vlast, _, _ = span_of(i0, min(n_words, i0 + 32) - 1, nw, w, mis, 16)
            q = v0 + lanes[None, :] + 32 * np.arange(BYTE_ROUNDS)[:, None]  # (round, lane)
            live = q <= vlast
            vec = np.zeros((BYTE_ROUNDS, 32, 16), np.uint8)
            vec[live] = read(q[live])
            bits = nonzero16(vec).astype(np.uint16).reshape(-1).view(U32)  # slot lane + 32 r; 16 words a round
            i = i0 + lanes
            on = i < n_words
            row = i // nw
            j = i - row * nw
            b = mis + row * w + 32 * j - 16 * v0
            assert ((b >> 5) + 1 < bits.size)[on].all()
            word = funnelshift_r(bits[(b >> 5)[on]], bits[(b >> 5)[on] + 1], b[on] & 31) & valid_mask(j[on], w)
            boards[i[on]] = word
            written[i[on]] += 1


def emulate_words(read, mis: int, boards, written, n_words: int, nw: int, w: int, k: int, plane: int,
                  labels: bool) -> None:
    """``words_to_boards<labels>``: every CTA's warps, each forming words
    [i0, i0 + 32), lane l word i0 + l of each layer, from a stage of 33-int
    rows (pixel p at p + p // 32) that starts as garbage, every lane storing
    all its rounds (zero past the span); a lane reads all 32 of its word's
    slots and keeps the pixels inside the row."""
    lanes = np.arange(32)
    for cta in range(-(-n_words // (32 * WORD_WARPS))):
        for warp in range(WORD_WARPS):
            i0 = (cta * WORD_WARPS + warp) * 32
            if i0 >= n_words:
                continue
            i1 = min(n_words, i0 + 32) - 1
            v0, vlast, _, _ = span_of(i0, i1, nw, w, mis, 4)
            q = lanes[None, :] + 32 * np.arange(WORD_ROUNDS)[:, None]  # (round, lane): the span's vector q
            live = v0 + q <= vlast
            stage = GARBAGE_RNG.integers(INT_MIN, INT_MAX, STAGE_INTS, dtype=np.int64).astype(np.int32)
            loaded = np.zeros(STAGE_INTS, bool)  # slots of a loaded vector; every other slot the lanes store is 0
            vec = np.zeros((WORD_ROUNDS, 32, 4), np.int32)
            vec[live] = read(v0 + q[live]).view(np.int32).reshape(-1, 4)
            slots = (4 * q + q // 8)[..., None] + np.arange(4)
            stage[slots] = vec
            loaded[slots[live]] = True
            i = i0 + lanes
            on = i <= i1
            row = i // nw
            j = i - row * nw
            p0 = mis + row * w + 32 * j - 4 * v0
            n = np.minimum(32, w - 32 * j)
            x = np.arange(32)[:, None]  # (pixel, lane)
            p = p0 + x
            at = (p + p // 32)[:, on]
            assert (at < STAGE_INTS).all(), "a read past the stage"
            kept = (x < n)[:, on]
            assert loaded[at][kept].all(), "a pixel kept from a slot of no loaded vector"
            label = np.where(kept, stage[at], -1).astype(np.int64)
            if not labels:
                words = ((label > 0).astype(U64) << x.astype(U64)).sum(axis=0).astype(U32)
                boards[i[on]] = words
                written[i[on]] += 1
                continue
            base = (i + (i // plane) * (k - 1) * plane)[on]
            for c0 in range(0, k, 8):
                d = (label.astype(np.uint32) - np.uint32(c0)).astype(U64)  # (pixel, lane), the kernel's unsigned d
                hot_byte = np.where(d < 8, U64(1) << np.minimum(d, 7), U64(0))
                hot = (hot_byte.reshape(8, 4, -1) << (U64(8) * np.arange(4, dtype=U64))[:, None]).sum(axis=1)  # (g, lane)
                for c in range(c0, min(k, c0 + 8)):
                    nib = gather4((hot >> U64(c - c0)).astype(U32)).astype(U64)
                    words = (nib << (U64(4) * np.arange(8, dtype=U64))[:, None]).sum(axis=0).astype(U32)
                    boards[base + c * plane] = words
                    written[base + c * plane] += 1


# --- fixtures and inputs ------------------------------------------------------------------------------


@pytest.fixture
def fake(monkeypatch):
    """The bitpack library replaced by :class:`FakeBitpack` under the real wrappers."""
    lib = FakeBitpack([])
    monkeypatch.setattr(kernels, "load", lambda name: lib if name == "bitpack" else pytest.fail(name))
    monkeypatch.setattr(kernels, "_guard", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: SimpleNamespace(cuda_stream=0))
    kernels.reset_launches()
    return lib


def placed(lib: FakeBitpack, values: np.ndarray, offset: int, garbage) -> torch.Tensor:
    """``values`` at ``offset`` elements into a storage of nonzero garbage (two
    16-byte vectors more on each side), as a card tensor; the storage is
    registered with the fake library."""
    n = values.size
    buf = torch.from_numpy(garbage(offset + n + 32 // values.itemsize))
    assert buf.untyped_storage().data_ptr() % 16 == 0
    view = buf[offset : offset + n].view(values.shape)
    view.copy_(torch.from_numpy(values))
    lib.regions.append((buf.untyped_storage().data_ptr(), buf.untyped_storage().nbytes()))
    return card(view)


def byte_garbage(n: int) -> np.ndarray:
    return GARBAGE_RNG.integers(1, 256, n, dtype=np.uint8)


def int_garbage(low: int, high: int):
    return lambda n: GARBAGE_RNG.integers(low, high, n, dtype=np.int64).astype(np.int32)


def jax_rows(cases: list, fill, pack) -> list:
    """``pack`` (a JAX function of (..., H, W) arrays) over every case's
    (..., w) array in one call: each row padded with ``fill`` (which sets no
    bit) to the widest case's width, so a row's words are its own; each
    case's boards as ``uint32``, cut back to its own words."""
    width = max(x.shape[-1] for x in cases)
    flat = [x.reshape(-1, x.shape[-1]) for x in cases]
    rows = np.concatenate([np.pad(f, ((0, 0), (0, width - f.shape[-1])), constant_values=fill) for f in flat])
    out = np.asarray(pack(jnp.asarray(rows)[None]))[0]  # (rows, words), or (k, rows, words)
    got, at = [], 0
    for x, f in zip(cases, flat):
        part = out[..., at : at + len(f), : -(-x.shape[-1] // 32)]
        part = part.reshape(*part.shape[:-2], *x.shape[:-1], part.shape[-1])
        got.append(np.moveaxis(part, 0, -3) if part.ndim > x.ndim else part)  # layers before the rows
        at += len(f)
    return got


BYTE_WIDTHS = [tuple(range(1, 17)), tuple(range(17, 33)), tuple(range(33, 49)), tuple(range(49, 65)),
               tuple(range(65, 81)), tuple(range(81, 101)), (257,), (2000,)]
LEAD = (2, 3)  # two images of three rows: words of one warp cross rows and images
# the bytes' leading shapes: LEAD, one row, and 33 rows (a warp's 32 words span many rows of a narrow W)
BYTE_LEADS = (LEAD, (1,), (33,))
U8_VALUES = np.array([0, 1, 2, 127, 128, 255], np.uint8)
I32_VALUES = np.array([INT_MIN, -1, 0, 1, INT_MAX], np.int64)


def group_id(widths) -> str:
    return f"w{widths[0]}-{widths[-1]}" if len(widths) > 1 else f"w{widths[0]}"


# --- dense -> boards ----------------------------------------------------------------------------------


@pytest.mark.parametrize("lead", BYTE_LEADS, ids=lambda lead: "x".join(map(str, lead)))
@pytest.mark.parametrize("dtype", ("uint8", "bool"))
@pytest.mark.parametrize("widths", BYTE_WIDTHS, ids=group_id)
def test_bytes_to_boards_emulated(fake, widths, dtype, lead):
    """uint8 and bool at every storage offset 0–15: the emulated kernel ==
    plain == JAX's ``pack_bitboards``, every vector read inside the
    tensor's aligned cover."""
    rng = np.random.default_rng(1000 * (dtype == "bool") + 10 * widths[0] + len(lead) + lead[0])
    got, batch = [], []
    for w in widths:
        for offset in range(16):
            if dtype == "uint8":
                x = rng.choice(U8_VALUES, (*lead, w))
            else:
                x = rng.random((*lead, w)) < 0.5
            t = placed(fake, x.astype(np.uint8), offset, byte_garbage)
            if dtype == "bool":
                t = t.view(torch.bool)
            with cards():
                got.append(plain(kernels.dense_to_boards_cuda(t) if offset % 2 else thinning.pack_bitboards(t)))
            assert torch.equal(got[-1], pack_bitboards_plain(torch.from_numpy(x))), f"{dtype} w={w} offset {offset}"
            batch.append(x)
    for g, ref, x in zip(got, jax_rows(batch, 0, jthin.pack_bitboards), batch):
        assert np.array_equal(bitboards_to_jax(g), ref), f"{dtype} w={x.shape[-1]} != JAX"
    assert kernels.K1_LAUNCHES["dense_to_boards_bytes"] == kernels.LAUNCHES["bitpack"] == len(widths) * 16


INT_WIDTHS = [tuple(range(1, 17)), tuple(range(17, 33)), tuple(range(33, 49)), tuple(range(49, 65)),
              tuple(range(65, 81)), tuple(range(81, 101)), (257,), (2000,)]


@pytest.mark.parametrize("widths", INT_WIDTHS, ids=group_id)
def test_int32_to_boards_emulated(fake, widths):
    """int32 (set where > 0: INT_MIN, -1, 0, 1, INT_MAX) at element offsets
    0–3, garbage > 0 around it: emulated kernel == plain == JAX."""
    rng = np.random.default_rng(widths[0])
    got, batch = [], []
    for w in widths:
        for offset in range(4):
            x = rng.choice(I32_VALUES, (*LEAD, w)).astype(np.int32)
            t = placed(fake, x, offset, int_garbage(1, INT_MAX))
            with cards():
                got.append(plain(kernels.dense_to_boards_cuda(t)))
            assert torch.equal(got[-1], pack_bitboards_plain(torch.from_numpy(x))), f"int32 w={w} offset {offset}"
            batch.append(x)
    for g, ref, x in zip(got, jax_rows(batch, 0, jthin.pack_bitboards), batch):
        assert np.array_equal(bitboards_to_jax(g), ref), f"int32 w={x.shape[-1]} != JAX"
    assert kernels.K1_LAUNCHES["dense_to_boards_words"] == kernels.LAUNCHES["bitpack"] == len(widths) * 4


# --- labels -> boards ---------------------------------------------------------------------------------

LABEL_WIDTHS = [tuple(range(1, 34)), tuple(range(34, 101)), (257,), (2000,)]


def jax_onehot(k: int):
    """The JAX front-end's one-hot pack (``plotweave/ops/frontend.py``), k layers."""
    return lambda lab: jthin.pack_bitboards(lab[..., None, :, :] == jnp.arange(k)[:, None, None])


@pytest.mark.parametrize("k", (1, 2, 4, 8, 12))
@pytest.mark.parametrize("widths", LABEL_WIDTHS, ids=group_id)
def test_labels_to_boards_emulated(fake, widths, k):
    """Labels -1, 0..k-1, k and INT_MAX at element offsets 0–3, garbage of
    in-range labels around them: the emulated kernel == plain ==
    JAX's one-hot pack, through ``onehot_boards`` and the wrapper."""
    rng = np.random.default_rng(100 * k + widths[0])
    values = np.array([-1, *range(k), k, INT_MAX], np.int64)
    got, batch = [], []
    for w in widths:
        for shape in ((2, 3, w), (5, w)):
            for offset in range(4):
                x = rng.choice(values, shape).astype(np.int32)
                t = placed(fake, x, offset, int_garbage(0, k))
                with cards():
                    got.append(plain(frontend.onehot_boards(t, k) if offset % 2 else kernels.labels_to_boards_cuda(t, k)))
                assert torch.equal(got[-1], onehot_boards_plain(torch.from_numpy(x), k)), f"k={k} {shape} {offset}"
                batch.append(x)
    for g, ref, x in zip(got, jax_rows(batch, -1, jax_onehot(k)), batch):
        assert np.array_equal(bitboards_to_jax(g), ref), f"k={k} {x.shape} != JAX"
    assert kernels.K1_LAUNCHES["labels_to_boards"] == kernels.LAUNCHES["bitpack"] == len(widths) * 2 * 4


# --- the schedule and the reads ---------------------------------------------------------------------


@pytest.mark.parametrize("dtype", (torch.uint8, torch.bool, torch.int32), ids=str)
def test_launches_are_counted_by_kernel(fake, dtype):
    """Bytes (uint8, bool) launch the byte kernel, int32 the word kernel:
    each counted under its own name, and under "bitpack"."""
    x = np.random.default_rng(3).integers(0, 2, (5, 70)).astype(np.uint8 if dtype != torch.int32 else np.int32)
    t = placed(fake, x, 1, byte_garbage if dtype != torch.int32 else int_garbage(1, 9))
    with cards():
        got = plain(kernels.dense_to_boards_cuda(t.view(dtype) if dtype == torch.bool else t))
    assert torch.equal(got, pack_bitboards_plain(torch.from_numpy(x)))
    kernel = "dense_to_boards_words" if dtype == torch.int32 else "dense_to_boards_bytes"
    assert kernels.K1_LAUNCHES == {**dict.fromkeys(kernels.K1_LAUNCHES, 0), kernel: 1}
    assert kernels.LAUNCHES["bitpack"] == 1


def test_stage_holds_a_warps_span():
    """The int32 and label kernel's stage of 33-int rows holds its rounds'
    vectors, and each kernel's rounds cover a warp's span of 32 words plus
    a vector (int32 4096 + 12 bytes, bytes 1024 + 15)."""
    assert "kStageInts = 32 * kWordRounds * 4 * 33 / 32;" in SRC
    assert 32 * WORD_ROUNDS * 16 >= 4096 + 12 + 16 and 32 * BYTE_ROUNDS * 16 >= 1024 + 15 + 16


@pytest.mark.parametrize("offset", (0, 5))
def test_each_warp_reads_its_span_once(fake, offset):
    """At a 16-byte aligned W the vectors read are the plane's bytes / 16
    and a few at the warps' seams; at an odd offset, one more a warp at
    most: the span is read once, not a window a word."""
    x = np.random.default_rng(offset).integers(0, 2, (4, 40, 2000), dtype=np.uint8)
    t = placed(fake, x, offset, byte_garbage)
    with cards():
        got = plain(kernels.dense_to_boards_cuda(t))
    assert torch.equal(got, pack_bitboards_plain(torch.from_numpy(x)))
    warps = -(-x.size // 2000 * 63 // 32)
    assert x.size // 16 <= fake.vectors[-1] <= x.size // 16 + 2 * warps


@pytest.mark.parametrize("what", ("dense", "labels"))
def test_a_failed_launch_raises(monkeypatch, fake, what):
    """An error from the entry point raises; nothing falls back to the plain version."""
    monkeypatch.setattr(fake, "pw_dense_to_boards", lambda *a: 700)
    monkeypatch.setattr(fake, "pw_labels_to_boards", lambda *a: 700)
    x = np.ones((3, 40), np.int32)
    t = placed(fake, x, 0, int_garbage(0, 2))
    with cards(), pytest.raises(RuntimeError, match="CUDA error 700"):
        kernels.dense_to_boards_cuda(t) if what == "dense" else kernels.labels_to_boards_cuda(t, 2)
    assert kernels.K1_LAUNCHES["dense_to_boards_words" if what == "dense" else "labels_to_boards"] == 1
