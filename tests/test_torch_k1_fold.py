"""K1 folded into K2's load and K6's stores, on the CPU.

The raster chain hands K2 the cleaned masks as packed rows (8 px a byte, MSB
first, ⌈W/8⌉ bytes a row, so rows are not 4-byte aligned); K2's load builds
each bitboard word from the row's own bytes, and K6 writes the edges it
loads and the skeletons it stores straight into stage 02's blob (packed
rows) or the front-end's outputs (dense bytes).  No CUDA runs here, so:

- numpy emulations of the fused load and stores (``csrc/bitlayout.cuh``'s
  ``row_word``, ``store_row_word`` and ``store_dense_word``, K2's bands and
  K6's CTAs), indexed as the kernels index, read from buffers whose every
  cell the kernel may not read is a sentinel and write into buffers filled
  with one, and must leave every byte outside the layer's rows untouched;
- the blob-offset function (``kernels.layer_offset``) held against
  ``chain_tail``'s view of the blob;
- the plain composites (K1's plain conversions with the plain K2 and K6:
  ``morph_steps_plain`` with packed rows in and out,
  ``zhang_suen_into_plain``) and the paths built on them held byte for byte
  (tolerance 0: all integer) to the JAX package's ``_chain_from_clean``,
  ``_chain_blob_batch``, ``_assign_tail`` and ``raster_frontend``.

``chip_smoke.py`` holds the kernels to these plain versions on the card.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plotweave.ops import thinning as jthin
from plotweave.ops.frontend import assign_nearest as jax_assign_nearest
from plotweave.ops.frontend import raster_frontend as jax_raster_frontend
from plotweave.stages.s02_color_extract import _chain_blob_batch, _chain_from_clean
from plotweave_torch.ops import kernels, morphology, thinning
from plotweave_torch.ops.bitpack import boards_to_rows_plain, rows_to_boards_plain
from plotweave_torch.ops.frontend import assign_nearest, raster_frontend
from plotweave_torch.ops.thinning import bitboards_from_jax, bitboards_to_jax
from plotweave_torch.stages.s02_color_extract import (
    assign_tail, chain_blob_batch, chain_from_clean, chain_tail, edges_from_boards)

from test_torch_frontend import BENCH_CENTERS, label_flips, poster
from test_torch_ops import blob_stack

WIDTHS = (1, 7, 8, 31, 32, 33, 250)
CASES = [(w, k, b) for w in WIDTHS for k in (1, 4) for b in (1, 3)]
IDS = [f"w{w}-k{k}-b{b}" for w, k, b in CASES]
H = 11  # rows a layer: odd, and fewer than K6's 16 CTAs hold at one row each
PARAMS = (3, 1, 1, 5, 22, 70)  # (mk, oi, ci, bk, lo, hi): the default config's
SENTINEL = 0xA5
CPU = torch.device("cpu")
REV8 = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)  # the bits of a byte reversed
CSRC = Path(kernels.CSRC)


def valid_masks(w: int) -> np.ndarray:
    """``valid_mask(word, w)`` of every word of a row, uint32."""
    n = w - 32 * np.arange(-(-w // 32))
    return np.where(n >= 32, 0xFFFFFFFF, (1 << np.clip(n, 0, 31).astype(np.uint64)) - 1).astype(np.uint32)


def row_words(buf: np.ndarray, owner: np.ndarray, starts: np.ndarray, ids: np.ndarray, w: int) -> np.ndarray:
    """``row_word`` of every word of the rows ``ids`` (R,) that start at
    byte ``starts`` (R,) of ``buf``: each word from the 1-4 bytes of its own
    row (min(4, wb - 4 word)), asserted never to touch a byte that ``owner``
    gives to another row or to none (a sentinel); bytes reversed bit by bit,
    the bits at and beyond w cleared.  → (R, ⌈w/32⌉) uint32."""
    wb, nw = -(-w // 8), -(-w // 32)
    word = np.arange(nw)[None, :, None]
    b = np.arange(4)[None, None, :]
    idx = starts[:, None, None] + 4 * word + b
    read = np.broadcast_to(b < np.minimum(4, wb - 4 * word), idx.shape)
    rows = np.broadcast_to(ids[:, None, None], idx.shape)
    assert (owner[idx[read]] == rows[read]).all(), "a word read a byte outside its own row"
    vals = np.where(read, REV8[buf[np.where(read, idx, 0)]], 0).astype(np.uint64)
    return ((vals << (8 * b).astype(np.uint64)).sum(-1).astype(np.uint64) & valid_masks(w)).astype(np.uint32)


def store_row_words(out: np.ndarray, count: np.ndarray, starts: np.ndarray, words: np.ndarray, w: int) -> None:
    """``store_row_word`` of every word (R, nw) into the rows that start at
    byte ``starts`` of ``out``: the 1-4 bytes of each word inside its row, the
    bits at and beyond w as zero; ``count`` counts the writes of each byte."""
    wb, nw = -(-w // 8), -(-w // 32)
    u = words & valid_masks(w)
    for word in range(nw):
        for b in range(min(4, wb - 4 * word)):
            idx = starts + 4 * word + b
            out[idx] = REV8[(u[:, word] >> np.uint32(8 * b)) & np.uint32(255)]
            count[idx] += 1


def store_dense_words(out: np.ndarray, count: np.ndarray, starts: np.ndarray, words: np.ndarray, w: int,
                      value: int, vec: bool) -> None:
    """``store_dense_word`` of every word into the dense rows at ``starts``:
    per half word one 16-byte store where ``vec`` and 16 px remain (asserted
    16-byte aligned), else one byte store a pixel inside the row."""
    for word in range(-(-w // 32)):
        for x0 in (32 * word, 32 * word + 16):
            n = min(16, w - x0)
            if n <= 0:
                continue
            bits = (words[:, word] >> np.uint32(x0 - 32 * word))[:, None] >> np.arange(16, dtype=np.uint32)
            px = np.where(bits & 1, value, 0).astype(np.uint8)
            if vec and n == 16:
                assert ((starts + x0) % 16 == 0).all(), "a 16-byte store off a 16-byte boundary"
            idx = starts[:, None] + x0 + np.arange(n)
            out[idx] = px[:, :n]
            count[idx] += 1


def random_rows(rng, shape, w: int) -> np.ndarray:
    """Packed rows of uniformly random bytes, the padding bits beyond w set
    at random too: a load must drop them."""
    return rng.integers(0, 256, (*shape, -(-w // 8)), dtype=np.uint8)


def random_boards(rng, shape, w: int) -> np.ndarray:
    """uint32 boards of random bits, the padding bits beyond w included: a
    store must drop them."""
    return rng.integers(0, 2**32, (*shape, -(-w // 32)), dtype=np.uint64).astype(np.uint32)


def jax_boards(rows: np.ndarray, w: int) -> np.ndarray:
    """The JAX package's boards of packed rows (np.unpackbits, then
    ``pack_bitboards``)."""
    return np.asarray(jthin.pack_bitboards(jnp.asarray(np.unpackbits(rows, axis=-1)[..., :w])))


def jax_dense(boards: np.ndarray, w: int) -> np.ndarray:
    return np.asarray(jthin.unpack_bitboards(jnp.asarray(boards), w)).astype(np.uint8)


# --- the fused load: K2's bands over packed rows --------------------------------------


@pytest.mark.parametrize("w,k,b", CASES, ids=IDS)
def test_k2_packed_row_load_emulated(w, k, b):
    """K2's blocks load their band and its halo (rows outside the layer are
    never read and hold 0) from packed rows laid in a buffer of sentinels;
    each buffer row is the JAX package's board of that row."""
    rng = np.random.default_rng(1000 * w + 10 * k + b)
    wb, layers = -(-w // 8), b * k
    rows = random_rows(rng, (layers, H), w)
    pad = 19  # sentinels before and after the tensor
    buf = np.full(2 * pad + rows.size, SENTINEL, np.uint8)
    buf[pad : pad + rows.size] = rows.reshape(-1)
    owner = np.full(buf.size, -1)
    owner[pad : pad + rows.size] = np.repeat(np.arange(layers * H), wb)
    ref = jax_boards(rows, w)
    for band, radius in ((4, 2), (H, 0), (32, 4)):  # the main path's radius 4 on 32-row bands, and others
        for layer in range(layers):
            for block in range(-(-H // band)):
                g0 = block * band - radius  # the layer row of the block's buffer row 0
                g = np.arange(g0, g0 + band + 2 * radius)
                inside = (g >= 0) & (g < H)
                loaded = np.zeros((len(g), -(-w // 32)), np.uint32)
                ids = layer * H + g[inside]  # the rows of this layer the block reads: its band and halo
                loaded[inside] = row_words(buf, owner, pad + ids * wb, ids, w)
                np.testing.assert_array_equal(loaded[inside], ref[layer, g[inside]])
                assert not loaded[~inside].any()
    # the plain version of the load, a list of no steps
    got = morphology.morph_steps_plain(torch.from_numpy(rows), morphology._valid_bits(w), (), width=w)
    np.testing.assert_array_equal(bitboards_to_jax(got), ref)
    np.testing.assert_array_equal(bitboards_to_jax(rows_to_boards_plain(torch.from_numpy(rows), w)), ref)


# --- the fused stores: K6's CTAs into a blob or dense outputs -----------------------------


def k6_store(out, count, base: int, boards: np.ndarray, w: int, group: int, img_stride: int, layout: str,
             value: int = 255, vec: bool = False) -> None:
    """Every CTA of K6's clusters storing its rows of every layer of
    ``boards`` (layers, H, nw) into ``out`` at ``base`` + its
    ``kernels.layer_offset`` (``zs_cluster``'s ``half``)."""
    layers, h, _ = boards.shape
    rb = kernels.row_bytes(layout, w)
    rpc = -(-h // kernels.CLUSTER_SIZE)
    for layer in range(layers):
        for rank in range(kernels.CLUSTER_SIZE):
            row0 = rank * rpc
            nrows = max(0, min(h - row0, rpc))
            if not nrows:
                continue
            half = kernels.layer_offset(layer, group, h, rb, img_stride) + row0 * rb
            starts = base + half + rb * np.arange(nrows)
            words = boards[layer, row0 : row0 + nrows]
            if layout == "rows":
                store_row_words(out, count, starts, words, w)
            else:
                store_dense_words(out, count, starts, words, w, value, vec)


@pytest.mark.parametrize("w,k,b", CASES, ids=IDS)
def test_k6_blob_store_emulated(w, k, b):
    """K6's stores of the edges and the skeletons into a blob filled with a
    sentinel, at an odd offset (stage 02's device-mode blob): every byte of
    the layers' rows written once, every other byte untouched, and the blob
    the JAX package's layout [packed edges][packed skeletons] per image."""
    rng = np.random.default_rng(2000 * w + 10 * k + b)
    wb = -(-w // 8)
    edges, skels = random_boards(rng, (b * k, H), w), random_boards(rng, (b * k, H), w)
    half = k * H * wb
    base = 3
    out = np.full(base + 2 * b * half + 5, SENTINEL, np.uint8)
    count = np.zeros(out.size, np.int64)
    k6_store(out, count, base, edges, w, k, 2 * half, "rows")
    k6_store(out, count, base + half, skels, w, k, 2 * half, "rows")
    assert (count[base : base + 2 * b * half] == 1).all(), "a byte of the rows written twice or never"
    assert not count[:base].any() and not count[base + 2 * b * half :].any()
    assert (out[:base] == SENTINEL).all() and (out[base + 2 * b * half :] == SENTINEL).all()
    ref = np.stack([np.packbits(jax_dense(x, w).reshape(b, k, H, w), axis=-1) for x in (edges, skels)], axis=1)
    np.testing.assert_array_equal(out[base : base + 2 * b * half], ref.reshape(-1))
    # the plain version writes the same halves
    blob = torch.full((b, 2, k, H, wb), SENTINEL, dtype=torch.uint8)
    e = bitboards_from_jax(edges)
    thinning.zhang_suen_into_plain(e, w, blob[:, 0], blob[:, 1], "rows", 0)  # max_iter 0: the skeletons are the edges
    np.testing.assert_array_equal(blob[:, 0].numpy(), ref[:, 0])
    np.testing.assert_array_equal(blob[:, 1].numpy(), ref[:, 0])


@pytest.mark.parametrize("w,k,b", CASES, ids=IDS)
def test_k6_dense_store_emulated(w, k, b):
    """K6's dense stores (the front-end's outputs: edges 255, skeletons 1),
    with 16-byte stores where a row is a multiple of 16 px and byte stores
    else, into outputs filled with a sentinel: every pixel written once,
    nothing outside, the JAX package's ``unpack_bitboards`` times the value."""
    rng = np.random.default_rng(3000 * w + 10 * k + b)
    boards = random_boards(rng, (b * k, H), w)
    size = b * k * H * w
    base = 16  # a 16-byte aligned output, as torch.empty gives
    vec = w % 16 == 0
    for value in (255, 1):
        out = np.full(base + size + 16, SENTINEL, np.uint8)
        count = np.zeros(out.size, np.int64)
        k6_store(out, count, base, boards, w, k, k * H * w, "dense", value, vec)
        assert (count[base : base + size] == 1).all() and not count[:base].any() and not count[base + size :].any()
        assert (out[:base] == SENTINEL).all() and (out[base + size :] == SENTINEL).all()
        np.testing.assert_array_equal(out[base : base + size], (jax_dense(boards, w) * value).reshape(-1))


@pytest.mark.parametrize("w,k,b", CASES, ids=IDS)
def test_layer_offset_is_chain_tails_blob(w, k, b):
    """``kernels.layer_offset`` at chain_tail's image stride (2 k H ⌈W/8⌉)
    finds each layer's edges, and k H ⌈W/8⌉ further its skeletons, in the
    blob that ``chain_tail`` writes (into an ``out`` at an odd offset, as
    stage 02's device mode does)."""
    wb = -(-w // 8)
    masks = np.stack([np.packbits(blob_stack(40 * w + i, k, H, w) > 0, axis=-1) for i in range(b)])
    big = torch.full((7 + 2 * b * k * H * wb,), SENTINEL, dtype=torch.uint8)
    chain_tail(torch.from_numpy(masks), w, *PARAMS, out=big[7:])
    assert (big[:7] == SENTINEL).all()
    flat = big[7:].numpy()
    edges_b = edges_from_boards(torch.from_numpy(masks), w, *PARAMS).reshape(b * k, H, -1)
    skels_b = thinning.zhang_suen_packed_plain(edges_b, 120, True)
    for layer in range(b * k):
        at = kernels.layer_offset(layer, k, H, wb, 2 * k * H * wb)
        np.testing.assert_array_equal(flat[at : at + H * wb], boards_to_rows_plain(edges_b[layer], w).reshape(-1))
        at += k * H * wb
        np.testing.assert_array_equal(flat[at : at + H * wb], boards_to_rows_plain(skels_b[layer], w).reshape(-1))


# --- the plain composites against the JAX package -----------------------------------------


@functools.lru_cache(maxsize=None)
def jax_skeletons(w: int) -> np.ndarray:
    """The JAX thinner's skeletons of :func:`edge_stack` (3, 4, H, w)."""
    return np.asarray(jthin.zhang_suen(jnp.asarray(edge_stack(w)), max_iter=120, rotated=True)).astype(np.uint8)


def edge_stack(w: int) -> np.ndarray:
    """(3, 4, H, w) 0/255 edge-like masks to thin."""
    return blob_stack(5000 + w, 12, H, w).reshape(3, 4, H, w)


@pytest.mark.parametrize("w,k,b", CASES, ids=IDS)
@pytest.mark.parametrize("layout", ["rows", "dense"])
def test_zhang_suen_into_plain_matches_jax(w, k, b, layout):
    """The plain K6 with its stores: the JAX package's packed rows
    (``bitpack_rows``) or dense bytes of the edges and of their skeletons, in
    outputs (B, group, H, row bytes) of one image stride."""
    edges = edge_stack(w)[:b, :k]
    ref_s = jax_skeletons(w)[:b, :k]
    boards = thinning.pack_bitboards_plain(torch.from_numpy(edges)).reshape(b * k, H, -1)
    rb = kernels.row_bytes(layout, w)
    out = torch.full((b, 2, k, H, rb), SENTINEL, dtype=torch.uint8)
    thinning.zhang_suen_into(boards, w, out[:, 0], out[:, 1], layout, 120, True)
    if layout == "rows":
        refs = (np.packbits(edges > 0, axis=-1), np.packbits(ref_s > 0, axis=-1))
    else:
        refs = ((edges > 0).astype(np.uint8) * 255, ref_s)
    np.testing.assert_array_equal(out[:, 0].numpy(), refs[0])
    np.testing.assert_array_equal(out[:, 1].numpy(), refs[1])


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("k", [1, 4])
def test_chain_from_clean_matches_jax_at_every_width(w, k):
    """``chain_from_clean`` on the CPU (the plain K2 loading packed rows, K3+K4,
    K5, the plain K6 storing the blob) == the JAX package's
    ``_chain_from_clean``."""
    packed = np.packbits(blob_stack(60 * w + k, k, H, w) > 0, axis=-1)
    ref = np.asarray(_chain_from_clean(packed, w, *PARAMS))
    got = chain_from_clean(packed, w, *PARAMS, device=CPU)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("w", [1, 33, 250])
def test_chain_blob_batch_matches_jax(w):
    """A grouped call of 3 images, k = 4: the JAX package's
    ``_chain_blob_batch`` row by row."""
    packed = np.stack([np.packbits(blob_stack(70 * w + i, 4, H, w) > 0, axis=-1) for i in range(3)])
    mk, oi, ci, bk, lo, hi = PARAMS
    ref = np.asarray(_chain_blob_batch(jnp.asarray(packed), w=w, mk=mk, oi=oi, ci=ci, bk=bk, lo=lo, hi=hi))
    np.testing.assert_array_equal(chain_blob_batch(packed, w, *PARAMS, device=CPU).numpy(), ref)


@pytest.mark.parametrize("w", [8, 33, 83])
def test_assign_tail_rows_match_jax(w):
    """``assign_tail``'s packed masks come from the plain K2's store (no K1):
    the JAX package's ``_assign_tail``, into a blob view and into a tensor of
    its own."""
    from plotweave.ops.colorspace import bgr_to_lab_u8 as jax_lab
    from plotweave.stages.s02_color_extract import _assign_tail
    from test_torch_kmeans import _poster

    img = _poster(14, 23, w, 0)
    centers = np.array([[40, 128, 128], [110, 160, 150], [190, 140, 150], [235, 128, 130]], np.float32)
    _, ref_packed, ref_masks = _assign_tail(jax_lab(jnp.asarray(img)), jnp.asarray(centers), 4, 1, 1)
    n = 4 * 23 * -(-w // 8)
    blob = torch.full((n + 9,), SENTINEL, dtype=torch.uint8)
    _, packed, masks_b = assign_tail(torch.from_numpy(img), torch.from_numpy(centers), 4, 1, 1,
                                     out=blob[5 : 5 + n].view(4, 23, -1))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_packed))
    assert (blob[:5] == SENTINEL).all() and (blob[5 + n :] == SENTINEL).all()
    np.testing.assert_array_equal(thinning.unpack_bitboards_plain(masks_b, w).numpy() * 255, np.asarray(ref_masks))
    _, own, _ = assign_tail(torch.from_numpy(img), torch.from_numpy(centers), 4, 1, 1)
    assert torch.equal(own, packed)


@pytest.mark.parametrize("w", [7, 33, 97])
def test_raster_frontend_dense_stores_match_jax(w):
    """The front-end's default route writes both dense outputs from the
    plain K6's store (no K1): the JAX package's ``raster_frontend``."""
    img = poster(20 + w, (40, w))
    labels = assign_nearest(torch.from_numpy(img), BENCH_CENTERS, 4).numpy()
    assert label_flips(img, BENCH_CENTERS, labels, np.asarray(jax_assign_nearest(img, BENCH_CENTERS, 4))) == 0
    edges, skels = raster_frontend(torch.from_numpy(img), BENCH_CENTERS, k=4)
    ref_e, ref_s = jax_raster_frontend(img, BENCH_CENTERS, k=4)
    assert edges.is_contiguous() and skels.is_contiguous()
    np.testing.assert_array_equal(edges.numpy(), np.asarray(ref_e))
    np.testing.assert_array_equal(skels.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("w", WIDTHS)
def test_morph_steps_plain_rows_in_and_out(w):
    """The plain K2 with packed rows in and out == the plain K2 between K1's
    plain conversions, and its rows == the JAX package's packing of the JAX
    boards."""
    rng = np.random.default_rng(w)
    rows = torch.from_numpy(random_rows(rng, (2, H), w))
    valid = morphology._valid_bits(w)
    steps = morphology.morph_program("ellipse", 3, 1, "ed") + morphology.morph_program("ellipse", 3, 1, "de")
    out = torch.full((2, H, -(-w // 8)), SENTINEL, dtype=torch.uint8)
    got = morphology.morph_steps(rows, valid, steps, w, out)
    ref = morphology.morph_steps_plain(rows_to_boards_plain(rows, w), valid, steps)
    assert torch.equal(got, ref)
    assert torch.equal(out, boards_to_rows_plain(ref, w))
    np.testing.assert_array_equal(out.numpy(), np.packbits(jax_dense(bitboards_to_jax(ref), w), axis=-1))


# --- what is left to the card -------------------------------------------------------------


def test_fused_wrappers_refuse_cpu_tensors():
    rows = torch.zeros((1, 4, 5), dtype=torch.uint8)
    boards = torch.zeros((1, 4, 2), dtype=torch.int32)
    out = torch.zeros((1, 1, 4, 5), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.morph_steps_cuda(rows, torch.zeros(2, dtype=torch.int32), (("rect", 3, "e"),), 40)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.zhang_suen_into_cuda(boards, 40, out, out)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.boards_to_dense_cuda(boards, 40, 255, out=torch.zeros((1, 4, 40), dtype=torch.uint8))


def test_layout_helpers_live_in_one_header():
    """``valid_mask`` and ``brev_bytes`` are defined once, in
    ``csrc/bitlayout.cuh``, which K1, K2 and K6 include."""
    header = (CSRC / "bitlayout.cuh").read_text()
    for fn in ("valid_mask", "brev_bytes", "row_word", "store_row_word", "store_dense_word"):
        assert f" {fn}(" in header
    for src in ("bitpack.cu", "morph_bits.cu", "bitboard_fixpoints.cu"):
        text = (CSRC / src).read_text()
        assert '#include "bitlayout.cuh"' in text
        assert "uint32_t valid_mask(" not in text and "uint32_t brev_bytes(" not in text


def test_row_bytes_and_layouts():
    assert kernels.LAYOUTS == {"rows": 1, "dense": 2}
    assert [kernels.row_bytes("rows", w) for w in WIDTHS] == [1, 1, 1, 4, 4, 5, 32]
    assert [kernels.row_bytes("dense", w) for w in WIDTHS] == list(WIDTHS)
    with pytest.raises(ValueError, match="layout"):
        thinning.zhang_suen_into(torch.zeros((1, 4, 1), dtype=torch.int32), 7, torch.zeros((1, 1, 4, 1),
                                 dtype=torch.uint8), torch.zeros((1, 1, 4, 1), dtype=torch.uint8), "packed")
