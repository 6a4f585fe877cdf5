// K1: the layout conversions between packed rows, bitboards and dense
// pixels, for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Layouts (csrc/bitlayout.cuh, whose word conversions K2's packed-row load
// and K6's stores share).  Packed rows: 8 px a byte, MSB first (np.packbits),
// a row of W px is ceil(W/8) bytes, so rows are not 4-byte aligned; the rows
// of a tensor are one contiguous stream of bytes.  Bitboards: 32 px a 32-bit
// word, LSB first, a row is ceil(W/32) words; bit j of word n is column
// 32 n + j.  Dense: one element a pixel.  Every board written here has its
// bits at and beyond W zero: K2, K5 and K6 rely on that.
//
// Kernels, the XLA programs each replaces, and their users:
// - dense_to_rows_bytes, dense_to_rows_words (pw_dense_to_rows): the fusion
//   of plotweave/ops/bitpack.py::bitpack_rows (:15), pixels straight to
//   packed rows, one launch; ops.bitpack.bitpack_rows on a card.
// - rows_to_dense (pw_rows_to_dense): bitunpack_rows (:27), packed rows
//   straight to 0/1 bytes, one launch; ops.bitpack.bitunpack_rows on a card.
// - rows_to_boards, boards_to_rows (pw_rows_to_boards, pw_boards_to_rows):
//   the same two programs stopped at the words.  No pipeline path launches
//   them, since K2 loads packed rows and K6 stores them itself:
//   rows_to_boards_cuda and boards_to_rows_cuda are the card references that
//   chip_smoke.py holds K2's packed-row load and K6's packed-row stores
//   against, and boards_to_rows serves zhang_suen_into's named "multi" route.
// - dense_to_boards_bytes, dense_to_boards_words (pw_dense_to_boards):
//   plotweave/ops/thinning.py::pack_bitboards (:166); thinning.pack_bitboards
//   on a card: the front-end's K12 route (its int32 skeletons), the unfused
//   stage 03/04 path and parallel/spatial.py's thinning of dense slabs.
// - labels_to_boards (pw_labels_to_boards): the one-hot pack of
//   plotweave/ops/frontend.py:85-86; frontend.onehot_boards on a card.
// - boards_to_dense (pw_boards_to_dense): unpack_bitboards (thinning.py:178);
//   thinning.unpack_bitboards and dense_from_boards on a card: the K12
//   route, the stage 03/04 path, the spatial thinning and dense morphology.
//
// Bound: bytes, for every kernel.  Each reads its input once, writes its
// output once and does a few integer operations a word; at 4 x 1500 x 2000
// px the rows and boards are 1.5 MB each and the dense uint8 planes 12 MB.
// The design keeps the issue of instructions below the bytes:
// - A warp forms a run of consecutive words of the (row, word) grid: 32, a
//   word a lane, for the pixel kernels and rows -> dense; 128 for rows <->
//   boards, lane l words 4 l to 4 l + 3, so that a warp keeps 528 bytes of
//   loads in flight (a word a lane kept 144 and reached 49 % of the bound
//   at 8 x 4400 x 4400, PERF.md).  Their pixels, and their packed-row bytes,
//   are one contiguous span of the flat stream (rows and words run on across
//   row ends), so the warp moves the span's 16-byte aligned cover, and
//   nothing else, as 16-byte vectors: a row or a tensor that starts off 16
//   bytes (W % 16 != 0 for bytes, W % 128 != 0 for rows, a view's
//   data_ptr() off 16 bytes) is only an offset into the span.  The word side
//   is 128 contiguous bytes a warp and store (a lane's four words one
//   16-byte vector where aligned).
// - Index math is 32-bit (the wrappers' range checks) with one division a
//   lane: its first word's row (its other words follow it, wrapping at the
//   row's end); the span's ends come from lane 0 and the run's last lane by
//   shuffles.
// - Loads: the vectors are staged in shared memory; a word is a funnel shift
//   of two staged words at its first byte or pixel.  Packed rows: 32 U words
//   span at most 128 U bytes, 8 U + 1 vectors; MSB-first bytes become an
//   LSB-first word by __byte_perm(__brev(.)) (brev_bytes) on the whole word,
//   masked at W.  uint8 and bool bytes: each vector becomes 16 flag
//   bits (__vcmpne4, the four flags of a 32-bit lane gathered into a nibble
//   by a multiply, gather4), one staged bit stream a warp.  int32 and
//   labels: the vectors staged as pixels, 32 to a row of 33 ints, a lane
//   reading its own word's 32 pixels (the lanes on 32 banks at once) and
//   forming each layer's word (set where > 0; or where the label is c: a
//   one-hot byte a pixel for eight layers, then layer c's bits gathered four
//   pixels a multiply, k words from one read of the labels).
// - Stores of packed rows: each lane ORs each word's 1-4 row bytes
//   (brev_bytes, bits at and beyond W zero) into a zeroed byte stage at its
//   offset (two shared atomics a word, whole words); the vectors inside the span
//   are stored whole, the first and the last byte by byte by 16 lanes each,
//   one instruction, only their bytes inside the span.  So no byte outside
//   the rows is written (out= into a blob at any offset), and no two warps
//   write one byte.  Stores of 0/1 pixels: each lane ORs its word into a
//   zeroed bit stage at its first pixel, a vector is 16 staged bits spread
//   to 16 bytes (spread4), stored the same way.
// - dense -> rows and rows -> dense are the pixel -> word and rows -> word
//   loads above with the rows or the pixel store in place of the board
//   store (template instances with names of their own), so bitpack_rows and
//   bitunpack_rows are one launch each, as the TPU's fusions were, with no
//   board plane between two launches.
// - boards_to_dense: a thread per 16 px, one 16-byte store where W and the
//   pointer allow (4 bits spread to 4 bytes by one multiply), else byte
//   stores; int32 out 16 stores.  A set bit becomes `value`.
// uint8 (and bool bytes) count as set where nonzero, int32 where > 0
// (pack_bitboards's `binary > 0`, bitpack_rows's `masks > 0`); a label sets
// layer c where it is c, so a label < 0 or >= k sets none.
//
// Why vectors and runs (PERF.md): a lane a pixel with a 64-bit division and
// a ballot a word (0.0357 ms alone for the 4.03 us of uint8 -> boards at
// 4 x 1500 x 2000), or a thread a word with a 64-bit division and a byte
// load or store at a time (rows <-> boards at 27-35 % of their bound), is
// bound by instruction issue, not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlayout.cuh"  // valid_mask, brev_bytes, store_dense16, spread4, gather4 (shared with K2, K6)

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    boards_to_dense(const uint32_t* __restrict__ boards, T* __restrict__ dense, long n_chunks, int nw, int w,
                    int chunks, int value, int vec) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_chunks) return;
  const long row = i / chunks;
  const int x0 = 16 * (int)(i - row * chunks);
  const uint32_t bits = (boards[row * nw + (x0 >> 5)] >> (x0 & 31)) & 0xffffu;
  T* p = dense + row * w + x0;
  const int n = min(16, w - x0);
  if constexpr (sizeof(T) == 1) {
    store_dense16(reinterpret_cast<uint8_t*>(p), bits, n, (uint32_t)value, vec);
    return;
  }
  for (int j = 0; j < n; ++j) p[j] = (T)(((bits >> j) & 1u) ? value : 0);
}

// Lane l of a warp's run of 32 U words [i0, i0 + 32 U): its first word i =
// i0 + U l of the (row, word) grid, that word's row and word j in the row
// (the lane's one division; its other words follow, j wrapping to the next
// row), how many of its U words are among the n_words (0 for a lane past
// them, which sits on the run's last lane's first word and moves nothing),
// and `last`, the run's last lane that holds one.
template <int U>
struct RunLane {
  uint32_t i, row, j, last, live;
};

template <int U>
__device__ __forceinline__ RunLane<U> run_lane(uint32_t i0, uint32_t n_words, uint32_t nw) {
  RunLane<U> r;
  const uint32_t lane = threadIdx.x & 31u;
  r.last = min(31u, (n_words - 1u - i0) / U);
  r.i = i0 + U * min(lane, r.last);
  r.live = lane <= r.last ? min((uint32_t)U, n_words - r.i) : 0u;
  r.row = r.i / nw;
  r.j = r.i - r.row * nw;
  return r;
}

// The first and the last `per`-unit vector of the run's span [a of lane 0,
// b of lane `last`) of a stream whose tensor starts `mis` units past its
// cover's 16-byte aligned start.
template <int U>
__device__ __forceinline__ uint2 run_vectors(uint32_t a, uint32_t b, const RunLane<U>& r, uint32_t mis,
                                             uint32_t per) {
  return make_uint2((mis + __shfl_sync(kFull, a, 0)) / per, (mis + __shfl_sync(kFull, b, r.last) - 1u) / per);
}

// A packed row's shape: w px, wb = ceil(w/8) bytes, nw = ceil(w/32) words.
struct Rows {
  uint32_t w, wb, nw;
};

// The bytes of word j of a packed row: 4, the row's last word the 1-4 that remain.
__device__ __forceinline__ uint32_t word_bytes(uint32_t j, const Rows& g) { return min(4u, g.wb - 4u * j); }

// The next word of the grid after word j of a row.
__device__ __forceinline__ uint32_t next_word(uint32_t j, const Rows& g) { return j + 1u == g.nw ? 0u : j + 1u; }

// Packed rows, per warp: 32 U words span at most 128 U bytes, which lie in at
// most 8 U + 1 vectors of the cover (15 bytes of offset + 128 U); the stage
// holds those vectors.  Pixels: 32 U words span at most 1024 U px, in at most
// 64 U + 1 vectors, 16 staged bits each: 32 U + 1 words.
template <int U>
struct RunStage {
  static constexpr int kVectors = 8 * U + 1;
  static constexpr int kWords = 4 * kVectors;
  static constexpr int kBits = 32 * U + 1;
};

// The lane's row bytes [x, y) of the packed-row stream: its live words'
// bytes, one after another (rows run on in the stream).
template <int U>
__device__ __forceinline__ uint2 lane_bytes(const RunLane<U>& r, const Rows& g) {
  const uint32_t start = r.row * g.wb + 4u * r.j;
  uint32_t end = start, j = r.j;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if ((uint32_t)k < r.live) end += word_bytes(j, g);
    j = next_word(j, g);
  }
  return make_uint2(start, end);
}

// A warp's run of words from packed rows (`cover`, the rows' 16-byte
// aligned cover, the tensor `mis` bytes into it): lane q loads vectors
// v0 + q + 32 n of the span into the stage `st` (zero past the span's last),
// and each lane forms each of its words from the two staged words at the
// word's first byte, its bits at and beyond w zero.
template <int U>
__device__ __forceinline__ void load_rows_run(const uint4* __restrict__ cover, uint32_t mis, uint32_t* st,
                                              const RunLane<U>& r, const Rows& g, uint32_t (&words)[U]) {
  constexpr int kVectors = RunStage<U>::kVectors;
  const uint32_t lane = threadIdx.x & 31u;
  const uint2 s = lane_bytes(r, g);
  const uint2 v = run_vectors(s.x, s.y, r, mis, 16u);
#pragma unroll
  for (int n = 0; n < (kVectors + 31) / 32; ++n) {
    const uint32_t q = lane + 32u * n;
    if (q < (uint32_t)kVectors)
      reinterpret_cast<uint4*>(st)[q] = v.x + q <= v.y ? __ldg(cover + v.x + q) : make_uint4(0u, 0u, 0u, 0u);
  }
  __syncwarp();
  uint32_t b = mis + s.x - 16u * v.x, j = r.j;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    words[k] = brev_bytes(__funnelshift_r(st[b >> 2], st[(b >> 2) + 1], 8u * (b & 3u))) & valid_mask(j, g.w);
    b += word_bytes(j, g);
    j = next_word(j, g);
  }
}

// The first and the last of a span's vectors, byte by byte: lane l < 16 byte
// l of vector 0, lane 16 + l byte l of vector nv - 1 (none where nv is 1),
// each written where it lies in the span [start, end) of the cover, from
// `byte(t)`, byte t of the stage.
template <typename Byte>
__device__ __forceinline__ void store_span_ends(uint8_t* __restrict__ cover, uint32_t v0, uint32_t nv,
                                                uint32_t start, uint32_t end, Byte byte) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t t = (lane < 16u ? 0u : 16u * (nv - 1u)) + (lane & 15u), at = 16u * v0 + t;
  if ((lane < 16u || nv > 1u) && at >= start && at < end) cover[at] = byte(t);
}

// 32-bit `v` ORed into a zeroed stage at bit c: two shared atomics at most.
__device__ __forceinline__ void or_bits(uint32_t* stage, uint32_t c, uint32_t v) {
  const uint32_t sh = c & 31u;
  atomicOr(stage + (c >> 5), v << sh);
  if (sh) atomicOr(stage + (c >> 5) + 1, v >> (32u - sh));
}

// A warp's run of words as packed rows (`cover`, the rows' 16-byte aligned
// cover, the tensor `mis` bytes into it): each of the lane's live words
// (any bits at and beyond w are dropped) is ORed as its 1-4 row bytes into
// the zeroed stage `st` at its offset, then the span's vectors are stored:
// those inside it whole, the first and the last byte by byte.  Only the
// span's bytes are written.
template <int U>
__device__ __forceinline__ void store_rows_run(uint4* __restrict__ cover, uint32_t mis, uint32_t* st,
                                               const RunLane<U>& r, const Rows& g, const uint32_t (&words)[U]) {
  constexpr int kVectors = RunStage<U>::kVectors;
  const uint32_t lane = threadIdx.x & 31u;
  const uint2 s = lane_bytes(r, g);
  const uint2 vec = run_vectors(s.x, s.y, r, mis, 16u);
  const uint32_t nv = vec.y - vec.x + 1u;
#pragma unroll
  for (int n = 0; n < (kVectors + 31) / 32; ++n)
    if (lane + 32u * n < (uint32_t)kVectors) reinterpret_cast<uint4*>(st)[lane + 32u * n] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
  uint32_t b = mis + s.x - 16u * vec.x, j = r.j;
#pragma unroll
  for (int k = 0; k < U; ++k) {
    if ((uint32_t)k < r.live) or_bits(st, 8u * b, brev_bytes(words[k] & valid_mask(j, g.w)));
    b += word_bytes(j, g);
    j = next_word(j, g);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < (kVectors + 31) / 32; ++n) {
    const uint32_t q = lane + 32u * n;
    if (q >= 1u && q + 1u < nv) cover[vec.x + q] = reinterpret_cast<const uint4*>(st)[q];
  }
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(st);
  store_span_ends(reinterpret_cast<uint8_t*>(cover), vec.x, nv, mis + __shfl_sync(kFull, s.x, 0),
                  mis + __shfl_sync(kFull, s.y, r.last), [&](uint32_t t) { return bytes[t]; });
}

// 16 bits -> 16 bytes of 0/1, bit b on byte b
__device__ __forceinline__ uint4 spread16(uint32_t bits) {
  return make_uint4(spread4(bits & 15u), spread4((bits >> 4) & 15u), spread4((bits >> 8) & 15u),
                    spread4((bits >> 12) & 15u));
}

// A warp's run of words (a word a lane) as 0/1 bytes a pixel (`cover`, the
// dense plane's 16-byte aligned cover, the tensor `mis` bytes into it):
// lane l's word `v` (bits at and beyond w zero) is ORed into the zeroed bit
// stage `bits` at its first pixel's offset from the cover's vector v0, then
// vector q of the span is 16 staged bits spread to bytes: those inside the
// span stored whole, the first and the last byte by byte.  Only the span's
// bytes are written.
__device__ __forceinline__ void store_dense_run(uint4* __restrict__ cover, uint32_t mis, uint32_t* bits,
                                                const RunLane<1>& r, const Rows& g, uint32_t v) {
  constexpr int kBits = RunStage<1>::kBits;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t p = r.row * g.w + 32u * r.j, n = r.live ? min(32u, g.w - 32u * r.j) : 0u;
  const uint2 vec = run_vectors(p, p + n, r, mis, 16u);
  const uint32_t nv = vec.y - vec.x + 1u;
  bits[lane] = 0u;
  if (lane < (uint32_t)(kBits - 32)) bits[32 + lane] = 0u;
  __syncwarp();
  if (n) or_bits(bits, mis + p - 16u * vec.x, v);
  __syncwarp();
  for (uint32_t q = lane + 1u; q + 1u < nv; q += 32u) cover[vec.x + q] = spread16(bits[q >> 1] >> (16u * (q & 1u)));
  store_span_ends(reinterpret_cast<uint8_t*>(cover), vec.x, nv, mis + __shfl_sync(kFull, p, 0),
                  mis + __shfl_sync(kFull, p + n, r.last),
                  [&](uint32_t t) { return (uint8_t)((bits[t >> 5] >> (t & 31u)) & 1u); });
}

// rows <-> boards: runs of 32 U words a warp, U = 4 consecutive words a lane
// (the words of a lane one 16-byte vector of the board plane where it is
// aligned), 8 warps a CTA; rows -> dense: a word a lane.  (A word a lane
// left one 144-byte load a warp in flight and took 0.0238 ms alone for 8 x
// 4400 x 4400 rows -> boards against a bound of 0.0116: PERF.md.)
constexpr int kRunThreads = 256;
constexpr int kRunWarps = kRunThreads / 32;
constexpr int kLaneWords = 4;

__global__ void __launch_bounds__(kRunThreads)
    rows_to_boards(const uint4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words, Rows g,
                   uint32_t mis) {
  constexpr int U = kLaneWords;
  __shared__ __align__(16) uint32_t st[kRunWarps][RunStage<U>::kWords];
  const uint32_t warp = threadIdx.x >> 5, i0 = (blockIdx.x * kRunWarps + warp) * 32u * U;
  if (i0 >= n_words) return;
  const RunLane<U> r = run_lane<U>(i0, n_words, g.nw);
  uint32_t words[U];
  load_rows_run(cover, mis, st[warp], r, g, words);
  uint32_t* out = boards + r.i;
  if (r.live == U && reinterpret_cast<uintptr_t>(out) % 16 == 0) {
    *reinterpret_cast<uint4*>(out) = make_uint4(words[0], words[1], words[2], words[3]);
    return;
  }
#pragma unroll
  for (int k = 0; k < U; ++k)
    if ((uint32_t)k < r.live) out[k] = words[k];
}

__global__ void __launch_bounds__(kRunThreads)
    boards_to_rows(const uint32_t* __restrict__ boards, uint4* __restrict__ cover, uint32_t n_words, Rows g,
                   uint32_t mis) {
  constexpr int U = kLaneWords;
  __shared__ __align__(16) uint32_t st[kRunWarps][RunStage<U>::kWords];
  const uint32_t warp = threadIdx.x >> 5, i0 = (blockIdx.x * kRunWarps + warp) * 32u * U;
  if (i0 >= n_words) return;
  const RunLane<U> r = run_lane<U>(i0, n_words, g.nw);
  const uint32_t* in = boards + r.i;
  uint32_t words[U];
  if (r.live == U && reinterpret_cast<uintptr_t>(in) % 16 == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(in));
    words[0] = v.x, words[1] = v.y, words[2] = v.z, words[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < U; ++k) words[k] = (uint32_t)k < r.live ? __ldg(in + k) : 0u;
  }
  store_rows_run(cover, mis, st[warp], r, g, words);
}

__global__ void __launch_bounds__(kRunThreads)
    rows_to_dense(const uint4* __restrict__ cover, uint4* __restrict__ dense, uint32_t n_words, Rows g, uint32_t mis,
                  uint32_t dense_mis) {
  __shared__ __align__(16) uint32_t st[kRunWarps][RunStage<1>::kWords];
  __shared__ uint32_t bits[kRunWarps][RunStage<1>::kBits];
  const uint32_t warp = threadIdx.x >> 5, i0 = (blockIdx.x * kRunWarps + warp) * 32u;
  if (i0 >= n_words) return;
  const RunLane<1> r = run_lane<1>(i0, n_words, g.nw);
  uint32_t word[1];
  load_rows_run(cover, mis, st[warp], r, g, word);
  store_dense_run(dense, dense_mis, bits[warp], r, g, word[0]);
}

// The byte kernel's threads a CTA and 16-byte vector rounds, and the int32
// and label kernel's rounds: bytes, 32 words of a warp span at most 1024 +
// 15 bytes, 65 vectors; int32, 32 words span at most 4096 + 12 bytes, 257.
// (A lane forming 2 or 4 words of the bytes was slower alone at 1-8 layers
// of 1500 x 2000: PERF.md.)
constexpr int kPackThreads = 256;
constexpr int kPackWarps = kPackThreads / 32;
constexpr int kByteRounds = 3;
constexpr int kWordRounds = 9;

// The nonzero bytes of a 16-byte vector as 16 bits, byte b on bit b.
__device__ __forceinline__ uint32_t nonzero16(uint4 v) {
  return gather4(__vcmpne4(v.x, 0u)) | gather4(__vcmpne4(v.y, 0u)) << 4 | gather4(__vcmpne4(v.z, 0u)) << 8 |
         gather4(__vcmpne4(v.w, 0u)) << 12;
}

// Where the pixel -> word kernels put their words: boards (int32 set where
// > 0, or bytes set where nonzero), the k one-hot boards of labels, or
// packed rows (`out` the rows' 16-byte aligned cover, `out_mis` bytes before
// the tensor).
enum Out { kToBoards, kToOneHot, kToRows };

// uint8 (or bool bytes) -> words, set where nonzero: a warp forms words
// [i0, i0 + 32), lane l word i0 + l.  The span's vectors become one bit
// stream in shared memory (bit p - 16 v0 for the pixel at offset p of the
// cover), every slot written (zero past vlast), so a word is a funnel shift
// of two staged words.  The two kernels below are its instances.
template <Out kOut>
__device__ __forceinline__ void bytes_to_words(const uint4* __restrict__ cover, void* __restrict__ out,
                                               uint32_t n_words, uint32_t nw, uint32_t w, uint32_t mis,
                                               uint32_t out_mis) {
  __shared__ uint32_t bits[kPackWarps][16 * kByteRounds];
  __shared__ __align__(16) uint32_t st[kOut == kToRows ? kPackWarps : 1][RunStage<1>::kWords];
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t i0 = (blockIdx.x * kPackWarps + warp) * 32u;
  if (i0 >= n_words) return;
  const RunLane<1> r = run_lane<1>(i0, n_words, nw);
  const uint32_t p = r.row * w + 32u * r.j;
  const uint2 s = run_vectors(p, p + min(32u, w - 32u * r.j), r, mis, 16u);
  uint4 v[kByteRounds];
#pragma unroll
  for (int k = 0; k < kByteRounds; ++k) {
    const uint32_t q = s.x + lane + 32u * k;
    v[k] = q <= s.y ? __ldg(cover + q) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint16_t* stream = reinterpret_cast<uint16_t*>(bits[warp]);
#pragma unroll
  for (int k = 0; k < kByteRounds; ++k) stream[lane + 32 * k] = (uint16_t)nonzero16(v[k]);
  __syncwarp();
  const uint32_t b = mis + p - 16u * s.x;
  const uint32_t word[1] = {__funnelshift_r(bits[warp][b >> 5], bits[warp][(b >> 5) + 1], b & 31) &
                            valid_mask(r.j, w)};
  if constexpr (kOut == kToRows) {
    store_rows_run(static_cast<uint4*>(out), out_mis, st[warp], r, Rows{w, (w + 7u) / 8u, nw}, word);
  } else if (r.live) {
    static_cast<uint32_t*>(out)[r.i] = word[0];
  }
}

__global__ void __launch_bounds__(kPackThreads)
    dense_to_boards_bytes(const uint4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words,
                          uint32_t nw, uint32_t w, uint32_t mis) {
  bytes_to_words<kToBoards>(cover, boards, n_words, nw, w, mis, 0u);
}

__global__ void __launch_bounds__(kPackThreads)
    dense_to_rows_bytes(const uint4* __restrict__ cover, uint4* __restrict__ rows, uint32_t n_words, uint32_t nw,
                        uint32_t w, uint32_t mis, uint32_t rows_mis) {
  bytes_to_words<kToRows>(cover, rows, n_words, nw, w, mis, rows_mis);
}

// int32 -> words, set where > 0 (kToBoards, kToRows; k = 1), or labels ->
// the k one-hot planes (kToOneHot: bit x of plane c set where the label is
// c): a warp forms words [i0, i0 + 32) of the (image, row, word) grid, lane
// l word i0 + l of every layer.  The span's vectors are staged as pixels, 32
// to a row of 33 ints (pixel p at p + p / 32; zero past the span), so that
// the lanes, each reading pixel x of its own word at once, hit 32 banks; a
// lane reads its word's 32 pixels (all inside the stage: past the row they
// are the next row's, or zero, and count as -1) and forms each layer's word
// from them: int32, one compare a pixel; labels, a one-hot byte a pixel,
// then a multiply a layer and four pixels.  Word i of image g goes to plane
// c at i + (g (k - 1) + c) h nw (h nw = `plane`; for k = 1, i); packed rows
// are stored as store_rows_run stores them, `out_mis` bytes into `out`.  CTAs of
// four warps: the grid is one wave, and smaller CTAs spread it more evenly
// over the SMs.  The three kernels below are its instances, under names of
// their own in a profiler's trace.
constexpr int kWordThreads = 128;
constexpr int kWordWarps = kWordThreads / 32;
constexpr int kStageInts = 32 * kWordRounds * 4 * 33 / 32;

template <Out kOut>
__device__ __forceinline__ void ints_to_words(const int4* __restrict__ cover, void* __restrict__ out,
                                              uint32_t n_words, uint32_t nw, uint32_t w, uint32_t mis, int k,
                                              uint32_t plane, uint32_t out_mis) {
  __shared__ int stage[kWordWarps][kStageInts];
  __shared__ __align__(16) uint32_t st[kOut == kToRows ? kWordWarps : 1][RunStage<1>::kWords];
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t i0 = (blockIdx.x * kWordWarps + warp) * 32u;
  if (i0 >= n_words) return;
  const RunLane<1> r = run_lane<1>(i0, n_words, nw);
  const uint32_t x0 = r.row * w + 32u * r.j, n = min(32u, w - 32u * r.j);
  const uint2 s = run_vectors(x0, x0 + n, r, mis, 4u);
  int4 v[kWordRounds];
#pragma unroll
  for (int g = 0; g < kWordRounds; ++g) {
    const uint32_t q = s.x + lane + 32u * g;
    v[g] = q <= s.y ? __ldg(cover + q) : make_int4(0, 0, 0, 0);
  }
  int* stg = stage[warp];
#pragma unroll
  for (int g = 0; g < kWordRounds; ++g) {
    int* d = stg + 4u * (lane + 32u * g) + (lane + 32u * g) / 8u;  // pixels 4 q to 4 q + 3 of the span, q = lane + 32 g
    d[0] = v[g].x, d[1] = v[g].y, d[2] = v[g].z, d[3] = v[g].w;
  }
  __syncwarp();
  const uint32_t p0 = mis + x0 - 4u * s.x;
  int label[32];
#pragma unroll
  for (uint32_t x = 0; x < 32; ++x) {
    const uint32_t p = p0 + x;
    const int px = stg[p + p / 32u];
    label[x] = x < n ? px : -1;
  }
  if constexpr (kOut != kToOneHot) {
    uint32_t word[1] = {0u};
#pragma unroll
    for (uint32_t x = 0; x < 32; ++x) word[0] |= (uint32_t)(label[x] > 0) << x;
    if constexpr (kOut == kToRows) {
      store_rows_run(static_cast<uint4*>(out), out_mis, st[warp], r, Rows{w, (w + 7u) / 8u, nw}, word);
    } else if (r.live) {
      static_cast<uint32_t*>(out)[r.i] = word[0];
    }
  } else {
    if (!r.live) return;
    // eight layers at a time: each pixel's one-hot byte (bit c - c0 where
    // its label is c), four pixels to a register; layer c's word gathers bit
    // c - c0 of every byte, four pixels a multiply (gather4)
    uint32_t* boards = static_cast<uint32_t*>(out);
    const uint32_t base = r.i + (r.i / plane) * (uint32_t)(k - 1) * plane;
    for (int c0 = 0; c0 < k; c0 += 8) {
      uint32_t hot[8];
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        hot[g] = 0u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const uint32_t d = (uint32_t)label[4 * g + t] - (uint32_t)c0;
          hot[g] |= (d < 8u ? 1u << d : 0u) << (8 * t);
        }
      }
      for (int c = c0; c < min(k, c0 + 8); ++c) {
        uint32_t word = 0u;
#pragma unroll
        for (int g = 0; g < 8; ++g) word |= gather4(hot[g] >> (c - c0)) << (4 * g);
        boards[base + (uint32_t)c * plane] = word;
      }
    }
  }
}

__global__ void __launch_bounds__(kWordThreads)
    dense_to_boards_words(const int4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words,
                          uint32_t nw, uint32_t w, uint32_t mis) {
  ints_to_words<kToBoards>(cover, boards, n_words, nw, w, mis, 1, 0u, 0u);
}

__global__ void __launch_bounds__(kWordThreads)
    dense_to_rows_words(const int4* __restrict__ cover, uint4* __restrict__ rows, uint32_t n_words, uint32_t nw,
                        uint32_t w, uint32_t mis, uint32_t rows_mis) {
  ints_to_words<kToRows>(cover, rows, n_words, nw, w, mis, 1, 0u, rows_mis);
}

__global__ void __launch_bounds__(kWordThreads)
    labels_to_boards(const int4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words, uint32_t nw,
                     uint32_t w, uint32_t mis, int k, uint32_t plane) {
  ints_to_words<kToOneHot>(cover, boards, n_words, nw, w, mis, k, plane, 0u);
}

unsigned blocks(long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

// CTAs for n_words words, 32 a warp and `warps` (times the words a lane) a CTA
unsigned run_blocks(uint32_t n_words, int warps) { return (n_words + 32u * warps - 1u) / (32u * warps); }

Rows rows_of(int w) { return Rows{(uint32_t)w, (uint32_t)(w + 7) / 8, (uint32_t)(w + 31) / 32}; }

bool bad(long n_rows, int w) { return n_rows <= 0 || w <= 0 || n_rows * (long)((w + 31) / 32) >= (1L << 31) / 32; }

// the dense plane of n_rows x w pixels (and its 15 bytes of cover) past 32-bit indices
bool bad_dense(long n_rows, int w) { return n_rows * (long)w >= (1L << 31); }

const uint4* cover_of(const void* p) { return reinterpret_cast<const uint4*>((uintptr_t)p & ~(uintptr_t)15); }
uint4* cover_of(void* p) { return reinterpret_cast<uint4*>((uintptr_t)p & ~(uintptr_t)15); }
uint32_t mis_of(const void* p) { return (uint32_t)((uintptr_t)p & 15); }

}  // namespace

extern "C" {

// Each function converts n_rows rows of w px and returns a CUDA error code (0
// on success), cudaErrorInvalidValue for sizes its grid does not take.

// (n_rows, ceil(w/8)) bytes -> (n_rows, ceil(w/32)) words
int pw_rows_to_boards(const uint8_t* rows, uint32_t* boards, long n_rows, int w, void* stream) {
  if (bad(n_rows, w)) return (int)cudaErrorInvalidValue;
  const Rows g = rows_of(w);
  const uint32_t n_words = (uint32_t)(n_rows * g.nw);
  rows_to_boards<<<run_blocks(n_words, kRunWarps * kLaneWords), kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cover_of(rows), boards, n_words, g, mis_of(rows));
  return (int)cudaGetLastError();
}

// (n_rows, ceil(w/32)) words -> (n_rows, ceil(w/8)) bytes, no byte outside them written
int pw_boards_to_rows(const uint32_t* boards, uint8_t* rows, long n_rows, int w, void* stream) {
  if (bad(n_rows, w)) return (int)cudaErrorInvalidValue;
  const Rows g = rows_of(w);
  const uint32_t n_words = (uint32_t)(n_rows * g.nw);
  boards_to_rows<<<run_blocks(n_words, kRunWarps * kLaneWords), kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      boards, cover_of(rows), n_words, g, mis_of(rows));
  return (int)cudaGetLastError();
}

// (n_rows, ceil(w/8)) bytes -> (n_rows, w) bytes of 0/1
int pw_rows_to_dense(const uint8_t* rows, uint8_t* dense, long n_rows, int w, void* stream) {
  if (bad(n_rows, w) || bad_dense(n_rows, w)) return (int)cudaErrorInvalidValue;
  const Rows g = rows_of(w);
  const uint32_t n_words = (uint32_t)(n_rows * g.nw);
  rows_to_dense<<<run_blocks(n_words, kRunWarps), kRunThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cover_of(rows), cover_of(dense), n_words, g, mis_of(rows), mis_of(dense));
  return (int)cudaGetLastError();
}

// words -> (n_rows, w) elements of elem_size 1 (uint8) or 4 (int32), a set bit as `value`
int pw_boards_to_dense(const uint32_t* boards, void* dense, long n_rows, int w, int value, int elem_size,
                       void* stream) {
  if (bad(n_rows, w) || (elem_size != 1 && elem_size != 4)) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32, chunks = (w + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1) {
    const int vec = (w % 16 == 0) && ((uintptr_t)dense % 16 == 0);
    boards_to_dense<uint8_t><<<blocks(n_rows * chunks), kThreads, 0, s>>>(
        boards, static_cast<uint8_t*>(dense), n_rows * chunks, nw, w, chunks, value, vec);
  } else {
    boards_to_dense<int32_t><<<blocks(n_rows * chunks), kThreads, 0, s>>>(
        boards, static_cast<int32_t*>(dense), n_rows * chunks, nw, w, chunks, value, 0);
  }
  return (int)cudaGetLastError();
}

// (n_rows, w) elements of elem_size 1 (set where nonzero) or 4 (int32, set
// where > 0) -> words
int pw_dense_to_boards(const void* dense, uint32_t* boards, long n_rows, int w, int elem_size, void* stream) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(dense);
  if (bad(n_rows, w) || (elem_size != 1 && elem_size != 4) || p % elem_size) return (int)cudaErrorInvalidValue;
  const uint32_t nw = (w + 31) / 32, n_words = (uint32_t)(n_rows * nw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) {
    dense_to_boards_words<<<run_blocks(n_words, kWordWarps), kWordThreads, 0, s>>>(
        reinterpret_cast<const int4*>(cover_of(dense)), boards, n_words, nw, w, mis_of(dense) / 4);
    return (int)cudaGetLastError();
  }
  dense_to_boards_bytes<<<run_blocks(n_words, kPackWarps), kPackThreads, 0, s>>>(cover_of(dense), boards, n_words,
                                                                                  nw, w, mis_of(dense));
  return (int)cudaGetLastError();
}

// (n_rows, w) elements of elem_size 1 (set where nonzero) or 4 (int32, set
// where > 0) -> (n_rows, ceil(w/8)) packed rows, no byte outside them written
int pw_dense_to_rows(const void* dense, uint8_t* rows, long n_rows, int w, int elem_size, void* stream) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(dense);
  if (bad(n_rows, w) || (elem_size != 1 && elem_size != 4) || p % elem_size) return (int)cudaErrorInvalidValue;
  const uint32_t nw = (w + 31) / 32, n_words = (uint32_t)(n_rows * nw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 4) {
    dense_to_rows_words<<<run_blocks(n_words, kWordWarps), kWordThreads, 0, s>>>(
        reinterpret_cast<const int4*>(cover_of(dense)), cover_of(rows), n_words, nw, w, mis_of(dense) / 4,
        mis_of(rows));
    return (int)cudaGetLastError();
  }
  dense_to_rows_bytes<<<run_blocks(n_words, kPackWarps), kPackThreads, 0, s>>>(
      cover_of(dense), cover_of(rows), n_words, nw, w, mis_of(dense), mis_of(rows));
  return (int)cudaGetLastError();
}

// (n_img, h, w) int32 labels -> (n_img, k, h, ceil(w/32)) one-hot boards
int pw_labels_to_boards(const int32_t* labels, uint32_t* boards, long n_img, int k, int h, int w, void* stream) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(labels);
  if (n_img <= 0 || h <= 0 || k <= 0 || bad(n_img * h, w) || bad(n_img * h * k, w) || p % 4)
    return (int)cudaErrorInvalidValue;
  const uint32_t nw = (w + 31) / 32, n_words = (uint32_t)(n_img * h * nw);
  labels_to_boards<<<run_blocks(n_words, kWordWarps), kWordThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(cover_of(labels)), boards, n_words, nw, w, mis_of(labels) / 4, k,
      (uint32_t)h * nw);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
