// K1: the layout conversions between packed rows, bitboards and dense
// pixels, for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Replaces the XLA fusions of plotweave/ops/bitpack.py::bitpack_rows (:15)
// and bitunpack_rows (:27) and of plotweave/ops/thinning.py::pack_bitboards
// (:166) and unpack_bitboards (:178), which eager PyTorch runs as a dozen
// launches over int32 and int64 planes.
//
// Layouts (csrc/bitlayout.cuh, whose word conversions K2's packed-row load
// and K6's stores share).  Packed rows: 8 px a byte, MSB first (np.packbits),
// a row of W px is ceil(W/8) bytes, so rows are not 4-byte aligned.
// Bitboards: 32 px a 32-bit word, LSB first, a row is ceil(W/32) words; bit j
// of word n is column 32 n + j.  Dense: one element a pixel.  Every board
// written here has its bits at and beyond W zero: K2, K5 and K6 rely on that.
//
// - pw_rows_to_boards: a thread per word gathers the row's 4 bytes (the last
//   word of a row the 1-3 that remain), reverses the bits inside each byte
//   (__brev turns the whole word round, __byte_perm puts the bytes back) and
//   masks the bits at and beyond W.
// - pw_boards_to_rows: the same reversal the other way; a thread stores the
//   1-4 bytes of its word that lie inside the row, anywhere in a larger
//   tensor (the chain's blob is written in place).
// - pw_boards_to_dense: a thread per 16 px; uint8 out is one 16-byte store
//   where W is a multiple of 16 (4 bits spread to 4 bytes by one multiply),
//   else byte stores; int32 out is 16 stores.  A set bit becomes `value`.
// - pw_dense_to_boards and pw_labels_to_boards, pixels -> words: a warp
//   forms a run of 32 consecutive output words (of each layer for labels).  Their pixels are one contiguous span of the flat plane, so the
//   warp reads the span's 16-byte aligned cover, and nothing else, as int4
//   loads, lane l taking vector v0 + l + 32 r in round r: every load
//   instruction reads 512 contiguous bytes.  A row that starts off a 16-byte boundary (W % 16 != 0 for
//   bytes, W % 4 != 0 for int32, or a view's data_ptr() off 16 bytes) is
//   only an offset into the span.  Bytes: each vector becomes 16 flag bits
//   (__vcmpne4, the four flags of a 32-bit lane gathered into a nibble by a
//   multiply, gather4), staged per warp in shared memory as one bit stream;
//   a lane then forms its output word, a funnel shift of two staged words
//   at the word's first pixel, masked at W.  int32 and labels: the
//   vectors are staged as pixels, 32 to a row of 33 ints, and a lane reads
//   its own word's 32 pixels (the lanes on 32 banks at once) and forms the
//   word (set where > 0; or where the label is c: a one-hot byte a pixel
//   for eight layers, then layer c's bits gathered four pixels a multiply,
//   k words from one read of the labels).  Every warp stores 128
//   contiguous bytes of a plane per store.  Index math is 32-bit (the
//   wrappers' range checks), one division a lane.
//   uint8 (and bool bytes) count as set where nonzero, int32 where > 0
//   (pack_bitboards's `binary > 0`); a label sets layer c where it is c, so
//   a label < 0 or >= k sets none.
//
// Bound: bytes.  Each conversion reads its input once and writes its output
// once and does a few integer operations a word; at 4 x 1500 x 2000 px the
// rows and boards are 1.5 MB each and the dense uint8 planes 12 MB.  On an
// H100 80GB HBM3 at 700 W two boards -> dense launches there take 9.0 us
// against 8.1 us of bytes, and a wrapper call 25-60 us of host time
// (PERF.md): a conversion costs its launch, not its kernel.  So the raster
// chain, the device k-means stage and the front-end's K6 route launch none
// of these: K2 loads packed rows and stores them beside its boards, and K6
// stores the edges and the skeletons as packed rows or dense bytes
// (morph_bits.cu, bitboard_fixpoints.cu).  They remain for the plotweave.ops
// surface, the unfused stage 03/04 path, parallel/spatial.py's thinning of
// dense slabs, and K12's route.  The first pixel -> word kernels, a lane a
// pixel with a 64-bit division each and a ballot a word, took 0.0357 ms
// alone for the 4.03 us of uint8 -> boards at 4 x 1500 x 2000 (PERF.md):
// instruction issue, not bytes, bound them; the vector loads and staged
// words above are their redesign.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlayout.cuh"  // valid_mask, brev_bytes, row_word, store_row_word, store_dense16, gather4 (shared with K2, K6)

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    rows_to_boards(const uint8_t* __restrict__ rows, uint32_t* __restrict__ boards, long n_words, int nw, int wb,
                   int w) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const long row = i / nw;
  const int word = (int)(i - row * nw);
  boards[i] = row_word(rows + row * wb, word, wb, w);
}

__global__ void __launch_bounds__(kThreads)
    boards_to_rows(const uint32_t* __restrict__ boards, uint8_t* __restrict__ rows, long n_words, int nw, int wb,
                   int w) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_words) return;
  const long row = i / nw;
  const int word = (int)(i - row * nw);
  store_row_word(rows + row * wb, word, wb, w, boards[i]);
}

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

// The words [i0, i1] of a warp (i1 its last) as pixels of the flat plane,
// offset by `mis` pixels from the cover's 16-byte aligned start: the first
// and the last vector of the span (`per` pixels a vector), the first word's
// row and word.
struct Span {
  uint32_t v0, vlast, r0, j0;
};

__device__ __forceinline__ Span span_of(uint32_t i0, uint32_t i1, uint32_t nw, uint32_t w, uint32_t mis,
                                        uint32_t per) {
  Span s;
  s.r0 = i0 / nw;
  s.j0 = i0 - s.r0 * nw;
  const uint32_t r1 = i1 / nw, j1 = i1 - r1 * nw;
  s.v0 = (mis + s.r0 * w + 32u * s.j0) / per;
  s.vlast = (mis + r1 * w + min(32u * j1 + 32u, w) - 1u) / per;
  return s;
}

// uint8 (or bool bytes) -> words, set where nonzero: a warp forms words
// [i0, i0 + 32), lane l word i0 + l.  The span's vectors become one bit
// stream in shared memory (bit p - 16 v0 for the pixel at offset p of the
// cover), every slot written (zero past vlast), so a word is a funnel shift
// of two staged words.
__global__ void __launch_bounds__(kPackThreads)
    dense_to_boards_bytes(const uint4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words,
                          uint32_t nw, uint32_t w, uint32_t mis) {
  __shared__ uint32_t bits[kPackWarps][16 * kByteRounds];
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t i0 = (blockIdx.x * kPackWarps + warp) * 32u;
  if (i0 >= n_words) return;
  const Span s = span_of(i0, min(n_words, i0 + 32u) - 1u, nw, w, mis, 16u);
  uint4 v[kByteRounds];
#pragma unroll
  for (int r = 0; r < kByteRounds; ++r) {
    const uint32_t q = s.v0 + lane + 32u * r;
    v[r] = q <= s.vlast ? __ldg(cover + q) : make_uint4(0u, 0u, 0u, 0u);
  }
  uint16_t* stream = reinterpret_cast<uint16_t*>(bits[warp]);
#pragma unroll
  for (int r = 0; r < kByteRounds; ++r) stream[lane + 32 * r] = (uint16_t)nonzero16(v[r]);
  __syncwarp();
  const uint32_t i = i0 + lane;
  if (i >= n_words) return;
  const uint32_t row = i / nw, j = i - row * nw, b = mis + row * w + 32u * j - 16u * s.v0;
  boards[i] = __funnelshift_r(bits[warp][b >> 5], bits[warp][(b >> 5) + 1], b & 31) & valid_mask(j, w);
}

// int32 -> words, set where > 0 (kLabels false, k = 1), or labels -> the k
// one-hot planes (bit x of plane c set where the label is c): a warp forms
// words [i0, i0 + 32) of the (image, row, word) grid, lane l word i0 + l of
// every layer.  The span's vectors are staged as pixels, 32 to a row of 33
// ints (pixel p at p + p / 32; zero past the span), so that the lanes, each
// reading pixel x of its own word at once, hit 32 banks; a lane reads its
// word's 32 pixels (all inside the stage: past the row they are the next
// row's, or zero, and count as -1) and forms each layer's word from them:
// int32, one compare a pixel; labels, a one-hot byte a pixel, then a
// multiply a layer and four pixels.  Word i of image g goes to plane c at
// i + (g (k - 1) + c) h nw (h nw = `plane`; for k = 1, i).  CTAs of four
// warps: the grid is one wave, and smaller CTAs spread it more evenly over
// the SMs.  The two kernels below are its instances, under names of their
// own in a profiler's trace.
constexpr int kWordThreads = 128;
constexpr int kWordWarps = kWordThreads / 32;
constexpr int kStageInts = 32 * kWordRounds * 4 * 33 / 32;

template <bool kLabels>
__device__ __forceinline__ void words_to_boards(const int4* __restrict__ cover, uint32_t* __restrict__ boards,
                                                uint32_t n_words, uint32_t nw, uint32_t w, uint32_t mis, int k,
                                                uint32_t plane) {
  __shared__ int stage[kWordWarps][kStageInts];
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t i0 = (blockIdx.x * kWordWarps + warp) * 32u;
  if (i0 >= n_words) return;
  const uint32_t i1 = min(n_words, i0 + 32u) - 1u;
  const Span s = span_of(i0, i1, nw, w, mis, 4u);
  int4 v[kWordRounds];
#pragma unroll
  for (int r = 0; r < kWordRounds; ++r) {
    const uint32_t q = s.v0 + lane + 32u * r;
    v[r] = q <= s.vlast ? __ldg(cover + q) : make_int4(0, 0, 0, 0);
  }
  int* st = stage[warp];
#pragma unroll
  for (int r = 0; r < kWordRounds; ++r) {
    int* d = st + 4u * (lane + 32u * r) + (lane + 32u * r) / 8u;  // pixels 4 q to 4 q + 3 of the span, q = lane + 32 r
    d[0] = v[r].x, d[1] = v[r].y, d[2] = v[r].z, d[3] = v[r].w;
  }
  __syncwarp();
  const uint32_t i = i0 + lane;
  if (i > i1) return;
  const uint32_t row = i / nw, j = i - row * nw;
  const uint32_t p0 = mis + row * w + 32u * j - 4u * s.v0, n = min(32u, w - 32u * j);
  int label[32];
#pragma unroll
  for (uint32_t x = 0; x < 32; ++x) {
    const uint32_t p = p0 + x;
    const int px = st[p + p / 32u];
    label[x] = x < n ? px : -1;
  }
  if (!kLabels) {
    uint32_t word = 0u;
#pragma unroll
    for (uint32_t x = 0; x < 32; ++x) word |= (uint32_t)(label[x] > 0) << x;
    boards[i] = word;
    return;
  }
  // eight layers at a time: each pixel's one-hot byte (bit c - c0 where its
  // label is c), four pixels to a register; layer c's word gathers bit
  // c - c0 of every byte, four pixels a multiply (gather4)
  const uint32_t base = i + (i / plane) * (uint32_t)(k - 1) * plane;
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

__global__ void __launch_bounds__(kWordThreads)
    dense_to_boards_words(const int4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words,
                          uint32_t nw, uint32_t w, uint32_t mis) {
  words_to_boards<false>(cover, boards, n_words, nw, w, mis, 1, 0u);
}

__global__ void __launch_bounds__(kWordThreads)
    labels_to_boards(const int4* __restrict__ cover, uint32_t* __restrict__ boards, uint32_t n_words, uint32_t nw,
                     uint32_t w, uint32_t mis, int k, uint32_t plane) {
  words_to_boards<true>(cover, boards, n_words, nw, w, mis, k, plane);
}

unsigned blocks(long threads) { return (unsigned)((threads + kThreads - 1) / kThreads); }

bool bad(long n_rows, int w) { return n_rows <= 0 || w <= 0 || n_rows * (long)((w + 31) / 32) >= (1L << 31) / 32; }

}  // namespace

extern "C" {

// Each function converts n_rows rows of w px and returns a CUDA error code (0
// on success), cudaErrorInvalidValue for sizes its grid does not take.

// (n_rows, ceil(w/8)) bytes -> (n_rows, ceil(w/32)) words
int pw_rows_to_boards(const uint8_t* rows, uint32_t* boards, long n_rows, int w, void* stream) {
  if (bad(n_rows, w)) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  rows_to_boards<<<blocks(n_rows * nw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, boards, n_rows * nw, nw, (w + 7) / 8, w);
  return (int)cudaGetLastError();
}

// (n_rows, ceil(w/32)) words -> (n_rows, ceil(w/8)) bytes
int pw_boards_to_rows(const uint32_t* boards, uint8_t* rows, long n_rows, int w, void* stream) {
  if (bad(n_rows, w)) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  boards_to_rows<<<blocks(n_rows * nw), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      boards, rows, n_rows * nw, nw, (w + 7) / 8, w);
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
    dense_to_boards_words<<<(n_words + 32u * kWordWarps - 1) / (32u * kWordWarps), kWordThreads, 0, s>>>(
        reinterpret_cast<const int4*>(p & ~(uintptr_t)15), boards, n_words, nw, w, (p & 15) / 4);
    return (int)cudaGetLastError();
  }
  dense_to_boards_bytes<<<(n_words + 32u * kPackWarps - 1) / (32u * kPackWarps), kPackThreads, 0, s>>>(
      reinterpret_cast<const uint4*>(p & ~(uintptr_t)15), boards, n_words, nw, w, p & 15);
  return (int)cudaGetLastError();
}

// (n_img, h, w) int32 labels -> (n_img, k, h, ceil(w/32)) one-hot boards
int pw_labels_to_boards(const int32_t* labels, uint32_t* boards, long n_img, int k, int h, int w, void* stream) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(labels);
  if (n_img <= 0 || h <= 0 || k <= 0 || bad(n_img * h, w) || bad(n_img * h * k, w) || p % 4)
    return (int)cudaErrorInvalidValue;
  const uint32_t nw = (w + 31) / 32, n_words = (uint32_t)(n_img * h * nw);
  labels_to_boards<<<(n_words + 32u * kWordWarps - 1) / (32u * kWordWarps), kWordThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(reinterpret_cast<const int4*>(p & ~(uintptr_t)15), boards,
                                                          n_words, nw, w, (p & 15) / 4, k, (uint32_t)h * nw);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
