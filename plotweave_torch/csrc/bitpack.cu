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
// - pw_dense_to_boards: a warp per word, a lane per pixel, one
//   __ballot_sync; uint8 (or bool bytes) count as set where nonzero, int32
//   where > 0 (pack_bitboards's `binary > 0`).
// - pw_labels_to_boards: int32 labels -> the k one-hot boards, a warp per
//   word, one ballot per layer.
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
// surface, a layer too large for K6's resident route, and K12's route.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlayout.cuh"  // valid_mask, brev_bytes, row_word, store_row_word, store_dense16 (shared with K2, K6)

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dense_to_boards(const T* __restrict__ dense, uint32_t* __restrict__ boards, long n_words, int nw, int w) {
  const long i = ((long)blockIdx.x * kThreads + threadIdx.x) >> 5;  // one word a warp
  if (i >= n_words) return;
  const long row = i / nw;
  const int x = 32 * (int)(i - row * nw) + (threadIdx.x & 31);
  const bool bit = x < w && dense[row * w + x] > 0;
  const uint32_t m = __ballot_sync(0xffffffffu, bit);
  if ((threadIdx.x & 31) == 0) boards[i] = m;
}

__global__ void __launch_bounds__(kThreads)
    labels_to_boards(const int32_t* __restrict__ labels, uint32_t* __restrict__ boards, long n_words, int k, int h,
                     int nw, int w) {
  const long i = ((long)blockIdx.x * kThreads + threadIdx.x) >> 5;  // word i of the (image, row, word) grid
  if (i >= n_words) return;
  const long row = i / nw;  // image * h + row
  const int word = (int)(i - row * nw);
  const long img = row / h;
  const int x = 32 * word + (threadIdx.x & 31);
  const int label = x < w ? labels[row * w + x] : -1;
  for (int c = 0; c < k; ++c) {
    const uint32_t m = __ballot_sync(0xffffffffu, label == c);
    if ((threadIdx.x & 31) == 0) boards[((img * k + c) * h + (row - img * h)) * nw + word] = m;
  }
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

// (n_rows, w) elements of elem_size 1 (set where nonzero) or 4 (int32, set where > 0) -> words
int pw_dense_to_boards(const void* dense, uint32_t* boards, long n_rows, int w, int elem_size, void* stream) {
  if (bad(n_rows, w) || (elem_size != 1 && elem_size != 4)) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_size == 1)
    dense_to_boards<uint8_t><<<blocks(n_rows * nw * 32), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(dense), boards, n_rows * nw, nw, w);
  else
    dense_to_boards<int32_t><<<blocks(n_rows * nw * 32), kThreads, 0, s>>>(
        static_cast<const int32_t*>(dense), boards, n_rows * nw, nw, w);
  return (int)cudaGetLastError();
}

// (n_img, h, w) int32 labels -> (n_img, k, h, ceil(w/32)) one-hot boards
int pw_labels_to_boards(const int32_t* labels, uint32_t* boards, long n_img, int k, int h, int w, void* stream) {
  if (n_img <= 0 || h <= 0 || k <= 0 || bad(n_img * h, w) || bad(n_img * h * k, w)) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  labels_to_boards<<<blocks(n_img * h * nw * 32), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      labels, boards, n_img * h * nw, k, h, nw, w);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
