// K2 pw_morph_bits_run: one elementary packed dilation or erosion, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA fusion of plotweave/ops/morphology.py::morph_bits
// (_dilate_bits, _shift_cols_bits): dilation ORs the board shifted over the
// structuring element's taps, with zero fill (OpenCV's non-feeding border);
// erosion is ~dilate(~x & valid) & valid, so a read outside the layer gives
// 0 in the complement and counts as set (the non-constraining border).
//
// Boards: (k, H, NW) 32-bit words, 32 pixels per word, LSB-first; bit j of a
// word is column 32*w + j; `valid` has bits [0, W) of each word set.  Like the
// plain version, a dilation may set padding bits beyond W; the result is the
// plain version's, bit for bit.
//
// Design.  One thread computes one output word.  The element is passed by
// value as one 64-bit mask of column offsets per row of taps (bit dx + 31),
// so a thread loads the three words w-1..w+1 of each tap row once and ORs
// one funnel shift per tap; |dx| <= 31 keeps every shift inside those
// three words.  The wrapper runs a program ("ed", "de", x iterations) as one
// launch per elementary op over two ping-pong buffers.  In eager PyTorch the
// same op is dozens of launches (a shift, a concatenation and an OR per tap).
//
// Bound: memory and launches.  A launch reads 3 words per tap row and
// writes one word; at 4 x 1500 x 2000 px the board is 4 * 1500 * 63 words =
// 1.5 MB, which stays in the 50 MB L2, so an op costs about one launch.
// Running a whole program in one launch (a halo of the program's radius)
// would cut the launches; left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 63;  // |dx| <= 31, and the element is square

struct Element {
  int dy0;     // row offset of rows[0]
  int n_rows;  // <= kMaxRows
  unsigned long long rows[kMaxRows];  // bit dx + 31: a tap at (dy0 + i, dx)
};

// Word (r, w) of the operand: x for a dilation, ~x & valid for an erosion;
// 0 outside the layer (the zero fill of _shift_rows / _shift_words).
template <bool ERODE>
__device__ __forceinline__ uint32_t operand(const uint32_t* __restrict__ layer,
                                            const uint32_t* __restrict__ valid, int r, int w,
                                            int h, int nw) {
  if (r < 0 || r >= h || w < 0 || w >= nw) return 0u;
  uint32_t v = layer[(long)r * nw + w];
  return ERODE ? (~v & valid[w]) : v;
}

template <bool ERODE>
__global__ void __launch_bounds__(kThreads) morph_step(const uint32_t* __restrict__ in,
                                                       uint32_t* __restrict__ out,
                                                       const uint32_t* __restrict__ valid,
                                                       Element se, long total, int h, int nw) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int w = (int)(i % nw);
  long row_index = i / nw;
  int r = (int)(row_index % h);
  const uint32_t* layer = in + (row_index - r) * nw;

  uint32_t acc = 0u;
  for (int t = 0; t < se.n_rows; ++t) {
    unsigned long long m = se.rows[t];
    if (!m) continue;
    int rr = r + se.dy0 + t;
    uint32_t left = operand<ERODE>(layer, valid, rr, w - 1, h, nw);
    uint32_t mid = operand<ERODE>(layer, valid, rr, w, h, nw);
    uint32_t right = operand<ERODE>(layer, valid, rr, w + 1, h, nw);
    while (m) {
      int dx = __ffsll((long long)m) - 1 - 31;
      m &= m - 1;
      // bit j of the shifted word = bit j + dx of the row
      if (dx > 0)
        acc |= (mid >> dx) | (right << (32 - dx));
      else if (dx < 0)
        acc |= (mid << -dx) | (left >> (32 + dx));
      else
        acc |= mid;
    }
  }
  out[i] = ERODE ? (~acc & valid[w]) : acc;
}

}  // namespace

extern "C" {

// One dilation (erode = 0) or erosion (erode = 1) of the board `in` into
// `out` (no overlap).  row_masks[i] (host memory, n_rows <= 63) has bit
// dx + 31 set for each tap (dy0 + i, dx).  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an element the kernel does not take.
int pw_morph_bits_run(const uint32_t* in, uint32_t* out, const uint32_t* valid,
                      const unsigned long long* row_masks, int dy0, int n_rows, int erode, int k,
                      int h, int nw, void* stream) {
  if (n_rows < 0 || n_rows > kMaxRows) return (int)cudaErrorInvalidValue;
  long total = (long)k * h * nw;
  if (total == 0) return (int)cudaGetLastError();
  Element se;
  se.dy0 = dy0;
  se.n_rows = n_rows;
  for (int i = 0; i < kMaxRows; ++i) se.rows[i] = i < n_rows ? row_masks[i] : 0ull;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  if (erode)
    morph_step<true><<<grid, kThreads, 0, s>>>(in, out, valid, se, total, h, nw);
  else
    morph_step<false><<<grid, kThreads, 0, s>>>(in, out, valid, se, total, h, nw);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
