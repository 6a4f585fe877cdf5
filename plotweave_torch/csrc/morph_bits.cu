// K2 pw_morph_steps_run: a sequence of packed dilations and erosions in one
// launch, for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).
//
// Replaces the XLA fusion of plotweave/ops/morphology.py::morph_bits (:133,
// with _dilate_bits and _shift_cols_bits, :101-122), and any chain of its
// calls: a step is one elementary op with its structuring element.
// Dilation ORs the board shifted over the element's taps, with zero fill
// (OpenCV's non-feeding border); erosion is ~dilate(~x & valid) & valid, so a
// read outside the layer gives 0 in the complement and counts as set (the
// non-constraining border).
//
// Boards: (k, H, NW) 32-bit words, 32 pixels per word, LSB-first; bit j of a
// word is column 32*w + j; `valid` has bits [0, W) of each word set.  Like the
// plain version, a dilation may set padding bits beyond W, the next dilation
// reads them, and an erosion's `& valid` clears them; the result is the plain
// version's, bit for bit.
//
// Design.  One block per (band of `band` output rows, layer), over the full
// row width.  It loads its band and `radius` rows above and below (radius =
// the sum of the steps' row radii) into shared memory, rows padded with a
// zero word on each side, and applies every step there between two buffers
// with a __syncthreads() between steps.  The rows a step computes shrink by
// its radius at each end of the band, so after the last step exactly the
// band's own rows are right, and only they are stored.  A row outside the
// layer is never computed and reads as 0 in the operand of every step (for
// an erosion, ~x & valid = 0), as the zero fill of _shift_rows does; the pad
// words read as 0 in both operands (valid is 0 there).  A block is 32 x 16
// threads: a warp takes 32 consecutive words of a row (conflict-free shared
// loads), the 16 warps take rows, and a thread computes one word at a time
// with no divide.  The element comes as one 64-bit mask of column offsets
// per row of taps (bit dx + 31), so a thread loads the three words w-1..w+1
// of each tap row once and ORs one funnel shift per tap; |dx| <= 31 keeps
// every shift inside those three words.  The instruction rate bounds this
// kernel, so a step of row radius 1 or 0 (every 3 x 3 element, so the
// defaults) takes a branch-free path: two funnel shifts per row of taps and
// three selectors made once per step, about a sixth of the instructions of
// the general loop's 64-bit find-first-set and branches.  Each step's masks
// are staged in shared memory, double-buffered by step parity, so one
// barrier per step serves both the board and the masks.
//
// Packed rows in and out (the chain's K1 fold).  Where the caller hands it
// packed rows (8 px a byte, MSB first, ceil(W/8) bytes a row, so not 4-byte
// aligned) instead of a board, the load builds each word from the row's own
// 1-4 bytes as K1's pw_rows_to_boards does (csrc/bitlayout.cuh: the bits of
// each byte reversed, the bits at and beyond W cleared), so the chain's
// upload goes straight into K2 with no conversion launch.  Where it hands
// an output for packed rows, the store writes each word's 1-4 bytes there
// beside the board (stage 02's device mode: the cleaned masks into the
// stage's blob).  Only a launch's first segment reads rows and only its last
// writes them; a list of no steps is one launch that converts.
//
// The step table is a small int64 device buffer that the wrapper builds once
// per step list and caches (ops/kernels.py::_step_table): per step a header
// (erode, row radius, rows of taps, index of its first mask), then the masks.
// The band is 32 rows (ops/kernels.py::MORPH_BAND, fewer for a shorter
// layer): at the defaults (ksize 3; radius 4 on the main path's open+close,
// 8 on the front-end's four programs) a block holds 40 or 48 rows of 65
// words, 22 or 26 KB with the masks, and 4 x 1500 rows make 188 blocks.
// Where the radius of a step list would not fit 227 KB, the wrapper splits
// it into segments before any launch, one launch each
// (ops/kernels.py::morph_schedule); a single step that does not fit a full
// band takes a shorter one.
//
// Bound: operations.  The function reads the board once and writes it once:
// at 4 x 1500 x 2000 px (4 x 1500 x 63 words, 1.5 MB) that is about 1 us at
// 3.35 TB/s, and the front-end's 8 steps of 3 x 3 elements are about 2.5 us
// of integer operations at the card's INT32 rate.  On an H100 80GB HBM3 at
// 700 W this kernel takes 23 us there (the general loop alone took 71 us)
// and a call adds 20-50 us of the wrapper's host work (PERF.md), so the
// whole sequence is one launch and one wrapper call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlayout.cuh"  // row_word, store_row_word (shared with K1, K6)

namespace {

constexpr int kLanes = 32;        // threadIdx.x: words of a row, one warp
constexpr int kRowLanes = 16;     // threadIdx.y: rows
constexpr int kThreads = kLanes * kRowLanes;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block
constexpr int kHead = 4;          // int64 header words per step
constexpr int kMaxRows = 63;      // rows of taps of one step: |dy| <= 31

size_t smem_bytes(int band, int radius, int nw) {
  return (size_t)(2 * (band + 2 * radius) + 1) * (size_t)(nw + 2) * sizeof(uint32_t);
}

__global__ void __launch_bounds__(kThreads)
    morph_steps(const uint32_t* __restrict__ in, const uint8_t* __restrict__ rows_in, uint32_t* __restrict__ out,
                uint8_t* __restrict__ rows_out, const uint32_t* __restrict__ valid,
                const long long* __restrict__ table, int step0, int n_steps, int radius, int band, int h, int nw,
                int width) {
  extern __shared__ uint32_t smem[];
  __shared__ unsigned long long masks[2][kMaxRows];  // the step's masks, by step parity
  const int stride = nw + 2;
  const int rows = band + 2 * radius;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kLanes + tx;
  uint32_t* vs = smem;  // valid, with a zero pad word on each side
  uint32_t* b0 = vs + stride;
  uint32_t* b1 = b0 + rows * stride;
  const int g0 = blockIdx.x * band - radius;  // the layer row of buffer row 0
  const long layer = (long)blockIdx.y * h * nw;
  const int wb = (width + 7) / 8;  // bytes of a packed row
  const long layer_rows = (long)blockIdx.y * h * wb;

  for (int j = tid; j < stride; j += kThreads) vs[j] = (j >= 1 && j <= nw) ? valid[j - 1] : 0u;
  for (int i = ty; i < rows; i += kRowLanes) {
    const int g = g0 + i;
    const bool inside = g >= 0 && g < h;
    for (int j = tx; j < stride; j += kLanes) {
      uint32_t v = 0u;
      if (inside && j >= 1 && j <= nw)
        v = rows_in ? row_word(rows_in + layer_rows + (long)g * wb, j - 1, wb, width)
                    : in[layer + (long)g * nw + j - 1];
      b0[i * stride + j] = v;
      b1[i * stride + j] = 0u;
    }
  }

  const uint32_t* x = b0;
  uint32_t* y = b1;
  int done = 0;  // the summed radius of the steps applied
  for (int s = 0; s < n_steps; ++s) {
    const long long* head = table + (long)(step0 + s) * kHead;
    const bool erode = head[0] != 0;
    const int r = (int)head[1], n_rows = (int)head[2];
    // step s - 2 read these masks last, and every thread has passed step s - 1's barrier since
    unsigned long long* m_s = masks[s & 1];
    if (tid < n_rows) m_s[tid] = (unsigned long long)table[head[3] + tid];
    done += r;
    // the rows this step gets right: inside the band's shrinking window and the layer
    const int lo = max(done, -g0), hi = min(rows - done, h - g0);
    __syncthreads();  // the load, or the previous step, and this step's masks are done
    if (r <= 1) {
      // at most 3 rows of taps with |dx| <= 1 (every 3 x 3 element): per row
      // of taps, all-ones or zero selectors of its taps at dx = -1, 0, +1
      uint32_t sel[3][3];
#pragma unroll
      for (int t = 0; t < 3; ++t)
#pragma unroll
        for (int d = 0; d < 3; ++d) sel[t][d] = t < n_rows ? 0u - (uint32_t)((m_s[t] >> (30 + d)) & 1ull) : 0u;
      for (int i = lo + ty; i < hi; i += kRowLanes) {
        for (int w = tx + 1; w <= nw; w += kLanes) {
          uint32_t acc = 0u;
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int ii = i - r + t, g = g0 + ii;
            if (t >= n_rows || g < 0 || g >= h) continue;  // a row outside the layer reads as 0
            const uint32_t* row = x + ii * stride;
            uint32_t left = row[w - 1], mid = row[w], right = row[w + 1];
            if (erode) {
              left = ~left & vs[w - 1];
              mid = ~mid & vs[w];
              right = ~right & vs[w + 1];
            }
            // bit j of each = bit j + dx of the row, dx = -1 and +1
            const uint32_t west = (mid << 1) | (left >> 31), east = (mid >> 1) | (right << 31);
            acc |= (sel[t][0] & west) | (sel[t][1] & mid) | (sel[t][2] & east);
          }
          y[i * stride + w] = erode ? (~acc & vs[w]) : acc;
        }
      }
    } else {
      for (int i = lo + ty; i < hi; i += kRowLanes) {
        for (int w = tx + 1; w <= nw; w += kLanes) {  // w: the padded word index
          uint32_t acc = 0u;
          for (int t = 0; t < n_rows; ++t) {
            unsigned long long m = m_s[t];
            const int ii = i - r + t, g = g0 + ii;
            if (!m || g < 0 || g >= h) continue;  // a row outside the layer reads as 0
            const uint32_t* row = x + ii * stride;
            uint32_t left = row[w - 1], mid = row[w], right = row[w + 1];
            if (erode) {
              left = ~left & vs[w - 1];
              mid = ~mid & vs[w];
              right = ~right & vs[w + 1];
            }
            while (m) {
              const int dx = __ffsll((long long)m) - 1 - 31;
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
          y[i * stride + w] = erode ? (~acc & vs[w]) : acc;
        }
      }
    }
    const uint32_t* t = y;
    y = const_cast<uint32_t*>(x);
    x = t;
  }
  __syncthreads();

  // the band's own rows: buffer rows [radius, radius + band), inside the layer
  for (int i = radius + ty; i < radius + band && g0 + i < h; i += kRowLanes)
    for (int w = tx; w < nw; w += kLanes) {
      const uint32_t v = x[i * stride + w + 1];
      out[layer + (long)(g0 + i) * nw + w] = v;
      if (rows_out) store_row_word(rows_out + layer_rows + (long)(g0 + i) * wb, w, wb, width, v);
    }
}

}  // namespace

extern "C" {

// Steps [step0, step0 + n_steps) of the step table `table` (device memory,
// see above) applied to the board `in`, or to the packed rows `rows_in` of
// `width` px (k, h, ceil(width/8)) bytes when `in` is null, written to
// `out` (no overlap), and as packed rows to `rows_out` too when it is not
// null.  `radius` is the sum of those steps' row radii and `band` the output
// rows of one block; n_steps may be 0 (a layout conversion alone).  Returns a
// CUDA error code (0 on success); cudaErrorInvalidValue for arguments the
// kernel does not take.
int pw_morph_steps_run(const uint32_t* in, const uint8_t* rows_in, uint32_t* out, uint8_t* rows_out,
                       const uint32_t* valid, const long long* table, int step0, int n_steps, int radius, int band,
                       int k, int h, int nw, int width, void* stream) {
  if (k <= 0 || k > 65535 || h <= 0 || nw <= 0 || n_steps < 0 || step0 < 0 || band <= 0 || radius < 0 ||
      (in == nullptr) == (rows_in == nullptr) || out == nullptr)
    return (int)cudaErrorInvalidValue;
  if ((rows_in || rows_out) && (width <= 0 || (width + 31) / 32 != nw)) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(band, radius, nw);  // dynamic, beside the static masks
  if (smem + sizeof(unsigned long long) * 2 * kMaxRows > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem + sizeof(unsigned long long) * 2 * kMaxRows > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(morph_steps, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((h + band - 1) / band), (unsigned)k);
  morph_steps<<<grid, dim3(kLanes, kRowLanes), smem, static_cast<cudaStream_t>(stream)>>>(
      in, rows_in, out, rows_out, valid, table, step0, n_steps, radius, band, h, nw, width);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
