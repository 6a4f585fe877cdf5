// K12 pw_zs_tiles_run: dense Zhang-Suen thinning, bit-sliced in shared
// memory, up to kT iterations per launch, for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernel plotweave/ops/pallas_kernels.py::zhang_suen_pallas
// (:99, body _zs_iter_kernel :75).  The result equals
// plotweave/ops/thinning.py::zhang_suen_dense: the input (k, H, W) planes,
// 0/nonzero, binarised as > 0; int32 0/1 out, zero border, stopping after the
// first iteration that changes no layer, or after max_iter iterations.
//
// Design.  One block per (tile of kTR rows x kTW words of output, layer).
// It loads the tile and a halo of kHalo = 2 kT rows and one word on each side
// into shared memory, 32 pixels per word, LSB-first as pack_bitboards packs
// them.  The first launch of a call packs on load: a warp reads 32
// consecutive bytes of a row for each word and __ballot_sync(v != 0) gives
// the word; pixels outside the image are 0.  Later launches load the packed
// state that the previous launch stored.  The block then runs up to kT
// iterations, both subpasses, with K6's bit-sliced word logic (zs_word.cuh):
// a thread owns one word column of a strip of rows and slides a 3 x 3 word
// window down it, from one shared buffer into the other.  Each subpass is a
// radius-1 stencil, so the rows a subpass gets right shrink by one at each
// end of the loaded rows, and by one bit at each end of the loaded words:
// after 2 kT subpasses the kTR x kTW words of the tile's own region are
// still right (kT <= 16 keeps the bits inside the halo word).  Zhang-Suen
// only clears set pixels, so the pixels outside the image stay 0, which is
// the plain version's zero border.
//
// Convergence.  flags[it] is raised when any pixel of a block's own region
// changed at iteration it: the OR over blocks of the plain version's "any
// layer changed".  A block whose whole computed region did not change at
// iteration it stops there: the next iterations would compute the same
// board from the same words, so its own region is final and its later flags
// are 0.  The wrapper (ops/kernels.py::zhang_suen_dense_cuda) launches with
// n = min(kT, max_iter - done) iterations, reads flags[done + n - 1] once per
// launch when another launch may follow, and stops after the first launch
// whose last iteration changed nothing: iterations past the fixpoint are
// no-ops, so the bytes equal the JAX while_loop's.
//
// Output.  Every launch writes its tiles' int32 0/1 pixels, one lane per
// pixel, 128 bytes per warp store, and, unless it is the call's last launch
// by max_iter, the packed state for the next launch ((k, H, ceil(W/32))
// int32).  The front-end's edges converge inside one launch, so a call is
// one launch there.
//
// Tile: kTR x kTW = 64 rows x 16 words (512 px) with kT = 8: 96 rows of 18
// words are loaded for 64 x 16, and the subpasses compute on average 1.4x the
// own region's words.  At 4 x 1500 x 2000 that is 4 x 24 x 4 = 384 blocks of
// 15 KB of shared memory, about 3 per SM.  A narrower tile (64 x 8) loads
// 1.9x its own words against 1.7x here; a larger one (128 x 32) makes 96
// blocks for 132 SMs.
//
// Bound: bytes.  The function reads the uint8 planes once and writes the
// int32 pixels once, 60 MB at 4 x 1500 x 2000, 18 us at 3.35 TB/s; the
// iterations these edges need cost a few microseconds of operations at 49
// per word and subpass (chip_smoke.py counts them).  On an H100 80GB HBM3
// at 700 W this kernel takes 44 us there, and a call about 0.09-0.15 ms
// with the wrapper's host work and its one flag read (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "zs_word.cuh"

namespace {

constexpr int kT = 8;                       // iterations per launch (ops/kernels.py::ZS_CHUNK)
constexpr int kTR = 64;                     // output rows per tile
constexpr int kTW = 16;                     // output words per tile
constexpr int kHalo = 2 * kT;               // halo rows: one per subpass
constexpr int kRows = kTR + 2 * kHalo;      // 96 loaded rows
constexpr int kCols = kTW + 2;              // 18 loaded words: one halo word on each side
constexpr int kStride = kCols + 2;          // and a zero pad word on each side
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrips = kThreads / kCols;   // 14 strips of word columns
constexpr int kLen = (kRows + kStrips - 1) / kStrips;
static_assert(kT <= 16, "the halo word holds the bits of 2 kT subpasses");
static_assert(kStrips * kLen >= kRows, "the strips cover the loaded rows");

typedef uint32_t Tile[kRows][kStride];

__device__ __forceinline__ Row3 row3(const uint32_t* row, int c) { return Row3{row[c - 1], row[c], row[c + 1]}; }

// One subpass down rows [r0, r1) of padded word column c, src -> dst.  The
// second subpass writes the iteration's result over its input, so it reports
// whether a word changed (any) and whether one of the tile's own words did.
template <bool FIRST, bool ROTATED>
__device__ __forceinline__ void zs_strip(const Tile& src, Tile& dst, int c, int r0, int r1, bool& any,
                                         bool& own) {
  if (r0 >= r1) return;
  Row3 rows[3];
  rows[0] = row3(src[r0 - 1], c);
  rows[1] = row3(src[r0], c);
  const bool own_col = c >= 2 && c <= kTW + 1;
  for (int r = r0; r < r1; ++r) {
    rows[2] = row3(src[r + 1], c);
    const uint32_t res = zs_word<FIRST, ROTATED>(rows);
    if (!FIRST && res != dst[r][c]) {
      any = true;
      own |= own_col && r >= kHalo && r < kHalo + kTR;
    }
    dst[r][c] = res;
    rows[0] = rows[1];
    rows[1] = rows[2];
  }
}

template <bool PACKED_IN, bool ROTATED>
__global__ void __launch_bounds__(kThreads)
    zs_tiles(const void* __restrict__ in, uint32_t* __restrict__ state, int32_t* __restrict__ out,
             int* __restrict__ flags, int h, int w, int nw, int n_iter) {
  __shared__ Tile xs, ys;
  const int r0 = blockIdx.y * kTR - kHalo;  // the layer row of tile row 0
  const int w0 = blockIdx.x * kTW - 1;      // the board word of loaded word 0 (padded column 1)
  const long layer = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int idx = threadIdx.x; idx < kRows * kStride; idx += kThreads) (&ys[0][0])[idx] = 0u;
  if (PACKED_IN) {
    const uint32_t* src = static_cast<const uint32_t*>(in) + layer * h * nw;
    for (int idx = threadIdx.x; idx < kRows * kStride; idx += kThreads) {
      const int i = idx / kStride, c = idx - i * kStride, g = r0 + i, ww = w0 + c - 1;
      (&xs[0][0])[idx] =
          (c >= 1 && c <= kCols && g >= 0 && g < h && ww >= 0 && ww < nw) ? src[(long)g * nw + ww] : 0u;
    }
  } else {
    const uint8_t* src = static_cast<const uint8_t*>(in) + layer * h * w;
    // a warp per row: 18 independent byte loads per lane, then one ballot per word
    for (int i = warp; i < kRows; i += kWarps) {
      const int g = r0 + i;
      uint8_t v[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = (w0 + j) * 32 + lane;
        v[j] = (g >= 0 && g < h && col >= 0 && col < w) ? src[(long)g * w + col] : 0;
      }
      uint32_t mine = 0u;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const uint32_t word = __ballot_sync(0xffffffffu, v[j] != 0);
        if (lane == j) mine = word;
      }
      if (lane < kCols) xs[i][lane + 1] = mine;
      if (lane == 0) xs[i][0] = 0u;
      if (lane == 1) xs[i][kStride - 1] = 0u;
    }
  }

  const int c = threadIdx.x % kCols + 1, strip = threadIdx.x / kCols;
  const int s0 = strip * kLen, s1 = strip < kStrips ? s0 + kLen : s0;  // threads past the strips idle
  for (int it = 0; it < n_iter; ++it) {
    bool any = false, own = false;
    __syncthreads();  // the load, or the previous iteration, is done
    zs_strip<true, ROTATED>(xs, ys, c, max(s0, 2 * it + 1), min(s1, kRows - 2 * it - 1), any, own);
    __syncthreads();
    zs_strip<false, ROTATED>(ys, xs, c, max(s0, 2 * it + 2), min(s1, kRows - 2 * it - 2), any, own);
    if (__any_sync(0xffffffffu, own) && lane == 0) flags[it] = 1;
    if (!__syncthreads_or(any)) break;
  }
  __syncthreads();

  // the tile's own region: rows [kHalo, kHalo + kTR), padded columns [2, kTW + 2)
  const int g_top = blockIdx.y * kTR, w_left = blockIdx.x * kTW;
  if (state != nullptr) {
    uint32_t* dst = state + layer * h * nw;
    for (int idx = threadIdx.x; idx < kTR * kTW; idx += kThreads) {
      const int i = idx / kTW, j = idx - i * kTW, g = g_top + i, ww = w_left + j;
      if (g < h && ww < nw) dst[(long)g * nw + ww] = xs[kHalo + i][j + 2];
    }
  }
  int32_t* dst = out + layer * h * w;
  for (int i = warp; i < kTR && g_top + i < h; i += kWarps) {
    const long row = (long)(g_top + i) * w;
#pragma unroll 4
    for (int j = 0; j < kTW; ++j) {
      const int col = (w_left + j) * 32 + lane;
      if (col < w) dst[row + col] = (int32_t)((xs[kHalo + i][j + 2] >> lane) & 1u);
    }
  }
}

template <bool PACKED_IN>
cudaError_t launch(const void* in, uint32_t* state, int32_t* out, int* flags, int k, int h, int w, int nw,
                   int n_iter, bool rotated, cudaStream_t s) {
  dim3 grid((unsigned)((nw + kTW - 1) / kTW), (unsigned)((h + kTR - 1) / kTR), (unsigned)k);
  if (rotated)
    zs_tiles<PACKED_IN, true><<<grid, kThreads, 0, s>>>(in, state, out, flags, h, w, nw, n_iter);
  else
    zs_tiles<PACKED_IN, false><<<grid, kThreads, 0, s>>>(in, state, out, flags, h, w, nw, n_iter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// n_iter (0 to 8) Zhang-Suen iterations on (k, h, w) planes in one launch:
// `in` is uint8 0/nonzero pixels (packed_in = 0) or the (k, h, ceil(w/32))
// int32 packed state of the previous launch (packed_in = 1).  Writes the
// int32 0/1 pixels into `out` and, unless `state` is null, the packed result
// into `state` (not `in`).  flags[it] (zeroed here) is set when iteration it
// changed a pixel.  Returns a CUDA error code (0 on success).
int pw_zs_tiles_run(const void* in, int packed_in, uint32_t* state, int32_t* out, int* flags, int k, int h,
                    int w, int n_iter, int rotated, void* stream) {
  if (k <= 0 || k > 65535 || h <= 0 || w <= 0 || n_iter < 0 || n_iter > kT || (h + kTR - 1) / kTR > 65535)
    return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_iter > 0) {
    cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * n_iter, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(packed_in ? launch<true>(in, state, out, flags, k, h, w, nw, n_iter, rotated != 0, s)
                         : launch<false>(in, state, out, flags, k, h, w, nw, n_iter, rotated != 0, s));
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
