// K7 pw_assign_nearest: BGR -> Lab -> the nearest of k centres, in one pass,
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA fusion of plotweave/ops/frontend.py::assign_nearest with
// plotweave/ops/colorspace.py::bgr_to_lab_u8: the one-pass design that
// frontend.py:28-33 describes, where neither the Lab plane nor the distances
// reach device memory.  It writes int32 labels (assign_nearest's signature)
// or, for the front-end, which needs no labels, the k one-hot bitboards
// directly (32 px a word, LSB first, bits at and beyond W zero): k/8 bytes a
// pixel instead of 4, and no `labels == c` planes.
//
// Numbers.  Each pixel runs the plain version's float32 operations
// (plotweave_torch/ops/colorspace.py, ops/frontend.py::assign_nearest_plain)
// in the same order, with correctly rounded division; the Lab arithmetic lives
// in lab.cuh, which K8's sampler shares bit for bit.  This file is compiled
// with --fmad=false, so no multiply-add is contracted into an FMA and no
// distance moves; powf and cbrtf are the accurate library functions, not the
// __ intrinsics.  cbrtf is jnp.cbrt's function (the plain version uses
// pow(t, 1/3)), so labels may differ from the plain version's only where two
// centres are nearly equally far.  A strict < keeps the first minimum, as
// argmin does.
//
// Counts.  pw_assign_boards also returns, where asked, the k pixel counts of
// one image (the stage's sel.sum): the popcount of each ballot word goes to an
// int in shared memory and from there, once per block, to device memory, by
// integer atomics, so the counts are exact in any order.
//
// Design and bound.  Instructions bound this kernel, not its bytes (3 in and
// 4, or k/8, out a pixel): done per pixel, the conversion costs three
// accurate powf and three cbrtf.  gamma_inv((float)v / 255.0f) has 256
// possible inputs, so each block fills a 256-entry table in shared memory
// with that very device function (the bits are the same by construction) and
// looks it up; cbrtf stays, its inputs are continuous.  Filling the table costs a
// powf a thread, so the grid is only the blocks the device holds at once
// (the occupancy query says how many) and a block strides over chunks of 256
// consecutive pixels, of the flat image (labels) or of one image row
// (boards), which also evens the blocks' work.  A chunk is 768 contiguous
// bytes, read as 16-byte vectors into shared memory from the 16-byte boundary
// below them (the partial vectors at the tensor's two ends by bytes), and the
// k centres are staged there once.  For the boards a warp's 32 pixels are one
// word of one row, so the chunks are cut from image rows, each warp ballots
// `best == c` once per layer and chunk (lane c keeps and stores layer c's
// word), and the chunk's (image, row, segment) advance by the grid's stride
// with carries instead of divisions.  On an H100 80GB HBM3 at 700 W the
// kernel takes 0.031 ms for the labels and 0.042 ms for the boards of 2000 x
// 1500 px, k = 4 (PERF.md): the three cbrtf and four divisions a pixel bind it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lab.cuh"

namespace {

using pw_lab::gamma_inv;
using pw_lab::lab_from_linear;

constexpr int kThreads = 256;     // pixels of one chunk
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block
constexpr int kVecs = (3 * kThreads + 15) / 16 + 1;  // 16-byte vectors over 768 bytes at any alignment

// A chunk is 256 consecutive pixels: chunk c of the flat image (labels), or
// segment c % segs of image row c / segs (boards; a row is image * h + row),
// whose warp v writes word 8 (c % segs) + v of that row in each layer.  The
// blocks stride over the chunks, so the block's gamma table serves them all.
template <bool kBoardsOut>
__global__ void __launch_bounds__(kThreads, 2048 / kThreads)  // a full SM of threads: 32 registers each
    assign_nearest(const uint8_t* __restrict__ bgr, long n, const float* __restrict__ centers,
                   int32_t* __restrict__ labels, uint32_t* __restrict__ boards, int* __restrict__ counts, int k, int h,
                   int w, int nw, long n_chunks, int segs) {
  extern __shared__ float centers_s[];  // (k, 3), then the block's k counts as ints
  int* counts_s = reinterpret_cast<int*>(centers_s + 3 * k);
  __shared__ float gamma_s[256];
  __shared__ uint4 px_v[kVecs];
  const int tid = threadIdx.x;
  gamma_s[tid] = gamma_inv((float)tid / 255.0f);
  for (int j = tid; j < 3 * k; j += kThreads) centers_s[j] = centers[j];
  if (kBoardsOut && counts)
    for (int j = tid; j < k; j += kThreads) counts_s[j] = 0;

  uint8_t* px_s = reinterpret_cast<uint8_t*>(px_v);
  // boards: the chunk's (image, row, segment), advanced by the grid's stride with carries
  const unsigned first_row = kBoardsOut ? blockIdx.x / (unsigned)segs : 0u;
  const unsigned step_row = kBoardsOut ? gridDim.x / (unsigned)segs : 0u;
  const int step_seg = kBoardsOut ? (int)(gridDim.x % (unsigned)segs) : 0;
  const int step_y = kBoardsOut ? (int)(step_row % (unsigned)h) : 0;
  const int step_img = kBoardsOut ? (int)(step_row / (unsigned)h) : 0;
  const int plane = h * nw;  // words of one layer
  int seg = kBoardsOut ? (int)(blockIdx.x % (unsigned)segs) : 0;
  int y = kBoardsOut ? (int)(first_row % (unsigned)h) : 0;
  int img = kBoardsOut ? (int)(first_row / (unsigned)h) : 0;
  for (long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    // the boards' pixel and word indices stay below 2^31 (the caller checks), so 32-bit arithmetic serves
    const long p0 = kBoardsOut ? (long)((img * h + y) * w + kThreads * seg) : (long)kThreads * chunk;
    const int npx = kBoardsOut ? min(kThreads, w - kThreads * seg) : (int)min((long)kThreads, n - p0);
    const uint8_t* first = bgr + 3 * p0;
    const int mis = (int)((uintptr_t)first & 15);
    __syncthreads();  // the table and the centres, or the previous chunk's reads
    if (tid < (mis + 3 * npx + 15) / 16) {
      const uint8_t* v = first - mis + 16 * tid;  // 16-byte aligned
      if (v >= bgr && v + 16 <= bgr + 3 * n) {
        px_v[tid] = *reinterpret_cast<const uint4*>(v);
      } else {
        for (int b = 0; b < 16; ++b)
          if (v + b >= bgr && v + b < bgr + 3 * n) px_s[16 * tid + b] = v[b];
      }
    }
    __syncthreads();

    int best = -1;
    if (tid < npx) {
      const uint8_t* px = px_s + mis + 3 * tid;
      const float r = gamma_s[px[2]], g = gamma_s[px[1]], b = gamma_s[px[0]];
      float lab0, lab1, lab2;
      lab_from_linear(r, g, b, lab0, lab1, lab2);
      float best_d = 0.0f;
      for (int c = 0; c < k; ++c) {
        const float d0 = lab0 - centers_s[3 * c];
        const float d1 = lab1 - centers_s[3 * c + 1];
        const float d2 = lab2 - centers_s[3 * c + 2];
        const float d = d0 * d0 + d1 * d1 + d2 * d2;
        if (c == 0 || d < best_d) {
          best = c;
          best_d = d;
        }
      }
      if (!kBoardsOut) labels[p0 + tid] = best;
    }
    if (kBoardsOut) {
      const int word = (kThreads / 32) * seg + (tid >> 5);
      if (word < nw) {  // the same for a whole warp; a lane at or beyond W holds -1
        // lane c keeps layer c's word, so one store a lane and 32 layers, not one address a layer
        const int lane = tid & 31;
        for (int c0 = 0; c0 < k; c0 += 32) {
          uint32_t mine = 0u;
          const int layers = min(32, k - c0);
          for (int c = 0; c < layers; ++c) {
            const uint32_t m = __ballot_sync(0xffffffffu, best == c0 + c);
            if (lane == c) mine = m;
          }
          if (lane < layers) {
            boards[(img * k * h + y) * nw + word + (c0 + lane) * plane] = mine;
            if (counts && mine) atomicAdd(&counts_s[c0 + lane], __popc(mine));
          }
        }
      }
      seg += step_seg;
      const int carry = seg >= segs;
      seg -= carry * segs;
      y += step_y + carry;
      img += step_img;
      if (y >= h) {
        y -= h;
        ++img;
      }
    }
  }
  if (kBoardsOut && counts) {
    __syncthreads();
    for (int j = tid; j < k; j += kThreads)
      if (counts_s[j]) atomicAdd(&counts[j], counts_s[j]);
  }
}

// One launch over n_chunks chunks, with as many blocks as the device holds at
// once (a grid beyond that would run its last blocks alone, as a second wave).
template <bool kBoardsOut>
int launch(const uint8_t* bgr, const float* centers, int32_t* labels, uint32_t* boards, int* counts, int k, long n,
           int h, int w, long n_chunks, int segs, cudaStream_t s) {
  const size_t smem = sizeof(float) * 4 * (size_t)k;  // the centres and the block's counts
  if (smem + sizeof(float) * 256 + sizeof(uint4) * kVecs > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 40 * 1024) {
    err = cudaFuncSetAttribute(assign_nearest<kBoardsOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, assign_nearest<kBoardsOut>, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(n_chunks < (long)per_sm * sms ? n_chunks : (long)per_sm * sms);
  assign_nearest<kBoardsOut><<<grid, kThreads, smem, s>>>(bgr, n, centers, labels, boards, counts, k, h, w,
                                                          (w + 31) / 32, n_chunks, segs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// labels[i] = the nearest of the k (L, a, b) centres (float32, device memory)
// to pixel i of the n BGR pixels.  Returns a CUDA error code (0 on success).
int pw_assign_nearest(const uint8_t* bgr, const float* centers, int32_t* labels, int k, long n, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  return launch<false>(bgr, centers, labels, nullptr, nullptr, k, n, 1, 1, (n + kThreads - 1) / kThreads, 1,
                       static_cast<cudaStream_t>(stream));
}

// boards (n_img, k, h, ceil(w/32)): bit x of row y of layer c of image i is
// set where centre c is the nearest to pixel (y, x) of image i of the (n_img,
// h, w, 3) BGR bytes; fewer than 2^31 pixels and 2^31 words.  `counts`, where
// not null (one image only), gets the k pixel counts, int32 (zeroed here).
// Returns a CUDA error code (0 on success).
int pw_assign_boards(const uint8_t* bgr, const float* centers, uint32_t* boards, int* counts, int k, long n_img,
                     int h, int w, void* stream) {
  if (n_img <= 0 || h <= 0 || w <= 0 || k <= 0) return (int)cudaGetLastError();
  const int segs = (w + kThreads - 1) / kThreads;
  const long limit = 1L << 31;
  if (n_img * h * w >= limit || n_img * k * h * ((w + 31) / 32) >= limit) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts) {
    if (n_img != 1) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * k, s);
    if (err != cudaSuccess) return (int)err;
  }
  return launch<true>(bgr, centers, nullptr, boards, counts, k, n_img * h * w, h, w, n_img * h * segs, segs, s);
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
