// The two bit-packed fixpoints of the stage 02->04 raster chain, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// K6  pw_zs_packed_run: the Zhang-Suen thinning fixpoint.  Replaces the
//     Pallas kernel plotweave/ops/pallas_kernels.py::zhang_suen_packed_pallas
//     (body _zs_packed_kernel), the same computation as the XLA loop
//     plotweave/ops/thinning.py::zhang_suen_packed.
// K5  pw_hysteresis_run: Canny's hysteresis, edges = cand & dilate8(edges)
//     until nothing changes.  Replaces the XLA while_loop in
//     plotweave/ops/canny.py::canny_packed (grow / _dilate8).
//
// Boards: (k, H, NW) 32-bit words, 32 pixels per word, LSB-first; bit j of a
// word is column 32*w + j.  Padding bits beyond W stay zero: thinning only
// clears bits and hysteresis stays inside cand, whose padding is zero.
//
// Design.  One thread computes one word of one pass.  It reads the words
// w-1..w+1 of rows r-1..r+1 of the input board (zero outside the layer) and
// writes one word of another buffer, so a pass never reads what it writes.
// The TPU kernel ran the whole loop inside one kernel per layer, with the
// plane resident in VMEM; here each pass is one launch over every layer, and
// the host launches a chunk of iterations and then reads one flag per
// iteration.  Iterations past a fixpoint are no-ops, so a chunk that runs
// past convergence changes nothing.  The flag is joint over all layers, as
// in the JAX loop.
//
// Bound: memory and launches, not arithmetic.  A pass is ~100 integer
// operations per word over 9 reads; at 4 x 1500 x 2000 px the board is
// 4 * 1500 * 63 words = 1.5 MB, which stays in the 50 MB L2, so a pass costs
// about one launch.  Keeping a layer in shared memory across iterations, a
// persistent grid-wide fixpoint or a CUDA graph of the chunk would remove
// the launches; they are left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// The three words of row r+dy around word w, zero outside the layer.
struct Row3 {
  uint32_t left, mid, right;
};

__device__ __forceinline__ Row3 load_row(const uint32_t* __restrict__ layer, int r, int w,
                                         int h, int nw) {
  Row3 q{0u, 0u, 0u};
  if (r < 0 || r >= h) return q;
  const uint32_t* row = layer + (long)r * nw;
  q.mid = row[w];
  if (w > 0) q.left = row[w - 1];
  if (w + 1 < nw) q.right = row[w + 1];
  return q;
}

// Bit j of the result = bit j+dx of the row; east (dx=+1) is a right shift
// with the carry from the next word.
__device__ __forceinline__ uint32_t shifted(const Row3& q, int dx) {
  if (dx > 0) return (q.mid >> 1) | (q.right << 31);
  if (dx < 0) return (q.mid << 1) | (q.left >> 31);
  return q.mid;
}

__device__ __forceinline__ void full_add(uint32_t a, uint32_t b, uint32_t c, uint32_t& s,
                                         uint32_t& carry) {
  uint32_t ab = a ^ b;
  s = ab ^ c;
  carry = (a & b) | (c & ab);
}

// One Zhang-Suen subpass on one word.  FIRST selects the direction test;
// ROTATED negates the ring offsets (stage 04's 180-degree ring).  The second
// subpass writes the iteration's result over the iteration's input (`out`
// holds x, `in` holds y) and raises *flag when the word changed.
template <bool FIRST, bool ROTATED>
__global__ void zs_subpass(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                           int* __restrict__ flag, long total, int h, int nw) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int w = (int)(i % nw);
  long row_index = i / nw;
  int r = (int)(row_index % h);
  const uint32_t* layer = in + (row_index - r) * nw;

  Row3 rows[3];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) rows[dy + 1] = load_row(layer, r + dy, w, h, nw);

  // P2..P9: N, NE, E, SE, S, SW, W, NW as (dy, dx); negated when ROTATED
  const int ring_dy[8] = {-1, -1, 0, 1, 1, 1, 0, -1};
  const int ring_dx[8] = {0, 1, 1, 1, 0, -1, -1, -1};
  const int s = ROTATED ? -1 : 1;
  uint32_t n[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) n[k] = shifted(rows[s * ring_dy[k] + 1], s * ring_dx[k]);

  // B = neighbour count, bit-sliced through carry-save adders; 2 <= B <= 6
  uint32_t s1, c1, s2, c2, b0, c4, s5, c5;
  full_add(n[0], n[1], n[2], s1, c1);
  full_add(n[3], n[4], n[5], s2, c2);
  uint32_t s3 = n[6] ^ n[7], c3 = n[6] & n[7];
  full_add(s1, s2, s3, b0, c4);
  full_add(c1, c2, c3, s5, c5);
  uint32_t b1 = s5 ^ c4, c6 = s5 & c4;
  uint32_t b2 = c5 ^ c6, b3 = c5 & c6;
  uint32_t b_ok = (b1 | b2 | b3) & ~(b3 | (b2 & b1 & b0));

  // A == 1: exactly one 0->1 transition around the ring
  uint32_t any = ~n[0] & n[1], two = 0u;
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    uint32_t t = ~n[k] & n[(k + 1) % 8];
    two |= any & t;
    any |= t;
  }
  uint32_t a1 = any & ~two;

  uint32_t p2 = n[0], p4 = n[2], p6 = n[4], p8 = n[6];
  uint32_t dir_ok = FIRST ? (~(p2 & p4 & p6) & ~(p4 & p6 & p8))
                          : (~(p2 & p4 & p8) & ~(p2 & p6 & p8));

  uint32_t x = rows[1].mid;
  uint32_t res = x & ~(a1 & b_ok & dir_ok);
  if (FIRST) {
    out[i] = res;
  } else {
    uint32_t before = out[i];  // this word at the start of the iteration
    out[i] = res;
    if (res != before) *flag = 1;
  }
}

// One hysteresis sweep on one word: out = cand & dilate8(in); raises *flag
// when the word changed.
__global__ void hysteresis_sweep(const uint32_t* __restrict__ cand,
                                 const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                 int* __restrict__ flag, long total, int h, int nw) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int w = (int)(i % nw);
  long row_index = i / nw;
  int r = (int)(row_index % h);
  const uint32_t* layer = in + (row_index - r) * nw;

  uint32_t d = 0u;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    Row3 q = load_row(layer, r + dy, w, h, nw);
    d |= q.mid | shifted(q, 1) | shifted(q, -1);
  }
  uint32_t res = cand[i] & d;
  out[i] = res;
  if (res != in[i]) *flag = 1;
}

template <bool ROTATED>
cudaError_t zs_iterations(uint32_t* a, uint32_t* b, int* flags, long total, int h, int nw,
                          int n_iter, cudaStream_t stream) {
  unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  for (int it = 0; it < n_iter; ++it) {
    zs_subpass<true, ROTATED><<<grid, kThreads, 0, stream>>>(a, b, nullptr, total, h, nw);
    zs_subpass<false, ROTATED><<<grid, kThreads, 0, stream>>>(b, a, flags + it, total, h, nw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// n_iter Zhang-Suen iterations on the board in `a` (updated in place); `b` is
// scratch of the same size; flags[it] (zeroed by the caller) is set when
// iteration it changed any word.  Returns cudaGetLastError().
int pw_zs_packed_run(uint32_t* a, uint32_t* b, int* flags, int k, int h, int nw, int n_iter,
                     int rotated, void* stream) {
  long total = (long)k * h * nw;
  if (total == 0 || n_iter <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = rotated ? zs_iterations<true>(a, b, flags, total, h, nw, n_iter, s)
                            : zs_iterations<false>(a, b, flags, total, h, nw, n_iter, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// n_sweeps (even) hysteresis sweeps, e0 -> e1 -> e0 ..., so the result is in
// e0; flags[j] (zeroed by the caller) is set when sweep j changed any word.
// Returns cudaGetLastError().
int pw_hysteresis_run(const uint32_t* cand, uint32_t* e0, uint32_t* e1, int* flags, int k,
                      int h, int nw, int n_sweeps, void* stream) {
  long total = (long)k * h * nw;
  if (total == 0 || n_sweeps <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  for (int j = 0; j < n_sweeps; ++j) {
    const uint32_t* src = (j % 2 == 0) ? e0 : e1;
    uint32_t* dst = (j % 2 == 0) ? e1 : e0;
    hysteresis_sweep<<<grid, kThreads, 0, s>>>(cand, src, dst, flags + j, total, h, nw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
