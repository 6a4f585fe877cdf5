// K12 pw_zs_dense_run: dense tile-halo Zhang-Suen thinning, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas kernel plotweave/ops/pallas_kernels.py::zhang_suen_pallas
// (body _zs_iter_kernel): one launch runs one full iteration, both subpasses,
// and raises a per-iteration flag when any pixel of any layer changed.  The
// result equals plotweave/ops/thinning.py::zhang_suen_dense (zero border).
//
// Planes: (k, H, W) uint8 0/1, row-major.
//
// Design.  One block per (layer, 32x32 output tile) loads a 36x36 tile with a
// 2-px halo into shared memory, zero outside the image.  Subpass 1 runs over
// the inner 34x34 into a second shared tile, then subpass 2 over the inner
// 32x32, written to the other global buffer.  A 2-px halo is exactly enough
// for two radius-1 subpasses: it plays the part of the Pallas kernel's
// neighbour-block rows (pallas_kernels.py:79-81).  Pixels outside the image
// are 0 and stay 0, since a subpass only clears set pixels, so the zero
// border is exact.  The TPU kernel took 64-row, full-width blocks in VMEM; a
// Hopper block holds 2.6 KB here, so many blocks are in flight on each SM.
// The host launches a chunk of iterations, ping-ponging between two buffers,
// then reads one flag per iteration; iterations past the fixpoint are no-ops,
// so the bytes equal the JAX while_loop's.  The flag is joint over layers.
//
// Bound: memory and launches.  An iteration reads and writes each pixel once
// (plus the halo, 27 % more reads at 32x32); at 4 x 1500 x 2000 the two
// planes are 24 MB and stay in the 50 MB L2.  Keeping several iterations in
// one launch (a deeper halo) would cut the launches; left for later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 2;
constexpr int kIn = kTile + 2 * kHalo;  // 36: the loaded tile
constexpr int kMid = kTile + 2;         // 34: subpass 1's region
constexpr int kThreads = 256;

// One subpass at t[i][j] (0/1).  P2..P9 are N, NE, E, SE, S, SW, W, NW as
// (dy, dx), negated when ROTATED (stage 04's 180-degree ring).
template <bool FIRST, bool ROTATED>
__device__ __forceinline__ uint8_t subpass_px(uint8_t (*t)[kIn], int i, int j) {
  if (!t[i][j]) return 0;
  const int s = ROTATED ? -1 : 1;
  const int p[8] = {t[i - s][j], t[i - s][j + s], t[i][j + s], t[i + s][j + s],
                    t[i + s][j], t[i + s][j - s], t[i][j - s], t[i - s][j - s]};
  int b = 0, a = 0;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    b += p[n];
    a += (p[n] == 0) & (p[(n + 1) % 8] == 1);
  }
  bool dir_ok = FIRST ? !(p[0] & p[2] & p[4]) && !(p[2] & p[4] & p[6])
                      : !(p[0] & p[2] & p[6]) && !(p[0] & p[4] & p[6]);
  return (a == 1 && b >= 2 && b <= 6 && dir_ok) ? 0 : 1;
}

template <bool ROTATED>
__global__ void __launch_bounds__(kThreads) zs_dense_iter(const uint8_t* __restrict__ in,
                                                          uint8_t* __restrict__ out,
                                                          int* __restrict__ flag, int h, int w) {
  __shared__ uint8_t s0[kIn][kIn];
  __shared__ uint8_t s1[kIn][kIn];
  const long layer = (long)blockIdx.z * h * w;
  const int r0 = blockIdx.y * kTile - kHalo;
  const int c0 = blockIdx.x * kTile - kHalo;

  for (int idx = threadIdx.x; idx < kIn * kIn; idx += kThreads) {
    int i = idx / kIn, j = idx % kIn;
    int r = r0 + i, c = c0 + j;
    s0[i][j] = (r >= 0 && r < h && c >= 0 && c < w) ? in[layer + (long)r * w + c] : 0;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kMid * kMid; idx += kThreads) {
    int i = 1 + idx / kMid, j = 1 + idx % kMid;
    s1[i][j] = subpass_px<true, ROTATED>(s0, i, j);
  }
  __syncthreads();
  int changed = 0;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += kThreads) {
    int i = kHalo + idx / kTile, j = kHalo + idx % kTile;
    int r = r0 + i, c = c0 + j;
    if (r < h && c < w) {
      uint8_t v = subpass_px<false, ROTATED>(s1, i, j);
      out[layer + (long)r * w + c] = v;
      changed |= v != s0[i][j];
    }
  }
  if (__syncthreads_or(changed) && threadIdx.x == 0) *flag = 1;
}

}  // namespace

extern "C" {

// n_iter Zhang-Suen iterations, a -> b -> a ...: the result is in `a` when
// n_iter is even and in `b` when it is odd.  flags[it] (zeroed by the caller)
// is set when iteration it changed any pixel.  Returns cudaGetLastError().
int pw_zs_dense_run(uint8_t* a, uint8_t* b, int* flags, int k, int h, int w, int n_iter,
                    int rotated, void* stream) {
  if ((long)k * h * w == 0 || n_iter <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((w + kTile - 1) / kTile), (unsigned)((h + kTile - 1) / kTile), (unsigned)k);
  for (int it = 0; it < n_iter; ++it) {
    const uint8_t* src = (it % 2 == 0) ? a : b;
    uint8_t* dst = (it % 2 == 0) ? b : a;
    if (rotated)
      zs_dense_iter<true><<<grid, kThreads, 0, s>>>(src, dst, flags + it, h, w);
    else
      zs_dense_iter<false><<<grid, kThreads, 0, s>>>(src, dst, flags + it, h, w);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
