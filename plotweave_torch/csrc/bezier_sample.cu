// K14 pw_bezier_sample: every cubic (or quadratic) Bézier segment of one
// path sampled at n parameters, (S, K, 2) control points -> (S, n, 2) points
// in float32, for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the device program of the JAX package's --sampling-backend jax
// (plotweave/frontends/svg.py::sample_cubics_batched :82 and
// sample_quads_batched :95): the Bernstein basis on a shared
// linspace(0, 1, n) grid, then einsum("nk,skc->snc").  With K = 4 (or 3) the
// contraction is four (three) products a coordinate: an elementwise
// evaluation, not a matrix product, so one thread takes one (curve, sample)
// point: t = i / (n - 1) correctly rounded (linspace's t in float32), u =
// 1 - t, the basis u^3, 3u^2 t, 3u t^2, t^3 (u^2, 2ut, t^2) in the plain
// version's order (plotweave_torch/ops/bezier.py::sample_bezier_plain), and
// the sum over the control points in their order.  Compiled with
// --fmad=false, so each product is rounded as the plain version's.
//
// Design and bound.  Bytes bind it: 8 bytes written a point, K * 8 read a
// curve (60,000 curves x 128 samples write 61 MB, 18 us at 3.35 TB/s).
// Neighbouring threads take neighbouring samples of one curve, so the stores
// are one float2 a thread, contiguous across the warp, and a curve's control
// points are read from L1 by all the threads that share it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
    bezier_sample(const float* __restrict__ ctrl, float2* __restrict__ out, long n_points, int n) {
  const long idx = (long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_points) return;
  const long curve = idx / n;
  const int i = (int)(idx - curve * n);
  const float t = n > 1 ? __fdiv_rn((float)i, (float)(n - 1)) : 0.0f;
  const float u = 1.0f - t;
  float b[K];
  if constexpr (K == 4) {
    b[0] = u * u * u;
    b[1] = 3.0f * (u * u) * t;
    b[2] = 3.0f * u * (t * t);
    b[3] = t * t * t;
  } else {
    b[0] = u * u;
    b[1] = 2.0f * u * t;
    b[2] = t * t;
  }
  const float* p = ctrl + curve * (2 * K);
  float x = 0.0f, y = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x += b[k] * p[2 * k];
    y += b[k] * p[2 * k + 1];
  }
  out[idx] = make_float2(x, y);
}

}  // namespace

extern "C" {

// out (s, n, 2) float32 = the k-point Bézier curves ctrl (s, k, 2) float32
// (k = 3 or 4) at t = i / (n - 1), both in device memory; s * n < 2^31.
// Returns a CUDA error code (0 on success).
int pw_bezier_sample(const float* ctrl, float* out, int s, int k, int n, void* stream) {
  const long n_points = (long)s * n;
  if (n_points <= 0) return (int)cudaGetLastError();
  if (k != 3 && k != 4) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((n_points + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* o = reinterpret_cast<float2*>(out);
  if (k == 4)
    bezier_sample<4><<<grid, kThreads, 0, st>>>(ctrl, o, n_points, n);
  else
    bezier_sample<3><<<grid, kThreads, 0, st>>>(ctrl, o, n_points, n);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
