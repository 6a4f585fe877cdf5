// K14 pw_bezier_families: every curve family of one SVG document in one
// launch, for Hopper (sm_90a), bound to Python through a plain C interface
// (ctypes).  A family is the cubic (or quadratic) Bézier segments of one path
// sampled at one n: (S, K, 2) control points -> (S, n, 2) points in float32.
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
// the sum over the control points in their order from 0.  Compiled with
// --fmad=false, so each product is rounded as the plain version's.
//
// The family table.  The host knows every family's S, K and n, so it packs
// the document into one buffer (ops/bezier.py::pack_families), copied up in
// one transfer: the control points of every non-empty family back to back
// (float32), the table (one int4 a family: control-point offset in floats,
// output offset in points, n, K; cubics and quadratics side by side), and for
// each CTA of kThreads points the family that holds its first point, then the
// last family.  The output is every family's points back to back, so the
// document's points come back in one transfer too.  A thread finds its family
// by a binary search between its CTA's first family and the next CTA's (at
// most log2(kThreads + 1) steps over a few table entries, all CTA-uniform
// loads that L1 serves); the families of a CTA are those that its points
// touch.  A table of one (pw_bezier_sample) passes its entry by value and no
// start table: the same kernel, so a family gives the same bits either way.
//
// Design and bound.  Bytes bind it: 8 bytes written a point, K * 8 read a
// curve, and the table's 16 bytes a family.  A launch a family would be
// launch-bound at a document's shapes (an A3 traced poster has 3,000
// families of a few thousand points), so the fixed costs of an upload, a
// launch, a synchronisation and a copy back are paid once a document, not
// once a family.  Neighbouring
// threads take neighbouring points of a family, so the stores are one float2
// a thread, contiguous across the warp, and a curve's control points are read
// from L1 by all the threads that share it.  On an H100 the times are in
// PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // points a CTA (ops/kernels.py::BEZIER_THREADS)

// Point i of n of the K-point curve p, as the one-family kernel before the
// table computed it: every operation in the same order.
template <int K>
__device__ __forceinline__ float2 bezier_point(const float* __restrict__ p, int i, int n) {
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
  float x = 0.0f, y = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    x += b[k] * p[2 * k];
    y += b[k] * p[2 * k + 1];
  }
  return make_float2(x, y);
}

// Point q of the document: family f (table[f] = {control offset, output
// offset, n, K}) found between first[blockIdx.x] and first[blockIdx.x + 1];
// a null table stands for the single family `one` (and then first is null).
__global__ void __launch_bounds__(kThreads)
    bezier_families(const float* __restrict__ ctrl, const int4* __restrict__ table, const int* __restrict__ first,
                    int4 one, int n_points, float2* __restrict__ out) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= n_points) return;
  int4 e = one;
  if (table != nullptr) {
    int lo = __ldg(first + blockIdx.x), hi = __ldg(first + blockIdx.x + 1);
    while (lo < hi) {  // the last family whose output starts at or before q
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(&table[mid].y) <= q) lo = mid;
      else hi = mid - 1;
    }
    e = __ldg(table + lo);
  }
  const int r = q - e.y;
  const int curve = r / e.z;
  const int i = r - curve * e.z;
  const float* p = ctrl + e.x + (long)curve * (2 * e.w);
  out[q] = e.w == 4 ? bezier_point<4>(p, i, e.z) : bezier_point<3>(p, i, e.z);
}

cudaError_t launch(const float* ctrl, const int4* table, const int* first, int4 one, int n_points, float* out,
                   void* stream) {
  if (n_points <= 0) return cudaGetLastError();
  const unsigned grid = (unsigned)((n_points + kThreads - 1) / kThreads);
  bezier_families<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(ctrl, table, first, one, n_points,
                                                                            reinterpret_cast<float2*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// A document's families in one launch.  words (device memory, int32): the
// control points (float32 bits) from word 0, the table of n_fam int4 entries
// {control offset in floats, output offset in points, n >= 1, K = 3 or 4} at
// word table_off (a multiple of 4; output offsets increasing, every family
// non-empty), and ceil(n_points / 256) + 1 start entries at word first_off
// (the family of CTA b's first point, then n_fam - 1) -> out (n_points, 2)
// float32, n_points < 2^31.  Returns a CUDA error code (0 on success).
int pw_bezier_families(const int* words, int table_off, int first_off, int n_fam, int n_points, float* out,
                       void* stream) {
  if (n_points <= 0) return (int)cudaGetLastError();
  if (n_fam < 1 || table_off % 4 != 0) return (int)cudaErrorInvalidValue;
  return (int)launch(reinterpret_cast<const float*>(words), reinterpret_cast<const int4*>(words + table_off),
                     words + first_off, make_int4(0, 0, 1, 4), n_points, out, stream);
}

// A table of one: out (s, n, 2) float32 = the k-point Bézier curves ctrl
// (s, k, 2) float32 (k = 3 or 4) at t = i / (n - 1), both in device memory;
// s * n < 2^31.  Returns a CUDA error code (0 on success).
int pw_bezier_sample(const float* ctrl, float* out, int s, int k, int n, void* stream) {
  if ((long)s * n <= 0) return (int)cudaGetLastError();
  if (k != 3 && k != 4) return (int)cudaErrorInvalidValue;
  return (int)launch(ctrl, nullptr, nullptr, make_int4(0, 0, n, k), s * n, out, stream);
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
