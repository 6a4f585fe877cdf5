// K7 pw_assign_nearest: BGR -> Lab -> the nearest of k centres, in one pass,
// for Hopper (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA fusion of plotweave/ops/frontend.py::assign_nearest with
// plotweave/ops/colorspace.py::bgr_to_lab_u8: the one-pass design that
// frontend.py:28-33 describes, where neither the Lab plane nor the distances
// reach device memory.
//
// Numbers.  Each pixel runs the plain version's float32 operations
// (plotweave_torch/ops/colorspace.py, ops/frontend.py::assign_nearest_plain)
// in the same order, with correctly rounded division.  This file is compiled
// with --fmad=false, so no multiply-add is contracted into an FMA and no
// distance moves; powf and cbrtf are the accurate library functions, not the
// __ intrinsics.  cbrtf is jnp.cbrt's function (the plain version uses
// pow(t, 1/3)), so labels may differ from the plain version's only where two
// centres are nearly equally far.  A strict < keeps the first minimum, as
// argmin does.
//
// Design and bound.  One thread per pixel reads its 3 bytes, computes Lab,
// takes the k distances against the centres (read from device memory
// through the read-only cache; any k) and writes an int32 label.  It is
// bound by memory: 3 bytes in and 4 out per pixel, about 20 float operations
// and 3 powf/cbrtf calls.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float gamma_inv(float u) {
  return u <= 0.04045f ? u / 12.92f : powf((u + 0.055f) / 1.055f, 2.4f);
}

__device__ __forceinline__ float lab_f(float t) {
  // (6/29)^3, 3 (6/29)^2 and 4/29, rounded to float32
  return t > 0.008856451679035631f ? cbrtf(t) : t / 0.12841854934601665f + 0.13793103448275862f;
}

__global__ void __launch_bounds__(kThreads) assign_nearest(const uint8_t* __restrict__ bgr,
                                                           const float* __restrict__ centers,
                                                           int32_t* __restrict__ labels, int k,
                                                           long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* px = bgr + 3 * i;
  float r = gamma_inv((float)px[2] / 255.0f);
  float g = gamma_inv((float)px[1] / 255.0f);
  float b = gamma_inv((float)px[0] / 255.0f);
  // sRGB -> XYZ (D65) in the einsum's row order, over the white point
  float fx = lab_f((0.412453f * r + 0.357580f * g + 0.180423f * b) / 0.950456f);
  float fy = lab_f((0.212671f * r + 0.715160f * g + 0.072169f * b) / 1.0f);
  float fz = lab_f((0.019334f * r + 0.119193f * g + 0.950227f * b) / 1.088754f);
  float lab0 = (116.0f * fy - 16.0f) * 255.0f / 100.0f;
  float lab1 = 500.0f * (fx - fy) + 128.0f;
  float lab2 = 200.0f * (fy - fz) + 128.0f;

  int best = 0;
  float best_d = 0.0f;
  for (int c = 0; c < k; ++c) {
    float d0 = lab0 - __ldg(centers + 3 * c);
    float d1 = lab1 - __ldg(centers + 3 * c + 1);
    float d2 = lab2 - __ldg(centers + 3 * c + 2);
    float d = d0 * d0 + d1 * d1 + d2 * d2;
    if (c == 0 || d < best_d) {
      best = c;
      best_d = d;
    }
  }
  labels[i] = best;
}

}  // namespace

extern "C" {

// labels[i] = the nearest of the k (L, a, b) centres (float32, device memory)
// to pixel i of the n BGR pixels.  Returns cudaGetLastError().
int pw_assign_nearest(const uint8_t* bgr, const float* centers, int32_t* labels, int k, long n,
                      void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  assign_nearest<<<grid, kThreads, 0, s>>>(bgr, centers, labels, k, n);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
