// BGR byte -> float Lab in OpenCV's 8-bit scaling (L * 255 / 100, a + 128,
// b + 128): the float32 operations of plotweave_torch/ops/colorspace.py in the
// same order, with correctly rounded division.  Shared by K7
// (assign_nearest.cu) and K8's pw_lab_sample (kmeans.cu), so both give the
// same bits for the same pixel.
//
// Every source that includes this header MUST be compiled with --fmad=false
// (ops/kernels.py::NVCC_FLAGS): a multiply-add contracted into an FMA rounds
// once instead of twice and the bits move.  powf and cbrtf are the accurate
// library functions, not the __ intrinsics; cbrtf is jnp.cbrt's function (the
// plain version uses pow(t, 1/3)).

#pragma once

namespace pw_lab {

__device__ __forceinline__ float gamma_inv(float u) {
  return u <= 0.04045f ? u / 12.92f : powf((u + 0.055f) / 1.055f, 2.4f);
}

__device__ __forceinline__ float lab_f(float t) {
  // (6/29)^3, 3 (6/29)^2 and 4/29, rounded to float32
  return t > 0.008856451679035631f ? cbrtf(t) : t / 0.12841854934601665f + 0.13793103448275862f;
}

// Linear r, g, b (gamma_inv of byte / 255) -> Lab: sRGB -> XYZ (D65) in the
// einsum's row order, over the white point.
__device__ __forceinline__ void lab_from_linear(float r, float g, float b, float& lab0, float& lab1, float& lab2) {
  const float fx = lab_f((0.412453f * r + 0.357580f * g + 0.180423f * b) / 0.950456f);
  const float fy = lab_f((0.212671f * r + 0.715160f * g + 0.072169f * b) / 1.0f);
  const float fz = lab_f((0.019334f * r + 0.119193f * g + 0.950227f * b) / 1.088754f);
  lab0 = (116.0f * fy - 16.0f) * 255.0f / 100.0f;
  lab1 = 500.0f * (fx - fy) + 128.0f;
  lab2 = 200.0f * (fy - fz) + 128.0f;
}

}  // namespace pw_lab
