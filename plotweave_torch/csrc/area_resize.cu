// K13 pw_area_resize_frac / pw_area_resize_int: the INTER_AREA downscale of
// a uint8 image, (H, W, C) -> (h, w, C), C = 1 to 4, for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA programs of plotweave/ops/resize.py: _area_resize_frac
// (with its tap table _resize_area_tab and the chunked passes) and
// _area_resize_int.  Both match the JAX functions bit for bit, and through
// them cv2.resize(..., INTER_AREA).
//
// Fractional ratios.  The tap tables (per destination column and row, the
// source indices and float32 alphas of cv2's computeResizeAreaTab, padded to
// the longest with alpha 0, which adds an exact 0) come from the host
// (plotweave_torch/ops/resize.py::_resize_area_tab).  One thread per output
// pixel walks the vertical taps in table order; for each, and each channel, it
// forms the horizontal sum, sum x * xal in table order with every product
// rounded before its add, then adds hb * yal in order, rounds half to even
// (rintf) and clips to 0..255.  That is the JAX package's order of float32
// operations (horizontal pass, then vertical pass), so nothing may be
// contracted into an FMA: the file is compiled with --fmad=false and the
// sums use __fmul_rn / __fadd_rn besides (resize.py:150-168: a contracted
// multiply-add flips half-even ties).  The JAX package cuts the passes into
// groups of 16 taps (_TAP_CHUNK) only to bound XLA's product stacks; the
// global add order is the same, so the kernel needs no chunking.
//
// Integer ratios.  One thread per output pixel sums its sy x sx block, each
// channel in an int: the 2 x 2 case is (sum + 2) >> 2, every other ratio
// rintf(sum / area) in float32: the sum converted to float32 (rounded to
// nearest even, as XLA's int32 -> float32), a correctly rounded division (the
// JAX package writes float64, but it never enables x64, so that is float32).
//
// Design and bound.  Bytes bind it: each input byte read once, each output
// byte written once (a 4032 x 3024 x 3 photo to 2000 x 1500 reads 36.6 MB
// and writes 9.0 MB, 14 us at 3.35 TB/s).  One thread takes one output
// pixel, all its channels in registers (the kernels are instantiated for C =
// 1 to 4), so a pixel's taps and index arithmetic serve every channel, and
// the indices are 32-bit (the wrapper keeps every tensor below 2^31
// elements).  Neighbouring threads take neighbouring output pixels of one
// row, so their loads fall on neighbouring source bytes of the same rows,
// and the rows that two output rows share are read again from L1 or L2, not
// from device memory.  The horizontal sums of a source row are recomputed
// for each output row that takes it (about twice at a ratio of 2): a simple
// kernel that is right; sharing them through shared memory is left for
// later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint8_t clip_u8(float v) { return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f); }

template <int C>
__global__ void __launch_bounds__(kThreads)
    area_frac(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, const int* __restrict__ xsi,
              const float* __restrict__ xal, int th, const int* __restrict__ ysi, const float* __restrict__ yal,
              int tv, int w, int nh, int nw) {
  const unsigned px = blockIdx.x * kThreads + threadIdx.x;
  if (px >= (unsigned)nh * (unsigned)nw) return;
  const unsigned oy = px / (unsigned)nw, ox = px - oy * (unsigned)nw;
  const int* xs = xsi + ox * th;
  const float* xa = xal + ox * th;
  const int* ys = ysi + oy * tv;
  const float* ya = yal + oy * tv;
  float acc[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;  // 0 + the first product is that product: every term is >= 0
  for (int v = 0; v < tv; ++v) {
    const uint8_t* row = src + (unsigned)ys[v] * (unsigned)w * C;
    float hb[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) hb[ch] = 0.0f;
    for (int t = 0; t < th; ++t) {
      const uint8_t* p = row + xs[t] * C;
      const float a = xa[t];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) hb[ch] = __fadd_rn(hb[ch], __fmul_rn((float)p[ch], a));
    }
    const float b = ya[v];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = __fadd_rn(acc[ch], __fmul_rn(hb[ch], b));
  }
  uint8_t* out = dst + px * C;
#pragma unroll
  for (int ch = 0; ch < C; ++ch) out[ch] = clip_u8(acc[ch]);
}

template <int C>
__global__ void __launch_bounds__(kThreads)
    area_int(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, int w, int sy, int sx, int nh, int nw) {
  const unsigned px = blockIdx.x * kThreads + threadIdx.x;
  if (px >= (unsigned)nh * (unsigned)nw) return;
  const unsigned oy = px / (unsigned)nw, ox = px - oy * (unsigned)nw;
  const uint8_t* base = src + ((oy * sy) * (unsigned)w + ox * sx) * C;
  int sum[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) sum[ch] = 0;
  for (int dy = 0; dy < sy; ++dy) {
    const uint8_t* row = base + dy * (unsigned)w * C;
    for (int dx = 0; dx < sx; ++dx) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) sum[ch] += row[dx * C + ch];
    }
  }
  uint8_t* out = dst + px * C;
  const bool half_up = sy == 2 && sx == 2;
  const float area = (float)(sy * sx);
#pragma unroll
  for (int ch = 0; ch < C; ++ch)
    out[ch] = half_up ? (uint8_t)((sum[ch] + 2) >> 2) : clip_u8(__fdiv_rn((float)sum[ch], area));
}

unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// dst (nh, nw, c) = cv2's resizeArea of src (h, w, c) uint8, through the tap
// tables xsi/xal (nw, th) and ysi/yal (nh, tv), int32 and float32 in device
// memory.  Fewer than 2^31 elements in and out (the caller checks).  Returns a
// CUDA error code (0 on success).
int pw_area_resize_frac(const uint8_t* src, uint8_t* dst, const int* xsi, const float* xal, int th, const int* ysi,
                        const float* yal, int tv, int w, int c, int nh, int nw, void* stream) {
  const long n = (long)nh * nw;
  if (n <= 0) return (int)cudaGetLastError();
  if (th < 1 || tv < 1 || c < 1 || c > 4) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks_for(n);
  switch (c) {
    case 1: area_frac<1><<<g, kThreads, 0, st>>>(src, dst, xsi, xal, th, ysi, yal, tv, w, nh, nw); break;
    case 2: area_frac<2><<<g, kThreads, 0, st>>>(src, dst, xsi, xal, th, ysi, yal, tv, w, nh, nw); break;
    case 3: area_frac<3><<<g, kThreads, 0, st>>>(src, dst, xsi, xal, th, ysi, yal, tv, w, nh, nw); break;
    default: area_frac<4><<<g, kThreads, 0, st>>>(src, dst, xsi, xal, th, ysi, yal, tv, w, nh, nw);
  }
  return (int)cudaGetLastError();
}

// dst (nh, nw, c) = the sy x sx box means of src (nh * sy, nw * sx, c) uint8,
// rounded as cv2's integer-ratio INTER_AREA.  Returns a CUDA error code.
int pw_area_resize_int(const uint8_t* src, uint8_t* dst, int w, int c, int sy, int sx, int nh, int nw, void* stream) {
  const long n = (long)nh * nw;
  if (n <= 0) return (int)cudaGetLastError();
  if (sy < 1 || sx < 1 || c < 1 || c > 4 || (long)sy * sx * 255 >= (1L << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned g = blocks_for(n);
  switch (c) {
    case 1: area_int<1><<<g, kThreads, 0, st>>>(src, dst, w, sy, sx, nh, nw); break;
    case 2: area_int<2><<<g, kThreads, 0, st>>>(src, dst, w, sy, sx, nh, nw); break;
    case 3: area_int<3><<<g, kThreads, 0, st>>>(src, dst, w, sy, sx, nh, nw); break;
    default: area_int<4><<<g, kThreads, 0, st>>>(src, dst, w, sy, sx, nh, nw);
  }
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
