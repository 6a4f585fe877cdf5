// K11 pw_morph_dense_run: gray (uint8) morphology, a whole list of erosions
// and dilations by arbitrary structuring elements in one launch, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA fusion of plotweave/ops/morphology.py::_morph (through
// _window_reduce): each step is the minimum (erosion) or maximum (dilation)
// over the set cells of its element; a read outside the image gives 255 to an
// erosion and 0 to a dilation, the borders that neither constrain the one nor
// feed the other.  The element's anchor is ksize / 2 for an even ksize too, as
// _window_reduce pads.  Gray input is why this kernel exists beside K2, which
// works on bits.
//
// Design and bound.  A block owns a tile of th x tw output pixels and holds it
// with a halo of the steps' summed radius in shared memory, twice: each step
// reads one buffer and writes the other over a window that shrinks by the
// step's radius, so the whole list costs one read and one write of the image.
// The element's taps are data (dy, dx pairs staged in shared memory per step),
// so any shape and size runs the same code.  Only the tiles on the image's
// rim test coordinates: there a cell outside the image is never written, and
// a tap that falls outside reads the step's border value.  The wrapper
// (ops/kernels.py::dense_morph_schedule) splits a list whose halo would cost
// more recomputation than a launch, or does not fit 227 KB, into segments
// before any launch.  Operations bind it (one shared-memory load and one
// min/max per tap and pixel against two bytes of traffic); times on an H100
// are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One step over the window of margin `margin` in a region of ah x aw cells
// whose cell (0, 0) is pixel (y0, x0): dst = min or max over the taps of src.
template <bool kRim, bool kMax>
__device__ __forceinline__ void step(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, const int* taps,
                                     int n_taps, int margin, int ah, int aw, int y0, int x0, int h, int w) {
  const int rh = ah - 2 * margin, rw = aw - 2 * margin;
  const int pad = kMax ? 0 : 255;
  for (int i = threadIdx.x; i < rh * rw; i += kThreads) {
    const int ry = margin + i / rw, rx = margin + i % rw;
    const int gy = y0 + ry, gx = x0 + rx;
    if (kRim && (gy < 0 || gy >= h || gx < 0 || gx >= w)) continue;
    int acc = pad;
    for (int t = 0; t < n_taps; ++t) {
      const int dy = taps[t] >> 16, dx = (int)(short)(taps[t] & 0xffff);
      int v;
      if (kRim && (gy + dy < 0 || gy + dy >= h || gx + dx < 0 || gx + dx >= w))
        v = pad;
      else
        v = src[(ry + dy) * aw + rx + dx];
      acc = kMax ? max(acc, v) : min(acc, v);
    }
    dst[ry * aw + rx] = (uint8_t)acc;
  }
}

// table: per step (is_max, radius, taps, index of its first tap), then the
// taps as (dy << 16) | (dx & 0xffff).  Steps first .. first + n_steps - 1 run
// here; halo is the sum of their radii.  Grid: (tiles across, tiles down,
// images).
__global__ void __launch_bounds__(kThreads)
    morph_dense(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, const int* __restrict__ table, int first,
                int n_steps, int halo, int th, int tw, int h, int w) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ah = th + 2 * halo, aw = tw + 2 * halo;
  const int cells = (ah * aw + 3) & ~3;
  uint8_t* a = smem;
  uint8_t* b = smem + cells;
  int* taps = reinterpret_cast<int*>(smem + 2 * cells);
  const int y0 = blockIdx.y * th - halo, x0 = blockIdx.x * tw - halo;
  const long plane = (long)blockIdx.z * h * w;
  const bool rim = y0 < 0 || x0 < 0 || y0 + ah > h || x0 + aw > w;
  for (int i = threadIdx.x; i < ah * aw; i += kThreads) {
    const int gy = y0 + i / aw, gx = x0 + i % aw;
    a[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w) ? in[plane + (long)gy * w + gx] : 0;
  }
  int margin = 0;
  for (int s = 0; s < n_steps; ++s) {
    const int* head = table + 4 * (first + s);
    const int is_max = head[0], n_taps = head[2];
    __syncthreads();  // the buffer the last step wrote, and its taps, are done with
    for (int t = threadIdx.x; t < n_taps; t += kThreads) taps[t] = table[head[3] + t];
    __syncthreads();
    margin += head[1];
    if (rim) {
      if (is_max) step<true, true>(a, b, taps, n_taps, margin, ah, aw, y0, x0, h, w);
      else step<true, false>(a, b, taps, n_taps, margin, ah, aw, y0, x0, h, w);
    } else {
      if (is_max) step<false, true>(a, b, taps, n_taps, margin, ah, aw, y0, x0, h, w);
      else step<false, false>(a, b, taps, n_taps, margin, ah, aw, y0, x0, h, w);
    }
    uint8_t* tmp = a;
    a = b;
    b = tmp;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < th * tw; i += kThreads) {
    const int ty = i / tw, tx = i % tw;
    const int gy = blockIdx.y * th + ty, gx = blockIdx.x * tw + tx;
    if (gy < h && gx < w) out[plane + (long)gy * w + gx] = a[(ty + halo) * aw + tx + halo];
  }
}

}  // namespace

extern "C" {

// Steps first .. first + n_steps - 1 of `table` on the k images (h, w) of
// `in` into `out`, on tiles of th x tw pixels with a halo of `halo` (the sum of
// those steps' radii) and room for max_taps taps.  Returns a CUDA error code
// (0 on success).
int pw_morph_dense_run(const uint8_t* in, uint8_t* out, const int* table, int first, int n_steps, int halo, int th,
                       int tw, int max_taps, int k, int h, int w, void* stream) {
  if (k <= 0 || h <= 0 || w <= 0 || n_steps <= 0 || th <= 0 || tw <= 0) return (int)cudaErrorInvalidValue;
  const size_t cells = ((size_t)(th + 2 * halo) * (tw + 2 * halo) + 3) & ~(size_t)3;
  const size_t smem = 2 * cells + sizeof(int) * (size_t)max_taps;
  cudaError_t err = cudaFuncSetAttribute(morph_dense, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((w + tw - 1) / tw), (unsigned)((h + th - 1) / th), (unsigned)k);
  morph_dense<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(in, out, table, first, n_steps, halo, th,
                                                                           tw, h, w);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
