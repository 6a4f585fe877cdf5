// K3+K4 pw_edge_candidates: Q8 Gaussian blur, Sobel, L1 magnitude, sector
// non-maximum suppression and the double threshold in one launch, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA fusions of plotweave/ops/filters.py::gaussian_blur_u8
// (:42-63) and of the part of plotweave/ops/canny.py::canny_packed before
// its hysteresis loop (_sobel_pair :32-47, the NMS and thresholds :65-103),
// which eager PyTorch runs as some eighty launches over int16 and int32
// planes.  It writes the `cand` and `strong` bitboards that K5 reads (32 px a
// word, LSB first, bits at and beyond W zero), or, in its blur-only mode, the
// blurred uint8 image.  Its input is a bitboard, a set bit reading as 255
// (the mask from K2: the dense mask never reaches device memory), or a dense
// uint8 image; a template parameter picks the loader.  ksize 1 blurs nothing
// (its one tap is 256), so the same kernel serves Canny on a plain image.
//
// Numbers, all integer and exact: the row pass sums tap * pixel (taps sum to
// 256, so at most 65,280: uint16), the column pass sums tap * row sum in
// int32, one (acc + 2^15) >> 16 after both, clamped to 255.  Sobel and the
// magnitude fit int16; the Q15 sector products (ay << 15, 13573 ax + (ax <<
// 16), at most 8.1e7) run in int32.  A zero gradient counts as non-negative.
//
// Three borders, each in its own pass over a tile in shared memory.  A block
// owns `th` rows x `tww` whole words of columns and loads them with a halo of
// R = ksize / 2 + 2 px:
//   1. load: cell (i, j) of the input region holds the pixel at (reflect101(y0
//      - R + i), reflect101(x0 - R + j)): the blur's border, repeated for a
//      radius beyond the axis;
//   2. row pass, then column pass: the blurred byte of every in-image pixel of
//      the tile and 2 px around it.  A cell outside the image is never read:
//   3. Sobel reads the blurred image with a replicate border, i.e. at the
//      clamped coordinate (which lies in the tile's region, because a tile
//      that reaches beyond the image starts inside it), and gives the
//      magnitude of every pixel of the tile and 1 px around it, 0 outside the
//      image: the NMS's border;
//   4. each pixel of the tile recomputes its own gx, gy, compares its
//      magnitude with the sector's two neighbours, applies the thresholds,
//      and a warp's 32 pixels leave as one word of each board by
//      __ballot_sync.
// The taps come as data (any ksize, any sigma); the wrapper picks the tile so
// that the region fits 227 KB, before any launch
// (ops/kernels.py::edge_schedule): 32 rows x 4 words at the defaults, 30 KB
// at ksize 7.
//
// Bound: operations.  At 4 x 1500 x 2000 px from a board it reads 1.5 MB and
// writes 3 MB (1.3 us at 3.35 TB/s); a pixel takes 2 ksize multiply-adds and
// 4 operations of rounding and clamping for the blur and 33 integer
// operations of Sobel, magnitude and NMS (12 + 3 + 18, counted below; loads
// and index arithmetic apart): 47 at ksize 5, 51 at ksize 7, about 0.035 ms
// at the card's INT32 rate.  On an H100 80GB HBM3 at 700 W the kernel takes
// 0.173 ms there at ksize 5 and 0.187 ms at ksize 7 (PERF.md), a fifth of
// that bound: the Sobel is computed in both the magnitude and the NMS pass,
// and byte loads from shared memory and clamped indices outnumber the
// counted operations.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // threadIdx.x: columns
constexpr int kRows = 8;    // threadIdx.y: rows
constexpr int kThreads = kLanes * kRows;
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block
constexpr int kTG22 = 13573;      // tan(22.5 deg) in Q15

// shared memory of one block: row sums (uint16) and magnitudes (int16), then
// the input and blurred bytes, then the taps
size_t smem_bytes(int th, int tww, int ksize) {
  const int R = ksize / 2 + 2, tw = 32 * tww;
  const size_t ah = th + 2 * R, aw = tw + 2 * R, bh = th + 4, bw = tw + 4, ch = th + 2, cw = tw + 2;
  size_t bytes = 2 * ah * bw + 2 * ch * cw + ah * aw + bh * bw;
  return (bytes + 3) / 4 * 4 + 4 * (size_t)ksize;
}

// numpy's mode="reflect" (reflect-101), repeated for any distance
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = (i < 0 ? -i : i) % period;
  return i >= n ? period - i : i;
}

// 3x3 Sobel of the blurred tile at image pixel (y, x), replicate border: the
// neighbours' coordinates clamped to the image.  9 clamps and offsets, 8
// loads, 12 adds and shifts.
__device__ __forceinline__ void sobel_at(const uint8_t* __restrict__ blur_s, int bw, int y, int x, int y0, int x0,
                                         int h, int w, int& gx, int& gy) {
  const uint8_t* up = blur_s + (max(y - 1, 0) - y0 + 2) * bw;
  const uint8_t* mid = blur_s + (y - y0 + 2) * bw;
  const uint8_t* down = blur_s + (min(y + 1, h - 1) - y0 + 2) * bw;
  const int xl = max(x - 1, 0) - x0 + 2, xc = x - x0 + 2, xr = min(x + 1, w - 1) - x0 + 2;
  const int a = up[xl], b = up[xc], c = up[xr], d = mid[xl], f = mid[xr], g = down[xl], hh = down[xc], i = down[xr];
  gx = (c + 2 * f + i) - (a + 2 * d + g);
  gy = (g + 2 * hh + i) - (a + 2 * b + c);
}

template <bool kBoardsIn>
__global__ void __launch_bounds__(kThreads)
    edge_tiles(const void* __restrict__ in, uint32_t* __restrict__ cand, uint32_t* __restrict__ strong,
               uint8_t* __restrict__ blurred, const int* __restrict__ taps, int ksize, int th, int tww, int h, int w,
               int nw, int low, int high) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = ksize / 2, R = r + 2, tw = 32 * tww;
  const int ah = th + 2 * R, aw = tw + 2 * R, bh = th + 4, bw = tw + 4, ch = th + 2, cw = tw + 2;
  uint16_t* tmp_s = reinterpret_cast<uint16_t*>(smem);      // (ah, bw) row sums
  int16_t* mag_s = reinterpret_cast<int16_t*>(tmp_s + ah * bw);  // (ch, cw) magnitudes
  uint8_t* in_s = reinterpret_cast<uint8_t*>(mag_s + ch * cw);   // (ah, aw) input
  uint8_t* blur_s = in_s + ah * aw;                              // (bh, bw) blurred
  int* taps_s = reinterpret_cast<int*>(smem + ((2 * ah * bw + 2 * ch * cw + ah * aw + bh * bw + 3) / 4) * 4);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int y0 = blockIdx.y * th, x0 = blockIdx.x * tw;
  const long layer = blockIdx.z;

  // 1. the input region, reflect-101 about the image's edges
  for (int j = ty * kLanes + tx; j < ksize; j += kThreads) taps_s[j] = taps[j];
  for (int i = ty; i < ah; i += kRows) {
    const int yy = reflect101(y0 - R + i, h);
    for (int j = tx; j < aw; j += kLanes) {
      const int xx = reflect101(x0 - R + j, w);
      if (kBoardsIn) {
        const uint32_t word = static_cast<const uint32_t*>(in)[(layer * h + yy) * nw + (xx >> 5)];
        in_s[i * aw + j] = ((word >> (xx & 31)) & 1u) ? 255 : 0;
      } else {
        in_s[i * aw + j] = static_cast<const uint8_t*>(in)[(layer * h + yy) * w + xx];
      }
    }
  }
  __syncthreads();

  // 2a. row pass: column jb of tmp_s is image column x0 - 2 + jb, whose tap t reads input column jb + t
  for (int i = ty; i < ah; i += kRows) {
    for (int jb = tx; jb < bw; jb += kLanes) {
      const uint8_t* p = in_s + i * aw + jb;
      int acc = 0;
      for (int t = 0; t < ksize; ++t) acc += taps_s[t] * p[t];
      tmp_s[i * bw + jb] = (uint16_t)acc;
    }
  }
  __syncthreads();

  // 2b. column pass: row ib of blur_s is image row y0 - 2 + ib, whose tap t reads row ib + t of tmp_s
  for (int ib = ty; ib < bh; ib += kRows) {
    for (int jb = tx; jb < bw; jb += kLanes) {
      const uint16_t* p = tmp_s + ib * bw + jb;
      int acc = 0;
      for (int t = 0; t < ksize; ++t) acc += taps_s[t] * p[t * bw];
      blur_s[ib * bw + jb] = (uint8_t)min(max((acc + (1 << 15)) >> 16, 0), 255);
    }
  }
  __syncthreads();

  if (blurred != nullptr) {  // blur only: the tile's own pixels
    for (int i = ty; i < th && y0 + i < h; i += kRows)
      for (int j = tx; j < tw && x0 + j < w; j += kLanes)
        blurred[(layer * h + y0 + i) * w + x0 + j] = blur_s[(i + 2) * bw + j + 2];
    return;
  }

  // 3. the magnitude of the tile and 1 px around it, 0 outside the image
  for (int ic = ty; ic < ch; ic += kRows) {
    const int y = y0 - 1 + ic;
    for (int jc = tx; jc < cw; jc += kLanes) {
      const int x = x0 - 1 + jc;
      int mag = 0;
      if (y >= 0 && y < h && x >= 0 && x < w) {
        int gx, gy;
        sobel_at(blur_s, bw, y, x, y0, x0, h, w, gx, gy);
        mag = abs(gx) + abs(gy);
      }
      mag_s[ic * cw + jc] = (int16_t)mag;
    }
  }
  __syncthreads();

  // 4. sector NMS and the thresholds; a warp's 32 pixels are one word.  About
  // 18 operations beside the Sobel: 2 abs, shift, multiply, shift-add, 3
  // compares and selects of the sector, 2 loads and 2 compares of its
  // neighbours, 2 threshold compares, 3 ANDs, 2 ballots.
  for (int i = ty; i < th && y0 + i < h; i += kRows) {
    const int y = y0 + i;
    for (int word = 0; word < tww && x0 / 32 + word < nw; ++word) {
      const int j = 32 * word + tx, x = x0 + j;
      bool c = false, s = false;
      if (x < w) {
        int gx, gy;
        sobel_at(blur_s, bw, y, x, y0, x0, h, w, gx, gy);
        const int16_t* m = mag_s + (i + 1) * cw + j + 1;
        const int mag = m[0], ax = abs(gx), ay = abs(gy) << 15;
        const int tg22x = ax * kTG22, tg67x = tg22x + (ax << 16);
        bool keep;
        if (ay < tg22x)
          keep = mag > m[-1] && mag >= m[1];
        else if (ay > tg67x)
          keep = mag > m[-cw] && mag >= m[cw];
        else if ((gx ^ gy) < 0)  // the gradient along the anti-diagonal
          keep = mag > m[-cw + 1] && mag > m[cw - 1];
        else
          keep = mag > m[-cw - 1] && mag > m[cw + 1];
        c = keep && mag > low;
        s = c && mag > high;
      }
      const uint32_t cm = __ballot_sync(0xffffffffu, c), sm = __ballot_sync(0xffffffffu, s);
      if (tx == 0) {
        const long o = (layer * h + y) * nw + x0 / 32 + word;
        cand[o] = cm;
        strong[o] = sm;
      }
    }
  }
}

}  // namespace

extern "C" {

// `in`: (k, h, ceil(w/32)) words when boards_in, else (k, h, w) bytes.  With
// `blurred` null, writes the cand and strong boards (k, h, ceil(w/32)) for the
// thresholds low <= high (swapped and clamped by the caller); else writes
// only the blurred (k, h, w) bytes.  `taps`: ksize Q8 ints in device memory.
// A block owns th rows x tww words.  Returns a CUDA error code (0 on
// success), cudaErrorInvalidValue for arguments the kernel does not take.
int pw_edge_candidates(const void* in, int boards_in, uint32_t* cand, uint32_t* strong, uint8_t* blurred,
                       const int* taps, int ksize, int th, int tww, int k, int h, int w, int low, int high,
                       void* stream) {
  if (k <= 0 || k > 65535 || h <= 0 || w <= 0 || ksize <= 0 || th <= 0 || tww <= 0) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  const unsigned gx = (unsigned)((nw + tww - 1) / tww), gy = (unsigned)((h + th - 1) / th);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(th, tww, ksize);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = boards_in ? edge_tiles<true> : edge_tiles<false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3(gx, gy, (unsigned)k), dim3(kLanes, kRows), smem, static_cast<cudaStream_t>(stream)>>>(
      in, cand, strong, blurred, taps, ksize, th, tww, h, w, nw, low, high);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
