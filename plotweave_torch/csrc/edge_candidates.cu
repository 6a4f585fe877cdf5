// K3+K4 pw_edge_candidates: Q8 Gaussian blur, Sobel, L1 magnitude, sector
// non-maximum suppression and the double threshold in one launch, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA fusions of plotweave/ops/filters.py::gaussian_blur_u8
// (:42-63) and of the part of plotweave/ops/canny.py::canny_packed before
// its hysteresis loop (_sobel_pair :32-47, the NMS and thresholds :65-103),
// which eager PyTorch runs as some hundred launches over int16 and int32
// planes.  It writes the `cand` and `strong` bitboards that K5 reads (32 px a
// word, LSB first, bits at and beyond W zero), or, in its blur-only mode, the
// blurred uint8 image.  Its input is a bitboard, a set bit reading as 255
// (the mask from K2: the dense mask never reaches device memory), or a dense
// uint8 image; a template parameter picks the loader.  ksize 1 blurs nothing
// (its one tap is 256), so the same kernel serves Canny on a plain image.
//
// Numbers, all integer and exact: the row pass sums tap * pixel (taps sum to
// 256, so at most 65,280: uint16), the column pass sums tap * row sum in
// int32, one (acc + 2^15) >> 16 after both.  Sobel and the magnitude fit
// int16; the Q15 sector products (ay << 15, 13573 ax + (ax << 16), at most
// 8.1e7) run in int32.  A zero gradient counts as non-negative.
//
// Bound: operations.  At 4 x 1500 x 2000 px from a board it reads 1.5 MB and
// writes 3 MB (1.3 us at 3.35 TB/s); a pixel takes 2 ksize multiply-adds and
// 4 operations of rounding and clamping for the blur and 33 integer
// operations of Sobel, magnitude and NMS (12 + 3 + 18; loads and index
// arithmetic apart): 47 at ksize 5, 51 at ksize 7, 0.034 and 0.037 ms at the
// card's INT32 rate (132 SMs x 64 lanes x 1.98 GHz).  The first version of
// this kernel (one pixel a thread and pass, a board expanded to bytes, the
// Sobel computed in the magnitude pass and again in the NMS pass, reflected
// and clamped coordinates for every cell) took 0.173 ms there at ksize 5 and
// 0.187 ms at ksize 7 on an H100 80GB HBM3 at 700 W, about 200 instructions
// a pixel.  This design takes 0.078 ms and 0.081 ms there, kernel alone (43 %
// and 45 % of the bound; 0.089 and 0.095 ms from a dense image; PERF.md):
// what is left over the counted operations is the warm-up rows of each row
// segment, the two extra columns of Sobel parts, and 105-113 registers a
// thread, which hold an SM to two blocks of 256 threads (a cap of 80
// registers spills and gains nothing measurable).
//
// What the design does about it.  A block of 256 threads owns a tile of `th`
// rows x `tww` words of columns (ops/kernels.py::edge_schedule: 64 x 4 where
// that leaves a thousand blocks, else 32 x 4, less where 227 KB demand it) and runs three passes over shared memory:
//
//   1. load the input region, the tile and a halo of R = ksize / 2 + 2 px,
//      as it lies in memory: a board stays words (32 px each, never bytes), a
//      dense image is copied word by word where its rows are 4-byte aligned.
//   2. blur walk: a thread owns a strip of four columns of the blurred
//      region (the tile and 2 px around it) and a segment of its rows, and
//      walks down them.  Per input row it takes the four row sums of its
//      strip: from a board, one funnel shift cuts the ksize + 3 bits under
//      the strip out of two words, and each pixel's ksize-bit window indexes
//      a table of 2^ksize uint16 sums (255 x the taps under the set bits),
//      built once a block in shared memory; from bytes, one __dp4a per four
//      taps on windows cut by funnel shifts.  The last ksize row sums live in
//      registers (template instances for ksize 1, 3, 5, 7, 9, the loop
//      unrolled over the ring's period so no register moves), one row of
//      sums in and one blurred word out per step: the column pass re-reads
//      nothing.
//   3. Sobel and NMS walk: a thread owns four pixels of a row and a segment
//      of rows.  Per blurred row it loads two words (its pixels and two
//      beside them on each side), takes the horizontal difference and
//      smoothing of six columns, and from three rows of those gx, gy and the
//      magnitude of its four pixels and one on each side, once.  The NMS of
//      row y runs one row behind, when the magnitudes of row y + 1 exist,
//      with gx, gy of row y still in registers.  Recomputing two columns in
//      six costs less than a shuffle per neighbour and keeps a warp's edge
//      lanes on the same path (the tile is 33 strips wide with its ring, one
//      more than a warp).  Four pixels' bits are ORed across the eight lanes
//      of a word by three shuffles, and each word of `cand` and `strong` is
//      written once.
//
// Rim and interior apart, a block-uniform branch.  A tile whose region lies
// inside the image runs no reflect101, no clamp and no image-bound test.
// Only a rim tile (122 of 752 a layer at 1500 x 2000) loads through
// reflect101 (the blur's border, repeated for a radius beyond the axis; a
// board word that crosses the image's edge is assembled bit by bit), copies
// the blurred bytes at the clamped coordinates into the blurred cells
// outside the image (Sobel's replicate border: a pass of its own, so the
// walk reads plain neighbours), zeroes the magnitude outside the image (the
// NMS's border, which also keeps the bits at and beyond W zero) and tests which
// rows and words of the boards exist.
//
// Slab mode (row sharding, parallel/spatial.py): the input is a slab of
// `top` + `own` + `bottom` rows, the shard's own rows widened by rows copied
// from its neighbours, and only the own rows are written, at their own row
// 0.  The kernel treats the whole buffer as the image: the tiles cover the
// own rows, a tile is interior where its region lies inside the buffer and
// inside the own rows, and the rim's reflect-101, replicate and zero
// magnitude apply at the buffer's ends.  A side with 0 halo rows is the
// image's border, so there they are today's rules; a side with at least
// ksize / 2 + 2 halo rows (ksize / 2 blur-only) keeps every cell that an own
// row reads inside the buffer, so there they change nothing an own row
// reads (the caller checks those counts).  Unsharded calls are top 0,
// bottom 0.
//
// Any other ksize (even, above 9) or taps that do not fit a byte (a sigma so
// small that one tap is 256) take the general path: passes 1 and 3 as above,
// pass 2 as a row pass over uint16 sums in shared memory and a column pass
// that loops over them, taps as data.  Tensor cores are not used (a 5- or
// 7-tap band in an MMA tile wastes over 90 % of it, and the column pass's
// inputs are 16-bit), nor TMA or cp.async (a block loads 1 KB of board).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
#ifndef PW_EDGE_MIN_BLOCKS
#define PW_EDGE_MIN_BLOCKS 2  // blocks an SM must hold: caps the registers a thread may take (chip_smoke.py sweeps it)
#endif
constexpr int kMaxSmem = 232448;  // 227 KB, the opt-in limit of one block
constexpr int kTG22 = 13573;      // tan(22.5 deg) in Q15
constexpr unsigned kFull = 0xffffffffu;

// One block's shared memory, in 32-bit words: the blurred bytes of the tile
// and 2 px around it, the input region, then the table (fast path from a
// board) or the uint16 row sums (general path), then the taps.
struct Layout {
  int R, tw, ah, bh, bwords, hw, pad, in_words, aux_words;
};

__host__ __device__ inline Layout make_layout(int th, int tww, int ksize, bool boards, bool fast) {
  Layout L;
  L.R = ksize / 2 + 2, L.tw = 32 * tww;
  L.ah = th + 2 * L.R, L.bh = th + 4, L.bwords = L.tw / 4 + 1;
  L.hw = (L.R + 31) / 32;  // a board's halo in words
  const int ra = (L.R + 3) / 4 * 4;  // a dense fast tile starts on a word: its halo in bytes
  L.pad = (!boards && fast) ? ra - L.R : 0;
  if (boards) L.in_words = tww + 2 * L.hw;
  else if (fast) L.in_words = L.tw / 4 + ra / 2 + 1;
  else L.in_words = (L.tw + 2 * L.R + 3) / 4;
  if (!fast) L.aux_words = L.ah * (L.tw + 4) / 2;
  else L.aux_words = boards ? ((1 << ksize) + 1) / 2 : 0;
  return L;
}

size_t smem_bytes(const Layout& L, int ksize) {
  return 4 * ((size_t)L.bh * L.bwords + (size_t)L.ah * L.in_words + (size_t)L.aux_words + (size_t)ksize);
}

// numpy's mode="reflect" (reflect-101), repeated for any distance
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i >= 0 && i < n) return i;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i = (i < 0 ? -i : i) % period;
  return i >= n ? period - i : i;
}

// 1. the input region of a board: row i is image row y0 - R + i, word jw is
// word x0 / 32 - hw + jw of that row.
template <bool kRim>
__device__ __forceinline__ void load_board(const Layout& L, const uint32_t* __restrict__ src, uint32_t* in_s, int y0,
                                           int x0, int h, int w, int nw) {
  const int w0 = x0 / 32 - L.hw;
  for (int idx = threadIdx.x; idx < L.ah * L.in_words; idx += kThreads) {
    const int i = idx / L.in_words, wi = w0 + idx - i * L.in_words;
    uint32_t word = 0;
    if (!kRim) {
      if (wi >= 0 && wi < nw) word = src[(long)(y0 - L.R + i) * nw + wi];
    } else {
      const uint32_t* row = src + (long)reflect101(y0 - L.R + i, h) * nw;
      const int xs = 32 * wi;
      if (xs >= 0 && xs + 32 <= w) {
        word = row[wi];
      } else {  // the word crosses the image's edge: bit by bit, never a bit at or beyond W
        for (int b = 0; b < 32; ++b) {
          const int xx = reflect101(xs + b, w);
          word |= ((row[xx >> 5] >> (xx & 31)) & 1u) << b;
        }
      }
    }
    in_s[idx] = word;
  }
}

// 1. the input region of a dense image: row i is image row y0 - R + i, byte
// pad + j of it is column x0 - R + j.
template <bool kRim>
__device__ __forceinline__ void load_dense(const Layout& L, const uint8_t* __restrict__ src, uint32_t* in_s, int y0,
                                           int x0, int h, int w, bool words) {
  if (!kRim && words) {  // whole words: the region starts pad bytes before column x0 - R, on a word of the row
    const int n = L.in_words - 1;
    for (int idx = threadIdx.x; idx < L.ah * n; idx += kThreads) {
      const int i = idx / n, m = idx - i * n;
      const uint8_t* row = src + (long)(y0 - L.R + i) * w + (x0 - L.R - L.pad);
      in_s[i * L.in_words + m] = reinterpret_cast<const uint32_t*>(row)[m];
    }
    return;
  }
  uint8_t* in_b = reinterpret_cast<uint8_t*>(in_s);
  const int aw = L.tw + 2 * L.R;
  for (int idx = threadIdx.x; idx < L.ah * aw; idx += kThreads) {
    const int i = idx / aw, j = idx - i * aw;
    int yy = y0 - L.R + i, xx = x0 - L.R + j;
    if (kRim) yy = reflect101(yy, h), xx = reflect101(xx, w);
    in_b[i * L.in_words * 4 + L.pad + j] = src[(long)yy * w + xx];
  }
}

// The four row sums of strip j (blurred columns x0 - 2 + 4 j ...) on one row
// of the input region.  With KS 1 they are the four pixels themselves.
template <int KS, bool kBoards>
__device__ __forceinline__ void row_sums(const uint32_t* row, int j, int bit0, const uint16_t* tab,
                                         const uint32_t (&tapw)[(KS + 3) / 4], int (&out)[4]) {
  if (kBoards) {
    // the strip's first window starts at bit 32 hw - R + 4 j of the row; KS + 3 bits serve its four pixels
    const int bit = bit0 + 4 * j;
    const uint32_t win = __funnelshift_r(row[bit >> 5], row[(bit >> 5) + 1], bit & 31);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (KS == 1) out[p] = ((win >> p) & 1u) * 255;
      else out[p] = tab[(win >> p) & ((1u << KS) - 1u)];
    }
  } else {
    constexpr int R = KS / 2 + 2, kPad = (R + 3) / 4 * 4 - R, kNQ = (KS + 3) / 4;
    constexpr int kNW = ((kPad + 3 + 4 * (kNQ - 1)) >> 2) + 2;
    uint32_t wd[kNW];
#pragma unroll
    for (int m = 0; m < kNW; ++m) wd[m] = row[j + m];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t acc = 0;
#pragma unroll
      for (int q = 0; q < kNQ; ++q) {
        const int k = kPad + p + 4 * q;  // the window's first byte, a constant once unrolled
        const uint32_t win = (k & 3) ? __funnelshift_r(wd[k >> 2], wd[(k >> 2) + 1], 8 * (k & 3)) : wd[k >> 2];
        if (KS == 1) acc = win & 255u;
        else acc = __dp4a(win, tapw[q], acc);
      }
      out[p] = (int)acc;
    }
  }
}

// 2. the blur walk of the fast path: thread (segment, strip) walks down its
// rows of the blurred region with the last KS row sums in registers.
template <int KS, bool kBoards>
__device__ __forceinline__ void blur_walk(const Layout& L, const uint32_t* in_s, const uint16_t* tab,
                                          const int* __restrict__ taps, uint32_t* blur_s) {
  const int nsx = L.bwords, nseg = max(1, kThreads / nsx), rps = (L.bh + nseg - 1) / nseg;
  const int tid = threadIdx.x;
  if (tid >= nsx * nseg) return;
  const int seg = tid / nsx, j = tid - seg * nsx;
  const int b0 = seg * rps, b1 = min(L.bh, b0 + rps);
  if (b0 >= b1) return;
  int tp[KS];
  uint32_t tapw[(KS + 3) / 4];
#pragma unroll
  for (int q = 0; q < (KS + 3) / 4; ++q) tapw[q] = 0;
#pragma unroll
  for (int t = 0; t < KS; ++t) {
    tp[t] = taps[t];
    tapw[t / 4] |= ((uint32_t)tp[t] & 255u) << (8 * (t % 4));
  }
  const int bit0 = 32 * L.hw - L.R;
  int ring[KS][4];
  // blurred row ib sums input rows ib ... ib + KS - 1; step t loads row b0 + t into slot t % KS
  const int nsteps = (b1 - b0) + KS - 1;
  for (int base = 0; base < nsteps; base += KS) {
#pragma unroll
    for (int u = 0; u < KS; ++u) {
      const int t = base + u;
      if (t < nsteps) {
        row_sums<KS, kBoards>(in_s + (b0 + t) * L.in_words, j, bit0, tab, tapw, ring[u]);
        if (t >= KS - 1) {
          uint32_t word = 0;
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            int v;
            if (KS == 1) {
              v = ring[0][p];
            } else {
              int acc = 1 << 15;
#pragma unroll
              for (int q = 0; q < KS; ++q) acc += tp[q] * ring[(u + 1 + q) % KS][p];
              v = acc >> 16;  // at most 255: the taps are non-negative and sum to 256
            }
            word |= (uint32_t)v << (8 * p);
          }
          blur_s[(b0 + t - (KS - 1)) * L.bwords + j] = word;
        }
      }
    }
  }
}

// 2. the general path: any ksize, taps as data.  Row sums (uint16) of every
// row of the region, then the column pass over them.
template <bool kBoards>
__device__ __forceinline__ void blur_general(const Layout& L, const uint32_t* in_s, uint16_t* rs_s, const int* taps_s,
                                             int ksize, uint32_t* blur_s) {
  const int bw = L.tw + 4;
  const uint8_t* in_b = reinterpret_cast<const uint8_t*>(in_s);
  for (int idx = threadIdx.x; idx < L.ah * bw; idx += kThreads) {
    const int i = idx / bw, jb = idx - i * bw;
    int acc = 0;
    if (kBoards) {
      const uint32_t* row = in_s + i * L.in_words;
      for (int t = 0; t < ksize; ++t) {
        const int bit = 32 * L.hw - L.R + jb + t;
        acc += taps_s[t] * (int)((row[bit >> 5] >> (bit & 31)) & 1u);
      }
      acc *= 255;
    } else {
      const uint8_t* p = in_b + i * L.in_words * 4 + jb;
      for (int t = 0; t < ksize; ++t) acc += taps_s[t] * p[t];
    }
    rs_s[idx] = (uint16_t)acc;
  }
  __syncthreads();
  uint8_t* blur_b = reinterpret_cast<uint8_t*>(blur_s);
  for (int idx = threadIdx.x; idx < L.bh * bw; idx += kThreads) {
    const int ib = idx / bw, jb = idx - ib * bw;
    const uint16_t* p = rs_s + ib * bw + jb;
    int acc = 0;
    for (int t = 0; t < ksize; ++t) acc += taps_s[t] * p[t * bw];
    blur_b[idx] = (uint8_t)min(max((acc + (1 << 15)) >> 16, 0), 255);
  }
}

// 3. Sobel, magnitude, NMS and thresholds.  Thread (segment, strip) owns
// pixels x0 + 4 s ... + 3 of the tile rows of its segment.  Step t loads
// blurred row i0 + t (image row y0 - 2 + i0 + t); its horizontal parts and
// those of the two rows before give gx, gy and the magnitude of tile row
// i0 + t - 3 for columns x - 1 ... x + 4; the NMS of tile row i0 + t - 4
// follows with three rows of magnitudes in registers.  Slots rotate with
// period 3, unrolled.
template <bool kRim>
__device__ __forceinline__ void sobel_nms_walk(const Layout& L, const uint32_t* blur_s, uint32_t* __restrict__ cand,
                                               uint32_t* __restrict__ strong, int th, int y0, int x0, int h, int w,
                                               int nw, int low, int high, int top, int yend) {
  const int nss = L.tw / 4, nseg = max(1, kThreads / nss), rps = (th + nseg - 1) / nseg;
  const int tid = threadIdx.x;
  const bool active = tid < nss * nseg;  // every thread walks (the shuffles want whole warps); only these store
  const int seg = active ? tid / nss : 0, s = active ? tid - seg * nss : 0;
  const int i0 = seg * rps, i1 = min(th, i0 + rps);
  const int x = x0 + 4 * s;
  int d[3][6], sm[3][6], mg[3][6], gxs[3][4], gys[3][4];
  const int nsteps = rps + 4;
  for (int base = 0; base < nsteps; base += 3) {
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const int t = base + u;
      if (t < nsteps) {
        // a segment that overhangs the tile re-reads the last row; what it computes there is not stored
        const uint32_t* row = blur_s + min(i0 + t, L.bh - 1) * L.bwords + s;
        const uint32_t lo = row[0], hi = row[1];
        int b[8];
#pragma unroll
        for (int c = 0; c < 4; ++c) b[c] = (lo >> (8 * c)) & 255u, b[c + 4] = (hi >> (8 * c)) & 255u;
#pragma unroll
        for (int c = 0; c < 6; ++c) d[u][c] = b[c + 2] - b[c], sm[u][c] = b[c] + 2 * b[c + 1] + b[c + 2];
        if (t >= 2) {
          const int s0 = (u + 1) % 3, s1 = (u + 2) % 3;  // the rows of steps t - 2 and t - 1
          const int m = i0 + t - 3;                      // this magnitude's tile row, -1 ... th
#pragma unroll
          for (int c = 0; c < 6; ++c) {
            const int gx = d[s0][c] + 2 * d[s1][c] + d[u][c], gy = sm[u][c] - sm[s0][c];
            int mag = abs(gx) + abs(gy);
            if (kRim && !((unsigned)(y0 + m) < (unsigned)h && (unsigned)(x - 1 + c) < (unsigned)w)) mag = 0;
            mg[s0][c] = mag;
            if (c >= 1 && c <= 4) gxs[s0][c - 1] = gx, gys[s0][c - 1] = gy;
          }
          if (t >= 4) {
            // tile row i = m - 1: magnitudes above in slot s1, its own (and gx, gy) in slot u, below in slot s0
            const int i = m - 1;
            uint32_t cbits = 0, sbits = 0;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = q + 1, gx = gxs[u][q], gy = gys[u][q];
              const int mag = mg[u][c], ax = abs(gx), ay = abs(gy) << 15;
              const int tg22x = ax * kTG22, tg67x = tg22x + (ax << 16);
              bool keep;
              if (ay < tg22x)
                keep = mag > mg[u][c - 1] && mag >= mg[u][c + 1];
              else if (ay > tg67x)
                keep = mag > mg[s1][c] && mag >= mg[s0][c];
              else if ((gx ^ gy) < 0)  // the gradient along the anti-diagonal
                keep = mag > mg[s1][c + 1] && mag > mg[s0][c - 1];
              else
                keep = mag > mg[s1][c - 1] && mag > mg[s0][c + 1];
              const bool cb = keep && mag > low;  // never beyond the image: a magnitude of 0 keeps nothing
              cbits |= (uint32_t)cb << q;
              sbits |= (uint32_t)(cb && mag > high) << q;
            }
            // eight lanes hold one word: OR their nibbles together
            cbits <<= 4 * (s & 7), sbits <<= 4 * (s & 7);
#pragma unroll
            for (int o = 1; o < 8; o <<= 1) {
              cbits |= __shfl_xor_sync(kFull, cbits, o);
              sbits |= __shfl_xor_sync(kFull, sbits, o);
            }
            bool store = active && (s & 7) == 0 && i < i1;
            if (kRim) store = store && y0 + i < yend && x0 / 32 + (s >> 3) < nw;
            if (store) {
              const long o = (long)(y0 + i - top) * nw + x0 / 32 + (s >> 3);
              cand[o] = cbits;
              strong[o] = sbits;
            }
          }
        }
      }
    }
  }
}

template <int KS, bool kBoards, bool kRim>
__device__ __forceinline__ void tile(const Layout& L, uint32_t* smem, const void* __restrict__ in,
                                     uint32_t* __restrict__ cand, uint32_t* __restrict__ strong,
                                     uint8_t* __restrict__ blurred, const int* __restrict__ taps, int ksize, int th,
                                     int y0, int x0, long layer, int h, int w, int nw, int low, int high,
                                     int aligned, int top, int own) {
  uint32_t* blur_s = smem;
  uint32_t* in_s = blur_s + L.bh * L.bwords;
  uint32_t* aux_s = in_s + L.ah * L.in_words;
  int* taps_s = reinterpret_cast<int*>(aux_s + L.aux_words);
  const int tid = threadIdx.x;

  // 1. the input region, the taps, the table of window sums
  if (kBoards) load_board<kRim>(L, static_cast<const uint32_t*>(in) + layer * h * nw, in_s, y0, x0, h, w, nw);
  else load_dense<kRim>(L, static_cast<const uint8_t*>(in) + layer * h * w, in_s, y0, x0, h, w,
                        KS > 0 && (aligned & 1));
  if (KS == 0) {
    for (int t = tid; t < ksize; t += kThreads) taps_s[t] = taps[t];
  } else if (kBoards && KS > 1) {
    uint16_t* tab = reinterpret_cast<uint16_t*>(aux_s);
    for (int m = tid; m < (1 << KS); m += kThreads) {
      int sum = 0;
#pragma unroll
      for (int t = 0; t < KS; ++t) sum += ((m >> t) & 1) * taps[t];
      tab[m] = (uint16_t)(255 * sum);
    }
  }
  __syncthreads();

  // 2. the blurred bytes of the tile and 2 px around it
  if (KS == 0) blur_general<kBoards>(L, in_s, reinterpret_cast<uint16_t*>(aux_s), taps_s, ksize, blur_s);
  else blur_walk<(KS > 0 ? KS : 1), kBoards>(L, in_s, reinterpret_cast<const uint16_t*>(aux_s), taps, blur_s);
  __syncthreads();

  uint8_t* blur_b = reinterpret_cast<uint8_t*>(blur_s);
  const int bw = L.tw + 4;
  if (blurred != nullptr) {  // blur only: the tile's own pixels, a word of four where the rows allow
    uint8_t* dst = blurred + (layer * own + y0 - top) * w;  // the tile's first row: own row y0 - top
    for (int idx = tid; idx < th * (L.tw / 4); idx += kThreads) {
      const int i = idx / (L.tw / 4), s = idx - i * (L.tw / 4), y = y0 + i, x = x0 + 4 * s;
      if (y < top + own && x < w) {
        const uint32_t* row = blur_s + (i + 2) * L.bwords + s;
        const uint32_t word = __funnelshift_r(row[0], row[1], 16);
        if (aligned & 2) {
          *reinterpret_cast<uint32_t*>(dst + (long)i * w + x) = word;
        } else {
          for (int p = 0; p < 4 && x + p < w; ++p) dst[(long)i * w + x + p] = (uint8_t)(word >> (8 * p));
        }
      }
    }
    return;
  }

  if (kRim) {
    // Sobel's replicate border: a blurred cell outside the image takes the byte at the clamped coordinate,
    // which lies inside the image and inside this region (a tile that reaches beyond the image starts in it)
    for (int idx = tid; idx < L.bh * bw; idx += kThreads) {
      const int ib = idx / bw, jb = idx - ib * bw, y = y0 - 2 + ib, x = x0 - 2 + jb;
      if (y < 0 || y >= h || x < 0 || x >= w)
        blur_b[idx] = blur_b[(min(max(y, 0), h - 1) - y0 + 2) * bw + min(max(x, 0), w - 1) - x0 + 2];
    }
    __syncthreads();
  }

  // 3. Sobel once a pixel, the NMS one row behind, a word of each board per eight lanes
  sobel_nms_walk<kRim>(L, blur_s, cand + layer * own * nw, strong + layer * own * nw, th, y0, x0, h, w, nw, low, high,
                       top, top + own);
}

// KS: the template instance of the fast path (ksize itself), or 0 for the
// general path.
template <int KS, bool kBoards>
__global__ void __launch_bounds__(kThreads, PW_EDGE_MIN_BLOCKS)
    edge_tiles(const void* __restrict__ in, uint32_t* __restrict__ cand, uint32_t* __restrict__ strong,
               uint8_t* __restrict__ blurred, const int* __restrict__ taps, int ksize, int th, int tww, int h, int w,
               int nw, int low, int high, int aligned, int top, int own) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Layout L = make_layout(th, tww, ksize, kBoards, KS > 0);
  // h counts the buffer's rows; the tiles cover its own rows [top, top + own)
  const int y0 = top + blockIdx.y * th, x0 = blockIdx.x * L.tw;
  const long layer = blockIdx.z;
  // interior: the tile's region with its halo lies inside the buffer, and its rows are own rows
  const bool interior = y0 >= L.R && y0 + th + L.R <= h && y0 + th <= top + own && x0 >= L.R && x0 + L.tw + L.R <= w;
  if (interior)
    tile<KS, kBoards, false>(L, smem, in, cand, strong, blurred, taps, ksize, th, y0, x0, layer, h, w, nw, low, high,
                             aligned, top, own);
  else
    tile<KS, kBoards, true>(L, smem, in, cand, strong, blurred, taps, ksize, th, y0, x0, layer, h, w, nw, low, high,
                            aligned, top, own);
}

using Kernel = void (*)(const void*, uint32_t*, uint32_t*, uint8_t*, const int*, int, int, int, int, int, int, int,
                        int, int, int, int);

template <bool kBoards>
Kernel pick(int fast) {
  switch (fast) {
    case 0: return edge_tiles<0, kBoards>;
    case 1: return edge_tiles<1, kBoards>;
    case 3: return edge_tiles<3, kBoards>;
    case 5: return edge_tiles<5, kBoards>;
    case 7: return edge_tiles<7, kBoards>;
    case 9: return edge_tiles<9, kBoards>;
  }
  return nullptr;
}

}  // namespace

extern "C" {

// `in`: (k, h, ceil(w/32)) words when boards_in, else (k, h, w) bytes.  With
// `blurred` null, writes the cand and strong boards (k, own, ceil(w/32)) for
// the thresholds low <= high (swapped and clamped by the caller); else writes
// only the blurred (k, own, w) bytes: rows [top, top + own) of the input,
// the rows around them read as image rows (slab mode; top 0 and own h
// unsharded).  `taps`: ksize Q8 ints in device memory.
// `fast`: ksize itself (1, 3, 5, 7 or 9) where every tap lies in 0..255 (or
// ksize is 1), which the caller vouches for, else 0: the general path.  A
// block owns th rows x tww words.  Returns a CUDA error code (0 on success),
// cudaErrorInvalidValue for arguments the kernel does not take.
int pw_edge_candidates(const void* in, int boards_in, uint32_t* cand, uint32_t* strong, uint8_t* blurred,
                       const int* taps, int ksize, int fast, int th, int tww, int k, int h, int w, int low, int high,
                       int top, int own, void* stream) {
  if (k <= 0 || k > 65535 || h <= 0 || w <= 0 || ksize <= 0 || th <= 0 || tww <= 0 || tww > 4)
    return (int)cudaErrorInvalidValue;
  if (top < 0 || own <= 0 || top + own > h) return (int)cudaErrorInvalidValue;
  if (fast != 0 && fast != ksize) return (int)cudaErrorInvalidValue;
  Kernel kernel = boards_in ? pick<true>(fast) : pick<false>(fast);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int nw = (w + 31) / 32;
  const unsigned gx = (unsigned)((nw + tww - 1) / tww), gy = (unsigned)((own + th - 1) / th);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(make_layout(th, tww, ksize, boards_in != 0, fast != 0), ksize);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // rows of whole words on word boundaries: the dense loader and the blur-only store may move words
  int aligned = 0;
  if (w % 4 == 0) {
    if (!boards_in && reinterpret_cast<uintptr_t>(in) % 4 == 0) aligned |= 1;
    if (blurred != nullptr && reinterpret_cast<uintptr_t>(blurred) % 4 == 0) aligned |= 2;
  }
  kernel<<<dim3(gx, gy, (unsigned)k), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      in, cand, strong, blurred, taps, ksize, th, tww, h, w, nw, low, high, aligned, top, own);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
