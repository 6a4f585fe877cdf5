// K11 pw_morph_dense_run: gray (uint8) morphology, a whole list of erosions
// and dilations by rect, ellipse or cross elements in one launch, for Hopper
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
// Separable row runs.  Min and max are exact and associative, so a step may
// take its cells in any grouping.  ops/kernels.py::element_runs cuts each row
// of the element into runs [dx0, dx1] of set cells and groups the rows by run
// (a rect is one run over every row; a cross one long run on its middle row
// and [0, 0] on the others; an ellipse one symmetric run a row).  A step takes,
// for each distinct run, the run's horizontal min or max over the rows it
// needs (the H pass, into a shared-memory plane), then the vertical min or max
// of that plane over the run's rows (the V pass), and folds the runs together:
// out[y] = op over (run, dy) of H_run[y + dy].  A run [0, 0] skips its H pass.
// A rect 3 step is 2 ops across and 2 down a pixel, against 8 tap by tap.
//
// Packed bytes.  A thread owns 16 consecutive pixels of a row (four 32-bit
// words; one 16-byte shared load or store), never one byte.  The pixels a
// run needs beside them come as words cut by funnel shifts from the aligned
// words around them; a run of up to kFastRun pixels is unrolled by a template
// (every shift an immediate), a longer one walks its words four pixels at a
// time.  Min and max work on four bytes at once (op3: widened to two u16
// lanes by __byte_perm and reduced with Hopper's DPX three-input min/max,
// VIMNMX3; __vminu4 / __vmaxu4 compile to LOP3 and shift sequences and ran
// slower, PERF.md).  A rect of
// side 2 to 5 (every step of swatch mode, morph_open and morph_close at their
// defaults) skips the H plane: a thread owns two word columns and a
// segment of rows, widens each word it loads to u16 pairs once, cuts the
// run's windows from them, and keeps the last K rows of the run's min/max in
// registers (roll_step).  No `/` or `%` runs per pixel: a pass walks its
// (row, chunk) pairs by adding the block's stride.
//
// Tiles, halo, rim.  A CTA walks the tiles of th x tw output pixels (all k
// planes in one list, persistent: grid = the CTAs that fit the card) and holds
// each with a halo of `halo` rows (the sum of the list's radii) and `hx`
// columns (halo rounded up to 16) in shared memory.  Where rows are 16-byte
// aligned in device memory (w % 16 == 0), the next tile's region is loaded by
// 16-byte cp.async while the current one runs its steps (two load buffers);
// else bytes are loaded one by one.  A step writes the window that the rest
// of the list still needs, which shrinks by the step's radius; the 16-pixel
// chunks round it outward, and rows carry 32 bytes of slack on each side, so
// a chunk that straddles the window reads only slack or cells nobody needs.
// Only tiles on the image's rim test coordinates: before each step they set
// every cell outside the image in the rows the step reads to the step's
// neutral value, so the H plane is neutral there too, as _window_reduce pads.  Each step's runs and
// rows come in the kernel's parameter block (__grid_constant__), read
// through the constant cache: nothing is restaged a step.  The wrapper
// (ops/kernels.py::dense_morph_schedule) splits a list whose halo, runs or
// shared memory exceed one launch into segments before any launch.
//
// Bound and prediction.  The function reads each plane once and writes it
// once: 6 MB for one 1500 x 2000 mask, 1.79 us at 3.35 TB/s; its separable
// min/max (rect 3: 4 a pixel a step, four bytes a 32-bit operation) take
// 0.72 us for the mask's open and close at the INT32 rate, so bytes bind.
// Predicted before the first run on the card (estimates from the code): one
// mask's open and close in single-digit microseconds alone (against 0.0987 ms
// for the first design's two launches: one thread a byte, every tap a decoded
// (dy, dx), a division a pixel, the taps restaged each step); the swatch
// run's four masks, stacked, in one launch of 10-20 us.  Both missed (PERF.md):
// each step of a rect 3 over the four masks takes some 8.5 us, where its
// counted operations and shared-memory traffic take a third or less of that
// (what stalls the rest is not measured: no stall profiler runs on the card's
// machine), and a launch of one identity step, its loads, rim and stores,
// takes 10.4 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlack = 32;  // bytes of slack before and after each shared row
constexpr int kFastRun = 9;  // the longest run on the unrolled path
constexpr int kMaxSteps = 32, kMaxGroups = 128, kMaxDys = 640;  // a launch's parameter block
constexpr int kMaxDevices = 64;
constexpr int kRollWords = 2;  // word columns a thread of roll_step owns: one 8-byte load a row
// __byte_perm selectors: the even bytes into two u16 lanes, the odd bytes, and the two lanes' low bytes back
constexpr unsigned kEvens = 0x4240, kOdds = 0x4341, kInterleave = 0x6240;

struct Group {
  short dx0, dx1, first, n, dy_min, dy_max;  // the run, its rows' offsets in Program::dy
};
struct Step {
  short is_max, radius, first, n;  // its groups in Program::group
  short square;  // 0, or the side (2 to 5) of a rect whose rows roll in registers (roll_step)
};
struct Program {
  int n_steps, halo, hx, th, tw, h, w, tiles_x, tiles_y, n_tiles, stride, prefetch, aligned;
  int h_first, h_rows;  // the H plane's first region row and its rows (none where no step needs it)
  Step step[kMaxSteps];
  Group group[kMaxGroups];
  short dy[kMaxDys];
};

__device__ __forceinline__ uint32_t evens(uint32_t a) { return __byte_perm(a, 0, kEvens); }
__device__ __forceinline__ uint32_t odds(uint32_t a) { return __byte_perm(a, 0, kOdds); }

// Bytewise min (max) of three words.
template <bool kMax>
__device__ __forceinline__ uint32_t op3(uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t e = kMax ? __vimax3_u16x2(evens(a), evens(b), evens(c)) : __vimin3_u16x2(evens(a), evens(b), evens(c));
  const uint32_t o = kMax ? __vimax3_u16x2(odds(a), odds(b), odds(c)) : __vimin3_u16x2(odds(a), odds(b), odds(c));
  return __byte_perm(e, o, kInterleave);
}

template <bool kMax>
__device__ __forceinline__ uint32_t op2(uint32_t a, uint32_t b) {
  return op3<kMax>(a, b, b);
}

template <bool kMax>
__device__ __forceinline__ uint4 op3v(uint4 a, uint4 b, uint4 c) {
  return make_uint4(op3<kMax>(a.x, b.x, c.x), op3<kMax>(a.y, b.y, c.y), op3<kMax>(a.z, b.z, c.z),
                    op3<kMax>(a.w, b.w, c.w));
}

template <bool kMax>
__device__ __forceinline__ uint4 op2v(uint4 a, uint4 b) {
  return make_uint4(op2<kMax>(a.x, b.x), op2<kMax>(a.y, b.y), op2<kMax>(a.z, b.z), op2<kMax>(a.w, b.w));
}

// The pairs (y, c) of rows [0, rows) x chunks [0, nc), thread by thread in
// row-major order, walked by adding the block's stride (two divisions a pass).
struct Walk {
  int y, c, sy, sc, nc;
  __device__ explicit Walk(int n) : nc(n) {
    y = threadIdx.x / nc;
    c = threadIdx.x - y * nc;
    sy = kThreads / nc;
    sc = kThreads - sy * nc;
  }
  __device__ void next() {
    c += sc;
    y += sy;
    if (c >= nc) {
      c -= nc;
      ++y;
    }
  }
};

// H pass of a run of L pixels starting at dx0, unrolled: hb = op over the run
// of a, on rows [y0, y1) and chunks [c0, c1).  A[m] is the word of the four
// pixels at 4 m + dx0 from the chunk's start, cut from the aligned words W.
template <int L, bool kMax>
__device__ void hpass_fast(const uint8_t* __restrict__ a, uint8_t* __restrict__ hb, int S, int y0, int y1, int c0,
                           int c1, int dx0) {
  constexpr int kA = 5 + (L - 1) / 4;
  const int qa = dx0 >> 2, s = (dx0 & 3) * 8;
  for (Walk it(c1 - c0); it.y < y1 - y0; it.next()) {
    const int off = (y0 + it.y) * S + (c0 + it.c) * 16;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(a + off) + qa;
    uint32_t A[kA];
    uint32_t w0 = wp[0];
#pragma unroll
    for (int m = 0; m < kA; ++m) {
      const uint32_t w1 = wp[m + 1];
      A[m] = __funnelshift_r(w0, w1, s);
      w0 = w1;
    }
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t v[L];
#pragma unroll
      for (int i = 0; i < L; ++i)
        v[i] = (i & 3) ? __funnelshift_r(A[j + i / 4], A[j + i / 4 + 1], 8 * (i & 3)) : A[j + i / 4];
      uint32_t acc = v[0];
#pragma unroll
      for (int i = 1; i < L; i += 2) acc = i + 1 < L ? op3<kMax>(acc, v[i], v[i + 1]) : op2<kMax>(acc, v[i]);
      r[j] = acc;
    }
    *reinterpret_cast<uint4*>(hb + off) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

// H pass of a longer run: each word walks the run four pixels at a time; the
// last window's pixels past the run repeat its first (min and max are
// idempotent).
template <bool kMax>
__device__ void hpass_long(const uint8_t* __restrict__ a, uint8_t* __restrict__ hb, int S, int y0, int y1, int c0,
                           int c1, int dx0, int L) {
  const int qa = dx0 >> 2, s = (dx0 & 3) * 8, windows = (L + 3) / 4;
  for (Walk it(c1 - c0); it.y < y1 - y0; it.next()) {
    const int off = (y0 + it.y) * S + (c0 + it.c) * 16;
    const uint32_t* wp = reinterpret_cast<const uint32_t*>(a + off) + qa;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t* q = wp + j;
      uint32_t w1 = q[1];
      uint32_t cur = __funnelshift_r(q[0], w1, s);
      uint32_t acc = cur;
      for (int m = 0; m < windows; ++m) {
        const uint32_t w2 = q[m + 2];
        const uint32_t nxt = __funnelshift_r(w1, w2, s);
        const int left = L - 4 * m;
        const uint32_t v1 = left > 1 ? __funnelshift_r(cur, nxt, 8) : cur;
        const uint32_t v2 = left > 2 ? __funnelshift_r(cur, nxt, 16) : cur;
        const uint32_t v3 = left > 3 ? __funnelshift_r(cur, nxt, 24) : cur;
        acc = op3<kMax>(acc, cur, v1);
        acc = op3<kMax>(acc, v2, v3);
        w1 = w2;
        cur = nxt;
      }
      r[j] = acc;
    }
    *reinterpret_cast<uint4*>(hb + off) = make_uint4(r[0], r[1], r[2], r[3]);
  }
}

template <bool kMax>
__device__ void hpass(const uint8_t* a, uint8_t* hb, int S, int y0, int y1, int c0, int c1, int dx0, int L) {
  switch (L) {
    case 1: hpass_fast<1, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 2: hpass_fast<2, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 3: hpass_fast<3, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 4: hpass_fast<4, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 5: hpass_fast<5, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 6: hpass_fast<6, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 7: hpass_fast<7, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 8: hpass_fast<8, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    case 9: hpass_fast<9, kMax>(a, hb, S, y0, y1, c0, c1, dx0); break;
    default: hpass_long<kMax>(a, hb, S, y0, y1, c0, c1, dx0, L);
  }
  static_assert(kFastRun == 9, "hpass unrolls runs of 1 to kFastRun pixels");
}

// V pass: d = op over the group's rows dy of hb[y + dy] on rows [y0, y1) and
// chunks [c0, c1), folded into d unless it is the step's first group.
template <bool kMax>
__device__ void vpass(const uint8_t* __restrict__ hb, uint8_t* __restrict__ d, int S, int y0, int y1, int c0, int c1,
                      const short* dys, int n, bool first) {
  for (Walk it(c1 - c0); it.y < y1 - y0; it.next()) {
    const int off = (y0 + it.y) * S + (c0 + it.c) * 16;
    const uint8_t* base = hb + off;
    uint4 acc = *reinterpret_cast<const uint4*>(base + dys[0] * S);
    int i = 1;
    for (; i + 1 < n; i += 2)
      acc = op3v<kMax>(acc, *reinterpret_cast<const uint4*>(base + dys[i] * S),
                       *reinterpret_cast<const uint4*>(base + dys[i + 1] * S));
    if (i < n) acc = op2v<kMax>(acc, *reinterpret_cast<const uint4*>(base + dys[i] * S));
    uint4* out = reinterpret_cast<uint4*>(d + off);
    if (!first) acc = op2v<kMax>(acc, *out);
    *out = acc;
  }
}

// Set every cell of `rows` region rows outside the image to `pad` (rim tiles only).
__device__ void rim_fill(uint8_t* a, int S, int rows, int nc, int gy0, int gx0, int h, int w, uint8_t pad) {
  const uint32_t fill = pad * 0x01010101u;
  for (Walk it(nc); it.y < rows; it.next()) {
    const int gy = gy0 + it.y, gx = gx0 + 16 * it.c;
    if (gy >= 0 && gy < h && gx >= 0 && gx + 16 <= w) continue;
    uint8_t* q = a + it.y * S + 16 * it.c;
    if (gy < 0 || gy >= h || gx >= w || gx + 16 <= 0) {
      *reinterpret_cast<uint4*>(q) = make_uint4(fill, fill, fill, fill);
      continue;
    }
    for (int i = 0; i < 16; ++i)
      if (gx + i < 0 || gx + i >= w) q[i] = pad;
  }
}

// The region of a tile, 16-byte cp.async a chunk (zero filled outside the image).
__device__ void load_async(const uint8_t* plane, uint8_t* a, int S, int rh, int nc, int gy0, int gx0, int h, int w) {
  for (Walk it(nc); it.y < rh; it.next()) {
    const int gy = gy0 + it.y, gx = gx0 + 16 * it.c;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const uint8_t* src = inside ? plane + (long)gy * w + gx : plane;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(a + it.y * S + 16 * it.c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(inside ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The region of a tile byte by byte (rows not 16-byte aligned); cells
// outside the image keep what they held.
__device__ void load_bytes(const uint8_t* __restrict__ plane, uint8_t* a, int S, int rh, int rw, int gy0, int gx0,
                           int h, int w) {
  for (Walk it(rw); it.y < rh; it.next()) {
    const int gy = gy0 + it.y, gx = gx0 + it.c;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) a[it.y * S + it.c] = __ldg(plane + (long)gy * w + gx);
  }
}

struct Tile {
  long plane;
  int gy, gx;  // the tile's first output pixel
};

__device__ __forceinline__ Tile tile_at(const Program& p, int t) {
  const int tx = t % p.tiles_x, rest = t / p.tiles_x;
  const int ty = rest % p.tiles_y, img = rest / p.tiles_y;
  return {(long)img * p.h * p.w, ty * p.th, tx * p.tw};
}

// The run's window at pixel offset D from a word, as the even-pixel and
// odd-pixel u16 pairs: from the pairs of the word (ec, oc) and of the words
// before (el, ol) and after (er, orr) it.
template <int D>
__device__ __forceinline__ void window(uint32_t el, uint32_t ol, uint32_t ec, uint32_t oc, uint32_t er, uint32_t orr,
                                       uint32_t& e, uint32_t& o) {
  static_assert(D >= -2 && D <= 2, "a window reaches one word on each side");
  if (D == -2) e = __funnelshift_r(el, ec, 16), o = __funnelshift_r(ol, oc, 16);
  if (D == -1) e = __funnelshift_r(ol, oc, 16), o = ec;
  if (D == 0) e = ec, o = oc;
  if (D == 1) e = oc, o = __funnelshift_r(ec, er, 16);
  if (D == 2) e = __funnelshift_r(ec, er, 16), o = __funnelshift_r(oc, orr, 16);
}

template <bool kMax>
__device__ __forceinline__ uint32_t lanes3(uint32_t a, uint32_t b, uint32_t c) {
  return kMax ? __vimax3_u16x2(a, b, c) : __vimin3_u16x2(a, b, c);
}

// op over n u16-pair words.
template <int N, bool kMax>
__device__ __forceinline__ uint32_t lanes_all(const uint32_t* v) {
  uint32_t acc = v[0];
#pragma unroll
  for (int i = 1; i < N; i += 2) acc = lanes3<kMax>(acc, v[i], v[i + 1 < N ? i + 1 : i]);
  return acc;
}

// A rect step of side K (run [-K/2, (K-1)/2] over the same rows) without
// the H plane: a thread owns two word columns of the window and a
// segment of its rows, walks down them, widens each word it loads to u16
// pairs once, keeps the last K rows of the run's min/max in registers (the
// slot of a row is its index mod K, so nothing moves) and writes each output
// row's words once.
template <int K, bool kMax>
__device__ void roll_step(const uint8_t* __restrict__ a, uint8_t* __restrict__ d, int S, int y0, int y1, int w0,
                          int w1) {
  constexpr int kLo = -(K / 2), kHi = (K - 1) / 2, W = kRollWords;  // the run and the rows: [kLo, kHi]
  const int ng = (w1 - w0) / W, rows = y1 - y0;
  const int segs = ng >= kThreads ? 1 : kThreads / ng, len = (rows + segs - 1) / segs;
  const int stride = S / 4;
  static_assert(W == 2, "a row's words come in one uint2 load");
  for (int u = threadIdx.x; u < segs * ng; u += kThreads) {
    const int seg = u / ng, col = w0 + W * (u - seg * ng);
    const int ya = y0 + seg * len, yb = min(ya + len, y1);
    if (ya >= yb) continue;
    const uint32_t* src = reinterpret_cast<const uint32_t*>(a) + col;
    uint32_t* dst = reinterpret_cast<uint32_t*>(d) + col;
    uint32_t re[K][W], ro[K][W];
    for (int y = ya + kLo; y < yb + kHi; y += K) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int row = y + k;
        if (row < yb + kHi) {
          const uint32_t* q = src + row * stride;
          uint32_t wv[W + 2], ev[W + 2], ov[W + 2];  // the words -1 .. W of the row, and widened
          wv[0] = q[-1];
          wv[W + 1] = q[W];
          const uint2 v = *reinterpret_cast<const uint2*>(q);
          wv[1] = v.x, wv[2] = v.y;
#pragma unroll
          for (int j = 0; j < W + 2; ++j) {
            ev[j] = evens(wv[j]);
            ov[j] = odds(wv[j]);
          }
#pragma unroll
          for (int j = 0; j < W; ++j) {
            uint32_t e[K], o[K];
#pragma unroll
            for (int i = 0; i < K; ++i) {
              const uint32_t el = ev[j], ol = ov[j], ec = ev[j + 1], oc = ov[j + 1], er = ev[j + 2], orr = ov[j + 2];
              if (kLo + i == -2) window<-2>(el, ol, ec, oc, er, orr, e[i], o[i]);
              if (kLo + i == -1) window<-1>(el, ol, ec, oc, er, orr, e[i], o[i]);
              if (kLo + i == 0) window<0>(el, ol, ec, oc, er, orr, e[i], o[i]);
              if (kLo + i == 1) window<1>(el, ol, ec, oc, er, orr, e[i], o[i]);
              if (kLo + i == 2) window<2>(el, ol, ec, oc, er, orr, e[i], o[i]);
            }
            re[k][j] = lanes_all<K, kMax>(e);
            ro[k][j] = lanes_all<K, kMax>(o);
          }
          if (row - kHi >= ya) {
            uint32_t out[W];
#pragma unroll
            for (int j = 0; j < W; ++j) {
              uint32_t e[K], o[K];
#pragma unroll
              for (int i = 0; i < K; ++i) e[i] = re[i][j], o[i] = ro[i][j];
              out[j] = __byte_perm(lanes_all<K, kMax>(e), lanes_all<K, kMax>(o), kInterleave);
            }
            *reinterpret_cast<uint2*>(dst + (row - kHi) * stride) = make_uint2(out[0], out[1]);
          }
        }
      }
    }
  }
}

template <bool kMax>
__device__ void run_step(const Program& p, const Step& st, const uint8_t* a, uint8_t* d, uint8_t* hb, int m) {
  const int S = p.stride, rh = p.th + 2 * p.halo, rw = p.tw + 2 * p.hx;
  const int c0 = (p.hx - p.halo + m) >> 4, c1 = (rw - p.hx + p.halo - m + 15) >> 4;
  if (st.square) {
    switch (st.square) {
      case 2: roll_step<2, kMax>(a, d, S, m, rh - m, 4 * c0, 4 * c1); break;
      case 3: roll_step<3, kMax>(a, d, S, m, rh - m, 4 * c0, 4 * c1); break;
      case 4: roll_step<4, kMax>(a, d, S, m, rh - m, 4 * c0, 4 * c1); break;
      default: roll_step<5, kMax>(a, d, S, m, rh - m, 4 * c0, 4 * c1);
    }
    __syncthreads();
    return;
  }
  for (int g = 0; g < st.n; ++g) {
    const Group& gr = p.group[st.first + g];
    const uint8_t* src = a;
    if (gr.dx0 != 0 || gr.dx1 != 0) {
      hpass<kMax>(a, hb, S, m + gr.dy_min, rh - m + gr.dy_max, c0, c1, gr.dx0, gr.dx1 - gr.dx0 + 1);
      __syncthreads();
      src = hb;
    }
    vpass<kMax>(src, d, S, m, rh - m, c0, c1, p.dy + gr.first, gr.n, g == 0);
    __syncthreads();
  }
}

// Grid: persistent CTAs over the k * tiles_y * tiles_x tiles.  Shared memory:
// one or two load buffers of rh rows, the odd steps' buffer of rh - 2 r1 rows
// (the window after the first step), the H plane of h_rows rows (from the
// rows the first step with an H pass reaches; no later step reaches beyond
// them; none where every step is a [0, 0] run or rolls its rows); every
// row S bytes, its cells from byte kSlack.
__global__ void __launch_bounds__(kThreads, 1)
    morph_runs(const uint8_t* __restrict__ in, uint8_t* __restrict__ out, const __grid_constant__ Program p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int S = p.stride, rh = p.th + 2 * p.halo, rw = p.tw + 2 * p.hx, nc = rw / 16;
  const int r1 = p.step[0].radius;
  uint8_t* const ibuf = smem + kSlack;  // load buffer `par` at ibuf + par * next_buf
  const int next_buf = p.prefetch ? rh * S : 0;
  uint8_t* dbuf = smem + kSlack + (p.prefetch ? 2 : 1) * rh * S - r1 * S;  // addressed by region row
  uint8_t* hbuf = dbuf + r1 * S + (rh - 2 * r1) * S - p.h_first * S;
  int par = 0;
  if (p.aligned && p.prefetch && (int)blockIdx.x < p.n_tiles) {
    const Tile t = tile_at(p, blockIdx.x);
    load_async(in + t.plane, ibuf, S, rh, nc, t.gy - p.halo, t.gx - p.hx, p.h, p.w);
  }
  for (int t = blockIdx.x; t < p.n_tiles; t += gridDim.x) {
    const Tile tile = tile_at(p, t);
    const int gy0 = tile.gy - p.halo, gx0 = tile.gx - p.hx;
    uint8_t* a = ibuf + par * next_buf;
    if (p.aligned) {
      const int next = t + gridDim.x;
      if (!p.prefetch) {
        load_async(in + tile.plane, a, S, rh, nc, gy0, gx0, p.h, p.w);
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      } else if (next < p.n_tiles) {
        const Tile n = tile_at(p, next);
        load_async(in + n.plane, ibuf + (par ^ 1) * next_buf, S, rh, nc, n.gy - p.halo, n.gx - p.hx, p.h, p.w);
        asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      }
    } else {
      load_bytes(in + tile.plane, a, S, rh, rw, gy0, gx0, p.h, p.w);
    }
    __syncthreads();
    const bool rim = gy0 < 0 || gx0 < 0 || gy0 + rh > p.h || gx0 + rw > p.w;
    uint8_t* d = dbuf;
    int m = 0;
    for (int s = 0; s < p.n_steps; ++s) {
      const Step& st = p.step[s];
      if (rim) {  // the rows this step reads: the odd steps' buffer holds no more
        rim_fill(a + m * S, S, rh - 2 * m, nc, gy0 + m, gx0, p.h, p.w, st.is_max ? 0 : 255);
        __syncthreads();
      }
      m += st.radius;
      if (st.is_max) run_step<true>(p, st, a, d, hbuf, m);
      else run_step<false>(p, st, a, d, hbuf, m);
      uint8_t* tmp = a;
      a = d;
      d = tmp;
    }
    uint8_t* o = out + tile.plane;
    if (p.aligned) {
      for (Walk it(p.tw / 16); it.y < p.th; it.next()) {
        const int gy = tile.gy + it.y, gx = tile.gx + 16 * it.c;
        if (gy < p.h && gx < p.w)
          *reinterpret_cast<uint4*>(o + (long)gy * p.w + gx) =
              *reinterpret_cast<const uint4*>(a + (p.halo + it.y) * S + p.hx + 16 * it.c);
      }
    } else {
      for (Walk it(p.tw); it.y < p.th; it.next()) {
        const int gy = tile.gy + it.y, gx = tile.gx + it.c;
        if (gy < p.h && gx < p.w) o[(long)gy * p.w + gx] = a[(p.halo + it.y) * S + p.hx + it.c];
      }
    }
    __syncthreads();  // the buffers are read before the next tile's loads and steps
    if (p.prefetch) par ^= 1;
  }
}

}  // namespace

extern "C" {

// The steps of `table` on the k images (h, w) of `in` into `out`, on tiles of
// th x tw pixels (tw a multiple of 16) with a halo of `halo` rows (the sum of
// the steps' radii).  table: n_steps, then per step is_max, radius, n_groups
// and per group dx0, dx1, n_dy and its n_dy row offsets.  aligned: rows are
// 16-byte aligned in both tensors (w % 16 == 0); prefetch: a second load
// buffer.  Returns a CUDA error code (0 on success).
int pw_morph_dense_run(const uint8_t* in, uint8_t* out, const int* table, int n_table, int k, int h, int w, int th,
                       int tw, int halo, int prefetch, int aligned, void* stream) {
  if (k <= 0 || h <= 0 || w <= 0 || th <= 0 || tw <= 0 || tw % 16 || halo < 0 || n_table < 1)
    return (int)cudaErrorInvalidValue;
  Program p{};  // the parameter block (the launch copies it)
  int at = 0, groups = 0, dys = 0, radii = 0;
  p.n_steps = table[at++];
  if (p.n_steps < 1 || p.n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p.n_steps; ++s) {
    if (at + 3 > n_table) return (int)cudaErrorInvalidValue;
    Step& st = p.step[s];
    st.is_max = (short)(table[at] != 0);
    st.radius = (short)table[at + 1];
    st.n = (short)table[at + 2];
    st.first = (short)groups;
    at += 3;
    radii += st.radius;
    if (st.radius < 0 || st.n < 1 || groups + st.n > kMaxGroups) return (int)cudaErrorInvalidValue;
    for (int g = 0; g < st.n; ++g, ++groups) {
      if (at + 3 > n_table) return (int)cudaErrorInvalidValue;
      Group& gr = p.group[groups];
      gr.dx0 = (short)table[at];
      gr.dx1 = (short)table[at + 1];
      gr.n = (short)table[at + 2];
      gr.first = (short)dys;
      at += 3;
      if (gr.n < 1 || dys + gr.n > kMaxDys || at + gr.n > n_table || gr.dx1 < gr.dx0 ||
          -gr.dx0 > st.radius || gr.dx1 > st.radius)
        return (int)cudaErrorInvalidValue;
      gr.dy_min = gr.dy_max = (short)table[at];
      for (int i = 0; i < gr.n; ++i, ++dys) {
        const int dy = table[at + i];
        if (dy < -st.radius || dy > st.radius) return (int)cudaErrorInvalidValue;
        p.dy[dys] = (short)dy;
        if (dy < gr.dy_min) gr.dy_min = (short)dy;
        if (dy > gr.dy_max) gr.dy_max = (short)dy;
      }
      at += gr.n;
    }
  }
  if (radii != halo || at != n_table) return (int)cudaErrorInvalidValue;
  for (int s = 0; s < p.n_steps; ++s) {  // a rect of side 2 to 5: one run [-K/2, (K-1)/2] on the same rows
    Step& st = p.step[s];
    const Group& gr = p.group[st.first];
    const int side = gr.dx1 - gr.dx0 + 1;
    bool square = st.n == 1 && side >= 2 && side <= 5 && gr.dx0 == -(side / 2) && gr.n == side;
    for (int i = 0; square && i < gr.n; ++i) square = p.dy[gr.first + i] == gr.dx0 + i;
    st.square = (short)(square ? side : 0);
  }
  const int rh = th + 2 * halo;
  p.h_first = p.h_rows = 0;
  for (int s = 0, m = 0; s < p.n_steps && !p.h_rows; ++s) {  // the first step with an H pass
    const Step& st = p.step[s];
    m += st.radius;
    if (st.square) continue;
    int reach = -1;
    for (int g = st.first; g < st.first + st.n; ++g) {
      const Group& gr = p.group[g];
      if (gr.dx0 == 0 && gr.dx1 == 0) continue;
      if (reach < -gr.dy_min) reach = -gr.dy_min;
      if (reach < gr.dy_max) reach = gr.dy_max;
    }
    if (reach >= 0) {
      p.h_first = m - reach;
      p.h_rows = rh - 2 * p.h_first;
    }
  }

  p.halo = halo;
  p.hx = (halo + 15) & ~15;
  p.th = th;
  p.tw = tw;
  p.h = h;
  p.w = w;
  p.tiles_x = (w + tw - 1) / tw;
  p.tiles_y = (h + th - 1) / th;
  const long tiles = (long)k * p.tiles_x * p.tiles_y;
  if (tiles >= (1L << 31)) return (int)cudaErrorInvalidValue;
  p.n_tiles = (int)tiles;
  p.stride = tw + 2 * p.hx + 2 * kSlack;
  p.aligned = aligned ? 1 : 0;
  p.prefetch = (aligned && prefetch) ? 1 : 0;
  const long smem = (long)p.stride * (rh * (p.prefetch ? 2L : 1L) + (rh - 2L * p.step[0].radius) + p.h_rows);
  if (smem > (1L << 30)) return (int)cudaErrorInvalidValue;
  // per device, the largest shared memory set on the kernel and the last occupancy asked (host time a call)
  static long attr_smem[kMaxDevices], fit_smem[kMaxDevices];
  static int fit_grid[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > attr_smem[dev]) {
    err = cudaFuncSetAttribute(morph_runs, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    attr_smem[dev] = smem;
  }
  if (smem != fit_smem[dev]) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, morph_runs, kThreads, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1 || sms < 1) return (int)cudaErrorInvalidConfiguration;
    fit_grid[dev] = per_sm * sms;
    fit_smem[dev] = smem;
  }
  const int per_card = fit_grid[dev];
  const int grid = p.n_tiles < per_card ? p.n_tiles : per_card;
  morph_runs<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(in, out, p);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
