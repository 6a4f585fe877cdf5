// K13 pw_area_resize_frac / pw_area_resize_int: the INTER_AREA downscale of
// a uint8 image, (H, W, C) -> (h, w, C), C = 1 to 4, for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA programs of plotweave/ops/resize.py: _area_resize_frac
// (with its tap table _resize_area_tab and the chunked passes) and
// _area_resize_int.  Both match the JAX functions bit for bit, and through
// them cv2.resize(..., INTER_AREA).
//
// Fractional ratios (pw_area_resize_frac, kernel area_frac_bands).  The tap
// tables (per destination column and row, the source indices and float32
// alphas of cv2's computeResizeAreaTab, padded to the longest with index 0
// and alpha 0) come from the host (plotweave_torch/ops/resize.py::
// _resize_area_tab).  A row's real taps are its taps of alpha > 0: a prefix
// of the row, on consecutive source indices (tests/test_torch_resize.py holds
// the tables to that).  The JAX package's order of float32 operations
// (resize.py:65-96, _frac_hprod, _frac_hsum_vprod, _frac_vsum): the
// horizontal sum of a (source row, output column), sum x * xal in table
// order with every product rounded before its add; then per output pixel
// sum hb * yal in table order; round half to even (rintf), clip to 0..255.
// Nothing may be contracted into an FMA: the file is compiled with
// --fmad=false and the sums use __fmul_rn / __fadd_rn besides (a contracted
// multiply-add flips half-even ties).  A padded tap adds x * 0 = +0 to a sum
// of terms >= 0, which changes no bit, so the kernel skips it; a sum starts
// from an exact 0, and 0 + p = p.
//
// Design.  The output is cut into items, a band of output rows by a tile of
// output columns, one thread a column (ops/kernels.py::area_frac_schedule
// picks them, fitting the items to the CTAs the card holds at once, and the
// CPU tests emulate that schedule); the CTAs take the items in turn.  An
// item walks the source rows its band's taps name, in increasing order, in
// groups staged in shared memory, double-buffered (the next group in flight
// while this one is summed): each row's 16-byte aligned cover of the tile's
// source span by one bulk copy (the copy engine's 1D mode, completing on an
// mbarrier; TMA's tensor mode does not fit, a row of w * C bytes is not
// 16-byte aligned at every width), and the covers that leave the tensor (the
// image's first and last rows) byte by byte.  For each staged source row each
// thread forms its column's horizontal sums once, every channel in
// registers: where no column has more than 4 real taps its bytes come as
// aligned words from shared memory, realigned by funnel shifts, each byte
// converted exactly by a byte permute into 2^23 + b less 2^23 (the bits of
// (float)b, without the quarter-rate I2F), two source rows a step; else byte
// by byte.  Then it multiplies the sum by the row's alpha
// and adds it into the sums of the output rows whose taps hold the row, in
// their tap order.  On a downscale (the pair route) at most two output rows
// are open at once, their sums in registers (the lower row, and the one that
// starts where it ends), and the item's source rows carry at most two (row,
// alpha) events each, staged in shared memory;
// otherwise (an upscale) the open rows are searched at each source row and
// their sums kept in a ring in shared memory, each thread its own column's.
// A closed row is rounded into a staged output row, and the band's rows are
// stored at the end with 16-byte stores (their first and last partial
// vectors byte by byte, since neighbouring tiles own the other bytes).  A
// source row at a band's edge is summed by both bands, in the same order, so
// the bits agree.  Any ratio: the span is streamed, so a table of 84 taps
// (8000 -> 97) needs no route of its own; a wide ratio narrows the tile and
// the group until the stage fits.
//
// Bound.  Bytes bind it: each input byte read once, each output byte written
// once (a 4032 x 3024 x 3 photo to 2000 x 1500 reads 36.6 MB and writes
// 9.0 MB, 13.6 us at 3.35 TB/s).  The work is one product and add per real
// horizontal tap of each (source row, output column, channel) and one per
// real vertical tap of each output value: about 3024 x 2000 x 3.008 x 3 =
// 55 M products there, against 144 M for one thread an output pixel, which
// recomputes a source row's sums for each output row that takes it.  On an
// H100 the sums, not the bytes, set its time: a build that left out the
// copies took most of its time, one that left out the sums about two thirds
// (PERF.md).
// Built with -DPW_RESIZE_PHASES, thread 0 of three CTAs records its clock64
// cycles by phase, and every CTA its start and end (pw_resize_phases).
//
// Integer ratios (pw_area_resize_int).  One thread per output pixel sums its
// sy x sx block, each channel in an int: the 2 x 2 case is (sum + 2) >> 2,
// every other ratio rintf(sum / area) in float32: the sum converted to
// float32 (rounded to nearest even, as XLA's int32 -> float32), a correctly
// rounded division (the JAX package writes float64, but it never enables
// x64, so that is float32).  Bytes bind it as they bind the fractional route.
// One thread takes one output pixel, all its channels in registers (the
// kernels are instantiated for C = 1 to 4), and the indices are 32-bit (the
// wrapper keeps every tensor below 2^31 elements); neighbouring threads take
// neighbouring output pixels of one row, so their loads fall on neighbouring
// source bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // the integer route's threads a block
constexpr int kMaxTile = 256;      // the fractional route's widest tile: its threads a CTA
constexpr int kMaxSmem = 232448;   // 227 KB, the opt-in limit of one CTA

__device__ __forceinline__ uint8_t clip_u8(float v) { return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f); }

// (float)b of a byte, exactly: 2^23 + b has b in its low mantissa bits
__device__ __forceinline__ float byte_float(uint32_t b) {
  return __fsub_rn(__int_as_float(0x4B000000u | b), 8388608.0f);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// One bulk copy (the copy engine's 1D mode) of `size` bytes, a multiple of 16,
// between 16-byte aligned addresses, completing its bytes on the mbarrier
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned size, unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
               "l"(src), "r"(size), "r"(bar)
               : "memory");
}

// the one arrival a phase of the mbarrier expects, with the bytes its copies bring
__device__ __forceinline__ void expect_bytes(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` of the mbarrier has completed
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// The fractional route's launch: the tables, the shapes and the schedule
// (ops/kernels.py::area_frac_schedule), with the byte offsets of the parts
// of its dynamic shared memory.
struct FracArgs {
  const uint8_t* src;
  uint8_t* dst;
  const int* xsi;
  const float* xal;
  const int* ysi;
  const float* yal;
  int th, tv, h, w, nh, nw;
  int band_rows, tile, group, pitch, out_pitch, slots, events, bands, tiles;
  int stage_off, out_off, acc_off, ev_off, rows_off;
};

// An event's code (the pair route): the band row's staged output row in
// out_s (bits 0-15) and whether the source row is the row's last tap; -1:
// no row (its alpha then 0).
constexpr int kLast = 1 << 16;

#ifdef PW_RESIZE_PHASES
// Thread 0 of CTA 0, of the middle CTA and of the last, over all its items:
// the cycles of the set-up (tables, spans, events, the first group issued),
// of issuing the later groups, of waiting for each group, of the sums, and of
// the store; the total; the groups; the items.
__device__ unsigned long long resize_cycles[3][8];
// Every CTA's thread 0 (the first kTimedCtas CTAs): %globaltimer (ns) at its
// start and at its end, which date the CTAs against each other and turn the
// cycles into time.
constexpr int kTimedCtas = 4096;
__device__ unsigned long long resize_ns[kTimedCtas][2];
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PW_RESIZE_MARK(slot)                            \
  if (clock_on) {                                       \
    const unsigned long long now = clock64();           \
    cycles[slot] += now - stamp;                        \
    stamp = now;                                        \
  }
#else
#define PW_RESIZE_MARK(slot)
#endif

// Stage source rows [r0, r1) into buf, row j at buf + j * pitch: the
// 16-byte aligned cover of the tile's `span` bytes from the boundary below
// its first (sx_lo * C), by one bulk copy a row (the lanes of warp 0, a row
// each), whose bytes complete on `bar` with warp 0's one arrival.  Only the
// image's first and last rows may have a cover that leaves the tensor: those
// are copied byte by byte by every thread (the bytes outside are never read).
template <int C>
__device__ __forceinline__ void stage_rows(const FracArgs& a, uint8_t* buf, int r0, int r1, int sx_lo, int span,
                                           const uint8_t* end, unsigned bar) {
  const size_t wc = (size_t)a.w * C;
  const uint8_t* row0 = a.src + (size_t)r0 * wc + (size_t)sx_lo * C;
  const bool edge = r0 == 0 || r1 == a.h;
  if (threadIdx.x < 32) {
    unsigned bytes = 0;
    if (span > 0) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the generic writes to the buffer
      for (int j = threadIdx.x; j < r1 - r0; j += 32) {
        const uint8_t* first = row0 + j * wc;
        const int mis = (int)((uintptr_t)first & 15);
        const unsigned size = 16u * (unsigned)((mis + span + 15) >> 4);
        const uint8_t* g0 = first - mis;
        if (!edge || (g0 >= a.src && g0 + size <= end)) {
          bulk_copy(smem_u32(buf + j * a.pitch), g0, size, bar);
          bytes += size;
        }
      }
    }
    bytes = __reduce_add_sync(0xffffffffu, bytes);
    if (threadIdx.x == 0) expect_bytes(bar, bytes);
  }
  if (edge && span > 0) {
    for (int j = 0; j < r1 - r0; ++j) {
      const uint8_t* first = row0 + j * wc;
      const int mis = (int)((uintptr_t)first & 15);
      const int size = 16 * ((mis + span + 15) >> 4);
      const uint8_t* g0 = first - mis;
      if (g0 >= a.src && g0 + size <= end) continue;
      for (int b = threadIdx.x; b < size; b += blockDim.x)
        if (g0 + b >= a.src && g0 + b < end) buf[j * a.pitch + b] = g0[b];
    }
  }
}

// The count of a table row's real taps (a prefix of alpha > 0); its first
// eight alphas, loaded at once, are left in `first8` (0 past the row).
__device__ __forceinline__ int real_taps(const float* al, int taps, float (&first8)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) first8[i] = i < taps ? __ldg(al + i) : 0.0f;
  int n = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) n += first8[i] > 0.0f;
  if (n < 8 || taps == 8) return n;
  while (n < taps && __ldg(al + n) > 0.0f) ++n;
  return n;
}

// (float)b of the byte of w that `sel` (0-3) picks: 2^23 + b has b in its low
// mantissa bits, so one byte permute and a subtract
__device__ __forceinline__ float word_byte(uint32_t w, int sel) {
  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | (unsigned)sel)), 8388608.0f);
}

__device__ __forceinline__ uint32_t lds32(unsigned addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr));
  return v;
}

// A column's horizontal sums of one staged source row, for a table of at most
// KH taps a column (KH <= 4, so at most 16 bytes): the column's bytes from
// the shared address p as aligned words, realigned by funnel shifts; the taps
// in order, each product rounded before its add; the alphas past the
// column's real taps are 0 and add +0 (exact: every term is >= 0, and every
// staged byte is finite).  Straight-line code, so that two rows' sums
// interleave.
template <int C, int KH>
__device__ __forceinline__ void hsums_words(unsigned p, const float (&xa)[KH], float (&hs)[C]) {
  constexpr int kWords = (KH * C + 3) / 4 + 1;
  const unsigned wp = p & ~3u, sh = 8u * (p & 3u);
  uint32_t wv[kWords], u[kWords - 1];
#pragma unroll
  for (int i = 0; i < kWords; ++i) wv[i] = lds32(wp + 4 * i);
#pragma unroll
  for (int i = 0; i < kWords - 1; ++i) u[i] = __funnelshift_r(wv[i], wv[i + 1], sh);
#pragma unroll
  for (int t = 0; t < KH; ++t) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = t * C + c;
      const float prod = __fmul_rn(word_byte(u[j >> 2], j & 3), xa[t]);
      hs[c] = t == 0 ? prod : __fadd_rn(hs[c], prod);
    }
  }
}

// The same for any number of taps (KH = 0: a table wider than 4 taps, or an
// upscale): byte by byte over the column's nx real taps, alphas read from L1.
template <int C>
__device__ __forceinline__ void hsums_bytes(const uint8_t* p, const float* xal_col, int nx, float (&hs)[C]) {
#pragma unroll
  for (int c = 0; c < C; ++c) hs[c] = 0.0f;
  for (int t = 0; t < nx; ++t) {
    const float al = __ldg(xal_col + t);
#pragma unroll
    for (int c = 0; c < C; ++c) hs[c] = __fadd_rn(hs[c], __fmul_rn(byte_float(p[t * C + c]), al));
  }
}

// The ring's route: one open output row's sums; the first tap sets them, the
// others add, in tap order (the caller walks the source rows upwards).
template <int C>
__device__ __forceinline__ void accumulate(float (&acc)[C], const float (&hs)[C], float al, bool first) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float p = __fmul_rn(hs[c], al);
    acc[c] = first ? p : __fadd_rn(acc[c], p);
  }
}

// rintf, then the clip to 0..255: a value clipped to [0, 255] plus 2^23 is
// rounded half to even to an integer, its byte in the low mantissa bits
template <int C>
__device__ __forceinline__ void close_row(uint8_t* row, bool own, const float (&acc)[C]) {
  if (own) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      row[c] = (uint8_t)__float_as_uint(__fadd_rn(fminf(fmaxf(acc[c], 0.0f), 255.0f), 8388608.0f));
  }
}

// One source row's events on the pair route: `cur`, the lower open output
// row, takes the sums times the first event's alpha, `next`, the row that
// starts at this source row while `cur` ends there, times the second's (an
// alpha of 0 where there is no such row adds +0: exact, the sums are >= 0).
// Where `cur` ends it is rounded into its staged output row and `next`
// becomes `cur`, a new `next` starting from an exact 0 (0 + p is p); where
// that row ends too (a row of one tap), it is stored as well.  The codes are
// the same for every thread, so the branches are uniform.
template <int C>
__device__ __forceinline__ void pair_step(const int4 ev, const float (&hs)[C], float (&cur)[C], float (&next)[C],
                                          uint8_t* out_col, bool own) {
  const float a0 = __int_as_float(ev.x), a1 = __int_as_float(ev.y);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    cur[c] = __fadd_rn(cur[c], __fmul_rn(hs[c], a0));
    next[c] = __fadd_rn(next[c], __fmul_rn(hs[c], a1));
  }
  if (ev.z >= 0 && (ev.z & kLast)) {
    close_row<C>(out_col + (ev.z & 0xffff), own, cur);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      cur[c] = next[c];
      next[c] = 0.0f;
    }
    if (ev.w >= 0 && (ev.w & kLast)) {
      close_row<C>(out_col + (ev.w & 0xffff), own, cur);
#pragma unroll
      for (int c = 0; c < C; ++c) cur[c] = 0.0f;
    }
  }
}

// The CTAs stride over the (band, tile) items.  KH: the table's widest
// column in taps (1 to 4: read as words; 0: byte by byte).  kPair: every
// output row and column has a tap, and a row shares at most its first source
// row with the row before it, so the item's bounds come from its first and
// last row and column, at most two rows are open at once, their sums in
// registers (the lower one and the one that starts where it ends), and a
// band's source row takes at most two (row, alpha) events, staged in shared
// memory; else (an upscale, or a span too tall for the events) the bounds
// are found by atomics, the rows that may be open are searched at each
// source row and their sums kept in a ring of a.slots rows in shared memory,
// [slot][channel][thread].
template <int C, int KH, bool kPair>
__global__ void __launch_bounds__(kMaxTile) area_frac_bands(const FracArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* stage = smem + a.stage_off;
  uint8_t* out_s = smem + a.out_off;
  float* ring = reinterpret_cast<float*>(smem + a.acc_off);
  int4* ev_s = reinterpret_cast<int4*>(smem + a.ev_off);  // per source row: two alphas' bits, two codes
  int4* rows_s = reinterpret_cast<int4*>(smem + a.rows_off);  // per band row: first and last source row,
                                                              // its alphas' index less its first row, its stage
  int* bounds = reinterpret_cast<int*>(rows_s + a.band_rows);  // the band's source rows, the tile's columns
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(bounds + 4);  // a stage's copies, each
  const int tid = threadIdx.x;
  const uint8_t* end = a.src + (size_t)a.h * a.w * C;
  if (tid == 0)
    for (int b = 0; b < 2; ++b)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bars[b])) : "memory");
  unsigned phases = 0;  // bit b: the parity of the next phase of stage b's mbarrier to wait for
#ifdef PW_RESIZE_PHASES
  const int clock_slot = blockIdx.x == 0 ? 0 : blockIdx.x == gridDim.x / 2 ? 1 : blockIdx.x == gridDim.x - 1 ? 2 : -1;
  const bool clock_on = clock_slot >= 0 && tid == 0;
  const unsigned long long ns0 = global_ns();
  unsigned long long cycles[6] = {0, 0, 0, 0, 0, 0}, stamp = clock64(), n_groups_all = 0, n_items = 0;
  const unsigned long long t0 = stamp;
#endif
  for (int item = blockIdx.x; item < a.bands * a.tiles; item += gridDim.x) {
    const int band = item / a.tiles, tile = item - band * a.tiles;
    const int oy0 = band * a.band_rows, ox0 = tile * a.tile;
    const int rows = min(a.band_rows, a.nh - oy0), cols = min(a.tile, a.nw - ox0);
    __syncthreads();  // the previous item's store has read out_s
    const bool own = tid < cols;
    const int col = ox0 + tid;
    const float* xal_col = a.xal + (size_t)(own ? col : 0) * a.th;
    int fx = -1, nx = 0, lo, hi, sx_lo, span;
    float xa8[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if constexpr (kPair) {
      // every row and column has taps, in increasing order: the band's source
      // rows and the tile's from the tables' ends, one round trip, and the
      // first group's copies in flight while the rest is set up
      if (tid < 2) {  // thread 0 the rows, thread 1 the columns
        const int taps = tid == 0 ? a.tv : a.th;
        const int* si = tid == 0 ? a.ysi : a.xsi;
        const float* al = tid == 0 ? a.yal : a.xal;
        const size_t first = (size_t)(tid == 0 ? oy0 : ox0) * taps;
        const size_t last = (size_t)(tid == 0 ? oy0 + rows - 1 : ox0 + cols - 1) * taps;
        const int s0 = __ldg(si + first), s1 = __ldg(si + last);
        float al8[8];
        const int n = real_taps(al + last, taps, al8);
        bounds[2 * tid] = s0;
        bounds[2 * tid + 1] = s1 + n - 1;
      }
      __syncthreads();
      lo = bounds[0];
      hi = bounds[1];
      sx_lo = bounds[2];
      span = (bounds[3] - sx_lo + 1) * C;
      stage_rows<C>(a, stage, lo, min(lo + a.group, hi + 1), sx_lo, span, end, smem_u32(&bars[0]));
      for (int r = tid; r < rows; r += blockDim.x) {
        const size_t row = (size_t)(oy0 + r) * a.tv;
        const int f = __ldg(a.ysi + row);  // loaded beside the alphas: one round trip
        float al8[8];
        const int n = real_taps(a.yal + row, a.tv, al8);
        const int mis = (int)((uintptr_t)(a.dst + ((size_t)(oy0 + r) * a.nw + ox0) * C) & 15);
        rows_s[r] = make_int4(f, f + n - 1, (int)row - f, r * a.out_pitch + mis);
      }
      if (own) {
        fx = __ldg(a.xsi + (size_t)col * a.th);
        nx = real_taps(xal_col, a.th, xa8);
      }
      for (int j = tid; j < hi - lo + 1; j += blockDim.x) ev_s[j] = make_int4(0, 0, -1, -1);
      __syncthreads();
      // each band row's taps as events of its source rows: the row that starts
      // where the row before it ends takes the second slot
      for (int r = tid; r < rows; r += blockDim.x) {
        const int4 info = rows_s[r];
        const bool second = r > 0 && rows_s[r - 1].y == info.x;
        for (int sy = info.x; sy <= info.y; ++sy) {
          const int code = info.w | (sy == info.y ? kLast : 0);
          const int bits = __float_as_int(__ldg(a.yal + (info.z + sy)));
          int* e = reinterpret_cast<int*>(ev_s + (sy - lo));
          if (second && sy == info.x) {
            e[1] = bits;
            e[3] = code;
          } else {
            e[0] = bits;
            e[2] = code;
          }
        }
      }
    } else {
      // rows or columns of no tap (an upscale): the band's and the tile's
      // bounds by atomics over their taps
      if (tid < 4) bounds[tid] = (tid & 1) ? -1 : 0x7fffffff;
      __syncthreads();
      for (int r = tid; r < a.band_rows; r += blockDim.x) {
        int f = -1, l = -2;  // a row with no tap (or past the image) is never open
        const size_t row = (size_t)(oy0 + r) * a.tv;
        if (r < rows) {
          const int si = __ldg(a.ysi + row);
          float al8[8];
          const int n = real_taps(a.yal + row, a.tv, al8);
          if (n > 0) {
            f = si;
            l = f + n - 1;
            atomicMin(&bounds[0], f);
            atomicMax(&bounds[1], l);
          }
        }
        const int mis = r < rows ? (int)((uintptr_t)(a.dst + ((size_t)(oy0 + r) * a.nw + ox0) * C) & 15) : 0;
        rows_s[r] = make_int4(f, l, (int)row - f, r * a.out_pitch + mis);
      }
      if (own) {
        const int si = __ldg(a.xsi + (size_t)col * a.th);
        nx = real_taps(xal_col, a.th, xa8);
        if (nx > 0) {
          fx = si;
          atomicMin(&bounds[2], fx);
          atomicMax(&bounds[3], fx + nx - 1);
        }
      }
      __syncthreads();
      lo = bounds[0];
      hi = bounds[1];
      const bool any_col = bounds[3] >= 0;
      sx_lo = any_col ? bounds[2] : 0;
      span = any_col ? (bounds[3] - sx_lo + 1) * C : 0;
      if (lo <= hi) stage_rows<C>(a, stage, lo, min(lo + a.group, hi + 1), sx_lo, span, end, smem_u32(&bars[0]));
      for (int r = 0; r < rows; ++r)  // rows with no tap come out 0, as the plain version's sum of zeros
        if (rows_s[r].x < 0)
          for (int i = tid; i < a.out_pitch; i += blockDim.x) out_s[r * a.out_pitch + i] = 0;
    }
    float xa[KH > 0 ? KH : 1];  // the word route's first KH alphas: 0 past the column's real taps
#pragma unroll
    for (int t = 0; t < (KH > 0 ? KH : 1); ++t) xa[t] = xa8[t];
    const int off = (fx < 0 ? 0 : fx - sx_lo) * C;  // a column of no tap reads the span's first bytes, times 0
    const int n_groups = lo <= hi ? (hi - lo + a.group) / a.group : 0;
    // the staged rows' offsets from their 16-byte boundaries: mis0 + (sy - lo) * (w C mod 16), mod 16
    const int mis0 = (int)((uintptr_t)(a.src + ((size_t)lo * a.w + sx_lo) * C) & 15);
    const int step = (int)(((size_t)a.w * C) & 15);
#ifdef PW_RESIZE_PHASES
    n_groups_all += n_groups;
    ++n_items;
#endif
    PW_RESIZE_MARK(0);

    float acc0[C], acc1[C];  // the pair route's cur and next
#pragma unroll
    for (int c = 0; c < C; ++c) acc0[c] = acc1[c] = 0.0f;
    uint8_t* out_col = out_s + tid * C;
    int ra = 0, rb = -1;  // the ring's route: the band rows that may be open
    for (int k = 0; k < n_groups; ++k) {
      const int r0 = lo + k * a.group, r1 = min(r0 + a.group, hi + 1);
      if (k + 1 < n_groups) {
        stage_rows<C>(a, stage + ((k + 1) & 1) * a.group * a.pitch, r1, min(r1 + a.group, hi + 1), sx_lo, span, end,
                      smem_u32(&bars[(k + 1) & 1]));
        PW_RESIZE_MARK(1);
      }
      wait_parity(smem_u32(&bars[k & 1]), (phases >> (k & 1)) & 1u);
      phases ^= 1u << (k & 1);
      __syncthreads();  // and the rows copied byte by byte
      PW_RESIZE_MARK(2);
      const uint8_t* px = stage + (k & 1) * a.group * a.pitch + off;
      unsigned pxs = smem_u32(px);  // the same, as a shared-memory address: the word route's loads
      int mis = (mis0 + (r0 - lo) * step) & 15;
      int sy = r0;
      if constexpr (kPair && KH > 0) {  // two source rows a step: their sums are independent
        for (; sy + 1 < r1; sy += 2, pxs += 2 * a.pitch, mis = (mis + 2 * step) & 15) {
          float ha[C], hb[C];
          hsums_words<C, KH>(pxs + mis, xa, ha);
          hsums_words<C, KH>(pxs + a.pitch + ((mis + step) & 15), xa, hb);
          pair_step<C>(ev_s[sy - lo], ha, acc0, acc1, out_col, own);
          pair_step<C>(ev_s[sy + 1 - lo], hb, acc0, acc1, out_col, own);
        }
        px += (sy - r0) * a.pitch;
      }
      for (; sy < r1; ++sy, px += a.pitch, pxs += a.pitch, mis = (mis + step) & 15) {
        // the horizontal sums of (source row sy, this column), once
        float hs[C];
        if constexpr (KH > 0) {
          hsums_words<C, KH>(pxs + mis, xa, hs);
        } else {
          hsums_bytes<C>(px + mis, xal_col, nx, hs);
        }
        // into the open output rows that take source row sy, in their tap order
        if constexpr (kPair) {
          pair_step<C>(ev_s[sy - lo], hs, acc0, acc1, out_col, own);
        } else {
          while (rb + 1 < rows && rows_s[rb + 1].x <= sy) ++rb;
          while (ra <= rb && rows_s[ra].y < sy) ++ra;
          for (int r = ra; r <= rb; ++r) {
            const int4 info = rows_s[r];
            if (sy < info.x || sy > info.y) continue;
            const float al = __ldg(a.yal + (info.z + sy));
            float* slot = ring + (r % a.slots) * C * (int)blockDim.x + tid;
            float acc[C];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[c] = slot[c * blockDim.x];
            accumulate<C>(acc, hs, al, sy == info.x);
#pragma unroll
            for (int c = 0; c < C; ++c) slot[c * blockDim.x] = acc[c];
            if (sy == info.y) close_row<C>(out_col + info.w, own, acc);
          }
        }
      }
      __syncthreads();  // the buffer is refilled by the next group but one
      PW_RESIZE_MARK(3);
    }
    __syncthreads();  // the rows of no tap, where no group ran
    // the band's rows, a warp a row, each at its alignment to 16 bytes in
    // out_s: whole vectors of own bytes by 16-byte stores, the partial ones at
    // the ends byte by byte
    const int len = cols * C;
    for (int r = tid >> 5; r < rows; r += blockDim.x >> 5) {
      const int mis = rows_s[r].w - r * a.out_pitch;
      uint8_t* d = a.dst + ((size_t)(oy0 + r) * a.nw + ox0) * C - mis;  // 16-byte aligned
      const uint8_t* s = out_s + r * a.out_pitch;
      for (int b0 = 16 * (tid & 31); b0 < mis + len; b0 += 512) {
        if (b0 >= mis && b0 + 16 <= mis + len) {
          *reinterpret_cast<uint4*>(d + b0) = *reinterpret_cast<const uint4*>(s + b0);
        } else {
          for (int b = max(b0, mis); b < min(b0 + 16, mis + len); ++b) d[b] = s[b];
        }
      }
    }
    PW_RESIZE_MARK(4);
  }
#ifdef PW_RESIZE_PHASES
  if (tid == 0 && blockIdx.x < kTimedCtas) {
    resize_ns[blockIdx.x][0] = ns0;
    resize_ns[blockIdx.x][1] = global_ns();
  }
  if (clock_on) {
    for (int i = 0; i < 5; ++i) resize_cycles[clock_slot][i] = cycles[i];
    resize_cycles[clock_slot][5] = clock64() - t0;
    resize_cycles[clock_slot][6] = n_groups_all;
    resize_cycles[clock_slot][7] = n_items;
  }
#endif
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

int round16(long v) { return (int)((v + 15) / 16 * 16); }

int frac_threads(int tile) { return tile < 32 ? 32 : (tile + 31) / 32 * 32; }

// The instance's shared-memory attributes on the current device: room for
// `smem` bytes, and the largest carveout of the SM's memory for shared
// memory, so that the CTAs resident at once are the ones the occupancy count
// gives, to which the schedule fits its items.
template <int C, int KH, bool kPair>
cudaError_t frac_attributes(int smem) {
  const auto kernel = area_frac_bands<C, KH, kPair>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return err;
}

template <int C, int KH, bool kPair>
cudaError_t launch_frac(const FracArgs& a, int threads, int smem, long ctas, cudaStream_t st) {
  const auto kernel = area_frac_bands<C, KH, kPair>;
  const cudaError_t err = frac_attributes<C, KH, kPair>(smem);
  if (err != cudaSuccess) return err;
  const long items = (long)a.bands * a.tiles;
  kernel<<<(unsigned)(items < ctas ? items : ctas), threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The CTAs of an instance the current device holds at once.
template <int C, int KH, bool kPair>
long resident_ctas(int threads, int smem) {
  const auto kernel = area_frac_bands<C, KH, kPair>;
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (frac_attributes<C, KH, kPair>(smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) != cudaSuccess) return -1;
  return (long)per_sm * sms;
}

// Dispatch on the channels, the word route and the pair route: launch
// (ctas > 0: on at most that many CTAs) or count the resident CTAs (ctas = 0).
template <int C>
long frac_instance(const FracArgs& a, int kh, bool pair, int threads, int smem, long ctas, cudaStream_t st) {
#define PW_FRAC(KH, PAIR) \
  (ctas > 0 ? (long)launch_frac<C, KH, PAIR>(a, threads, smem, ctas, st) : resident_ctas<C, KH, PAIR>(threads, smem))
  if (!pair) return PW_FRAC(0, false);
  if (kh == 1) return PW_FRAC(1, true);
  if (kh == 2) return PW_FRAC(2, true);
  if (kh == 3) return PW_FRAC(3, true);
  if (kh == 4) return PW_FRAC(4, true);
  return PW_FRAC(0, true);
#undef PW_FRAC
}

long frac_dispatch(const FracArgs& a, int c, int kh, bool pair, int threads, int smem, long ctas, cudaStream_t st) {
  switch (c) {
    case 1: return frac_instance<1>(a, kh, pair, threads, smem, ctas, st);
    case 2: return frac_instance<2>(a, kh, pair, threads, smem, ctas, st);
    case 3: return frac_instance<3>(a, kh, pair, threads, smem, ctas, st);
    default: return frac_instance<4>(a, kh, pair, threads, smem, ctas, st);
  }
}

}  // namespace

extern "C" {

// The bytes of the fractional route's dynamic shared memory for a schedule,
// or -1 where the schedule is not one it takes: two stages of `group` rows of
// `pitch` bytes (a multiple of 16), the band's staged output rows, the ring
// of sums (the ring's route: `slots` rows, a column a thread), the events
// (the pair route: `events` source rows of 16 bytes), an int4 of each band
// row's taps and stage, four bounds and the two stages' mbarriers.
int pw_area_frac_smem(int band_rows, int tile, int group, int pitch, int slots, int events, int c) {
  if (band_rows < 1 || tile < 1 || tile > kMaxTile || group < 1 || pitch < 16 || pitch % 16 || slots < 2 || c < 1 ||
      c > 4 || events < 0 || (long)band_rows * round16((long)tile * c + 15) > 0xffff)
    return -1;
  const long stage = 2L * group * pitch;
  const long out = (long)band_rows * round16((long)tile * c + 15);
  const long ring = events == 0 ? round16(4L * slots * c * frac_threads(tile)) : 0;
  const long total = stage + out + ring + 16L * events + 16L * band_rows + 32;
  return total < (1L << 30) ? (int)total : -1;
}

static bool frac_args(FracArgs& a, const uint8_t* src, uint8_t* dst, const int* xsi, const float* xal, int th,
                      const int* ysi, const float* yal, int tv, int h, int w, int c, int nh, int nw, int band_rows,
                      int tile, int group, int pitch, int slots, int events, int kh, int smem) {
  const int need = pw_area_frac_smem(band_rows, tile, group, pitch, slots, events, c);
  if (th < 1 || tv < 1 || h < 1 || w < 1 || nh < 1 || nw < 1 || need < 0 || need != smem || smem > kMaxSmem ||
      kh < 0 || kh > 4 || (kh != 0 && events == 0))
    return false;
  a.src = src;
  a.dst = dst;
  a.xsi = xsi;
  a.xal = xal;
  a.ysi = ysi;
  a.yal = yal;
  a.th = th;
  a.tv = tv;
  a.h = h;
  a.w = w;
  a.nh = nh;
  a.nw = nw;
  a.band_rows = band_rows;
  a.tile = tile;
  a.group = group;
  a.pitch = pitch;
  a.out_pitch = round16((long)tile * c + 15);
  a.slots = slots;
  a.events = events;
  a.bands = (nh + band_rows - 1) / band_rows;
  a.tiles = (nw + tile - 1) / tile;
  a.stage_off = 0;
  a.out_off = 2 * group * pitch;
  a.acc_off = a.out_off + band_rows * a.out_pitch;
  a.ev_off = a.acc_off + (events == 0 ? round16(4L * slots * c * frac_threads(tile)) : 0);
  a.rows_off = a.ev_off + 16 * events;
  return true;
}

// The CTAs of the fractional route's instance for this schedule that the
// current device holds at once (the schedule's items are fitted to it), or a
// negative value where the schedule is not one it takes.
long pw_area_frac_ctas(int c, int band_rows, int tile, int group, int pitch, int slots, int events, int kh) {
  FracArgs a = {};
  const int smem = pw_area_frac_smem(band_rows, tile, group, pitch, slots, events, c);
  if (!frac_args(a, nullptr, nullptr, nullptr, nullptr, 1, nullptr, nullptr, 1, 1, 1, c, 1, 1, band_rows, tile, group,
                 pitch, slots, events, kh, smem))
    return -1;
  return frac_dispatch(a, c, kh, events > 0, frac_threads(tile), smem, 0, nullptr);
}

// dst (nh, nw, c) = cv2's resizeArea of src (h, w, c) uint8, through the tap
// tables xsi/xal (nw, th) and ysi/yal (nh, tv), int32 and float32 in device
// memory, on the schedule of ops/kernels.py::area_frac_schedule: items of
// band_rows output rows and `tile` columns, `group` source rows staged at
// once at `pitch` bytes a row; `events` > 0, the pair route with that many
// source rows of events a band, else the ring's route with `slots` rows
// open at once at most; `kh` the widest column's real taps (1 to 4), or 0
// past 4; `smem` bytes of dynamic shared memory, as
// pw_area_frac_smem gives; on at most `ctas` CTAs.  Fewer than 2^31 elements
// in and out (the caller checks).  Returns a CUDA error code.
int pw_area_resize_frac(const uint8_t* src, uint8_t* dst, const int* xsi, const float* xal, int th, const int* ysi,
                        const float* yal, int tv, int h, int w, int c, int nh, int nw, int band_rows, int tile,
                        int group, int pitch, int slots, int events, int kh, int smem, int ctas, void* stream) {
  if ((long)nh * nw <= 0) return (int)cudaGetLastError();
  FracArgs a = {};
  if (ctas < 1 || !frac_args(a, src, dst, xsi, xal, th, ysi, yal, tv, h, w, c, nh, nw, band_rows, tile, group, pitch,
                             slots, events, kh, smem))
    return (int)cudaErrorInvalidValue;
  return (int)frac_dispatch(a, c, kh, events > 0, frac_threads(tile), smem, ctas, static_cast<cudaStream_t>(stream));
}

#ifdef PW_RESIZE_PHASES
// The last fractional launch's phase cycles (3 x 8 values; see resize_cycles)
// and its CTAs' start and end times (kTimedCtas x 2; see resize_ns).
int pw_resize_phases(unsigned long long* out, unsigned long long* ns) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, resize_cycles, sizeof(resize_cycles));
  return (int)(err != cudaSuccess ? err : cudaMemcpyFromSymbol(ns, resize_ns, sizeof(resize_ns)));
}
#endif

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
