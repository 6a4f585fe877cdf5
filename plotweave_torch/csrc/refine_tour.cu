// K10: stage 12's 2-opt / relocate tour refiner for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces plotweave/vector/refine_device.py::_refine_impl (an XLA
// while_loop over n x n matrices).  The ops are nodes with an entry E and an
// exit X, in tour order from the pen's start.  Each iteration evaluates every
// move, takes the single best one and applies it, until no move shortens the
// pen-up travel by more than MIN_GAIN = 1e-2 or max_moves are spent:
// - 2-opt(i, j), i <= j: reverse ops i..j, each flipped;
//   delta = ((d(P[i], X[j]) + d(E[i], N[j])) - a_edge[i]) - b_edge[j];
// - relocate(i -> k), k in 0..n, k != i, i + 1, forward or reversed:
//   delta = ((d(E[i] or X[i], B[k]) + d(X[i] or E[i], A[k])) - base[k]) - gain_rm[i],
//   gain_rm[i] = (a_edge[i] + b_edge[i]) - d(P[i], N[i]);
// with P[i] the exit before op i (the start for i = 0), N[j] the entry after
// op j, B[k] the exit before slot k and A[k] the entry at slot k; a term that
// reaches past the last op is 0.  Each family's first minimum is taken over
// its flattened matrix (2-opt index i n + j, relocate i (n + 1) + k), and the
// family is the first minimum of the three values, as jnp.argmin does.
//
// Exactness.  Every delta is evaluated in that operation order, d as
// __fsqrt_rn(dx*dx + dy*dy) with each product and sum rounded on its own
// (the library is compiled with --fmad=false), so K10 gives the perm, flips
// and move count of its plain version (vector/refine_device.py::
// refine_order_plain) exactly.  d is symmetric bit for bit (a - b is -(b - a)
// exactly, and the squares drop the sign), which is what lets one distance
// serve two families below.  A lane keeps each family's minimum along one
// column as (value, row) in registers, a strict < over rows visited in
// increasing order; -0 and +0 compare equal, as in the plain argmin.  Only
// the warp, CTA and grid reductions use 64-bit keys: the value's bits mapped
// to an unsigned order (-0 taken as +0), then the index as row << 14 |
// column, which orders as the flat index does (a column is below 16,384).
//
// Design.  ONE cooperative launch a tour, one 1,024-thread CTA per SM (fewer
// for a tour shorter than the SM count), and nothing read back until it ends.
// - The tour is resident in every CTA's shared memory for the whole run:
//   EX (float4: the entry, then the exit), EG (float2: edge[t] = d(P[t], E[t]),
//   the travel into op t, which is a_edge, b_edge shifted by one and base;
//   then gain_rm) and PF (uint16: perm, the flip in bit 15).  26 bytes an op,
//   212,992 bytes at the largest tour of 8,192 ops, under the 232,448 a CTA
//   may take.  E and X are read from global memory once, before the loop.
// - Every CTA reduces the same partial minima alike, takes the same decision
//   and applies the move to its own copy: a 2-opt swaps the pairs (t, i + j -
//   t) and toggles their flips; a relocate shifts [dest, i] or [i, dest] by one
//   in chunks of 1,024 slots through registers, a __syncthreads between the
//   reads and the writes of a chunk, the chunks taken from the end that never
//   reads a slot a chunk before it wrote.  Then edge and gain_rm are
//   recomputed from shared memory for the slots beside the changed ones.
//   CTA 0 writes perm and flip once, at the end.
// - One grid.sync() an iteration.  The CTAs' partial minima sit in two global
//   slots chosen by the iteration's parity: a CTA past the barrier writes
//   iteration t + 1's slot while a slower one still reads t's, and no CTA can
//   write t's slot again before every CTA has passed t + 1's barrier.  After
//   the barrier three warps load every CTA's minimum of their family at once.
// - Four distances per (row i, column c), shared by the three families.
//   Columns are c = -1 .. n - 1 (X[-1] is the start); column c stands for
//   relocate slot k = c + 1 (B[k] = X[c], A[k] = E[c + 1]) and 2-opt j = c.
//   Row i computes d(E_i, X_c), d(X_i, E_c+1), d(X_i, X_c) and d(E_i, E_c+1):
//   relocate forward takes the first two, reversed the last two; 2-opt (i, c)
//   takes d(E_i, E_c+1) and d(P_i, X_c), which is d(X_i-1, X_c) of the row
//   before, carried in a register.  Slot n (c = n - 1) has no tail (the
//   tails are 0), slot 0 is column -1.
// - The work is cut into units (32-column group g, row i), numbered u = g n +
//   i; CTA b takes the contiguous run [b U / G, (b + 1) U / G) of the U units
//   and each of its 32 warps an equal share of that run: a stretch of
//   consecutive rows in one column group (two where it crosses one).  So
//   every CTA and every warp has the same work to a unit and no pass runs
//   with few lanes busy (only the last column group is partly empty).  Lane
//   l holds column 32 g + l - 1's X_c, E_c+1 and edge[c + 1] in registers
//   across its rows; each row's E_i, X_i, edge and gain_rm are one broadcast
//   from shared memory.  A warp that starts a column computes one distance
//   more, d(P_i, X_c) of its first row.  (Bands of whole rows, one a CTA,
//   left 26 of 132 CTAs a row more than the others at 1,214 ops, and the
//   rest waited for them at the barrier.)
//
// Registers, shared memory, spills (nvcc 12.9, -Xptxas -v, sm_90a): 63
// registers, 0 bytes of spill, 800 bytes of static shared memory (the warp
// keys, the grid group's) beside the 26 bytes an op.
//
// Bound.  The function needs the distinct distances of an iteration: E-X over
// all pairs (n^2), X-X and E-E each once per unordered pair (n(n - 1)/2 each)
// and the start's 2n: 2n^2 + n square roots, about 32 us an iteration at
// 8,192 ops at the SFU's 16 a clock per SM.  The kernel computes four a
// (row, column), twice that, each a correctly rounded sequence of several
// instructions, and about 80 instructions a pair in all: issue-bound near
// 160 us an iteration at 8,192.  A short tour is bound by its one grid
// barrier and the CTA's reductions.  Prediction (before its first run on the
// card): 5-8 us an iteration at 1,214 ops (the earlier design: 17.6), 150-200
// us at 8,192 (345).  Measured (H100 80GB HBM3 at 700 W; chip_smoke.py::
// phase_k10_ab, greedy tours, the full move budget, the earlier design in
// turns): 5.3 us an iteration at 600 ops, 9.7 at 1,214, 19.5 at 2,000 and
// 209 at 8,192 (the earlier design 8.7, 17.8-18.0, 28.8 and 343).  Both
// predictions missed: each correctly rounded square root carries its range
// test, a branch around its slow path and a reconvergence beside its
// arithmetic, so a (row, column) issues more than the 80 instructions
// estimated, and the candidates take 98 % of an iteration at 8,192 ops; at
// 1,214 a warp has 11 units, its column setup and key reduction stay
// uncovered, the candidates take 68 % of an iteration and the grid barrier
// 12 % (CTA 0's clock, chip_smoke.py::phase_k10_phases, a build with
// PW_REFINE_PHASES).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // a CTA's threads: one CTA an SM
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 256;  // CTAs a launch may take
constexpr float kMinGain = 1e-2f;
constexpr unsigned long long kNone = ~0ull;
constexpr unsigned kNoIndex = ~0u;
constexpr unsigned short kFlip = 0x8000u;
constexpr unsigned kColBits = 14, kColMask = (1u << kColBits) - 1;  // a column below 16,384 beside its row

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float dist(float2 a, float2 b) {
  const float dx = __fsub_rn(a.x, b.x), dy = __fsub_rn(a.y, b.y);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// (value, index) as one key whose unsigned order is the float order of the
// value, then the index
__device__ __forceinline__ unsigned long long key_of(float v, unsigned idx) {
  unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | idx;
}

__device__ __forceinline__ float value_of(unsigned long long key) {
  const unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ unsigned long long kmin(unsigned long long a, unsigned long long b) { return a < b ? a : b; }

// the least key of the warp, in every lane: the least high word, then the least low word beside it (two redux.sync)
__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  const unsigned hi = __reduce_min_sync(0xffffffffu, (unsigned)(v >> 32));
  const unsigned lo = __reduce_min_sync(0xffffffffu, (unsigned)(v >> 32) == hi ? (unsigned)v : ~0u);
  return ((unsigned long long)hi << 32) | lo;
}

// a candidate, visited in increasing index order: the first minimum
__device__ __forceinline__ void take(bool ok, float v, unsigned idx, float& bv, unsigned& bi) {
  if (ok && v < bv) {
    bv = v;
    bi = idx;
  }
}

__device__ __forceinline__ float2 entry(float4 ex) { return make_float2(ex.x, ex.y); }
__device__ __forceinline__ float2 exit_of(float4 ex) { return make_float2(ex.z, ex.w); }
__device__ __forceinline__ float4 reversed(float4 ex) { return make_float4(ex.z, ex.w, ex.x, ex.y); }

#ifdef PW_REFINE_PHASES
// CTA 0's thread 0: the clock64 cycles of each phase of the loop (candidates,
// CTA minima, grid barrier, grid minima, move, prologue) summed over the
// iterations, then the iteration count; only to time the phases
__device__ unsigned long long phase_cycles[7];
#define PHASE(k)                                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                      \
    const unsigned long long now = clock64();                     \
    cycles[k] += now - stamp;                                     \
    stamp = now;                                                  \
  }
#else
#define PHASE(k)
#endif

// edge[t] and gain_rm[t] of the ops t0..t1, from the tour in shared memory
__device__ void prologue(const float4* EX, float2* EG, int t0, int t1, int n, float2 start) {
  for (int t = t0 + (int)threadIdx.x; t <= t1; t += kThreads) {
    const float4 ex = EX[t];
    const float2 P = t ? exit_of(EX[t - 1]) : start;
    const float a = dist(P, entry(ex));
    float g = a;  // the last op: (a + 0) - 0
    if (t < n - 1) {
      const float2 En = entry(EX[t + 1]);
      g = __fsub_rn(__fadd_rn(a, dist(exit_of(ex), En)), dist(P, En));
    }
    EG[t] = make_float2(a, g);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    refine_tour(const float* __restrict__ Ein, const float* __restrict__ Xin, unsigned long long* __restrict__ partial,
                int n, float2 start, int max_moves, int32_t* __restrict__ perm_out, uint8_t* __restrict__ flip_out,
                int32_t* __restrict__ moves_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* EX = reinterpret_cast<float4*>(smem);
  float2* EG = reinterpret_cast<float2*>(EX + n);
  unsigned short* PF = reinterpret_cast<unsigned short*>(EG + n);
  __shared__ unsigned long long warp_key[3][kWarps];
  __shared__ unsigned long long best_key[3];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  // the (column group, row) units u = g n + i, n + 1 columns in groups of 32: this CTA's run of them, this warp's
  // share of it, and where that starts
  const int units = (n + 32) / 32 * n;
  const int c_lo = (int)((long long)blockIdx.x * units / G), c_hi = (int)((long long)(blockIdx.x + 1) * units / G);
  const int u_lo = c_lo + (int)((long long)warp * (c_hi - c_lo) / kWarps);
  const int u_hi = c_lo + (int)((long long)(warp + 1) * (c_hi - c_lo) / kWarps);
  const int g_lo = u_lo / n, r_lo = u_lo - g_lo * n;

  for (int t = tid; t < n; t += kThreads) {
    EX[t] = make_float4(Ein[2 * t], Ein[2 * t + 1], Xin[2 * t], Xin[2 * t + 1]);
    PF[t] = (unsigned short)t;
  }
  __syncthreads();
  prologue(EX, EG, 0, n - 1, n, start);
  __syncthreads();

#ifdef PW_REFINE_PHASES
  unsigned long long cycles[6] = {0, 0, 0, 0, 0, 0}, stamp = clock64();
#endif
  int moves = 0;
  for (; moves < max_moves; ++moves) {
    // ---- every candidate of this warp's units, each column group's minima into the warp's keys
    if (lane == 0) warp_key[0][warp] = warp_key[1][warp] = warp_key[2][warp] = kNone;
    for (int u = u_lo, g = g_lo, r0 = r_lo; u < u_hi; ++g, r0 = 0) {
      const int r1 = min(n, r0 + (u_hi - u));  // rows r0 .. r1 - 1 of column group g
      const int c = g * 32 + lane - 1;         // column: relocate slot c + 1, 2-opt j = c
      const bool col = c < n, tail = c + 1 < n;
      const float2 Xc = c < 0 ? start : exit_of(EX[min(c, n - 1)]);
      const float2 Ec1 = tail ? entry(EX[c + 1]) : Xc;  // slot n: a stand-in whose distances are dropped
      const float e1 = tail ? EG[c + 1].x : 0.0f;      // base[c + 1] = b_edge[c]
      float prev = dist(r0 ? exit_of(EX[r0 - 1]) : start, Xc);  // d(P_i, X_c)
      float v2 = inf(), vf = inf(), vr = inf();
      unsigned k2 = kNoIndex, kf = kNoIndex, kr = kNoIndex;  // the rows of the column's minima
      for (int i = r0; i < r1; ++i) {
        const float4 ex = EX[i];
        const float2 eg = EG[i], Ei = entry(ex), Xi = exit_of(ex);
        const float dEX = dist(Ei, Xc), dXX = dist(Xi, Xc), tXE = dist(Xi, Ec1), tEE = dist(Ei, Ec1);
        const float dXE = tail ? tXE : 0.0f, dEE = tail ? tEE : 0.0f;
        const bool reloc = col && (unsigned)(i - c) > 1u;  // k = c + 1 is neither i nor i + 1
        take(reloc, __fsub_rn(__fsub_rn(__fadd_rn(dEX, dXE), e1), eg.y), i, vf, kf);
        take(reloc, __fsub_rn(__fsub_rn(__fadd_rn(dXX, dEE), e1), eg.y), i, vr, kr);
        take(col && c >= i, __fsub_rn(__fsub_rn(__fadd_rn(prev, dEE), eg.x), e1), i, v2, k2);
        prev = dXX;
      }
      // (row, column) as row << 14 | column: the order of the flat index (2-opt i n + j, relocate i (n + 1) + k)
      const unsigned long long w2 = warp_min(key_of(v2, k2 == kNoIndex ? kNoIndex : k2 << kColBits | (unsigned)c));
      const unsigned long long wf = warp_min(key_of(vf, kf == kNoIndex ? kNoIndex : kf << kColBits | (unsigned)(c + 1)));
      const unsigned long long wr = warp_min(key_of(vr, kr == kNoIndex ? kNoIndex : kr << kColBits | (unsigned)(c + 1)));
      if (lane == 0) {
        warp_key[0][warp] = kmin(warp_key[0][warp], w2);
        warp_key[1][warp] = kmin(warp_key[1][warp], wf);
        warp_key[2][warp] = kmin(warp_key[2][warp], wr);
      }
      u += r1 - r0;
    }

    // ---- this CTA's minima into this iteration's slot, one barrier, and every CTA reduces them alike
    unsigned long long* slot = partial + (size_t)(moves & 1) * 3 * G;
    __syncthreads();
    PHASE(0)
    if (warp < 3) {
      const unsigned long long k = warp_min(lane < kWarps ? warp_key[warp][lane] : kNone);
      if (lane == 0) slot[warp * G + blockIdx.x] = k;
    }
    PHASE(1)
    grid.sync();
    PHASE(2)
    if (warp < 3) {  // warp f: family f, every CTA's minimum loaded at once
      unsigned long long k[kMaxGrid / 32];
#pragma unroll
      for (int m = 0; m < kMaxGrid / 32; ++m) k[m] = lane + 32 * m < G ? __ldcg(slot + warp * G + lane + 32 * m) : kNone;
#pragma unroll
      for (int m = 1; m < kMaxGrid / 32; ++m) k[0] = kmin(k[0], k[m]);
      k[0] = warp_min(k[0]);
      if (lane == 0) best_key[warp] = k[0];
    }
    __syncthreads();
    PHASE(3)
    const float v2 = value_of(best_key[0]), vf = value_of(best_key[1]), vr = value_of(best_key[2]);
    int fam = 0;
    float best = v2;
    if (vf < best) {
      fam = 1;
      best = vf;
    }
    if (vr < best) {
      fam = 2;
      best = vr;
    }
    if (!(best < -kMinGain)) break;

    // ---- the move, in place in this CTA's copy
    const unsigned at = (unsigned)best_key[fam];
    const int i = (int)(at >> kColBits), c = (int)(at & kColMask);  // 2-opt (i, j = c), relocate (i, k = c)
    const int dest = fam == 0 ? c : c < i ? c : c - 1;              // the slots i..dest change
    if (fam == 0) {  // positions i..j reverse and each op flips
      for (int p = tid; p <= (c - i) / 2; p += kThreads) {
        const int a = i + p, b = c - p;
        const float4 ea = EX[a], eb = EX[b];
        const unsigned short pa = PF[a], pb = PF[b];
        EX[a] = reversed(eb);
        EX[b] = reversed(ea);
        PF[a] = pb ^ kFlip;
        PF[b] = pa ^ kFlip;
      }
    } else {  // op i lands at dest, the ops between shift by one towards i
      float4 moved = EX[i];  // read by every thread before any write
      unsigned short pm = PF[i];
      if (fam == 2) {
        moved = reversed(moved);
        pm ^= kFlip;
      }
      if (dest < i) {  // t in (dest, i] takes t - 1: chunks from the top down
        for (int hi = i; hi > dest; hi -= kThreads) {
          const int t = hi - tid;
          const bool on = t > dest;
          float4 v;
          unsigned short p;
          if (on) {
            v = EX[t - 1];
            p = PF[t - 1];
          }
          __syncthreads();
          if (on) {
            EX[t] = v;
            PF[t] = p;
          }
        }
      } else {  // t in [i, dest) takes t + 1: chunks from the bottom up
        for (int lo = i; lo < dest; lo += kThreads) {
          const int t = lo + tid;
          const bool on = t < dest;
          float4 v;
          unsigned short p;
          if (on) {
            v = EX[t + 1];
            p = PF[t + 1];
          }
          __syncthreads();
          if (on) {
            EX[t] = v;
            PF[t] = p;
          }
        }
      }
      if (tid == 0) {  // after the last chunk's barrier: every read of dest is done
        EX[dest] = moved;
        PF[dest] = pm;
      }
    }
    __syncthreads();
    PHASE(4)
    // edge and gain_rm read the slots t - 1 .. t + 1: only those beside a changed slot change
    prologue(EX, EG, max(min(i, dest) - 1, 0), min(max(i, dest) + 1, n - 1), n, start);
    __syncthreads();
    PHASE(5)
  }
#ifdef PW_REFINE_PHASES
  if (blockIdx.x == 0 && tid == 0) {
    for (int k = 0; k < 6; ++k) phase_cycles[k] = cycles[k];
    phase_cycles[6] = moves + 1;
  }
#endif

  if (blockIdx.x == 0) {
    for (int t = tid; t < n; t += kThreads) {
      perm_out[t] = PF[t] & 0x7fff;
      flip_out[t] = (uint8_t)(PF[t] >> 15);
    }
    if (tid == 0) *moves_out = moves;
  }
}

// EX (16 bytes an op), EG (8) and PF (2)
size_t smem_bytes(int n) { return (size_t)n * (sizeof(float4) + sizeof(float2) + sizeof(unsigned short)); }

}  // namespace

extern "C" {

// The number of blocks the refiner's cooperative launch takes for n ops
// (one per SM where they fit, at most n), or a negative CUDA error code.
int pw_refine_blocks(int n) {
  const void* kernel = (const void*)refine_tour;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(8192));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem_bytes(n));
  if (err != cudaSuccess) return -(int)err;
  int blocks = sms * per_sm < kMaxGrid ? sms * per_sm : kMaxGrid;
  return blocks < n ? blocks : n;
}

// Refine the tour of n ops (3 <= n <= 8192) with entries E and exits X (n, 2)
// float32 in tour order (read once, not written), from the pen's start
// (sx, sy), making at most max_moves moves.  partial (2 * 3 * blocks,) uint64
// is scratch.  -> perm (n,) int32, flip (n,) uint8, moves (1,) int32.
// Returns a CUDA error code.
int pw_refine_tour(const float* E, const float* X, unsigned long long* partial, int blocks, int n, float sx, float sy,
                   int max_moves, int32_t* perm, uint8_t* flip, int32_t* moves, void* stream) {
  if (n < 3 || n > 8192 || blocks < 1 || blocks > n || blocks > kMaxGrid) return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)refine_tour;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(8192));
  if (err != cudaSuccess) return (int)err;
  float2 start = make_float2(sx, sy);
  void* args[] = {&E, &X, &partial, &n, &start, &max_moves, &perm, &flip, &moves};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks), dim3(kThreads), args, smem_bytes(n),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef PW_REFINE_PHASES
// the last launch's phase cycles (PHASE), 7 values
int pw_refine_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}
#endif

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
