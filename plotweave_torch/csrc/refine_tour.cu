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
// refine_order_plain) exactly.  The minima are 64-bit keys: the delta's bits
// mapped to an unsigned order (-0 taken as +0), then the flat index; the least
// key is the first minimum.
//
// Design.  No matrix in memory, and no host read until the tour ends: ONE
// cooperative launch of one 1,024-thread block per SM (fewer for a short
// tour).  Per iteration each block loads the tour (E, X) into shared memory and
// derives the O(n) prologue there: edge[t] = d(P[t], E[t]) (which is a_edge,
// b_edge shifted by one and base) and gain_rm; then it walks its rows i (rows
// b, b + G, ...) with its threads over the columns, keeping a running minimum
// key per family, reduces them by warp shuffles and writes one key per family.
// After a grid-wide barrier every block reduces the G partial keys the same
// way, takes the stop decision (best < -MIN_GAIN, moves < max_moves) on the
// device, and gathers its share of the new tour (E, X, perm, flip) into the
// other buffer; a second barrier, and the next iteration reads that buffer.
// Shared memory: 24 bytes an op (E, X, edge, gain_rm), 196,608 bytes at the
// largest tour of 8,192 ops.
//
// Bound.  About 3 n^2 candidates an iteration (2-opt n^2 / 2, each relocate
// family n^2) with two square roots each on average: the SFU's rate (16 a
// clock per SM) bounds it, about 80 us an iteration at n = 8,192, with some 20
// float operations per candidate beside them.  Two grid-wide barriers an
// iteration (a few microseconds each) bound a short tour.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kMinGain = 1e-2f;
constexpr unsigned long long kNone = ~0ull;

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

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = kmin(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

struct Tour {
  float2* E;
  float2* X;
  int32_t* perm;
  uint8_t* flip;
};

__global__ void __launch_bounds__(kThreads, 1)
    refine_tour(Tour cur, Tour nxt, unsigned long long* __restrict__ partial, int n, float2 start, int max_moves,
                int32_t* __restrict__ perm_out, uint8_t* __restrict__ flip_out, int32_t* __restrict__ moves_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* sE = reinterpret_cast<float2*>(smem);
  float2* sX = sE + n;
  float* edge = reinterpret_cast<float*>(sX + n);  // edge[t] = d(P[t], E[t]), the travel into op t
  float* gain = edge + n;                           // gain_rm
  __shared__ unsigned long long warp_key[3][kWarps];
  __shared__ unsigned long long best_key[3];

  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  const unsigned np1 = (unsigned)n + 1u;
  int moves = 0;
  // the identity and no flips; read only after a grid-wide barrier, or by the thread that wrote them
  for (int t = blockIdx.x * kThreads + tid; t < n; t += G * kThreads) {
    cur.perm[t] = t;
    cur.flip[t] = 0;
  }

  while (moves < max_moves) {
    // ---- the tour and its O(n) prologue in shared memory
    for (int t = tid; t < n; t += kThreads) {
      sE[t] = cur.E[t];
      sX[t] = cur.X[t];
    }
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) edge[t] = dist(t ? sX[t - 1] : start, sE[t]);
    __syncthreads();
    for (int t = tid; t < n; t += kThreads) {
      const bool has_next = t < n - 1;
      const float b = has_next ? edge[t + 1] : 0.0f;
      gain[t] = __fsub_rn(__fadd_rn(edge[t], b), has_next ? dist(t ? sX[t - 1] : start, sE[t + 1]) : 0.0f);
    }
    __syncthreads();

    // ---- every candidate of this block's rows
    unsigned long long k2 = kNone, kf = kNone, kr = kNone;
    for (int i = blockIdx.x; i < n; i += G) {
      const float2 Pi = i ? sX[i - 1] : start, Ei = sE[i], Xi = sX[i];
      const float ai = edge[i], gi = gain[i];
      for (int c = tid; c <= n; c += kThreads) {
        if (c != i && c != i + 1) {  // relocate op i before slot k = c
          const float2 Bk = c ? sX[c - 1] : start;
          float tail_f = 0.0f, tail_r = 0.0f, base = 0.0f;
          if (c < n) {
            const float2 Ak = sE[c];
            tail_f = dist(Xi, Ak);
            tail_r = dist(Ei, Ak);
            base = edge[c];
          }
          const unsigned flat = (unsigned)i * np1 + (unsigned)c;
          kf = kmin(kf, key_of(__fsub_rn(__fsub_rn(__fadd_rn(dist(Ei, Bk), tail_f), base), gi), flat));
          kr = kmin(kr, key_of(__fsub_rn(__fsub_rn(__fadd_rn(dist(Xi, Bk), tail_r), base), gi), flat));
        }
        if (c >= i && c < n) {  // 2-opt over ops i..j, j = c
          const bool has_next = c < n - 1;
          const float d_en = has_next ? dist(Ei, sE[c + 1]) : 0.0f;
          const float b = has_next ? edge[c + 1] : 0.0f;
          const float v = __fsub_rn(__fsub_rn(__fadd_rn(dist(Pi, sX[c]), d_en), ai), b);
          k2 = kmin(k2, key_of(v, (unsigned)i * (unsigned)n + (unsigned)c));
        }
      }
    }
    k2 = warp_min(k2);
    kf = warp_min(kf);
    kr = warp_min(kr);
    if (lane == 0) {
      warp_key[0][warp] = k2;
      warp_key[1][warp] = kf;
      warp_key[2][warp] = kr;
    }
    __syncthreads();
    if (warp < 3) {
      const unsigned long long k = warp_min(warp_key[warp][lane]);
      if (lane == 0) partial[3 * blockIdx.x + warp] = k;
    }
    grid.sync();

    // ---- every block reduces the partial minima alike and takes the same decision
    if (warp < 3) {
      unsigned long long k = kNone;
      for (int b = lane; b < G; b += 32) k = kmin(k, partial[3 * b + warp]);
      k = warp_min(k);
      if (lane == 0) best_key[warp] = k;
    }
    __syncthreads();
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

    // ---- apply the move: the new tour into the other buffer, G * 1024 positions at a time
    const unsigned c = (unsigned)best_key[fam];
    for (int t = blockIdx.x * kThreads + tid; t < n; t += G * kThreads) {
      int src;
      bool swap;
      if (fam == 0) {
        const int i = (int)(c / (unsigned)n), j = (int)(c % (unsigned)n);
        swap = t >= i && t <= j;  // positions i..j reverse and each op flips
        src = swap ? i + j - t : t;
      } else {
        const int i = (int)(c / np1), k = (int)(c % np1);
        const int dest = k < i ? k : k - 1;  // where the moved op lands
        if (t == dest) {
          src = i;
        } else if (t > dest && t <= i) {
          src = t - 1;
        } else if (t >= i && t < dest) {
          src = t + 1;
        } else {
          src = t;
        }
        swap = fam == 2 && t == dest;
      }
      const float2 e = cur.E[src], x = cur.X[src];
      nxt.E[t] = swap ? x : e;
      nxt.X[t] = swap ? e : x;
      nxt.perm[t] = cur.perm[src];
      nxt.flip[t] = cur.flip[src] ^ (uint8_t)swap;
    }
    ++moves;
    const Tour t = cur;
    cur = nxt;
    nxt = t;
    grid.sync();
  }

  for (int t = blockIdx.x * kThreads + tid; t < n; t += G * kThreads) {
    perm_out[t] = cur.perm[t];
    flip_out[t] = cur.flip[t];
  }
  if (blockIdx.x == 0 && tid == 0) *moves_out = moves;
}

size_t smem_bytes(int n) { return (size_t)n * (2 * sizeof(float2) + 2 * sizeof(float)); }

}  // namespace

extern "C" {

// The number of blocks the refiner's cooperative launch takes for n ops
// (one per SM where they fit, at most n), or a negative CUDA error code.
int pw_refine_blocks(int n) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(refine_tour, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(8192));
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, refine_tour, kThreads, smem_bytes(n));
  if (err != cudaSuccess) return -(int)err;
  const int blocks = sms * per_sm;
  return blocks < n ? blocks : n;
}

// Refine the tour of n ops (3 <= n <= 8192) with entries E and exits X (n, 2)
// float32 in tour order, from the pen's start (sx, sy), making at most
// max_moves moves.  Two buffers per tour: E0, X0 hold the input (and are
// overwritten); perm0, flip0, E1, X1, perm1, flip1 and partial (3 blocks,)
// uint64 are scratch.  -> perm (n,) int32, flip (n,) uint8, moves (1,)
// int32.  Returns a CUDA error code.
int pw_refine_tour(float* E0, float* X0, int32_t* perm0, uint8_t* flip0, float* E1, float* X1, int32_t* perm1,
                   uint8_t* flip1, unsigned long long* partial, int blocks, int n, float sx, float sy, int max_moves,
                   int32_t* perm, uint8_t* flip, int32_t* moves, void* stream) {
  if (n < 3 || n > 8192 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(refine_tour, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes(8192));
  if (err != cudaSuccess) return (int)err;
  Tour a = {reinterpret_cast<float2*>(E0), reinterpret_cast<float2*>(X0), perm0, flip0};
  Tour b = {reinterpret_cast<float2*>(E1), reinterpret_cast<float2*>(X1), perm1, flip1};
  float2 start = make_float2(sx, sy);
  void* args[] = {&a, &b, &partial, &n, &start, &max_moves, &perm, &flip, &moves};
  err = cudaLaunchCooperativeKernel((const void*)refine_tour, dim3((unsigned)blocks), dim3(kThreads), args,
                                    smem_bytes(n), static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
