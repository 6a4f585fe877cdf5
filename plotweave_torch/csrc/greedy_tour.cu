// K9: stage 07's greedy nearest-endpoint tour for Hopper (sm_90a), bound to
// Python through a plain C interface (ctypes).
//
// Replaces plotweave/vector/planner_device.py::_greedy_device_impl (an XLA
// fori_loop).  From a seed contour, n - 1 dependent steps each take the
// unused contour nearest the pen: float32 d2 = dx*dx + dy*dy to its start and
// to its end, prefer the start when d2s <= d2e (always, for a closed contour
// when closed_aware), used contours out, the first minimum, then the pen moves
// to the far end of the chosen contour (its start when it was flipped or is
// closed).
//
// Exactness.  The order and the flips equal the host planner's
// (native/encoder.cpp pw_greedy_order, built with -ffp-contract=off) bit for
// bit: every product and sum is rounded on its own (__fmul_rn, __fadd_rn, and
// the library is compiled with --fmad=false), and the candidates are reduced
// as 64-bit keys (d2's bits, then the index): d2 >= 0, so its bit pattern
// orders as the float does, and the least key is the first minimum, which is
// what the host's ascending strict-< scan and jnp.argmin both pick.  The two
// low bits of a key carry the flip and whether the pen ends at the start.
//
// Design.  One persistent launch for the whole tour; the host reads nothing
// until it ends.  The points (start, end: 16 bytes) and a flag byte (joins at
// its start; used) live in shared memory, 17 bytes a point.
// - Up to GREEDY_CTA_MAX_N points (ops/kernels.py), one CTA of 512 threads:
//   each step is a scan of the thread's points, a warp reduction by shuffles,
//   one __syncthreads() and a second warp reduction of the 16 warp minima
//   (every warp takes it, so nothing is broadcast).
// - Above that, up to 65,536, a thread block cluster of 16 CTAs, each holding
//   n / 16 points (70 KB at 65,536).  Each CTA reduces as above, publishes its
//   minimum and the pen's next position in a slot, and after one
//   cluster.sync() every warp reads the 16 slots through distributed shared
//   memory and reduces them the same way.
// The per-step slots are double-buffered, which makes one barrier per step
// (two in the cluster) enough.  A contour's used flag is written only by the
// thread that scans it, so the flags need no barrier of their own.
//
// Bound.  n - 1 dependent steps of a scan over the unused points: the
// operations (8 float operations a point and step, about 4 n^2 in all) are
// small next to the barriers, so the floor is n barriers (one __syncthreads,
// or a cluster.sync, plus the shuffles' latency), about a microsecond a step.
// chip_smoke.py's bound (bytes and operations at the card's peaks) is far
// below that floor; PERF.md has both beside the measured times.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 16;  // CTAs of the cluster route (a non-portable cluster size)
constexpr unsigned long long kNone = ~0ull;

struct Slot {
  unsigned long long key;
  float x, y;  // where the pen goes if this key wins
};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

__device__ __forceinline__ float d2(float2 p, float2 c) {
  const float dx = __fsub_rn(p.x, c.x), dy = __fsub_rn(p.y, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// kCl CTAs (1, or kCluster as one cluster); CTA r holds points [r chunk,
// min(n, (r + 1) chunk)).  flags: bit 0 the contour joins at its start (closed
// and closed_aware), bit 1 used.
template <int kCl>
__global__ void __launch_bounds__(kThreads)
    greedy_tour(const float2* __restrict__ starts, const float2* __restrict__ ends, const uint8_t* __restrict__ closed,
                int n, int chunk, int closed_aware, int seed, int32_t* __restrict__ order, uint8_t* __restrict__ flips) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s_start = reinterpret_cast<float2*>(smem);
  float2* s_end = s_start + chunk;
  uint8_t* s_flag = reinterpret_cast<uint8_t*>(s_end + chunk);
  __shared__ unsigned long long warp_best[2][kWarps];
  __shared__ Slot cta_best[2];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int rank = 0;
  if constexpr (kCl > 1) rank = (int)cg::this_cluster().block_rank();
  const int base = rank * chunk;
  const int cnt = max(0, min(chunk, n - base));
  // each thread loads the points it scans, so no barrier is needed before its first scan
  for (int l = tid; l < cnt; l += kThreads) {
    const int i = base + l;
    s_start[l] = starts[i];
    s_end[l] = ends[i];
    s_flag[l] = (uint8_t)(((closed_aware && closed[i]) ? 1 : 0) | (i == seed ? 2 : 0));
  }
  float2 cur = (closed_aware && closed[seed]) ? starts[seed] : ends[seed];
  if (rank == 0 && tid == 0) {
    order[0] = seed;
    flips[0] = 0;
  }

  for (int step = 1; step < n; ++step) {
    const int buf = step & 1;
    unsigned long long best = kNone;
    for (int l = tid; l < cnt; l += kThreads) {
      const uint8_t f = s_flag[l];
      if (f & 2) continue;
      const float d2s = d2(s_start[l], cur), d2e = d2(s_end[l], cur);
      const bool prefer_start = (f & 1) || d2s <= d2e;
      // low bits: bit 1 flip (an open contour entered at its end), bit 0 the pen ends at the start
      const unsigned low = ((unsigned)(base + l) << 2) | (prefer_start ? 0u : 2u) | ((f & 1) || !prefer_start ? 1u : 0u);
      const unsigned long long key = ((unsigned long long)__float_as_uint(prefer_start ? d2s : d2e) << 32) | low;
      best = key < best ? key : best;
    }
    best = warp_min(best);
    if (lane == 0) warp_best[buf][warp] = best;
    __syncthreads();
    best = warp_min(lane < kWarps ? warp_best[buf][lane] : kNone);

    float2 next;
    if constexpr (kCl == 1) {
      const int l = (int)((unsigned)best >> 2);
      next = (best & 1ull) ? s_start[l] : s_end[l];
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (tid == 0) {
        Slot s = {best, 0.0f, 0.0f};
        if (best != kNone) {  // a CTA whose points are all used publishes kNone
          const int l = (int)((unsigned)best >> 2) - base;
          const float2 p = (best & 1ull) ? s_start[l] : s_end[l];
          s.x = p.x;
          s.y = p.y;
        }
        cta_best[buf] = s;
      }
      cluster.sync();
      Slot s = {kNone, 0.0f, 0.0f};
      if (lane < kCl) s = *cluster.map_shared_rank(&cta_best[buf], lane);
      best = warp_min(s.key);
      const int from = __ffs((int)__ballot_sync(0xffffffffu, s.key == best)) - 1;
      next.x = __shfl_sync(0xffffffffu, s.x, from);
      next.y = __shfl_sync(0xffffffffu, s.y, from);
    }

    const int idx = (int)((unsigned)best >> 2);
    const int l = idx - base;
    if (l >= 0 && l < cnt && l % kThreads == tid) s_flag[l] |= 2;  // only its scanning thread reads it
    if (rank == 0 && tid == 0) {
      order[step] = idx;
      flips[step] = (uint8_t)((best >> 1) & 1ull);
    }
    cur = next;
  }
  if constexpr (kCl > 1) cg::this_cluster().sync();  // no CTA leaves while a peer may read its slots
}

}  // namespace

extern "C" {

// The greedy tour over n contours with starts and ends (n, 2) float32 (8-byte
// aligned), closed (n,) uint8, from contour `seed`, on `cluster` CTAs (1 or 16)
// -> order (n,) int32 and flips (n,) uint8.  Returns a CUDA error code.
int pw_greedy_tour(const float* starts, const float* ends, const uint8_t* closed, int n, int closed_aware, int seed,
                   int cluster, int32_t* order, uint8_t* flips, void* stream) {
  if (n < 2 || seed < 0 || seed >= n || (cluster != 1 && cluster != kCluster)) return (int)cudaErrorInvalidValue;
  int chunk = (n + cluster - 1) / cluster;
  const size_t smem = (size_t)chunk * (2 * sizeof(float2) + 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = reinterpret_cast<const float2*>(starts);
  const float2* en = reinterpret_cast<const float2*>(ends);
  cudaError_t err;
  if (cluster == 1) {
    err = cudaFuncSetAttribute(greedy_tour<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    greedy_tour<1><<<1, kThreads, smem, s>>>(st, en, closed, n, chunk, closed_aware, seed, order, flips);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(greedy_tour<kCluster>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(greedy_tour<kCluster>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&st, &en, &closed, &n, &chunk, &closed_aware, &seed, &order, &flips};
  err = cudaLaunchKernelExC(&cfg, (const void*)greedy_tour<kCluster>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
