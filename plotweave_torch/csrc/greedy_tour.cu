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
// the library is compiled with --fmad=false).  A candidate's value is
// min(d2s, d2e), which is d2s when d2s <= d2e and d2e otherwise; a closed
// contour (closed_aware) is held with its end set to its start, so its value
// is d2s, it is never flipped and the pen stays at its start.  Candidates
// compare as pairs (d2's bits, then a low word that orders as the contour's
// index): d2 >= 0, so its bits order as the float does, and the least pair
// is the first minimum, which is what the host's ascending strict-< scan and
// jnp.argmin both pick, whatever order the points are scanned in.  (Finite
// coordinates: a NaN d2 is ordered by its bits, not as the host does.)
//
// Design.  One persistent launch for the whole tour; the host reads nothing
// until it ends.  T threads a CTA: 256 on the one-CTA route, 128 on each CTA
// of the cluster (fewer warps do less of the chain's work that every warp
// repeats; measured on the H100, PERF.md).
// - Each thread keeps its own points, the unused ones only, compacted in
//   shared memory: its k-th point at slot k T + tid, (start, end) as a float4
//   and a meta word (local index << 16 | k << 1); 20 bytes a point.  A step
//   scans only the thread's live points, with no test of a used flag.  When
//   the winner is one of its own, the thread moves its last live point into
//   the winner's slot and shortens its count; only the owner reads or writes
//   its list, so that needs no barrier.  Each thread starts with the points
//   of local index tid, tid + T, ..., the seed left out.
// - A thread keeps its least (d2 bits, meta) pair, then reads that point once
//   more and works out whether it is flipped (d2e < d2s) and where the pen
//   goes if it wins.  A warp takes its least pair with two redux.sync (the
//   least d2 bits, then the least low word among the lanes that hold them),
//   and the lane that holds it writes the warp's slot: the pair with the
//   flip in bit 0, and that point.  One __syncthreads(), then the CTA's
//   least pair over the warp slots the same way; the winning warp is known
//   from the index (its owner thread is the local index mod T).
// - Below GREEDY_CLUSTER_MIN_N points (ops/kernels.py) one CTA holds the
//   tour, and every warp reduces the warp slots itself, so nothing is
//   broadcast.  It holds up to GREEDY_CTA_MAX_N.
// - From there up to 65,536, a thread block cluster of 16 CTAs, each holding
//   n / 16 points (80 KB at 65,536).  Warp 0 of each CTA reduces its warp
//   slots; its lane 0 arrives on its own CTA's mbarrier of the step,
//   expecting the bytes of 16 slots (expect_tx), and its lanes 0-15 store
//   the CTA's slot (the pair, the low word now global index << 5 | rank << 1
//   | flip, and the pen's next point: 16 bytes) into every peer's shared
//   memory with st.async, whose completion counts its bytes on that peer's
//   mbarrier (complete_tx; a slot may land before the expect_tx).  Every
//   thread waits only on its own CTA's mbarrier (acquire at cluster scope)
//   and reduces the 16 slots; no cluster barrier in the loop.  The winner's
//   rank is in its low word, so the pen's next point is one shuffle away.
// - Two sets of warp slots, received slots and mbarriers, by the step's
//   parity.  A CTA writes step s + 2's slot into a peer only after it has
//   passed step s + 1's wait, which needs the peer's slot of step s + 1, and
//   the peer's warp 0 stores that only after its __syncthreads() of step
//   s + 1, which each of its warps reaches only after reading step s's
//   slots: so no slot is written while it may still be read, and no byte
//   lands in a phase that has not completed.  Likewise a warp slot of step
//   s is written again at step s + 2, after the __syncthreads() of step
//   s + 1.  One cluster.sync() before the loop (the mbarriers are set up
//   before any peer stores to them) and one before exit (no CTA leaves
//   while a peer may still write to it).
//
// Bound.  n - 1 dependent steps; step s scans the n - s unused points, about
// 20 instructions and 20 bytes of shared memory a point, n^2 / 2 point-steps
// in all.  chip_smoke.py's bound (bytes and float operations at the card's
// peaks) is far below the chain of a step: a scan of a few points a thread,
// two warp reductions, a barrier (one CTA) or a store and a wait across the
// cluster, each some hundreds of cycles.  phase_k9_phases measures that
// chain alone (the scan removed); PERF.md has both beside the measured times.
// Prediction (before its first run on the card; the earlier design measured
// 2.43 us a step at 9,451 points on one CTA, 3.68 at 65,536 on the cluster,
// and a chain of 0.54 and 3.14 us a step): 0.55-0.8 us a step at 9,451 on
// one CTA, 0.7-1.0 at 65,536 on the cluster, chains of 0.25-0.35 and
// 0.45-0.75 us a step, the cluster faster than one CTA from 7,000-9,000.
// Measured (H100 80GB HBM3 at 700 W; chip_smoke.py::phase_k9_ab against the
// earlier design in turns, the same order and flips): 0.85 us a step at
// 9,451 on the cluster (1.13 on one CTA; 2.42 before), 1.19 at 65,536
// (3.70), 0.76 at 4,500 (1.43); chains (phase_k9_phases, the scan removed)
// of 0.48 us a step on one CTA and 0.64-0.66 on the cluster; the cluster
// faster from about 2,000 points.  The step times missed: on one CTA the
// scan, issue- and shared-memory-bound at some 0.2 cycles a live point,
// takes 58-68 % of a step at 4,500-9,451 points; on the cluster the chain
// is two thirds of a step, its minima (two warp reductions, the barrier,
// warp 0's reduction) and its exchange (the stores, the wait, the 16
// slots' reduction) about 530 clock64 ticks each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtaThreads = 256;      // threads of the one-CTA route's CTA
constexpr int kClusterThreads = 128;  // threads of each CTA of the cluster route
constexpr int kCluster = 16;           // CTAs of the cluster route (a non-portable cluster size)
constexpr unsigned kNone = ~0u;
constexpr unsigned kPosMask = 0x7fffu;  // meta bits 1-15: the slot row k; 16-31: the local index

// a warp's or a CTA's candidate: the pair (d2 bits, low word) and where the pen goes if it wins
struct __align__(16) Slot {
  unsigned hi, lo;
  float x, y;
};

#ifdef PW_GREEDY_PHASES
// CTA 0's thread 0: the clock64 cycles of each phase of a step (scan, warp and
// CTA minima, the cluster's exchange, the move) summed over the steps, then
// the step count; with phase_floor set every thread offers its first live
// point in place of its scan, which times the chain of a step without the scan
__device__ unsigned long long phase_cycles[5];
__device__ int phase_floor;
#define PHASE(k)                                                  \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                      \
    const unsigned long long now = clock64();                     \
    cycles[k] += now - stamp;                                     \
    stamp = now;                                                  \
  }
#else
#define PHASE(k)
#endif

__device__ __forceinline__ float d2(float px, float py, float2 c) {
  const float dx = __fsub_rn(px, c.x), dy = __fsub_rn(py, c.y);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// the least (hi, lo) pair of the warp, in every lane: the least hi, then the least lo beside it
__device__ __forceinline__ void warp_min(unsigned& hi, unsigned& lo) {
  const unsigned h = __reduce_min_sync(0xffffffffu, hi);
  lo = __reduce_min_sync(0xffffffffu, hi == h ? lo : kNone);
  hi = h;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

// the same shared-memory address in the CTA of cluster rank `rank`
__device__ __forceinline__ unsigned peer_addr(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// write a slot into a peer's shared memory; the store completes its 16 bytes on the peer's mbarrier
__device__ __forceinline__ void push(unsigned slot, unsigned bar, const Slot& s) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];" ::"r"(slot),
               "r"(s.hi), "r"(s.lo), "r"(__float_as_uint(s.x)), "r"(__float_as_uint(s.y)), "r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` of this CTA's mbarrier has completed (acquire at cluster scope)
__device__ __forceinline__ void wait_parity(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// kCl CTAs (1, or kCluster as one cluster); CTA r holds the points of local
// index l, global index r chunk + l, l < min(chunk, n - r chunk)
template <int kCl, int kT>
__global__ void __launch_bounds__(kT, 1)
    greedy_tour(const float2* __restrict__ starts, const float2* __restrict__ ends, const uint8_t* __restrict__ closed,
                int n, int chunk, int closed_aware, int seed, int32_t* __restrict__ order, uint8_t* __restrict__ flips) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kW = kT / 32;  // warps, at most 32: one warp slot a lane
  float4* L = reinterpret_cast<float4*>(smem);            // (start, end) of thread t's k-th live point at k kT + t
  unsigned* M = reinterpret_cast<unsigned*>(L + chunk);  // its meta word at the same slot
  __shared__ Slot warp_slot[2][kW];
  __shared__ Slot recv[2][kCl];          // the cluster's CTA slots of a step, each stored by its CTA
  __shared__ unsigned long long bar[2];  // completes when all 16 slots of a step have landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned rank = 0;
  if constexpr (kCl > 1) rank = cg::this_cluster().block_rank();
  const int base = (int)rank * chunk;
  const int cnt = max(0, min(chunk, n - base));
  // each thread loads its own list, so no barrier is needed before its first scan
  int live = 0;
  for (int l = tid; l < cnt; l += kT) {
    const int i = base + l;
    if (i == seed) continue;
    const float2 s = starts[i];
    const float2 e = (closed_aware && closed[i]) ? s : ends[i];  // a closed contour joins and leaves at its start
    L[live * kT + tid] = make_float4(s.x, s.y, e.x, e.y);
    M[live * kT + tid] = ((unsigned)l << 16) | ((unsigned)live << 1);
    ++live;
  }
  float2 cur = (closed_aware && closed[seed]) ? starts[seed] : ends[seed];
  if (rank == 0 && tid == 0) {
    order[0] = seed;
    flips[0] = 0;
  }
  if constexpr (kCl > 1) {
    if (tid == 0) {
      for (int b = 0; b < 2; ++b) asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(&bar[b])) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();  // every CTA's mbarriers are set before any peer stores to them
  }

#ifdef PW_GREEDY_PHASES
  unsigned long long cycles[4] = {0, 0, 0, 0}, stamp = clock64();
  const bool no_scan = phase_floor != 0;
#endif
  for (int step = 1; step < n; ++step) {
    const int buf = step & 1;
    // ---- the thread's least (d2 bits, meta) over its live points
    unsigned long long best = ~0ull;
#ifdef PW_GREEDY_PHASES
    if (no_scan) {
      if (live > 0) best = M[tid];
    } else
#endif
    {
#pragma unroll 4
      for (int k = 0; k < live; ++k) {
        const float4 p = L[k * kT + tid];
        const unsigned long long key =
            ((unsigned long long)__float_as_uint(fminf(d2(p.x, p.y, cur), d2(p.z, p.w, cur))) << 32) |
            M[k * kT + tid];
        best = key < best ? key : best;
      }
    }
    PHASE(0)
    // ---- warp and CTA minima: the thread's flip and where the pen goes if its pair wins (its start when it is
    // entered at its end); the lane that holds its warp's least pair writes the warp's slot
    unsigned hi = (unsigned)(best >> 32), lo = (unsigned)best;
    Slot w = {hi, lo, 0.0f, 0.0f};
    if (lo != kNone) {
      const float4 p = L[((lo >> 1) & kPosMask) * kT + tid];
      const bool flip = d2(p.z, p.w, cur) < d2(p.x, p.y, cur);
      w.lo |= flip ? 1u : 0u;
      w.x = flip ? p.x : p.z;
      w.y = flip ? p.y : p.w;
    }
    warp_min(hi, lo);
    if ((unsigned)(best >> 32) == hi && (unsigned)best == lo && (lo != kNone || lane == 0)) warp_slot[buf][warp] = w;
    __syncthreads();

    unsigned idx, flip;
    float2 next;
    if constexpr (kCl == 1) {
      const uint2 k = lane < kW ? *reinterpret_cast<const uint2*>(&warp_slot[buf][lane]) : make_uint2(kNone, kNone);
      hi = k.x;
      lo = k.y;
      warp_min(hi, lo);
      idx = lo >> 16;
      flip = lo & 1u;
      const Slot& win = warp_slot[buf][(idx % kT) >> 5];  // the slot of the winner's owner's warp
      next = make_float2(win.x, win.y);
      PHASE(1)
      PHASE(2)
    } else {
      if (warp == 0) {
        Slot s = {kNone, kNone, 0.0f, 0.0f};
        if (lane < kW) s = warp_slot[buf][lane];
        hi = s.hi;
        lo = s.lo;
        warp_min(hi, lo);
        const int from = (int)(((lo >> 16) % kT) >> 5);
        Slot c = {hi, kNone, __shfl_sync(0xffffffffu, s.x, from), __shfl_sync(0xffffffffu, s.y, from)};
        if (lo != kNone) c.lo = ((unsigned)(base + (int)(lo >> 16)) << 5) | (rank << 1) | (lo & 1u);
        PHASE(1)
        // this CTA's mbarrier of the step: one arrival, and the bytes of 16 slots; a peer's slot may land first
        if (lane == 0)
          asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(&bar[buf])),
                       "r"(kCl * (int)sizeof(Slot))
                       : "memory");
        if (lane < kCl) push(peer_addr(smem_u32(&recv[buf][rank]), lane), peer_addr(smem_u32(&bar[buf]), lane), c);
      }
      wait_parity(smem_u32(&bar[buf]), (unsigned)((step - 1) >> 1) & 1u);
      Slot r = {kNone, kNone, 0.0f, 0.0f};
      if (lane < kCl) r = recv[buf][lane];
      hi = r.hi;
      lo = r.lo;
      warp_min(hi, lo);
      idx = lo >> 5;
      flip = lo & 1u;
      const int from = (int)((lo >> 1) & (kCl - 1));  // the winner's CTA
      next.x = __shfl_sync(0xffffffffu, r.x, from);
      next.y = __shfl_sync(0xffffffffu, r.y, from);
      PHASE(2)
    }

    // ---- the move: the owner drops the winner from its list (it was the owner's own least pair)
    const int l = (int)idx - base;
    if (l >= 0 && l < cnt && l % kT == tid) {
      const unsigned k = ((unsigned)best >> 1) & kPosMask;
      --live;
      if ((int)k != live) {
        L[k * kT + tid] = L[live * kT + tid];
        M[k * kT + tid] = (M[live * kT + tid] & 0xffff0000u) | (k << 1);
      }
    }
    if (rank == 0 && tid == 0) {
      order[step] = (int32_t)idx;
      flips[step] = (uint8_t)flip;
    }
    cur = next;
    PHASE(3)
  }
#ifdef PW_GREEDY_PHASES
  if (blockIdx.x == 0 && tid == 0) {
    for (int k = 0; k < 4; ++k) phase_cycles[k] = cycles[k];
    phase_cycles[4] = n - 1;
  }
#endif
  if constexpr (kCl > 1) cg::this_cluster().sync();  // no CTA leaves while a peer may still write to it
}

// the dynamic shared memory of a CTA holding `chunk` points
size_t smem_bytes(int chunk) { return (size_t)chunk * (sizeof(float4) + sizeof(unsigned)); }

}  // namespace

extern "C" {

// The greedy tour over n contours with starts and ends (n, 2) float32 (8-byte
// aligned), closed (n,) uint8, from contour `seed`, on `cluster` CTAs (1 or 16)
// -> order (n,) int32 and flips (n,) uint8.  Returns a CUDA error code.
int pw_greedy_tour(const float* starts, const float* ends, const uint8_t* closed, int n, int closed_aware, int seed,
                   int cluster, int32_t* order, uint8_t* flips, void* stream) {
  if (n < 2 || n > 65536 || seed < 0 || seed >= n || (cluster != 1 && cluster != kCluster))
    return (int)cudaErrorInvalidValue;
  int chunk = (n + cluster - 1) / cluster;  // one CTA's shared memory keeps a local index within 16 bits
  const size_t smem = smem_bytes(chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float2* st = reinterpret_cast<const float2*>(starts);
  const float2* en = reinterpret_cast<const float2*>(ends);
  cudaError_t err;
  if (cluster == 1) {
    err = cudaFuncSetAttribute(greedy_tour<1, kCtaThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    greedy_tour<1, kCtaThreads><<<1, kCtaThreads, smem, s>>>(st, en, closed, n, chunk, closed_aware, seed, order, flips);
    return (int)cudaGetLastError();
  }
  err = cudaFuncSetAttribute(greedy_tour<kCluster, kClusterThreads>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(greedy_tour<kCluster, kClusterThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&st, &en, &closed, &n, &chunk, &closed_aware, &seed, &order, &flips};
  err = cudaLaunchKernelExC(&cfg, (const void*)greedy_tour<kCluster, kClusterThreads>, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef PW_GREEDY_PHASES
// the last launch's phase cycles (PHASE), 5 values
int pw_greedy_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}

// whether the next launches offer each thread's first live point in place of the scan
int pw_greedy_set_floor(int on) { return (int)cudaMemcpyToSymbol(phase_floor, &on, sizeof(on)); }
#endif

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
