// K8: the device k-means of stage 02 (kmeans_init = "device") for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA programs of plotweave/ops/kmeans.py (_lloyd,
// _kpp_init_device, kmeans_fit_device) and the subsample of
// plotweave/stages/s02_color_extract.py::_device_init_stage (its
// jax.random.choice without replacement, :127-129).  Entry points:
//
// - pw_subsample: the subsample's draw, on the device, with no host read.
//   Pixel i < n gets the 32-bit key fmix32(i * a + b mod 2^32), murmur3's
//   finalizer, with (a odd, b) two words of splitmix64(seed) (the host's
//   only part, ops/kmeans.py::draw_words).  Both steps are bijections of i,
//   so no two of a seed's keys are equal.  The subsample is the `limit`
//   pixels of least key, in increasing index order.  One cooperative launch
//   of at most 1,024 CTAs of 1,024 threads, each owning a run of whole
//   1,024-pixel tiles: a radix select over the key (11, 11, then 10 bits: a
//   shared-memory histogram of the digit over the keys inside the prefix
//   found so far, merged into device memory with integer atomics, one
//   grid.sync(), then every CTA finds the same digit from the merged counts),
//   which gives K, the limit-th least key; then each CTA counts its keys
//   <= K, one grid.sync(), each takes its first output slot from every CTA's
//   counts, and writes its tiles' indices, each tile ranked by one CTA-wide
//   scan.  Keys are recomputed in each of the five passes, never stored.
// - pw_lab_sample: gathers `n` pixels of a BGR image by index and converts
//   them to float Lab with lab.cuh's arithmetic, K7's bit for bit (this file
//   is compiled with --fmad=false like K7).
// - pw_kpp_init: k-means++ seeding of every attempt: the first centre by a
//   given index, then k - 1 draws, each the first row i whose running sum
//   R(i) of the integer weights w = max(floor(d2 2^16), 1) (at most 2^36)
//   exceeds target = floor(total u) (the last row where none does: u = 1),
//   d2 = (e0^2 + e1^2) + e2^2 in float32 the squared distance to the nearest
//   centre so far, updated by min.  The random numbers come from the host
//   (one index and k - 1 uniforms per attempt).  Integer sums are exact in
//   any order, so the picks depend on no order of additions
//   (ops/kmeans.py::kpp_init_plain: cumsum and searchsorted); target is exact
//   (kpp_target).  Overflow: w < 2^36 and n < 2^27, so every sum is below
//   2^63; the cap binds only where d2 >= 2^20 (a distance of 1,024; Lab in
//   OpenCV's 8-bit scaling has d2 < 3 * 255^2 < 2^18), and the wrappers
//   refuse n >= 2^27.  Design: one thread block cluster of 16 CTAs of 512
//   threads per attempt; CTA r owns rows [r P, (r + 1) P), P = ceil(n / 16),
//   in tiles of 512 rows, one row a thread, so every load is coalesced.
//   Where a CTA's rows fit (16 bytes a row: 200,000 rows take 200 KB a
//   CTA), they and their d2 stay in shared memory and the sample is read
//   once; else (the streamed route) the rows are read each draw and d2 lives
//   in device scratch.  A draw: every thread updates its rows' d2 and w, a
//   warp sums its w (two redux.sync, of the low and the high 18 bits) and
//   adds both sums to its tile's (32-bit shared-memory atomics), the CTA sums its tiles and stores its total into every peer
//   (distributed shared memory); one cluster.sync(); every CTA sums the 16
//   totals in rank order to its offset and the grand total, and computes
//   target; only the CTA whose range holds target searches: warp 0 finds the
//   tile from the tile totals, the CTA rescans that one tile (one scan), and
//   thread 0 stores the pick and its row into every peer; one cluster.sync().
// - pw_lloyd_fit: every attempt's whole Lloyd loop in ONE launch, one thread
//   block cluster of 16 CTAs per attempt, with the stop test on the device
//   (a launch and a flag read per iteration would be host-bound: up to 40
//   iterations x 3 attempts), and the choice of the best attempt by the last
//   cluster to finish.  No host read anywhere.
//
// - pw_assign_points: the all-point assignment of ops/kmeans.py::kmeans, by
//   the fit's distance.
//
// Numbers.  Distances are |x|^2 - 2 x.c + |c|^2 in float32 as _lloyd's, each
// three-term sum as (a + b) + c, first minimum wins, an empty cluster keeps
// its centre, shift = the largest centre movement, loop while shift > eps
// and it < iters, then one more assignment for the compactness (sum of the
// minimal d2, which this expanded form can make slightly negative: kept, it
// decides which attempt wins).  No TF32, no FMA, no float atomics.  The sums
// have a fixed order, so a seed gives the same centres on every run: thread
// (its points i = rank * T + tid, stride 16 T, in order) -> warp (shuffle
// tree) -> block (warps in order) -> cluster (CTA ranks in order, read through
// distributed shared memory between cluster.sync()s; every CTA computes the
// same new centres from the same numbers and so takes the same stop
// decision).  The partials are double-buffered, which makes one
// cluster.sync() per iteration enough.
//
// Bound.  The fit: about 9 float operations per centre, point and
// iteration.  The sample (2.4 MB at 200,000 points) is read from L2 by 16 CTAs
// per iteration; a cooperative grid over all SMs would read it faster but pay
// a grid-wide barrier per iteration, and three attempts already run side by
// side on 48 SMs.  The draw: the hash once a key, n x about 10 integer
// operations (3e7 at 3,000,000 pixels, 1.8 us at the INT32 peak), against
// 0.8 MB written (0.24 us); the kernel hashes each key five times.  The seeding: 12 bytes a row read once; its chain of two
// cluster barriers a draw binds it.  On an H100 the times are in PERF.md.
//
// Prediction (written before the first run on the card; the earlier seeding, one
// CTA of 1,024 threads an attempt with uncoalesced chunks, took 1.104 ms
// alone at 200,000 x 3, k = 4, 3 attempts): the seeding 15-30 us a call there
// (3-6 us a draw for the update, the two cluster barriers and the one-tile
// rescan, 3-6 us to load the rows); the draw 20-60 us at 3,000,000 -> 200,000
// (five passes of about 1-3 us each, four grid barriers, the global
// histogram merges), against about 60 ms of host torch.randperm before.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lab.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 8;           // centres the fit's register accumulators hold
constexpr int kCluster = 16;       // CTAs per attempt (a non-portable cluster size)
constexpr int kFitThreads = 512;   // threads per CTA of the fit
constexpr int kFitWarps = kFitThreads / 32;
constexpr int kInitThreads = 512;   // threads per CTA of the seeding: a tile is one row a thread
constexpr int kInitWarps = kInitThreads / 32;
constexpr int kDrawThreads = 1024;  // threads per CTA of the draw; also the most CTAs it takes
constexpr int kDrawWarps = kDrawThreads / 32;
constexpr int kDigits = 2048;       // histogram buckets of one round of the draw's radix select
constexpr int kMaxSmem = 232448;    // 227 KB, the opt-in limit of one CTA

__global__ void lab_sample(const uint8_t* __restrict__ bgr, const int32_t* __restrict__ idx, float* __restrict__ out,
                           int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint8_t* px = bgr + 3 * (long)(idx ? idx[i] : i);
  const float r = pw_lab::gamma_inv((float)px[2] / 255.0f);
  const float g = pw_lab::gamma_inv((float)px[1] / 255.0f);
  const float b = pw_lab::gamma_inv((float)px[0] / 255.0f);
  float lab0, lab1, lab2;
  pw_lab::lab_from_linear(r, g, b, lab0, lab1, lab2);
  out[3 * (long)i] = lab0;
  out[3 * (long)i + 1] = lab1;
  out[3 * (long)i + 2] = lab2;
}

// ---------------------------------------------------------------- the draw

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// The draw's key of pixel i: murmur3's 32-bit finalizer of i * a + b (mod 2^32).
__device__ __forceinline__ uint32_t draw_key(uint32_t i, uint32_t a, uint32_t b) { return fmix32(i * a + b); }

template <typename T>
__device__ __forceinline__ T warp_inclusive_scan(T x) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Exclusive scan of v over the CTA (kWarps warps, every thread calls it);
// total gets the CTA's sum.  slots: kWarps values of shared memory.
template <typename T, int kWarps>
__device__ __forceinline__ T block_exclusive_scan(T v, T* slots, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T x = warp_inclusive_scan(v);
  if (lane == 31) slots[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const T y = warp_inclusive_scan(lane < kWarps ? slots[lane] : T(0));
    if (lane < kWarps) slots[lane] = y;
  }
  __syncthreads();
  const T excl = x - v + (warp > 0 ? slots[warp - 1] : T(0));
  total = slots[kWarps - 1];
  __syncthreads();  // the slots are written again by the next scan
  return excl;
}

// One cooperative launch; CTA q owns the pixels [q chunk, (q + 1) chunk).
// hist: 3 rounds x kDigits counts, zeroed by the caller; counts: one per CTA.
__global__ void __launch_bounds__(kDrawThreads)
    subsample_draw(int n, int limit, uint32_t a, uint32_t b, long chunk, uint32_t* __restrict__ hist,
                   int* __restrict__ counts, int32_t* __restrict__ out) {
  __shared__ uint32_t h_s[kDigits];
  __shared__ int slots[kDrawWarps];
  __shared__ int found[2];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const long lo = min((long)blockIdx.x * chunk, (long)n), hi = min(lo + chunk, (long)n);

  // the radix select: 11, 11 and 10 bits of the key, counting only the keys inside the prefix found so far
  uint32_t prefix = 0, mask = 0;
  int need = limit;  // the rank, among the keys inside the prefix, of the limit-th least key
  for (int round = 0; round < 3; ++round) {
    const int sh = round == 0 ? 21 : round == 1 ? 10 : 0;
    const uint32_t digit = round == 2 ? 0x3ffu : 0x7ffu;
    for (int j = tid; j < kDigits; j += kDrawThreads) h_s[j] = 0;
    __syncthreads();
    for (long i = lo + tid; i < hi; i += kDrawThreads) {
      const uint32_t key = draw_key((uint32_t)i, a, b);
      if ((key & mask) == prefix) atomicAdd(&h_s[(key >> sh) & digit], 1u);
    }
    __syncthreads();
    uint32_t* g = hist + round * kDigits;
    for (int j = tid; j < kDigits; j += kDrawThreads)
      if (h_s[j]) atomicAdd(&g[j], h_s[j]);
    grid.sync();
    // every CTA finds the same digit: the first whose running count reaches need
    const int c0 = (int)__ldcg(g + 2 * tid), c1 = (int)__ldcg(g + 2 * tid + 1);
    int sum;
    const int below = block_exclusive_scan<int, kDrawWarps>(c0 + c1, slots, sum);
    if (below < need && need <= below + c0) {
      found[0] = 2 * tid;
      found[1] = below;
    } else if (below + c0 < need && need <= below + c0 + c1) {
      found[0] = 2 * tid + 1;
      found[1] = below + c0;
    }
    __syncthreads();
    prefix |= (uint32_t)found[0] << sh;
    mask |= digit << sh;
    need -= found[1];
    __syncthreads();  // found is written again in the next round
  }

  // prefix is the limit-th least key: take every key up to it
  int take = 0;
  for (long i = lo + tid; i < hi; i += kDrawThreads) take += draw_key((uint32_t)i, a, b) <= prefix;
  int take_cta;
  block_exclusive_scan<int, kDrawWarps>(take, slots, take_cta);
  if (tid == 0) counts[blockIdx.x] = take_cta;
  grid.sync();
  // thread q stands for CTA q (gridDim.x <= kDrawThreads): its first output slot
  int all;
  const int q_base = block_exclusive_scan<int, kDrawWarps>(tid < (int)gridDim.x ? __ldcg(counts + tid) : 0, slots, all);
  if (tid == (int)blockIdx.x) found[0] = q_base;
  __syncthreads();
  int base = found[0];

  // the compaction, a tile of kDrawThreads pixels at a time in index order
  for (long t0 = lo; t0 < hi; t0 += kDrawThreads) {
    const long i = t0 + tid;
    const int is_taken = i < hi && draw_key((uint32_t)i, a, b) <= prefix;
    int tile;
    const int before = block_exclusive_scan<int, kDrawWarps>(is_taken, slots, tile);
    if (is_taken) out[base + before] = (int32_t)i;
    base += tile;
  }
}

// ------------------------------------------------------------ the seeding

// w = max(floor(d2 2^16), 1), at most 2^36 (d2 >= 2^20 saturates); NaN counts as the cap.
__device__ __forceinline__ unsigned long long kpp_weight(float d2) {
  const unsigned long long w = (unsigned long long)fminf(d2 * 65536.0f, 68719476736.0f);
  return w > 0ull ? w : 1ull;
}

// floor(total u) exactly, u a float32 in [0, 1] (below 0 reads as 0, above 1 as 1): u = m 2^-q with m < 2^24
// and q >= 24; total = hi 2^24 + lo, so floor(total m / 2^24) = hi m + floor(lo m / 2^24), no product above 2^63.
__device__ __forceinline__ unsigned long long kpp_target(unsigned long long total, float u) {
  const uint32_t bits = __float_as_uint(u);
  if (bits >= 0x80000000u || bits == 0u) return 0ull;
  if (bits >= 0x3f800000u) return total;
  const uint32_t e8 = bits >> 23, f23 = bits & 0x7fffffu;
  const unsigned long long m = e8 ? (f23 | 0x800000u) : f23;
  const int q = e8 ? 150 - (int)e8 : 149;
  const unsigned long long v = (total >> 24) * m + (((total & 0xffffffull) * m) >> 24);
  return q - 24 >= 64 ? 0ull : v >> (q - 24);
}

struct InitShared {
  float4 pick;                            // this draw's pick: its index's bits, then its row; pushed by its CTA
  unsigned long long totals[kCluster];    // every CTA's total of this draw, pushed by each CTA
  unsigned long long cta_total;
  unsigned long long slots[kInitWarps];   // the CTA's scans; the warps' parts of the CTA's total
  unsigned long long rest;                // the picker's residual inside its tile
  int tile, local;
};

// One cluster of kCluster CTAs per attempt; see the header.  rows: a CTA's
// rows, tiles = ceil(rows / kInitThreads).  A tile's total is kept as the
// sums of its weights' low and high 18 bits (each below 2^27), added by
// 32-bit shared-memory atomics: a 64-bit shared atomic add is a
// compare-and-swap loop, and 16 warps add to each tile.  kResident: the
// CTA's rows and d2 in shared memory after the tile totals, else the rows
// read from the sample and d2 in d2_all (attempts, n).
template <bool kResident>
__global__ void __launch_bounds__(kInitThreads)
    kpp_init(const float* __restrict__ sample, int n, int k, int rows, int tiles, const int32_t* __restrict__ first,
             const float* __restrict__ uniforms, float* __restrict__ d2_all, float* __restrict__ centers_all,
             int32_t* __restrict__ picks_all) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ InitShared s;
  uint32_t* tile_lo = reinterpret_cast<uint32_t*>(dyn);
  uint32_t* tile_hi = tile_lo + tiles;
  float* xs = reinterpret_cast<float*>(tile_hi + tiles);  // resident: x0, x1, x2 and d2, rows values each
  auto tile_tot = [&](int t) -> unsigned long long { return ((unsigned long long)tile_hi[t] << 18) + tile_lo[t]; };
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), a = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long lo = min((long)rank * rows, (long)n);
  const int len = (int)(min(lo + rows, (long)n) - lo);
  float* d2 = kResident ? xs + 3 * (long)rows : d2_all + (long)a * n + lo;
  const float* src = sample + 3 * lo;
  auto coord = [&](int r, int c) -> float { return kResident ? xs[(long)c * rows + r] : src[3 * (long)r + c]; };

  int idx = first[a];
  float c0 = sample[3 * (long)idx], c1 = sample[3 * (long)idx + 1], c2 = sample[3 * (long)idx + 2];
  if (rank == 0 && tid == 0) {
    picks_all[(long)a * k] = idx;
    centers_all[(long)a * k * 3] = c0;
    centers_all[(long)a * k * 3 + 1] = c1;
    centers_all[(long)a * k * 3 + 2] = c2;
  }
  if (k == 1) return;
  if (kResident)  // coalesced: the CTA's 3 len floats in order
    for (int f = tid; f < 3 * len; f += kInitThreads) xs[(long)(f % 3) * rows + f / 3] = src[f];

  for (int j = 1; j < k; ++j) {
    // d2 and w against the last centre; every tile's total and the CTA's, integer sums in any order
    for (int t = tid; t < tiles; t += kInitThreads) tile_lo[t] = tile_hi[t] = 0u;
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      const int r = t * kInitThreads + tid;
      unsigned long long w = 0ull;
      if (r < len) {
        const float e0 = coord(r, 0) - c0, e1 = coord(r, 1) - c1, e2 = coord(r, 2) - c2;
        float d = (e0 * e0 + e1 * e1) + e2 * e2;
        if (j > 1) d = fminf(d2[r], d);
        d2[r] = d;
        w = kpp_weight(d);
      }
      const uint32_t lo_sum = __reduce_add_sync(0xffffffffu, (uint32_t)(w & 0x3ffffull));  // below 2^23
      const uint32_t hi_sum = __reduce_add_sync(0xffffffffu, (uint32_t)(w >> 18));
      if (lane == 0) {
        if (lo_sum) atomicAdd(&tile_lo[t], lo_sum);
        if (hi_sum) atomicAdd(&tile_hi[t], hi_sum);
      }
    }
    __syncthreads();
    unsigned long long part = 0ull;
    for (int t = tid; t < tiles; t += kInitThreads) part += tile_tot(t);
    part = warp_sum(part);
    if (lane == 0) s.slots[warp] = part;
    __syncthreads();
    if (tid == 0) {
      unsigned long long sum = 0ull;
      for (int v = 0; v < kInitWarps; ++v) sum += s.slots[v];
      s.cta_total = sum;
    }
    __syncthreads();
    if (tid < kCluster) cluster.map_shared_rank(&s.totals[0], tid)[rank] = s.cta_total;
    cluster.sync();  // every CTA's total is in every CTA

    unsigned long long off = 0ull, total = 0ull;
    for (int q = 0; q < kCluster; ++q) {
      const unsigned long long v = s.totals[q];
      off += q < rank ? v : 0ull;
      total += v;
    }
    const unsigned long long target = kpp_target(total, uniforms[(long)a * (k - 1) + j - 1]);
    const bool past = target >= total;  // u = 1: no running sum exceeds it, the last row
    if (past ? rank == (n - 1) / rows : off <= target && target < off + s.totals[rank]) {
      int local = len - 1;
      if (!past) {
        const unsigned long long res = target - off;
        if (warp == 0) {  // the tile: lane l sums a run of tiles, the first lane whose running sum exceeds res
          const int per = (tiles + 31) / 32;
          const int t0 = min(lane * per, tiles), t1 = min(t0 + per, tiles);
          unsigned long long own = 0ull;
          for (int t = t0; t < t1; ++t) own += tile_tot(t);
          const unsigned long long incl = warp_inclusive_scan(own);
          if (lane == __ffs(__ballot_sync(0xffffffffu, incl > res)) - 1) {
            unsigned long long rest = res - (incl - own);
            int t = t0;
            while (rest >= tile_tot(t)) rest -= tile_tot(t++);
            s.tile = t;
            s.rest = rest;
          }
        }
        __syncthreads();
        const int r = s.tile * kInitThreads + tid;  // the tile's rescan: one row a thread
        const unsigned long long w = r < len ? kpp_weight(d2[r]) : 0ull;
        unsigned long long sum;
        const unsigned long long before = block_exclusive_scan<unsigned long long, kInitWarps>(w, s.slots, sum);
        if (before <= s.rest && s.rest < before + w) s.local = r;
        __syncthreads();
        local = s.local;
      }
      if (tid == 0) {
        const float4 p = make_float4(__int_as_float((int)(lo + local)), coord(local, 0), coord(local, 1),
                                     coord(local, 2));
        for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(&s.pick, q) = p;
      }
    }
    cluster.sync();  // the pick is in every CTA
    const float4 p = s.pick;
    idx = __float_as_int(p.x);
    c0 = p.y;
    c1 = p.z;
    c2 = p.w;
    if (rank == 0 && tid == 0) {
      picks_all[(long)a * k + j] = idx;
      centers_all[((long)a * k + j) * 3] = c0;
      centers_all[((long)a * k + j) * 3 + 1] = c1;
      centers_all[((long)a * k + j) * 3 + 2] = c2;
    }
  }
}

// ---------------------------------------------------------------- the fit

struct FitShared {
  float cen[kMaxK * 3];              // the centres of this iteration
  float cen2[kMaxK];                 // |c|^2
  float next[kMaxK * 3];             // the centres of the next
  float move[kMaxK];                 // each centre's movement
  float warp_sum[kFitWarps][kMaxK * 3];
  int warp_cnt[kFitWarps][kMaxK];
  float warp_comp[kFitWarps];
  float part_sum[2][kMaxK * 3];      // this CTA's partial sums, double-buffered; peers read them
  int part_cnt[2][kMaxK];
  float part_comp;
  float tot_sum[kMaxK * 3];
  int tot_cnt[kMaxK];
  float shift;
};

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Nearest centre of x by _lloyd's expanded distance; the first minimum wins.
__device__ __forceinline__ int nearest(const float* cen, const float* cen2, int k, float x0, float x1, float x2,
                                       float& best_d) {
  const float sq = (x0 * x0 + x1 * x1) + x2 * x2;
  int best = 0;
  for (int c = 0; c < k; ++c) {
    const float dot = (x0 * cen[3 * c] + x1 * cen[3 * c + 1]) + x2 * cen[3 * c + 2];
    const float d = (sq - 2.0f * dot) + cen2[c];
    if (c == 0 || d < best_d) {
      best = c;
      best_d = d;
    }
  }
  return best;
}

// One cluster per attempt.  out: centers_all (attempts, k, 3), comp_all and
// iters_all (attempts,); the last attempt to finish (done counts them) writes
// the centres of the first attempt of least compactness to best (k, 3), zeros
// where no compactness is below infinity, and its index to best_idx.
__global__ void __launch_bounds__(kFitThreads)
    lloyd_fit(const float* __restrict__ sample, int n, int k, const float* __restrict__ init_all, int iters, float eps,
              float* __restrict__ centers_all, float* __restrict__ comp_all, int32_t* __restrict__ iters_all,
              int attempts, int* __restrict__ done, float* __restrict__ best, int32_t* __restrict__ best_idx) {
  __shared__ FitShared s;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int a = blockIdx.x / kCluster;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long first = (long)rank * kFitThreads + tid, stride = (long)kCluster * kFitThreads;

  if (tid < 3 * k) s.cen[tid] = init_all[(long)a * k * 3 + tid];
  __syncthreads();
  if (tid < k) s.cen2[tid] = (s.cen[3 * tid] * s.cen[3 * tid] + s.cen[3 * tid + 1] * s.cen[3 * tid + 1])
                             + s.cen[3 * tid + 2] * s.cen[3 * tid + 2];
  __syncthreads();

  float shift = CUDART_INF_F;
  int it = 0;
  while (shift > eps && it < iters) {
    const int buf = it & 1;
    float sum[kMaxK][3];
    int cnt[kMaxK];
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) {
      sum[c][0] = sum[c][1] = sum[c][2] = 0.0f;
      cnt[c] = 0;
    }
    for (long i = first; i < n; i += stride) {
      const float x0 = sample[3 * i], x1 = sample[3 * i + 1], x2 = sample[3 * i + 2];
      float d;
      const int b = nearest(s.cen, s.cen2, k, x0, x1, x2, d);
#pragma unroll
      for (int c = 0; c < kMaxK; ++c) {
        if (b == c) {
          sum[c][0] = sum[c][0] + x0;
          sum[c][1] = sum[c][1] + x1;
          sum[c][2] = sum[c][2] + x2;
          cnt[c] = cnt[c] + 1;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kMaxK; ++c) {
      if (c < k) {
        const float v0 = warp_sum_f(sum[c][0]), v1 = warp_sum_f(sum[c][1]), v2 = warp_sum_f(sum[c][2]);
        const int m = warp_sum_i(cnt[c]);
        if (lane == 0) {
          s.warp_sum[warp][3 * c] = v0;
          s.warp_sum[warp][3 * c + 1] = v1;
          s.warp_sum[warp][3 * c + 2] = v2;
          s.warp_cnt[warp][c] = m;
        }
      }
    }
    __syncthreads();
    if (tid < 3 * k) {
      float r = 0.0f;
      for (int v = 0; v < kFitWarps; ++v) r = r + s.warp_sum[v][tid];
      s.part_sum[buf][tid] = r;
    } else if (tid >= 32 && tid < 32 + k) {
      int m = 0;
      for (int v = 0; v < kFitWarps; ++v) m += s.warp_cnt[v][tid - 32];
      s.part_cnt[buf][tid - 32] = m;
    }
    cluster.sync();  // every CTA's partials of this iteration are in place
    if (tid < 3 * k) {
      float r = 0.0f;
      for (int q = 0; q < kCluster; ++q) r = r + cluster.map_shared_rank(&s.part_sum[buf][0], q)[tid];
      s.tot_sum[tid] = r;
    } else if (tid >= 32 && tid < 32 + k) {
      int m = 0;
      for (int q = 0; q < kCluster; ++q) m += cluster.map_shared_rank(&s.part_cnt[buf][0], q)[tid - 32];
      s.tot_cnt[tid - 32] = m;
    }
    __syncthreads();
    if (tid < k) {
      const int m = s.tot_cnt[tid];
      const float div = fmaxf((float)m, 1.0f);
      float e[3];
      for (int j = 0; j < 3; ++j) {
        const float old = s.cen[3 * tid + j];
        const float v = m > 0 ? s.tot_sum[3 * tid + j] / div : old;  // an empty cluster keeps its centre
        s.next[3 * tid + j] = v;
        e[j] = v - old;
      }
      s.move[tid] = sqrtf((e[0] * e[0] + e[1] * e[1]) + e[2] * e[2]);
    }
    __syncthreads();
    if (tid == 0) {
      float m = s.move[0];
      for (int c = 1; c < k; ++c) m = fmaxf(m, s.move[c]);
      s.shift = m;
    }
    if (tid < 3 * k) s.cen[tid] = s.next[tid];
    __syncthreads();
    if (tid < k) s.cen2[tid] = (s.cen[3 * tid] * s.cen[3 * tid] + s.cen[3 * tid + 1] * s.cen[3 * tid + 1])
                               + s.cen[3 * tid + 2] * s.cen[3 * tid + 2];
    shift = s.shift;
    ++it;
    __syncthreads();
  }

  // the compactness of the final centres
  float comp = 0.0f;
  for (long i = first; i < n; i += stride) {
    float d;
    nearest(s.cen, s.cen2, k, sample[3 * i], sample[3 * i + 1], sample[3 * i + 2], d);
    comp = comp + d;
  }
  comp = warp_sum_f(comp);
  if (lane == 0) s.warp_comp[warp] = comp;
  __syncthreads();
  if (tid == 0) {
    float r = 0.0f;
    for (int v = 0; v < kFitWarps; ++v) r = r + s.warp_comp[v];
    s.part_comp = r;
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float r = 0.0f;
    for (int q = 0; q < kCluster; ++q) r = r + *cluster.map_shared_rank(&s.part_comp, q);
    for (int j = 0; j < 3 * k; ++j) centers_all[(long)a * k * 3 + j] = s.cen[j];
    comp_all[a] = r;
    iters_all[a] = it;
    __threadfence();
    if (atomicAdd(done, 1) == attempts - 1) {
      __threadfence();
      const volatile float* comps = comp_all;
      const volatile float* cens = centers_all;
      float best_comp = CUDART_INF_F;
      int pick = -1;
      for (int q = 0; q < attempts; ++q) {
        if (comps[q] < best_comp) {  // strict: the first of equal attempts wins
          best_comp = comps[q];
          pick = q;
        }
      }
      for (int j = 0; j < 3 * k; ++j) best[j] = pick < 0 ? 0.0f : cens[(long)pick * k * 3 + j];
      *best_idx = pick;
    }
  }
  cluster.sync();  // no CTA leaves while rank 0 may still read its partial
}

// labels[i] = the nearest of the k centres to point i, by the fit's distance.
__global__ void assign_points(const float* __restrict__ data, long n, const float* __restrict__ centers, int k,
                              int32_t* __restrict__ labels) {
  extern __shared__ float cen_s[];  // (k, 3), then |c|^2 (k,)
  float* cen2_s = cen_s + 3 * k;
  for (int j = threadIdx.x; j < 3 * k; j += blockDim.x) cen_s[j] = centers[j];
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x)
    cen2_s[c] = (cen_s[3 * c] * cen_s[3 * c] + cen_s[3 * c + 1] * cen_s[3 * c + 1]) + cen_s[3 * c + 2] * cen_s[3 * c + 2];
  __syncthreads();
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    float d;
    labels[i] = nearest(cen_s, cen2_s, k, data[3 * i], data[3 * i + 1], data[3 * i + 2], d);
  }
}

}  // namespace

extern "C" {

// out (n, 3) float32 = Lab of pixel idx[i] (int32; pixel i where idx is null)
// of the BGR bytes.  Returns a CUDA error code (0 on success).
int pw_lab_sample(const uint8_t* bgr, const int32_t* idx, float* out, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  lab_sample<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(bgr, idx, out, n);
  return (int)cudaGetLastError();
}

// The subsample of n pixels: the `limit` pixels of least key draw_key(i, a,
// b), written to out (limit,) int32 in increasing index order; 1 <= limit <
// n.  scratch: 3 * 2048 + 1024 uint32 words (three rounds' histograms, then a
// count a CTA).  Makes a memset and one cooperative launch.  Returns a CUDA
// error code.
int pw_subsample(int n, int limit, unsigned a, unsigned b, int32_t* out, uint32_t* scratch, void* stream) {
  if (n < 2 || limit < 1 || limit >= n) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(uint32_t) * 3 * kDigits, s);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, subsample_draw, kDrawThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long grid = (long)sms * per_sm;
  grid = grid < kDrawThreads ? grid : kDrawThreads;
  const long tiles = ((long)n + kDrawThreads - 1) / kDrawThreads;
  grid = grid < tiles ? grid : tiles;
  if (grid < 1) return (int)cudaErrorInvalidConfiguration;
  long chunk = ((tiles + grid - 1) / grid) * kDrawThreads;  // whole tiles a CTA
  grid = ((long)n + chunk - 1) / chunk;
  uint32_t* hist = scratch;
  int* counts = reinterpret_cast<int*>(scratch + 3 * kDigits);
  void* args[] = {&n, &limit, &a, &b, &chunk, &hist, &counts, &out};
  err = cudaLaunchCooperativeKernel((const void*)subsample_draw, dim3((unsigned)grid), dim3(kDrawThreads), args, 0, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// k-means++ seeds of `attempts` attempts on sample (n, 3), n < 2^27: first
// (attempts,) int32 indices, uniforms (attempts, k - 1) float32 in [0, 1] ->
// centers (attempts, k, 3) and picks (attempts, k), the chosen indices.  One
// cluster of kCluster CTAs an attempt; resident (nonzero): each CTA holds its
// rows and their d2 in shared memory, else d2 (attempts, n) float32 is
// scratch in device memory.  Returns a CUDA error code.
int pw_kpp_init(const float* sample, int n, int k, int attempts, const int32_t* first, const float* uniforms,
                float* d2, float* centers, int32_t* picks, int resident, void* stream) {
  if (n <= 0 || n >= (1 << 27) || k <= 0 || attempts <= 0 || (!resident && d2 == nullptr))
    return (int)cudaErrorInvalidValue;
  int rows = (n + kCluster - 1) / kCluster, tiles = (rows + kInitThreads - 1) / kInitThreads;
  const size_t smem = sizeof(unsigned long long) * (size_t)tiles + (resident ? 16 * (size_t)rows : 0);
  if (smem + sizeof(InitShared) > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const void* kernel = resident ? (const void*)kpp_init<true> : (const void*)kpp_init<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(attempts * kCluster));
  cfg.blockDim = dim3(kInitThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&sample, &n, &k, &rows, &tiles, &first, &uniforms, &d2, &centers, &picks};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The Lloyd fits of `attempts` attempts from init (attempts, k, 3), k <= 8, in
// one launch -> centers (attempts, k, 3), comp and iters (attempts,), and the
// best attempt's centres in best (k, 3) and its index in best_idx; done is an
// int of scratch (zeroed here).  Returns a CUDA error code.
int pw_lloyd_fit(const float* sample, int n, int k, int attempts, const float* init, int iters, float eps,
                 float* centers, float* comp, int32_t* iters_out, int* done, float* best, int32_t* best_idx,
                 void* stream) {
  if (n <= 0 || k <= 0 || k > kMaxK || attempts <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(lloyd_fit, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(attempts * kCluster));
  cfg.blockDim = dim3(kFitThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&sample, &n, &k, &init, &iters, &eps, &centers, &comp, &iters_out, &attempts, &done, &best,
                  &best_idx};
  err = cudaLaunchKernelExC(&cfg, (const void*)lloyd_fit, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// labels (n,) int32 = the nearest of centers (k, 3) to each row of data (n,
// 3), by the expanded distance, first minimum.  Returns a CUDA error code.
int pw_assign_points(const float* data, long n, const float* centers, int k, int32_t* labels, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 4 * (size_t)k;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long blocks = (n + 255) / 256;
  assign_points<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, smem, static_cast<cudaStream_t>(stream)>>>(
      data, n, centers, k, labels);
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
