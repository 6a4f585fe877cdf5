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
//   in clusters of 8 CTAs of 1,024 threads (as many clusters as the card
//   holds at once, at most 32), CTA q owning the pixels [q chunk, (q + 1)
//   chunk); three passes over the pixels, each hashing every key once, and
//   two grid barriers:
//   1. the histogram of the top digit (bits 21-31) in shared memory; the
//      cluster's 8 histograms merged through distributed shared memory, each
//      rank a 256-bin slice (keeping, for each of its bins, the ranks'
//      exclusive prefix), stored as the cluster's row with its 64 coarse
//      sums: no atomic in device memory, nothing to zero before the launch;
//      barrier 1;
//   2. every CTA reads the clusters' coarse sums, then their counts of the
//      one coarse bucket's 32 bins, which give the bucket B of the limit-th
//      least key, its rank inside B, the keys of B and this CTA's first slot
//      in the candidate list (the clusters before it, then the ranks before
//      it); then it counts its keys below B and writes its keys in B, as
//      (key bits 0-20) << 10 | q, to its slots of the list; barrier 2;
//   3. every CTA finds the exact limit-th least key K among the candidates
//      (copied into shared memory where they fit, 16,384 words, else read
//      in place; at most 2^21, since no two keys are equal): the second
//      digit (bits 10-20) by a histogram, then the third (bits 0-9) over
//      the at most 1,024 keys of the second digit's bucket; each CTA's
//      output base is its keys below B and its candidates up to K, summed
//      over the CTAs before it, so no third barrier; then it writes the
//      indices of its keys <= K in index order, runs of up to 16 pixels a
//      thread kept as bits of a word, one CTA-wide scan a round of 16 x
//      1,024 pixels, each round's indices staged in shared memory and
//      stored coalesced.
// - pw_lab_sample: gathers `n` pixels of a BGR image by index and converts
//   them to float Lab with lab.cuh's arithmetic, K7's bit for bit (this file
//   is compiled with --fmad=false like K7).  Its bound is the bytes it must
//   move: the distinct 32-byte sectors that the gathered pixels touch (about
//   half of a 3,000,000-pixel image's sectors for a 200,000-pixel sample), the
//   indices and the (n, 3) float32 output.  Its time is a chain: the indices,
//   then the gathers, then the Lab of every pixel, then the store.  So it is
//   built as K7 is: the gamma of a byte, gamma_inv(b / 255), is a
//   256-entry table in shared memory filled by that very device function (the
//   same bits), so no powf is left a pixel; the grid is only the CTAs the
//   device holds at once, each striding over chunks of kSampleChunk pixels; a
//   quarter of the threads gather a chunk, each loading four indices as one
//   int4 and issuing the eight word loads that hold their pixels' bytes before
//   it uses any, while the other warps fill the table; then every thread
//   converts one pixel (the Lab's dependent chains want many warps in
//   flight); the chunk's Lab is staged in shared memory and written as
//   16-byte vectors.  With no indices a chunk's bytes are read as K7 reads
//   them, 16-byte vectors into shared memory.
// - pw_kmeans_fit: the device mode's seeds and fits of every attempt in ONE launch (kernel kmeans_fit), one
//   thread block cluster of 16 CTAs of 512 threads per attempt; CTA r owns rows [r P, (r + 1) P), P = ceil(n /
//   16).  The rows are loaded once into shared memory where they fit (the resident route: three columns,
//   xs[c P + r], and a d2 column, 16 bytes a row; 231,696 rows, ops/kernels.py::kpp_schedule), else read each
//   draw and pass, 4,096 rows at a time, through a stage in shared memory by coalesced loads (the streamed
//   route, d2 in device scratch).  Then, over the same rows:
//   * the k-means++ seeds: the first centre by a given index, then k - 1 draws, each the first row i whose
//     running sum R(i) of the integer weights w = max(floor(d2 2^16), 1) (at most 2^36) exceeds target =
//     floor(total u) (the last row where none does: u = 1), d2 = (e0^2 + e1^2) + e2^2 in float32 the squared
//     distance to the nearest centre so far, updated by min.  The random numbers come from the host (one index
//     and k - 1 uniforms per attempt, packed in `draws`).  Integer sums are exact in any order, so the picks
//     depend on no order of additions (ops/kmeans.py::kpp_init_plain: cumsum and searchsorted); target is exact
//     (kpp_target).  Overflow: w < 2^36 and n < 2^27, so every sum is below 2^63; the cap binds only where d2 >=
//     2^20 (a distance of 1,024; Lab in OpenCV's 8-bit scaling has d2 < 3 * 255^2 < 2^18), and the wrappers
//     refuse n >= 2^27.  A draw: every thread updates its rows' d2 and w, one row a thread and tile, a warp sums
//     its w (two redux.sync, of the low and the high 18 bits) and adds both sums to its tile's (32-bit
//     shared-memory atomics), the CTA sums its tiles and stores its total into every peer (distributed shared
//     memory); one cluster.sync(); every CTA sums the 16 totals in rank order to its offset and the grand total,
//     and computes target; only the CTA whose range holds target searches: warp 0 finds the tile from the tile
//     totals, the CTA rescans that one tile (one scan), and thread 0 stores the pick and its row into every
//     peer; one cluster.sync();
//   * the Lloyd loop of every attempt, with the stop test on the device (a launch and a flag read per iteration
//     would be host-bound: up to 40 iterations x 3 attempts); d2 is dead after the last draw, and the fit's
//     scratch takes its place;
//   * the choice of the best attempt by the last cluster to finish.  No host read anywhere.
// - pw_lloyd_fit: the same fit body (kernel lloyd_fit) from seeds given by the host: the tools' kmeans().
// - pw_assign_points: the all-point assignment of ops/kmeans.py::kmeans, by the fit's distance.
//
// The fit.  The kernels are instantiated on k (1 to 8), so a point costs k centres; the centres and |c|^2 stay in
// registers for the whole pass.  Distances are |x|^2 - 2 x.c + |c|^2 in float32 as _lloyd's, each three-term
// sum as (a + b) + c, first minimum wins, an empty cluster keeps its centre, shift = the largest centre
// movement, loop while shift > eps and it < iters, then one more assignment for the compactness (sum of the
// minimal d2, which this expanded form can make slightly negative: kept, it decides which attempt wins).  No
// TF32, no FMA, no float atomics.  Every float sum has a fixed order, the same on every run, so a seed gives the
// same centres every time:
//   1. a thread adds its rows in order, r = tid, tid + 512, ... of its CTA's range;
//   2. a warp: lane l adds lane l + o's value for o = 16, 8, 4, 2, 1 (__shfl_down_sync), lane 0 keeps it;
//   3. a CTA: its 16 warps' values by the same tree over 16 lanes (o = 8, 4, 2, 1, lane w holding warp w's);
//   4. the cluster: the 16 CTAs' values, read through distributed shared memory by 16 lanes at once (lane q from
//      CTA q), by the same 16-lane tree.
// The counts are integers.  In every CTA the first k threads then compute the new centres from the same totals
// (each division and square root in IEEE float32), and every thread reads them, so every CTA takes the same
// stop decision.  The CTAs' partials are double-buffered, which makes one cluster.sync() a
// pass enough.
//
// Bound.  The fit: about 9 float operations per centre, point and pass.  The seeding: 12 bytes a row read once;
// its chain of two cluster barriers a draw binds it.  Together: the sample read once (12 bytes a row) against
// the seeding's and the fit's operations.  A cooperative grid over all SMs would scan faster but pay a grid-wide
// barrier a pass; three attempts already run side by side on 48 SMs.  The draw: the hash once a key, n x about
// 10 integer operations (3e7 at 3,000,000 pixels, 1.8 us at the INT32 peak), against 0.8 MB written (0.24 us);
// the kernel hashes each key three times, and its two grid barriers and the reads after them are latency, not
// work.  On an H100 the times are in PERF.md.
//
// Built with -DPW_KMEANS_PHASES, kmeans_fit and lloyd_fit record CTA 0's clock64 cycles for the row load, each
// draw, each pass's scan and its reduction and barrier, and the compactness (phase_cycles, pw_kmeans_phases);
// subsample_draw records them for each of its passes, merges, barriers and selections (draw_cycles,
// pw_draw_phases), and lab_sample the stages of its first chunk (sample_cycles, pw_sample_phases).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "lab.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 8;           // centres a fit holds in registers (a template parameter, 1 to 8)
constexpr int kCluster = 16;       // CTAs per attempt (a non-portable cluster size)
constexpr int kThreads = 512;      // threads per CTA of the seeds and fits: a tile is one row a thread
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVals = 4 * kMaxK;  // the sums of a Lloyd pass: 3 k coordinates, then k counts
constexpr int kStageTiles = 8;     // the streamed route's stage: 8 tiles of rows copied at once
constexpr int kStageRows = kStageTiles * kThreads;
// the fit's shared scratch (bytes): the warps' partials, the CTA's (double-buffered) and the cluster's totals,
// and the new centres (x, y, z, |c|^2 and the movement of each)
constexpr int kFitScratch = 4 * (kMaxVals * kWarps + 3 * kMaxVals + 5 * kMaxK);
constexpr int kStaticSmem = 512;   // a bound on either fit kernel's static shared memory
constexpr int kDrawThreads = 1024;  // threads per CTA of the draw; also the most CTAs it takes
constexpr int kDrawWarps = kDrawThreads / 32;
constexpr int kDrawCluster = 8;     // CTAs a cluster of the draw, which merge their histograms
constexpr int kMaxDrawClusters = 32;  // an H100 holds 30 clusters of the draw at once
constexpr int kDigits = 2048;       // the top digit's buckets (key bits 21-31); also the second digit's (10-20)
constexpr int kOwnBins = kDigits / kDrawCluster;  // the bins each rank of a cluster merges
constexpr int kCoarse = 64, kFine = kDigits / kCoarse;  // the top digit read back in two levels
constexpr int kRowWords = kDigits + kCoarse;  // a cluster's row in device memory: its bins, then its coarse bins
constexpr int kListCap = 16384;     // candidates copied into shared memory for the selection (else read in place)
constexpr int kRun = 16;            // the compaction's pixels a thread and round, kRun x kDrawThreads <= kListCap
constexpr int kMaxSmem = 232448;    // 227 KB, the opt-in limit of one CTA

constexpr int kSampleThreads = 512;  // the sampler's threads a CTA: a chunk's pixels, one a thread
constexpr int kSamplePer = 4;                      // a loader's pixels: one int4 of indices
constexpr int kSampleChunk = kSampleThreads;
constexpr int kSampleLoaders = kSampleChunk / kSamplePer;
constexpr int kSampleVecs = 3 * kSampleChunk / 16 + 2;  // 16-byte vectors over a chunk's bytes at any alignment

#ifdef PW_KMEANS_PHASES
// CTA 0's thread 0 (a loader) on its first chunk: the cycles until its
// indices are in (its gathers issued), until its pixels' words are in, until
// the chunk's pixels and the gamma table are (the barrier), of its Lab and
// the stage's barrier, of the store; the total.
constexpr int kSampleSlots = 8;
__device__ unsigned long long sample_cycles[kSampleSlots];
// Every CTA's thread 0: %globaltimer (ns) at its start and its end.
constexpr int kSampleTimed = 4096;
__device__ unsigned long long sample_ns[kSampleTimed][2];
__device__ __forceinline__ unsigned long long sample_clock_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PW_SAMPLE_MARK(slot)                                 \
  if (clock_on) {                                            \
    const unsigned long long now = clock64();                \
    sample_cycles[slot] = now - stamp;                       \
    stamp = now;                                             \
  }
#else
#define PW_SAMPLE_MARK(slot)
#endif

// out (n, 3) float32 = the Lab of pixel idx[i] (pixel i where idx is null) of
// the BGR bytes of px pixels, the CTAs striding over chunks of kSampleChunk
// pixels.  With indices, the first kSampleLoaders threads gather a chunk: each
// loads four indices as one int4 and then the two aligned words that hold each
// pixel's three bytes, all eight loads issued before any is used, while the
// other warps fill the gamma table; every thread then converts one pixel.
__global__ void __launch_bounds__(kSampleThreads)
    lab_sample(const uint8_t* __restrict__ bgr, const int32_t* __restrict__ idx, float* __restrict__ out, int n,
               long px) {
  __shared__ float gamma_s[256];
  __shared__ uint32_t bgr_s[kSampleChunk];       // a pixel's B | G << 8 | R << 16
  __shared__ __align__(16) float out_s[3 * kSampleChunk];  // the chunk's Lab, 3 floats a pixel
  __shared__ uint4 px_v[kSampleVecs];            // with no indices: the chunk's bytes
  const int tid = threadIdx.x;
  const uint8_t* px_s = reinterpret_cast<const uint8_t*>(px_v);
  const int n_chunks = (n + kSampleChunk - 1) / kSampleChunk;
  const bool idx_vectors = idx != nullptr && ((uintptr_t)idx & 15) == 0;
  bool have_table = false;
#ifdef PW_KMEANS_PHASES
  bool clock_on = blockIdx.x == 0 && tid == 0;
  unsigned long long stamp = clock64();
  const unsigned long long start = stamp, ns0 = sample_clock_ns();
#endif
  for (int chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long p0 = (long)chunk * kSampleChunk;
    const int m = (int)min((long)kSampleChunk, (long)n - p0);
    if (idx != nullptr) {
      if (tid < kSampleLoaders) {
        const int q = kSamplePer * tid;
        int ix[kSamplePer];
        if (idx_vectors && q + kSamplePer <= m) {
          const int4 v = *reinterpret_cast<const int4*>(idx + p0 + q);
          ix[0] = v.x;
          ix[1] = v.y;
          ix[2] = v.z;
          ix[3] = v.w;
        } else {
#pragma unroll
          for (int j = 0; j < kSamplePer; ++j) ix[j] = q + j < m ? idx[p0 + q + j] : -1;
        }
        // the aligned words that hold bytes 3i and 3i + 2 (the same word or the
        // next), every load issued before any is used; a pixel whose words would
        // reach outside the image's bytes (its first or last pixel, where the
        // image does not start or end on a word) loads no word and is read byte
        // by byte after the others' loads are issued
        const uintptr_t lo_end = (uintptr_t)bgr, hi_end = (uintptr_t)(bgr + 3 * px);
        uint32_t lo[kSamplePer], hi[kSamplePer];
        bool inside[kSamplePer];
#pragma unroll
        for (int j = 0; j < kSamplePer; ++j) {
          const uintptr_t a = (uintptr_t)(bgr + 3 * (long)(ix[j] < 0 ? 0 : ix[j]));
          const uintptr_t w0 = a & ~(uintptr_t)3, w1 = (a + 2) & ~(uintptr_t)3;
          inside[j] = w0 >= lo_end && w1 + 4 <= hi_end;
          lo[j] = inside[j] ? *reinterpret_cast<const uint32_t*>(w0) : 0u;
          hi[j] = inside[j] ? *reinterpret_cast<const uint32_t*>(w1) : 0u;
        }
        PW_SAMPLE_MARK(0);
#pragma unroll
        for (int j = 0; j < kSamplePer; ++j) {
          const uint8_t* p = bgr + 3 * (long)(ix[j] < 0 ? 0 : ix[j]);
          bgr_s[q + j] = inside[j] ? __funnelshift_r(lo[j], hi[j], 8 * (unsigned)((uintptr_t)p & 3))
                                   : (uint32_t)p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
        }
        PW_SAMPLE_MARK(1);
      }
    } else {
      const uint8_t* first = bgr + 3 * p0;
      const int mis = (int)((uintptr_t)first & 15);
      const uint8_t* end = bgr + 3 * (long)n;
      for (int v = tid; v < (mis + 3 * m + 15) / 16; v += kSampleThreads) {
        const uint8_t* g = first - mis + 16 * v;  // 16-byte aligned
        if (g >= bgr && g + 16 <= end) {
          px_v[v] = *reinterpret_cast<const uint4*>(g);
        } else {
          uint8_t* s = reinterpret_cast<uint8_t*>(px_v) + 16 * v;
          for (int b = 0; b < 16; ++b)
            if (g + b >= bgr && g + b < end) s[b] = g[b];
        }
      }
    }
    if (!have_table) {  // at the CTA's first chunk, on the warps that gather nothing
      const int first = idx != nullptr ? kSampleLoaders : 0;
      for (int i = tid - first; i >= 0 && i < 256; i += kSampleThreads - first)
        gamma_s[i] = pw_lab::gamma_inv((float)i / 255.0f);
      have_table = true;
    }
    __syncthreads();
    PW_SAMPLE_MARK(2);
    if (tid < m) {
      uint32_t v;
      if (idx != nullptr) {
        v = bgr_s[tid];
      } else {
        const uint8_t* b = px_s + ((uintptr_t)(bgr + 3 * p0) & 15) + 3 * tid;
        v = (uint32_t)b[0] | (uint32_t)b[1] << 8 | (uint32_t)b[2] << 16;
      }
      pw_lab::lab_from_linear(gamma_s[(v >> 16) & 255u], gamma_s[(v >> 8) & 255u], gamma_s[v & 255u], out_s[3 * tid],
                              out_s[3 * tid + 1], out_s[3 * tid + 2]);
    }
    __syncthreads();
    PW_SAMPLE_MARK(3);
    float* dst = out + 3 * p0;  // 16-byte aligned: 12 kSampleChunk bytes a chunk from an aligned output
    const int vecs = 3 * m / 4;
    for (int v = tid; v < vecs; v += kSampleThreads)
      reinterpret_cast<uint4*>(dst)[v] = reinterpret_cast<const uint4*>(out_s)[v];
    for (int i = 4 * vecs + tid; i < 3 * m; i += kSampleThreads) dst[i] = out_s[i];
    PW_SAMPLE_MARK(4);
#ifdef PW_KMEANS_PHASES
    if (clock_on) sample_cycles[6] = clock64() - start;
    clock_on = false;
#endif
    __syncthreads();  // the shared arrays are written again by the next chunk
  }
#ifdef PW_KMEANS_PHASES
  if (tid == 0 && blockIdx.x < kSampleTimed) {
    sample_ns[blockIdx.x][0] = ns0;
    sample_ns[blockIdx.x][1] = sample_clock_ns();
  }
#endif
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

#ifdef PW_KMEANS_PHASES
// CTA 0's thread 0: the clock64 cycles of each phase of the last draw (slots named in chip_smoke.py::DRAW_PHASES),
// and the whole launch in slot kDrawTotal.
constexpr int kDrawSlots = 16, kDrawTotal = 15;
__device__ unsigned long long draw_cycles[kDrawSlots];
struct DrawClock {
  unsigned long long start, t;
  __device__ __forceinline__ void begin() { start = t = clock64(); }
  __device__ __forceinline__ void mark(int slot) {
    const unsigned long long now = clock64();
    if (blockIdx.x == 0 && threadIdx.x == 0) draw_cycles[slot] = now - t;
    t = now;
  }
  __device__ __forceinline__ void total() {
    if (blockIdx.x == 0 && threadIdx.x == 0) draw_cycles[kDrawTotal] = clock64() - start;
  }
};
#else
struct DrawClock {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void total() {}
};
#endif

static_assert(kMaxDrawClusters * kFine <= kDrawThreads, "a thread a cluster's fine count");
static_assert(kRun * kDrawThreads <= kListCap && kRun <= 32, "a compaction round's stage and bits");

// The draw's shared memory (dynamic): the histogram of pass 1 (kept until the peers of its cluster have merged
// it), the exclusive prefixes over the cluster's ranks of the bins this CTA merges, the coarse and fine counts
// read back after the first barrier, and the selection's histograms, tallies, sub-bucket and list copy.
struct DrawSmem {
  uint32_t hist[kDigits];              // pass 1: the top digit's histogram; after barrier 2: the second digit's
  uint32_t prefix[kDigits];            // prefix[r kOwnBins + j]: ranks < r's count of this CTA's j-th merged bin
  uint32_t fine[kMaxDrawClusters * kFine];  // after barrier 1: each cluster's counts of the coarse bucket's bins
  uint32_t coarse[kCoarse];
  uint32_t fine_tot[kFine];
  uint32_t tally[kDrawThreads];        // tally[q]: CTA q's candidates <= K
  uint32_t sub[1024];                  // the candidates of the sub-bucket (at most 1,024 distinct keys)
  uint32_t list[kListCap];             // the candidates, where they fit
  int slots[kDrawWarps];
  int found[4];
  uint32_t count;                      // pass 2: the list's cursor; the selection: the sub-bucket's
  uint32_t below;                      // this CTA's keys below the bucket
};

// The first bin of counts[0, bins) (bins = 32 or 64) whose running count reaches need, by warp 0:
// found[0] = the bin, found[1] = the count below it.  The caller syncs before reading found.
__device__ __forceinline__ void warp_find_bin(const uint32_t* counts, int bins, int need, int* found) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x, per = bins / 32;
  int own = 0;
  for (int j = 0; j < per; ++j) own += (int)counts[lane * per + j];
  const int incl = warp_inclusive_scan(own);
  int run = incl - own;
  if (run < need && need <= incl)
    for (int j = 0; j < per; ++j) {
      const int c = (int)counts[lane * per + j];
      if (run < need && need <= run + c) {
        found[0] = lane * per + j;
        found[1] = run;
      }
      run += c;
    }
}

// The same over counts[0, bins) with bins = 1,024 or 2,048, by the whole CTA (every thread calls it).
__device__ __forceinline__ void block_find_bin(const uint32_t* counts, int bins, int need, int* slots, int* found) {
  const int per = bins / kDrawThreads, tid = threadIdx.x;
  int own = 0;
  for (int j = 0; j < per; ++j) own += (int)counts[tid * per + j];
  int all;
  int run = block_exclusive_scan<int, kDrawWarps>(own, slots, all);
  if (run < need && need <= run + own)
    for (int j = 0; j < per; ++j) {
      const int c = (int)counts[tid * per + j];
      if (run < need && need <= run + c) {
        found[0] = tid * per + j;
        found[1] = run;
      }
      run += c;
    }
  __syncthreads();
}

// One cooperative launch in clusters of kDrawCluster CTAs; CTA q owns the pixels [q chunk, (q + 1) chunk).
// rows: a row of kRowWords words a cluster (its counts of the top digit's bins, then of the coarse bins);
// belows: a count a CTA; list: at most min(n, 2^21) candidates.  Nothing needs to be zeroed.
__global__ void __launch_bounds__(kDrawThreads, 2)
    subsample_draw(int n, int limit, uint32_t a, uint32_t b, long chunk, uint32_t* __restrict__ rows,
                   int* __restrict__ belows, uint32_t* __restrict__ list, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char draw_dyn[];
  DrawSmem& s = *reinterpret_cast<DrawSmem*>(draw_dyn);
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, rank = (int)cluster.block_rank(), cid = blockIdx.x / kDrawCluster;
  const int clusters = gridDim.x / kDrawCluster;
  // pixel indices as unsigned: n < 2^31, so an index plus a stride never wraps
  const uint32_t lo = (uint32_t)min((long)blockIdx.x * chunk, (long)n), hi = (uint32_t)min(lo + chunk, (long)n);
  DrawClock clk;
  clk.begin();

  // pass 1: every key hashed, the histogram of its top digit (bits 21-31) in shared memory
  for (int j = tid; j < kDigits; j += kDrawThreads) s.hist[j] = 0;
  if (tid < kCoarse) s.coarse[tid] = 0;
  if (tid < kFine) s.fine_tot[tid] = 0;
  if (tid == 0) s.count = s.below = 0;
  __syncthreads();
  for (uint32_t i = lo + tid; i < hi; i += kDrawThreads) atomicAdd(&s.hist[draw_key(i, a, b) >> 21], 1u);
  clk.mark(0);
  // the cluster's histograms merged through distributed shared memory: rank r takes bins [r kOwnBins, (r + 1)
  // kOwnBins), a thread a bin, the ranks' counts in rank order; one store a bin and cluster, one a coarse bin
  cluster.sync();
  if (tid < kOwnBins) {
    const int j = rank * kOwnBins + tid;
    uint32_t v[kDrawCluster];
#pragma unroll
    for (int r = 0; r < kDrawCluster; ++r) v[r] = cluster.map_shared_rank(s.hist, r)[j];
    uint32_t run = 0;
#pragma unroll
    for (int r = 0; r < kDrawCluster; ++r) {
      s.prefix[r * kOwnBins + tid] = run;
      run += v[r];
    }
    rows[(long)cid * kRowWords + j] = run;
    const uint32_t coarse = warp_sum(run);  // a warp's 32 bins are one coarse bin
    if ((tid & 31) == 0) rows[(long)cid * kRowWords + kDigits + j / kFine] = coarse;
  }
  clk.mark(1);
  grid.sync();  // barrier 1: every cluster's row stored, every peer's histogram read
  clk.mark(2);

  // the bucket B of the limit-th least key: the coarse bin from every cluster's coarse row, then the bin inside
  // it from every cluster's fine counts of it.  The keys are uniform, so the coarse bin is almost always the one
  // where limit / n falls: its fine counts are read beside the coarse rows, and read again only where it is not
  const int guess = (int)((double)limit / n * kCoarse);
  auto fine_at = [&](int j, int bin) { return __ldcg(rows + (long)(j / kFine) * kRowWords + bin * kFine + j % kFine); };
  const uint32_t early = tid < clusters * kFine ? fine_at(tid, guess) : 0u;
  for (int j = tid; j < clusters * kCoarse; j += kDrawThreads)
    atomicAdd(&s.coarse[j % kCoarse], __ldcg(rows + (long)(j / kCoarse) * kRowWords + kDigits + j % kCoarse));
  __syncthreads();
  warp_find_bin(s.coarse, kCoarse, limit, s.found);
  __syncthreads();
  const int cbin = s.found[0];
  int need = limit - s.found[1];
  if (tid < clusters * kFine) {
    const uint32_t v = cbin == guess ? early : fine_at(tid, cbin);
    s.fine[tid] = v;
    atomicAdd(&s.fine_tot[tid % kFine], v);
  }
  __syncthreads();
  warp_find_bin(s.fine_tot, kFine, need, s.found + 2);
  __syncthreads();
  const int fbin = s.found[2];
  const uint32_t B = (uint32_t)(cbin * kFine + fbin);
  need -= s.found[3];  // the rank of the limit-th least key among the bucket's keys
  // this CTA's first slot in the list: the bucket's keys of the clusters before it, then of the ranks before it
  // (the prefix kept by the rank that merged bin B)
  int first = 0, total = 0;
  if (tid < 32) {
    for (int c = tid; c < clusters; c += 32) {
      const int v = (int)s.fine[c * kFine + fbin];
      total += v;
      first += c < cid ? v : 0;
    }
    total = warp_sum(total);
    first = warp_sum(first);
  }
  if (tid == 0) {
    s.found[0] = first + (int)cluster.map_shared_rank(s.prefix, (int)(B / kOwnBins))[rank * kOwnBins + B % kOwnBins];
    s.found[1] = total;
  }
  __syncthreads();
  first = s.found[0];
  const int m = s.found[1];  // the candidates of the whole grid
  clk.mark(3);

  // pass 2: every key hashed again; count the keys below the bucket, gather the bucket's keys
  int below = 0;
  for (uint32_t i = lo + tid; i < hi; i += kDrawThreads) {
    const uint32_t key = draw_key(i, a, b), d = key >> 21;
    below += d < B;
    if (d == B) list[first + atomicAdd(&s.count, 1u)] = (key & 0x1fffffu) << 10 | blockIdx.x;
  }
  below = warp_sum(below);
  if ((tid & 31) == 0) atomicAdd(&s.below, (uint32_t)below);
  for (int j = tid; j < kDigits; j += kDrawThreads) s.hist[j] = 0;  // the peers read it before barrier 1
  s.tally[tid] = 0;
  __syncthreads();
  if (tid == 0) {
    belows[blockIdx.x] = (int)s.below;
    s.count = 0;
  }
  clk.mark(4);
  grid.sync();  // barrier 2: every candidate gathered, every count stored
  clk.mark(5);

  // the exact limit-th least key K among the m candidates (each (key bits 0-20) << 10 | its CTA), by their second
  // digit (key bits 10-20), then their third (bits 0-9) over the at most 1,024 keys of the second digit's bucket;
  // read from shared memory where the list fits, else from device memory
  const bool resident = m <= kListCap;
  for (int j = tid; j < m; j += kDrawThreads) {
    const uint32_t w = __ldcg(list + j);
    if (resident) s.list[j] = w;
    atomicAdd(&s.hist[(w >> 20) & 0x7ffu], 1u);
  }
  __syncthreads();
  auto cand = [&](int j) { return resident ? s.list[j] : __ldcg(list + j); };
  block_find_bin(s.hist, kDigits, need, s.slots, s.found);
  const uint32_t B2 = (uint32_t)s.found[0];
  need -= s.found[1];
  for (int j = tid; j < m; j += kDrawThreads) {
    const uint32_t w = cand(j), d2 = (w >> 20) & 0x7ffu;
    if (d2 < B2) atomicAdd(&s.tally[w & 0x3ffu], 1u);
    else if (d2 == B2) s.sub[atomicAdd(&s.count, 1u)] = w;
  }
  __syncthreads();
  // the sub-bucket's keys differ in bits 0-9 alone: each one's rank among them by counting (about one key at
  // the main path's size; 1,024 at most)
  const int subs = (int)s.count;
  if (tid < subs) {
    const uint32_t w = s.sub[tid], low = (w >> 10) & 0x3ffu;
    int r = 0;
    for (int j = 0; j < subs; ++j) r += ((s.sub[j] >> 10) & 0x3ffu) < low;
    if (r + 1 == need) s.found[0] = (int)low;
    if (r < need) atomicAdd(&s.tally[w & 0x3ffu], 1u);
  }
  __syncthreads();
  const uint32_t B3 = (uint32_t)s.found[0];
  const uint32_t K = B << 21 | B2 << 10 | B3;
  clk.mark(6);
  // thread q stands for CTA q (gridDim.x <= kDrawThreads): its keys <= K, those below the bucket and its tally
  int all;
  const int q_base = block_exclusive_scan<int, kDrawWarps>(
      tid < (int)gridDim.x ? __ldcg(belows + tid) + (int)s.tally[tid] : 0, s.slots, all);
  if (tid == (int)blockIdx.x) s.found[0] = q_base;
  __syncthreads();
  int base = s.found[0];
  clk.mark(7);

  // pass 3: the compaction in index order, runs of up to kRun pixels a thread (a taken pixel one bit of a
  // word), one CTA-wide scan a round of up to kRun x kDrawThreads pixels; the round's indices staged in shared
  // memory (the list's copy, dead now) and stored coalesced
  for (uint32_t r0 = lo; r0 < hi; r0 += kRun * kDrawThreads) {
    const uint32_t len = min(hi - r0, (uint32_t)kRun * kDrawThreads), per = (len + kDrawThreads - 1) / kDrawThreads;
    const uint32_t s0 = r0 + tid * per, run = s0 < r0 + len ? min(per, r0 + len - s0) : 0u;
    uint32_t taken = 0;
#pragma unroll 4
    for (uint32_t j = 0; j < run; ++j) taken |= (uint32_t)(draw_key(s0 + j, a, b) <= K) << j;
    int round;
    int o = block_exclusive_scan<int, kDrawWarps>(__popc(taken), s.slots, round);
    for (; taken; taken &= taken - 1) s.list[o++] = s0 + __ffs((int)taken) - 1;
    __syncthreads();
    for (int j = tid; j < round; j += kDrawThreads) out[base + j] = (int32_t)s.list[j];
    base += round;
    __syncthreads();  // the stage is written again in the next round
  }
  clk.mark(8);
  clk.total();
}

// ------------------------------------------------------- the seeds and fits

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

// The arguments of both launches: kmeans_fit (seeds from `draws`, then the fits) and lloyd_fit (the fits from
// `init`).  tiles: the seeding's tiles of a CTA (0 for lloyd_fit, whose shared memory holds no tile totals).
struct FitArgs {
  const float* sample;   // (n, 3)
  const float* draws;    // kmeans_fit: (attempts, k), the first centre's row as int32 bits, then k - 1 uniforms
  const float* init;     // lloyd_fit: (attempts, k, 3) seeds
  float* d2_all;         // kmeans_fit, streamed route: (attempts, n) scratch
  int32_t* picks_all;    // kmeans_fit: (attempts, k) the seeds' rows
  float* centers_all;    // (attempts, k, 3)
  float* comp_all;       // (attempts,)
  int32_t* iters_all;    // (attempts,)
  int* done;             // zeroed before the launch; the last attempt to finish picks the best
  float* best;           // (k, 3)
  int32_t* best_idx;
  int n, rows, tiles, attempts, iters;
  float eps;
};

#ifdef PW_KMEANS_PHASES
// CTA 0's thread 0: the clock64 cycles of each phase of the last launch (kPhase* slots; draw j's update, its
// totals and barrier, its search and barrier in slots kPhaseDraw + 3 (j - 1) + 0, 1, 2; pass p's scan in slot
// kPhasePass + 2 p, its reduction, new centres and barriers in the next), and the passes run.
constexpr int kPhaseSlots = 128, kPhaseLoad = 0, kPhasePasses = 8, kPhaseComp = 9, kPhaseTotal = 11,
              kPhaseDraw = 16, kPhasePass = 64;
__device__ unsigned long long phase_cycles[kPhaseSlots];
struct PhaseClock {
  unsigned long long start, t;
  __device__ __forceinline__ void begin() { start = t = clock64(); }
  __device__ __forceinline__ void mark(int slot) {
    const unsigned long long now = clock64();
    if (blockIdx.x == 0 && threadIdx.x == 0 && slot < kPhaseSlots) phase_cycles[slot] = now - t;
    t = now;
  }
  __device__ __forceinline__ void value(int slot, unsigned long long v) {
    if (blockIdx.x == 0 && threadIdx.x == 0) phase_cycles[slot] = v;
  }
  __device__ __forceinline__ void total() { value(kPhaseTotal, clock64() - start); }
};
#else
constexpr int kPhaseLoad = 0, kPhasePasses = 8, kPhaseComp = 9, kPhaseDraw = 16, kPhasePass = 64;
struct PhaseClock {
  __device__ __forceinline__ void begin() {}
  __device__ __forceinline__ void mark(int) {}
  __device__ __forceinline__ void value(int, unsigned long long) {}
  __device__ __forceinline__ void total() {}
};
#endif

// A CTA's dynamic shared memory: the seeding's tile totals (tiles low words, tiles high words); then, resident,
// the rows' three columns (xs[c rows + r]) and a region that holds d2 during the seeding and the fit's scratch
// after the last draw (d2 is dead there); streamed, a stage of kStageTiles tiles of rows in the same column
// layout (xs[c kStageRows + r]) and the fit's scratch.  The scratch: the warps' partials (kMaxVals x kWarps
// words), this CTA's partials, double-buffered (2 x kMaxVals; peers read them), the cluster's totals (kMaxVals)
// and the new centres (5 kMaxK).
struct Smem {
  uint32_t* tile_lo;
  uint32_t* tile_hi;
  float* xs;  // resident: the rows; streamed: the stage
  float* d2;
  uint32_t* wpart;
  uint32_t* part;
  uint32_t* tot;
  float* upd;
};

template <bool kResident>
__device__ __forceinline__ Smem smem_layout(unsigned char* dyn, int rows, int tiles) {
  Smem m;
  m.tile_lo = reinterpret_cast<uint32_t*>(dyn);
  m.tile_hi = m.tile_lo + tiles;
  m.xs = reinterpret_cast<float*>(m.tile_hi + tiles);
  m.d2 = m.xs + (kResident ? 3 * (long)rows : 3 * (long)kStageRows);
  m.wpart = reinterpret_cast<uint32_t*>(m.d2);
  m.part = m.wpart + kMaxVals * kWarps;
  m.tot = m.part + 2 * kMaxVals;
  m.upd = reinterpret_cast<float*>(m.tot + kMaxVals);
  return m;
}

// The CTA's rows into shared memory, resident route: its 3 len floats in order, one a thread and step (coalesced).
template <bool kResident>
__device__ __forceinline__ void load_rows(const Smem& m, const float* src, int rows, int len) {
  if (kResident)
    for (int f = threadIdx.x; f < 3 * len; f += kThreads) m.xs[(long)(f % 3) * rows + f / 3] = src[f];
  __syncthreads();
}

// Row r = t kThreads + tid of the CTA into (x0, x1, x2) where r < len.  Resident: from the columns.  Streamed: at
// every kStageTiles-th tile the CTA first copies the next kStageRows rows from the sample into the stage, one float
// a thread and step in order (coalesced; no thread reads at a 12-byte stride), so every thread of the CTA calls it
// for every t in order (two barriers a stage).
template <bool kResident>
__device__ __forceinline__ void tile_row(const Smem& m, const float* src, int rows, int len, int t, float& x0,
                                         float& x1, float& x2) {
  const int tid = threadIdx.x, r = t * kThreads + tid;
  if (!kResident) {
    const int rr = (t % kStageTiles) * kThreads + tid;
    if (t % kStageTiles == 0) {
      const int r0 = t * kThreads, cnt = 3 * max(min(kStageRows, len - r0), 0);
      __syncthreads();  // every thread has read the last stage
#pragma unroll 8
      for (int f = tid; f < cnt; f += kThreads) m.xs[(f % 3) * kStageRows + f / 3] = src[3 * (long)r0 + f];
      __syncthreads();
    }
    if (r < len) {
      x0 = m.xs[rr];
      x1 = m.xs[kStageRows + rr];
      x2 = m.xs[2 * kStageRows + rr];
    }
  } else if (r < len) {
    x0 = m.xs[r];
    x1 = m.xs[rows + r];
    x2 = m.xs[2 * (long)rows + r];
  }
}

// visit(x0, x1, x2) for each of this thread's rows in order: r = tid, tid + kThreads, ... < len.
template <bool kResident, typename F>
__device__ __forceinline__ void scan_rows(const Smem& m, const float* src, int rows, int len, F&& visit) {
  if (kResident) {
#pragma unroll 2
    for (int r = threadIdx.x; r < len; r += kThreads) visit(m.xs[r], m.xs[rows + r], m.xs[2 * (long)rows + r]);
  } else {
    const int tiles = (rows + kThreads - 1) / kThreads;
    for (int t = 0; t < tiles; ++t) {
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      tile_row<false>(m, src, rows, len, t, x0, x1, x2);
      if (t * kThreads + (int)threadIdx.x < len) visit(x0, x1, x2);
    }
  }
}

struct SeedShared {
  float4 pick;                            // this draw's pick: its index's bits, then its row; pushed by its CTA
  unsigned long long totals[kCluster];    // every CTA's total of this draw, pushed by each CTA
  unsigned long long cta_total;
  unsigned long long slots[kWarps];       // the CTA's scans; the warps' parts of the CTA's total
  unsigned long long rest;                // the picker's residual inside its tile
  int tile, local;
};

// The k-means++ seeds of attempt a (see the header), into seeds (3 K floats of this CTA's shared memory, written
// by thread 0) and picks_all (by CTA 0).  A tile's total is kept as the sums of its weights' low and high 18 bits
// (each below 2^27), added by 32-bit shared-memory atomics: a 64-bit shared atomic add is a compare-and-swap loop,
// and 16 warps add to each tile.
template <int K, bool kResident>
__device__ __forceinline__ void kpp_seed(const FitArgs& p, const Smem& m, const float* src, long lo, int len, int a,
                                         int rank, SeedShared& s, float* seeds, cg::cluster_group& cluster,
                                         PhaseClock& clk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = p.n, rows = p.rows, tiles = p.tiles;
  uint32_t* tile_lo = m.tile_lo;
  uint32_t* tile_hi = m.tile_hi;
  auto tile_tot = [&](int t) -> unsigned long long { return ((unsigned long long)tile_hi[t] << 18) + tile_lo[t]; };
  float* d2 = kResident ? m.d2 : p.d2_all + (long)a * n + lo;
  auto coord = [&](int r, int c) -> float { return kResident ? m.xs[(long)c * rows + r] : src[3 * (long)r + c]; };
  const float* draws = p.draws + (long)a * K;

  int idx = __float_as_int(draws[0]);
  float c0 = p.sample[3 * (long)idx], c1 = p.sample[3 * (long)idx + 1], c2 = p.sample[3 * (long)idx + 2];
  if (tid == 0) {
    seeds[0] = c0;
    seeds[1] = c1;
    seeds[2] = c2;
    if (rank == 0) p.picks_all[(long)a * K] = idx;
  }
  for (int j = 1; j < K; ++j) {
    // d2 and w against the last centre; every tile's total and the CTA's, integer sums in any order
    for (int t = tid; t < tiles; t += kThreads) tile_lo[t] = tile_hi[t] = 0u;
    __syncthreads();
    for (int t = 0; t < tiles; ++t) {
      const int r = t * kThreads + tid;
      float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
      tile_row<kResident>(m, src, rows, len, t, x0, x1, x2);
      unsigned long long w = 0ull;
      if (r < len) {
        const float e0 = x0 - c0, e1 = x1 - c1, e2 = x2 - c2;
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
    clk.mark(kPhaseDraw + 3 * (j - 1));
    unsigned long long part = 0ull;
    for (int t = tid; t < tiles; t += kThreads) part += tile_tot(t);
    part = warp_sum(part);
    if (lane == 0) s.slots[warp] = part;
    __syncthreads();
    if (tid == 0) {
      unsigned long long sum = 0ull;
      for (int v = 0; v < kWarps; ++v) sum += s.slots[v];
      s.cta_total = sum;
    }
    __syncthreads();
    if (tid < kCluster) cluster.map_shared_rank(&s.totals[0], tid)[rank] = s.cta_total;
    cluster.sync();  // every CTA's total is in every CTA
    clk.mark(kPhaseDraw + 3 * (j - 1) + 1);

    unsigned long long off = 0ull, total = 0ull;
    for (int q = 0; q < kCluster; ++q) {
      const unsigned long long v = s.totals[q];
      off += q < rank ? v : 0ull;
      total += v;
    }
    const unsigned long long target = kpp_target(total, draws[j]);
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
        const int r = s.tile * kThreads + tid;  // the tile's rescan: one row a thread
        const unsigned long long w = r < len ? kpp_weight(d2[r]) : 0ull;
        unsigned long long sum;
        const unsigned long long before = block_exclusive_scan<unsigned long long, kWarps>(w, s.slots, sum);
        if (before <= s.rest && s.rest < before + w) s.local = r;
        __syncthreads();
        local = s.local;
      }
      if (tid == 0) {
        const float4 pk = make_float4(__int_as_float((int)(lo + local)), coord(local, 0), coord(local, 1),
                                      coord(local, 2));
        for (int q = 0; q < kCluster; ++q) *cluster.map_shared_rank(&s.pick, q) = pk;
      }
    }
    cluster.sync();  // the pick is in every CTA
    const float4 pk = s.pick;
    idx = __float_as_int(pk.x);
    c0 = pk.y;
    c1 = pk.z;
    c2 = pk.w;
    if (tid == 0) {
      seeds[3 * j] = c0;
      seeds[3 * j + 1] = c1;
      seeds[3 * j + 2] = c2;
      if (rank == 0) p.picks_all[(long)a * K + j] = idx;
    }
    clk.mark(kPhaseDraw + 3 * (j - 1) + 2);
  }
}

__device__ __forceinline__ uint32_t add_bits(uint32_t x, uint32_t y, bool is_float) {
  return is_float ? __float_as_uint(__uint_as_float(x) + __uint_as_float(y)) : x + y;
}

// The cluster's totals of NV values a thread (v: the first NF float32, the rest int32, as bits), the same in every
// CTA, into tot.  Fixed order: a warp's lanes by a tree of shuffles (lane l adds lane l + o, o = 16, 8, 4, 2, 1),
// the CTA's 16 warps by a tree over 16 lanes (o = 8, 4, 2, 1) into part[buf], then the 16 CTAs' parts, read
// through distributed shared memory by 16 lanes at once, by the same tree.  part is double-buffered: a CTA that
// runs ahead writes the other buffer, so one cluster.sync() a call suffices (calls alternate buf).
template <int NV, int NF>
__device__ __forceinline__ void cluster_sums(const uint32_t (&v)[NV], const Smem& m, int buf,
                                             cg::cluster_group& cluster) {
  static_assert(kWarps == 16 && kCluster == 16 && NV <= kMaxVals, "one 16-lane tree a value");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    uint32_t x = v[j];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = add_bits(x, __shfl_down_sync(0xffffffffu, x, o), j < NF);
    if (lane == 0) m.wpart[j * kWarps + warp] = x;
  }
  __syncthreads();
  const int j = tid >> 4, q = tid & 15;  // value j, warp or CTA q
  const bool busy = warp < (16 * NV + 31) / 32;  // whole warps
  uint32_t* part = m.part + buf * kMaxVals;
  if (busy) {
    uint32_t x = j < NV ? m.wpart[j * kWarps + q] : 0u;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = add_bits(x, __shfl_down_sync(0xffffffffu, x, o, 16), j < NF);
    if (q == 0 && j < NV) part[j] = x;
  }
  cluster.sync();  // every CTA's part is in place
  if (busy) {
    uint32_t x = j < NV ? cluster.map_shared_rank(part, q)[j] : 0u;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) x = add_bits(x, __shfl_down_sync(0xffffffffu, x, o, 16), j < NF);
    if (q == 0 && j < NV) m.tot[j] = x;
  }
  __syncthreads();
}

// The nearest of the K centres (registers) to x by _lloyd's expanded distance; the first minimum wins.
template <int K>
__device__ __forceinline__ int nearest_of(const float (&cx)[K], const float (&cy)[K], const float (&cz)[K],
                                          const float (&cc)[K], float x0, float x1, float x2, float& best_d) {
  const float sq = (x0 * x0 + x1 * x1) + x2 * x2;
  int best = 0;
  best_d = 0.0f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float dot = (x0 * cx[c] + x1 * cy[c]) + x2 * cz[c];
    const float d = (sq - 2.0f * dot) + cc[c];
    if (c == 0 || d < best_d) {
      best = c;
      best_d = d;
    }
  }
  return best;
}

// Attempt a's Lloyd loop from seeds (3 K floats) over the CTA's rows, then the compactness of its centres; the
// last attempt to finish (done counts them) writes the centres of the first attempt of least compactness to best,
// zeros where no compactness is below infinity, and its index to best_idx.  The centres and |c|^2 stay in
// registers; every thread computes the same new centres from the same totals, so every CTA takes the same stop
// decision.
template <int K, bool kResident>
__device__ __forceinline__ void lloyd_body(const FitArgs& p, const Smem& m, const float* src, int len, int a,
                                           int rank, const float* seeds, cg::cluster_group& cluster,
                                           PhaseClock& clk) {
  constexpr int NF = 3 * K, NV = 4 * K;
  const int tid = threadIdx.x;
  float cx[K], cy[K], cz[K], cc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    cx[c] = seeds[3 * c];
    cy[c] = seeds[3 * c + 1];
    cz[c] = seeds[3 * c + 2];
    cc[c] = (cx[c] * cx[c] + cy[c] * cy[c]) + cz[c] * cz[c];
  }
  float shift = CUDART_INF_F;
  int it = 0;
  while (shift > p.eps && it < p.iters) {
    float s0[K], s1[K], s2[K];
    int cnt[K];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      s0[c] = s1[c] = s2[c] = 0.0f;
      cnt[c] = 0;
    }
    scan_rows<kResident>(m, src, p.rows, len, [&](float x0, float x1, float x2) {
      float d;
      const int b = nearest_of<K>(cx, cy, cz, cc, x0, x1, x2, d);
#pragma unroll
      for (int c = 0; c < K; ++c) {
        if (b == c) {
          s0[c] = s0[c] + x0;
          s1[c] = s1[c] + x1;
          s2[c] = s2[c] + x2;
          cnt[c] = cnt[c] + 1;
        }
      }
    });
    clk.mark(kPhasePass + 2 * it);
    uint32_t v[NV];
#pragma unroll
    for (int c = 0; c < K; ++c) {
      v[3 * c] = __float_as_uint(s0[c]);
      v[3 * c + 1] = __float_as_uint(s1[c]);
      v[3 * c + 2] = __float_as_uint(s2[c]);
      v[NF + c] = (uint32_t)cnt[c];
    }
    cluster_sums<NV, NF>(v, m, it & 1, cluster);
    if (tid < K) {  // thread c: centre c's new place (an empty cluster keeps its centre), |c|^2 and movement
      float ox = cx[0], oy = cy[0], oz = cz[0];
#pragma unroll
      for (int c = 1; c < K; ++c) {
        if (tid == c) {
          ox = cx[c];
          oy = cy[c];
          oz = cz[c];
        }
      }
      const int n_c = (int)m.tot[NF + tid];
      const float div = fmaxf((float)n_c, 1.0f);
      const float nx = n_c > 0 ? __uint_as_float(m.tot[3 * tid]) / div : ox;
      const float ny = n_c > 0 ? __uint_as_float(m.tot[3 * tid + 1]) / div : oy;
      const float nz = n_c > 0 ? __uint_as_float(m.tot[3 * tid + 2]) / div : oz;
      const float e0 = nx - ox, e1 = ny - oy, e2 = nz - oz;
      float* u = m.upd + 5 * tid;
      u[0] = nx;
      u[1] = ny;
      u[2] = nz;
      u[3] = (nx * nx + ny * ny) + nz * nz;
      u[4] = sqrtf((e0 * e0 + e1 * e1) + e2 * e2);
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < K; ++c) {
      cx[c] = m.upd[5 * c];
      cy[c] = m.upd[5 * c + 1];
      cz[c] = m.upd[5 * c + 2];
      cc[c] = m.upd[5 * c + 3];
      shift = c == 0 ? m.upd[5 * c + 4] : fmaxf(shift, m.upd[5 * c + 4]);
    }
    clk.mark(kPhasePass + 2 * it + 1);
    ++it;
  }
  clk.value(kPhasePasses, it);

  // the compactness of the final centres
  float comp = 0.0f;
  scan_rows<kResident>(m, src, p.rows, len, [&](float x0, float x1, float x2) {
    float d;
    nearest_of<K>(cx, cy, cz, cc, x0, x1, x2, d);
    comp = comp + d;
  });
  clk.mark(kPhaseComp);
  const uint32_t vc[1] = {__float_as_uint(comp)};
  cluster_sums<1, 1>(vc, m, it & 1, cluster);
  clk.mark(kPhaseComp + 1);
  if (rank == 0 && tid == 0) {
#pragma unroll
    for (int c = 0; c < K; ++c) {
      p.centers_all[((long)a * K + c) * 3] = cx[c];
      p.centers_all[((long)a * K + c) * 3 + 1] = cy[c];
      p.centers_all[((long)a * K + c) * 3 + 2] = cz[c];
    }
    p.comp_all[a] = __uint_as_float(m.tot[0]);
    p.iters_all[a] = it;
    __threadfence();
    if (atomicAdd(p.done, 1) == p.attempts - 1) {
      __threadfence();
      const volatile float* comps = p.comp_all;
      const volatile float* cens = p.centers_all;
      float best_comp = CUDART_INF_F;
      int pick = -1;
      for (int q = 0; q < p.attempts; ++q) {
        if (comps[q] < best_comp) {  // strict: the first of equal attempts wins
          best_comp = comps[q];
          pick = q;
        }
      }
      for (int j = 0; j < 3 * K; ++j) p.best[j] = pick < 0 ? 0.0f : cens[(long)pick * K * 3 + j];
      *p.best_idx = pick;
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still read its partials
  clk.total();
}

// The device mode's seeds and fits in one launch: one cluster of kCluster CTAs an attempt, each CTA over its own
// rows (loaded once, resident route), the k-means++ seeds, then the Lloyd loop over the same rows.
template <int K, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) kmeans_fit(const FitArgs p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ SeedShared s;
  __shared__ float seeds[3 * K];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), a = blockIdx.x / kCluster;
  const Smem m = smem_layout<kResident>(dyn, p.rows, p.tiles);
  const long lo = min((long)rank * p.rows, (long)p.n);
  const int len = (int)(min(lo + p.rows, (long)p.n) - lo);
  const float* src = p.sample + 3 * lo;
  PhaseClock clk;
  clk.begin();
  load_rows<kResident>(m, src, p.rows, len);
  clk.mark(kPhaseLoad);
  kpp_seed<K, kResident>(p, m, src, lo, len, a, rank, s, seeds, cluster, clk);
  __syncthreads();  // thread 0's seeds
  lloyd_body<K, kResident>(p, m, src, len, a, rank, seeds, cluster, clk);
}

// The fits from given seeds (init), the same body: the tools' kmeans().
template <int K, bool kResident>
__global__ void __launch_bounds__(kThreads, 1) lloyd_fit(const FitArgs p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), a = blockIdx.x / kCluster;
  const Smem m = smem_layout<kResident>(dyn, p.rows, 0);
  const long lo = min((long)rank * p.rows, (long)p.n);
  const int len = (int)(min(lo + p.rows, (long)p.n) - lo);
  const float* src = p.sample + 3 * lo;
  PhaseClock clk;
  clk.begin();
  load_rows<kResident>(m, src, p.rows, len);
  clk.mark(kPhaseLoad);
  lloyd_body<K, kResident>(p, m, src, len, a, rank, p.init + (long)a * K * 3, cluster, clk);
}

#define PW_K8_BY_K(kernel, resident)                                                                          \
  {                                                                                                           \
    (const void*)kernel<1, resident>, (const void*)kernel<2, resident>, (const void*)kernel<3, resident>,     \
        (const void*)kernel<4, resident>, (const void*)kernel<5, resident>, (const void*)kernel<6, resident>, \
        (const void*)kernel<7, resident>, (const void*)kernel<8, resident>                                    \
  }
// [fused][resident][k - 1]
const void* const kFitKernels[2][2][kMaxK] = {{PW_K8_BY_K(lloyd_fit, false), PW_K8_BY_K(lloyd_fit, true)},
                                              {PW_K8_BY_K(kmeans_fit, false), PW_K8_BY_K(kmeans_fit, true)}};
#undef PW_K8_BY_K

// Either kernel's static shared memory stays within kStaticSmem (KPP_STATIC_SMEM of ops/kernels.py), so the
// dynamic part may take the rest of a CTA's 227 KB.
static_assert(sizeof(SeedShared) + sizeof(float) * 3 * kMaxK <= kStaticSmem, "static shared memory");

// A CTA's dynamic shared memory (smem_layout).
size_t fit_smem(int rows, int tiles, bool resident) {
  const size_t region = resident ? (4 * (size_t)rows > (size_t)kFitScratch ? 4 * (size_t)rows : (size_t)kFitScratch)
                                 : (size_t)kFitScratch;
  return 8 * (size_t)tiles + 12 * (size_t)(resident ? rows : kStageRows) + region;
}

// One launch of kFitKernels[fused][resident][k - 1] after zeroing done.  The kernels' attributes are set once a
// process and device.
cudaError_t launch_fit(bool fused, bool resident, int k, FitArgs& p, cudaStream_t s) {
  const size_t smem = fit_smem(p.rows, p.tiles, resident);
  if (smem > (size_t)(kMaxSmem - kStaticSmem)) return cudaErrorInvalidValue;
  const void* kernel = kFitKernels[fused][resident][k - 1];
  static unsigned char configured[64][2][2][kMaxK];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !configured[dev][fused][resident][k - 1]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem - kStaticSmem);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured[dev][fused][resident][k - 1] = 1;
  }
  err = cudaMemsetAsync(p.done, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)(p.attempts * kCluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* args[] = {&p};
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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

// out (n, 3) float32 = Lab of pixel idx[i] (int32, below px; pixel i where idx
// is null) of the BGR bytes of px pixels.  Returns a CUDA error code (0 on
// success).  out must be 16-byte aligned.  The grid is the CTAs the device
// holds at once (found at a device's first launch), at most one a chunk.
int pw_lab_sample(const uint8_t* bgr, const int32_t* idx, float* out, int n, long px, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;
  static int most_ctas[64];  // a device's co-resident CTAs of the sampler
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int most = dev < 64 ? most_ctas[dev] : 0;
  if (most == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lab_sample, kSampleThreads, 0);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    most = per_sm * sms > 0 ? per_sm * sms : 1;
    if (dev < 64) most_ctas[dev] = most;
  }
  const int chunks = (int)(((long)n + kSampleChunk - 1) / kSampleChunk);
  const int grid = chunks < most ? chunks : most;
  lab_sample<<<grid, kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(bgr, idx, out, n, px);
  return (int)cudaGetLastError();
}

// The subsample of n pixels: the `limit` pixels of least key draw_key(i, a,
// b), written to out (limit,) int32 in increasing index order; 1 <= limit <
// n < 2^31.  scratch: kMaxDrawClusters * kRowWords + kDrawThreads words (a
// row a cluster, a count a CTA), then min(n, 2^21) words of candidates;
// nothing in it needs to be zeroed.  One cooperative launch in clusters of
// kDrawCluster CTAs.  Returns a CUDA error code.
int pw_subsample(int n, int limit, unsigned a, unsigned b, int32_t* out, uint32_t* scratch, void* stream) {
  if (n < 2 || limit < 1 || limit >= n) return (int)cudaErrorInvalidValue;
  static int max_clusters[64];  // a device's co-resident clusters of the draw, found at its first launch
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kDrawCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.blockDim = dim3(kDrawThreads);
  cfg.dynamicSmemBytes = sizeof(DrawSmem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  int most = dev < 64 ? max_clusters[dev] : 0;
  if (most == 0) {
    err = cudaFuncSetAttribute(subsample_draw, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(DrawSmem));
    cfg.gridDim = dim3(kDrawCluster);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&most, (const void*)subsample_draw, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (most < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    if (dev < 64) max_clusters[dev] = most;
  }
  const long per_cluster = (long)kDrawCluster * kDrawThreads;
  long clusters = ((long)n + per_cluster - 1) / per_cluster;
  clusters = clusters < most ? clusters : most;
  clusters = clusters < kMaxDrawClusters ? clusters : kMaxDrawClusters;
  const long grid = clusters * kDrawCluster;
  long chunk = ((long)n + grid - 1) / grid;
  chunk = (chunk + 31) / 32 * 32;
  uint32_t* rows = scratch;
  int* belows = reinterpret_cast<int*>(scratch + (long)kMaxDrawClusters * kRowWords);
  uint32_t* list = scratch + (long)kMaxDrawClusters * kRowWords + kDrawThreads;
  cfg.gridDim = dim3((unsigned)grid);
  err = cudaLaunchKernelEx(&cfg, subsample_draw, n, limit, (uint32_t)a, (uint32_t)b, chunk, rows, belows, list, out);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The device mode's seeds and fits of `attempts` attempts on sample (n, 3), 0 < n < 2^27, 1 <= k <= 8, in one
// launch: draws (attempts, k) float32, each attempt's first row as int32 bits, then k - 1 uniforms in [0, 1] ->
// picks (attempts, k) int32, the seeds' rows; centers (attempts, k, 3) after `iters` Lloyd iterations at most (the
// seeds where iters is 0); comp and iters_out (attempts,); the best attempt's centres in best (k, 3) and its index
// in best_idx.  resident (nonzero): each CTA holds its rows in shared memory (ops/kernels.py::kpp_schedule),
// else d2 (attempts, n) float32 is scratch in device memory.  done: an int of scratch (zeroed here).  Returns a
// CUDA error code.
int pw_kmeans_fit(const float* sample, int n, int k, int attempts, const float* draws, int iters, float eps,
                  int resident, float* d2, int32_t* picks, float* centers, float* comp, int32_t* iters_out, int* done,
                  float* best, int32_t* best_idx, void* stream) {
  if (n <= 0 || n >= (1 << 27) || k <= 0 || k > kMaxK || attempts <= 0 || iters < 0 || (!resident && d2 == nullptr))
    return (int)cudaErrorInvalidValue;
  FitArgs p = {};
  p.sample = sample;
  p.draws = draws;
  p.d2_all = d2;
  p.picks_all = picks;
  p.centers_all = centers;
  p.comp_all = comp;
  p.iters_all = iters_out;
  p.done = done;
  p.best = best;
  p.best_idx = best_idx;
  p.n = n;
  p.rows = (n + kCluster - 1) / kCluster;
  p.tiles = (p.rows + kThreads - 1) / kThreads;
  p.attempts = attempts;
  p.iters = iters;
  p.eps = eps;
  return (int)launch_fit(true, resident != 0, k, p, static_cast<cudaStream_t>(stream));
}

// The Lloyd fits of `attempts` attempts from init (attempts, k, 3), 1 <= k <= 8, in one launch, by the same body
// as pw_kmeans_fit's fits and on the same routes -> centers, comp, iters_out, best, best_idx as there.  Returns a
// CUDA error code.
int pw_lloyd_fit(const float* sample, int n, int k, int attempts, const float* init, int iters, float eps,
                 int resident, float* centers, float* comp, int32_t* iters_out, int* done, float* best,
                 int32_t* best_idx, void* stream) {
  if (n <= 0 || k <= 0 || k > kMaxK || attempts <= 0 || iters < 0) return (int)cudaErrorInvalidValue;
  FitArgs p = {};
  p.sample = sample;
  p.init = init;
  p.centers_all = centers;
  p.comp_all = comp;
  p.iters_all = iters_out;
  p.done = done;
  p.best = best;
  p.best_idx = best_idx;
  p.n = n;
  p.rows = (n + kCluster - 1) / kCluster;
  p.tiles = 0;
  p.attempts = attempts;
  p.iters = iters;
  p.eps = eps;
  return (int)launch_fit(false, resident != 0, k, p, static_cast<cudaStream_t>(stream));
}

#ifdef PW_KMEANS_PHASES
// The last launch's phase cycles (kPhaseSlots values; see PhaseClock).
int pw_kmeans_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));
}

// The last draw's phase cycles (kDrawSlots values; see DrawClock).
int pw_draw_phases(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, draw_cycles, sizeof(draw_cycles));
}

// The last sampler's phase cycles (kSampleSlots values; see sample_cycles)
// and its CTAs' start and end times (kSampleTimed x 2; see sample_ns).
int pw_sample_phases(unsigned long long* out, unsigned long long* ns) {
  const cudaError_t err = cudaMemcpyFromSymbol(out, sample_cycles, sizeof(sample_cycles));
  return (int)(err != cudaSuccess ? err : cudaMemcpyFromSymbol(ns, sample_ns, sizeof(sample_ns)));
}
#endif

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
