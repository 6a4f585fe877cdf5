// The two bit-packed fixpoints of the stage 02->04 raster chain, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// K6  Zhang-Suen thinning fixpoint.  Replaces the Pallas kernel
//     plotweave/ops/pallas_kernels.py::zhang_suen_packed_pallas (:179, body
//     _zs_packed_kernel), the same computation as the XLA loop
//     plotweave/ops/thinning.py::zhang_suen_packed.
// K5  Canny's hysteresis, edges = cand & dilate8(edges) until nothing changes.
//     Replaces the XLA while_loop of plotweave/ops/canny.py::canny_packed
//     (grow / _dilate8, canny.py:118-133).
//
// Boards: (k, H, NW) 32-bit words, 32 pixels per word, LSB-first; bit j of a
// word is column 32*w + j.  Padding bits beyond W stay zero: thinning only
// clears bits and hysteresis stays inside cand, whose padding is zero.
//
// Bound.  At the main path's 4 x 1500 x 2000 px a board is 4*1500*63 words
// = 1.5 MB.  Moving each input once and the output once takes about 1 us at
// 3.35 TB/s; K6's bit-sliced arithmetic (zs_word) is 49 integer operations
// per word and subpass, counting a three-input logic op (LOP3) or a funnel
// shift as one: 6 shifts, 16 for the neighbour count, 23 for the
// transitions, 4 for the direction test and the clear.  That is about 2.2 us
// per iteration at 132 SMs x 64 INT32 lanes x 1.98 GHz, so K6 is bound by
// operations over its iterations and K5 by bytes.  Either is microseconds, while one launch per subpass or sweep
// with a host check per chunk costs tens of microseconds per iteration: the
// fixpoints are bound by launches and round trips, not by work.
//
// Design: the resident route (pw_zs_cluster_run, pw_hysteresis_cluster_run).
// One launch per call.  Each layer belongs to one thread block cluster of
// kCluster = 16 CTAs (16 beat 8 by 1.6x on K6 at the chain's shapes); a
// cluster loops over layers when there are more layers than clusters fit on
// the card.  The layer's rows are split evenly over the
// cluster's CTAs and stay in dynamic shared memory for the whole fixpoint:
// loaded once with cp.async, stored once at the end.  A CTA reads the
// boundary rows of its neighbour CTAs through distributed shared memory
// (cluster.map_shared_rank) between cluster.sync()s; rows outside the layer
// read as a zero row.  Rows are padded with a zero word on each side, so a
// word's left and right neighbours need no test.  A thread owns a strip of
// rows of one word column and slides a 3 x 3 word window down it, loading
// three words per row; its indices need no 64-bit divide.  The loop ends on
// the device.  The wrapper reads nothing back: the iterations (K6) or the
// rounds and sweeps (K5) each layer took go into a small device buffer.
//
//   K6: two boards per layer, x and the subpass-1 result y.  Subpass 1 reads
//   x and writes y, cluster.sync(), subpass 2 reads y and writes x, then
//   every CTA publishes whether its rows changed and cluster.sync().  Every
//   warp then ORs the cluster's flags through DSMEM, so all CTAs leave the
//   loop together.  A layer stops at its own fixpoint or at max_iter.  The
//   JAX loop stops on one flag joint over all layers, and this gives the
//   same board: an iteration past a layer's fixpoint changes nothing
//   (plotweave/ops/thinning.py:11-14).
//
//   K6's stores (the chain's K1 fold): given a layout, each CTA writes its
//   rows of the input, the edges, right after the load, and its rows of the
//   result, the skeletons, at its store, as packed rows (each word's 1-4
//   bytes inside the row, the bits at and beyond W zero; stage 02's blob) or
//   as dense bytes (the edges 255, the skeletons 1, 16-byte stores where a
//   row is a multiple of 16 px; the front-end's outputs), so no conversion
//   launch follows K6.  The board output is then optional.  At 4 x 1500 x
//   2000 px that adds 3 MB of packed stores (24 MB dense) to a kernel bound
//   by operations.
//
//   K5: the result is the set of cand pixels 8-connected through cand to a
//   pixel of cand & dilate8(strong) (the plain version's first sweep, taken
//   here while the layer loads, so that any strong works): the least
//   fixpoint of a monotone growth, which no order of updates changes, since
//   every update adds only pixels of that set and a state where no update
//   adds anything is that set.  So each CTA updates its own rows in place,
//   Gauss-Seidel, sweeping down and up in turn and growing each word along
//   its row to a fixpoint in registers, until a sweep changes nothing; then
//   it publishes its first and last rows into a double buffer and meets the
//   cluster barrier.  Its neighbours read those published rows as halos in
//   the next round.  Rounds end when a whole round changed nothing anywhere
//   in the cluster: every CTA then sat at a fixpoint of halos that no longer
//   move.  A long weak chain therefore costs sweeps and rounds inside one
//   launch, not launches: a sweep carries growth down (or up) a whole strip
//   and 32 pixels along a row, a round carries it across a CTA boundary.
//
// Shared memory per CTA (words, stride NW + 2, rpc = ceil(H / 16) rows):
// K6 (2 rpc + 1) stride, K5 (2 rpc + 5) stride, plus two flags.  At 1500 x
// 63 words that is 49 KB; the default max_dimension of 2000 rows takes
// 64 KB.  A layer that does not fit
// in 227 KB takes the multi-launch route; the wrapper chooses the route by
// size before any launch (ops/kernels.py::resident_smem_bytes repeats these
// formulas).
//
// The multi-launch route (pw_zs_packed_run, pw_hysteresis_run): one thread
// per word, one launch per subpass or sweep over every layer, chunks of
// iterations with one joint device flag per iteration that the host reads
// once per chunk.  Iterations past a fixpoint are no-ops, so a chunk that
// runs past convergence changes nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitlayout.cuh"  // store_row_word, store_dense_word (shared with K1, K2)
#include "zs_word.cuh"     // Row3, shifted, full_add, zs_word (shared with K12)

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;           // multi-launch route
constexpr int kClusterThreads = 512;    // resident route
constexpr int kMaxSmem = 232448;        // 227 KB, the opt-in limit of one CTA
constexpr int kCluster = 16;            // CTAs per cluster (a non-portable size)
constexpr int kRows = 1, kDense = 2;    // K6's layouts of its edges and skeletons (0: none)

__device__ __forceinline__ uint32_t dilate_row(const Row3& q) {
  return q.mid | shifted(q, 1) | shifted(q, -1);
}

// ---------------------------------------------------------------------------
// Multi-launch route
// ---------------------------------------------------------------------------

// The three words of row r around word w of an unpadded layer, zero outside.
__device__ __forceinline__ Row3 load_row(const uint32_t* __restrict__ layer, int r, int w,
                                         int h, int nw) {
  Row3 q{0u, 0u, 0u};
  if (r < 0 || r >= h) return q;
  const uint32_t* row = layer + (long)r * nw;
  q.mid = row[w];
  if (w > 0) q.left = row[w - 1];
  if (w + 1 < nw) q.right = row[w + 1];
  return q;
}

// One subpass on one word of every layer.  The first subpass writes y; the
// second reads y, writes the iteration's result into `out` and raises *flag
// where it differs from `prev`, the iteration's input (`prev` may be `out`:
// each thread reads its word before it writes it).
template <bool FIRST, bool ROTATED>
__global__ void zs_subpass(const uint32_t* __restrict__ in, const uint32_t* prev, uint32_t* out,
                           int* __restrict__ flag, int h, int nw) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  int r = blockIdx.y;
  long offset = ((long)blockIdx.z * h + r) * nw;
  const uint32_t* layer = in + (long)blockIdx.z * h * nw;
  Row3 rows[3];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) rows[dy + 1] = load_row(layer, r + dy, w, h, nw);
  uint32_t res = zs_word<FIRST, ROTATED>(rows);
  if (FIRST) {
    out[offset + w] = res;
  } else {
    uint32_t before = prev[offset + w];
    out[offset + w] = res;
    if (res != before) *flag = 1;
  }
}

// One hysteresis sweep on one word of every layer: out = cand & dilate8(in);
// raises *flag when the word changed.
__global__ void hysteresis_sweep(const uint32_t* __restrict__ cand,
                                 const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                                 int* __restrict__ flag, int h, int nw) {
  int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= nw) return;
  int r = blockIdx.y;
  long offset = ((long)blockIdx.z * h + r) * nw;
  const uint32_t* layer = in + (long)blockIdx.z * h * nw;
  uint32_t d = 0u;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) d |= dilate_row(load_row(layer, r + dy, w, h, nw));
  uint32_t res = cand[offset + w] & d;
  out[offset + w] = res;
  if (res != in[offset + w]) *flag = 1;
}

dim3 word_grid(int k, int h, int nw) {
  return dim3((unsigned)((nw + kThreads - 1) / kThreads), (unsigned)h, (unsigned)k);
}

template <bool ROTATED>
cudaError_t zs_iterations(const uint32_t* src, uint32_t* a, uint32_t* b, int* flags, int k, int h,
                          int nw, int n_iter, cudaStream_t stream) {
  dim3 grid = word_grid(k, h, nw);
  for (int it = 0; it < n_iter; ++it) {
    const uint32_t* x = it == 0 ? src : a;
    zs_subpass<true, ROTATED><<<grid, kThreads, 0, stream>>>(x, nullptr, b, nullptr, h, nw);
    zs_subpass<false, ROTATED><<<grid, kThreads, 0, stream>>>(b, x, a, flags + it, h, nw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Resident route
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The three words around word w of a padded row (index 0 and nw + 1 are 0).
__device__ __forceinline__ Row3 row3(const uint32_t* row, int w) {
  return Row3{row[w], row[w + 1], row[w + 2]};
}

// One CTA's rows of one layer: `own` holds rows [0, nrows) at `stride`
// words each; row -1 is `above` and row nrows is `below` (a neighbour's
// row through DSMEM, or the zero row).
struct Rows {
  const uint32_t* own;
  const uint32_t* above;
  const uint32_t* below;
  int nrows;
  int stride;
  __device__ __forceinline__ const uint32_t* at(int i) const {
    return i < 0 ? above : (i >= nrows ? below : own + i * stride);
  }
};

// The rows of a CTA are cut into `strips` strips of `len` rows, and a
// thread owns one word column of one strip per item.
struct Strips {
  int strips, len;
  __device__ Strips(int nrows, int nw) {
    strips = kClusterThreads / nw;
    if (strips < 1) strips = 1;
    if (strips > nrows) strips = nrows > 0 ? nrows : 1;
    len = (nrows + strips - 1) / strips;
  }
};

// One Zhang-Suen subpass down one strip of word column w: reads `src`,
// writes dst (padded, same stride).  The second subpass overwrites x in
// place, so `dst` is then the iteration's input as well; returns whether
// any word changed.
template <bool FIRST, bool ROTATED>
__device__ __forceinline__ bool zs_strip(const Rows& src, uint32_t* dst, int w, int r0, int r1) {
  bool changed = false;
  Row3 rows[3];
  rows[0] = row3(src.at(r0 - 1), w);
  rows[1] = row3(src.at(r0), w);
  for (int r = r0; r < r1; ++r) {
    rows[2] = row3(src.at(r + 1), w);
    uint32_t res = zs_word<FIRST, ROTATED>(rows);
    uint32_t* out = dst + r * src.stride + w + 1;
    if (!FIRST) changed |= (*out != res);
    *out = res;
    rows[0] = rows[1];
    rows[1] = rows[2];
  }
  return changed;
}

// Every warp ORs the published flag of each CTA of the cluster; all threads
// of all CTAs get the same answer.
__device__ __forceinline__ bool cluster_any(cg::cluster_group& cluster, int* flag) {
  int lane = threadIdx.x & 31;
  int f = 0;
  if (lane < kCluster) f = *cluster.map_shared_rank(flag, (unsigned)lane);
  return __any_sync(0xffffffffu, f != 0);
}

// Load one CTA's rows of a layer into its padded buffer with cp.async.
__device__ __forceinline__ void load_rows(uint32_t* dst, const uint32_t* src, int nrows, int nw,
                                          int stride) {
  for (int r = threadIdx.x / 32; r < nrows; r += kClusterThreads / 32)
    for (int w = threadIdx.x % 32; w < nw; w += 32) cp_async4(dst + r * stride + w + 1, src + (long)r * nw + w);
  cp_async_wait_all();
}

__device__ __forceinline__ void store_rows(uint32_t* dst, const uint32_t* src, int nrows, int nw,
                                           int stride) {
  for (int r = threadIdx.x / 32; r < nrows; r += kClusterThreads / 32)
    for (int w = threadIdx.x % 32; w < nw; w += 32) dst[(long)r * nw + w] = src[r * stride + w + 1];
}

// One CTA's rows of a layer into a packed-row (kRows) or dense (kDense)
// output whose row 0 of those rows is `dst`: each word's 1-4 bytes of a
// packed row, or its 1-32 pixels as `value` where set.
__device__ __forceinline__ void store_layout(uint8_t* __restrict__ dst, const uint32_t* src, int nrows, int nw,
                                             int stride, int width, int layout, uint32_t value, bool vec) {
  const int rb = layout == kRows ? (width + 7) / 8 : width;
  for (int r = threadIdx.x / 32; r < nrows; r += kClusterThreads / 32)
    for (int w = threadIdx.x % 32; w < nw; w += 32) {
      const uint32_t v = src[r * stride + w + 1];
      if (layout == kRows)
        store_row_word(dst + (long)r * rb, w, rb, width, v);
      else
        store_dense_word(dst + (long)r * rb, w, width, v, value, vec);
    }
}

template <bool ROTATED>
__global__ void __launch_bounds__(kClusterThreads)
    zs_cluster(const uint32_t* __restrict__ in, uint32_t* __restrict__ out, int* __restrict__ iters,
               uint8_t* __restrict__ edges, uint8_t* __restrict__ skels, long img_stride, int group, int layout,
               int k, int h, int nw, int width, int vec, int max_iter) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint32_t smem[];
  const int rank = (int)cluster.block_rank();
  const int stride = nw + 2;
  const int rpc = (h + kCluster - 1) / kCluster;
  uint32_t* x = smem;
  uint32_t* y = x + rpc * stride;
  uint32_t* zero = y + rpc * stride;
  int* flag = reinterpret_cast<int*>(zero + stride);  // flag[2]
  const int row0 = rank * rpc;
  const int nrows = max(0, min(h - row0, rpc));
  for (int i = threadIdx.x; i < (2 * rpc + 1) * stride; i += kClusterThreads) smem[i] = 0u;

  const bool has_above = rank > 0 && nrows > 0;
  const bool has_below = row0 + nrows < h;
  Rows xs{x, has_above ? cluster.map_shared_rank(x, rank - 1) + (rpc - 1) * stride : zero,
          has_below ? cluster.map_shared_rank(x, rank + 1) : zero, nrows, stride};
  Rows ys{y, has_above ? cluster.map_shared_rank(y, rank - 1) + (rpc - 1) * stride : zero,
          has_below ? cluster.map_shared_rank(y, rank + 1) : zero, nrows, stride};
  const Strips st(nrows, nw);
  const int items = st.strips * nw;

  const int rb = layout == kRows ? (width + 7) / 8 : width;  // bytes of an output row
  for (int layer = blockIdx.x / kCluster; layer < k; layer += gridDim.x / kCluster) {
    const long base = ((long)layer * h + row0) * nw;
    // this CTA's first row in each output: layer = b group + l at b img_stride + l h rb
    const long half = layout ? (long)(layer / group) * img_stride + ((long)(layer % group) * h + row0) * rb : 0;
    __syncthreads();  // the zero fill, or the previous layer's store, is done
    load_rows(x, in + base, nrows, nw, stride);
    cluster.sync();  // every CTA's rows are in place before a halo is read
    // the input is the edges: written from x before subpass 2 first changes it, past a cluster barrier
    if (layout) store_layout(edges + half, x, nrows, nw, stride, width, layout, 255u, vec);
    int it = 0;
    while (it < max_iter) {
      for (int item = threadIdx.x; item < items; item += kClusterThreads) {
        int s = item / nw, w = item - s * nw;
        zs_strip<true, ROTATED>(xs, y, w, s * st.len, min(nrows, (s + 1) * st.len));
      }
      cluster.sync();
      bool changed = false;
      for (int item = threadIdx.x; item < items; item += kClusterThreads) {
        int s = item / nw, w = item - s * nw;
        changed |= zs_strip<false, ROTATED>(ys, x, w, s * st.len, min(nrows, (s + 1) * st.len));
      }
      // flag[it & 1] was last read before the barrier that ended iteration it - 1
      int local = __syncthreads_or(changed);
      if (threadIdx.x == 0) flag[it & 1] = local;
      cluster.sync();
      bool any = cluster_any(cluster, flag + (it & 1));
      ++it;
      if (!any) break;
    }
    if (rank == 0 && threadIdx.x == 0) iters[layer] = it;
    if (out) store_rows(out + base, x, nrows, nw, stride);
    if (layout) store_layout(skels + half, x, nrows, nw, stride, width, layout, 1u, vec);
  }
  cluster.sync();  // no CTA leaves while a neighbour may still read its flags
}

// One in-place hysteresis sweep down (or up) one strip of word column w of
// the edges `e`, growing each word along its row to a fixpoint in registers.
// Neighbouring words may be read before or after their owner updates them:
// both are subsets of the fixpoint, so either is safe.  Returns whether any
// word grew.
__device__ __forceinline__ bool grow_strip(const Rows& e, uint32_t* own, const uint32_t* cand,
                                           int w, int r0, int r1, bool down) {
  if (r0 >= r1) return false;
  bool changed = false;
  const int step = down ? 1 : -1;
  int r = down ? r0 : r1 - 1;
  Row3 prev = row3(e.at(r - step), w);
  Row3 cur = row3(e.at(r), w);
  for (int n = r1 - r0; n > 0; --n, r += step) {
    Row3 next = row3(e.at(r + step), w);
    const uint32_t c = cand[r * e.stride + w + 1];
    uint32_t v = c & (dilate_row(prev) | dilate_row(cur) | dilate_row(next));
    for (uint32_t u = c & (v | (v << 1) | (v >> 1)); u != v; u = c & (v | (v << 1) | (v >> 1))) v = u;
    if (v != cur.mid) {
      own[r * e.stride + w + 1] = v;
      cur.mid = v;
      changed = true;
    }
    prev = cur;
    cur = next;
  }
  return changed;
}

__global__ void __launch_bounds__(kClusterThreads)
    hysteresis_cluster(const uint32_t* __restrict__ cand_g, const uint32_t* __restrict__ strong_g,
                       uint32_t* __restrict__ out, int* __restrict__ stats, int k, int h, int nw) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint32_t smem[];
  const int rank = (int)cluster.block_rank();
  const int stride = nw + 2;
  const int rpc = (h + kCluster - 1) / kCluster;
  uint32_t* cand = smem;
  uint32_t* e = cand + rpc * stride;
  uint32_t* pub = e + rpc * stride;  // pub[parity][first row, last row]
  uint32_t* zero = pub + 4 * stride;
  int* flag = reinterpret_cast<int*>(zero + stride);  // flag[2]
  const int row0 = rank * rpc;
  const int nrows = max(0, min(h - row0, rpc));
  for (int i = threadIdx.x; i < (2 * rpc + 5) * stride; i += kClusterThreads) smem[i] = 0u;

  const bool has_above = rank > 0 && nrows > 0;
  const bool has_below = row0 + nrows < h;
  // the neighbours' published rows: the last row of rank - 1, the first of rank + 1
  const uint32_t* pub_above[2] = {zero, zero};
  const uint32_t* pub_below[2] = {zero, zero};
  for (int p = 0; p < 2; ++p) {
    if (has_above) pub_above[p] = cluster.map_shared_rank(pub, rank - 1) + (2 * p + 1) * stride;
    if (has_below) pub_below[p] = cluster.map_shared_rank(pub, rank + 1) + (2 * p) * stride;
  }
  const Strips st(nrows, nw);
  const int items = st.strips * nw;

  for (int layer = blockIdx.x / kCluster; layer < k; layer += gridDim.x / kCluster) {
    const long base = ((long)layer * h + row0) * nw;
    const uint32_t* strong = strong_g + (long)layer * h * nw;
    __syncthreads();  // the zero fill, or the previous layer's store, is done
    load_rows(cand, cand_g + base, nrows, nw, stride);
    __syncthreads();
    // the first sweep, cand & dilate8(strong), from strong in device memory
    for (int r = threadIdx.x / 32; r < nrows; r += kClusterThreads / 32)
      for (int w = threadIdx.x % 32; w < nw; w += 32) {
        uint32_t d = 0u;
        for (int dy = -1; dy <= 1; ++dy) d |= dilate_row(load_row(strong, row0 + r + dy, w, h, nw));
        e[r * stride + w + 1] = cand[r * stride + w + 1] & d;
      }
    int sweeps = 0, round = 0;
    for (;; ++round) {
      const int p = round & 1;
      // publish this round's boundary rows; the neighbours read them after
      // the barrier.  pub[p] was last read in round - 2.
      __syncthreads();
      if (nrows > 0)
        for (int w = threadIdx.x; w < nw; w += kClusterThreads) {
          pub[2 * p * stride + w + 1] = e[w + 1];
          pub[(2 * p + 1) * stride + w + 1] = e[(nrows - 1) * stride + w + 1];
        }
      cluster.sync();
      if (round > 0) {
        // flag[p ^ 1] holds whether round - 1 changed anything in its CTA
        if (!cluster_any(cluster, flag + (p ^ 1))) break;
      }
      Rows es{e, pub_above[p], pub_below[p], nrows, stride};
      bool changed_round = false;
      for (int local = 1; local;) {
        bool changed = false;
        const bool down = (sweeps & 1) == 0;
        for (int item = threadIdx.x; item < items; item += kClusterThreads) {
          int s = item / nw, w = item - s * nw;
          changed |= grow_strip(es, e, cand, w, s * st.len, min(nrows, (s + 1) * st.len), down);
        }
        local = __syncthreads_or(changed);
        changed_round |= local != 0;
        ++sweeps;
      }
      // flag[p] was last read right after the barrier of round - 1
      if (threadIdx.x == 0) flag[p] = changed_round;
    }
    if (threadIdx.x == 0) {
      if (rank == 0) stats[2 * layer] = round;
      atomicMax(stats + 2 * layer + 1, sweeps);
    }
    store_rows(out + base, e, nrows, nw, stride);
  }
  cluster.sync();  // no CTA leaves while a neighbour may still read its rows or flags
}

template <typename Kernel>
cudaError_t launch_cluster(Kernel kernel, int k, size_t smem, cudaStream_t stream, void** args) {
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)kCluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  // one cluster per layer, as many as fit at once; each loops over layers
  cfg.gridDim = dim3((unsigned)((k < fit ? k : fit) * kCluster));
  err = cudaLaunchKernelExC(&cfg, (const void*)kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Dynamic shared memory of one CTA of the resident route (kind 0: K6, 1: K5).
size_t cluster_smem_bytes(int kind, int h, int nw) {
  size_t rpc = (size_t)((h + kCluster - 1) / kCluster);
  size_t rows = kind == 0 ? 2 * rpc + 1 : 2 * rpc + 5;
  return rows * (size_t)(nw + 2) * 4 + 2 * sizeof(int);
}

}  // namespace

extern "C" {

// K6, resident: the Zhang-Suen fixpoint of `in` ((k, h, nw) boards), one
// cluster of 16 CTAs per layer; iters[layer] gets the iterations it ran.
// The result goes to `out` where it is not null.  With `layout` 1 (packed
// rows, ceil(width/8) bytes a row) or 2 (dense bytes, width a row; the edges
// 255, the skeletons 1), the input's rows (the edges) go to `edges` and the
// result's (the skeletons) to `skels`, layer L = b group + l at byte
// b img_stride + l h row_bytes of each (the chain's blob: skels = edges +
// group h row_bytes, img_stride = 2 group h row_bytes).  Returns a CUDA error
// code (0 on success).
int pw_zs_cluster_run(const uint32_t* in, uint32_t* out, int* iters, uint8_t* edges, uint8_t* skels,
                      long img_stride, int group, int layout, int k, int h, int nw, int width, int max_iter,
                      int rotated, void* stream) {
  if (k <= 0 || h <= 0 || nw <= 0 || layout < 0 || layout > kDense) return (int)cudaErrorInvalidValue;
  if (layout ? (!edges || !skels || group <= 0 || k % group || width <= 0 || (width + 31) / 32 != nw) : !out)
    return (int)cudaErrorInvalidValue;
  int vec = layout == kDense && width % 16 == 0 && img_stride % 16 == 0 && (uintptr_t)edges % 16 == 0 &&
            (uintptr_t)skels % 16 == 0;
  size_t smem = cluster_smem_bytes(0, h, nw);
  void* args[] = {&in, &out, &iters, &edges, &skels, &img_stride, &group, &layout, &k, &h, &nw, &width, &vec,
                  &max_iter};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(rotated ? launch_cluster(zs_cluster<true>, k, smem, s, args)
                       : launch_cluster(zs_cluster<false>, k, smem, s, args));
}

// K5, resident: the hysteresis fixpoint of (cand, strong) into `out`;
// stats[2 layer] gets the rounds and stats[2 layer + 1] (zeroed here) the
// most sweeps one CTA ran.  Returns a CUDA error code.
int pw_hysteresis_cluster_run(const uint32_t* cand, const uint32_t* strong, uint32_t* out,
                              int* stats, int k, int h, int nw, void* stream) {
  if (k <= 0 || h <= 0 || nw <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(stats, 0, sizeof(int) * 2 * k, s);
  if (err != cudaSuccess) return (int)err;
  size_t smem = cluster_smem_bytes(1, h, nw);
  void* args[] = {&cand, &strong, &out, &stats, &k, &h, &nw};
  return (int)launch_cluster(hysteresis_cluster, k, smem, s, args);
}

// K6, multi-launch: n_iter Zhang-Suen iterations from `src` (the call's
// input, or `a` after the first chunk) into `a`; `b` is scratch of the same
// size; flags[it] is set when iteration it changed any word (zeroed here).
// Returns cudaGetLastError().
int pw_zs_packed_run(const uint32_t* src, uint32_t* a, uint32_t* b, int* flags, int k, int h,
                     int nw, int n_iter, int rotated, void* stream) {
  if ((long)k * h * nw == 0 || n_iter <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * n_iter, s);
  if (err != cudaSuccess) return (int)err;
  err = rotated ? zs_iterations<true>(src, a, b, flags, k, h, nw, n_iter, s)
                : zs_iterations<false>(src, a, b, flags, k, h, nw, n_iter, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K5, multi-launch: n_sweeps (even) hysteresis sweeps from `init` (strong,
// or e0 after the first chunk), init -> e1 -> e0 -> e1 ..., so the result is
// in e0; flags[j] is set when sweep j changed any word (zeroed here).
// Returns cudaGetLastError().
int pw_hysteresis_run(const uint32_t* cand, const uint32_t* init, uint32_t* e0, uint32_t* e1,
                      int* flags, int k, int h, int nw, int n_sweeps, void* stream) {
  if ((long)k * h * nw == 0 || n_sweeps <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * n_sweeps, s);
  if (err != cudaSuccess) return (int)err;
  dim3 grid = word_grid(k, h, nw);
  for (int j = 0; j < n_sweeps; ++j) {
    const uint32_t* src = j == 0 ? init : ((j % 2 == 0) ? e0 : e1);
    uint32_t* dst = (j % 2 == 0) ? e1 : e0;
    hysteresis_sweep<<<grid, kThreads, 0, s>>>(cand, src, dst, flags + j, h, nw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

const char* pw_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
