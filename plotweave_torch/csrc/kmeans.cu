// K8: the device k-means of stage 02 (kmeans_init = "device") for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the XLA programs of plotweave/ops/kmeans.py (_lloyd,
// _kpp_init_device, kmeans_fit_device) and the subsample of
// plotweave/stages/s02_color_extract.py::_device_init_stage.  Entry points:
//
// - pw_lab_sample: gathers `n` pixels of a BGR image by index and converts
//   them to float Lab with lab.cuh's arithmetic, K7's bit for bit (this file
//   is compiled with --fmad=false like K7).
// - pw_kpp_init: k-means++ seeding of every attempt, one block per attempt:
//   the first centre by a given index, then k - 1 draws with probability
//   proportional to max(d2, 1e-12), d2 the squared distance to the nearest
//   centre so far (kept in device scratch, updated by min).  The random
//   numbers come from the host (one index and k - 1 uniforms per attempt), so
//   the draw is a pure function: the first index, in index order, whose
//   running sum R(i) exceeds u * total.  The running sum has a FIXED order,
//   which the plain version (ops/kmeans.py::kpp_init_plain) repeats: lane t of
//   1024 owns the chunk [t L, (t + 1) L), L = ceil(n / 1024), and sums it from
//   0 in index order; lane totals are summed in order within each warp of 32
//   lanes and the 32 warp totals in order; R(i) = (warp offset + lane offset)
//   + (the chunk's sum up to and including i).
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
// Bound.  Operations: about 9 float operations per centre, point and
// iteration.  The sample (2.4 MB at 200,000 points) is read from L2 by 16 CTAs
// per iteration; a cooperative grid over all SMs would read it faster but pay
// a grid-wide barrier per iteration, and three attempts already run side by
// side on 48 SMs.  On an H100 the times are in PERF.md.

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
constexpr int kInitThreads = 1024;  // lanes of the seeding's running sum
constexpr int kInitWarps = kInitThreads / 32;

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

// One block per attempt; see the header for the running sum's order.
__global__ void __launch_bounds__(kInitThreads)
    kpp_init(const float* __restrict__ sample, int n, int k, const int32_t* __restrict__ first,
             const float* __restrict__ uniforms, float* __restrict__ d2_all, float* __restrict__ centers_all,
             int32_t* __restrict__ picks_all) {
  __shared__ float lane_tot[kInitThreads];
  __shared__ float lane_off[kInitThreads];
  __shared__ float warp_tot[kInitWarps];
  __shared__ float warp_off[kInitWarps];
  __shared__ float total_s;
  __shared__ float c_s[3];
  __shared__ int hit_s;
  const int a = blockIdx.x, t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const long len = ((long)n + kInitThreads - 1) / kInitThreads;
  const long lo = min((long)t * len, (long)n), hi = min(lo + len, (long)n);
  float* d2 = d2_all + (long)a * n;
  float* centers = centers_all + (long)a * k * 3;
  int idx = first[a];
  for (int j = 0; j < k; ++j) {
    if (t < 3) {
      const float v = sample[3 * (long)idx + t];
      c_s[t] = v;
      centers[3 * j + t] = v;
    }
    if (t == 0) {
      picks_all[a * k + j] = idx;
      hit_s = n;
    }
    __syncthreads();
    if (j == k - 1) break;
    const float c0 = c_s[0], c1 = c_s[1], c2 = c_s[2];
    float run = 0.0f;
    for (long i = lo; i < hi; ++i) {
      const float e0 = sample[3 * i] - c0, e1 = sample[3 * i + 1] - c1, e2 = sample[3 * i + 2] - c2;
      float d = (e0 * e0 + e1 * e1) + e2 * e2;
      if (j > 0) d = fminf(d2[i], d);
      d2[i] = d;
      run = run + fmaxf(d, 1e-12f);
    }
    lane_tot[t] = run;
    __syncthreads();
    if (lane == 0) {
      float r = 0.0f;
      for (int l = 0; l < 32; ++l) {
        lane_off[t + l] = r;
        r = r + lane_tot[t + l];
      }
      warp_tot[warp] = r;
    }
    __syncthreads();
    if (t == 0) {
      float r = 0.0f;
      for (int v = 0; v < kInitWarps; ++v) {
        warp_off[v] = r;
        r = r + warp_tot[v];
      }
      total_s = r;
    }
    __syncthreads();
    const float base = warp_off[warp] + lane_off[t];
    const float target = uniforms[a * (k - 1) + j] * total_s;
    run = 0.0f;
    for (long i = lo; i < hi; ++i) {
      run = run + fmaxf(d2[i], 1e-12f);
      if (base + run > target) {
        atomicMin(&hit_s, (int)i);
        break;
      }
    }
    __syncthreads();
    idx = hit_s < n ? hit_s : n - 1;  // u * total rounded up to the whole sum: the last point
    __syncthreads();                  // every thread has read hit_s and c_s before thread 0 rewrites them
  }
}

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

// k-means++ seeds of `attempts` attempts on sample (n, 3): first (attempts,)
// int32 indices, uniforms (attempts, k - 1) float32 in [0, 1), d2 (attempts,
// n) float32 scratch -> centers (attempts, k, 3) and picks (attempts, k), the
// chosen indices.  Returns a CUDA error code.
int pw_kpp_init(const float* sample, int n, int k, int attempts, const int32_t* first, const float* uniforms,
                float* d2, float* centers, int32_t* picks, void* stream) {
  if (n <= 0 || k <= 0 || attempts <= 0) return (int)cudaErrorInvalidValue;
  kpp_init<<<attempts, kInitThreads, 0, static_cast<cudaStream_t>(stream)>>>(sample, n, k, first, uniforms, d2,
                                                                             centers, picks);
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
