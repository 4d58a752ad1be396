// K5 on Hopper: n_steps iterations of  y_i <- clip(y_i @ Wt[i, r_i] + b_i, lo_i, hi_i)
// for every problem i of a heterogeneous batch: problem i has its own ladder
// of Wt blocks (a (B, N, Dp, Dp) bank) and walks its own rung r_i.
//
// Replaces the TPU kernel reluqp_tpu/ops/fused_step.py `_kernel_hetero` as
// launched by `fused_chunk_hetero` (through `pallas_hetero_chunk_runner`):
// the hot loop of the heterogeneous batched solver (BatchedReLU_QP with
// per-problem H and A).
//
// What bounds it: one window reads each problem's current rung once (B*Dp*Dp
// elements, 67 MB at B=1024, Dp=128 in fp32) and the rows' b, lo, hi, y, and
// does 2*n_steps*B*Dp*Dp flops: 2*25/4 = 12.5 flops per byte of W, below the
// card's fp32 ridge (~20 flops per byte). So device-memory bytes bound it, and
// the design reads every rung from device memory once per window and never
// more (the TPU kernel's point: it keeps the gathered block in VMEM for the
// window).
//
// Design:
//   * The rung index of each problem is read from a device int32 (B,) array
//     and the rung is addressed inside the bank; nothing materializes the
//     gathered (B, Dp, Dp) copy (the TPU runner does, once per window: at
//     B=1024, Dp=128 that copy alone moves twice the kernel's bound).
//   * Problems are independent for all n_steps of a window, so a thread-block
//     cluster of C blocks owns one problem and runs its window alone: no grid
//     barrier. Block c of the cluster owns the output columns [c*cw,
//     (c+1)*cw), cw = Dp/C, and keeps that column slab of the problem's rung
//     in its shared memory for the whole window. C is the smallest cluster
//     whose slab fits: C=1 at Dp=128 in fp32 (a 64 KB rung; three such blocks
//     share an SM), C=2 at Dp=256. Where no slab of a 16-block cluster fits,
//     every block reads its slab from L2 each iteration, as K1 and K2 do.
//   * Each block holds the problem's whole y, double buffered; an iteration
//     computes the block's cw outputs, stores them 16 bytes at a time into
//     every block of the cluster (distributed shared memory), and one cluster
//     barrier ends it (with C=1, a block barrier).
//   * Inside a block a thread owns 16 bytes of output columns (4 fp32 or 2
//     fp64) and a contiguous stretch of the Dp inputs; it reads 16 bytes of a
//     slab row at a time (neighbouring threads, neighbouring columns) and y as
//     a broadcast. The epilogue adds the stretches' partial sums in stretch
//     order, then b, then clips.
//   * Padded lanes (zero rows and columns of W, b = 0, lo = -inf, hi = +inf)
//     stay exactly 0. The rung index is clamped into range as a dynamic index
//     is on the TPU. Input and output are distinct allocations.
//
// Tiers (tier argument) as csrc/tiers.cuh sets them out, summed in the state
// type, as K4 sums.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success), the launch error
// checked right after the launch.

#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "tiers.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// 16-byte loads each thread has in flight while copying into shared memory.
constexpr int kCopyAhead = 4;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;
// Cluster sizes: the smallest whose slab fits shared memory is taken; where
// none fits, the largest the card schedules reads its slab from L2.
constexpr int kClusters[] = {1, 2, 4, 8, 16};

// Elements in 16 bytes: 4 floats or 2 doubles.
template <typename T> struct Vec16 { static constexpr int n = 16 / sizeof(T); };

template <int TIER> struct NAcc { static constexpr int n = TIER == TIER_HIGH ? 3 : 1; };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}

// V consecutive operand entries of one slab row (V = the state type's 16
// bytes): 16 bytes of fp32/fp64, 8 bytes of bf16; shared or global memory.
__device__ __forceinline__ void loadw(const float* p, float (&v)[4]) { load16(p, v); }
__device__ __forceinline__ void loadw(const double* p, double (&v)[2]) { load16(p, v); }
__device__ __forceinline__ void loadw(const __nv_bfloat16* p, __nv_bfloat16 (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&q);
  v[0] = e[0], v[1] = e[1], v[2] = e[2], v[3] = e[3];
}

struct Plan {
  int cluster;       // blocks per problem
  int cw;            // output columns per block
  int ks;            // stretches of the contraction (thread groups)
  int kc;            // inputs per stretch
  int ccv;           // 16-byte column groups computed at once per stretch
  int smem;          // dynamic shared memory per block
  int w_smem;        // the slab is held in shared memory (else read from L2)
  int max_clusters;  // clusters (problems) the card holds at once
};

template <typename T, typename WT, int TIER, bool WSMEM>
__global__ void __launch_bounds__(kThreads)
k5_kernel(const WT* __restrict__ bank, int n_rho, const int* __restrict__ rho_inds,
          const T* __restrict__ b, const T* __restrict__ lo, const T* __restrict__ hi,
          const T* __restrict__ y_in, T* __restrict__ y_out, int dp, int n_steps,
          const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Vec16<T>::n;
  constexpr int NA = NAcc<TIER>::n;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, cw = p.cw;
  const int c = (int)cluster.block_rank();
  const int prob = blockIdx.x / C;
  const int tid = threadIdx.x;

  // shared memory: y double buffer, the slab's b, lo, hi, the stretches'
  // partial sums, the W slab (rows of cw entries, contiguous)
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + dp;
  const size_t off_b = align16(2 * (size_t)dp * sizeof(T));
  T* bs = reinterpret_cast<T*>(smem_raw + off_b);
  T* ls = bs + cw;
  T* hs = ls + cw;
  const size_t off_part = off_b + align16(3 * (size_t)cw * sizeof(T));
  T* part = reinterpret_cast<T*>(smem_raw + off_part);
  const size_t off_w = off_part + align16((size_t)p.ks * NA * cw * sizeof(T));
  WT* wslab = reinterpret_cast<WT*>(smem_raw + off_w);

  int k = rho_inds[prob];
  k = k < 0 ? 0 : (k >= n_rho ? n_rho - 1 : k);
  // row i of the block's slab of this problem's rung starts at w + i * dp
  const WT* w = bank + ((size_t)prob * n_rho + k) * dp * dp + (size_t)c * cw;
  const size_t yoff = (size_t)prob * dp;

  {  // the problem's y: 16-byte loads, several in flight per thread
    const uint4* s = reinterpret_cast<const uint4*>(y_in + yoff);
    uint4* d = reinterpret_cast<uint4*>(cur);
    const int n = dp * (int)sizeof(T) / 16;
    for (int t = tid; t < n; t += kThreads) d[t] = s[t];
  }
  for (int o = tid; o < cw; o += kThreads) {
    const size_t gi = yoff + (size_t)c * cw + o;
    bs[o] = b[gi];
    ls[o] = lo[gi];
    hs[o] = hi[gi];
  }
  const WT* ws = w;
  int wst = dp;
  if (WSMEM) {
    // the slab's dp rows of cw entries, read 16 bytes at a time (the plan
    // takes cw * sizeof(WT) a multiple of 16)
    const int rv = cw * (int)sizeof(WT) / 16;
    const int nvec = dp * rv;
    uint4* d = reinterpret_cast<uint4*>(wslab);
    for (int t0 = tid; t0 < nvec; t0 += kCopyAhead * kThreads) {
      uint4 v[kCopyAhead];
#pragma unroll
      for (int u = 0; u < kCopyAhead; ++u) {
        const int t = t0 + u * kThreads;
        if (t < nvec) v[u] = reinterpret_cast<const uint4*>(w + (size_t)(t / rv) * dp)[t % rv];
      }
#pragma unroll
      for (int u = 0; u < kCopyAhead; ++u) {
        const int t = t0 + u * kThreads;
        if (t < nvec) d[t] = v[u];
      }
    }
    ws = wslab;
    wst = cw;
  }
  // every block of the cluster has started (and loaded) before any block
  // writes into another's shared memory
  cluster.sync();

  const int cv = cw / V;   // the plan takes cw a multiple of V
  const int ccv = p.ccv;
  const bool active = tid < p.ks * ccv;
  const int kidx = tid / ccv, jv0 = tid % ccv;
  const int i_begin = kidx * p.kc;
  const int i_end = min(dp, i_begin + p.kc);

  for (int s = 0; s < n_steps; ++s) {
    if (active) {
      for (int jv = jv0; jv < cv; jv += ccv) {
        T a0[V], a1[V], a2[V];
#pragma unroll
        for (int j = 0; j < V; ++j) a0[j] = a1[j] = a2[j] = T(0);
        const WT* wc = ws + jv * V;
#pragma unroll 2
        for (int i0 = i_begin; i0 < i_end; i0 += V) {
          T yv[V];
          load16(cur + i0, yv);
          WT wv[V][V];
#pragma unroll
          for (int q = 0; q < V; ++q) loadw(wc + (size_t)(i0 + q) * wst, wv[q]);
#pragma unroll
          for (int q = 0; q < V; ++q) {
#pragma unroll
            for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv[q], wv[q][j]);
          }
        }
        T* pp = part + (size_t)kidx * NA * cw + jv * V;
        store16(pp, a0);
        if (NA == 3) {
          store16(pp + cw, a1);
          store16(pp + 2 * cw, a2);
        }
      }
    }
    __syncthreads();
    // the block's cw outputs, V at a time: the stretches' partial sums in
    // stretch order, + b, clipped, into the next buffer of every block of
    // the cluster as one 16-byte store each
    for (int o = tid; o < cv; o += kThreads) {
      T s0[V], s1[V], s2[V];
#pragma unroll
      for (int q = 0; q < V; ++q) s0[q] = s1[q] = s2[q] = T(0);
      for (int g = 0; g < p.ks; ++g) {
        const T* pg = part + (size_t)g * NA * cw + o * V;
        T v[V];
        load16(pg, v);
#pragma unroll
        for (int q = 0; q < V; ++q) s0[q] += v[q];
        if (NA == 3) {
          load16(pg + cw, v);
#pragma unroll
          for (int q = 0; q < V; ++q) s1[q] += v[q];
          load16(pg + 2 * cw, v);
#pragma unroll
          for (int q = 0; q < V; ++q) s2[q] += v[q];
        }
      }
      T bv[V], lv[V], hv[V], out[V];
      load16(bs + o * V, bv);
      load16(ls + o * V, lv);
      load16(hs + o * V, hv);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T acc = (NA == 3) ? (s0[q] + s1[q]) + s2[q] : s0[q];
        T v = acc + bv[q];
        // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
        v = v < lv[q] ? lv[q] : v;
        v = v > hv[q] ? hv[q] : v;
        out[q] = v;
      }
      const int yi = c * cw + o * V;
      for (int q = 0; q < C; ++q) store16(cluster.map_shared_rank(nxt, q) + yi, out);
    }
    // every piece has landed everywhere (and every read of cur and of the
    // partial sums is done) before the next iteration; no block exits while
    // a peer may still write into it
    cluster.sync();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int o = tid; o < cw; o += kThreads) y_out[yoff + (size_t)c * cw + o] = cur[c * cw + o];
}

template <typename T, typename WT, int TIER>
cudaError_t active_clusters(const Plan& q, int* n) {
  auto fn = q.w_smem ? k5_kernel<T, WT, TIER, true> : k5_kernel<T, WT, TIER, false>;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem)))
    return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = q.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(q.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = q.smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  *n = 0;
  e = cudaOccupancyMaxActiveClusters(n, fn, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    *n = 0;
  }
  return cudaSuccess;
}

// The launch shape for Dp: the smallest cluster whose column slab of a rung
// (a whole number of 16-byte row pieces) fits shared memory beside the rest;
// where none fits, the largest schedulable cluster, its slab read from L2.
template <typename T, typename WT, int TIER>
cudaError_t make_plan(int dp, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int smem_optin = 0;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  constexpr int V = Vec16<T>::n;
  constexpr int NA = NAcc<TIER>::n;
  if (dp < 1 || dp % V != 0) return cudaErrorInvalidValue;
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  for (int pass = 0; pass < 2; ++pass) {
    const bool in_smem = pass == 0;
    for (int ci = 0; ci < 5; ++ci) {
      const int C = in_smem ? kClusters[ci] : kClusters[4 - ci];
      if (dp % C != 0 || (dp / C) % V != 0) continue;
      Plan q;
      q.cluster = C;
      q.cw = dp / C;
      if (in_smem && (q.cw * sizeof(WT)) % 16 != 0) continue;
      const int cv = q.cw / V;
      q.ccv = cv < kThreads ? cv : kThreads;
      q.ks = kThreads / q.ccv;
      // each stretch: whole 16-byte groups of y
      q.kc = ((dp + q.ks - 1) / q.ks + V - 1) / V * V;
      q.ks = (dp + q.kc - 1) / q.kc;
      const size_t need = align16(2 * (size_t)dp * sizeof(T)) +
                          align16(3 * (size_t)q.cw * sizeof(T)) +
                          align16((size_t)q.ks * NA * q.cw * sizeof(T));
      const size_t w_bytes = in_smem ? (size_t)dp * q.cw * sizeof(WT) : 0;
      if (need + w_bytes > budget) continue;
      q.w_smem = in_smem;
      q.smem = (int)(need + w_bytes);
      int n = 0;
      if ((e = active_clusters<T, WT, TIER>(q, &n))) return e;
      if (n < 1) continue;
      q.max_clusters = n;
      *plan = q;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;  // not even y fits one block
}

// make_plan once per device and Dp: its attribute and occupancy queries cost
// more host time than a launch.
template <typename T, typename WT, int TIER>
cudaError_t cached_plan(int dp, Plan* plan) {
  static std::mutex mu;
  static std::map<std::tuple<int, int>, Plan> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, dp);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  if ((e = make_plan<T, WT, TIER>(dp, plan))) return e;
  cache[key] = *plan;
  return cudaSuccess;
}

template <typename T, typename WT, int TIER>
cudaError_t launch_tier(const void* bank, int n_rho, const void* rho_inds, const void* b,
                        const void* lo, const void* hi, const void* y_in, void* y_out, int rows,
                        int dp, int n_steps, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = cached_plan<T, WT, TIER>(dp, &plan);
  if (e != cudaSuccess) return e;
  auto fn = plan.w_smem ? k5_kernel<T, WT, TIER, true> : k5_kernel<T, WT, TIER, false>;
  // another shape's plan may have set a smaller limit since
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)rows * plan.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, static_cast<const WT*>(bank), n_rho,
                         static_cast<const int*>(rho_inds), static_cast<const T*>(b),
                         static_cast<const T*>(lo), static_cast<const T*>(hi),
                         static_cast<const T*>(y_in), static_cast<T*>(y_out), dp, n_steps, plan);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t launch(const void* bank, int n_rho, const void* rho_inds, const void* b,
                   const void* lo, const void* hi, const void* y_in, void* y_out, int rows,
                   int dp, int n_steps, int tier, cudaStream_t stream) {
  if (tier == TIER_HIGHEST)
    return launch_tier<T, WT, TIER_HIGHEST>(bank, n_rho, rho_inds, b, lo, hi, y_in, y_out, rows,
                                            dp, n_steps, stream);
  if (tier == TIER_HIGH)
    return launch_tier<T, WT, TIER_HIGH>(bank, n_rho, rho_inds, b, lo, hi, y_in, y_out, rows,
                                         dp, n_steps, stream);
  return launch_tier<T, WT, TIER_BF16>(bank, n_rho, rho_inds, b, lo, hi, y_in, y_out, rows, dp,
                                       n_steps, stream);
}

template <typename T, typename WT>
cudaError_t plan_for(int dp, int tier, Plan* plan) {
  if (tier == TIER_HIGHEST) return cached_plan<T, WT, TIER_HIGHEST>(dp, plan);
  if (tier == TIER_HIGH) return cached_plan<T, WT, TIER_HIGH>(dp, plan);
  return cached_plan<T, WT, TIER_BF16>(dp, plan);
}

}  // namespace

extern "C" {

// Runs n_steps iterations on (rows, dp) states, problem i against rung
// rho_inds[i] of its own ladder bank[i] ((rows, n_rho, dp, dp)); every
// pointer is a device pointer, y_out a distinct allocation. Returns
// cudaError_t.
int k5_fused_chunk_hetero(const void* bank, int w_dtype, int n_rho, const void* rho_inds,
                          const void* b, const void* lo, const void* hi, const void* y_in,
                          void* y_out, int rows, int dp, int n_steps, int tier, int y_dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier < TIER_HIGHEST || tier > TIER_BF16 || n_steps < 1 || n_rho < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    return (int)launch<float, float>(bank, n_rho, rho_inds, b, lo, hi, y_in, y_out, rows, dp,
                                     n_steps, tier, st);
  if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    return (int)launch<float, __nv_bfloat16>(bank, n_rho, rho_inds, b, lo, hi, y_in, y_out,
                                             rows, dp, n_steps, TIER_BF16, st);
  if (y_dtype == DT_F64 && w_dtype == DT_F64)
    return (int)launch<double, double>(bank, n_rho, rho_inds, b, lo, hi, y_in, y_out, rows, dp,
                                       n_steps, tier, st);
  return (int)cudaErrorInvalidValue;
}

// The launch shape k5_fused_chunk_hetero would use at dp, for reports:
// blocks per problem (the cluster), output columns per block, dynamic shared
// memory per block, whether the slab is held in shared memory, how many
// clusters (problems) the card holds at once, and the contraction's
// stretches per block.
int k5_plan(int dp, int y_dtype, int w_dtype, int tier, int* cluster, int* cw, int* smem,
            int* w_smem, int* max_clusters, int* ks) {
  Plan plan;
  cudaError_t e;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    e = plan_for<float, float>(dp, tier, &plan);
  else if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    e = plan_for<float, __nv_bfloat16>(dp, TIER_BF16, &plan);
  else if (y_dtype == DT_F64 && w_dtype == DT_F64)
    e = plan_for<double, double>(dp, tier, &plan);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *cluster = plan.cluster;
  *cw = plan.cw;
  *smem = plan.smem;
  *w_smem = plan.w_smem;
  *max_clusters = plan.max_clusters;
  *ks = plan.ks;
  return 0;
}

const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
