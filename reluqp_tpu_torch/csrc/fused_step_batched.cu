// K4 on Hopper: n_steps iterations of  Y <- clip(Y @ Wt[k] + B, LO, HI)  on a
// (rows, Dp) block of independent state rows that share one rung k.
//
// Replaces the TPU chunk kernel reluqp_tpu/ops/fused_step.py `_kernel` as
// launched by `fused_chunk_batched` (through `pallas_batched_chunk_runner`):
// the hot loop of the shared-(H, A) batched solver (BatchedReLU_QP) and of
// the scenario-MPC loop rollout.
//
// What bounds it: one window reads one Wt rung (Dp*Dp elements, 1.64 MB at
// Dp=640 in fp32) and the rows' b, lo, hi, y, and does 2*n_steps*rows*Dp*Dp
// flops: 2*25*64/4 = 800 flops per byte of W at rows=64 -- far above the
// card's fp32 ridge (~20 flops/byte), so at the batched sizes the fp32
// operations bound it (the tensor cores would lose the "highest" tier's
// fp32 accuracy).
//
// Design:
//   * The rows are independent for all n_steps of a window, so a group of
//     blocks that owns a tile of `rb` rows runs the whole window alone: no
//     grid barrier. (The TPU kernel's whole rung in VMEM does not carry
//     over: one SM has 227 KB of shared memory.)
//   * The group is a thread-block cluster of C blocks (16 where the card
//     schedules such clusters, else 8, ...): block c of the cluster owns the
//     output columns [c*cw, (c+1)*cw), cw = Dp/C, and keeps that column slab
//     of the rung in its shared memory for the whole window, transposed so
//     that a thread reads 16 bytes of its column at a time, where it fits
//     (else it reads the slab from L2 every iteration). Each block holds the
//     tile's whole rows of Y, double buffered; an iteration computes the
//     block's (rb, cw) piece, stores it 16 bytes at a time into every block
//     of the cluster (distributed shared memory), and one cluster barrier
//     ends it. So the rung is read from L2 once per window, not once per
//     iteration per row tile. The slab load and the stores into the peers
//     are csrc/cluster_slab.cuh's, shared with K6.
//   * Inside a block the contraction is split: `ks` groups of threads each
//     sum a contiguous stretch of the Dp inputs for every (row, column) of
//     the piece into register accumulators, 8 rows at a time; the epilogue
//     adds the groups' partial sums in group order, then b, then clips.
//     Where the slab streams from L2, a thread reads the next kAhead * 16
//     bytes of its column before using them.
//   * Tiles are 8 rows, or up to 16 where that puts every tile in the
//     card's first wave of clusters (B=64 at Dp=640 in fp32: 7 clusters of
//     10 rows, 112 blocks; the card holds 7 clusters of 16 such blocks).
//   * The piece's b, lo, hi are read into shared memory once. Input and
//     output are distinct allocations. Padded lanes (zero rows and columns
//     of W, b = 0, lo = -inf, hi = +inf) and inert padded rows stay exactly
//     0.
//   * The rung index is read from a device int32 (the counterpart of scalar
//     prefetch), clamped into range as a dynamic index is on the TPU.
//
// Tiers (tier argument) as csrc/tiers.cuh sets them out, summed in the state
// type.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success), the launch
// error checked right after the launch.

#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "cluster_slab.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
// Rows per tile at most, and rows summed at once in register accumulators.
constexpr int kMaxRows = 16;
constexpr int kRowGroup = 8;
// 16-byte groups of a column's entries read ahead of their use where the
// slab streams from L2.
constexpr int kAhead = 8;
// 16-byte loads each thread has in flight while copying into shared memory.
constexpr int kCopyAhead = 4;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;
// Cluster sizes tried, largest first (16 is beyond the portable 8).
constexpr int kClusters[] = {16, 8, 4, 2, 1};

template <int TIER> struct NAcc { static constexpr int n = TIER == TIER_HIGH ? 3 : 1; };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Copies n 16-byte groups from global to shared memory (both 16-byte
// aligned), kCopyAhead loads in flight per thread.
__device__ __forceinline__ void copy16(void* dst, const void* src, size_t n) {
  const uint4* s = static_cast<const uint4*>(src);
  uint4* d = static_cast<uint4*>(dst);
  for (size_t t0 = threadIdx.x; t0 < n; t0 += kCopyAhead * kThreads) {
    uint4 v[kCopyAhead];
#pragma unroll
    for (int u = 0; u < kCopyAhead; ++u)
      if (t0 + u * kThreads < n) v[u] = s[t0 + u * kThreads];
#pragma unroll
    for (int u = 0; u < kCopyAhead; ++u)
      if (t0 + u * kThreads < n) d[t0 + u * kThreads] = v[u];
  }
}

struct Plan {
  int nblocks, rb, smem, cluster, cw, ks, kc, w_smem, max_clusters;
};

// One group's partial sums of rows [rg, rg + ng) at column jl over its
// inputs [i_begin, i_end), into a0..a2. WSMEM: the slab is transposed in
// shared memory (column jl contiguous), else it is read from the rung in
// global memory (stride dp).
template <typename T, typename WT, int TIER, bool WSMEM>
__device__ __forceinline__ void group_sums(const WT* ws, int wst, const T* cur, int dp, int jl,
                                           int i_begin, int i_end, int rg, int ng,
                                           T (&a0)[kRowGroup], T (&a1)[kRowGroup],
                                           T (&a2)[kRowGroup]) {
  constexpr int V = Vec16<T>::n;
#pragma unroll
  for (int r = 0; r < kRowGroup; ++r) a0[r] = a1[r] = a2[r] = T(0);
  const T* yr = cur + (size_t)rg * dp;
  if (WSMEM) {
    const WT* col = ws + (size_t)jl * wst;
#pragma unroll 2
    for (int i0 = i_begin; i0 < i_end; i0 += V) {
      WT wv[V];
      loadw(col + i0, wv);
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (r < ng) {
          T yv[V];
          load16(yr + (size_t)r * dp + i0, yv);
#pragma unroll
          for (int q = 0; q < V; ++q) mac<TIER, T, T, WT>(a0[r], a1[r], a2[r], yv[q], wv[q]);
        }
      }
    }
    return;
  }
  // from L2: the next kAhead * V entries of the column are loaded before
  // they are used, so that many reads are in flight per thread; the sum
  // still runs over i in order
  const WT* col = ws + jl;
  int i0 = i_begin;
  for (; i0 + kAhead * V <= i_end; i0 += kAhead * V) {
    WT wv[kAhead * V];
#pragma unroll
    for (int q = 0; q < kAhead * V; ++q) wv[q] = col[(size_t)(i0 + q) * wst];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
#pragma unroll
      for (int r = 0; r < kRowGroup; ++r) {
        if (r < ng) {
          T yv[V];
          load16(yr + (size_t)r * dp + i0 + u * V, yv);
#pragma unroll
          for (int q = 0; q < V; ++q)
            mac<TIER, T, T, WT>(a0[r], a1[r], a2[r], yv[q], wv[u * V + q]);
        }
      }
    }
  }
  for (; i0 < i_end; i0 += V) {
    WT wv[V];
#pragma unroll
    for (int q = 0; q < V; ++q) wv[q] = col[(size_t)(i0 + q) * wst];
#pragma unroll
    for (int r = 0; r < kRowGroup; ++r) {
      if (r < ng) {
        T yv[V];
        load16(yr + (size_t)r * dp + i0, yv);
#pragma unroll
        for (int q = 0; q < V; ++q) mac<TIER, T, T, WT>(a0[r], a1[r], a2[r], yv[q], wv[q]);
      }
    }
  }
}

template <typename T, typename WT, int TIER, bool WSMEM>
__global__ void __launch_bounds__(kThreads)
k4_kernel(const WT* __restrict__ wt_bank, int n_rho, const T* __restrict__ b,
          const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ y_in,
          T* __restrict__ y_out, const int* __restrict__ rho_ind, int rows, int dp,
          int n_steps, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Vec16<T>::n;
  constexpr int NA = NAcc<TIER>::n;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, cw = p.cw, rb = p.rb;
  const int c = (int)cluster.block_rank();
  const int tile = blockIdx.x / C;
  const int tid = threadIdx.x;

  // shared memory: Y double buffer, the piece's b, lo, hi, the groups'
  // partial sums, the W slab
  const size_t piece = (size_t)rb * cw;
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + (size_t)rb * dp;
  T* bs = nxt + (size_t)rb * dp;
  T* ls = bs + piece;
  T* hs = ls + piece;
  const size_t off_part = align16((2 * (size_t)rb * dp + 3 * piece) * sizeof(T));
  T* part = reinterpret_cast<T*>(smem_raw + off_part);
  const size_t off_w = off_part + align16((size_t)p.ks * NA * piece * sizeof(T));
  WT* wslab = reinterpret_cast<WT*>(smem_raw + off_w);

  int k = *rho_ind;
  k = k < 0 ? 0 : (k >= n_rho ? n_rho - 1 : k);
  const WT* w = wt_bank + (size_t)k * dp * dp + (size_t)c * cw;

  const int r0 = tile * rb;
  const int nr = min(rb, rows - r0);
  const size_t yoff = (size_t)r0 * dp;
  // the tile's rows: 16-byte loads (dp is a whole number of them), several
  // in flight per thread
  copy16(cur, y_in + yoff, (size_t)nr * dp * sizeof(T) / 16);
  for (int o = tid; o < nr * cw; o += kThreads) {
    const size_t gi = yoff + (size_t)(o / cw) * dp + c * cw + o % cw;
    bs[o] = b[gi];
    ls[o] = lo[gi];
    hs[o] = hi[gi];
  }
  // the slab: rows i, columns [c*cw, (c+1)*cw) of the rung; in shared
  // memory transposed (column jl at wslab + jl * wst), read 16 bytes at a
  // time from global memory
  const WT* ws = w;
  int wst = dp;
  if (WSMEM) {
    wst = slab_stride<WT>(dp);
    load_slab(wslab, w, dp, cw);   // the plan takes cw a multiple of 16 bytes of WT
    ws = wslab;
  }
  // every block of the cluster has started (and loaded) before any block
  // writes into another's shared memory
  cluster.sync();

  const int ccols = cw < kThreads ? cw : kThreads;
  const bool active = tid < p.ks * ccols;
  const int kidx = tid / ccols, jl0 = tid % ccols;
  const int i_begin = kidx * p.kc;
  const int i_end = min(dp, i_begin + p.kc);
  const int cwv = cw / V;   // the plan takes cw a multiple of V

  for (int s = 0; s < n_steps; ++s) {
    if (active) {
      for (int jl = jl0; jl < cw; jl += ccols) {
        for (int rg = 0; rg < nr; rg += kRowGroup) {
          const int ng = min(kRowGroup, nr - rg);
          T a0[kRowGroup], a1[kRowGroup], a2[kRowGroup];
          group_sums<T, WT, TIER, WSMEM>(ws, wst, cur, dp, jl, i_begin, i_end, rg, ng, a0, a1,
                                         a2);
          T* pp = part + (size_t)kidx * NA * piece + (size_t)rg * cw + jl;
#pragma unroll
          for (int r = 0; r < kRowGroup; ++r) {
            if (r < ng) {
              pp[(size_t)r * cw] = a0[r];
              if (NA == 3) {
                pp[piece + (size_t)r * cw] = a1[r];
                pp[2 * piece + (size_t)r * cw] = a2[r];
              }
            }
          }
        }
      }
    }
    __syncthreads();
    // the piece's (rb, cw) outputs, V at a time: the groups' partial sums
    // in group order, + b, clipped, into the next buffer of every block of
    // the cluster as one 16-byte store each
    for (int o4 = tid; o4 < nr * cwv; o4 += kThreads) {
      const int r = o4 / cwv;
      const int o = r * cw + (o4 % cwv) * V;   // within the piece
      T s0[V], s1[V], s2[V];
#pragma unroll
      for (int q = 0; q < V; ++q) s0[q] = s1[q] = s2[q] = T(0);
      for (int g = 0; g < p.ks; ++g) {
        const T* pg = part + (size_t)g * NA * piece + o;
        T v[V];
        load16(pg, v);
#pragma unroll
        for (int q = 0; q < V; ++q) s0[q] += v[q];
        if (NA == 3) {
          load16(pg + piece, v);
#pragma unroll
          for (int q = 0; q < V; ++q) s1[q] += v[q];
          load16(pg + 2 * piece, v);
#pragma unroll
          for (int q = 0; q < V; ++q) s2[q] += v[q];
        }
      }
      T bv[V], lv[V], hv[V], out[V];
      load16(bs + o, bv);
      load16(ls + o, lv);
      load16(hs + o, hv);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const T acc = (NA == 3) ? (s0[q] + s1[q]) + s2[q] : s0[q];
        T v = acc + bv[q];
        // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
        v = v < lv[q] ? lv[q] : v;
        v = v > hv[q] ? hv[q] : v;
        out[q] = v;
      }
      const size_t yi = (size_t)r * dp + c * cw + (o4 % cwv) * V;
      push16(cluster, nxt, yi, out);
    }
    // every piece has landed everywhere (and every read of cur and of the
    // partial sums is done) before the next iteration
    cluster.sync();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int o = tid; o < nr * cw; o += kThreads) {
    const int r = o / cw, j = c * cw + o % cw;
    y_out[yoff + (size_t)r * dp + j] = cur[(size_t)r * dp + j];
  }
}

template <typename T, typename WT, int TIER>
cudaError_t active_clusters(const Plan& q, int* n) {
  auto fn = q.w_smem ? k4_kernel<T, WT, TIER, true> : k4_kernel<T, WT, TIER, false>;
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
  cfg.gridDim = dim3(q.nblocks);
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

// The launch shape: the largest cluster the card schedules whose column
// slab width is a whole number of 16-byte groups; 8 rows per tile (fewer
// where they do not fit), more (up to kMaxRows, keeping the slab in shared
// memory) where that puts every tile in the card's first wave of clusters.
template <typename T, typename WT, int TIER>
cudaError_t make_plan(int rows, int dp, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int smem_optin = 0;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  constexpr int V = Vec16<T>::n;
  constexpr int VW = Vec16<WT>::n;
  constexpr int NA = NAcc<TIER>::n;
  if (rows < 1 || dp < 1 || dp % V != 0) return cudaErrorInvalidValue;
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  for (int C : kClusters) {
    if (dp % C != 0 || (dp / C) % V != 0) continue;
    Plan q;
    q.cluster = C;
    q.cw = dp / C;
    const int ccols = q.cw < kThreads ? q.cw : kThreads;
    q.ks = kThreads / ccols;
    // each group's stretch of inputs: whole 16-byte groups
    q.kc = ((dp + q.ks - 1) / q.ks + V - 1) / V * V;
    q.ks = (dp + q.kc - 1) / q.kc;
    auto need = [&](int rb) {
      return align16((2 * (size_t)rb * dp + 3 * (size_t)rb * q.cw) * sizeof(T)) +
             align16((size_t)q.ks * NA * rb * q.cw * sizeof(T));
    };
    const size_t w_bytes = (size_t)slab_stride<WT>(dp) * q.cw * sizeof(WT);
    const bool w_ok = q.cw % VW == 0;
    auto shape = [&](int rb) {
      q.rb = rb;
      q.w_smem = w_ok && need(rb) + w_bytes <= budget;
      q.smem = (int)(need(rb) + (q.w_smem ? w_bytes : 0));
      q.nblocks = C * ((rows + rb - 1) / rb);
    };
    int rb0 = rows < kRowGroup ? rows : kRowGroup;
    while (rb0 > 1 && need(rb0) > budget) --rb0;
    if (need(rb0) > budget) continue;
    shape(rb0);
    const bool w0 = q.w_smem;
    int n0 = 0;
    if ((e = active_clusters<T, WT, TIER>(q, &n0))) return e;
    if (n0 < 1) continue;
    int rb = (rows + n0 - 1) / n0;
    rb = rb < rb0 ? rb0 : (rb > kMaxRows ? kMaxRows : rb);
    while (rb > rb0 && (need(rb) > budget || (w0 && need(rb) + w_bytes > budget))) --rb;
    shape(rb);
    int n = 0;
    if ((e = active_clusters<T, WT, TIER>(q, &n))) return e;
    if (n < 1) {
      shape(rb0);
      n = n0;
    }
    q.max_clusters = n;
    *plan = q;
    return cudaSuccess;
  }
  return cudaErrorInvalidValue;  // one row does not fit
}

// make_plan once per device and shape: its attribute and occupancy queries
// cost more host time than a launch.
template <typename T, typename WT, int TIER>
cudaError_t cached_plan(int rows, int dp, Plan* plan) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Plan> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, rows, dp);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  if ((e = make_plan<T, WT, TIER>(rows, dp, plan))) return e;
  cache[key] = *plan;
  return cudaSuccess;
}

template <typename T, typename WT, int TIER>
cudaError_t launch_tier(const void* wt_bank, int n_rho, const void* b, const void* lo,
                        const void* hi, const void* y_in, void* y_out, const void* rho_ind,
                        int rows, int dp, int n_steps, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = cached_plan<T, WT, TIER>(rows, dp, &plan);
  if (e != cudaSuccess) return e;
  auto fn = plan.w_smem ? k4_kernel<T, WT, TIER, true> : k4_kernel<T, WT, TIER, false>;
  // another shape's plan may have set a smaller limit since
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = plan.cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(plan.nblocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = plan.smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, fn, static_cast<const WT*>(wt_bank), n_rho,
                         static_cast<const T*>(b), static_cast<const T*>(lo),
                         static_cast<const T*>(hi), static_cast<const T*>(y_in),
                         static_cast<T*>(y_out), static_cast<const int*>(rho_ind), rows, dp,
                         n_steps, plan);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t launch(const void* wt_bank, int n_rho, const void* b, const void* lo,
                   const void* hi, const void* y_in, void* y_out, const void* rho_ind,
                   int rows, int dp, int n_steps, int tier, cudaStream_t stream) {
  if (tier == TIER_HIGHEST)
    return launch_tier<T, WT, TIER_HIGHEST>(wt_bank, n_rho, b, lo, hi, y_in, y_out, rho_ind,
                                            rows, dp, n_steps, stream);
  if (tier == TIER_HIGH)
    return launch_tier<T, WT, TIER_HIGH>(wt_bank, n_rho, b, lo, hi, y_in, y_out, rho_ind,
                                         rows, dp, n_steps, stream);
  return launch_tier<T, WT, TIER_BF16>(wt_bank, n_rho, b, lo, hi, y_in, y_out, rho_ind, rows,
                                       dp, n_steps, stream);
}

template <typename T, typename WT>
cudaError_t plan_for(int rows, int dp, int tier, Plan* plan) {
  if (tier == TIER_HIGHEST) return cached_plan<T, WT, TIER_HIGHEST>(rows, dp, plan);
  if (tier == TIER_HIGH) return cached_plan<T, WT, TIER_HIGH>(rows, dp, plan);
  return cached_plan<T, WT, TIER_BF16>(rows, dp, plan);
}

}  // namespace

extern "C" {

// Runs n_steps iterations on (rows, dp) states; every pointer is a device
// pointer, y_out a distinct allocation. Returns cudaError_t.
int k4_fused_chunk_batched(const void* wt_bank, int w_dtype, int n_rho, const void* b,
                           const void* lo, const void* hi, const void* y_in, void* y_out,
                           const void* rho_ind, int rows, int dp, int n_steps, int tier,
                           int y_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier < TIER_HIGHEST || tier > TIER_BF16 || n_steps < 1 || n_rho < 1)
    return (int)cudaErrorInvalidValue;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    return (int)launch<float, float>(wt_bank, n_rho, b, lo, hi, y_in, y_out, rho_ind, rows,
                                     dp, n_steps, tier, st);
  if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    return (int)launch<float, __nv_bfloat16>(wt_bank, n_rho, b, lo, hi, y_in, y_out, rho_ind,
                                             rows, dp, n_steps, TIER_BF16, st);
  if (y_dtype == DT_F64 && w_dtype == DT_F64)
    return (int)launch<double, double>(wt_bank, n_rho, b, lo, hi, y_in, y_out, rho_ind, rows,
                                       dp, n_steps, tier, st);
  return (int)cudaErrorInvalidValue;
}

// The launch shape k4_fused_chunk_batched would use, for reports: blocks,
// rows per tile, dynamic shared memory, blocks per cluster (column slabs),
// whether the slab is held in shared memory, and how many such clusters the
// card holds at once.
int k4_plan(int rows, int dp, int y_dtype, int w_dtype, int tier, int* nblocks, int* rb,
            int* smem, int* cluster, int* w_smem, int* max_clusters) {
  Plan plan;
  cudaError_t e;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    e = plan_for<float, float>(rows, dp, tier, &plan);
  else if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    e = plan_for<float, __nv_bfloat16>(rows, dp, TIER_BF16, &plan);
  else if (y_dtype == DT_F64 && w_dtype == DT_F64)
    e = plan_for<double, double>(rows, dp, tier, &plan);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *nblocks = plan.nblocks;
  *rb = plan.rb;
  *smem = plan.smem;
  *cluster = plan.cluster;
  *w_smem = plan.w_smem;
  *max_clusters = plan.max_clusters;
  return 0;
}

const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
