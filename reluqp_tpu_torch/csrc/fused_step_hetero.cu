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
//     in its shared memory for the whole window.
//   * The plan knows B. It starts from the smallest cluster whose slab fits
//     (one block at Dp=128, fp32 and fp64) and doubles it while B problems
//     still take no more blocks than the card has SMs (B=16, Dp=128: a
//     cluster of 8, 128 blocks of 16 columns; B=1024 stays at one block per
//     problem): at small B a problem's iteration is spread over more SMs and
//     each thread's chain gets shorter. Where no slab of a 16-block cluster
//     fits, every block reads its slab from L2 each iteration, as K1 does.
//   * Each block holds the problem's whole y, double buffered. A thread owns
//     16 bytes of output columns (a column group: 4 fp32 or 2 fp64) and one
//     of S "stretches" of the contraction, the inputs i = s, s + S, ...; the
//     S lanes of a column group sit in one warp and add their partial sums
//     with a shuffle butterfly, so no partial sum goes through shared memory
//     and no serial pass adds them. Their lanes then add b, clip and store
//     the 16 bytes into the next buffer: with one block per problem its own,
//     and one block barrier ends the iteration; in a cluster, every block's
//     (st.async, cluster_slab.cuh), S peers at a time, and each block waits
//     on its own mbarrier for the dp entries of the next y, not on a cluster
//     barrier. A block stores into a peer's buffer again only after it has
//     the whole next y, the peer's piece included, which the peer sends
//     after its last read of that buffer.
//   * Where each lane owns one column group and its stretch is a few rows
//     (Dp=128: 16 rows at one block per problem in fp32, 4 rows in clusters
//     of 8), the lane keeps its rows of the slab in registers for the
//     window, loaded once from the bank: no slab in shared memory and no
//     shared-memory traffic for W (at B=1024 two blocks then share an SM
//     where three shared its memory, and the window still runs faster).
//     Otherwise the slab sits in shared memory, or is read from L2 where
//     it does not fit.
//   * The 8 lanes of a quarter warp read 16 bytes each, of 8 / cgw
//     consecutive rows and cgw consecutive column groups (cgw column groups
//     per warp). Where cgw < 8 the slab is swizzled: column group g of row i
//     sits at g ^ ((i * cgw) & 7), so the eight reads hit distinct banks.
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
#include <type_traits>

#include "cluster_slab.cuh"

namespace cg = cooperative_groups;

namespace {

// Most threads per block.
constexpr int kThreads = 256;
// Units each thread has in flight while copying into shared memory.
constexpr int kCopyAhead = 4;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;
// Cluster sizes: the smallest whose slab fits shared memory is taken and
// then doubled while B problems fill no more than the card's SMs; where
// none fits, the largest the card schedules reads its slab from L2.
constexpr int kClusters[] = {1, 2, 4, 8, 16};

// V operand entries (one column group): 16 bytes of fp32/fp64, 8 of bf16.
template <typename T, typename WT>
using Unit = typename std::conditional<sizeof(WT) * Vec16<T>::n == 16, uint4, uint2>::type;

template <int TIER> struct NAcc { static constexpr int n = TIER == TIER_HIGH ? 3 : 1; };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Plan {
  int cluster;       // blocks per problem
  int cw;            // output columns per block
  int threads;       // threads per block
  int ks;            // stretches of the contraction (lanes per column group)
  int rs;            // row stride of the slab (entries; dp where read from L2)
  int swz;           // column groups are swizzled by row (cgw < 8, in smem)
  int smem;          // dynamic shared memory per block
  int w_smem;        // the slab is held in shared memory (else registers or L2)
  int rr;            // rows of the slab each lane holds in registers (0: none)
  int max_clusters;  // clusters (problems) the card holds at once
};

// Rows per lane a slab may keep in registers (its lane's RR rows of one
// column group): at Dp=128, one block of 8 stretches (B=1024) and clusters
// of 8 with 32 stretches (B=16).
constexpr int kRegRows[] = {4, 16};

template <typename T, typename WT, int TIER, bool WSMEM, int RR>
__global__ void __launch_bounds__(kThreads)
k5_kernel(const WT* __restrict__ bank, int n_rho, const int* __restrict__ rho_inds,
          const T* __restrict__ b, const T* __restrict__ lo, const T* __restrict__ hi,
          const T* __restrict__ y_in, T* __restrict__ y_out, int dp, int n_steps,
          const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Vec16<T>::n;
  constexpr int NA = NAcc<TIER>::n;
  using U = Unit<T, WT>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, cw = p.cw, S = p.ks, rs = p.rs;
  const int c = (int)cluster.block_rank();
  const int prob = blockIdx.x / C;
  const int tid = threadIdx.x, nt = blockDim.x;

  // shared memory: y double buffer, the slab's b, lo, hi, the W slab (dp
  // rows of rs entries, the first cw of them used)
  T* cur = reinterpret_cast<T*>(smem_raw);
  T* nxt = cur + dp;
  const size_t off_b = align16(2 * (size_t)dp * sizeof(T));
  T* bs = reinterpret_cast<T*>(smem_raw + off_b);
  T* ls = bs + cw;
  T* hs = ls + cw;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem_raw + off_b + align16(3 * (size_t)cw * sizeof(T)));
  const size_t off_w = off_b + align16(3 * (size_t)cw * sizeof(T)) + 16;
  WT* wslab = reinterpret_cast<WT*>(smem_raw + off_w);

  int k = rho_inds[prob];
  k = k < 0 ? 0 : (k >= n_rho ? n_rho - 1 : k);
  // row i of the block's slab of this problem's rung starts at w + i * dp
  const WT* w = bank + ((size_t)prob * n_rho + k) * dp * dp + (size_t)c * cw;
  const size_t yoff = (size_t)prob * dp;

  {  // the problem's y: 16-byte loads
    const uint4* s = reinterpret_cast<const uint4*>(y_in + yoff);
    uint4* d = reinterpret_cast<uint4*>(cur);
    const int n = dp * (int)sizeof(T) / 16;
    for (int t = tid; t < n; t += nt) d[t] = s[t];
  }
  for (int o = tid; o < cw; o += nt) {
    const size_t gi = yoff + (size_t)c * cw + o;
    bs[o] = b[gi];
    ls[o] = lo[gi];
    hs[o] = hi[gi];
  }
  const int cgs = cw / V;  // column groups of the block
  const int cgw = 32 / S;  // column groups per warp
  const WT* ws = w;
  if (WSMEM) {
    // the slab's dp rows of cw entries, one column group at a time, into
    // rows of rs entries, swizzled
    const int nvec = dp * cgs;
    for (int t0 = tid; t0 < nvec; t0 += kCopyAhead * nt) {
      U v[kCopyAhead];
#pragma unroll
      for (int u = 0; u < kCopyAhead; ++u) {
        const int t = t0 + u * nt;
        if (t < nvec)
          v[u] = *reinterpret_cast<const U*>(w + (size_t)(t / cgs) * dp + (t % cgs) * V);
      }
#pragma unroll
      for (int u = 0; u < kCopyAhead; ++u) {
        const int t = t0 + u * nt;
        if (t < nvec) {
          const int i = t / cgs;
          const int g = (t % cgs) ^ (p.swz ? (i * cgw) & 7 : 0);
          *reinterpret_cast<U*>(wslab + (size_t)i * rs + g * V) = v[u];
        }
      }
    }
    ws = wslab;
  }
  // with RR > 0 (one column group per lane, the plan checks): the lane's RR
  // rows i = s, s + S, ... of its column group, in registers for the window
  WT wr[RR > 0 ? RR : 1][V];
  if (RR > 0) {
    const int lane = tid & 31, cgw = 32 / S, s = lane / cgw;
    const int cgi = (tid >> 5) * cgw + lane % cgw;
#pragma unroll
    for (int k = 0; k < (RR > 0 ? RR : 1); ++k) {
      if (cgi < cgs) {
        loadw(w + (size_t)(s + S * k) * dp + cgi * V, wr[k]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) wr[k][j] = WT();
      }
    }
  }
  // y's next buffer receives all dp entries each iteration, cw from each
  // block; its mbarrier's phases alternate with the buffer's uses
  const uint32_t y_bytes = (uint32_t)(dp * sizeof(T));
  if (C > 1 && tid == 0) {
    mbar_init(bar, 2);
    mbar_expect(bar, y_bytes);
    mbar_expect(bar + 1, y_bytes);
  }
  // every block of the cluster has started (and loaded, and armed its
  // mbarriers) before any block writes into another's shared memory
  cluster.sync();

  // lane = (stretch, column group of the warp): the S lanes of a column
  // group differ in the high bits, so the butterfly runs over xor offsets
  // cgw, 2 cgw, ..., 16
  const int lane = tid & 31, warp = tid >> 5;
  const int s = lane / cgw;
  const int cg_step = (nt >> 5) * cgw;
  // the lane's rows i = s (mod S), S a multiple of 8 where swizzled, so
  // its swizzle is fixed
  const int x = p.swz ? (s * cgw) & 7 : 0;

  for (int it = 0; it < n_steps; ++it) {
    // every lane of a warp runs the same trips (the shuffles need them all)
    for (int base = warp * cgw; base < cgs; base += cg_step) {
      const int cgi = base + lane % cgw;
      const bool on = cgi < cgs;
      T a0[V], a1[V], a2[V];
#pragma unroll
      for (int j = 0; j < V; ++j) a0[j] = a1[j] = a2[j] = T(0);
      if (RR > 0) {
        // the same rows in the same order as from the slab
#pragma unroll
        for (int k = 0; k < (RR > 0 ? RR : 1); ++k) {
          const T yv = cur[s + S * k];
#pragma unroll
          for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv, wr[k][j]);
        }
      } else if (on) {
        const WT* wc = ws + (cgi ^ x) * V;
#pragma unroll 4
        for (int i = s; i < dp; i += S) {
          const T yv = cur[i];
          WT wv[V];
          loadw(wc + (size_t)i * rs, wv);
#pragma unroll
          for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv, wv[j]);
        }
      }
      for (int off = cgw; off < 32; off <<= 1) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a0[j] += __shfl_xor_sync(0xffffffffu, a0[j], off);
          if (NA == 3) {
            a1[j] += __shfl_xor_sync(0xffffffffu, a1[j], off);
            a2[j] += __shfl_xor_sync(0xffffffffu, a2[j], off);
          }
        }
      }
      if (on && s < C) {
        T bv[V], lv[V], hv[V], out[V];
        load16(bs + cgi * V, bv);
        load16(ls + cgi * V, lv);
        load16(hs + cgi * V, hv);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const T acc = (NA == 3) ? (a0[j] + a1[j]) + a2[j] : a0[j];
          T v = acc + bv[j];
          // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
          v = v < lv[j] ? lv[j] : v;
          v = v > hv[j] ? hv[j] : v;
          out[j] = v;
        }
        const int yi = c * cw + cgi * V;
        if (C == 1) {
          store16(nxt + yi, out);
        } else {
          const uint4 v = bits16(out);
          for (int q = s; q < C; q += S) send16(nxt, yi, v, bar + ((it + 1) & 1), q);
        }
      }
    }
    if (C == 1) {
      // every output is in nxt and every read of cur is done
      __syncthreads();
    } else {
      // every block's piece of this iteration has landed here. A peer
      // stores into a buffer again only after it has the whole of the
      // next iteration's y, this block's piece included, which this block
      // sends after its last read of that buffer.
      const int j = (it + 1) & 1;
      mbar_wait(bar + j, (it >> 1) & 1);
      if (tid == 0) mbar_expect(bar + j, y_bytes);
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int o = tid; o < cw; o += nt) y_out[yoff + (size_t)c * cw + o] = cur[c * cw + o];
  // no block exits while a peer's stores into it may be in flight
  if (C > 1) cluster.sync();
}

// The kernel for a plan: slab in shared memory, in registers (RR rows per
// lane) or read from L2.
template <typename T, typename WT, int TIER>
auto kernel_for(const Plan& q) -> decltype(&k5_kernel<T, WT, TIER, true, 0>) {
  if (q.rr == kRegRows[0]) return k5_kernel<T, WT, TIER, false, kRegRows[0]>;
  if (q.rr == kRegRows[1]) return k5_kernel<T, WT, TIER, false, kRegRows[1]>;
  return q.w_smem ? k5_kernel<T, WT, TIER, true, 0> : k5_kernel<T, WT, TIER, false, 0>;
}

template <typename T, typename WT, int TIER>
cudaError_t active_clusters(const Plan& q, int* n) {
  auto fn = kernel_for<T, WT, TIER>(q);
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
  cfg.blockDim = dim3(q.threads);
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

// The shape of a cluster of C blocks at Dp, slab in shared memory or not;
// false where C does not split Dp into whole column groups or the block's
// shared memory would not fit.
template <typename T, typename WT, int TIER>
bool shape(int dp, int C, bool in_smem, size_t budget, Plan* q) {
  constexpr int V = Vec16<T>::n;
  if (dp % C != 0 || (dp / C) % V != 0) return false;
  q->cluster = C;
  q->cw = dp / C;
  const int cgs = q->cw / V;
  // stretches: the most (a power of two, at most 32) that keep every column
  // group's lanes in one warp and the block within kThreads
  int S = 32;
  while (S > 1 && cgs * S > kThreads) S >>= 1;
  q->ks = S;
  const int cgw = 32 / S;
  const int warps = (cgs + cgw - 1) / cgw;
  q->threads = 32 * (warps < kThreads / 32 ? warps : kThreads / 32);
  // where each lane has one column group and S divides Dp into a row
  // count kRegRows lists, the slab lives in registers, not shared memory
  q->rr = 0;
  if (in_smem && cgs <= (q->threads / 32) * cgw && dp % S == 0)
    for (int r : kRegRows)
      if (dp / S == r) q->rr = r;
  const bool slab = in_smem && q->rr == 0;
  // the swizzle (cgw < 8) keeps a column group within its aligned 8, so a
  // row holds a whole number of 8 groups
  q->swz = slab && cgw < 8;
  const int rs16 = q->swz ? (cgs + 7) / 8 * 8 : cgs;
  q->rs = slab ? rs16 * V : dp;
  const size_t need =
      align16(2 * (size_t)dp * sizeof(T)) + align16(3 * (size_t)q->cw * sizeof(T)) + 16;
  const size_t w_bytes = slab ? (size_t)dp * q->rs * sizeof(WT) : 0;
  if (need + w_bytes > budget) return false;
  q->w_smem = slab;
  q->smem = (int)(need + w_bytes);
  return true;
}

// The launch shape for Dp and B rows: the smallest cluster whose column slab
// of a rung fits shared memory beside the rest, doubled while rows x the
// cluster still fit the card's SMs; where none fits, the largest
// schedulable cluster, its slab read from L2.
template <typename T, typename WT, int TIER>
cudaError_t make_plan(int dp, int rows, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int smem_optin = 0, nsm = 0;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  constexpr int V = Vec16<T>::n;
  if (dp < 1 || dp % V != 0 || rows < 1) return cudaErrorInvalidValue;
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  for (int pass = 0; pass < 2; ++pass) {
    const bool in_smem = pass == 0;
    for (int ci = 0; ci < 5; ++ci) {
      const int C = in_smem ? kClusters[ci] : kClusters[4 - ci];
      Plan q;
      if (!shape<T, WT, TIER>(dp, C, in_smem, budget, &q)) continue;
      int n = 0;
      if ((e = active_clusters<T, WT, TIER>(q, &n))) return e;
      if (n < 1) continue;
      q.max_clusters = n;
      // spread each problem wider while the batch leaves SMs idle
      while (in_smem && q.cluster < 16 && (long long)rows * 2 * q.cluster <= nsm) {
        Plan w;
        if (!shape<T, WT, TIER>(dp, 2 * q.cluster, true, budget, &w)) break;
        if ((e = active_clusters<T, WT, TIER>(w, &n))) return e;
        if (n < 1) break;
        w.max_clusters = n;
        q = w;
      }
      *plan = q;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;  // not even y fits one block
}

// make_plan once per device, Dp and row count: its attribute and occupancy
// queries cost more host time than a launch.
template <typename T, typename WT, int TIER>
cudaError_t cached_plan(int dp, int rows, Plan* plan) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, Plan> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, dp, rows);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  if ((e = make_plan<T, WT, TIER>(dp, rows, plan))) return e;
  cache[key] = *plan;
  return cudaSuccess;
}

template <typename T, typename WT, int TIER>
cudaError_t launch_tier(const void* bank, int n_rho, const void* rho_inds, const void* b,
                        const void* lo, const void* hi, const void* y_in, void* y_out, int rows,
                        int dp, int n_steps, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = cached_plan<T, WT, TIER>(dp, rows, &plan);
  if (e != cudaSuccess) return e;
  auto fn = kernel_for<T, WT, TIER>(plan);
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
  cfg.blockDim = dim3(plan.threads);
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
cudaError_t plan_for(int dp, int rows, int tier, Plan* plan) {
  if (tier == TIER_HIGHEST) return cached_plan<T, WT, TIER_HIGHEST>(dp, rows, plan);
  if (tier == TIER_HIGH) return cached_plan<T, WT, TIER_HIGH>(dp, rows, plan);
  return cached_plan<T, WT, TIER_BF16>(dp, rows, plan);
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

// The launch shape k5_fused_chunk_hetero would use at dp and rows, for
// reports: blocks per problem (the cluster), output columns per block,
// dynamic shared memory per block, whether the slab is held in shared
// memory, how many clusters (problems) the card holds at once, the
// contraction's stretches (lanes per column group), threads per block and
// the slab's rows per lane held in registers (0: none).
int k5_plan(int dp, int rows, int y_dtype, int w_dtype, int tier, int* cluster, int* cw,
            int* smem, int* w_smem, int* max_clusters, int* ks, int* threads, int* rr) {
  Plan plan;
  cudaError_t e;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    e = plan_for<float, float>(dp, rows, tier, &plan);
  else if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    e = plan_for<float, __nv_bfloat16>(dp, rows, TIER_BF16, &plan);
  else if (y_dtype == DT_F64 && w_dtype == DT_F64)
    e = plan_for<double, double>(dp, rows, tier, &plan);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *cluster = plan.cluster;
  *cw = plan.cw;
  *smem = plan.smem;
  *w_smem = plan.w_smem;
  *max_clusters = plan.max_clusters;
  *ks = plan.ks;
  *threads = plan.threads;
  *rr = plan.rr;
  return 0;
}

const char* k5_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
