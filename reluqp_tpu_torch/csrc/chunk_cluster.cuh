// The chunk kernel on thread-block clusters, shared by K5
// (csrc/fused_step_hetero.cu, row i against the rung r_i of its own ladder)
// and K1 (csrc/fused_step.cu, every row against one shared rung): n_steps
// iterations of  y_i <- clip(y_i @ Wt[i, r_i] + b_i, lo_i, hi_i).
//
// Row i's rung is bank + i * bstride + r_i * Dp * Dp, r_i the clamped
// rho_inds[i * rstride]: K5 passes (N * Dp * Dp, 1), its (B, N, Dp, Dp)
// bank and (B,) rung vector; K1 passes (0, 0), its (N, Dp, Dp) bank and one
// rung. See fused_step_hetero.cu's header for the design: a cluster of C
// blocks owns one row for the whole window, block c its column slab of the
// rung (in shared memory, in registers, or read from L2), the lanes of a
// column group add their stretches with a shuffle butterfly, and the pieces
// of the next y go into every block with st.async, each block waiting on
// its own mbarrier (cluster_slab.cuh). Two choices are K1's alone:
//   * split slab (WM = 2): each lane keeps the last kSplitRegRows of its
//     rows of the slab in registers for the window and the block the rows
//     before them in shared memory; where those do not fit either (Dp=4096)
//     the rows after the registers' are read from L2 every iteration; all
//     in the same order (the sum is the one the whole slab would give).
//     Registers have no bandwidth limit: at Dp=640 a lane's 24 register
//     rows cut each iteration's shared-memory reads from 640 rows to 256;
//   * asynchronous slab load (ALOAD): every thread issues all of its
//     16-byte copies of the slab with cp.async before waiting on any (K5's
//     copy holds 4 in flight per thread, too few where one row's cluster of
//     16 blocks of 160 threads loads a 100 KB slab per block).
//
// Every entry returns a cudaError_t (0 on success), the launch error
// checked right after the launch.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>

#include "cluster_slab.cuh"

namespace {
namespace chunk {

namespace cg = cooperative_groups;

// Most threads per block.
constexpr int kThreads = 256;
// Units each thread has in flight while copying into shared memory.
constexpr int kCopyAhead = 4;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;
// Cluster sizes: the smallest whose slab fits shared memory is taken and
// then doubled while B problems fill no more than the card's SMs; where
// none fits, the largest the card schedules reads its slab from L2. K1
// takes a split slab first, on the widest cluster that keeps its rows in
// one wave (make_plan).
constexpr int kClusters[] = {1, 2, 4, 8, 16};
// Slab modes: read from L2 every iteration, whole in shared memory, or
// split (its first rows in shared memory, the next in registers, any rest
// from L2).
enum { WM_L2 = 0, WM_SMEM = 1, WM_SPLIT = 2 };

// V operand entries (one column group): 16 bytes of fp32/fp64, 8 of bf16.
template <typename T, typename WT>
using Unit = typename std::conditional<sizeof(WT) * Vec16<T>::n == 16, uint4, uint2>::type;

template <int TIER> struct NAcc { static constexpr int n = TIER == TIER_HIGH ? 3 : 1; };

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

struct Plan {
  int cluster;       // blocks per row (the launch's cluster dimension)
  int cw;            // output columns per block
  int threads;       // threads per block
  int ks;            // stretches of the contraction (lanes per column group)
  int rs;            // row stride of the slab (entries; dp where read from L2)
  int swz;           // column groups are swizzled by row (cgw < 8, in smem)
  int smem;          // dynamic shared memory per block
  int wm;            // slab mode: WM_L2, WM_SMEM or WM_SPLIT
  int rsm;           // rows of the slab in shared memory (WM_SPLIT)
  int rr;            // rows of the slab each lane holds in registers (0: none)
  int max_clusters;  // clusters (rows) the card holds at once
};

// What one launch reads and writes.
template <typename T, typename WT>
struct Args {
  const WT* bank;
  size_t bstride;  // entries from one row's ladder to the next (0: shared)
  int n_rho;
  const int* rho_inds;
  int rstride;  // entries from one row's rung index to the next (0: shared)
  const T *b, *lo, *hi, *y_in;
  T* y_out;
  int dp, n_steps;
};

// Rows per lane a slab may keep in registers (its lane's RR rows of one
// column group): at Dp=128, one block of 8 stretches (B=1024) and clusters
// of 8 with 32 stretches (B=16).
constexpr int kRegRows[] = {4, 16};
// Rows per lane a split slab keeps in registers after its rows in shared
// memory (24 x 16 bytes: 96 registers in fp32).
constexpr int kSplitRegRows = 24;

// One 16-byte (8-byte for a bf16 unit) copy from global to shared memory
// through the async path: no register holds it and nothing waits for it
// until cp_async_wait.
template <typename U>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if (sizeof(U) == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename T, typename WT, int TIER, int WM, int RR, bool ALOAD>
__device__ __forceinline__ void chunk_body(const Args<T, WT>& a, const Plan& p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int V = Vec16<T>::n;
  constexpr int NA = NAcc<TIER>::n;
  using U = Unit<T, WT>;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = p.cluster, cw = p.cw, S = p.ks, rs = p.rs, dp = a.dp;
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

  int k = a.rho_inds[(size_t)prob * a.rstride];
  k = k < 0 ? 0 : (k >= a.n_rho ? a.n_rho - 1 : k);
  // row i of the block's slab of this row's rung starts at w + i * dp
  const WT* w = a.bank + (size_t)prob * a.bstride + (size_t)k * dp * dp + (size_t)c * cw;
  const size_t yoff = (size_t)prob * dp;

  {  // the row's y: 16-byte loads
    const uint4* s = reinterpret_cast<const uint4*>(a.y_in + yoff);
    uint4* d = reinterpret_cast<uint4*>(cur);
    const int n = dp * (int)sizeof(T) / 16;
    for (int t = tid; t < n; t += nt) d[t] = s[t];
  }
  for (int o = tid; o < cw; o += nt) {
    const size_t gi = yoff + (size_t)c * cw + o;
    bs[o] = a.b[gi];
    ls[o] = a.lo[gi];
    hs[o] = a.hi[gi];
  }
  const int cgs = cw / V;  // column groups of the block
  const int cgw = 32 / S;  // column groups per warp
  const WT* ws = w;
  // the rows of the slab held in shared memory
  const int rsm = WM == WM_SMEM ? dp : (WM == WM_SPLIT ? p.rsm : 0);
  if (WM != WM_L2) {
    // the slab's rsm rows of cw entries, one column group at a time, into
    // rows of rs entries, swizzled
    const int nvec = rsm * cgs;
    if (ALOAD) {
      for (int t = tid; t < nvec; t += nt) {
        const int i = t / cgs;
        const int g = (t % cgs) ^ (p.swz ? (i * cgw) & 7 : 0);
        cp_async<U>(wslab + (size_t)i * rs + g * V, w + (size_t)i * dp + (t % cgs) * V);
      }
      cp_async_wait();
    }
    for (int t0 = ALOAD ? nvec : tid; t0 < nvec; t0 += kCopyAhead * nt) {
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
  // a split slab (one column group per lane, the plan checks): the lane's
  // rows rsm + s, rsm + s + S, ... (rsm a multiple of S), up to
  // kSplitRegRows of them, in registers for the window
  constexpr int XR = WM == WM_SPLIT ? kSplitRegRows : 1;
  WT wx[XR][V];
  if (WM == WM_SPLIT) {
    const int lane = tid & 31, s = lane / cgw;
    const int cgi = (tid >> 5) * cgw + lane % cgw;
#pragma unroll
    for (int k = 0; k < XR; ++k) {
      const int i = rsm + s + S * k;
      if (cgi < cgs && i < dp) {
        loadw(w + (size_t)i * dp + cgi * V, wx[k]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) wx[k][j] = WT();
      }
    }
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
  const bool exchange = C > 1;
  if (exchange && tid == 0) {
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

  for (int it = 0; it < a.n_steps; ++it) {
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
        int i = s;
        const int i_end = WM == WM_SPLIT ? rsm : dp;
#pragma unroll 4
        for (; i < i_end; i += S) {
          const T yv = cur[i];
          WT wv[V];
          loadw(wc + (size_t)i * rs, wv);
#pragma unroll
          for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv, wv[j]);
        }
        if (WM == WM_SPLIT) {
          // the lane's next rows from registers, then the rest from L2, in
          // the same order
#pragma unroll
          for (int k = 0; k < XR; ++k) {
            if (i < dp) {
              const T yv = cur[i];
#pragma unroll
              for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv, wx[k][j]);
            }
            i += S;
          }
          const WT* wg = w + cgi * V;
#pragma unroll 4
          for (; i < dp; i += S) {
            const T yv = cur[i];
            WT wv[V];
            loadw(wg + (size_t)i * dp, wv);
#pragma unroll
            for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv, wv[j]);
          }
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
  for (int o = tid; o < cw; o += nt) a.y_out[yoff + (size_t)c * cw + o] = cur[c * cw + o];
  // no block exits while a peer's stores into it may be in flight
  if (exchange) cluster.sync();
}

// The kernel entries of one user (K1 or K5): a struct with
//   template <typename T, typename WT, int TIER> static auto get(const Plan&)
// returning that user's __global__ instantiation for the plan's slab mode
// and register rows.

template <typename KF, typename T, typename WT, int TIER>
cudaError_t active_clusters(const Plan& q, int* n) {
  auto fn = KF::template get<T, WT, TIER>(q);
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

// The shape of C blocks per row at Dp, slab mode wm (for WM_SPLIT: as many
// rows in shared memory as fit); false where C does not split Dp into whole
// column groups, or the block's shared memory would not fit.
template <typename T, typename WT, int TIER>
bool shape(int dp, int C, int wm, size_t budget, Plan* q) {
  constexpr int V = Vec16<T>::n;
  if (dp % C != 0 || (dp / C) % V != 0) return false;
  *q = Plan{};
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
  if (wm == WM_SMEM && cgs <= (q->threads / 32) * cgw && dp % S == 0)
    for (int r : kRegRows)
      if (dp / S == r) q->rr = r;
  const bool slab = wm != WM_L2 && q->rr == 0;
  // the swizzle (cgw < 8) keeps a column group within its aligned 8, so a
  // row holds a whole number of 8 groups
  q->swz = slab && cgw < 8;
  const int rs16 = q->swz ? (cgs + 7) / 8 * 8 : cgs;
  q->rs = slab ? rs16 * V : dp;
  const size_t need =
      align16(2 * (size_t)dp * sizeof(T)) + align16(3 * (size_t)q->cw * sizeof(T)) + 16;
  if (need > budget) return false;
  const size_t row_bytes = (size_t)q->rs * sizeof(WT);
  int rows = slab ? dp : 0;
  if (wm == WM_SPLIT) {
    // one column group per lane (its register rows stay with it)
    if (cgs > (q->threads / 32) * cgw) return false;
    // whole stretch periods (so a lane's register rows follow its rows in
    // shared memory), whole 8-row swizzle periods
    const int period = S > 8 ? S : 8;
    const int fit = (int)((budget - need) / row_bytes) / period * period;
    const int left = dp - S * kSplitRegRows;  // rows the registers leave
    rows = left <= 0 ? 0 : (left + period - 1) / period * period;
    if (rows > fit) rows = fit;  // and the rest from L2
  }
  if (need + rows * row_bytes > budget) return false;
  q->wm = wm == WM_SMEM && q->rr > 0 ? WM_L2 : wm;  // registers: no slab
  q->rsm = wm == WM_SPLIT ? rows : 0;
  q->smem = (int)(need + rows * row_bytes);
  return true;
}

// The launch shape for Dp and B rows: the smallest cluster whose column
// slab of a rung fits shared memory beside the rest, doubled while rows x
// the cluster still fit the card's SMs; where none fits, the largest
// schedulable cluster, its slab split between shared memory and L2
// (`split`, K1) or read from L2.
template <typename KF, typename T, typename WT, int TIER>
cudaError_t make_plan(int dp, int rows, bool split, Plan* plan) {
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
  // K1 (`split`) takes a split slab first (registers and shared memory),
  // K5 the whole slab in shared memory
  const int order[2][3] = {{WM_SMEM, WM_SPLIT, WM_L2}, {WM_SPLIT, WM_SMEM, WM_L2}};
  for (int pass = 0; pass < 3; ++pass) {
    const int wm = order[split][pass];
    if (wm == WM_SPLIT && !split) continue;
    for (int ci = 0; ci < 5; ++ci) {
      const int C = wm == WM_SMEM ? kClusters[ci] : kClusters[4 - ci];
      // a split slab: the widest cluster that keeps the rows in one wave
      if (wm == WM_SPLIT && C > 1 && (long long)rows * C > nsm) continue;
      Plan q;
      if (!shape<T, WT, TIER>(dp, C, wm, budget, &q)) continue;
      int n = 0;
      if ((e = active_clusters<KF, T, WT, TIER>(q, &n))) return e;
      if (n < 1) continue;
      q.max_clusters = n;
      // spread each row wider while the batch leaves SMs idle
      while (wm == WM_SMEM && q.cluster < 16 && (long long)rows * 2 * q.cluster <= nsm) {
        Plan w;
        if (!shape<T, WT, TIER>(dp, 2 * q.cluster, WM_SMEM, budget, &w)) break;
        if ((e = active_clusters<KF, T, WT, TIER>(w, &n))) return e;
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
template <typename KF, typename T, typename WT, int TIER>
cudaError_t cached_plan(int dp, int rows, bool split, Plan* plan) {
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
  if ((e = make_plan<KF, T, WT, TIER>(dp, rows, split, plan))) return e;
  cache[key] = *plan;
  return cudaSuccess;
}

template <typename KF, typename T, typename WT, int TIER>
cudaError_t launch_tier(const Args<T, WT>& a, int rows, bool split, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = cached_plan<KF, T, WT, TIER>(a.dp, rows, split, &plan);
  if (e != cudaSuccess) return e;
  auto fn = KF::template get<T, WT, TIER>(plan);
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
  e = cudaLaunchKernelEx(&cfg, fn, a, plan);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename KF, typename T, typename WT>
cudaError_t launch(const Args<T, WT>& a, int rows, int tier, bool split, cudaStream_t stream) {
  if (tier == TIER_HIGHEST) return launch_tier<KF, T, WT, TIER_HIGHEST>(a, rows, split, stream);
  if (tier == TIER_HIGH) return launch_tier<KF, T, WT, TIER_HIGH>(a, rows, split, stream);
  return launch_tier<KF, T, WT, TIER_BF16>(a, rows, split, stream);
}

template <typename KF, typename T, typename WT>
cudaError_t plan_for(int dp, int rows, int tier, bool split, Plan* plan) {
  if (tier == TIER_HIGHEST) return cached_plan<KF, T, WT, TIER_HIGHEST>(dp, rows, split, plan);
  if (tier == TIER_HIGH) return cached_plan<KF, T, WT, TIER_HIGH>(dp, rows, split, plan);
  return cached_plan<KF, T, WT, TIER_BF16>(dp, rows, split, plan);
}

// Dispatch on the state and bank dtype codes: f(T(), WT(), tier), the tier
// forced to bf16 for a bf16 bank.
template <typename F>
cudaError_t dispatch(int y_dtype, int w_dtype, int tier, F&& f) {
  if (y_dtype == DT_F32 && w_dtype == DT_F32) return f(float(), float(), tier);
  if (y_dtype == DT_F32 && w_dtype == DT_BF16) return f(float(), __nv_bfloat16(), TIER_BF16);
  if (y_dtype == DT_F64 && w_dtype == DT_F64) return f(double(), double(), tier);
  return cudaErrorInvalidValue;
}

}  // namespace chunk
}  // namespace
