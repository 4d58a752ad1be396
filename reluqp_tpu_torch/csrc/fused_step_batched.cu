// K4 on Hopper: n_steps iterations of  Y <- clip(Y @ Wt[k] + B, LO, HI)  on a
// (rows, Dp) block of independent state rows that share one rung k.
//
// Replaces the TPU chunk kernel reluqp_tpu/ops/fused_step.py `_kernel` as
// launched by `fused_chunk_batched` (through `pallas_batched_chunk_runner`):
// the hot loop of the shared-(H, A) batched solver (BatchedReLU_QP) and of
// the scenario-MPC loop rollout.
//
// What bounds it: one window reads one Wt rung (Dp*Dp elements, 64 KB at
// Dp=128 and 1.64 MB at Dp=640 in fp32) and the rows' b, lo, hi, y, and
// does 2*n_steps*rows*Dp*Dp flops: 2*25*64/4 = 800 flops per byte of W at
// rows=64, far more at the shared batch's B=10000 -- far above the card's
// fp32 ridge (~20 flops/byte), so the fp32 operations bound it (the tensor
// cores would lose the "highest" tier's fp32 accuracy).
//
// The rows are independent for all n_steps of a window, so whatever owns a
// tile of rows runs the whole window alone: no grid barrier. Two regimes,
// chosen by the plan from (Dp, state type, operand type, tier) alone, never
// from B:
//
// Tile regime, where the whole rung and the smallest tile fit one block's
// shared memory (Dp=128 in fp32 and fp64, Dp=256 with a bf16 bank). The
// TPU kernel's design carries over: one block per row tile holds the rung
// and the tile's rows of Y in shared memory for the window.
//   * The rung is copied once per launch with cp.async (16 bytes a copy,
//     every copy in flight at once), as stored: row i of Wt contiguous.
//   * Y is double buffered in shared memory (row stride Dp + 16 bytes, so
//     that neighbouring rows fall in distinct banks); one __syncthreads
//     ends an iteration. No cluster, no exchange, no split of the sums.
//   * The product is register-tiled: a thread owns TM rows x two 16-byte
//     column groups of outputs (4 x 8 in fp32, 4 x 4 in fp64; 2 rows in the
//     "high" tier, whose three sums take three accumulators). It walks the
//     Dp inputs in order, reading 16 bytes of each of its rows of y one
//     group ahead of their use (the warp's lanes of one row read the same
//     address: a broadcast) and 16 bytes of each of its column groups of W
//     (the lanes read neighbouring addresses). Every output's sum runs
//     over i = 0 .. Dp-1 in order into one accumulator per tier sum, so a
//     row's bits depend on neither B nor the tile it falls in.
//   * The budget: 227 KB of shared memory and 64K registers per SM. At
//     the 76-row tile of B=10000 over 132 SMs the rung takes 64 KB and the
//     y buffers 79 KB, so b, lo and hi (114 KB) do not all fit beside them.
//     b lives in the registers of the thread that owns the output (32 a
//     thread in fp32, loaded once per launch); lo and hi in shared memory
//     (76 KB), laid out by thread so that each thread's 16-byte reads of its
//     own entries are neighbouring addresses (8 reads a thread per
//     iteration, against 384 of y and W in the product). With b, lo and
//     hi all in registers the fp32 kernel needed 168 registers at the
//     launch bound, spilled, and could not read y ahead: 0.300 ms per
//     window at B=10000 on an H100 (PERF.md). The cost is the cap on the tile: 76
//     rows at Dp=128 in fp32 (24 in fp64), and at most 320 threads (TM rows
//     per 16-byte column group thread: 40 rows in the "high" tier).
//   * Rows per tile come from B: enough tiles to fill the card's SMs in one
//     wave where B allows (B=10000: 76 rows, 132 blocks), at least TM, at
//     most the cap; the last tile may be ragged (its missing rows are zero
//     in shared memory and never stored).
//   * The last iteration stores from registers straight to y_out.
//
// Cluster regime, everywhere else (the rung does not fit one block, e.g.
// Dp=640 in fp32, 1.6 MB):
//   * A group of blocks that owns a tile of `rb` rows is a thread-block
//     cluster of C blocks (16 where the card schedules such clusters, else
//     8, ...): block c of the cluster owns the output columns [c*cw,
//     (c+1)*cw), cw = Dp/C, and keeps that column slab of the rung in its
//     shared memory for the whole window, transposed so that a thread reads
//     16 bytes of its column at a time, where it fits (else it reads the
//     slab from L2 every iteration). Each block holds the tile's whole rows
//     of Y, double buffered; an iteration computes the block's (rb, cw)
//     piece, stores it 16 bytes at a time into every block of the cluster
//     (distributed shared memory), and one cluster barrier ends it. So the
//     rung is read from L2 once per window, not once per iteration per row
//     tile. The slab load and the stores into the peers are
//     csrc/cluster_slab.cuh's, shared with K6.
//   * Inside a block the contraction is split: `ks` groups of threads each
//     sum a contiguous stretch of the Dp inputs for every (row, column) of
//     the piece into register accumulators, 8 rows at a time; the epilogue
//     adds the groups' partial sums in group order, then b, then clips. The
//     stretches depend on Dp and the cluster only, so here too a row's bits
//     do not depend on B. Where the slab streams from L2, a thread reads
//     the next kAhead * 16 bytes of its column before using them.
//   * Tiles are 8 rows, or up to 16 where that puts every tile in the
//     card's first wave of clusters (B=64 at Dp=640 in fp32: 7 clusters of
//     10 rows, 112 blocks; the card holds 7 clusters of 16 such blocks).
//   * The piece's b, lo, hi are read into shared memory once.
//
// Both regimes: input and output are distinct allocations. Padded lanes
// (zero rows and columns of W, b = 0, lo = -inf, hi = +inf) and inert
// padded rows stay exactly 0. The epilogue clips with comparisons, so a NaN
// propagates. The rung index is read from a device int32 (the counterpart
// of scalar prefetch), clamped into range as a dynamic index is on the TPU.
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

// tile: the tile regime (one block per row tile, the whole rung in shared
// memory), else the cluster regime; threads: per block.
struct Plan {
  int nblocks, rb, smem, cluster, cw, ks, kc, w_smem, max_clusters, threads, tile;
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

// ---- the tile regime ----------------------------------------------------

// The launch bound of the tile kernel: at most 200 registers a thread.
constexpr int kTileThreads = 320;

// A thread's outputs: TM rows x NG column groups of V entries (16 bytes of
// the state type each).
template <typename T, int TIER> struct TileShape {
  static constexpr int V = Vec16<T>::n;
  static constexpr int TM = NAcc<TIER>::n == 3 ? 2 : 4;
  static constexpr int NG = 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

template <typename T, typename WT, int TIER>
__global__ void __launch_bounds__(kTileThreads, 1)
k4_tile_kernel(const WT* __restrict__ wt_bank, int n_rho, const T* __restrict__ b,
               const T* __restrict__ lo, const T* __restrict__ hi, const T* __restrict__ y_in,
               T* __restrict__ y_out, const int* __restrict__ rho_ind, int rows, int dp,
               int n_steps, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  using S = TileShape<T, TIER>;
  constexpr int V = S::V, TM = S::TM, NG = S::NG, N = NG * V;
  constexpr int VW = Vec16<WT>::n;
  constexpr int NA = NAcc<TIER>::n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rb = p.rb;
  const int ncg = dp / N;    // threads across the columns
  const int nrg = rb / TM;   // threads across the rows
  const int c = tid % ncg, rg = tid / ncg;
  const int ys = dp + V;     // row stride of y in shared memory

  // shared memory: the rung (row i of Wt contiguous), the y double buffer,
  // then lo and hi of every thread's outputs, 16 bytes of thread t's
  // (row m, column group g) at [(m*NG + g)*nt + t]
  WT* w = reinterpret_cast<WT*>(smem_raw);
  T* cur = reinterpret_cast<T*>(smem_raw + align16((size_t)dp * dp * sizeof(WT)));
  T* nxt = cur + (size_t)rb * ys;
  T* los = nxt + (size_t)rb * ys;
  T* his = los + (size_t)rb * dp;

  int k = *rho_ind;
  k = k < 0 ? 0 : (k >= n_rho ? n_rho - 1 : k);
  const WT* wk = wt_bank + (size_t)k * dp * dp;
  const int r0 = blockIdx.x * rb;
  const int nr = min(rb, rows - r0);

  // the rung and the tile's rows, 16 bytes a copy, all in flight at once;
  // rows past the batch's end are zero
  const int nw = dp * dp / VW;
  for (int t = tid; t < nw; t += nt) cp_async16(w + (size_t)t * VW, wk + (size_t)t * VW);
  const int rv = dp / V;
  for (int t = tid; t < rb * rv; t += nt) {
    const int r = t / rv, j = (t % rv) * V;
    if (r < nr) {
      cp_async16(cur + (size_t)r * ys + j, y_in + (size_t)(r0 + r) * dp + j);
    } else {
      T z[V];
#pragma unroll
      for (int e = 0; e < V; ++e) z[e] = T(0);
      store16(cur + (size_t)r * ys + j, z);
    }
  }
  // the thread's outputs: rows rg + m*nrg, columns (g*ncg + c)*V + e; b in
  // registers and lo, hi in shared memory for the window (0 on rows past
  // the end); each thread reads back only what it stored
  T rbv[TM][N];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int row = rg + m * nrg;
    const bool in = row < nr;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      T lv[V], hv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const size_t gi = (size_t)(r0 + row) * dp + (g * ncg + c) * V + e;
        rbv[m][g * V + e] = in ? b[gi] : T(0);
        lv[e] = in ? lo[gi] : T(0);
        hv[e] = in ? hi[gi] : T(0);
      }
      const size_t at = ((size_t)(m * NG + g) * nt + tid) * V;
      store16(los + at, lv);
      store16(his + at, hv);
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int s = 0; s < n_steps; ++s) {
    T a0[TM][N], a1[TM][N], a2[TM][N];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int n = 0; n < N; ++n) a0[m][n] = a1[m][n] = a2[m][n] = T(0);
    // the next 16 bytes of the thread's rows are read before the current
    // ones are used
    T yv[TM][V];
#pragma unroll
    for (int m = 0; m < TM; ++m) load16(cur + (size_t)(rg + m * nrg) * ys, yv[m]);
#pragma unroll 2
    for (int k0 = 0; k0 < dp; k0 += V) {
      T yn[TM][V];
      const int kn = k0 + V < dp ? k0 + V : k0;
#pragma unroll
      for (int m = 0; m < TM; ++m) load16(cur + (size_t)(rg + m * nrg) * ys + kn, yn[m]);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const WT* wr = w + (size_t)(k0 + q) * dp + c * V;
        WT wv[NG][V];
#pragma unroll
        for (int g = 0; g < NG; ++g) loadw(wr + g * ncg * V, wv[g]);
#pragma unroll
        for (int m = 0; m < TM; ++m)
#pragma unroll
          for (int g = 0; g < NG; ++g)
#pragma unroll
            for (int e = 0; e < V; ++e)
              mac<TIER, T, T, WT>(a0[m][g * V + e], a1[m][g * V + e], a2[m][g * V + e],
                                  yv[m][q], wv[g][e]);
      }
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int e = 0; e < V; ++e) yv[m][e] = yn[m][e];
    }
    // + b, clipped with comparisons (not fmin/fmax) so a NaN propagates like
    // jnp.clip; into the next buffer, or on the last iteration into y_out
    const bool last = s + 1 == n_steps;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
      const int row = rg + m * nrg;
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const size_t at = ((size_t)(m * NG + g) * nt + tid) * V;
        T lv[V], hv[V], out[V];
        load16(los + at, lv);
        load16(his + at, hv);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const int n = g * V + e;
          const T acc = (NA == 3) ? (a0[m][n] + a1[m][n]) + a2[m][n] : a0[m][n];
          T v = acc + rbv[m][n];
          v = v < lv[e] ? lv[e] : v;
          v = v > hv[e] ? hv[e] : v;
          out[e] = v;
        }
        const int col = (g * ncg + c) * V;
        if (!last)
          store16(nxt + (size_t)row * ys + col, out);
        else if (row < nr)
          store16(y_out + (size_t)(r0 + row) * dp + col, out);
      }
    }
    if (last) break;
    // every row of nxt is written and every read of cur is done
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// The tile regime's shape where the rung and the smallest tile fit one
// block (false where they do not): rows per tile from B (one wave of the
// card's SMs where B allows, at least TM, at most what the launch bound and
// shared memory take), rounded to TM.
template <typename T, typename WT, int TIER>
bool tile_plan(int rows, int dp, size_t budget, int nsm, Plan* q) {
  using S = TileShape<T, TIER>;
  constexpr int TM = S::TM, N = S::NG * S::V;
  if (dp % N != 0) return false;
  const int ncg = dp / N;
  const size_t w_bytes = align16((size_t)dp * dp * sizeof(WT));
  // a row's two y buffers, its lo and its hi
  const size_t row_bytes = (2 * (size_t)(dp + S::V) + 2 * (size_t)dp) * sizeof(T);
  if (ncg > kTileThreads || w_bytes + TM * row_bytes > budget) return false;
  int cap = (int)((budget - w_bytes) / row_bytes);
  cap = min(cap, kTileThreads / ncg * TM) / TM * TM;
  int rb = ((rows + nsm - 1) / nsm + TM - 1) / TM * TM;
  rb = rb < TM ? TM : (rb > cap ? cap : rb);
  q->tile = 1;
  q->rb = rb;
  q->threads = rb / TM * ncg;
  q->nblocks = (rows + rb - 1) / rb;
  q->smem = (int)(w_bytes + rb * row_bytes);
  q->cluster = 1;
  q->w_smem = 1;
  return true;
}

// ---- the cluster regime -------------------------------------------------

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

// The launch shape: the tile regime where the rung and the smallest tile
// fit one block (the number of such blocks the card holds at once in
// max_clusters). Else the largest cluster the card schedules whose column
// slab width is a whole number of 16-byte groups; 8 rows per tile (fewer
// where they do not fit), more (up to kMaxRows, keeping the slab in shared
// memory) where that puts every tile in the card's first wave of clusters.
template <typename T, typename WT, int TIER>
cudaError_t make_plan(int rows, int dp, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int smem_optin = 0, nsm = 0;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  constexpr int V = Vec16<T>::n;
  constexpr int VW = Vec16<WT>::n;
  constexpr int NA = NAcc<TIER>::n;
  if (rows < 1 || dp < 1 || dp % V != 0) return cudaErrorInvalidValue;
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  Plan t = {};
  if (tile_plan<T, WT, TIER>(rows, dp, budget, nsm, &t)) {
    auto fn = k4_tile_kernel<T, WT, TIER>;
    if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, t.smem)))
      return e;
    int per_sm = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, t.threads, t.smem)))
      return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    t.max_clusters = per_sm * nsm;
    *plan = t;
    return cudaSuccess;
  }
  for (int C : kClusters) {
    if (dp % C != 0 || (dp / C) % V != 0) continue;
    Plan q;
    q.tile = 0;
    q.threads = kThreads;
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
  if (plan.tile) {
    auto fn = k4_tile_kernel<T, WT, TIER>;
    // another shape's plan may have set a smaller limit since
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
    if (e != cudaSuccess) return e;
    fn<<<plan.nblocks, plan.threads, plan.smem, stream>>>(
        static_cast<const WT*>(wt_bank), n_rho, static_cast<const T*>(b),
        static_cast<const T*>(lo), static_cast<const T*>(hi), static_cast<const T*>(y_in),
        static_cast<T*>(y_out), static_cast<const int*>(rho_ind), rows, dp, n_steps, plan);
    return cudaGetLastError();
  }
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
// whether the slab is held in shared memory, how many such clusters (tile
// regime: blocks) the card holds at once, threads per block, and the
// regime (1 tile, 0 cluster).
int k4_plan(int rows, int dp, int y_dtype, int w_dtype, int tier, int* nblocks, int* rb,
            int* smem, int* cluster, int* w_smem, int* max_clusters, int* threads, int* tile) {
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
  *threads = plan.threads;
  *tile = plan.tile;
  return 0;
}

const char* k4_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
