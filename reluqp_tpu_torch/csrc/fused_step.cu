// K1 on Hopper: n_steps iterations of  y <- clip(y @ Wt[k] + b, lo, hi).
//
// Replaces the TPU chunk kernel reluqp_tpu/ops/fused_step.py `_kernel`
// (launched through `fused_chunk`), the hot loop of every single-QP solve
// and of the warm MPC rollout's loop path.
//
// What bounds it: one window reads one Wt rung (Dp*Dp elements: 1.64 MB at
// Dp=640 in fp32) and does 2*n_steps*R*Dp*Dp flops, so per byte of W it does
// 2*n_steps*R/4 flops (12.5 at n_steps=25, R=1) -- below the card's fp32
// ridge of ~20 flops/byte, so the bytes of W bound it when W is read once per
// window. The iterations are a chain of dependent GEMVs: every output lane of
// step s+1 needs every lane of step s, so at these sizes the real limit is
// the latency of one exchange of y per step -- which must not be a grid
// barrier and an L2 round trip (~2.3 us per step, 118x the bound at Dp=640).
//
// Design: K5's cluster kernel (csrc/chunk_cluster.cuh) with every row on
// one rung: the (N, Dp, Dp) bank seen as K5's with a bank stride of 0
// between rows and one rung index for all (a stride of 0 in the rung
// vector). Each row gets one thread-block cluster for the whole window:
//   * the plan takes the widest cluster (up to 16 blocks) that keeps the
//     rows in one wave (Dp=640, one row: 16 blocks of 40 columns); each
//     lane owns one 16-byte column group and one stretch of its rows;
//   * the slab is split: each lane holds the last 24 of its rows in
//     registers for the window and the block the rows before them in
//     shared memory (Dp <= 768: all in registers at Dp=256, 256 of 640
//     rows in shared memory at Dp=640); where those do not fit shared
//     memory either (Dp=4096) the rest is read from L2 every iteration;
//   * each block issues its whole shared-memory slab copy with cp.async
//     at once (K5 holds 4 copies in flight per thread);
//   * each block holds the row's whole y, double buffered, sends its piece
//     of the next y into every block of the cluster with st.async and waits
//     on its own mbarrier: no grid barrier and no cluster barrier inside a
//     window;
//   * a window of one iteration (the loop MPC's ci=1 windows) needs no
//     exchange: k1_kernel_step spreads each row's columns over Dp/4 (fp32)
//     independent blocks of 256 threads, each summing a stretch of rows of
//     one 16-byte column group straight from L2, the stretches added by a
//     shuffle butterfly and then, in warp order, through shared memory.
//     A cluster would first copy 100 KB of slab into each of 16 SMs.
// The sums: each lane adds one stretch of its column group in order, the
// stretches meet in a shuffle butterfly, in the state type (K5's order,
// not the plain version's, so the two differ by rounding).
//
// The rung index is read from a device int32 (the counterpart of scalar
// prefetch): the host never syncs to learn it. It is clamped into range,
// as a dynamic index is on the TPU.
//
// Tiers (tier argument) as csrc/tiers.cuh sets them out.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success), the launch error
// checked right after the launch.

#include "chunk_cluster.cuh"

namespace {

using chunk::Plan;

template <typename T, typename WT, int TIER, int WM, int RR>
__global__ void __launch_bounds__(chunk::kThreads)
k1_kernel(const chunk::Args<T, WT> a, const Plan p) {
  chunk::chunk_body<T, WT, TIER, WM, RR, true>(a, p);
}

// One iteration (see the header): block (row, g) computes the column group
// g of the row, thread t the rows t, t + kStepThreads, ... in order.
constexpr int kStepThreads = 256;

template <typename T, typename WT, int TIER>
__global__ void __launch_bounds__(kStepThreads) k1_kernel_step(const chunk::Args<T, WT> a) {
  constexpr int V = Vec16<T>::n;
  constexpr int NA = chunk::NAcc<TIER>::n;
  constexpr int NW = kStepThreads / 32;
  __shared__ T part[NA][NW][V];
  const int dp = a.dp, groups = dp / V;
  const int row = blockIdx.x / groups, g = blockIdx.x % groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int k = a.rho_inds[0];
  k = k < 0 ? 0 : (k >= a.n_rho ? a.n_rho - 1 : k);
  const WT* w = a.bank + (size_t)k * dp * dp + g * V;
  const T* y = a.y_in + (size_t)row * dp;
  T a0[V], a1[V], a2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) a0[j] = a1[j] = a2[j] = T(0);
#pragma unroll 4
  for (int i = threadIdx.x; i < dp; i += kStepThreads) {
    const T yv = y[i];
    WT wv[V];
    loadw(w + (size_t)i * dp, wv);
#pragma unroll
    for (int j = 0; j < V; ++j) mac<TIER, T, T, WT>(a0[j], a1[j], a2[j], yv, wv[j]);
  }
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a0[j] += __shfl_xor_sync(0xffffffffu, a0[j], off);
      if (NA == 3) {
        a1[j] += __shfl_xor_sync(0xffffffffu, a1[j], off);
        a2[j] += __shfl_xor_sync(0xffffffffu, a2[j], off);
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      part[0][warp][j] = a0[j];
      if (NA == 3) {
        part[NA > 1 ? 1 : 0][warp][j] = a1[j];
        part[NA > 1 ? 2 : 0][warp][j] = a2[j];
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < V) {
    const int j = threadIdx.x;
    T s0 = T(0), s1 = T(0), s2 = T(0);
    for (int q = 0; q < NW; ++q) {
      s0 += part[0][q][j];
      if (NA == 3) {
        s1 += part[NA > 1 ? 1 : 0][q][j];
        s2 += part[NA > 1 ? 2 : 0][q][j];
      }
    }
    const T acc = NA == 3 ? (s0 + s1) + s2 : s0;
    const size_t o = (size_t)row * dp + g * V + j;
    T v = acc + a.b[o];
    // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
    const T l = a.lo[o], h = a.hi[o];
    v = v < l ? l : v;
    v = v > h ? h : v;
    a.y_out[o] = v;
  }
}

template <typename T, typename WT>
cudaError_t launch_step(const chunk::Args<T, WT>& a, int rows, int tier, cudaStream_t stream) {
  const dim3 grid((unsigned)rows * (a.dp / Vec16<T>::n));
  if (tier == TIER_HIGHEST)
    k1_kernel_step<T, WT, TIER_HIGHEST><<<grid, kStepThreads, 0, stream>>>(a);
  else if (tier == TIER_HIGH)
    k1_kernel_step<T, WT, TIER_HIGH><<<grid, kStepThreads, 0, stream>>>(a);
  else
    k1_kernel_step<T, WT, TIER_BF16><<<grid, kStepThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// The kernel for a plan: slab in registers (RR rows per lane), in shared
// memory, split between shared memory and L2, or read from L2.
struct K1Kernels {
  template <typename T, typename WT, int TIER>
  static auto get(const Plan& q) -> decltype(&k1_kernel<T, WT, TIER, chunk::WM_SMEM, 0>) {
    if (q.rr == chunk::kRegRows[0]) return k1_kernel<T, WT, TIER, chunk::WM_L2, chunk::kRegRows[0]>;
    if (q.rr == chunk::kRegRows[1]) return k1_kernel<T, WT, TIER, chunk::WM_L2, chunk::kRegRows[1]>;
    if (q.wm == chunk::WM_SMEM) return k1_kernel<T, WT, TIER, chunk::WM_SMEM, 0>;
    if (q.wm == chunk::WM_SPLIT) return k1_kernel<T, WT, TIER, chunk::WM_SPLIT, 0>;
    return k1_kernel<T, WT, TIER, chunk::WM_L2, 0>;
  }
};

}  // namespace

extern "C" {

// Runs n_steps iterations of every row of the (rows, dp) state against rung
// *rho_ind of the (n_rho, dp, dp) bank; every pointer is a device pointer
// starting on a 16-byte boundary, y_out a distinct allocation. Returns
// cudaError_t.
int k1_fused_chunk(const void* wt_bank, int w_dtype, int n_rho, const void* b, const void* lo,
                   const void* hi, const void* y_in, void* y_out, const void* rho_ind, int rows,
                   int dp, int n_steps, int tier, int y_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier < TIER_HIGHEST || tier > TIER_BF16 || n_steps < 1 || n_rho < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  return (int)chunk::dispatch(y_dtype, w_dtype, tier, [&](auto t, auto w, int tr) {
    using T = decltype(t);
    using WT = decltype(w);
    const chunk::Args<T, WT> a{static_cast<const WT*>(wt_bank), 0, n_rho,
                               static_cast<const int*>(rho_ind), 0,
                               static_cast<const T*>(b), static_cast<const T*>(lo),
                               static_cast<const T*>(hi), static_cast<const T*>(y_in),
                               static_cast<T*>(y_out), dp, n_steps};
    if (n_steps == 1) return launch_step<T, WT>(a, rows, tr, st);
    return chunk::launch<K1Kernels, T, WT>(a, rows, tr, true, st);
  });
}

// The launch shape k1_fused_chunk would use for a window of n_steps, for
// reports: blocks per row (the cluster, or k1_kernel_step's independent
// blocks where `direct`), output columns per block, threads per block,
// dynamic shared memory per block, the slab's mode (0: read from L2, 1: in
// shared memory, 2: split), the slab rows held in shared memory, the rows
// per lane held in registers (a split slab's after those in shared memory;
// whatever remains is read from L2), the contraction's stretches and how
// many clusters the card holds at once.
int k1_plan(int rows, int dp, int n_steps, int y_dtype, int w_dtype, int tier, int* cluster,
            int* cw, int* threads, int* smem, int* w_mode, int* smem_rows, int* rr, int* ks,
            int* direct, int* max_clusters) {
  if (n_steps < 1 || rows < 1) return (int)cudaErrorInvalidValue;
  Plan plan{};
  cudaError_t e;
  if (n_steps == 1) {
    const int v = 16 / (y_dtype == DT_F64 ? 8 : 4);
    if (dp % v) return (int)cudaErrorInvalidValue;
    plan.cluster = dp / v;
    plan.cw = v;
    plan.threads = kStepThreads;
    plan.ks = kStepThreads;
    e = cudaSuccess;
  } else {
    e = chunk::dispatch(y_dtype, w_dtype, tier, [&](auto t, auto w, int tr) {
      return chunk::plan_for<K1Kernels, decltype(t), decltype(w)>(dp, rows, tr, true, &plan);
    });
  }
  if (e != cudaSuccess) return (int)e;
  *cluster = plan.cluster;
  *cw = plan.cw;
  *threads = plan.threads;
  *smem = plan.smem;
  *w_mode = plan.wm;
  *smem_rows = plan.wm == chunk::WM_SMEM ? dp : plan.rsm;
  // a split slab's register rows per lane, else the register slab's
  const int left = dp - plan.rsm;
  *rr = plan.wm == chunk::WM_SPLIT
            ? ((left + plan.ks - 1) / plan.ks < chunk::kSplitRegRows
                   ? (left + plan.ks - 1) / plan.ks
                   : chunk::kSplitRegRows)
            : plan.rr;
  *ks = plan.ks;
  *direct = n_steps == 1;
  *max_clusters = plan.max_clusters;
  return 0;
}

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
