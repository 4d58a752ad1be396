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
//     fits, every block reads its slab from L2 each iteration.
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
// The kernel body and its planner live in csrc/chunk_cluster.cuh, which K1
// shares (every row against one rung; K5 passes its bank's per-problem
// stride and the (B,) rung vector's).
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success), the launch error
// checked right after the launch.

#include "chunk_cluster.cuh"

namespace {

using chunk::Plan;

template <typename T, typename WT, int TIER, int WM, int RR>
__global__ void __launch_bounds__(chunk::kThreads)
k5_kernel(const chunk::Args<T, WT> a, const Plan p) {
  chunk::chunk_body<T, WT, TIER, WM, RR, false>(a, p);
}

// The kernel for a plan: slab in shared memory, in registers (RR rows per
// lane) or read from L2.
struct K5Kernels {
  template <typename T, typename WT, int TIER>
  static auto get(const Plan& q) -> decltype(&k5_kernel<T, WT, TIER, chunk::WM_SMEM, 0>) {
    if (q.rr == chunk::kRegRows[0]) return k5_kernel<T, WT, TIER, chunk::WM_L2, chunk::kRegRows[0]>;
    if (q.rr == chunk::kRegRows[1]) return k5_kernel<T, WT, TIER, chunk::WM_L2, chunk::kRegRows[1]>;
    return q.wm == chunk::WM_SMEM ? k5_kernel<T, WT, TIER, chunk::WM_SMEM, 0>
                                  : k5_kernel<T, WT, TIER, chunk::WM_L2, 0>;
  }
};

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
  return (int)chunk::dispatch(y_dtype, w_dtype, tier, [&](auto t, auto w, int tr) {
    using T = decltype(t);
    using WT = decltype(w);
    const chunk::Args<T, WT> a{static_cast<const WT*>(bank), (size_t)n_rho * dp * dp, n_rho,
                               static_cast<const int*>(rho_inds), 1,
                               static_cast<const T*>(b), static_cast<const T*>(lo),
                               static_cast<const T*>(hi), static_cast<const T*>(y_in),
                               static_cast<T*>(y_out), dp, n_steps};
    return chunk::launch<K5Kernels, T, WT>(a, rows, tr, false, st);
  });
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
  const cudaError_t e = chunk::dispatch(y_dtype, w_dtype, tier, [&](auto t, auto w, int tr) {
    return chunk::plan_for<K5Kernels, decltype(t), decltype(w)>(dp, rows, tr, false, &plan);
  });
  if (e != cudaSuccess) return (int)e;
  *cluster = plan.cluster;
  *cw = plan.cw;
  *smem = plan.smem;
  *w_smem = plan.wm == chunk::WM_SMEM;
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
