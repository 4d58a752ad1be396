// K1 on Hopper: n_steps iterations of  y <- clip(y @ Wt[k] + b, lo, hi).
//
// Replaces the TPU chunk kernel reluqp_tpu/ops/fused_step.py `_kernel`
// (launched through `fused_chunk`), the hot loop of every single-QP solve
// and of the warm MPC rollout's loop path.
//
// What bounds it: one window reads one Wt rung (Dp*Dp elements: 1.64 MB at
// Dp=640 in fp32) and does 2*n_steps*R*Dp*Dp flops, so per byte of W it does
// 2*n_steps*R/4 flops (12.5 at n_steps=25, R=1) — below the card's fp32
// ridge of ~20 flops/byte, so the bytes of W bound it when W is read once per
// window. The iterations are a chain of dependent GEMVs: every output lane of
// step s+1 needs every lane of step s, so the real limit at these sizes is
// the latency of one grid-wide exchange per step.
//
// Design (simple and right first; wgmma/TMA/clusters are later work):
//   * ONE cooperative launch per check window, grid <= one block per SM.
//   * Block b owns the output lanes [b*ncols, (b+1)*ncols) and copies its
//     slab Wt[:, slab] into shared memory once, transposed to [col][row] so
//     a warp reads one column with unit stride. The slab stays there for all
//     n_steps iterations (Dp=640: 5 columns, 12.8 KB; Dp=1024: 8 columns,
//     32 KB). Where the slab does not fit shared memory (Dp >~ 2600 in fp32)
//     the block streams it from L2/HBM on every iteration instead.
//   * Each iteration every block copies the whole state y (R x Dp) into
//     shared memory, one warp reduces one (row, column) dot product with a
//     shuffle tree, and lane 0 applies bias and clamp.
//   * The state moves between blocks through a double-buffered global array
//     with grid.sync() between iterations. Input, output and the two
//     ping-pong buffers are four distinct allocations (no aliasing). Reads of
//     the exchanged state use __ldcg (L2, not the non-coherent L1), because
//     another SM wrote it during this launch.
//   * The rung index is read from a device int32 (the counterpart of scalar
//     prefetch): the host never syncs to learn it. It is clamped into range,
//     as a dynamic index is on the TPU.
//
// Tiers (tier argument):
//   0 highest: plain fp32 FMA (no TF32);
//   1 high:    bf16 hi/lo split of W and y with the lo*lo term dropped,
//              rounding by __float2bfloat16_rn, three fp32 sums;
//   2 bf16:    bf16-rounded y and W, fp32 accumulation ("default" and
//              "bf16"; a bf16-stored bank always takes this tier).
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success): the launch error
// is checked right after the launch, because a cooperative launch asking
// for more blocks than can be co-resident is otherwise refused silently.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tiers.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;

// Partial dot product of one state row with one W column over the lanes of
// a warp: lane handles i = lane, lane + 32, ...; W column element i sits at
// w[i * wstride].
template <typename T, typename WT>
__device__ __forceinline__ void lane_dot(const T* yr, const WT* w, size_t wstride,
                                         int dp, int lane, int tier,
                                         T& a0, T& a1, T& a2) {
  if (tier == TIER_HIGHEST) {
    for (int i = lane; i < dp; i += 32) a0 += yr[i] * cvt<T>(w[i * wstride]);
  } else if (tier == TIER_HIGH) {
    for (int i = lane; i < dp; i += 32) {
      const float yv = to_f(yr[i]);
      const float wv = to_f(w[i * wstride]);
      const float yh = bf16r(yv), yl = bf16r(yv - yh);
      const float wh = bf16r(wv), wl = bf16r(wv - wh);
      // products of two bf16 values are exact in fp32
      a0 += static_cast<T>(yh * wl);
      a1 += static_cast<T>(yl * wh);
      a2 += static_cast<T>(yh * wh);
    }
  } else {
    for (int i = lane; i < dp; i += 32)
      a0 += static_cast<T>(bf16r(to_f(yr[i])) * bf16r(to_f(w[i * wstride])));
  }
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads)
k1_kernel(const WT* __restrict__ wt_bank, int n_rho,
          const T* __restrict__ b, const T* __restrict__ lo,
          const T* __restrict__ hi, const T* y_in, T* y_out, T* scratch,
          const int* __restrict__ rho_ind, int rows, int dp, int n_steps,
          int tier, int ncols, int w_in_smem) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw);
  const size_t y_bytes = ((size_t)rows * dp * sizeof(T) + 15) & ~(size_t)15;
  WT* ws = reinterpret_cast<WT*>(smem_raw + y_bytes);

  int k = *rho_ind;
  k = k < 0 ? 0 : (k >= n_rho ? n_rho - 1 : k);
  const WT* wt = wt_bank + (size_t)k * dp * dp;

  const int j0 = blockIdx.x * ncols;
  const int nc_here = min(ncols, dp - j0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t state = (size_t)rows * dp;

  if (w_in_smem) {
    // slab Wt[:, j0:j0+nc_here] -> ws[c * dp + i]
    for (int t = threadIdx.x; t < nc_here * dp; t += kThreads) {
      const int i = t / nc_here;
      const int c = t - i * nc_here;
      ws[(size_t)c * dp + i] = wt[(size_t)i * dp + j0 + c];
    }
  }

  const int npairs = rows * nc_here;
  for (int s = 0; s < n_steps; ++s) {
    const T* src = (s == 0) ? y_in : scratch + (size_t)((s - 1) & 1) * state;
    T* dst = (s == n_steps - 1) ? y_out : scratch + (size_t)(s & 1) * state;
    for (size_t t = threadIdx.x; t < state; t += kThreads) ys[t] = __ldcg(src + t);
    __syncthreads();
    for (int p = warp; p < npairs; p += kWarps) {
      const int r = p / nc_here;
      const int c = p - r * nc_here;
      const int j = j0 + c;
      const T* yr = ys + (size_t)r * dp;
      T a0 = T(0), a1 = T(0), a2 = T(0);
      if (w_in_smem)
        lane_dot<T, WT>(yr, ws + (size_t)c * dp, 1, dp, lane, tier, a0, a1, a2);
      else
        lane_dot<T, WT>(yr, wt + j, (size_t)dp, dp, lane, tier, a0, a1, a2);
      a0 = warp_sum(a0);
      if (tier == TIER_HIGH) {
        a1 = warp_sum(a1);
        a2 = warp_sum(a2);
      }
      if (lane == 0) {
        const size_t o = (size_t)r * dp + j;
        const T acc = (tier == TIER_HIGH) ? (a0 + a1) + a2 : a0;
        T v = acc + b[o];
        // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
        const T l = lo[o], h = hi[o];
        v = v < l ? l : v;
        v = v > h ? h : v;
        dst[o] = v;
      }
    }
    if (s + 1 < n_steps) grid.sync();
  }
}

struct Plan {
  int nblocks, ncols, smem, w_in_smem;
};

template <typename T, typename WT>
cudaError_t make_plan(int rows, int dp, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int nsm = 0, smem_optin = 0, coop = 0;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return e;
  if (!coop) return cudaErrorNotSupported;
  if (rows < 1 || dp < 1) return cudaErrorInvalidValue;
  const size_t y_bytes = ((size_t)rows * dp * sizeof(T) + 15) & ~(size_t)15;
  const int ncols = (dp + nsm - 1) / nsm;
  const size_t w_bytes = (size_t)ncols * dp * sizeof(WT);
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  if (y_bytes > budget) return cudaErrorInvalidValue;  // state too large
  const int w_in = (y_bytes + w_bytes) <= budget;
  const size_t smem = y_bytes + (w_in ? w_bytes : 0);
  auto fn = k1_kernel<T, WT>;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)))
    return e;
  const int nblocks = (dp + ncols - 1) / ncols;
  if (nblocks > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;
  plan->nblocks = nblocks;
  plan->ncols = ncols;
  plan->smem = (int)smem;
  plan->w_in_smem = w_in;
  return cudaSuccess;
}

template <typename T, typename WT>
cudaError_t launch(const void* wt_bank, int n_rho, const void* b, const void* lo,
                   const void* hi, const void* y_in, void* y_out, void* scratch,
                   const void* rho_ind, int rows, int dp, int n_steps, int tier,
                   cudaStream_t stream) {
  Plan plan;
  cudaError_t e = make_plan<T, WT>(rows, dp, &plan);
  if (e != cudaSuccess) return e;
  const WT* a_w = static_cast<const WT*>(wt_bank);
  int a_n = n_rho;
  const T* a_b = static_cast<const T*>(b);
  const T* a_lo = static_cast<const T*>(lo);
  const T* a_hi = static_cast<const T*>(hi);
  const T* a_yin = static_cast<const T*>(y_in);
  T* a_yout = static_cast<T*>(y_out);
  T* a_scr = static_cast<T*>(scratch);
  const int* a_rho = static_cast<const int*>(rho_ind);
  int a_rows = rows, a_dp = dp, a_steps = n_steps, a_tier = tier;
  int a_ncols = plan.ncols, a_win = plan.w_in_smem;
  void* args[] = {&a_w,    &a_n,     &a_b,    &a_lo,   &a_hi,   &a_yin,
                  &a_yout, &a_scr,   &a_rho,  &a_rows, &a_dp,   &a_steps,
                  &a_tier, &a_ncols, &a_win};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k1_kernel<T, WT>),
                                  dim3(plan.nblocks), dim3(kThreads), args,
                                  (size_t)plan.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

}  // namespace

extern "C" {

// Runs n_steps iterations; all pointers are device pointers of distinct
// allocations: y_out (rows, dp), scratch (2, rows, dp). Returns cudaError_t.
int k1_fused_chunk(const void* wt_bank, int w_dtype, int n_rho, const void* b,
                   const void* lo, const void* hi, const void* y_in, void* y_out,
                   void* scratch, const void* rho_ind, int rows, int dp,
                   int n_steps, int tier, int y_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tier < TIER_HIGHEST || tier > TIER_BF16 || n_steps < 1)
    return (int)cudaErrorInvalidValue;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    return (int)launch<float, float>(wt_bank, n_rho, b, lo, hi, y_in, y_out, scratch,
                                     rho_ind, rows, dp, n_steps, tier, st);
  if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    return (int)launch<float, __nv_bfloat16>(wt_bank, n_rho, b, lo, hi, y_in, y_out,
                                             scratch, rho_ind, rows, dp, n_steps,
                                             TIER_BF16, st);
  if (y_dtype == DT_F64 && w_dtype == DT_F64)
    return (int)launch<double, double>(wt_bank, n_rho, b, lo, hi, y_in, y_out, scratch,
                                       rho_ind, rows, dp, n_steps, tier, st);
  return (int)cudaErrorInvalidValue;
}

// The launch shape k1_fused_chunk would use, for reports.
int k1_plan(int rows, int dp, int y_dtype, int w_dtype, int* nblocks, int* ncols,
            int* smem, int* w_in_smem) {
  Plan plan;
  cudaError_t e;
  if (y_dtype == DT_F32 && w_dtype == DT_F32)
    e = make_plan<float, float>(rows, dp, &plan);
  else if (y_dtype == DT_F32 && w_dtype == DT_BF16)
    e = make_plan<float, __nv_bfloat16>(rows, dp, &plan);
  else if (y_dtype == DT_F64 && w_dtype == DT_F64)
    e = make_plan<double, double>(rows, dp, &plan);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  *nblocks = plan.nblocks;
  *ncols = plan.ncols;
  *smem = plan.smem;
  *w_in_smem = plan.w_in_smem;
  return 0;
}

const char* k1_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
