// C1 and C2 on Hopper: the solve loops' check window in one launch.
//
// Replaces no Pallas kernel. The JAX package checks each window inside its
// compiled `lax.while_loop` body, which XLA fuses into a few device ops:
// reluqp_tpu/core/iteration.py `step` (`check` :455, `rho_ladder_step`
// :239, `infeasibility_certificates` :100) for one QP, and
// reluqp_tpu/core/batched.py `step` (`check` :369) for a batch. The port ran
// that check as some fifty small torch ops per window (ops/check_window.py
// keeps them as the plain versions `check_window_ref` and
// `batched_check_ref`). The Pallas whole-solve kernel K3 computes the same
// check in-kernel (csrc/solve_loop.cuh `check_window`, with the TPU's fp32
// rounding); these kernels keep the torch loops' arithmetic instead.
//
// C1, one QP: the residual products (y @ M_res when alpha = 1, else A x,
// H x and A'lam, and with the certificates A'dlam, H dx and A dx) spread
// over the grid: a tile of 8 output rows (one warp each, lanes along a
// contiguous row of the operand) or of 32 output columns (lanes along the
// columns, 8 warps each summing 32 rows of a 256-row chunk). Every block
// stages the vectors it multiplies (y, lam, dx, dlam) in shared memory.
// The products go to a scratch vector; the block that takes the last
// ticket (a fence and an atomic counter) reduces them and takes every
// decision: the maxima and scales, the rho estimate, the +-1 walk or the
// jump, the stride's check ordinal, the alpha re-encode of p, the solved
// test, the certificates, phase A's 3% stall test and the exit flags, and
// writes the loop's static state.
//
// C2, a batch: a block walks tiles of rows (grid-stride; the shared (nx, nx)
// and (nc, nx) H and A staged once per block in shared memory where they
// fit, else read from L2). A tile stages each row's x, z, lam (and dx,
// dlam), computes its rows' products (with H and A in shared memory a lane
// per row and a warp per output; else a warp per output of A x and H x,
// lanes along the operand's row, and a lane per output of A'lam, 32 columns
// a warp), and a warp per row then reduces them and takes the row's
// decisions (the
// freeze of done rows, the per-problem walk and re-encode, first-convergence
// iterations, status, certificates) and writes the row. The rows' shares of
// the shared walk's sum of log rho and active count, the open count and
// phase A's sum of log residuals are summed per block in row order; the
// last block sums the blocks' in a fixed order and decides the shared rung,
// the flags and phase A's test. Under the shared walk with alpha != 1 the
// re-encode of p needs the new rung: a second, elementwise launch does it.
// A row's results depend on the row and the decided rung only.
//
// Sums, each in a fixed order (so the check is deterministic): C1's
// products in fp64, rounded once to the state type; C2's in the state type
// (an fp32 -> fp64 conversion per factor would cost a batch four times its
// multiply-adds); every sum over rows in fp64. Elementwise steps are single
// IEEE operations in the state
// type (the `_rn` intrinsics: no contraction into an FMA), as the plain
// version's separate torch ops are, and every threshold decision is taken
// in the state type with the host's values rounded to it. The kernels and
// the plain versions therefore differ by the products' rounding only.
// No cooperative launch and no spin barrier: the kernels run inside the
// conditional bodies of the solves' device programs.
//
// What bounds them: the bytes. A check reads its operands once (M_res
// Dp x R, or H and A) and the state, and writes the state back: at most a
// few MB, microseconds at 3.35 TB/s. At these sizes the launch and the
// dependent chain (stage, products, ticket, decision) bound the time.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success), the launch error
// checked right after the launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <vector>

#include "tiers.cuh"

// The launch arguments (field for field ops/check_window.py's _C1Args and
// _C2Args); outside the unnamed namespace, as the C entries take them.
struct C1Args {
  const void *y_in, *m_res, *g_row, *H, *A, *g, *lo, *hi, *w_pri, *w_dua, *rhos, *rho_eff;
  void* y;
  int* rho_ind;
  void* rho;
  int *k, *status;
  void *pri, *dua;
  int *open, *tail;
  void *x_prev, *lam_prev;
  int* open_a;
  void *best_p, *best_d;
  int *n_stall, *k_fast;
  double* part;
  int* tick;
  int dp, nx, nc, nxp, ncp, n_rho, n_steps, tail_mode, phase_a, adaptive, jump, stride, ci,
      budget, cap_a, certs, alpha, dtype;
  double eps_pri, eps_dua, tol, rho_min, rho_max, eps_pinf, eps_dinf, stall;
};

struct C2Args {
  const void *Y_in, *H, *A, *G, *lo, *hi, *w_pri, *w_dua, *rhos, *rho_eff;
  void* Y;
  int* rho_ind;
  void *rho, *pri, *dua;
  uint8_t* done;
  int *iters, *status, *k;
  void *X_prev, *Lam_prev;
  int *n_open, *open, *tail, *open_a;
  void* best_m;
  int *best_open, *n_stall, *k_fast;
  double* part;
  int* tick;
  int B, dp, nx, nc, n_rho, h_per, a_per, g_per, wp_per, wd_per, reff_per, shared, n_steps,
      phase_a, adaptive, jump, stride, ci, budget, cap_a, certs, alpha, stop_open, dtype;
  double eps_pri, eps_dua, tol, rho_min, rho_max, eps_pinf, eps_dinf, stall;
};


namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColRows = 32;                  // rows a warp sums per column tile
constexpr int kChunk = kWarps * kColRows;     // rows of a column tile
constexpr int kMaxSeg = 6;
constexpr int kMaxRows = 32;                  // rows of a C2 tile
constexpr int kStatSolved = 1, kStatPinf = 2, kStatDinf = 3, kRunning = -1;

// single IEEE operations in the state type (never contracted)
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float log_t(float a) { return logf(a); }
__device__ __forceinline__ double log_t(double a) { return log(a); }
__device__ __forceinline__ float exp_t(float a) { return expf(a); }
__device__ __forceinline__ double exp_t(double a) { return exp(a); }
__device__ __forceinline__ float abs_t(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_t(double a) { return fabs(a); }
__device__ __forceinline__ bool finite_t(float a) { return isfinite(a); }
__device__ __forceinline__ bool finite_t(double a) { return isfinite(a); }

template <typename T> __device__ __forceinline__ bool is_nan(T v) { return v != v; }
// torch's NaN-propagating max (amax, maximum, clamp_min)
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (is_nan(a) || a > b) ? a : b;
}
// torch.clamp: NaN stays NaN
template <typename T> __device__ __forceinline__ T clamp_t(T v, T lo, T hi) {
  if (is_nan(v)) return v;
  v = v < lo ? lo : v;
  return hi < v ? hi : v;
}

template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
// every lane ends with the same bits: each stage adds the same two values
template <typename T> __device__ __forceinline__ T warp_sum_t(T v) {
  for (int o = 16; o > 0; o >>= 1) v = add_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ double warp_sum(double v) { return warp_sum_t(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// block-wide reductions; every thread gets the result, the warps' values
// combined in warp order. `sh` holds kWarps values.
template <typename T> __device__ T block_max(T v, T* sh) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = sh[0];
  for (int w = 1; w < kWarps; ++w) r = nmax(r, sh[w]);
  return r;
}
__device__ double block_sum(double v, double* sh) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  double r = sh[0];
  for (int w = 1; w < kWarps; ++w) r += sh[w];
  return r;
}
__device__ int block_and(int v, int* sh) {
  v = __all_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int r = 1;
  for (int w = 0; w < kWarps; ++w) r &= sh[w];
  return r;
}

__device__ __forceinline__ int clamp_ind(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// One rho-ladder update (ops/check_window.rho_ladder_step): the +-1 walk
// when `est` leaves [rho_k / tol, rho_k * tol], or the jump to the nearest
// rung in log distance (the first on a tie, as torch.argmin).
template <typename T>
__device__ int ladder(const T* rhos, int n_rho, int ind, T est, T tol, int jump) {
  const T rk = rhos[clamp_ind(ind, n_rho)];
  if (jump) {
    const bool moved = est > mul_rn(rk, tol) || est < div_rn(rk, tol);
    const T le = log_t(est);
    int best = 0;
    T bd = abs_t(sub_rn(log_t(rhos[0]), le));
    for (int i = 1; i < n_rho; ++i) {
      const T d = abs_t(sub_rn(log_t(rhos[i]), le));
      if (!is_nan(bd) && (is_nan(d) || d < bd)) bd = d, best = i;
    }
    return moved ? best : ind;
  }
  const bool up = est > mul_rn(rk, tol) && ind < n_rho - 1;
  const bool dn = est < div_rn(rk, tol) && ind > 0 && !up;
  return ind + (up ? 1 : 0) - (dn ? 1 : 0);
}

// the rho_update_stride gate: the ceil-div check ordinal of iteration k
__device__ __forceinline__ bool walk_now(int k, int ci, int stride) {
  return stride <= 1 || ((k + ci - 1) / ci) % stride == 0;
}

// The ticket: the block that increments it last (after its results are
// fenced) proceeds and resets it for the next launch.
__device__ bool last_block(int* tick) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int t = atomicAdd(tick, 1);
    s_last = t == (int)gridDim.x - 1;
    if (s_last) {
      __threadfence();
      *tick = 0;
    }
  }
  __syncthreads();
  return s_last != 0;
}

// ------------------------------------------------------------------------
// C1
// ------------------------------------------------------------------------

enum { V_Y = 0, V_LAM, V_DX, V_DLAM };

// One product: out[o] = sum_k M[o*so + k*sk] v[k]. Row mode (so = ld,
// sk = 1): a warp per output. Column mode (so = 1, sk = ld): a lane per
// output, the rows cut into chunks of kChunk.
struct Seg {
  const void* m;
  int row, n_out, n_k, ld, vec, chunks, off, tiles;
};

__host__ __device__ inline void seg_add(Seg* s, int& n, int& off, const void* m, int row,
                                        int n_out, int n_k, int ld, int vec) {
  Seg& g = s[n++];
  g.m = m, g.row = row, g.n_out = n_out, g.n_k = n_k, g.ld = ld, g.vec = vec;
  g.chunks = row ? 1 : (n_k + kChunk - 1) / kChunk;
  g.tiles = row ? (n_out + kWarps - 1) / kWarps : ((n_out + 31) / 32) * g.chunks;
  g.off = off;
  off += g.chunks * n_out;
}

// C1's products; returns their count and the scratch doubles they take.
__host__ __device__ inline int c1_segments(const C1Args& a, Seg* s, int* part_size) {
  int n = 0, off = 0;
  const int certs = a.certs && !a.tail_mode;
  if (a.m_res) {
    const int r = 2 * a.ncp + 2 * a.nxp;
    seg_add(s, n, off, a.m_res, 0, r, a.dp, r, V_Y);
  } else {
    seg_add(s, n, off, a.A, 1, a.nc, a.nx, a.nx, V_Y);    // A x
    seg_add(s, n, off, a.H, 1, a.nx, a.nx, a.nx, V_Y);    // H x
    seg_add(s, n, off, a.A, 0, a.nx, a.nc, a.nx, V_LAM);  // A' lam
  }
  if (certs) {
    seg_add(s, n, off, a.A, 0, a.nx, a.nc, a.nx, V_DLAM);  // A' dlam
    seg_add(s, n, off, a.H, 1, a.nx, a.nx, a.nx, V_DX);    // H dx
    seg_add(s, n, off, a.A, 1, a.nc, a.nx, a.nx, V_DX);    // A dx
  }
  *part_size = off;
  return n;
}

// output j of segment g, summed over its chunks in order, rounded once
template <typename T> __device__ __forceinline__ T seg_val(const double* part, const Seg& g, int j) {
  double acc = 0.0;
  for (int c = 0; c < g.chunks; ++c) acc += __ldcg(part + g.off + (size_t)c * g.n_out + j);
  return static_cast<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) c1_kernel(const C1Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double sh_col[kWarps][32];
  __shared__ double sh_d[kWarps];
  __shared__ T sh_t[kWarps];
  __shared__ int sh_i[kWarps];
  __shared__ int s_new_ind;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = a.dp, nx = a.nx, nc = a.nc;
  const bool certs = a.certs && !a.tail_mode;
  const bool need_lam = certs || (!a.m_res);
  const T* y_in = static_cast<const T*>(a.y_in);
  const T* reff = static_cast<const T*>(a.rho_eff);
  const int ind = clamp_ind(*a.rho_ind, a.n_rho);

  // the vectors every product reads: y, lam, dx, dlam
  T* ys = reinterpret_cast<T*>(smem_raw);
  T* lam = ys + dp;
  T* dx = lam + nc;
  T* dlam = dx + nx;
  for (int i = threadIdx.x; i < dp; i += kThreads) ys[i] = y_in[i];
  __syncthreads();
  if (need_lam) {
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      const T p = ys[nx + nc + i];
      lam[i] = a.alpha ? mul_rn(reff[(size_t)ind * nc + i], sub_rn(p, ys[nx + i])) : p;
    }
  }
  __syncthreads();
  if (certs) {
    const T* xp = static_cast<const T*>(a.x_prev);
    const T* lp = static_cast<const T*>(a.lam_prev);
    for (int i = threadIdx.x; i < nx; i += kThreads) dx[i] = sub_rn(ys[i], xp[i]);
    for (int i = threadIdx.x; i < nc; i += kThreads) dlam[i] = sub_rn(lam[i], lp[i]);
  }
  __syncthreads();

  Seg segs[kMaxSeg];
  int part_size;
  const int n_seg = c1_segments(a, segs, &part_size);
  int total = 0;
  for (int s = 0; s < n_seg; ++s) total += segs[s].tiles;
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    int s = 0, t = tile;
    while (t >= segs[s].tiles) t -= segs[s].tiles, ++s;
    const Seg& g = segs[s];
    const T* m = static_cast<const T*>(g.m);
    const T* v = g.vec == V_Y ? ys : g.vec == V_LAM ? lam : g.vec == V_DX ? dx : dlam;
    if (g.row) {
      const int o = t * kWarps + warp;
      if (o < g.n_out) {
        double acc = 0.0;
        const T* mr = m + (size_t)o * g.ld;
        for (int q = lane; q < g.n_k; q += 32)
          acc = fma(static_cast<double>(__ldg(mr + q)), static_cast<double>(v[q]), acc);
        acc = warp_sum(acc);
        if (lane == 0) a.part[g.off + o] = acc;
      }
    } else {
      const int c = t % g.chunks, j = (t / g.chunks) * 32 + lane;
      const int k0 = c * kChunk + warp * kColRows;
      double acc = 0.0;
      if (j < g.n_out) {
        const int k1 = min(k0 + kColRows, g.n_k);
        for (int q = k0; q < k1; ++q)
          acc = fma(static_cast<double>(__ldg(m + (size_t)q * g.ld + j)),
                    static_cast<double>(v[q]), acc);
      }
      sh_col[warp][lane] = acc;
      __syncthreads();
      if (warp == 0 && j < g.n_out) {
        double sum = 0.0;
        for (int w = 0; w < kWarps; ++w) sum += sh_col[w][lane];
        a.part[g.off + (size_t)c * g.n_out + j] = sum;
      }
      __syncthreads();
    }
  }

  if (!last_block(a.tick)) return;

  // ---- the last block: residuals, rho estimate, decisions, the state ----
  const T zero = T(0);
  T m_pri = zero, m_ax = zero, m_z = zero, m_dua = zero, m_hx = zero, m_atl = zero, m_g = zero;
  if (a.m_res) {
    const Seg& g = segs[0];
    const int ncp = a.ncp, nxp = a.nxp;
    const T* grow = static_cast<const T*>(a.g_row);
    for (int i = threadIdx.x; i < ncp; i += kThreads) {
      const T ax = seg_val<T>(a.part, g, i), z = seg_val<T>(a.part, g, ncp + i);
      m_pri = nmax(m_pri, abs_t(sub_rn(ax, z)));
      m_ax = nmax(m_ax, abs_t(ax));
      m_z = nmax(m_z, abs_t(z));
    }
    for (int i = threadIdx.x; i < nxp; i += kThreads) {
      const T hx = seg_val<T>(a.part, g, 2 * ncp + i);
      const T atl = seg_val<T>(a.part, g, 2 * ncp + nxp + i);
      const T gr = grow[i];
      m_dua = nmax(m_dua, abs_t(add_rn(add_rn(hx, atl), gr)));
      m_hx = nmax(m_hx, abs_t(hx));
      m_atl = nmax(m_atl, abs_t(atl));
      m_g = nmax(m_g, abs_t(gr));
    }
  } else {
    const T* wp = static_cast<const T*>(a.w_pri);
    const T* wd = static_cast<const T*>(a.w_dua);
    const T* gv = static_cast<const T*>(a.g);
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      T ax = seg_val<T>(a.part, segs[0], i), z = ys[nx + i];
      if (wp) ax = mul_rn(wp[i], ax), z = mul_rn(wp[i], z);
      m_pri = nmax(m_pri, abs_t(sub_rn(ax, z)));
      m_ax = nmax(m_ax, abs_t(ax));
      m_z = nmax(m_z, abs_t(z));
    }
    for (int i = threadIdx.x; i < nx; i += kThreads) {
      T hx = seg_val<T>(a.part, segs[1], i), atl = seg_val<T>(a.part, segs[2], i), gi = gv[i];
      if (wd) hx = mul_rn(wd[i], hx), atl = mul_rn(wd[i], atl), gi = mul_rn(wd[i], gi);
      m_dua = nmax(m_dua, abs_t(add_rn(add_rn(hx, atl), gi)));
      m_hx = nmax(m_hx, abs_t(hx));
      m_atl = nmax(m_atl, abs_t(atl));
      m_g = nmax(m_g, abs_t(gi));
    }
  }
  const T pri = block_max(m_pri, sh_t), dua = block_max(m_dua, sh_t);
  const T scale_p = nmax(block_max(m_ax, sh_t), block_max(m_z, sh_t));
  const T scale_d =
      nmax(nmax(block_max(m_hx, sh_t), block_max(m_atl, sh_t)), block_max(m_g, sh_t));

  // the certificates on the deltas since the last check
  bool pinf = false, dinf = false;
  if (certs) {
    const int s0 = a.m_res ? 1 : 3;  // A'dlam, H dx, A dx
    const T* lo = static_cast<const T*>(a.lo) + nx;
    const T* hi = static_cast<const T*>(a.hi) + nx;
    const T* gv = static_cast<const T*>(a.g);
    T m_dl = zero, m_dx = zero, m_at = zero, m_hd = zero;
    double sup = 0.0, gdx = 0.0;
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      const T dl = dlam[i];
      m_dl = nmax(m_dl, abs_t(dl));
      const T term = dl > zero ? mul_rn(hi[i], dl) : (dl < zero ? mul_rn(lo[i], dl) : zero);
      sup += static_cast<double>(term);
    }
    for (int i = threadIdx.x; i < nx; i += kThreads) {
      m_dx = nmax(m_dx, abs_t(dx[i]));
      m_at = nmax(m_at, abs_t(seg_val<T>(a.part, segs[s0], i)));
      m_hd = nmax(m_hd, abs_t(seg_val<T>(a.part, segs[s0 + 1], i)));
      gdx = fma(static_cast<double>(gv[i]), static_cast<double>(dx[i]), gdx);
    }
    const T ndl = block_max(m_dl, sh_t), ndx = block_max(m_dx, sh_t);
    const T at_max = block_max(m_at, sh_t), hd_max = block_max(m_hd, sh_t);
    const T support = static_cast<T>(block_sum(sup, sh_d));
    const T g_dx = static_cast<T>(block_sum(gdx, sh_d));
    const T eps_p = mul_rn(static_cast<T>(a.eps_pinf), ndl);
    const T eps_d = mul_rn(static_cast<T>(a.eps_dinf), ndx);
    int ok = 1;
    for (int i = threadIdx.x; i < nc; i += kThreads) {
      const T adx = seg_val<T>(a.part, segs[s0 + 2], i);
      if (finite_t(hi[i]) && !(adx <= eps_d)) ok = 0;
      if (finite_t(lo[i]) && !(adx >= -eps_d)) ok = 0;
    }
    const int ray_ok = block_and(ok, sh_i);
    pinf = ndl > zero && at_max <= eps_p && support <= -eps_p;
    dinf = ndx > zero && hd_max <= eps_d && g_dx <= -eps_d && ray_ok;
  }

  if (threadIdx.x == 0) {
    const T tiny = static_cast<T>(1e-30);
    const T num = div_rn(pri, nmax(scale_p, tiny));
    const T den = div_rn(dua, nmax(scale_d, tiny));
    const T ratio = sqrt_rn(div_rn(num, nmax(den, tiny)));
    const T rho_new = clamp_t(mul_rn(*static_cast<T*>(a.rho), ratio),
                              static_cast<T>(a.rho_min), static_cast<T>(a.rho_max));
    const bool solved = pri < static_cast<T>(a.eps_pri) && dua < static_cast<T>(a.eps_dua);
    const int k_new = *a.k + a.n_steps;
    *static_cast<T*>(a.rho) = rho_new;
    *static_cast<T*>(a.pri) = pri;
    *static_cast<T*>(a.dua) = dua;
    *a.k = k_new;
    int new_ind = ind;
    if (a.tail_mode) {
      if (solved) *a.status = kStatSolved;
    } else {
      if (a.adaptive) {
        new_ind = ladder(static_cast<const T*>(a.rhos), a.n_rho, ind, rho_new,
                         static_cast<T>(a.tol), a.jump);
        if (!walk_now(k_new, a.ci, a.stride)) new_ind = ind;
        *a.rho_ind = new_ind;
      }
      int status = solved ? kStatSolved : kRunning;
      if (status < 0 && pinf) status = kStatPinf;
      if (status < 0 && dinf) status = kStatDinf;
      const bool running = status < 0 && k_new < a.budget;
      *a.status = status;
      *a.open = running;
      *a.tail = status < 0;
      if (a.phase_a) {
        T* bp = static_cast<T*>(a.best_p);
        T* bd = static_cast<T*>(a.best_d);
        const T st = static_cast<T>(a.stall);
        const bool improved = pri < mul_rn(st, *bp) || dua < mul_rn(st, *bd);
        const int n_stall = improved ? 0 : *a.n_stall + 1;
        if (pri < *bp) *bp = pri;
        if (dua < *bd) *bd = dua;
        *a.n_stall = n_stall;
        *a.k_fast = k_new;
        *a.open_a = n_stall < 2 && k_new < a.cap_a && running;
      }
    }
    s_new_ind = new_ind;
  }
  __syncthreads();
  // the new state: y (p re-encoded for the new rung under alpha != 1) and
  // the certificates' previous iterate
  const int new_ind = s_new_ind;
  const bool reencode = !a.tail_mode && a.adaptive && a.alpha;
  T* y = static_cast<T*>(a.y);
  for (int i = threadIdx.x; i < dp; i += kThreads) {
    T v = ys[i];
    if (reencode && i >= nx + nc && i < nx + 2 * nc) {
      const int j = i - nx - nc;
      const T z = ys[nx + j];
      const T s = div_rn(reff[(size_t)ind * nc + j], reff[(size_t)new_ind * nc + j]);
      v = add_rn(z, mul_rn(s, sub_rn(v, z)));
    }
    y[i] = v;
  }
  if (certs) {
    T* xp = static_cast<T*>(a.x_prev);
    T* lp = static_cast<T*>(a.lam_prev);
    for (int i = threadIdx.x; i < nx; i += kThreads) xp[i] = ys[i];
    for (int i = threadIdx.x; i < nc; i += kThreads) lp[i] = lam[i];
  }
}

struct C1Plan {
  int grid, smem, part;
};

C1Plan c1_plan(const C1Args& a, int nsm) {
  Seg segs[kMaxSeg];
  C1Plan p;
  const int n = c1_segments(a, segs, &p.part);
  int total = 0;
  for (int s = 0; s < n; ++s) total += segs[s].tiles;
  p.grid = total < 1 ? 1 : (total < 2 * nsm ? total : 2 * nsm);
  const int elt = a.dtype == DT_F64 ? 8 : 4;
  p.smem = (a.dp + 2 * a.nc + a.nx) * elt;
  return p;
}

template <typename T>
cudaError_t c1_launch(const C1Args& a, cudaStream_t stream) {
  int dev, nsm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  const C1Plan p = c1_plan(a, nsm);
  if (p.smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(c1_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                p.smem)))
    return e;
  c1_kernel<T><<<p.grid, kThreads, p.smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// C2
// ------------------------------------------------------------------------

struct C2Plan {
  int rows, grid, smem, ha_smem, vec_ld, out_ld;
};

// The shared H and A in shared memory where they fit 64 KB; rows per tile
// (a lane per row there, else about 1024 warp tasks a tile; at most
// kMaxRows, and no more than spread the batch over eight blocks per SM),
// and a grid of at most eight blocks per SM walking the tiles.
C2Plan c2_plan(const C2Args& a, int nsm) {
  C2Plan p;
  const int elt = a.dtype == DT_F64 ? 8 : 4;
  const int nx = a.nx, nc = a.nc;
  p.out_ld = (nc + 2 * nx) * (a.certs ? 2 : 1);
  p.vec_ld = nx + 2 * nc + (a.certs ? nx + nc : 0);
  const long ha = (long)(nx + nc) * nx * elt;
  p.ha_smem = !a.h_per && !a.a_per && ha <= 64 * 1024;
  // with H and A in shared memory a lane per row: up to 32 rows a tile,
  // at an odd stride (a lane's reads fall in distinct banks)
  if (p.ha_smem) p.vec_ld |= 1;
  const int tasks = (nc + nx + (nx + 31) / 32) * (a.certs ? 2 : 1);
  int rows = p.ha_smem ? kMaxRows : 1024 / tasks;
  const int spread = (a.B + 8 * nsm - 1) / (8 * nsm);
  rows = rows < spread ? rows : spread;
  rows = rows < 1 ? 1 : (rows > kMaxRows ? kMaxRows : rows);
  const long fixed = p.ha_smem ? ha : 0;
  while (rows > 1 && fixed + (long)rows * (p.vec_ld + p.out_ld) * elt > 160 * 1024) rows /= 2;
  p.rows = rows;
  p.smem = (int)(fixed + (long)rows * (p.vec_ld + p.out_ld) * elt);
  const int tiles = (a.B + rows - 1) / rows;
  p.grid = tiles < 1 ? 1 : (tiles < 8 * nsm ? tiles : 8 * nsm);
  return p;
}

template <typename T>
__device__ __forceinline__ const T* reff_row(const C2Args& a, int b, int ind) {
  const T* r = static_cast<const T*>(a.rho_eff);
  const size_t base = a.reff_per ? (size_t)b * a.n_rho : 0;
  return r + (base + clamp_ind(ind, a.n_rho)) * a.nc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) c2_kernel(const C2Args a, const C2Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double c_logr[kMaxRows], c_logres[kMaxRows];
  __shared__ int c_act[kMaxRows], c_open[kMaxRows];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = a.B, dp = a.dp, nx = a.nx, nc = a.nc;
  const int n_out = p.out_ld, vl = p.vec_ld;
  const bool certs = a.certs;
  T* sHA = reinterpret_cast<T*>(smem_raw);
  T* vec = sHA + (p.ha_smem ? (size_t)(nx + nc) * nx : 0);
  T* outs = vec + (size_t)p.rows * vl;
  const T* Hg = static_cast<const T*>(a.H);
  const T* Ag = static_cast<const T*>(a.A);
  if (p.ha_smem) {
    for (int i = threadIdx.x; i < nx * nx; i += kThreads) sHA[i] = Hg[i];
    for (int i = threadIdx.x; i < nc * nx; i += kThreads) sHA[(size_t)nx * nx + i] = Ag[i];
  }
  // H and A of row b: shared memory, or the shared or per-problem operand
  auto h_of = [&](int b) -> const T* {
    return p.ha_smem ? sHA : Hg + (a.h_per ? (size_t)b * nx * nx : 0);
  };
  auto a_of = [&](int b) -> const T* {
    return p.ha_smem ? sHA + (size_t)nx * nx : Ag + (a.a_per ? (size_t)b * nc * nx : 0);
  };
  const int n_rowt = (nc + nx) * (certs ? 2 : 1);
  const int n_colg = (nx + 31) / 32, n_colt = n_colg * (certs ? 2 : 1);
  const T* Y_in = static_cast<const T*>(a.Y_in);
  const T* rhos = static_cast<const T*>(a.rhos);
  const int k_new = *a.k + a.n_steps;
  const int ind_shared = a.shared ? clamp_ind(*a.rho_ind, a.n_rho) : 0;
  const bool walk_rows = a.adaptive && !a.shared && walk_now(k_new, a.ci, a.stride);
  double blk_logr = 0.0, blk_logres = 0.0;
  int blk_act = 0, blk_open = 0;
  const T zero = T(0);

  for (int tile = blockIdx.x; tile * p.rows < B; tile += gridDim.x) {
    const int r0 = tile * p.rows;
    const int nr = min(p.rows, B - r0);
    __syncthreads();  // the previous tile's rows are written out
    // stage each row's x, z, lam (and dx, dlam)
    for (int r = warp; r < nr; r += kWarps) {
      const int b = r0 + r;
      const T* yr = Y_in + (size_t)b * dp;
      T* v = vec + (size_t)r * vl;
      const int ind = a.shared ? ind_shared : clamp_ind(a.rho_ind[b], a.n_rho);
      const T* rv = a.alpha ? reff_row<T>(a, b, ind) : nullptr;
      for (int i = lane; i < nx; i += 32) v[i] = yr[i];
      for (int i = lane; i < nc; i += 32) {
        const T z = yr[nx + i], pl = yr[nx + nc + i];
        v[nx + i] = z;
        v[nx + nc + i] = rv ? mul_rn(rv[i], sub_rn(pl, z)) : pl;
      }
      if (certs) {
        const T* xp = static_cast<const T*>(a.X_prev) + (size_t)b * nx;
        const T* lp = static_cast<const T*>(a.Lam_prev) + (size_t)b * nc;
        __syncwarp();
        for (int i = lane; i < nx; i += 32) v[nx + 2 * nc + i] = sub_rn(v[i], xp[i]);
        for (int i = lane; i < nc; i += 32)
          v[2 * nx + 2 * nc + i] = sub_rn(v[nx + nc + i], lp[i]);
      }
    }
    __syncthreads();
    // the products, summed in the state type in a fixed order. With H and
    // A in shared memory: a lane per row of the tile, a warp per output
    // (the operand's element read once for all 32 rows). Else a warp per
    // output of a row-contiguous product (A x, H x, A dx, H dx: the lanes
    // along the operand's row, their partial sums met by a butterfly), a
    // lane per output of a transposed one (A'lam, A'dlam: a warp's 32
    // columns summed down the rows in order)
    if (p.ha_smem) {
      const int r = lane;
      const T* v = vec + (size_t)r * vl;
      for (int o = warp; r < nr && o < n_out; o += kWarps) {
        // segments: A x | H x | A'lam | A dx | H dx | A'dlam
        int oo = o;
        const bool delta = oo >= nc + 2 * nx;
        if (delta) oo -= nc + 2 * nx;
        const T* xv = v + (delta ? nx + 2 * nc : 0);
        // four partial sums (the contraction index mod 4), then
        // (s0 + s1) + (s2 + s3): four independent chains
        const T* m;
        const T* u;
        int n, step;
        if (oo < nc + nx) {
          m = oo < nc ? sHA + (size_t)nx * nx + (size_t)oo * nx : sHA + (size_t)(oo - nc) * nx;
          u = xv, n = nx, step = 1;
        } else {
          m = sHA + (size_t)nx * nx + (oo - nc - nx);
          u = v + (delta ? 2 * nx + 2 * nc : nx + nc), n = nc, step = nx;
        }
        T s0 = zero, s1 = zero, s2 = zero, s3 = zero;
        int c = 0;
        for (; c + 3 < n; c += 4) {
          s0 = fma_t(m[(size_t)c * step], u[c], s0);
          s1 = fma_t(m[(size_t)(c + 1) * step], u[c + 1], s1);
          s2 = fma_t(m[(size_t)(c + 2) * step], u[c + 2], s2);
          s3 = fma_t(m[(size_t)(c + 3) * step], u[c + 3], s3);
        }
        if (c < n) s0 = fma_t(m[(size_t)c * step], u[c], s0);
        if (c + 1 < n) s1 = fma_t(m[(size_t)(c + 1) * step], u[c + 1], s1);
        if (c + 2 < n) s2 = fma_t(m[(size_t)(c + 2) * step], u[c + 2], s2);
        outs[(size_t)r * n_out + o] = add_rn(add_rn(s0, s1), add_rn(s2, s3));
      }
    }
    // (four outputs a warp at once, for the loads in flight)
    for (int q0 = warp; !p.ha_smem && q0 < nr * n_rowt; q0 += 4 * kWarps) {
      const T* m[4];
      const T* v[4];
      int dst[4];
      T acc[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int q = q0 + t * kWarps;
        dst[t] = -1, acc[t] = zero, m[t] = v[t] = nullptr;
        if (q >= nr * n_rowt) continue;
        const int r = q / n_rowt, b = r0 + r;
        int o = q % n_rowt;
        const bool delta = o >= nc + nx;
        if (delta) o -= nc + nx;
        v[t] = vec + (size_t)r * vl + (delta ? nx + 2 * nc : 0);
        m[t] = o < nc ? a_of(b) + (size_t)o * nx : h_of(b) + (size_t)(o - nc) * nx;
        dst[t] = r * n_out + (delta ? nc + 2 * nx : 0) + o;
      }
      for (int c = lane; c < nx; c += 32) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (dst[t] >= 0) acc[t] = fma_t(m[t][c], v[t][c], acc[t]);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (dst[t] < 0) continue;
        const T sum = warp_sum_t(acc[t]);
        if (lane == 0) outs[dst[t]] = sum;
      }
    }
    for (int q = warp; !p.ha_smem && q < nr * n_colt; q += kWarps) {
      const int r = q / n_colt, b = r0 + r;
      int grp = q % n_colt;
      const bool delta = grp >= n_colg;
      if (delta) grp -= n_colg;
      const int j = grp * 32 + lane;
      if (j < nx) {
        const T* lv = vec + (size_t)r * vl + (delta ? 2 * nx + 2 * nc : nx + nc);
        const T* am = a_of(b) + j;
        T s0 = zero, s1 = zero, s2 = zero, s3 = zero;
        int i = 0;
        for (; i + 3 < nc; i += 4) {
          s0 = fma_t(am[(size_t)i * nx], lv[i], s0);
          s1 = fma_t(am[(size_t)(i + 1) * nx], lv[i + 1], s1);
          s2 = fma_t(am[(size_t)(i + 2) * nx], lv[i + 2], s2);
          s3 = fma_t(am[(size_t)(i + 3) * nx], lv[i + 3], s3);
        }
        if (i < nc) s0 = fma_t(am[(size_t)i * nx], lv[i], s0);
        if (i + 1 < nc) s1 = fma_t(am[(size_t)(i + 1) * nx], lv[i + 1], s1);
        if (i + 2 < nc) s2 = fma_t(am[(size_t)(i + 2) * nx], lv[i + 2], s2);
        outs[(size_t)r * n_out + (delta ? 2 * nc + 3 * nx : nc + nx) + j] =
            add_rn(add_rn(s0, s1), add_rn(s2, s3));
      }
    }
    __syncthreads();
    // a warp per row: the row's residuals, estimate and decisions
    for (int r = warp; r < nr; r += kWarps) {
      const int b = r0 + r;
      const T* v = vec + (size_t)r * vl;
      const T* out = outs + (size_t)r * n_out;
      const T* wp = a.w_pri ? static_cast<const T*>(a.w_pri) + (a.wp_per ? (size_t)b * nc : 0)
                            : nullptr;
      const T* wd = a.w_dua ? static_cast<const T*>(a.w_dua) + (a.wd_per ? (size_t)b * nx : 0)
                            : nullptr;
      const T* gr = static_cast<const T*>(a.G) + (a.g_per ? (size_t)b * nx : 0);
      T m_pri = zero, m_ax = zero, m_z = zero, m_dua = zero, m_hx = zero, m_atl = zero,
        m_g = zero;
      for (int i = lane; i < nc; i += 32) {
        T ax = out[i], z = v[nx + i];
        if (wp) ax = mul_rn(wp[i], ax), z = mul_rn(wp[i], z);
        m_pri = nmax(m_pri, abs_t(sub_rn(ax, z)));
        m_ax = nmax(m_ax, abs_t(ax));
        m_z = nmax(m_z, abs_t(z));
      }
      for (int i = lane; i < nx; i += 32) {
        T hx = out[nc + i], atl = out[nc + nx + i], gi = gr[i];
        if (wd) hx = mul_rn(wd[i], hx), atl = mul_rn(wd[i], atl), gi = mul_rn(wd[i], gi);
        m_dua = nmax(m_dua, abs_t(add_rn(add_rn(hx, atl), gi)));
        m_hx = nmax(m_hx, abs_t(hx));
        m_atl = nmax(m_atl, abs_t(atl));
        m_g = nmax(m_g, abs_t(gi));
      }
      const T pri_n = warp_max(m_pri), dua_n = warp_max(m_dua);
      const T scale_p = nmax(warp_max(m_ax), warp_max(m_z));
      const T scale_d = nmax(nmax(warp_max(m_hx), warp_max(m_atl)), warp_max(m_g));
      bool pinf = false, dinf = false;
      if (certs) {
        const T* dxv = v + nx + 2 * nc;
        const T* dlv = v + 2 * nx + 2 * nc;
        const T* lo = static_cast<const T*>(a.lo) + (size_t)b * dp + nx;
        const T* hi = static_cast<const T*>(a.hi) + (size_t)b * dp + nx;
        const int o3 = nc + 2 * nx;
        T m_dl = zero, m_dx = zero, m_at = zero, m_hd = zero;
        double sup = 0.0, gdx = 0.0;
        for (int i = lane; i < nc; i += 32) {
          const T dl = dlv[i];
          m_dl = nmax(m_dl, abs_t(dl));
          const T term = dl > zero ? mul_rn(hi[i], dl) : (dl < zero ? mul_rn(lo[i], dl) : zero);
          sup += static_cast<double>(term);
        }
        for (int i = lane; i < nx; i += 32) {
          m_dx = nmax(m_dx, abs_t(dxv[i]));
          m_hd = nmax(m_hd, abs_t(out[o3 + nc + i]));
          m_at = nmax(m_at, abs_t(out[o3 + nc + nx + i]));
          gdx += static_cast<double>(mul_rn(gr[i], dxv[i]));
        }
        const T ndl = warp_max(m_dl), ndx = warp_max(m_dx);
        const T at_max = warp_max(m_at), hd_max = warp_max(m_hd);
        const T support = static_cast<T>(warp_sum(sup));
        const T g_dx = static_cast<T>(warp_sum(gdx));
        const T eps_p = mul_rn(static_cast<T>(a.eps_pinf), ndl);
        const T eps_d = mul_rn(static_cast<T>(a.eps_dinf), ndx);
        int ok = 1;
        for (int i = lane; i < nc; i += 32) {
          const T adx = out[o3 + i];
          if (finite_t(hi[i]) && !(adx <= eps_d)) ok = 0;
          if (finite_t(lo[i]) && !(adx >= -eps_d)) ok = 0;
        }
        const bool ray_ok = __all_sync(0xffffffffu, ok);
        pinf = ndl > zero && at_max <= eps_p && support <= -eps_p;
        dinf = ndx > zero && hd_max <= eps_d && g_dx <= -eps_d && ray_ok;
      }
      // the row's decisions (every lane alike)
      T* rho_b = static_cast<T*>(a.rho) + b;
      T* pri_b = static_cast<T*>(a.pri) + b;
      T* dua_b = static_cast<T*>(a.dua) + b;
      const bool done_old = a.done[b] != 0;
      const T rho_old = *rho_b, pri_old = *pri_b, dua_old = *dua_b;
      const int iters_old = a.iters[b], status_old = a.status[b];
      const int ind = a.shared ? ind_shared : clamp_ind(a.rho_ind[b], a.n_rho);
      __syncwarp();
      const T tiny = static_cast<T>(1e-30);
      const T num = div_rn(pri_n, nmax(scale_p, tiny));
      const T den = div_rn(dua_n, nmax(scale_d, tiny));
      const T ratio = sqrt_rn(div_rn(num, nmax(den, tiny)));
      const T rho_new = clamp_t(mul_rn(rho_old, ratio), static_cast<T>(a.rho_min),
                                static_cast<T>(a.rho_max));
      const T pri = done_old ? pri_old : pri_n;
      const T dua = done_old ? dua_old : dua_n;
      int new_ind = ind;
      if (walk_rows && !done_old)
        new_ind = ladder(rhos, a.n_rho, ind, rho_new, static_cast<T>(a.tol), a.jump);
      const bool newly =
          !done_old && pri < static_cast<T>(a.eps_pri) && dua < static_cast<T>(a.eps_dua);
      int iters = newly ? k_new : iters_old;
      int status = newly ? kStatSolved : status_old;
      bool done = done_old || newly;
      if (certs) {
        if (!done && pinf) status = kStatPinf, iters = k_new, done = true;
        if (!done && dinf) status = kStatDinf, iters = k_new, done = true;
      }
      if (lane == 0) {
        *rho_b = done_old ? rho_old : rho_new;
        *pri_b = pri;
        *dua_b = dua;
        a.done[b] = done;
        a.iters[b] = iters;
        a.status[b] = status;
        if (a.adaptive && !a.shared) a.rho_ind[b] = new_ind;
        c_act[r] = !done_old;
        c_open[r] = !done;
        c_logr[r] = (a.adaptive && a.shared && !done_old) ? static_cast<double>(log_t(rho_new))
                                                          : 0.0;
        c_logres[r] = (a.phase_a && !done)
                          ? static_cast<double>(log_t(nmax(add_rn(pri, dua), tiny)))
                          : 0.0;
      }
      // the row of the new state
      const bool reencode = a.adaptive && a.alpha && !a.shared;
      const T* rv_old = reencode ? reff_row<T>(a, b, ind) : nullptr;
      const T* rv_new = reencode ? reff_row<T>(a, b, new_ind) : nullptr;
      const T* yr = Y_in + (size_t)b * dp;
      T* yo = static_cast<T*>(a.Y) + (size_t)b * dp;
      for (int i = lane; i < dp; i += 32) {
        T val = yr[i];
        if (reencode && i >= nx + nc && i < nx + 2 * nc) {
          const int j = i - nx - nc;
          const T z = yr[nx + j];
          val = add_rn(z, mul_rn(div_rn(rv_old[j], rv_new[j]), sub_rn(val, z)));
        }
        yo[i] = val;
      }
      if (certs) {
        T* xp = static_cast<T*>(a.X_prev) + (size_t)b * nx;
        T* lp = static_cast<T*>(a.Lam_prev) + (size_t)b * nc;
        for (int i = lane; i < nx; i += 32) xp[i] = v[i];
        for (int i = lane; i < nc; i += 32) lp[i] = v[nx + nc + i];
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int r = 0; r < nr; ++r) {
        blk_logr += c_logr[r];
        blk_logres += c_logres[r];
        blk_act += c_act[r];
        blk_open += c_open[r];
      }
    }
  }
  if (threadIdx.x == 0) {
    double* pb = a.part + 4 * (size_t)blockIdx.x;
    pb[0] = blk_logr, pb[1] = blk_logres, pb[2] = blk_act, pb[3] = blk_open;
  }

  if (!last_block(a.tick)) return;
  // ---- the last block: the batch's sums in a fixed order (each thread
  // the blocks t, t + kThreads, ... in order, then the threads in order)
  // and its flags ----
  __shared__ double s_red[4][kThreads];
  {
    double q0 = 0.0, q1 = 0.0, q2 = 0.0, q3 = 0.0;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += kThreads) {
      const double* pb = a.part + 4 * (size_t)i;
      q0 += __ldcg(pb), q1 += __ldcg(pb + 1), q2 += __ldcg(pb + 2), q3 += __ldcg(pb + 3);
    }
    s_red[0][threadIdx.x] = q0, s_red[1][threadIdx.x] = q1;
    s_red[2][threadIdx.x] = q2, s_red[3][threadIdx.x] = q3;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  double logr = 0.0, logres = 0.0, act = 0.0, open = 0.0;
  for (int t = 0; t < kThreads; ++t)
    logr += s_red[0][t], logres += s_red[1][t], act += s_red[2][t], open += s_red[3][t];
  const long n_act = (long)act, n_open = (long)open;
  if (a.adaptive && a.shared) {
    const int ind = ind_shared;
    const T rk = rhos[ind];
    const T gm = n_act > 0 ? exp_t(div_rn(static_cast<T>(logr), static_cast<T>(n_act))) : rk;
    int new_ind = ladder(rhos, a.n_rho, ind, gm, static_cast<T>(a.tol), a.jump);
    if (!walk_now(k_new, a.ci, a.stride)) new_ind = ind;
    a.tick[1] = ind;
    *a.rho_ind = new_ind;
  }
  const bool running = n_open > a.stop_open && k_new < a.budget;
  if (a.phase_a) {
    T* bm = static_cast<T*>(a.best_m);
    const T metric =
        div_rn(static_cast<T>(logres), static_cast<T>(n_open > 1 ? n_open : 1));
    const bool improved =
        metric < sub_rn(*bm, static_cast<T>(a.stall)) || n_open < *a.best_open;
    const int n_stall = improved ? 0 : *a.n_stall + 1;
    if (metric < *bm) *bm = metric;
    if (n_open < *a.best_open) *a.best_open = (int)n_open;
    *a.n_stall = n_stall;
    *a.k_fast = k_new;
    *a.open_a = n_stall < 2 && k_new < a.cap_a && running;
  }
  *a.k = k_new;
  *a.n_open = (int)n_open;
  *a.open = running;
  *a.tail = n_open > 0;
}

// The shared walk's re-encode of p for the rung C2 decided (alpha != 1):
// p <- z + (rho_old / rho_new) (p - z), elementwise, the old rung kept by
// C2 in tick[1].
template <typename T>
__global__ void __launch_bounds__(kThreads) c2_reencode(const C2Args a) {
  const int nc = a.nc, nx = a.nx;
  const T* reff = static_cast<const T*>(a.rho_eff);
  const T* r_old = reff + (size_t)clamp_ind(a.tick[1], a.n_rho) * nc;
  const T* r_new = reff + (size_t)clamp_ind(*a.rho_ind, a.n_rho) * nc;
  T* Y = static_cast<T*>(a.Y);
  const long n = (long)a.B * nc;
  for (long q = blockIdx.x * (long)kThreads + threadIdx.x; q < n; q += (long)gridDim.x * kThreads) {
    const int b = (int)(q / nc), i = (int)(q % nc);
    T* yr = Y + (size_t)b * a.dp;
    const T z = yr[nx + i];
    yr[nx + nc + i] = add_rn(z, mul_rn(div_rn(r_old[i], r_new[i]), sub_rn(yr[nx + nc + i], z)));
  }
}

template <typename T>
cudaError_t c2_launch(const C2Args& a, cudaStream_t stream, int* launches) {
  int dev, nsm;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  const C2Plan p = c2_plan(a, nsm);
  if (p.smem > 48 * 1024 &&
      (e = cudaFuncSetAttribute(c2_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                p.smem)))
    return e;
  c2_kernel<T><<<p.grid, kThreads, p.smem, stream>>>(a, p);
  if ((e = cudaGetLastError())) return e;
  *launches = 1;
  if (a.adaptive && a.shared && a.alpha && a.B > 0) {
    const long n = (long)a.B * a.nc;
    long blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 4L * nsm) blocks = 4L * nsm;
    c2_reencode<T><<<(int)blocks, kThreads, 0, stream>>>(a);
    if ((e = cudaGetLastError())) return e;
    *launches = 2;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------------------
// a captured graph's nodes by name, for the checks of what a window runs
// ------------------------------------------------------------------------

typedef CUresult (*GetParamsFn)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*);
typedef CUresult (*FuncNameFn)(const char**, CUfunction);
typedef CUresult (*KernNameFn)(const char**, CUkernel);

void* driver_entry(const char* name) {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &fn, 12030, cudaEnableDefault, &q) != cudaSuccess)
    return nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &fn, cudaEnableDefault, &q) != cudaSuccess) return nullptr;
#endif
  return q == cudaDriverEntryPointSuccess ? fn : nullptr;
}

const char* node_kind(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "other";
  }
}

// cw_graph_kernels' walk of one graph, appending at buf + pos.
cudaError_t walk_graph(cudaGraph_t g, char* buf, int len, int& pos) {
  size_t n = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e) return e;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n && (e = cudaGraphGetNodes(g, nodes.data(), &n))) return e;
  std::vector<int> indeg(n, 0), done(n, 0);
  for (size_t i = 0; i < n; ++i) {
    size_t d = 0;
    if ((e = cudaGraphNodeGetDependencies(nodes[i], nullptr, &d))) return e;
    indeg[i] = (int)d;
  }
  auto get_params = reinterpret_cast<GetParamsFn>(driver_entry("cuGraphKernelNodeGetParams"));
  auto func_name = reinterpret_cast<FuncNameFn>(driver_entry("cuFuncGetName"));
  auto kern_name = reinterpret_cast<KernNameFn>(driver_entry("cuKernelGetName"));
  for (size_t step = 0; step < n; ++step) {
    size_t i = 0;
    while (i < n && (done[i] || indeg[i] > 0)) ++i;
    if (i == n) return cudaErrorInvalidValue;  // not a DAG
    done[i] = 1;
    cudaGraphNodeType t;
    if ((e = cudaGraphNodeGetType(nodes[i], &t))) return e;
    const char* name = node_kind(t);
    if (t == cudaGraphNodeTypeGraph) {
      cudaGraph_t child = nullptr;
      if ((e = cudaGraphChildGraphNodeGetGraph(nodes[i], &child))) return e;
      if ((e = walk_graph(child, buf, len, pos))) return e;
      name = nullptr;
    } else if (t == cudaGraphNodeTypeKernel) {
      name = "kernel";
      CUDA_KERNEL_NODE_PARAMS kp;
      memset(&kp, 0, sizeof(kp));
      if (get_params && get_params(reinterpret_cast<CUgraphNode>(nodes[i]), &kp) == CUDA_SUCCESS) {
        const char* s = nullptr;
        if (kp.func && func_name && func_name(&s, kp.func) == CUDA_SUCCESS && s) name = s;
        else if (kp.kern && kern_name && kern_name(&s, kp.kern) == CUDA_SUCCESS && s) name = s;
      }
    }
    if (name) pos += snprintf(buf + pos, pos < len ? len - pos : 0, "%s\n", name);
    if (pos >= len) return cudaErrorInvalidValue;
    size_t nd = 0;
    if ((e = cudaGraphNodeGetDependentNodes(nodes[i], nullptr, &nd))) return e;
    std::vector<cudaGraphNode_t> deps(nd);
    if (nd && (e = cudaGraphNodeGetDependentNodes(nodes[i], deps.data(), &nd))) return e;
    for (size_t j = 0; j < nd; ++j)
      for (size_t q = 0; q < n; ++q)
        if (nodes[q] == deps[j]) --indeg[q];
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The scratch doubles c1_check's launch takes for these arguments.
int c1_part_size(const C1Args* a) {
  Seg segs[kMaxSeg];
  int part;
  c1_segments(*a, segs, &part);
  return part > 0 ? part : 1;
}

// One launch of C1 on `stream` (a's part: c1_part_size doubles). Returns
// cudaError_t.
int c1_check(const C1Args* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dp < 1 || a->nx < 1 || a->nc < 1 || a->n_rho < 1 || !a->part || !a->tick)
    return (int)cudaErrorInvalidValue;
  if (a->dtype == DT_F32) return (int)c1_launch<float>(*a, st);
  if (a->dtype == DT_F64) return (int)c1_launch<double>(*a, st);
  return (int)cudaErrorInvalidValue;
}

// The scratch doubles c2_check's launch takes (four per block).
int c2_part_size(const C2Args* a) {
  int dev, nsm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  return 4 * c2_plan(*a, nsm).grid;
}

// C2 on `stream`: one launch, or two where the shared walk re-encodes p
// (*launches says which). Returns cudaError_t.
int c2_check(const C2Args* a, void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (a->B < 0 || a->nx < 1 || a->nc < 1 || a->n_rho < 1 || !a->part || !a->tick)
    return (int)cudaErrorInvalidValue;
  if (a->dtype == DT_F32) return (int)c2_launch<float>(*a, st, launches);
  if (a->dtype == DT_F64) return (int)c2_launch<double>(*a, st, launches);
  return (int)cudaErrorInvalidValue;
}

// The nodes of `graph` in the order they run (Kahn's order, ties in the
// graph's own order), one per line into `buf`: a kernel node by its
// function's name, a child graph's nodes in its place, any other node by
// its kind. Returns cudaError_t.
int cw_graph_kernels(void* graph, char* buf, int len) {
  int pos = 0;
  buf[0] = 0;
  return (int)walk_graph(static_cast<cudaGraph_t>(graph), buf, len, pos);
}

const char* cw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
