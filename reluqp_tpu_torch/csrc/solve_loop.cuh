// The device solve loop shared by K2 (csrc/solve_kernel.cu, the whole
// rollout) and K3 (csrc/full_solve.cu, the whole solve): check windows of
// y <- clip(y @ W_k + b_k, lo, hi), the one-matmul residuals
// y @ M_res = [Ax | z | Hx | A'lam], the rho estimate, the ladder walk
// (step or jump, every `stride`-th check) and the exit at eps, plus K3's
// options: lam = rho_vec * (p - z) and A'lam = lam @ A_w under alpha != 1
// with the p re-encode on a rung change, the OSQP infeasibility
// certificates, and the verbose line.
//
// Every product is rounded to fp32, as the TPU kernels' fp32-result dots
// are, then cast to the state type (a no-op in fp32). The residual maxima,
// rho and the tolerances are fp32 in an fp64 run too.
//
// Work split (the caller sets it up): each of the G blocks of a cooperative
// launch owns a contiguous share of each index space -- y lanes (columns of
// W and of M_aff, so b_j, lo_j, hi_j are block-local), constraint lanes
// (columns i of M_res's Ax and z segments) and variable lanes (columns j of
// the Hx and A'lam segments, of A_w and A_inf, and entry j of the g row) --
// and keeps those column slabs in shared memory, transposed to [col][row],
// or reads them from L2 where they do not fit. Every block holds the whole
// y in shared memory. One warp reduces one column dot product.
//
// Cross-block decisions: each block writes its partial maxima to one row
// of a (G, kPartCols) array; after grid.sync() every block reduces the
// whole array. A max is exact in any order, so every block reaches
// bit-identical pri, dua, rho, rung and status and takes identical branches
// around every grid.sync(). The certificates' two sums (the support
// function and g.dx) and their norms are not split over blocks: every
// block computes them whole, from its own copy of y and of lam, in one
// fixed order, so all blocks again hold identical values. No atomics and
// no block-local decision.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

#include "tiers.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;
// Columns of the cross-block partials array: pri, dua, scale_p, scale_d,
// max|A'dlam|, max|H dx|, "a ray test failed", unused.
constexpr int kPartCols = 8;
constexpr float kTinyF = 1e-30f;
constexpr double kTiny = 1e-30;

enum { ST_RUNNING = -1, ST_MAXITER = 0, ST_SOLVED = 1, ST_PINF = 2, ST_DINF = 3 };

// NaN-propagating max and min (a NaN residual must not be dropped, as
// fmax/fmin would).
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) {
  return (a < b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nmax(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// One block's share [lo, lo + n) of an index space of size `total`.
struct Range {
  int lo, n;
};

__device__ __forceinline__ Range split(int total, int nblocks, int b) {
  const int lo = (int)((long long)b * total / nblocks);
  const int hi = (int)((long long)(b + 1) * total / nblocks);
  return Range{lo, hi - lo};
}

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// Columns of a row-major operand, as held by one block: element i of owned
// column c is p[i * si + c * sc] -- (slab, 1, rows) when the columns sit
// transposed in shared memory, (base + col0, ld, 1) when read from global.
template <typename MT>
struct Cols {
  const MT* p;
  int si, sc;
  __device__ __forceinline__ const MT* col(int c) const { return p + (size_t)c * sc; }
};

// Copy columns [col0, col0 + ncols) of a row-major (rows, ld) matrix into
// dst[c * rows + i], and return the accessor; or return the global one.
template <typename MT>
__device__ Cols<MT> take_cols(MT* dst, const MT* src, int rows, int ld, int col0,
                              int ncols, bool resident) {
  if (!resident) return Cols<MT>{src + col0, ld, 1};
  for (int t = threadIdx.x; t < rows * ncols; t += kThreads) {
    const int i = t / ncols;
    const int c = t - i * ncols;
    dst[(size_t)c * rows + i] = src[(size_t)i * ld + col0 + c];
  }
  return Cols<MT>{dst, 1, rows};
}

// How a dot product accumulates. AccState<T> (K2): in the state type, with
// fused multiply-adds. AccF64 (K3): in fp64 with each product and each sum
// rounded on its own, in an fp32 run too; then the fp32 result depends on
// nothing but the order of the sum, and that order (below) is one that the
// plain version reproduces step for step, so the two agree bit for bit.
template <typename T>
struct AccState {
  using type = T;
  static __device__ __forceinline__ T mac(T a, T x, T y) { return a + x * y; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
struct AccF64 {
  using type = double;
  static __device__ __forceinline__ double mac(double a, double x, double y) {
    return __dadd_rn(a, __dmul_rn(x, y));
  }
  static __device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
};

// Lane 0 gets the warp's sum: the shuffle tree adds lane l + 16 into lane
// l, then l + 8, 4, 2, 1.
template <typename Acc>
__device__ __forceinline__ typename Acc::type warp_tree(typename Acc::type a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a = Acc::add(a, __shfl_down_sync(0xffffffffu, a, off));
  return a;
}

// Dot of a vector in shared memory with one column, rounded to fp32 (the
// TPU kernel's dot result): lane l of the warp sums entries l, l + 32, ...
// in order, then warp_tree.
template <typename Acc, typename T, typename MT>
__device__ __forceinline__ float dot32(const T* v, const MT* col, int si, int n, int lane) {
  using AT = typename Acc::type;
  AT a = AT(0);
  for (int i = lane; i < n; i += 32)
    a = Acc::mac(a, static_cast<AT>(v[i]), cvt<AT>(col[(size_t)i * si]));
  return static_cast<float>(warp_tree<Acc>(a));
}

// The iteration product y . W[:, j] at the tier: "high" sums its three
// bf16-split passes (each product exact in fp32), rounds each sum to fp32
// and adds them in fp32; "bf16" is one pass of bf16-rounded inputs.
template <typename Acc, typename T, typename WT>
__device__ __forceinline__ float iter_dot(const T* y, const WT* w, int si, int n,
                                          int lane, int tier) {
  using AT = typename Acc::type;
  if (tier == TIER_HIGHEST) return dot32<Acc, T, WT>(y, w, si, n, lane);
  if (tier == TIER_HIGH) {
    AT a0 = AT(0), a1 = AT(0), a2 = AT(0);
    for (int i = lane; i < n; i += 32) {
      const float yv = to_f(y[i]);
      const float wv = to_f(w[(size_t)i * si]);
      const float yh = bf16r(yv), yl = bf16r(yv - yh);
      const float wh = bf16r(wv), wl = bf16r(wv - wh);
      a0 = Acc::add(a0, static_cast<AT>(yh * wl));
      a1 = Acc::add(a1, static_cast<AT>(yl * wh));
      a2 = Acc::add(a2, static_cast<AT>(yh * wh));
    }
    const float s0 = static_cast<float>(warp_tree<Acc>(a0));
    const float s1 = static_cast<float>(warp_tree<Acc>(a1));
    const float s2 = static_cast<float>(warp_tree<Acc>(a2));
    return (s0 + s1) + s2;
  }
  AT a = AT(0);
  for (int i = lane; i < n; i += 32)
    a = Acc::add(a, static_cast<AT>(bf16r(to_f(y[i])) * bf16r(to_f(w[(size_t)i * si]))));
  return static_cast<float>(warp_tree<Acc>(a));
}

// Decisions every block computes identically after the residual barrier.
struct Decision {
  int k_idx, status;
  float rho, pri, dua;
};

// The certificates' whole-vector scalars, computed by every block alike.
struct CertScalars {
  float norm_dlam, eps_p, support, norm_dx, eps_d, gdx;
};

// The scalar state of one solve; identical in every block.
struct LoopState {
  int k_idx, k, status;
  float rho, pri, dua;
};

// What one block needs to run check windows, with state type T, weight
// type WT and dot accumulation Acc. Pointers into shared memory are
// block-local; the rest is the launch's.
template <typename T, typename WT, typename Acc>
struct Loop {
  // dimensions and this block's shares
  int dp, nx, nc, ncp, nplp, n_rho;
  Range ry, rc, rv;
  // shared memory: the whole y; this block's lo, hi, b (y lanes) and g row
  // (variable lanes); the residual columns; the decision
  T *ys, *lo_s, *hi_s, *b_s;
  const T* g_s;
  float* rr;  // [Ax | z | Hx | A'lam] columns, then [A dx | H dx | A'dlam]
  Decision* dec;
  // the plant state of the state-affine bias (null: the bias is bias_c[k])
  const T* xv;
  // slabs: W and M_aff reloaded on a rung change, M_res's four segments,
  // A_w (alpha) and A_inf (certificates)
  WT* w_slab;
  T* ma_slab;
  Cols<WT> wc;
  Cols<T> mac, mra, mrz, mrh, mrl, maw, mai;
  // K2: u = y @ S_u - Kx on this block's u lanes, computed with every
  // window's residuals into the global u_out (n_u = 0 in K3)
  Cols<T> msu;
  int n_u, u_lo;
  const T* kx;
  T* u_out;
  // global operands
  const WT* wt;
  const T *bias_c, *m_aff;
  // bias_c[k * bias_ld + bias_off + p]: the bias of this block's y lane p
  // at rung k (bias_c (N, dp) in global memory, or a copy of the block's
  // lanes)
  int bias_ld, bias_off;
  const float* rhos;
  T* ybuf;
  double* part;
  int resident, resident_rung, parity;
  // settings
  int limit, ci, adaptive, jump, stride;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
  // K3's options (0 / null in K2)
  int alpha, infeas, verbose;
  const float* reff;  // (N, ncp) per-rung rho_vec (alpha)
  T *lam_s, *d_s;     // lam and p - z, all ncp lanes (alpha or certificates)
  T *yprev_s, *lamp_s, *dy_s, *dlam_s;  // certificate state and deltas
  const T *inv_wp, *inv_wd, *l_nc, *u_nc, *fin_l, *fin_u, *g_dp;
  CertScalars* cert;
  float eps_pinf, eps_dinf;
};

// lam (and d = p - z under alpha) on all ncp constraint lanes, from this
// block's copy of y: the selector products of the TPU kernel as lane reads,
// rounded to fp32 as its dot is.
template <typename T, typename WT, typename Acc>
__device__ __forceinline__ void compute_lam(Loop<T, WT, Acc>& s, int k_idx, T* lam, T* d) {
  const int nx = s.nx, nc = s.nc;
  for (int i = threadIdx.x; i < s.ncp; i += kThreads) {
    T l = T(0), dd = T(0);
    if (i < nc) {
      if (s.alpha) {
        dd = static_cast<T>(static_cast<float>(s.ys[nx + nc + i] - s.ys[nx + i]));
        l = static_cast<T>(s.reff[(size_t)k_idx * s.ncp + i]) * dd;
      } else {
        l = static_cast<T>(static_cast<float>(s.ys[nx + nc + i]));
      }
    }
    lam[i] = l;
    if (d) d[i] = dd;
  }
}

// One check window: rung residency, the bias, n_steps iterations, the
// residual check and the decision. `tail` is K3's max_iter % ci window:
// residuals and the exit only, the rung held, no certificates or print.
template <typename T, typename WT, typename Acc>
__device__ __forceinline__ void check_window(Loop<T, WT, Acc>& s, cg::grid_group& grid, LoopState& st,
                             int n_steps, int tier, bool tail) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = s.dp, ncp = s.ncp, nplp = s.nplp;
  const Range ry = s.ry, rc = s.rc, rv = s.rv;
  const int k_idx = st.k_idx;
  if (k_idx != s.resident_rung) {
    __syncthreads();
    s.wc = take_cols(s.w_slab, s.wt + (size_t)k_idx * dp * dp, dp, dp, ry.lo, ry.n,
                     s.resident);
    if (s.xv)
      s.mac = take_cols(s.ma_slab, s.m_aff + (size_t)k_idx * nplp * dp, nplp, dp, ry.lo,
                        ry.n, s.resident);
    s.resident_rung = k_idx;
    __syncthreads();
  }
  for (int p = warp; p < ry.n; p += kWarps) {
    const T c = s.bias_c[(size_t)k_idx * s.bias_ld + s.bias_off + p];
    if (s.xv) {
      const float r = dot32<Acc, T>(s.xv, s.mac.col(p), s.mac.si, nplp, lane);
      if (lane == 0) s.b_s[p] = c + static_cast<T>(r);
    } else if (lane == 0) {
      s.b_s[p] = c;
    }
  }
  __syncthreads();
  {
    // the hot loop reads its operands from locals, not through `s`
    const Cols<WT> wc = s.wc;
    T* const ys = s.ys;
    const T *const b_s = s.b_s, *const lo_s = s.lo_s, *const hi_s = s.hi_s;
    int parity = s.parity;
    for (int it = 0; it < n_steps; ++it) {
      T* dst = s.ybuf + (size_t)parity * dp;
      parity ^= 1;
      for (int p = warp; p < ry.n; p += kWarps) {
        const float r = iter_dot<Acc, T, WT>(ys, wc.col(p), wc.si, dp, lane, tier);
        if (lane == 0) {
          T v = static_cast<T>(r) + b_s[p];
          // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
          v = v < lo_s[p] ? lo_s[p] : v;
          v = v > hi_s[p] ? hi_s[p] : v;
          dst[ry.lo + p] = v;
        }
      }
      grid.sync();
      for (int i = threadIdx.x; i < dp; i += kThreads) ys[i] = __ldcg(dst + i);
      __syncthreads();
    }
    s.parity = parity;
  }

  const bool need_lam = s.alpha || s.infeas;
  const bool certs = s.infeas && !tail;
  if (need_lam) {
    compute_lam(s, k_idx, s.lam_s, s.d_s);
    __syncthreads();
  }
  if (certs) {
    // deltas since the last check, rounded to fp32 as the TPU kernel's
    // (y - y_prev).astype(f32) is. Only x lanes of dy reach the products
    // (M_res's Ax and Hx columns, g_dp), and the alpha re-encode below
    // moves p lanes only, so these equal the deltas after it.
    for (int i = threadIdx.x; i < dp; i += kThreads)
      s.dy_s[i] = static_cast<T>(static_cast<float>(s.ys[i] - s.yprev_s[i]));
    for (int i = threadIdx.x; i < ncp; i += kThreads)
      s.dlam_s[i] = static_cast<T>(static_cast<float>(s.lam_s[i] - s.lamp_s[i]));
    __syncthreads();
    if (warp == 0) {
      float ndl = 0.f, ndx = 0.f;
      double sup = 0.0, gdx = 0.0;
      for (int i = lane; i < ncp; i += 32) {
        const float dl = static_cast<float>(s.dlam_s[i]);
        ndl = nmax(ndl, fabsf(dl));
        float term = 0.f;
        if (dl > 0.f) term = static_cast<float>(s.u_nc[i]) * dl;
        else if (dl < 0.f) term = static_cast<float>(s.l_nc[i]) * dl;
        sup = __dadd_rn(sup, static_cast<double>(term));
      }
      for (int i = lane; i < dp; i += 32) {
        const float dx = static_cast<float>(s.dy_s[i]);
        if (i < s.nx) ndx = nmax(ndx, fabsf(dx));
        gdx = __dadd_rn(gdx, static_cast<double>(dx * static_cast<float>(s.g_dp[i])));
      }
      ndl = warp_max(ndl);
      ndx = warp_max(ndx);
      sup = warp_tree<AccF64>(sup);
      gdx = warp_tree<AccF64>(gdx);
      if (lane == 0) {
        CertScalars* c = s.cert;
        c->norm_dlam = ndl;
        c->eps_p = s.eps_pinf * ndl;
        c->support = static_cast<float>(sup);
        c->norm_dx = ndx;
        c->eps_d = s.eps_dinf * ndx;
        c->gdx = static_cast<float>(gdx);
      }
    }
  }

  // residual columns of this block: [Ax | z] on its constraint lanes,
  // [Hx | A'lam] on its variable lanes; then, with the certificates,
  // [A dx] and [H dx | A'dlam]
  const int n_res = 2 * rc.n + 2 * rv.n;
  const int n_all = n_res + (certs ? rc.n + 2 * rv.n : 0);
  for (int p = warp; p < n_all + s.n_u; p += kWarps) {
    int q = p;
    float r;
    if (q >= n_all) {
      // K2's u lanes, stored where every block reads them after the
      // residual barrier
      q -= n_all;
      const T v0 = static_cast<T>(dot32<Acc, T>(s.ys, s.msu.col(q), s.msu.si, dp, lane));
      if (lane == 0) s.u_out[s.u_lo + q] = v0 - s.kx[q];
      continue;
    }
    if (q < rc.n) {
      r = dot32<Acc, T>(s.ys, s.mra.col(q), s.mra.si, dp, lane);
    } else if ((q -= rc.n) < rc.n) {
      r = dot32<Acc, T>(s.ys, s.mrz.col(q), s.mrz.si, dp, lane);
    } else if ((q -= rc.n) < rv.n) {
      r = dot32<Acc, T>(s.ys, s.mrh.col(q), s.mrh.si, dp, lane);
    } else if ((q -= rv.n) < rv.n) {
      r = s.alpha ? dot32<Acc, T>(s.lam_s, s.maw.col(q), s.maw.si, ncp, lane)
                  : dot32<Acc, T>(s.ys, s.mrl.col(q), s.mrl.si, dp, lane);
    } else if ((q -= rv.n) < rc.n) {
      r = dot32<Acc, T>(s.dy_s, s.mra.col(q), s.mra.si, dp, lane) *
          static_cast<float>(s.inv_wp[rc.lo + q]);
    } else if ((q -= rc.n) < rv.n) {
      r = dot32<Acc, T>(s.dy_s, s.mrh.col(q), s.mrh.si, dp, lane) *
          static_cast<float>(s.inv_wd[rv.lo + q]);
    } else {
      q -= rv.n;
      r = dot32<Acc, T>(s.dlam_s, s.mai.col(q), s.mai.si, ncp, lane);
    }
    if (lane == 0) s.rr[p] = r;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float p_pri = 0.f, p_sp = 0.f, p_atdl = 0.f, p_hdx = 0.f, p_bad = 0.f;
    T p_dua = T(0), p_sd = T(0);
    const float* rr = s.rr;
    for (int i = 0; i < rc.n; ++i) {
      const float ax = rr[i], z = rr[rc.n + i];
      p_pri = nmax(p_pri, fabsf(ax - z));
      p_sp = nmax(p_sp, nmax(fabsf(ax), fabsf(z)));
    }
    for (int i = 0; i < rv.n; ++i) {
      const float hx = rr[2 * rc.n + i], atl = rr[2 * rc.n + rv.n + i];
      const T d = static_cast<T>(hx + atl) + s.g_s[i];
      p_dua = nmax(p_dua, d < T(0) ? -d : d);
      p_sd = nmax(p_sd, static_cast<T>(nmax(fabsf(hx), fabsf(atl))));
      p_sd = nmax(p_sd, s.g_s[i] < T(0) ? -s.g_s[i] : s.g_s[i]);
    }
    if (certs) {
      const float eps_d = s.cert->eps_d;
      for (int i = 0; i < rc.n; ++i) {
        const float adx = rr[n_res + i];
        const bool ok_u = adx <= eps_d || static_cast<float>(s.fin_u[rc.lo + i]) == 0.f;
        const bool ok_l = adx >= -eps_d || static_cast<float>(s.fin_l[rc.lo + i]) == 0.f;
        if (!(ok_u && ok_l)) p_bad = 1.f;
      }
      for (int i = 0; i < rv.n; ++i) {
        p_hdx = nmax(p_hdx, fabsf(rr[n_res + rc.n + i]));
        p_atdl = nmax(p_atdl, fabsf(rr[n_res + rc.n + rv.n + i]));
      }
    }
    double* pp = s.part + (size_t)blockIdx.x * kPartCols;
    pp[0] = p_pri;
    pp[1] = static_cast<double>(p_dua);
    pp[2] = p_sp;
    pp[3] = static_cast<double>(p_sd);
    pp[4] = p_atdl;
    pp[5] = p_hdx;
    pp[6] = p_bad;
  }
  grid.sync();
  if (warp == 0) {
    // the certificate columns only where this window wrote them
    const int n_cols = certs ? 7 : 4;
    double m[kPartCols];
#pragma unroll
    for (int c = 0; c < kPartCols; ++c) m[c] = 0.0;
    for (int q = lane; q < (int)gridDim.x; q += 32)
#pragma unroll
      for (int c = 0; c < kPartCols; ++c)
        if (c < n_cols) m[c] = nmax(m[c], __ldcg(s.part + (size_t)q * kPartCols + c));
    // the columns' maxima over the warp, their shuffle levels interleaved
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < kPartCols; ++c)
        m[c] = nmax(m[c], __shfl_down_sync(0xffffffffu, m[c], off));
    }
    if (lane == 0) {
      const float prif = static_cast<float>(m[0]);
      const float spf = static_cast<float>(m[2]);
      const T duaT = static_cast<T>(m[1]), sdT = static_cast<T>(m[3]);
      const float num = prif / nmax(spf, kTinyF);
      const T den = duaT / nmax(sdT, static_cast<T>(kTiny));
      T rn = static_cast<T>(st.rho) *
             sqrt(static_cast<T>(num) / nmax(den, static_cast<T>(kTiny)));
      rn = rn < static_cast<T>(s.rho_min) ? static_cast<T>(s.rho_min) : rn;
      rn = rn > static_cast<T>(s.rho_max) ? static_cast<T>(s.rho_max) : rn;
      const float rho_new = static_cast<float>(rn);
      const float duaf = static_cast<float>(duaT);
      int nk = k_idx;
      if (s.adaptive && !tail) {
        const float rho_k = s.rhos[k_idx];
        const bool above = rho_new > rho_k * s.tol;
        const bool below = rho_new < rho_k / s.tol;
        if (s.jump) {
          const float target = logf(rho_new);
          float best = INFINITY;
          int nearest = 0;
          for (int ri = 0; ri < s.n_rho; ++ri) {
            const float dd = fabsf(logf(s.rhos[ri]) - target);
            if (dd < best) best = dd, nearest = ri;
          }
          if (above || below) nk = nearest;
        } else {
          const bool up = above && k_idx < s.n_rho - 1;
          const bool dn = below && k_idx > 0 && !up;
          nk = k_idx + (int)up - (int)dn;
        }
        if (s.stride > 1 && ((st.k / s.ci) + 1) % s.stride != 0) nk = k_idx;
      }
      if (s.verbose && !tail && blockIdx.x == 0) {
        // each float as <mantissa x 100>e<exp - 2> in integers, in fp32
        float v[3] = {rho_new, prif, duaf};
        int mant[3], ex[3];
        for (int c = 0; c < 3; ++c) {
          const float v32 = nmax(v[c], 1e-30f);
          const float e = floorf(logf(v32) * 0.43429448190325176f);
          const float mt = v32 * expf(-e * 2.302585092994046f);
          mant[c] = (int)(mt * 100.f);
          ex[c] = (int)e - 2;
        }
        printf("Iter: %d, rho: %de%d, res_p: %de%d, res_d: %de%d\n", st.k + s.ci, mant[0],
               ex[0], mant[1], ex[1], mant[2], ex[2]);
      }
      const bool solved = prif < s.eps_pri && duaf < s.eps_dua;
      int status = (solved && st.status < 0) ? ST_SOLVED : st.status;
      if (certs) {
        const CertScalars* c = s.cert;
        const bool pinf = c->norm_dlam > 0.f && static_cast<float>(m[4]) <= c->eps_p &&
                          c->support <= -c->eps_p;
        const bool dinf = c->norm_dx > 0.f && static_cast<float>(m[5]) <= c->eps_d &&
                          c->gdx <= -c->eps_d && m[6] == 0.0;
        if (status < 0 && pinf) status = ST_PINF;
        if (status < 0 && dinf) status = ST_DINF;
      }
      s.dec->k_idx = nk;
      s.dec->status = status;
      s.dec->rho = rho_new;
      s.dec->pri = prif;
      s.dec->dua = duaf;
    }
  }
  __syncthreads();
  const int nk = s.dec->k_idx;
  if (s.alpha && nk != k_idx) {
    // p is rung-scaled (p = z + R^-1 lam): re-encode it for the new rung
    // with the elementwise rho_old / rho_new, rounded to fp32 as the TPU
    // kernel's scatter product is
    for (int i = threadIdx.x; i < s.nc; i += kThreads) {
      const T ro = static_cast<T>(s.reff[(size_t)k_idx * ncp + i]);
      const T rn = static_cast<T>(s.reff[(size_t)nk * ncp + i]);
      const T corr = (ro / rn - T(1)) * s.d_s[i];
      s.ys[s.nx + s.nc + i] += static_cast<T>(static_cast<float>(corr));
    }
  }
  if (certs) {
    __syncthreads();
    for (int i = threadIdx.x; i < dp; i += kThreads) s.yprev_s[i] = s.ys[i];
    for (int i = threadIdx.x; i < ncp; i += kThreads) s.lamp_s[i] = s.lam_s[i];
  }
  st.k_idx = nk;
  st.status = s.dec->status;
  st.rho = s.dec->rho;
  st.pri = s.dec->pri;
  st.dua = s.dec->dua;
  st.k += n_steps;
  __syncthreads();
}

// The solve loop: whole check windows while the solve runs and the budget
// holds one more, then, if still running, the `rem` = max_iter % ci tail
// window (K3; K2 passes 0). `first_always`: run the first window whatever
// the budget (K2's warm step always checks once); K3 tests before every
// window, so a budget below one window runs none. `two_phase`: the windows
// run at `tier` until two consecutive windows improve neither residual by
// 3% or half the budget is spent, then at full precision. Returns the
// iterations of that reduced phase. One call site of check_window, so the
// inlined window is compiled once.
template <typename T, typename WT, typename Acc>
__device__ int run_solve(Loop<T, WT, Acc>& s, cg::grid_group& grid, LoopState& st, int tier,
                         bool first_always, bool two_phase, int rem) {
  const int cap_a = (s.limit / s.ci / 2) * s.ci;
  int stage = two_phase ? 0 : 1, k_fast = 0, n_stall = 0;
  bool first = first_always;
  float best_p = INFINITY, best_d = INFINITY;
  for (;;) {
    const bool running = st.status < 0 && st.k < s.limit;
    if (stage == 0 && !(n_stall < 2 && st.k < cap_a && running)) {
      k_fast = st.k;
      tier = TIER_HIGHEST;
      stage = 1;
    }
    if (stage == 1 && !(running || first)) stage = 2;
    if (stage == 2 && !(rem > 0 && st.status < 0)) break;
    check_window(s, grid, st, stage == 2 ? rem : s.ci, tier, stage == 2);
    first = false;
    if (stage == 2) break;
    if (stage == 0) {
      const bool improved = st.pri < 0.97f * best_p || st.dua < 0.97f * best_d;
      n_stall = improved ? 0 : n_stall + 1;
      best_p = nmin(best_p, st.pri);
      best_d = nmin(best_d, st.dua);
    }
  }
  return k_fast;
}

}  // namespace
