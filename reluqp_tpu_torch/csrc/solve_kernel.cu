// K2 on Hopper: T warm-started MPC control steps in ONE launch.
//
// Replaces the TPU whole-rollout kernel reluqp_tpu/ops/solve_kernel.py
// `_kernel_scan_rollout` (launched through `full_rollout`), the path of
// mpc_rollout_scan(kernel="scan"). Per control step:
//   1. refresh from the plant state x: the weighted g row, the bound shift
//      (pre-scattered into Dp layout, so lo/hi = lo0/hi0 + shift keeps the
//      +-inf padding), Kx and Ax -- all columns of one product x @ GL;
//   2. the warm solve: whole check windows of y <- clip(y @ W_k + b_k, lo,
//      hi) with b_k = c_k + x @ M_aff[k], then the one-matmul residuals
//      y @ M_res = [Ax | z | Hx | A'lam], the rho estimate, the ladder walk
//      (step or jump, every `stride`-th check) and the exit at eps; the
//      first window always runs; a step that ends running is MAX_ITER;
//   3. u = y @ S_u - Kx, x+ = Ax + u @ Bdw + noise[t].
// Every product is rounded to fp32, as the TPU kernel's fp32-result dots
// are, then cast to the state type (a no-op in fp32). The residual maxima,
// rho and the tolerances are fp32 in an fp64 run too.
//
// What bounds it on this card: per warm step the products move ~2-3 MB of
// operands (W rung 1.6 MB + M_res 2.6 MB + GL, M_aff, S_u at Dp=640 fp32)
// for ~1.2 MFLOP at one iteration per window -- below 1 flop/byte, so the
// bytes would bound it if they came from HBM every step; held on chip, the
// remaining limit is latency: each step is a chain of dependent GEMVs
// (refresh -> iterations -> residuals -> u -> x+) whose every lane needs
// every lane of the previous link.
//
// Design (simple and right first; clusters/DSMEM, wgmma and TMA are later):
//   * ONE cooperative launch per rollout segment, one block per SM,
//     persistent for all T steps. Block b owns a contiguous share of each
//     index space: y lanes (columns of W, of M_aff and of GL's bound-shift
//     segment, so b_j, lo_j, hi_j are block-local), constraint lanes
//     (columns i of M_res's Ax AND z segments, so max|Ax-z| is a block-local
//     partial), variable lanes (columns i of the Hx and A'lam segments and
//     entry i of the g row, so max|Hx+A'lam+g| is too), u lanes (S_u and
//     GL's Kx columns) and x lanes (Bdw and GL's Ax columns).
//   * Each block keeps its column slabs of all those operands in shared
//     memory for the whole launch, transposed to [col][row] so a warp reads
//     a column with unit stride (44 KB at Dp=640 fp32). The W and M_aff
//     slabs are reloaded only when the rung index changes (the counterpart
//     of the TPU kernel's ensure_resident). Where the slabs do not fit, the
//     block reads the same columns from global memory (L2) instead.
//   * One warp reduces one column dot product with a shuffle tree.
//   * y, u and x move between blocks through global buffers (y double
//     buffered) with grid.sync(), read back with __ldcg (L2, not the
//     non-coherent L1, since another SM wrote them in this launch). A warm
//     step at one iteration per window takes four barriers: iteration,
//     residual partials, u, x+.
//   * Cross-block decisions: each block writes its four residual partial
//     maxima to a (grid, 4) array; after the barrier every block reduces
//     the whole array. A max is exact in any order, so every block reaches
//     bit-identical pri/dua/rho and takes identical branches around every
//     grid.sync() (no atomics, no block-local decision).
//   * The scalar state (rung, resident rung, rho, k, status) never leaves
//     the device inside a launch; the start rung is a launch argument.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Entries return a cudaError_t (0 on success), checked right after
// the launch: a cooperative launch that asks for more blocks than can be
// co-resident is otherwise refused silently.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Shared memory kept free for the runtime's own use per block.
constexpr int kSmemReserve = 1024;
constexpr float kTinyF = 1e-30f;
constexpr double kTiny = 1e-30;

enum { DT_F32 = 0, DT_F64 = 1, DT_BF16 = 2 };
enum { TIER_HIGHEST = 0, TIER_HIGH = 1, TIER_BF16 = 2 };
enum { ST_RUNNING = -1, ST_MAXITER = 0, ST_SOLVED = 1 };

}  // namespace

// Launch parameters, mirrored field by field by _K2Params in
// reluqp_tpu_torch/ops/solve_kernel.py. Device pointers of distinct
// allocations; matrices row-major.
struct K2Params {
  const void *wt, *bias_c, *m_aff, *rhos, *m_res, *g0w, *gl, *lo0, *hi0,
      *s_u, *bdw, *y0, *x0, *noise;
  void *xs, *us, *stats, *y_f, *ybuf, *ubuf, *xbuf, *part;
  int w_dtype, y_dtype, n_rho, dp, nxp, ncp, nup, nplp;
  int n_steps, max_iter, ci, rho0, adaptive, jump, stride, tier, part_rows;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(double x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T cvt(float x) { return static_cast<T>(x); }
template <typename T> __device__ __forceinline__ T cvt(double x) { return static_cast<T>(x); }
template <typename T> __device__ __forceinline__ T cvt(__nv_bfloat16 x) {
  return static_cast<T>(__bfloat162float(x));
}

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// NaN-propagating max (a NaN residual must not be dropped, as fmax would).
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
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

// Full-precision dot of a vector in shared memory with one column, summed
// in T over a warp, then rounded to fp32 (the TPU kernel's dot result).
template <typename T, typename MT>
__device__ __forceinline__ float dot32(const T* v, const MT* col, int si, int n, int lane) {
  T a = T(0);
  for (int i = lane; i < n; i += 32) a += v[i] * cvt<T>(col[(size_t)i * si]);
  return static_cast<float>(warp_sum(a));
}

// The iteration product y . W[:, j] at the tier: "high" sums its three
// bf16-split passes in fp32, "bf16" is one pass of bf16-rounded inputs.
template <typename T, typename WT>
__device__ __forceinline__ float iter_dot(const T* y, const WT* w, int si, int n,
                                          int lane, int tier) {
  if (tier == TIER_HIGHEST) return dot32<T, WT>(y, w, si, n, lane);
  if (tier == TIER_HIGH) {
    T a0 = T(0), a1 = T(0), a2 = T(0);
    for (int i = lane; i < n; i += 32) {
      const float yv = to_f(y[i]);
      const float wv = to_f(w[(size_t)i * si]);
      const float yh = bf16r(yv), yl = bf16r(yv - yh);
      const float wh = bf16r(wv), wl = bf16r(wv - wh);
      // products of two bf16 values are exact in fp32
      a0 += static_cast<T>(yh * wl);
      a1 += static_cast<T>(yl * wh);
      a2 += static_cast<T>(yh * wh);
    }
    const float s0 = static_cast<float>(warp_sum(a0));
    const float s1 = static_cast<float>(warp_sum(a1));
    const float s2 = static_cast<float>(warp_sum(a2));
    return (s0 + s1) + s2;
  }
  T a = T(0);
  for (int i = lane; i < n; i += 32)
    a += static_cast<T>(bf16r(to_f(y[i])) * bf16r(to_f(w[(size_t)i * si])));
  return static_cast<float>(warp_sum(a));
}

template <typename T, typename WT>
struct Args {
  const WT* wt;
  const T *bias_c, *m_aff, *m_res, *g0w, *gl, *lo0, *hi0, *s_u, *bdw, *y0, *x0, *noise;
  const float* rhos;
  T *xs, *us, *y_f, *ybuf, *ubuf, *xbuf;
  float* stats;
  double* part;
  int n_rho, dp, nxp, ncp, nup, nplp;
  int n_steps, limit, ci, rho0, adaptive, jump, stride, tier, resident;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

// Per-block shared-memory layout (byte offsets), the same on the host
// (plan) and the device. Counts are the largest share of any block.
struct Layout {
  size_t ys, xv, uv, lo, hi, b, g, kx, ax, rr, dec;              // state
  size_t w, ma, glz, glg, glk, gla, mra, mrz, mrh, mrl, su, bd;  // slabs
  size_t small_end, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

template <typename T, typename WT>
__host__ __device__ Layout make_layout(int dp, int nxp, int ncp, int nup, int nplp,
                                       int nblocks) {
  const int my = ceil_div(dp, nblocks), mc = ceil_div(ncp, nblocks);
  const int mv = ceil_div(nxp, nblocks), mu = ceil_div(nup, nblocks);
  const int mx = ceil_div(nplp, nblocks);
  const size_t t = sizeof(T);
  Layout L;
  size_t o = 0;
  auto put = [&o](size_t bytes) {
    const size_t at = o;
    o = align16(o + bytes);
    return at;
  };
  L.ys = put(dp * t);
  L.xv = put(nplp * t);
  L.uv = put(nup * t);
  L.lo = put(my * t);
  L.hi = put(my * t);
  L.b = put(my * t);
  L.g = put(mv * t);
  L.kx = put(mu * t);
  L.ax = put(mx * t);
  L.rr = put((2 * mc + 2 * mv) * sizeof(float));
  L.dec = put(32);
  L.small_end = o;
  L.w = put((size_t)my * dp * sizeof(WT));
  L.ma = put((size_t)my * nplp * t);
  L.glz = put((size_t)my * nplp * t);
  L.glg = put((size_t)mv * nplp * t);
  L.glk = put((size_t)mu * nplp * t);
  L.gla = put((size_t)mx * nplp * t);
  L.mra = put((size_t)mc * dp * t);
  L.mrz = put((size_t)mc * dp * t);
  L.mrh = put((size_t)mv * dp * t);
  L.mrl = put((size_t)mv * dp * t);
  L.su = put((size_t)mu * dp * t);
  L.bd = put((size_t)mx * nup * t);
  L.total = o;
  return L;
}

// Decisions every block computes identically after the residual barrier.
struct Decision {
  int k_idx, status;
  float rho, pri, dua;
};

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads) k2_kernel(const Args<T, WT> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = gridDim.x, blk = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = a.dp, nxp = a.nxp, ncp = a.ncp, nup = a.nup, nplp = a.nplp;
  const int R = 2 * ncp + 2 * nxp, R2 = nxp + dp + nup + nplp;
  const bool res = a.resident != 0;
  const Layout L = make_layout<T, WT>(dp, nxp, ncp, nup, nplp, G);
  auto sm = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  T* ys = sm(L.ys);
  T* xv = sm(L.xv);
  T* uv = sm(L.uv);
  T *lo_s = sm(L.lo), *hi_s = sm(L.hi), *b_s = sm(L.b);
  T *g_s = sm(L.g), *kx_s = sm(L.kx), *ax_s = sm(L.ax);
  float* rr = reinterpret_cast<float*>(smem + L.rr);
  Decision* dec = reinterpret_cast<Decision*>(smem + L.dec);

  const Range ry = split(dp, G, blk), rc = split(ncp, G, blk);
  const Range rv = split(nxp, G, blk), ru = split(nup, G, blk);
  const Range rx = split(nplp, G, blk);

  // Slabs that do not depend on the rung: loaded once for the launch.
  const Cols<T> glz = take_cols(sm(L.glz), a.gl, nplp, R2, nxp + ry.lo, ry.n, res);
  const Cols<T> glg = take_cols(sm(L.glg), a.gl, nplp, R2, rv.lo, rv.n, res);
  const Cols<T> glk = take_cols(sm(L.glk), a.gl, nplp, R2, nxp + dp + ru.lo, ru.n, res);
  const Cols<T> gla =
      take_cols(sm(L.gla), a.gl, nplp, R2, nxp + dp + nup + rx.lo, rx.n, res);
  const Cols<T> mra = take_cols(sm(L.mra), a.m_res, dp, R, rc.lo, rc.n, res);
  const Cols<T> mrz = take_cols(sm(L.mrz), a.m_res, dp, R, ncp + rc.lo, rc.n, res);
  const Cols<T> mrh = take_cols(sm(L.mrh), a.m_res, dp, R, 2 * ncp + rv.lo, rv.n, res);
  const Cols<T> mrl =
      take_cols(sm(L.mrl), a.m_res, dp, R, 2 * ncp + nxp + rv.lo, rv.n, res);
  const Cols<T> su = take_cols(sm(L.su), a.s_u, dp, nup, ru.lo, ru.n, res);
  const Cols<T> bd = take_cols(sm(L.bd), a.bdw, nup, nplp, rx.lo, rx.n, res);
  Cols<WT> wc{};
  Cols<T> mac{};

  for (int i = threadIdx.x; i < dp; i += kThreads) ys[i] = a.y0[i];
  for (int i = threadIdx.x; i < nplp; i += kThreads) xv[i] = a.x0[i];
  int k_idx = a.rho0 < 0 ? 0 : (a.rho0 >= a.n_rho ? a.n_rho - 1 : a.rho0);
  int resident_rung = -1;
  int parity = 0;
  __syncthreads();

  const int n_ref = ry.n + rv.n + ru.n + rx.n;
  const int n_res = 2 * rc.n + 2 * rv.n;
  for (int t = 0; t < a.n_steps; ++t) {
    // 1. refresh: this block's columns of x @ GL
    for (int p = warp; p < n_ref; p += kWarps) {
      const T* col;
      int q = p, si;
      if (q < ry.n) {
        col = glz.col(q), si = glz.si;
      } else if ((q -= ry.n) < rv.n) {
        col = glg.col(q), si = glg.si;
      } else if ((q -= rv.n) < ru.n) {
        col = glk.col(q), si = glk.si;
      } else {
        q -= ru.n;
        col = gla.col(q), si = gla.si;
      }
      const T r = static_cast<T>(dot32<T, T>(xv, col, si, nplp, lane));
      if (lane == 0) {
        if (p < ry.n) {
          const int j = ry.lo + p;
          lo_s[p] = a.lo0[j] + r;   // +-inf padding absorbs the shift
          hi_s[p] = a.hi0[j] + r;
        } else if (p < ry.n + rv.n) {
          g_s[q] = a.g0w[rv.lo + q] + r;
        } else if (p < ry.n + rv.n + ru.n) {
          kx_s[q] = r;
        } else {
          ax_s[q] = r;
        }
      }
    }

    // 2. the warm solve, whole windows; every branch below is decided from
    //    values that all blocks hold identically
    float rho = a.rhos[k_idx];
    float pri = 0.f, dua = 0.f;
    int k = 0, status = ST_RUNNING;
    do {
      if (k_idx != resident_rung) {
        __syncthreads();
        wc = take_cols(reinterpret_cast<WT*>(smem + L.w), a.wt + (size_t)k_idx * dp * dp,
                       dp, dp, ry.lo, ry.n, res);
        mac = take_cols(sm(L.ma), a.m_aff + (size_t)k_idx * nplp * dp, nplp, dp,
                        ry.lo, ry.n, res);
        resident_rung = k_idx;
        __syncthreads();
      }
      for (int p = warp; p < ry.n; p += kWarps) {
        const float r = dot32<T, T>(xv, mac.col(p), mac.si, nplp, lane);
        if (lane == 0)
          b_s[p] = a.bias_c[(size_t)k_idx * dp + ry.lo + p] + static_cast<T>(r);
      }
      __syncthreads();
      for (int s = 0; s < a.ci; ++s) {
        T* dst = a.ybuf + (size_t)parity * dp;
        parity ^= 1;
        for (int p = warp; p < ry.n; p += kWarps) {
          const float r = iter_dot<T, WT>(ys, wc.col(p), wc.si, dp, lane, a.tier);
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

      // residuals: this block's columns of y @ M_res, then its partials
      for (int p = warp; p < n_res; p += kWarps) {
        const Cols<T>* m;
        int q = p;
        if (q < rc.n) {
          m = &mra;
        } else if ((q -= rc.n) < rc.n) {
          m = &mrz;
        } else if ((q -= rc.n) < rv.n) {
          m = &mrh;
        } else {
          q -= rv.n;
          m = &mrl;
        }
        const float r = dot32<T, T>(ys, m->col(q), m->si, dp, lane);
        if (lane == 0) rr[p] = r;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float p_pri = 0.f, p_sp = 0.f;
        T p_dua = T(0), p_sd = T(0);
        for (int i = 0; i < rc.n; ++i) {
          const float ax = rr[i], z = rr[rc.n + i];
          p_pri = nmax(p_pri, fabsf(ax - z));
          p_sp = nmax(p_sp, nmax(fabsf(ax), fabsf(z)));
        }
        for (int i = 0; i < rv.n; ++i) {
          const float hx = rr[2 * rc.n + i], atl = rr[2 * rc.n + rv.n + i];
          const T d = static_cast<T>(hx + atl) + g_s[i];
          p_dua = nmax(p_dua, d < T(0) ? -d : d);
          p_sd = nmax(p_sd, static_cast<T>(nmax(fabsf(hx), fabsf(atl))));
          p_sd = nmax(p_sd, g_s[i] < T(0) ? -g_s[i] : g_s[i]);
        }
        double* pp = a.part + (size_t)blk * 4;
        pp[0] = p_pri;
        pp[1] = static_cast<double>(p_dua);
        pp[2] = p_sp;
        pp[3] = static_cast<double>(p_sd);
      }
      grid.sync();
      if (warp == 0) {
        double m[4] = {0.0, 0.0, 0.0, 0.0};
        for (int q = lane; q < G; q += 32)
          for (int c = 0; c < 4; ++c) m[c] = nmax(m[c], __ldcg(a.part + (size_t)q * 4 + c));
        for (int c = 0; c < 4; ++c) m[c] = warp_max(m[c]);
        if (lane == 0) {
          const float prif = static_cast<float>(m[0]);
          const float spf = static_cast<float>(m[2]);
          const T duaT = static_cast<T>(m[1]), sdT = static_cast<T>(m[3]);
          const float num = prif / nmax(spf, kTinyF);
          const T den = duaT / nmax(sdT, static_cast<T>(kTiny));
          T rn = static_cast<T>(rho) *
                 sqrt(static_cast<T>(num) / nmax(den, static_cast<T>(kTiny)));
          rn = rn < static_cast<T>(a.rho_min) ? static_cast<T>(a.rho_min) : rn;
          rn = rn > static_cast<T>(a.rho_max) ? static_cast<T>(a.rho_max) : rn;
          const float rho_new = static_cast<float>(rn);
          const float duaf = static_cast<float>(duaT);
          int nk = k_idx;
          if (a.adaptive) {
            const float rho_k = a.rhos[k_idx];
            const bool above = rho_new > rho_k * a.tol;
            const bool below = rho_new < rho_k / a.tol;
            if (a.jump) {
              const float target = logf(rho_new);
              float best = INFINITY;
              int nearest = 0;
              for (int ri = 0; ri < a.n_rho; ++ri) {
                const float dd = fabsf(logf(a.rhos[ri]) - target);
                if (dd < best) best = dd, nearest = ri;
              }
              if (above || below) nk = nearest;
            } else {
              const bool up = above && k_idx < a.n_rho - 1;
              const bool dn = below && k_idx > 0 && !up;
              nk = k_idx + (int)up - (int)dn;
            }
            if (a.stride > 1 && ((k / a.ci) + 1) % a.stride != 0) nk = k_idx;
          }
          const bool solved = prif < a.eps_pri && duaf < a.eps_dua;
          dec->k_idx = nk;
          dec->status = (solved && status < 0) ? ST_SOLVED : status;
          dec->rho = rho_new;
          dec->pri = prif;
          dec->dua = duaf;
        }
      }
      __syncthreads();
      k_idx = dec->k_idx;
      status = dec->status;
      rho = dec->rho;
      pri = dec->pri;
      dua = dec->dua;
      k += a.ci;
    } while (status < 0 && k < a.limit);
    if (status < 0) status = ST_MAXITER;

    // 3. u = y @ S_u - Kx on this block's u lanes, then x+ on its x lanes
    for (int p = warp; p < ru.n; p += kWarps) {
      const T v0 = static_cast<T>(dot32<T, T>(ys, su.col(p), su.si, dp, lane));
      if (lane == 0) {
        const T u = v0 - kx_s[p];
        a.ubuf[ru.lo + p] = u;
        a.us[(size_t)t * nup + ru.lo + p] = u;
      }
    }
    grid.sync();
    for (int i = threadIdx.x; i < nup; i += kThreads) uv[i] = __ldcg(a.ubuf + i);
    __syncthreads();
    for (int p = warp; p < rx.n; p += kWarps) {
      const T d = static_cast<T>(dot32<T, T>(uv, bd.col(p), bd.si, nup, lane));
      if (lane == 0) {
        const int i = rx.lo + p;
        const T xn = (ax_s[p] + d) + a.noise[(size_t)t * nplp + i];
        a.xbuf[i] = xn;
        a.xs[(size_t)t * nplp + i] = xn;
      }
    }
    if (blk == 0 && threadIdx.x == 0) {
      float* st = a.stats + (size_t)t * 8;
      st[0] = (float)k;
      st[1] = pri;
      st[2] = dua;
      st[3] = rho;
      st[4] = (float)k_idx;
      st[5] = (float)status;
      st[6] = 0.f;
      st[7] = 0.f;
    }
    grid.sync();
    for (int i = threadIdx.x; i < nplp; i += kThreads) xv[i] = __ldcg(a.xbuf + i);
    __syncthreads();
  }
  for (int p = threadIdx.x; p < ry.n; p += kThreads) a.y_f[ry.lo + p] = ys[ry.lo + p];
}

struct Plan {
  int nblocks, smem, resident;
};

template <typename T, typename WT>
cudaError_t make_plan(int dp, int nxp, int ncp, int nup, int nplp, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int nsm = 0, smem_optin = 0, coop = 0;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return e;
  if (!coop) return cudaErrorNotSupported;
  if (dp < 1 || nxp < 1 || ncp < 1 || nup < 1 || nplp < 1) return cudaErrorInvalidValue;
  const int nblocks = nsm;
  const Layout L = make_layout<T, WT>(dp, nxp, ncp, nup, nplp, nblocks);
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  if (L.small_end > budget) return cudaErrorInvalidValue;  // state too large
  const int resident = L.total <= budget;
  const size_t smem = resident ? L.total : L.small_end;
  auto fn = k2_kernel<T, WT>;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)))
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  plan->nblocks = nblocks;
  plan->smem = (int)smem;
  plan->resident = resident;
  return cudaSuccess;
}

template <typename T, typename WT>
cudaError_t launch(const K2Params& p, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = make_plan<T, WT>(p.dp, p.nxp, p.ncp, p.nup, p.nplp, &plan);
  if (e != cudaSuccess) return e;
  if (plan.nblocks > p.part_rows) return cudaErrorInvalidValue;
  Args<T, WT> a;
  a.wt = static_cast<const WT*>(p.wt);
  a.bias_c = static_cast<const T*>(p.bias_c);
  a.m_aff = static_cast<const T*>(p.m_aff);
  a.m_res = static_cast<const T*>(p.m_res);
  a.g0w = static_cast<const T*>(p.g0w);
  a.gl = static_cast<const T*>(p.gl);
  a.lo0 = static_cast<const T*>(p.lo0);
  a.hi0 = static_cast<const T*>(p.hi0);
  a.s_u = static_cast<const T*>(p.s_u);
  a.bdw = static_cast<const T*>(p.bdw);
  a.y0 = static_cast<const T*>(p.y0);
  a.x0 = static_cast<const T*>(p.x0);
  a.noise = static_cast<const T*>(p.noise);
  a.rhos = static_cast<const float*>(p.rhos);
  a.xs = static_cast<T*>(p.xs);
  a.us = static_cast<T*>(p.us);
  a.y_f = static_cast<T*>(p.y_f);
  a.ybuf = static_cast<T*>(p.ybuf);
  a.ubuf = static_cast<T*>(p.ubuf);
  a.xbuf = static_cast<T*>(p.xbuf);
  a.stats = static_cast<float*>(p.stats);
  a.part = static_cast<double*>(p.part);
  a.n_rho = p.n_rho;
  a.dp = p.dp;
  a.nxp = p.nxp;
  a.ncp = p.ncp;
  a.nup = p.nup;
  a.nplp = p.nplp;
  a.n_steps = p.n_steps;
  a.limit = (p.max_iter / p.ci) * p.ci;
  a.ci = p.ci;
  a.rho0 = p.rho0;
  a.adaptive = p.adaptive;
  a.jump = p.jump;
  a.stride = p.stride;
  a.tier = p.tier;
  a.resident = plan.resident;
  a.eps_pri = p.eps_pri;
  a.eps_dua = p.eps_dua;
  a.tol = p.tol;
  a.rho_min = p.rho_min;
  a.rho_max = p.rho_max;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k2_kernel<T, WT>),
                                  dim3(plan.nblocks), dim3(kThreads), args,
                                  (size_t)plan.smem, stream);
  const cudaError_t last = cudaGetLastError();
  return e != cudaSuccess ? e : last;
}

template <typename F>
cudaError_t dispatch(int y_dtype, int w_dtype, F&& f) {
  if (y_dtype == DT_F32 && w_dtype == DT_F32) return f(float(), float());
  if (y_dtype == DT_F32 && w_dtype == DT_BF16) return f(float(), __nv_bfloat16());
  if (y_dtype == DT_F64 && w_dtype == DT_F64) return f(double(), double());
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Runs p->n_steps control steps; returns cudaError_t.
int k2_full_rollout(const K2Params* p, void* stream) {
  if (p->n_steps < 1 || p->ci < 1 || p->max_iter < p->ci || p->tier < TIER_HIGHEST ||
      p->tier > TIER_BF16 || p->n_rho < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(p->y_dtype, p->w_dtype, [&](auto t, auto w) {
    return launch<decltype(t), decltype(w)>(*p, st);
  });
}

// The launch shape k2_full_rollout would use, for reports.
int k2_plan(int dp, int nxp, int ncp, int nup, int nplp, int y_dtype, int w_dtype,
            int* nblocks, int* smem, int* resident) {
  Plan plan;
  const cudaError_t e = dispatch(y_dtype, w_dtype, [&](auto t, auto w) {
    return make_plan<decltype(t), decltype(w)>(dp, nxp, ncp, nup, nplp, &plan);
  });
  if (e != cudaSuccess) return (int)e;
  *nblocks = plan.nblocks;
  *smem = plan.smem;
  *resident = plan.resident;
  return 0;
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
