// K6 on Hopper: T warm-started SCENARIO-MPC steps of a B-plant ensemble in
// ONE launch.
//
// Replaces the TPU kernel reluqp_tpu/ops/solve_kernel.py
// `_kernel_scan_rollout_batched` (launched through `full_rollout_batched`),
// the path of scenario_rollout_scan(kernel="scan"). It is K2
// (csrc/solve_kernel.cu) for a (Bp, Dp) block of solver states and a
// (Bp, nplp) block of plant states. Per control step, for every row:
//   1. refresh from its plant state x: the weighted g row, the bound shift
//      (pre-scattered into Dp layout), Kx and Ax -- one product x @ GL;
//   2. the warm solve: whole check windows of y <- clip(y @ W_k + b_k, lo,
//      hi), b_k = c_k + x @ M_aff[k], then the row's residuals from
//      y @ M_res = [Ax | z | Hx | A'lam] and its rho estimate; a row that
//      converged is done, its pri, dua and rho frozen. ONE rung k for the
//      ensemble, walked by the geometric mean of the open rows' estimates
//      (step or jump, every `stride`-th check); the first window always
//      runs; the step ends when every row is done or the budget is spent.
//      Padding rows (pad = 1) start done and report SOLVED;
//   3. u = y @ S_u - Kx, x+ = Ax + u @ Bdw + noise[t].
// Every product is rounded to fp32, as the TPU kernel's fp32-result dots
// are, then cast to the state type; residual maxima, rho and the
// tolerances are fp32 in an fp64 run too. Every product is SUMMED in fp64,
// in fp32 runs too (as K3 does): with fp32 sums the kernel and its plain
// version, which sum in another order, rounded the products apart often
// enough that an fp32 ensemble certified a window apart (175 against 160
// iterations over 10 steps at Dp=640, B=5); fp64 sums rounded to fp32 agree
// but where a product lies within fp64 rounding of an fp32 tie.
//
// What bounds it on this card: per window the iterations do
// 2*ci*Bp*Dp*Dp flops on one Dp x Dp rung and the residual product
// 2*Bp*Dp*R more, ~60 flops per byte of operands at Bp=64, Dp=640, ci=1 --
// above the fp32 ridge, so at full width the fp32 operations bound it.
//
// Design (simple and right first):
//   * The rows are independent except for two things: the shared rung
//     decision (the sum of the open rows' log rho estimates and their
//     count) and the all-done exit (plus the stats maxima). So a block owns
//     `rb` whole rows and runs the refresh, the iterations, the residuals
//     and the plant step for them alone, with __syncthreads only. ONE
//     grid.sync() per check window exchanges the per-row values; K2's four
//     barriers per warm step come from its column split, which this does
//     not need.
//   * The block keeps its rows of y (double buffered), lo, hi, b, x, the g
//     row, Kx, Ax, u and the residual products in shared memory; the
//     operands (W rung, M_aff rung, M_res, GL, S_u, Bdw) are read from L2,
//     one row of the operand per step of the contraction, each thread
//     owning output columns (neighbouring threads on neighbouring
//     addresses) with one accumulator per row of the tile; y's entries are
//     16-byte shared-memory broadcasts. rb is 8 rows, or fewer where the
//     per-row buffers do not fit shared memory (k6_plan).
//   * Cross-block decisions: after its rows' residuals a block writes, per
//     row, [log rho_new (0 when done), open, done after the window, pri,
//     dua, status] into a (2, Bp, 6) fp64 exchange array (double buffered
//     by window parity); after grid.sync() every block copies the whole
//     array to shared memory and one thread sums the logs in fp64 in ROW
//     ORDER (which full_rollout_batched_ref reproduces), counts the open
//     and done rows, and decides the rung and whether another window runs.
//     Every block reads the same values in the same order, so every block
//     takes the same branch around the next grid.sync().
//   * Block 0 writes the step's stats row from the last window's exchange
//     values: [iterations, max pri, max dua, real rows, rung, min status,
//     unsolved rows, 0].
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Entries return a cudaError_t (0 on success), checked right after
// the launch: a cooperative launch that asks for more blocks than can be
// co-resident is otherwise refused silently.

#include "solve_loop.cuh"

// Launch parameters, mirrored field by field by _K6Params in
// reluqp_tpu_torch/ops/solve_kernel.py. Device pointers of distinct
// allocations; matrices row-major.
struct K6Params {
  const void *wt, *bias_c, *m_aff, *rhos, *m_res, *g0w, *gl, *lo0, *hi0, *s_u, *bdw, *y0,
      *x0, *pad, *noise;
  void *xs, *us, *stats, *y_f, *exch;
  int w_dtype, y_dtype, n_rho, dp, nxp, ncp, nup, nplp, bp;
  int n_steps, max_iter, ci, rho0, adaptive, jump, stride, tier;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

namespace {

// Rows per block at most: one register accumulator per row, and one warp
// reduces one row's residuals.
constexpr int kRowsMax = kWarps;
// fp64 values per row of the exchange array.
constexpr int kExCols = 6;
// 16-byte groups of an operand column read ahead of their use (L2 latency,
// not the multiply-adds, bounds the products with few blocks per SM).
constexpr int kAhead = 8;

template <typename T>
struct Args {
  const void* wt;
  const T *bias_c, *m_aff, *m_res, *g0w, *gl, *lo0, *hi0, *s_u, *bdw, *y0, *x0, *noise;
  const float *rhos, *pad;
  T *xs, *us, *y_f;
  float* stats;
  double* exch;
  int n_rho, dp, nxp, ncp, nup, nplp, bp, rb;
  int n_steps, limit, ci, rho0, adaptive, jump, stride, tier;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

// The block's rows times columns [0, n) of a row-major (k, ld) operand m:
// emit(r, c, v) gets row r's product with column c, summed in fp64 and
// rounded to fp32 ("high" rounds each of its three bf16-split sums to fp32
// and adds them in fp32).
// v holds the block's nr rows with row stride ldv; k is a multiple of 16
// bytes of T.
template <int TIER, typename T, typename MT, typename Emit>
__device__ __forceinline__ void rows_product(const T* v, int ldv, int nr, const MT* m, int ld,
                                             int k, int n, Emit&& emit) {
  constexpr int W = 16 / sizeof(T);
  for (int c = threadIdx.x; c < n; c += kThreads) {
    double a0[kRowsMax], a1[kRowsMax], a2[kRowsMax];
#pragma unroll
    for (int r = 0; r < kRowsMax; ++r) a0[r] = a1[r] = a2[r] = 0.0;
    // kAhead * W entries of the column are loaded before they are used,
    // so that many L2 reads are in flight per thread; the sum still runs
    // over i in order
    int i0 = 0;
    for (; i0 + kAhead * W <= k; i0 += kAhead * W) {
      // each entry converted to the rows' type once, not once per row
      T mv[kAhead * W];
#pragma unroll
      for (int q = 0; q < kAhead * W; ++q) mv[q] = cvt<T>(m[(size_t)(i0 + q) * ld + c]);
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r) {
          if (r < nr) {
            T yv[W];
            load16(v + (size_t)r * ldv + i0 + u * W, yv);
#pragma unroll
            for (int q = 0; q < W; ++q)
              mac<TIER, double, T, T>(a0[r], a1[r], a2[r], yv[q], mv[u * W + q]);
          }
        }
      }
    }
    for (; i0 < k; i0 += W) {
      T mv[W];
#pragma unroll
      for (int q = 0; q < W; ++q) mv[q] = cvt<T>(m[(size_t)(i0 + q) * ld + c]);
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r) {
        if (r < nr) {
          T yv[W];
          load16(v + (size_t)r * ldv + i0, yv);
#pragma unroll
          for (int q = 0; q < W; ++q) mac<TIER, double, T, T>(a0[r], a1[r], a2[r], yv[q], mv[q]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsMax; ++r) {
      if (r < nr) {
        const float p = (TIER == TIER_HIGH) ? (static_cast<float>(a0[r]) +
                                               static_cast<float>(a1[r])) +
                                                  static_cast<float>(a2[r])
                                            : static_cast<float>(a0[r]);
        emit(r, c, p);
      }
    }
  }
}

// Per-block shared-memory layout (byte offsets), the same on the host
// (plan) and the device.
struct Layout {
  size_t ya, yb, yd, lo, hi, b, x, ax, g, kx, u, rr, red, rho, pri, dua, st, done, dec, total;
};

template <typename T>
__host__ __device__ Layout make_layout(int rb, int dp, int nxp, int ncp, int nup, int nplp,
                                       int bp) {
  const size_t t = sizeof(T);
  const int R = 2 * ncp + 2 * nxp;
  Layout L;
  size_t o = 0;
  auto put = [&o](size_t bytes) {
    const size_t at = o;
    o = align16(o + bytes);
    return at;
  };
  L.ya = put((size_t)rb * dp * t);
  L.yb = put((size_t)rb * dp * t);
  // an fp64 copy of an fp32 state for the "highest" iteration product
  L.yd = put(t == sizeof(double) ? 0 : (size_t)rb * dp * sizeof(double));
  L.lo = put((size_t)rb * dp * t);
  L.hi = put((size_t)rb * dp * t);
  L.b = put((size_t)rb * dp * t);
  L.x = put((size_t)rb * nplp * t);
  L.ax = put((size_t)rb * nplp * t);
  L.g = put((size_t)rb * nxp * t);
  L.kx = put((size_t)rb * nup * t);
  L.u = put((size_t)rb * nup * t);
  L.rr = put((size_t)rb * R * sizeof(float));
  L.red = put((size_t)bp * 3 * sizeof(double));
  L.rho = put(kRowsMax * sizeof(float));
  L.pri = put(kRowsMax * sizeof(float));
  L.dua = put(kRowsMax * sizeof(float));
  L.st = put(kRowsMax * sizeof(float));
  L.done = put(kRowsMax * sizeof(int));
  L.dec = put(2 * sizeof(int));
  L.total = o;
  return L;
}

template <typename T, typename WT, int TIER>
__device__ __forceinline__ void iterate(const Args<T>& a, const WT* w, T*& cur, T*& nxt,
                                        double* yd, const T* lo, const T* hi, const T* b,
                                        int nr) {
  const int dp = a.dp;
  for (int it = 0; it < a.ci; ++it) {
    T* dst = nxt;
    auto emit = [&](int r, int c, float p) {
      const size_t o = (size_t)r * dp + c;
      T v = static_cast<T>(p) + b[o];
      // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
      v = v < lo[o] ? lo[o] : v;
      v = v > hi[o] ? hi[o] : v;
      dst[o] = v;
    };
    if (TIER == TIER_HIGHEST && sizeof(T) == sizeof(float)) {
      // convert the fp32 rows to fp64 once, not once per multiply-add (the
      // conversions, not the fp64 multiply-adds, bounded the product); the
      // products and their sums are the same
      for (int i = threadIdx.x; i < nr * dp; i += kThreads) yd[i] = cur[i];
      __syncthreads();
      rows_product<TIER, double, WT>(yd, dp, nr, w, dp, dp, dp, emit);
    } else {
      rows_product<TIER, T, WT>(cur, dp, nr, w, dp, dp, dp, emit);
    }
    __syncthreads();
    nxt = cur;
    cur = dst;
  }
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads) k6_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = a.dp, nxp = a.nxp, ncp = a.ncp, nup = a.nup, nplp = a.nplp, bp = a.bp;
  const int R = 2 * ncp + 2 * nxp, R2 = nxp + dp + nup + nplp;
  const Layout L = make_layout<T>(a.rb, dp, nxp, ncp, nup, nplp, bp);
  auto sm = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  T* cur = sm(L.ya);
  T* nxt = sm(L.yb);
  double* yd = reinterpret_cast<double*>(smem + L.yd);
  T *lo = sm(L.lo), *hi = sm(L.hi), *b = sm(L.b);
  T *xr = sm(L.x), *ax = sm(L.ax), *gr = sm(L.g), *kx = sm(L.kx), *ur = sm(L.u);
  float* rr = reinterpret_cast<float*>(smem + L.rr);
  double* red = reinterpret_cast<double*>(smem + L.red);
  float* rho_s = reinterpret_cast<float*>(smem + L.rho);
  float* pri_s = reinterpret_cast<float*>(smem + L.pri);
  float* dua_s = reinterpret_cast<float*>(smem + L.dua);
  float* st_s = reinterpret_cast<float*>(smem + L.st);
  int* done_s = reinterpret_cast<int*>(smem + L.done);
  int* dec = reinterpret_cast<int*>(smem + L.dec);
  const WT* wt = static_cast<const WT*>(a.wt);

  const int r0 = blockIdx.x * a.rb;
  const int nr = min(a.rb, bp - r0);
  for (int i = threadIdx.x; i < nr * dp; i += kThreads) cur[i] = a.y0[(size_t)r0 * dp + i];
  for (int i = threadIdx.x; i < nr * nplp; i += kThreads) xr[i] = a.x0[(size_t)r0 * nplp + i];
  int k_idx = a.rho0 < 0 ? 0 : (a.rho0 >= a.n_rho ? a.n_rho - 1 : a.rho0);
  int par = 0;
  __syncthreads();

  for (int t = 0; t < a.n_steps; ++t) {
    // 1. refresh: the rows' x @ GL
    rows_product<TIER_HIGHEST, T, T>(xr, nplp, nr, a.gl, R2, nplp, R2,
                                     [&](int r, int c, float p) {
      const T v = static_cast<T>(p);
      if (c < nxp) {
        gr[r * nxp + c] = a.g0w[c] + v;
      } else if ((c -= nxp) < dp) {
        lo[(size_t)r * dp + c] = a.lo0[c] + v;  // +-inf padding absorbs the shift
        hi[(size_t)r * dp + c] = a.hi0[c] + v;
      } else if ((c -= dp) < nup) {
        kx[r * nup + c] = v;
      } else {
        ax[r * nplp + c - nup] = v;
      }
    });
    if (threadIdx.x < nr) {
      const int r = threadIdx.x;
      const bool pad = a.pad[r0 + r] > 0.5f;
      rho_s[r] = a.rhos[k_idx];
      pri_s[r] = 0.f;
      dua_s[r] = 0.f;
      done_s[r] = pad;
      st_s[r] = pad ? 1.f : 0.f;
    }
    __syncthreads();

    // 2. the warm solve, whole windows, the first one always
    int k = 0;
    for (;;) {
      const T* bc = a.bias_c + (size_t)k_idx * dp;
      rows_product<TIER_HIGHEST, T, T>(xr, nplp, nr, a.m_aff + (size_t)k_idx * nplp * dp, dp,
                                       nplp, dp, [&](int r, int c, float p) {
        b[(size_t)r * dp + c] = bc[c] + static_cast<T>(p);
      });
      __syncthreads();
      const WT* w = wt + (size_t)k_idx * dp * dp;
      if (a.tier == TIER_HIGHEST)
        iterate<T, WT, TIER_HIGHEST>(a, w, cur, nxt, yd, lo, hi, b, nr);
      else if (a.tier == TIER_HIGH)
        iterate<T, WT, TIER_HIGH>(a, w, cur, nxt, yd, lo, hi, b, nr);
      else
        iterate<T, WT, TIER_BF16>(a, w, cur, nxt, yd, lo, hi, b, nr);
      rows_product<TIER_HIGHEST, T, T>(cur, dp, nr, a.m_res, R, dp, R,
                                       [&](int r, int c, float p) { rr[r * R + c] = p; });
      __syncthreads();

      // the rows' residuals, rho estimates and done flags: warp r, row r
      if (warp < nr) {
        const int r = warp;
        const float* q = rr + (size_t)r * R;
        float pri = 0.f, sp = 0.f, dua = 0.f, sd = 0.f;
        for (int i = lane; i < ncp; i += 32) {
          const float axv = q[i], z = q[ncp + i];
          pri = nmax(pri, fabsf(axv - z));
          sp = nmax(sp, nmax(fabsf(axv), fabsf(z)));
        }
        for (int i = lane; i < nxp; i += 32) {
          const float hx = q[2 * ncp + i], atl = q[2 * ncp + nxp + i];
          const float g32 = static_cast<float>(gr[r * nxp + i]);
          dua = nmax(dua, fabsf((hx + atl) + g32));
          sd = nmax(sd, nmax(nmax(fabsf(hx), fabsf(atl)), fabsf(g32)));
        }
        pri = warp_max(pri);
        sp = warp_max(sp);
        dua = warp_max(dua);
        sd = warp_max(sd);
        if (lane == 0) {
          const float num = pri / nmax(sp, kTinyF);
          const float den = dua / nmax(sd, kTinyF);
          float rn = rho_s[r] * sqrtf(num / nmax(den, kTinyF));
          rn = rn < a.rho_min ? a.rho_min : rn;
          rn = rn > a.rho_max ? a.rho_max : rn;
          const bool open = !done_s[r];
          if (open) {
            pri_s[r] = pri;
            dua_s[r] = dua;
            rho_s[r] = rn;
          }
          const bool newly = open && pri_s[r] < a.eps_pri && dua_s[r] < a.eps_dua;
          if (newly) {
            done_s[r] = 1;
            st_s[r] = 1.f;
          }
          double* e = a.exch + ((size_t)par * bp + r0 + r) * kExCols;
          e[0] = open ? log(static_cast<double>(rn)) : 0.0;
          e[1] = open ? 1.0 : 0.0;
          e[2] = done_s[r] ? 1.0 : 0.0;
          e[3] = pri_s[r];
          e[4] = dua_s[r];
          e[5] = st_s[r];
        }
      }
      grid.sync();

      // every block: the ensemble's rung and exit, from all rows in order
      const double* ex = a.exch + (size_t)par * bp * kExCols;
      for (int i = threadIdx.x; i < bp * 3; i += kThreads)
        red[i] = __ldcg(ex + (size_t)(i / 3) * kExCols + i % 3);
      __syncthreads();
      if (threadIdx.x == 0) {
        double s = 0.0;
        int n_act = 0, all_done = 1;
        for (int q = 0; q < bp; ++q) {
          s += red[3 * q];
          n_act += red[3 * q + 1] > 0.5;
          all_done &= red[3 * q + 2] > 0.5;
        }
        int nk = k_idx;
        if (a.adaptive) {
          const float rho_k = a.rhos[k_idx];
          const float gm =
              n_act > 0 ? static_cast<float>(exp(s / static_cast<double>(n_act))) : rho_k;
          const bool above = gm > rho_k * a.tol;
          const bool below = gm < rho_k / a.tol;
          if (a.jump) {
            const float target = logf(gm);
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
        dec[0] = nk;
        dec[1] = !all_done && k + a.ci < a.limit;
      }
      __syncthreads();
      k_idx = dec[0];
      k += a.ci;
      const bool more = dec[1] != 0;
      par ^= 1;
      if (!more) break;
    }

    // the step's stats row, from the last window's exchange values
    if (blockIdx.x == 0 && warp == 0) {
      const double* ex = a.exch + (size_t)(par ^ 1) * bp * kExCols;
      float mp = 0.f, md = 0.f, ms = INFINITY, unsolved = 0.f, real = 0.f;
      for (int q = lane; q < bp; q += 32) {
        const double* e = ex + (size_t)q * kExCols;
        mp = nmax(mp, static_cast<float>(__ldcg(e + 3)));
        md = nmax(md, static_cast<float>(__ldcg(e + 4)));
        const float s = static_cast<float>(__ldcg(e + 5));
        ms = nmin(ms, s);
        unsolved += 1.f - s;
        real += a.pad[q] < 0.5f ? 1.f : 0.f;
      }
      mp = warp_max(mp);
      md = warp_max(md);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        ms = nmin(ms, __shfl_down_sync(0xffffffffu, ms, off));
        unsolved += __shfl_down_sync(0xffffffffu, unsolved, off);
        real += __shfl_down_sync(0xffffffffu, real, off);
      }
      if (lane == 0) {
        float* out = a.stats + (size_t)t * 8;
        out[0] = (float)k;
        out[1] = mp;
        out[2] = md;
        out[3] = real;
        out[4] = (float)k_idx;
        out[5] = ms;
        out[6] = unsolved;
        out[7] = 0.f;
      }
    }

    // 3. u = y @ S_u - Kx, then x+ = Ax + u @ Bdw + noise, row by row
    const size_t row0 = (size_t)t * bp + r0;
    rows_product<TIER_HIGHEST, T, T>(cur, dp, nr, a.s_u, nup, dp, nup,
                                     [&](int r, int c, float p) {
      const T u = static_cast<T>(p) - kx[r * nup + c];
      ur[r * nup + c] = u;
      a.us[(row0 + r) * nup + c] = u;
    });
    __syncthreads();
    rows_product<TIER_HIGHEST, T, T>(ur, nup, nr, a.bdw, nplp, nup, nplp,
                                     [&](int r, int c, float p) {
      const T xn = (ax[r * nplp + c] + static_cast<T>(p)) + a.noise[(row0 + r) * nplp + c];
      xr[r * nplp + c] = xn;
      a.xs[(row0 + r) * nplp + c] = xn;
    });
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * dp; i += kThreads) a.y_f[(size_t)r0 * dp + i] = cur[i];
}

struct Plan {
  int nblocks, rb, smem;
};

template <typename T, typename WT>
cudaError_t make_plan(int bp, int dp, int nxp, int ncp, int nup, int nplp, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int nsm = 0, smem_optin = 0, coop = 0;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return e;
  if (!coop) return cudaErrorNotSupported;
  constexpr int W = 16 / sizeof(T);
  if (bp < 1 || dp < 1 || nxp < 1 || ncp < 1 || nup < 1 || nplp < 1 || dp % W || nup % W ||
      nplp % W)
    return cudaErrorInvalidValue;
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  int rb = kRowsMax < bp ? kRowsMax : bp;
  while (rb > 1 && make_layout<T>(rb, dp, nxp, ncp, nup, nplp, bp).total > budget) --rb;
  const size_t smem = make_layout<T>(rb, dp, nxp, ncp, nup, nplp, bp).total;
  if (smem > budget) return cudaErrorInvalidValue;  // one row does not fit
  auto fn = k6_kernel<T, WT>;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return e;
  int per_sm = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem)))
    return e;
  const int nblocks = (bp + rb - 1) / rb;
  if (nblocks > per_sm * nsm) return cudaErrorCooperativeLaunchTooLarge;
  plan->nblocks = nblocks;
  plan->rb = rb;
  plan->smem = (int)smem;
  return cudaSuccess;
}

template <typename T, typename WT>
cudaError_t launch(const K6Params& p, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = make_plan<T, WT>(p.bp, p.dp, p.nxp, p.ncp, p.nup, p.nplp, &plan);
  if (e != cudaSuccess) return e;
  Args<T> a;
  a.wt = p.wt;
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
  a.pad = static_cast<const float*>(p.pad);
  a.xs = static_cast<T*>(p.xs);
  a.us = static_cast<T*>(p.us);
  a.y_f = static_cast<T*>(p.y_f);
  a.stats = static_cast<float*>(p.stats);
  a.exch = static_cast<double*>(p.exch);
  a.n_rho = p.n_rho;
  a.dp = p.dp;
  a.nxp = p.nxp;
  a.ncp = p.ncp;
  a.nup = p.nup;
  a.nplp = p.nplp;
  a.bp = p.bp;
  a.rb = plan.rb;
  a.n_steps = p.n_steps;
  a.limit = (p.max_iter / p.ci) * p.ci;
  a.ci = p.ci;
  a.rho0 = p.rho0;
  a.adaptive = p.adaptive;
  a.jump = p.jump;
  a.stride = p.stride;
  a.tier = p.tier;
  a.eps_pri = p.eps_pri;
  a.eps_dua = p.eps_dua;
  a.tol = p.tol;
  a.rho_min = p.rho_min;
  a.rho_max = p.rho_max;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k6_kernel<T, WT>),
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

// Runs p->n_steps control steps of the ensemble; returns cudaError_t.
int k6_full_rollout_batched(const K6Params* p, void* stream) {
  if (p->n_steps < 1 || p->ci < 1 || p->max_iter < p->ci || p->tier < TIER_HIGHEST ||
      p->tier > TIER_BF16 || p->n_rho < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(p->y_dtype, p->w_dtype, [&](auto t, auto w) {
    return launch<decltype(t), decltype(w)>(*p, st);
  });
}

// The launch shape k6_full_rollout_batched would use, for reports.
int k6_plan(int bp, int dp, int nxp, int ncp, int nup, int nplp, int y_dtype, int w_dtype,
            int* nblocks, int* rb, int* smem) {
  Plan plan;
  const cudaError_t e = dispatch(y_dtype, w_dtype, [&](auto t, auto w) {
    return make_plan<decltype(t), decltype(w)>(bp, dp, nxp, ncp, nup, nplp, &plan);
  });
  if (e != cudaSuccess) return (int)e;
  *nblocks = plan.nblocks;
  *rb = plan.rb;
  *smem = plan.smem;
  return 0;
}

const char* k6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
