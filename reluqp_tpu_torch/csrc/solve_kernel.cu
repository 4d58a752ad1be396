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
//   * Exchanges, with no grid barrier inside a step: a block stores what
//     it computed beside a tag in 64-bit words (two in fp64) and every
//     block reads all of them as soon as their tags show (solve_loop.cuh,
//     gather_tagged): one round trip to L2 where a grid.sync() took two and
//     the reload a third. Per iteration, y (each block's y lanes). Per
//     check, the blocks' residual partial maxima, and beside them u =
//     y @ S_u - Kx on each block's u lanes, computed with every window's
//     residuals from the same y; the last window's u is the step's, and
//     every block then holds all of it, so u costs no exchange of its own.
//     Per step, x+ (each block's x lanes), for the next step's refresh. A
//     warm step at one iteration per window so takes three tagged
//     exchanges (y, partials and u, x+) where the grid design took three
//     grid barriers and three re-reads from L2.
//   * Slots: each kind of exchange has two slots that its exchanges take
//     in turn (y and the partials by their ordinal in the launch, x+ by the
//     step), tagged 1 or 2 by bit 1 of the ordinal. In every exchange each
//     block writes its own words and reads every block's, and writes those
//     of exchange n + 1 of a kind only after reading all of exchange n; so
//     a block that overwrites exchange n's slot with n + 2 has read every
//     block's n + 1, which each of them wrote after reading n: no block
//     overwrites a value another has yet to read, however many windows a
//     step runs (up to MAX_ITER) or steps a launch holds. u's words ride in
//     the partials' slot and are written before the block's partials row.
//   * Stale words: the launch starts every word at zero (no tag); each
//     block clears the words it writes, and the launch's one grid barrier,
//     before the first exchange (step 0's first iteration), orders every
//     clear before every read.
//   * Cross-block decisions: every block reduces all blocks' partial maxima
//     itself. A max is exact in any order, so every block reaches
//     bit-identical pri/dua/rho, rung and status and takes identical
//     branches around every exchange (no atomics, no block-local
//     decision): a block whose control flow left the others' would poll for
//     words no block writes. There is no fallback to a barrier path: K2
//     always passes its words, so the loop's barrier branches are never
//     taken.
//   * The scalar state (rung, resident rung, rho, k, status) never leaves
//     the device inside a launch; the start rung is a launch argument.
//   * What a step reads besides the slabs is read from global memory once
//     per launch into shared memory (the rung ladder, each block's lanes of
//     lo0, hi0, g0w and of every rung's bias c_k), and the step's noise is
//     loaded at the top of the step and used at its end, so no read in the
//     step's chain waits on L2 but the exchanges'. A redesign on one
//     thread-block cluster (16 blocks, slabs resident across steps, every
//     exchange through distributed shared memory) was measured slower at
//     Dp=640 than this one: its 16 SMs each run 8x this design's share of
//     every product (PERF.md, section 6).
//   * Step 2 is the device solve loop shared with K3 (csrc/solve_loop.cuh),
//     with K3's options off and the first window always run.
// A non-null `stamps` (never on a rollout path) makes block 0 sum its time
// by stage and count its steps and grid barriers (solve_loop.cuh K3S_* and
// K2S_*; ops/solve_kernel.k2_stage_split).
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Entries return a cudaError_t (0 on success), checked right after
// the launch: a cooperative launch that asks for more blocks than can be
// co-resident is otherwise refused silently.

#include "solve_loop.cuh"

// Launch parameters, mirrored field by field by _K2Params in
// reluqp_tpu_torch/ops/solve_kernel.py. Device pointers of distinct
// allocations; matrices row-major.
struct K2Params {
  const void *wt, *bias_c, *m_aff, *rhos, *m_res, *g0w, *gl, *lo0, *hi0,
      *s_u, *bdw, *y0, *x0, *noise;
  void *xs, *us, *stats, *y_f, *yx, *px, *xx, *stamps;
  int w_dtype, y_dtype, n_rho, dp, nxp, ncp, nup, nplp;
  int n_steps, max_iter, ci, rho0, adaptive, jump, stride, tier, part_rows;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

namespace {

template <typename T, typename WT>
struct Args {
  const WT* wt;
  const T *bias_c, *m_aff, *m_res, *g0w, *gl, *lo0, *hi0, *s_u, *bdw, *y0, *x0, *noise;
  const float* rhos;
  T *xs, *us, *y_f;
  uint64_t *yx, *px, *xx;
  float* stats;
  unsigned long long* stamps;
  int n_rho, dp, nxp, ncp, nup, nplp;
  int n_steps, limit, ci, rho0, adaptive, jump, stride, tier, resident;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

// Per-block shared-memory layout (byte offsets), the same on the host
// (plan) and the device. Counts are the largest share of any block.
struct Layout {
  size_t ys, xv, uv, lo, hi, b, g, kx, ax, rr, dec;              // state
  size_t lo0, hi0, g0, bias, rhos;  // constants of the block's lanes
  size_t w, ma, glz, glg, glk, gla, mra, mrz, mrh, mrl, su, bd;  // slabs
  size_t small_end, total;
};

template <typename T, typename WT>
__host__ __device__ Layout make_layout(int dp, int nxp, int ncp, int nup, int nplp, int n_rho,
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
  L.lo0 = put(my * t);
  L.hi0 = put(my * t);
  L.g0 = put(mv * t);
  L.bias = put((size_t)n_rho * my * t);
  L.rhos = put(n_rho * sizeof(float));
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

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads) k2_kernel(const Args<T, WT> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = gridDim.x, blk = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = a.dp, nxp = a.nxp, ncp = a.ncp, nup = a.nup, nplp = a.nplp;
  const int R = 2 * ncp + 2 * nxp, R2 = nxp + dp + nup + nplp;
  const bool res = a.resident != 0;
  const Layout L = make_layout<T, WT>(dp, nxp, ncp, nup, nplp, a.n_rho, G);
  auto sm = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  T* ys = sm(L.ys);
  T* xv = sm(L.xv);
  T* uv = sm(L.uv);
  T *lo_s = sm(L.lo), *hi_s = sm(L.hi);
  T *g_s = sm(L.g), *kx_s = sm(L.kx), *ax_s = sm(L.ax);

  const Range ry = split(dp, G, blk), rc = split(ncp, G, blk);
  const Range rv = split(nxp, G, blk), ru = split(nup, G, blk);
  const Range rx = split(nplp, G, blk);

  // Slabs that do not depend on the rung: loaded once for the launch.
  const Cols<T> glz = stage_cols(sm(L.glz), a.gl, nplp, R2, nxp + ry.lo, ry.n, res);
  const Cols<T> glg = stage_cols(sm(L.glg), a.gl, nplp, R2, rv.lo, rv.n, res);
  const Cols<T> glk = stage_cols(sm(L.glk), a.gl, nplp, R2, nxp + dp + ru.lo, ru.n, res);
  const Cols<T> gla =
      stage_cols(sm(L.gla), a.gl, nplp, R2, nxp + dp + nup + rx.lo, rx.n, res);
  const Cols<T> su = stage_cols(sm(L.su), a.s_u, dp, nup, ru.lo, ru.n, res);
  const Cols<T> bd = stage_cols(sm(L.bd), a.bdw, nup, nplp, rx.lo, rx.n, res);

  // The warm solve of every step runs the shared solve loop; the K3
  // options stay off (value-initialised).
  Loop<T, WT, AccState<T>> s{};
  s.stamps = a.stamps;
  if (a.stamps && threadIdx.x == 0) {
    s.mark = gtimer();
    atomicMin(a.stamps + K3S_START, s.mark);
  }
  s.dp = dp;
  s.ncp = ncp;
  s.nplp = nplp;
  s.n_rho = a.n_rho;
  s.ry = ry;
  s.rc = rc;
  s.rv = rv;
  s.ys = ys;
  s.lo_s = lo_s;
  s.hi_s = hi_s;
  s.b_s = sm(L.b);
  s.g_s = g_s;
  s.rr = reinterpret_cast<float*>(smem + L.rr);
  s.dec = reinterpret_cast<Decision*>(smem + L.dec);
  s.xv = xv;
  s.w_slab = reinterpret_cast<WT*>(smem + L.w);
  s.ma_slab = sm(L.ma);
  s.mra = stage_cols(sm(L.mra), a.m_res, dp, R, rc.lo, rc.n, res);
  s.mrz = stage_cols(sm(L.mrz), a.m_res, dp, R, ncp + rc.lo, rc.n, res);
  s.mrh = stage_cols(sm(L.mrh), a.m_res, dp, R, 2 * ncp + rv.lo, rv.n, res);
  s.mrl = stage_cols(sm(L.mrl), a.m_res, dp, R, 2 * ncp + nxp + rv.lo, rv.n, res);
  s.wt = a.wt;
  // the rung ladder and the constants of this block's lanes, read from
  // global memory once: in the step they would each cost a round trip to L2
  const int my = ceil_div(dp, G);
  T *lo0 = sm(L.lo0), *hi0 = sm(L.hi0), *g0 = sm(L.g0), *bias = sm(L.bias);
  float* rhos = reinterpret_cast<float*>(smem + L.rhos);
  for (int p = threadIdx.x; p < ry.n; p += kThreads) {
    lo0[p] = a.lo0[ry.lo + p];
    hi0[p] = a.hi0[ry.lo + p];
  }
  for (int q = threadIdx.x; q < rv.n; q += kThreads) g0[q] = a.g0w[rv.lo + q];
  for (int i = threadIdx.x; i < a.n_rho * ry.n; i += kThreads)
    bias[(i / ry.n) * my + i % ry.n] = a.bias_c[(size_t)(i / ry.n) * dp + ry.lo + i % ry.n];
  for (int i = threadIdx.x; i < a.n_rho; i += kThreads) rhos[i] = a.rhos[i];
  s.bias_c = bias;
  s.bias_ld = my;
  s.bias_off = 0;
  s.m_aff = a.m_aff;
  s.rhos = rhos;
  s.yx = a.yx;
  s.px = a.px;
  s.resident = res;
  s.resident_rung = -1;
  s.msu = su;
  s.n_u = ru.n;
  s.u_lo = ru.lo;
  s.nup = nup;
  s.kx = kx_s;
  s.uv = uv;
  s.limit = a.limit;
  s.ci = a.ci;
  s.adaptive = a.adaptive;
  s.jump = a.jump;
  s.stride = a.stride;
  s.eps_pri = a.eps_pri;
  s.eps_dua = a.eps_dua;
  s.tol = a.tol;
  s.rho_min = a.rho_min;
  s.rho_max = a.rho_max;

  for (int i = threadIdx.x; i < dp; i += kThreads) ys[i] = a.y0[i];
  for (int i = threadIdx.x; i < nplp; i += kThreads) xv[i] = a.x0[i];
  int k_idx = a.rho0 < 0 ? 0 : (a.rho0 >= a.n_rho ? a.n_rho - 1 : a.rho0);
  cpa_commit();  // the slabs' copies
  // The exchanges' slots start at zero (no tag): each block clears the
  // words it writes -- its y lanes, its partials row and u lanes, its x
  // lanes -- and the launch's one grid barrier comes before the first
  // exchange reads any (check_window, in step 0's first iteration).
  constexpr int N = TagWords<T>::n;
  const size_t n_pw = (size_t)G * kPartCols + nup;  // a partials slot's values
  for (int slot = 0; slot < 2; ++slot) {
    for (int i = threadIdx.x; i < ry.n * N; i += kThreads)
      a.yx[((size_t)slot * dp + ry.lo) * N + i] = 0;
    for (int i = threadIdx.x; i < kPartCols * N; i += kThreads)
      a.px[((size_t)slot * n_pw + (size_t)blk * kPartCols) * N + i] = 0;
    for (int i = threadIdx.x; i < ru.n * N; i += kThreads)
      a.px[((size_t)slot * n_pw + (size_t)G * kPartCols + ru.lo) * N + i] = 0;
    for (int i = threadIdx.x; i < rx.n * N; i += kThreads)
      a.xx[((size_t)slot * nplp + rx.lo) * N + i] = 0;
  }
  s.first_sync = 1;
  cpa_wait<0>();
  __syncthreads();
  lap(s, K3S_STAGED);

  const int n_ref = ry.n + rv.n + ru.n + rx.n;
  for (int t = 0; t < a.n_steps; ++t) {
    // this step's noise on the x lane of this warp (x+ lane p = warp is
    // lane 0's), read at once and used last
    const T noise = lane == 0 && warp < rx.n ? a.noise[(size_t)t * nplp + rx.lo + warp] : T(0);
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
      const T r = static_cast<T>(dot32<AccState<T>, T, T>(xv, col, si, nplp, lane));
      if (lane == 0) {
        if (p < ry.n) {
          lo_s[p] = lo0[p] + r;   // +-inf padding absorbs the shift
          hi_s[p] = hi0[p] + r;
        } else if (p < ry.n + rv.n) {
          g_s[q] = g0[q] + r;
        } else if (p < ry.n + rv.n + ru.n) {
          kx_s[q] = r;
        } else {
          ax_s[q] = r;
        }
      }
    }
    lap(s, K2S_REFRESH);

    // 2. the warm solve, whole windows, the first one always
    LoopState st{k_idx, 0, ST_RUNNING, rhos[k_idx], 0.f, 0.f};
    run_solve(s, grid, st, a.tier, true, false, 0);
    k_idx = st.k_idx;
    if (st.status < 0) st.status = ST_MAXITER;

    // 3. u = y @ S_u - Kx came with the last window's partials (every block
    // holds all of it in uv); then x+ on this block's x lanes, published as
    // tagged words (step t's slot and tag)
    for (int p = threadIdx.x; p < ru.n; p += kThreads)
      a.us[(size_t)t * nup + ru.lo + p] = uv[ru.lo + p];
    uint64_t* const xw = a.xx + (size_t)(t & 1) * nplp * N;
    for (int p = warp; p < rx.n; p += kWarps) {
      const T d = static_cast<T>(dot32<AccState<T>, T, T>(uv, bd.col(p), bd.si, nup, lane));
      if (lane == 0) {
        const int i = rx.lo + p;
        const T xn = (ax_s[p] + d) + (p == warp ? noise : a.noise[(size_t)t * nplp + i]);
        put_tagged(xw + (size_t)i * N, xn, xtag(t));
        a.xs[(size_t)t * nplp + i] = xn;
      }
    }
    if (blk == 0 && threadIdx.x == 0) {
      float* out = a.stats + (size_t)t * 8;
      out[0] = (float)st.k;
      out[1] = st.pri;
      out[2] = st.dua;
      out[3] = st.rho;
      out[4] = (float)k_idx;
      out[5] = (float)st.status;
      out[6] = 0.f;
      out[7] = 0.f;
    }
    lap(s, K2S_PLANT);
    // every block reads all of x+ for the next step's refresh (xv's last
    // readers, the refresh and the bias, are behind a block barrier)
    if (t + 1 < a.n_steps)
      gather_tagged<T>(xw, nplp, xtag(t), [&](int i, T v) { xv[i] = v; });
    __syncthreads();
    lap(s, K2S_XEXCH);
    if (s.stamps && blk == 0 && threadIdx.x == 0) {
      ++s.stamps[K2S_STEPS];
      if (t == 0) s.stamps[K2S_SYNC_FIRST] = s.n_sync;
    }
  }
  for (int p = threadIdx.x; p < ry.n; p += kThreads) a.y_f[ry.lo + p] = ys[ry.lo + p];
  if (a.stamps) {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (blk == 0) a.stamps[K2S_SYNCS] = s.n_sync;
      atomicMax(a.stamps + K3S_END, gtimer());
    }
  }
}

__global__ void k2_stamp_kernel(unsigned long long* stamps) { stamps[K3S_PRE] = gtimer(); }

struct Plan {
  int nblocks, smem, resident;
};

template <typename T, typename WT>
cudaError_t make_plan(int dp, int nxp, int ncp, int nup, int nplp, int n_rho, Plan* plan) {
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
  const Layout L = make_layout<T, WT>(dp, nxp, ncp, nup, nplp, n_rho, nblocks);
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
  cudaError_t e = make_plan<T, WT>(p.dp, p.nxp, p.ncp, p.nup, p.nplp, p.n_rho, &plan);
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
  a.yx = static_cast<uint64_t*>(p.yx);
  a.px = static_cast<uint64_t*>(p.px);
  a.xx = static_cast<uint64_t*>(p.xx);
  a.stats = static_cast<float*>(p.stats);
  a.stamps = static_cast<unsigned long long*>(p.stamps);
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
int k2_plan(int dp, int nxp, int ncp, int nup, int nplp, int n_rho, int y_dtype, int w_dtype,
            int* nblocks, int* smem, int* resident) {
  Plan plan;
  const cudaError_t e = dispatch(y_dtype, w_dtype, [&](auto t, auto w) {
    return make_plan<decltype(t), decltype(w)>(dp, nxp, ncp, nup, nplp, n_rho, &plan);
  });
  if (e != cudaSuccess) return (int)e;
  *nblocks = plan.nblocks;
  *smem = plan.smem;
  *resident = plan.resident;
  return 0;
}

// The K3S_PRE stamp on `stream`, just before a stamped K2 launch.
int k2_stamp_now(void* stamps, void* stream) {
  k2_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(stamps));
  return (int)cudaGetLastError();
}

const char* k2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
