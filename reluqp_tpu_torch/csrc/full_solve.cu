// K3 on Hopper: one whole ReLU-QP solve in ONE launch.
//
// Replaces the TPU whole-solve kernel reluqp_tpu/ops/solve_kernel.py
// `_kernel` (launched through `full_solve`), the path of
// ReLU_QP(backend="fused") and of mpc_rollout_scan(kernel="fused"). From
// the start state y0 and rung rho0 it runs whole check windows of
// y <- clip(y @ W_k + b_k, lo, hi) while the solve is running and the
// budget holds one more (none when max_iter < check_interval), each
// followed by the one-matmul residual check, the rho walk and the exit at
// eps; then, if still running, the max_iter % check_interval tail window
// (residuals and exit only, the rung held). Options, all runtime flags:
//   * alpha != 1: lam = rho_vec * (p - z), A'lam = lam @ A_w, and on a rung
//     change the p re-encode p += (rho_old / rho_new - 1) * (p - z);
//   * OSQP infeasibility certificates on the deltas since the last check;
//   * two-phase refine: a reduced tier ("high", "bf16"; "default" is full
//     precision but still two-phase) until two consecutive windows improve
//     neither residual by 3% or half the budget is spent, then full
//     precision; stats[6] counts the reduced phase's iterations;
//   * verbose: one printf line per check, as the TPU kernel prints it;
//   * a state-affine bias b_k = c_k + x @ M_aff[k] (the warm MPC rollout).
// Every product is rounded to fp32, as the TPU kernel's fp32-result dots
// are, then cast to the state type (a no-op in fp32). Each dot is summed in
// fp64, every product and sum rounded on its own, in a fixed lane order
// (solve_loop.cuh, dot32) that the plain version full_solve_ref reproduces
// step for step, so the two agree bit for bit in fp32 runs too, where any
// other order would flip an fp32 rounding now and then and, over the
// hundreds of iterations of a cold solve, move a certification by a
// window. The residual maxima, rho and the tolerances are fp32 in an fp64
// run too.
//
// What bounds it on this card: per iteration one GEMV with the W rung
// (1.6 MB at Dp=640 fp32) and per check one with M_res, far below one
// flop per byte; held on chip, the limit is latency -- a chain of
// dependent GEMVs in which every lane needs every lane of the one before.
//
// Design: ONE cooperative launch per solve, one persistent block per SM,
// running the device solve loop shared with K2 (csrc/solve_loop.cuh, see
// its header for the work split and the cross-block decisions). Each block
// keeps its column slabs of the current W rung (reloaded on a rung change
// only; the TPU kernel's stream_bank mode does the same, so both of its
// modes are this one), of M_res, of M_aff (affine), of A_w (alpha) and of
// A_inf (certificates) in shared memory, transposed, or reads them from L2
// where they do not fit. Every contraction sums the whole column: there are
// no contraction tiles and so no remainder tile. Against the fixed cost of
// a short (warm) solve and the per-iteration cost of a long one:
//   * Staging: every element of the slabs and vectors is copied with
//     cp.async, each thread on one column (no division per element), all in
//     flight at once, in two groups -- the vectors and the start rung's W
//     and M_aff columns, which the first window waits for, then M_res, A_w
//     and A_inf, which land while its iterations run (a bf16 bank's 2-byte
//     elements go through registers, a batch of loads at a time).
//   * Products: a warp per column as before (the sum order full_solve_ref
//     reproduces), each batch of eight terms' fp64 products formed before
//     they are added in order, so the loads and conversions leave the sum's
//     dependent chain.
//   * Exchange: no grid barrier per iteration and none per check. Each
//     block stores its new y lanes (and at a check its partial maxima)
//     beside a tag in 64-bit words (two in fp64) and every block reads all
//     of them as soon as their tags show (solve_loop.cuh, gather_tagged):
//     one round trip to L2 where the barrier took two and the reload of y a
//     third. The launch's one grid barrier, before its first exchange,
//     follows the blocks' clearing of the words they write. Each block
//     reduces every block's partials itself, all loads in flight at once
//     (the earlier design had warp 0 walk the G rows in turn). The
//     products read an fp64 copy of y (fp32 runs): each factor of y is
//     converted once an iteration, not once a column.
//   * The selector products of the TPU kernel (y @ S_pz, y @ S_lam, and
//     the scatter corr @ S_sc) are lane reads and writes of the stacked
//     layout [x | z | p or lam], rounded to fp32 as the dots are; every
//     block computes lam and p - z whole from its own copy of y, so lam
//     needs no exchange before lam @ A_w, and neither does dlam before
//     dlam @ A_inf.
//   * The rung index and eps_abs are launch arguments (eps as eps_pri /
//     eps_dua); the start rung may instead be read from the device (the
//     previous solve's rung, with no host sync). The scalar state never
//     leaves the device inside a launch: stats come back in one (8,) row.
// A non-null `stamps` (never on a solve path) makes block 0 sum its time
// by stage (solve_loop.cuh K3S_*; ops/solve_kernel.k3_stage_split).
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Entries return a cudaError_t (0 on success), checked right after
// the launch: a cooperative launch that asks for more blocks than can be
// co-resident is otherwise refused silently.

#include "solve_loop.cuh"

// Launch parameters, mirrored field by field by _K3Params in
// reluqp_tpu_torch/ops/solve_kernel.py. Device pointers of distinct
// allocations (null where an option is off); matrices row-major.
struct K3Params {
  const void *wt, *b, *rhos, *m_res, *g_row, *lo, *hi, *y0, *a_w, *rho_eff, *a_inf, *inv_wp,
      *inv_wd, *l_nc, *u_nc, *fin_l, *fin_u, *g_dp, *m_aff, *x_row, *rho0_dev;
  void *y_out, *stats, *ybuf, *part, *stamps;
  int w_dtype, y_dtype, n_rho, dp, nx, nc, nxp, ncp, nplp;
  int max_iter, ci, rho0, adaptive, jump, stride, tier, two_phase, alpha, infeas, verbose,
      part_rows;
  float eps_pri, eps_dua, tol, rho_min, rho_max, eps_pinf, eps_dinf;
};

namespace {

template <typename T, typename WT>
struct K3Args {
  const WT* wt;
  const T *b, *m_res, *g_row, *lo, *hi, *y0, *a_w, *a_inf, *inv_wp, *inv_wd, *l_nc, *u_nc,
      *fin_l, *fin_u, *g_dp, *m_aff, *x_row;
  const float *rhos, *rho_eff;
  const int* rho0_dev;
  T* y_out;
  uint64_t *yx, *px;
  float* stats;
  unsigned long long* stamps;
  int n_rho, dp, nx, nc, nxp, ncp, nplp;
  int max_iter, ci, rho0, adaptive, jump, stride, tier, two_phase, alpha, infeas, verbose,
      resident;
  float eps_pri, eps_dua, tol, rho_min, rho_max, eps_pinf, eps_dinf;
};

// Per-block shared-memory layout (byte offsets), the same on the host
// (plan) and the device. Counts are the largest share of any block; an
// option that is off takes no room.
struct Layout {
  size_t ys, ysd, lo, hi, b, g, xv, rr, dec, cert, lam, d, yprev, dy, lamp, dlam;  // state
  size_t w, ma, mra, mrz, mrh, mrl, maw, mai;                                 // slabs
  size_t small_end, total;
};

template <typename T, typename WT>
__host__ __device__ Layout make_layout(int dp, int nxp, int ncp, int nplp, int alpha,
                                       int infeas, int nblocks) {
  const int my = ceil_div(dp, nblocks), mc = ceil_div(ncp, nblocks);
  const int mv = ceil_div(nxp, nblocks);
  const size_t t = sizeof(T);
  const bool lam = alpha || infeas;
  Layout L;
  size_t o = 0;
  auto put = [&o](size_t bytes) {
    const size_t at = o;
    o = align16(o + bytes);
    return at;
  };
  L.ys = put(dp * t);
  L.ysd = put(t == 8 ? 0 : dp * sizeof(double));  // y in fp64 (fp32 runs)
  L.lo = put(my * t);
  L.hi = put(my * t);
  L.b = put(my * t);
  L.g = put(mv * t);
  L.xv = put(nplp * t);
  L.rr = put((3 * mc + 4 * mv) * sizeof(float));
  L.dec = put(32);
  L.cert = put(32);
  L.lam = put(lam ? ncp * t : 0);
  L.d = put(lam ? ncp * t : 0);
  L.yprev = put(infeas ? dp * t : 0);
  L.dy = put(infeas ? dp * t : 0);
  L.lamp = put(infeas ? ncp * t : 0);
  L.dlam = put(infeas ? ncp * t : 0);
  L.small_end = o;
  L.w = put((size_t)my * dp * sizeof(WT));
  L.ma = put((size_t)my * nplp * t);
  L.mra = put((size_t)mc * dp * t);
  L.mrz = put((size_t)mc * dp * t);
  L.mrh = put((size_t)mv * dp * t);
  L.mrl = put(alpha ? 0 : (size_t)mv * dp * t);
  L.maw = put(alpha ? (size_t)mv * ncp * t : 0);
  L.mai = put(infeas ? (size_t)mv * ncp * t : 0);
  L.total = o;
  return L;
}

template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads) k3_kernel(const K3Args<T, WT> a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = gridDim.x, blk = blockIdx.x;
  const int dp = a.dp, nxp = a.nxp, ncp = a.ncp, nplp = a.nplp;
  const bool res = a.resident != 0;
  const Layout L = make_layout<T, WT>(dp, nxp, ncp, nplp, a.alpha, a.infeas, G);
  auto sm = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  const Range ry = split(dp, G, blk), rc = split(ncp, G, blk);
  const Range rv = split(nxp, G, blk);

  Loop<T, WT, AccF64> s{};
  s.stamps = a.stamps;
  if (a.stamps && threadIdx.x == 0) {
    s.mark = gtimer();
    atomicMin(a.stamps + K3S_START, s.mark);
  }
  s.dp = dp;
  s.nx = a.nx;
  s.nc = a.nc;
  s.ncp = ncp;
  s.nplp = nplp;
  s.n_rho = a.n_rho;
  s.ry = ry;
  s.rc = rc;
  s.rv = rv;
  s.ys = sm(L.ys);
  s.ysd = reinterpret_cast<double*>(smem + (sizeof(T) == 8 ? L.ys : L.ysd));
  s.lo_s = sm(L.lo);
  s.hi_s = sm(L.hi);
  s.b_s = sm(L.b);
  T* g_s = sm(L.g);
  s.g_s = g_s;
  s.rr = reinterpret_cast<float*>(smem + L.rr);
  s.dec = reinterpret_cast<Decision*>(smem + L.dec);
  s.cert = reinterpret_cast<CertScalars*>(smem + L.cert);
  T* xv = sm(L.xv);
  s.xv = a.m_aff ? xv : nullptr;
  s.w_slab = reinterpret_cast<WT*>(smem + L.w);
  s.ma_slab = sm(L.ma);
  s.wt = a.wt;
  s.bias_c = a.b;
  s.bias_ld = dp;
  s.bias_off = ry.lo;
  s.m_aff = a.m_aff;
  s.rhos = a.rhos;
  s.yx = a.yx;
  s.px = a.px;
  s.resident = res;
  s.limit = (a.max_iter / a.ci) * a.ci;
  s.ci = a.ci;
  s.adaptive = a.adaptive;
  s.jump = a.jump;
  s.stride = a.stride;
  s.eps_pri = a.eps_pri;
  s.eps_dua = a.eps_dua;
  s.tol = a.tol;
  s.rho_min = a.rho_min;
  s.rho_max = a.rho_max;
  s.alpha = a.alpha;
  s.infeas = a.infeas;
  s.verbose = a.verbose;
  s.reff = a.rho_eff;
  s.lam_s = sm(L.lam);
  s.d_s = sm(L.d);
  s.yprev_s = sm(L.yprev);
  s.dy_s = sm(L.dy);
  s.lamp_s = sm(L.lamp);
  s.dlam_s = sm(L.dlam);
  s.inv_wp = a.inv_wp;
  s.inv_wd = a.inv_wd;
  s.l_nc = a.l_nc;
  s.u_nc = a.u_nc;
  s.fin_l = a.fin_l;
  s.fin_u = a.fin_u;
  s.g_dp = a.g_dp;
  s.eps_pinf = a.eps_pinf;
  s.eps_dinf = a.eps_dinf;

  // Staging, every copy in flight at once (cp.async), in two groups: what
  // the first window's bias and iterations read (the vectors, then the
  // start rung's W and M_aff columns), then what its check reads (M_res,
  // A_w, A_inf), which lands while the first iterations run.
  stage_vec(s.ys, a.y0, dp);
  stage_vec(s.lo_s, a.lo + ry.lo, ry.n);
  stage_vec(s.hi_s, a.hi + ry.lo, ry.n);
  stage_vec(g_s, a.g_row + rv.lo, rv.n);
  if (a.m_aff) stage_vec(xv, a.x_row, nplp);
  int k0 = a.rho0_dev ? *a.rho0_dev : a.rho0;
  k0 = k0 < 0 ? 0 : (k0 >= a.n_rho ? a.n_rho - 1 : k0);
  s.wc = stage_cols(s.w_slab, a.wt + (size_t)k0 * dp * dp, dp, dp, ry.lo, ry.n, res);
  if (a.m_aff)
    s.mac = stage_cols(s.ma_slab, a.m_aff + (size_t)k0 * nplp * dp, nplp, dp, ry.lo, ry.n, res);
  s.resident_rung = k0;
  cpa_commit();
  const int R = 2 * ncp + (a.alpha ? nxp : 2 * nxp);
  s.mra = stage_cols(sm(L.mra), a.m_res, dp, R, rc.lo, rc.n, res);
  s.mrz = stage_cols(sm(L.mrz), a.m_res, dp, R, ncp + rc.lo, rc.n, res);
  s.mrh = stage_cols(sm(L.mrh), a.m_res, dp, R, 2 * ncp + rv.lo, rv.n, res);
  if (a.alpha)
    s.maw = stage_cols(sm(L.maw), a.a_w, ncp, nxp, rv.lo, rv.n, res);
  else
    s.mrl = stage_cols(sm(L.mrl), a.m_res, dp, R, 2 * ncp + nxp + rv.lo, rv.n, res);
  if (a.infeas) s.mai = stage_cols(sm(L.mai), a.a_inf, ncp, nxp, rv.lo, rv.n, res);
  cpa_commit();
  s.in_flight = 1;
  // The exchange's slots start at zero (no tag): each block clears the
  // words it writes; the launch's one grid barrier comes before the first
  // exchange reads any (check_window).
  constexpr int N = TagWords<T>::n;
  for (int slot = 0; slot < 2; ++slot) {
    for (int i = threadIdx.x; i < ry.n * N; i += kThreads)
      a.yx[((size_t)slot * dp + ry.lo) * N + i] = 0;
    for (int i = threadIdx.x; i < kPartCols * N; i += kThreads)
      a.px[((size_t)slot * G + blk) * kPartCols * N + i] = 0;
  }
  s.first_sync = 1;
  cpa_wait<1>();
  __syncthreads();
  if (sizeof(T) == 4)
    for (int i = threadIdx.x; i < dp; i += kThreads) s.ysd[i] = static_cast<double>(s.ys[i]);
  __syncthreads();
  if (a.infeas) {
    compute_lam(s, k0, s.lamp_s, static_cast<T*>(nullptr));
    for (int i = threadIdx.x; i < dp; i += kThreads) s.yprev_s[i] = s.ys[i];
    __syncthreads();
  }
  lap(s, K3S_STAGED);

  LoopState st{k0, 0, ST_RUNNING, a.rhos[k0], 0.f, 0.f};
  const int k_fast =
      run_solve(s, grid, st, a.tier, false, a.two_phase != 0, a.max_iter - s.limit);
  if (st.status < 0) st.status = ST_MAXITER;

  for (int p = threadIdx.x; p < ry.n; p += kThreads) a.y_out[ry.lo + p] = s.ys[ry.lo + p];
  if (blk == 0 && threadIdx.x == 0) {
    a.stats[0] = (float)st.k;
    a.stats[1] = st.pri;
    a.stats[2] = st.dua;
    a.stats[3] = st.rho;
    a.stats[4] = (float)st.k_idx;
    a.stats[5] = (float)st.status;
    a.stats[6] = (float)k_fast;
    a.stats[7] = 0.f;
  }
  if (a.stamps) {
    __syncthreads();
    if (threadIdx.x == 0) atomicMax(a.stamps + K3S_END, gtimer());
  }
}

__global__ void k3_stamp_kernel(unsigned long long* stamps) { stamps[K3S_PRE] = gtimer(); }

struct Plan {
  int nblocks, smem, resident;
};

template <typename T, typename WT>
cudaError_t make_plan(int dp, int nxp, int ncp, int nplp, int alpha, int infeas, Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int nsm = 0, smem_optin = 0, coop = 0;
  if ((e = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return e;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return e;
  if (!coop) return cudaErrorNotSupported;
  if (dp < 1 || nxp < 1 || ncp < 1 || nplp < 0) return cudaErrorInvalidValue;
  const int nblocks = nsm;
  const Layout L = make_layout<T, WT>(dp, nxp, ncp, nplp, alpha, infeas, nblocks);
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  if (L.small_end > budget) return cudaErrorInvalidValue;  // state too large
  const int resident = L.total <= budget;
  const size_t smem = resident ? L.total : L.small_end;
  auto fn = k3_kernel<T, WT>;
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
cudaError_t launch(const K3Params& p, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = make_plan<T, WT>(p.dp, p.nxp, p.ncp, p.nplp, p.alpha, p.infeas, &plan);
  if (e != cudaSuccess) return e;
  if (plan.nblocks > p.part_rows) return cudaErrorInvalidValue;
  K3Args<T, WT> a;
  a.wt = static_cast<const WT*>(p.wt);
  a.b = static_cast<const T*>(p.b);
  a.m_res = static_cast<const T*>(p.m_res);
  a.g_row = static_cast<const T*>(p.g_row);
  a.lo = static_cast<const T*>(p.lo);
  a.hi = static_cast<const T*>(p.hi);
  a.y0 = static_cast<const T*>(p.y0);
  a.a_w = static_cast<const T*>(p.a_w);
  a.a_inf = static_cast<const T*>(p.a_inf);
  a.inv_wp = static_cast<const T*>(p.inv_wp);
  a.inv_wd = static_cast<const T*>(p.inv_wd);
  a.l_nc = static_cast<const T*>(p.l_nc);
  a.u_nc = static_cast<const T*>(p.u_nc);
  a.fin_l = static_cast<const T*>(p.fin_l);
  a.fin_u = static_cast<const T*>(p.fin_u);
  a.g_dp = static_cast<const T*>(p.g_dp);
  a.m_aff = static_cast<const T*>(p.m_aff);
  a.x_row = static_cast<const T*>(p.x_row);
  a.rhos = static_cast<const float*>(p.rhos);
  a.rho_eff = static_cast<const float*>(p.rho_eff);
  a.rho0_dev = static_cast<const int*>(p.rho0_dev);
  a.y_out = static_cast<T*>(p.y_out);
  a.yx = static_cast<uint64_t*>(p.ybuf);
  a.stats = static_cast<float*>(p.stats);
  a.px = static_cast<uint64_t*>(p.part);
  a.stamps = static_cast<unsigned long long*>(p.stamps);
  a.n_rho = p.n_rho;
  a.dp = p.dp;
  a.nx = p.nx;
  a.nc = p.nc;
  a.nxp = p.nxp;
  a.ncp = p.ncp;
  a.nplp = p.m_aff ? p.nplp : 0;
  a.max_iter = p.max_iter;
  a.ci = p.ci;
  a.rho0 = p.rho0;
  a.adaptive = p.adaptive;
  a.jump = p.jump;
  a.stride = p.stride;
  a.tier = p.tier;
  a.two_phase = p.two_phase;
  a.alpha = p.alpha;
  a.infeas = p.infeas;
  a.verbose = p.verbose;
  a.resident = plan.resident;
  a.eps_pri = p.eps_pri;
  a.eps_dua = p.eps_dua;
  a.tol = p.tol;
  a.rho_min = p.rho_min;
  a.rho_max = p.rho_max;
  a.eps_pinf = p.eps_pinf;
  a.eps_dinf = p.eps_dinf;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(k3_kernel<T, WT>),
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
  if (y_dtype == DT_F64 && w_dtype == DT_BF16) return f(double(), __nv_bfloat16());
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Runs one solve; returns cudaError_t.
int k3_full_solve(const K3Params* p, void* stream) {
  if (p->ci < 1 || p->max_iter < 0 || p->tier < TIER_HIGHEST || p->tier > TIER_BF16 ||
      p->n_rho < 1 || p->nx + 2 * p->nc > p->dp || (p->alpha && !(p->a_w && p->rho_eff)) ||
      (p->infeas && !(p->a_inf && p->g_dp)) || (p->m_aff && !p->x_row))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)dispatch(p->y_dtype, p->w_dtype, [&](auto t, auto w) {
    return launch<decltype(t), decltype(w)>(*p, st);
  });
}

// The launch shape k3_full_solve would use, for reports.
int k3_plan(int dp, int nxp, int ncp, int nplp, int y_dtype, int w_dtype, int alpha,
            int infeas, int* nblocks, int* smem, int* resident) {
  Plan plan;
  const cudaError_t e = dispatch(y_dtype, w_dtype, [&](auto t, auto w) {
    return make_plan<decltype(t), decltype(w)>(dp, nxp, ncp, nplp, alpha, infeas, &plan);
  });
  if (e != cudaSuccess) return (int)e;
  *nblocks = plan.nblocks;
  *smem = plan.smem;
  *resident = plan.resident;
  return 0;
}

// The K3S_PRE stamp on `stream`, just before a stamped K3 launch.
int k3_stamp_now(void* stamps, void* stream) {
  k3_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(stamps));
  return (int)cudaGetLastError();
}

const char* k3_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
