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
// What bounds it on this card: an iteration does Bp*Dp*Dp multiply-adds on
// one Dp x Dp rung (26 M at Bp=64, Dp=640; the rung is 1.64 MB in fp32),
// far below the fp64 tensor cores' rate; but each output is an in-order
// chain of Dp/8 dependent tensor-core products, and every row depends on
// the whole previous iterate, so each iteration pays that chain's latency,
// an exchange and a barrier.
//
// Design:
//   * A thread-block cluster of C blocks (16 where the card schedules such
//     clusters, else 8, ...) owns a tile of `rb` scenario rows for the whole
//     rollout. Block c owns the output columns [c*cw, (c+1)*cw), cw = Dp/C,
//     of every iteration and keeps that column slab of the CURRENT rung in
//     shared memory, transposed (csrc/cluster_slab.cuh, as K4 does), across
//     iterations, windows and control steps: it reloads the slab only when
//     the ensemble's rung decision changes the rung. Where no slab fits
//     beside the rows (large Dp in fp64, large row tiles) the slab is read
//     from L2 every iteration, a few entries of a column ahead of their use.
//   * Every block holds the tile's whole rows of y, in fp64 (an fp32 state
//     is exact in fp64, and the fp64 products then need no conversion of
//     y), double buffered, chunk by chunk (the rows of one 16-byte chunk of
//     the rung's inputs side by side, so a thread reads its rows at fixed
//     offsets). An iteration computes the block's (rb, cw) piece, stores it
//     16 bytes at a time into every block of the cluster
//     and ends with one cluster barrier. Everything else is split by
//     columns: the block holds its columns' b, lo, hi, its constraint and
//     variable lanes' residual products (the Ax and z columns of the same
//     constraint lanes, the Hx and A'lam columns and the g entries of the
//     same variable lanes), Kx and u of its u columns, Ax of its plant
//     columns. x and u are held whole (they are the inputs of the next
//     products), as pushed into every block.
//   * Products sum over the inputs IN ORDER, in fp64: the order of the
//     row-owning design this replaces, so the two agree bit for bit, and
//     the order in which cuBLAS sums the plain version's fp64 products at
//     the widths measured (Dp <= 640 on the H100), so that there kernel and
//     plain version round the same sums. Every product runs on the fp64
//     tensor cores: a warp takes tiles of 16 rows (a row tile is 5, 10 or
//     15 rows; rows past the last scenario read as 0) and 8 columns and
//     chains mma.m16n8k8 over the inputs, which on the H100 rounds exactly
//     as a chain of fp64 fused multiply-adds (each product of fp32 values is
//     exact in fp64). In the iteration a lane then holds two neighbouring
//     columns of a row and stores them 16 bytes at a time into the peers;
//     the other products read their operands from L2, a few steps ahead,
//     and run each tile's chain only over the 8-input steps that hold its
//     columns' nonzeros (K6Params' *_steps, made once with the operands):
//     the residual operator's columns read a quarter of y or less, u's one
//     entry, so a dense chain would mostly multiply zeros.
//   * A row's residual maxima and the pieces of its rho estimate are
//     combined across the cluster through distributed shared memory: each
//     block stores its (pri, scale_p, dua, scale_d) per row into slot c of
//     every block, one cluster barrier, then every block takes the maxima
//     over the slots in block order. So every block of the cluster holds
//     identical per-row state (rho, pri, dua, done, status).
//   * Cross-tile decisions: block 0 of each cluster writes, per row,
//     [log rho_new (0 when done), open, done after the window, pri, dua,
//     status] into a (2, Bp, 6) fp64 exchange array (double buffered by
//     window parity); after ONE grid-wide barrier per check window every
//     block copies the whole array to shared memory and one thread sums the
//     logs in fp64 in ROW ORDER (which full_rollout_batched_ref reproduces),
//     counts the open and done rows, and decides the rung and whether
//     another window runs. Every block reads the same values in the same
//     order, so every block takes the same branch around every barrier.
//     The launch is cooperative and clustered at once (cudaLaunchKernelEx
//     with both attributes); the plan puts every cluster in one wave.
//   * Block 0 writes the step's stats row from the last window's exchange
//     values: [iterations, max pri, max dua, real rows, rung, min status,
//     unsolved rows, 0]; and counts its slab loads into `loads`.
//   * A non-null `stamps` (never on a rollout path) makes block 0 sum its
//     %globaltimer time by stage into K2's slots (solve_loop.cuh K3S_* and
//     K2S_*; ops/solve_kernel.k6_stage_split): the staging (the prologue
//     and every slab reload), per step the refresh, each window's bias, the
//     iterations' products and their cluster barriers (the exchange), the
//     checks' products and row maxima, their reduction (the cluster
//     barrier, the rows' combination, the grid barrier and the ensemble's
//     decision), the plant step (the stats row, u and x+) and the last
//     cluster barrier (the exchange of x+); and count its steps and grid
//     barriers. That launch runs the kernel's STAMPS instantiation; every
//     other runs the one without stamps, whose code has none of it.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Entries return a cudaError_t (0 on success), checked right after
// the launch.

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "cluster_slab.cuh"
#include "solve_loop.cuh"

// Launch parameters, mirrored field by field by _K6Params in
// reluqp_tpu_torch/ops/solve_kernel.py. Device pointers of distinct
// allocations; matrices row-major.
struct K6Params {
  const void *wt, *bias_c, *m_aff, *rhos, *m_res, *g0w, *gl, *lo0, *hi0, *s_u, *bdw, *y0,
      *x0, *pad, *noise;
  // per column of gl, m_aff (the union over rungs), m_res, s_u and bdw: the
  // int32 pair [lo, hi) of 8-input steps that holds its nonzeros (lo >= hi:
  // none)
  const void *gl_steps, *m_aff_steps, *m_res_steps, *s_u_steps, *bdw_steps;
  void *xs, *us, *stats, *y_f, *exch, *loads, *stamps;
  int w_dtype, y_dtype, n_rho, dp, nxp, ncp, nup, nplp, bp;
  int n_steps, max_iter, ci, rho0, adaptive, jump, stride, tier;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
};

namespace {

// Threads per block (8 warps): enough for the block's tiles of the iteration
// (5 at B=64, Dp=640) and the (column, row group) pairs of its other
// products, and few enough that a thread may hold 255 registers (none
// spill).
constexpr int kBlockThreads = 256;
// Rows per tile: 5, 10 or 15 (B=64 takes 10, so that its 7 tiles fit the
// card's 7 clusters of 16 blocks).
constexpr int kRowGroup = 5;
constexpr int kMaxRows = 3 * kRowGroup;
// Widths (Dp, nup, nplp) are multiples of this: whole 8-input steps of the
// tensor-core products, whole 16-byte groups of every element type.
constexpr int kWidthStep = 16;
// fp64 values per row of the exchange array.
constexpr int kExCols = 6;
// Steps of 8 inputs whose rung entries (iteration, slab in L2) and operand
// entries (the other products) a lane reads ahead of their use.
constexpr int kAhead = 4;
constexpr int kAheadP = 8;
// 16x8 output tiles a warp runs at once in the iteration.
constexpr int kTilesPerWarp = 2;
// Cluster sizes tried, largest first (16 is beyond the portable 8).
constexpr int kClusters[] = {16, 8, 4, 2, 1};

// y (fp64, rb rows) is held in chunks of kYChunk inputs: entry (r, i) at
// ((i / kYChunk) * rb + r) * kYChunk + i % kYChunk, so the rows of a chunk
// are neighbours.
constexpr int kYChunk = 4;

__device__ __forceinline__ int yidx(int rb, int r, int i) {
  return ((i / kYChunk) * rb + r) * kYChunk + i % kYChunk;
}

// The launch shape (k6_plan): `nblocks` = cluster * tiles blocks of
// `threads`; block c of a cluster owns columns [c*cw, (c+1)*cw) of y for a
// tile of rb rows; `w_smem`: the slab is held in shared memory.
struct Plan {
  int nblocks, threads, cluster, cw, rb, tiles, smem, w_smem, max_clusters;
};

// Per-block shared-memory layout (byte offsets), made on the host for the
// plan. The scratch region holds the residual products of the block's lanes
// (rr), the per-row maxima from every block of the cluster (rmax), the
// control rows u (pushed by the peers after the last window) and the copy
// of the exchange array (red), which overlaps rr and rmax but never u.
struct Layout {
  size_t ya, yb, b, lo, hi, x, g, kx, ax, rho, pri, dua, st, done, dec;
  size_t rr, rmax, u, red, slab, total;
};

// Block `rank` of a cluster of C: its shares of the lane spaces (y columns
// [c0, c0 + cw), constraint lanes cl, variable lanes vl, u columns uc,
// plant columns xc) and the operand column that local column lc of each
// once-a-step product reads. k6_kernel's products and k6_chain_steps' count
// both take their columns from here.
struct K6Cols {
  int dp, nxp, ncp, nup, c0, cw;
  Range cl, vl, uc, xc;
  __host__ __device__ K6Cols(int dp_, int nxp_, int ncp_, int nup_, int nplp, int C, int cw_,
                             int rank)
      : dp(dp_), nxp(nxp_), ncp(ncp_), nup(nup_), c0(rank * cw_), cw(cw_),
        cl(split(ncp_, C, rank)), vl(split(nxp_, C, rank)), uc(split(nup_, C, rank)),
        xc(split(nplp, C, rank)) {}
  // refresh, x @ GL: [g of the variable lanes | lo, hi shift of the y
  // columns | Kx of the u columns | Ax of the plant columns]
  __host__ __device__ int n_gl() const { return vl.n + cw + uc.n + xc.n; }
  __host__ __device__ int gl(int lc) const {
    const int ng = vl.n, ns = ng + cw, nk = ns + uc.n;
    return lc < ng   ? vl.lo + lc
           : lc < ns ? nxp + c0 + (lc - ng)
           : lc < nk ? nxp + dp + uc.lo + (lc - ns)
                     : nxp + dp + nup + xc.lo + (lc - nk);
  }
  // bias, x @ M_aff[k]: the y columns
  __host__ __device__ int m_aff(int lc) const { return c0 + lc; }
  // check, y @ M_res: [Ax | z] of the constraint lanes, [Hx | A'lam] of the
  // variable lanes
  __host__ __device__ int n_res() const { return 2 * cl.n + 2 * vl.n; }
  __host__ __device__ int m_res(int lc) const {
    return lc < cl.n          ? cl.lo + lc
           : lc < 2 * cl.n    ? ncp + cl.lo + (lc - cl.n)
           : lc < 2 * cl.n + vl.n ? 2 * ncp + vl.lo + (lc - 2 * cl.n)
                                  : 2 * ncp + nxp + vl.lo + (lc - 2 * cl.n - vl.n);
  }
  // u, y @ S_u, and x+, u @ Bdw: the u and plant columns
  __host__ __device__ int s_u(int lc) const { return uc.lo + lc; }
  __host__ __device__ int bdw(int lc) const { return xc.lo + lc; }
};

template <typename T>
struct Args {
  const void* wt;
  const T *bias_c, *m_aff, *m_res, *g0w, *gl, *lo0, *hi0, *s_u, *bdw, *y0, *x0, *noise;
  const float *rhos, *pad;
  const int2 *gl_steps, *m_aff_steps, *m_res_steps, *s_u_steps, *bdw_steps;
  T *xs, *us, *y_f;
  float* stats;
  double* exch;
  int* loads;
  int n_rho, dp, nxp, ncp, nup, nplp, bp;
  int n_steps, limit, ci, rho0, adaptive, jump, stride, tier;
  float eps_pri, eps_dua, tol, rho_min, rho_max;
  Plan p;
  Layout L;   // make_layout's, for this plan
  unsigned long long* stamps;   // the STAMPS instantiation's only
};

template <typename T, typename WT>
Layout make_layout(const Plan& p, int dp, int nxp, int ncp, int nup, int nplp, int bp) {
  const size_t t = sizeof(T);
  const int C = p.cluster, rb = p.rb, cw = p.cw;
  const int ncl = ceil_div(ncp, C), nvl = ceil_div(nxp, C);
  const int nuw = ceil_div(nup, C), nxw = ceil_div(nplp, C);
  Layout L;
  size_t o = 0;
  auto put = [&o](size_t bytes) {
    const size_t at = o;
    o = align16(o + bytes);
    return at;
  };
  L.ya = put((size_t)rb * dp * sizeof(double));
  L.yb = put((size_t)rb * dp * sizeof(double));
  L.b = put((size_t)rb * cw * t);
  L.lo = put((size_t)rb * cw * t);
  L.hi = put((size_t)rb * cw * t);
  L.x = put((size_t)rb * nplp * t);
  L.g = put((size_t)rb * nvl * t);
  L.kx = put((size_t)rb * nuw * t);
  L.ax = put((size_t)rb * nxw * t);
  L.rho = put(kMaxRows * sizeof(float));
  L.pri = put(kMaxRows * sizeof(float));
  L.dua = put(kMaxRows * sizeof(float));
  L.st = put(kMaxRows * sizeof(float));
  L.done = put(kMaxRows * sizeof(int));
  L.dec = put(4 * sizeof(int));
  const size_t s = o;
  L.rr = s;
  L.rmax = align16(L.rr + (size_t)rb * (2 * ncl + 2 * nvl) * sizeof(float));
  L.u = align16(L.rmax + (size_t)C * rb * 4 * sizeof(float));
  const size_t end_u = align16(L.u + (size_t)rb * nup * t);
  const size_t red = (size_t)bp * 3 * sizeof(double);
  L.red = s + red <= L.u ? s : end_u;
  o = std::max(end_u, align16(L.red + red));
  L.slab = o;
  if (p.w_smem) o = align16(o + (size_t)cw * slab_stride<WT>(dp) * sizeof(WT));
  L.total = o;
  return L;
}

// Rows of a product's left operand in shared memory: `at(r, i)` is entry
// (r, i). Row-major rows (x, u): entry (r, i) at v[r * ld + i].
template <typename VT>
struct RowMajor {
  const VT* v;
  int ld;
  __device__ __forceinline__ const VT* at(int r, int i) const { return v + (size_t)r * ld + i; }
};
// y, chunk by chunk (see yidx).
struct Chunked {
  const double* v;
  int rb;
  __device__ __forceinline__ const double* at(int r, int i) const { return v + yidx(rb, r, i); }
};

// One fp64 tensor-core product (mma.m16n8k8) of a warp: c += A (16x8) *
// B (8x8) at this lane's fragments (g = lane/4, t = lane%4):
// a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g], B[t+4][g];
// c = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]. Each output takes its
// 8 products in k order, one rounding each, as a chain of fp64 fused
// multiply-adds does (held bit for bit on the H100 at K = 16 ... 1280).
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[4], const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// The block's rows [0, nr) of `rows` (VT = the state type or fp64) times n
// columns of a row-major operand m (global memory, row stride ld) over k
// inputs (a multiple of 8): emit(r, lc, p) gets row r's product with column
// col(lc) of m, summed in fp64 over the inputs in order (chains of fp64
// tensor-core products, as in the iteration) and rounded to fp32. A warp
// takes tiles of 16 rows and 8 columns; a lane's operand entries for the
// next kAheadP steps are in flight before their use. No barrier inside.
// A tile's chain runs only over the 8-input steps [lo, hi) that hold its
// columns' nonzeros (steps[col]: the union over the tile's 8 columns): every
// product outside it is an exact zero, and adding an exact zero leaves a
// finite fp64 sum as it was (a sum that starts at +0 never reaches -0), so
// the outputs are the dense chain's bit for bit where the rows are finite.
// A tile whose columns are all zero emits 0.
template <typename VT, typename MT, typename Rows, typename Col, typename Emit>
__device__ void piece_product(const Rows& rows, int nr, const MT* m, int ld, int k, int n,
                              const int2* steps, Col&& col, Emit&& emit) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt = ceil_div(n, 8), ntiles = ceil_div(nr, 16) * nt;
  for (int tile = warp; tile < ntiles; tile += nwarps) {
    const int r0 = (tile / nt) * 16, c0 = (tile % nt) * 8;
    // the lane's column of m (B's column g; a column past n reads column
    // c0, and its outputs are not emitted) and rows (A's rows g, g + 8; a
    // row past nr reads as 0)
    const int cm = col(c0 + g < n ? c0 + g : c0);
    const MT* mc = m + cm;
    const int ra = r0 + g, rb8 = r0 + g + 8;
    const bool ina = ra < nr, inb = rb8 < nr;
    // the tile's steps: the union of its columns' (warp-uniform)
    const int2 sc = __ldg(steps + cm);
    int lo = sc.x < sc.y ? sc.x : k / 8, hi = sc.x < sc.y ? sc.y : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    const int kend = 8 * hi;
    double c[4] = {0.0, 0.0, 0.0, 0.0};
    for (int k0 = 8 * lo; k0 < kend; k0 += 8 * kAheadP) {
      double bv[kAheadP][2];
#pragma unroll
      for (int u = 0; u < kAheadP; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = k0 + 8 * u + t + 4 * h;
          bv[u][h] = kk < kend ? static_cast<double>(cvt<VT>(mc[(size_t)kk * ld])) : 0.0;
        }
#pragma unroll
      for (int u = 0; u < kAheadP; ++u) {
        if (k0 + 8 * u < kend) {
          const int kk = k0 + 8 * u + t;
          const double av[4] = {ina ? static_cast<double>(*rows.at(ra, kk)) : 0.0,
                                inb ? static_cast<double>(*rows.at(rb8, kk)) : 0.0,
                                ina ? static_cast<double>(*rows.at(ra, kk + 4)) : 0.0,
                                inb ? static_cast<double>(*rows.at(rb8, kk + 4)) : 0.0};
          dmma(c, av, bv[u]);
        }
      }
    }
    // c = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + g + 8 * (i >> 1), lc = c0 + 2 * t + (i & 1);
      if (r < nr && lc < n) emit(r, lc, static_cast<float>(c[i]));
    }
  }
}

// The iteration tier's products of the y fragment a and the rung fragment
// w, into the tier's sums c[0..2]: "highest" the plain products; "high" the
// three bf16-split products (each exact in fp64), kept apart; "bf16" the
// products of the bf16-rounded factors -- as `mac` does for one
// multiply-add.
template <int TIER, typename WT>
__device__ __forceinline__ void dmma_tier(double (&c)[3][4], const double (&a)[4],
                                          const WT (&w)[2]) {
  if (TIER == TIER_HIGHEST) {
    const double b[2] = {cvt<double>(w[0]), cvt<double>(w[1])};
    dmma(c[0], a, b);
  } else if (TIER == TIER_HIGH) {
    double ah[4], al[4], bh[2], bl[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = to_f(a[i]);
      ah[i] = bf16r(v);
      al[i] = bf16r(v - static_cast<float>(ah[i]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = to_f(w[i]);
      bh[i] = bf16r(v);
      bl[i] = bf16r(v - static_cast<float>(bh[i]));
    }
    dmma(c[0], ah, bl);
    dmma(c[1], al, bh);
    dmma(c[2], ah, bh);
  } else {
    double ar[4], br[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) ar[i] = bf16r(to_f(a[i]));
#pragma unroll
    for (int i = 0; i < 2; ++i) br[i] = bf16r(to_f(w[i]));
    dmma(c[0], ar, br);
  }
}

// The stage that ends here into stamps[slot] (block 0, after a block
// barrier so that its slowest warp is counted; `mark` is its last stage
// boundary); no code without STAMPS.
template <bool STAMPS>
__device__ __forceinline__ void lap(unsigned long long* stamps, unsigned long long& mark,
                                    int slot) {
  if constexpr (STAMPS) {
    __syncthreads();
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      const unsigned long long now = gtimer();
      stamps[slot] += now - mark;
      mark = now;
    }
  }
}

// ci iterations of the tile. The block's (nr, cw) piece is cut into tiles
// of 16 rows (rows past nr read as 0) and 8 columns; a warp takes up to
// kTilesPerWarp of them and runs each as a chain of fp64 tensor-core
// products over the Dp inputs, 8 at a time, in order (the sums of the
// row-owning design this replaces, bit for bit, and those of cuBLAS's fp64
// product in the plain version at the widths measured), from the tile's
// rows of cur (fp64, chunk by chunk) and the slab ws (transposed in shared
// memory, column stride wst; or the rung's columns in global memory, row
// stride dp). Then each lane rounds its outputs (two neighbouring columns
// of two rows), adds b, clips, and stores each row's pair 16 bytes at a
// time into the next buffer of every block of the cluster. One cluster
// barrier per iteration.
template <typename T, typename WT, int TIER, bool WSMEM, bool STAMPS>
__device__ void iterate(const Args<T>& a, cg::cluster_group& cluster, const WT* ws, int wst,
                        double*& cur, double*& nxt, const T* b, const T* lo, const T* hi,
                        int nr, unsigned long long& mark) {
  constexpr int TPW = kTilesPerWarp;
  const int dp = a.dp, cw = a.p.cw, rb = a.p.rb;
  const int c0 = (int)cluster.block_rank() * cw;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt = cw / 8, ntiles = ceil_div(nr, 16) * nt;
  // y's fragment entries for the lane's rows r, r + 8 (row 0 past nr,
  // read as 0) at inputs t and t + 4: their offsets in cur; each step of 8
  // inputs moves every entry 8 * rb further (chunk by chunk layout)
  auto yoffs = [&](int (&off)[4], bool (&in)[4], int r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = r + 8 * (i & 1);
      in[i] = rr < nr;
      off[i] = yidx(rb, in[i] ? rr : 0, t + 4 * (i >> 1));
    }
  };
  const int ystep = 8 * rb;
  for (int it = 0; it < a.ci; ++it) {
    for (int t0 = warp; t0 < ntiles; t0 += nwarps * TPW) {
      double c[TPW][3][4];
      int row[TPW], col[TPW], off[TPW][4];
      bool has[TPW], in[TPW][4];
#pragma unroll
      for (int s = 0; s < TPW; ++s) {
        const int tile = t0 + s * nwarps;
        has[s] = tile < ntiles;
        row[s] = (has[s] ? tile / nt : 0) * 16 + g;   // the lane's first row
        col[s] = (has[s] ? tile % nt : 0) * 8;        // the tile's first column
        yoffs(off[s], in[s], row[s]);
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[s][q][i] = 0.0;
      }
      // the fragment of y for the step at inputs [k0, k0 + 8)
      auto yfrag = [&](double (&av)[4], int s, int k0) {
        const double* yk = cur + (size_t)(k0 / 8) * ystep;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const double v = yk[off[s][i]];
          av[i] = in[s][i] ? v : 0.0;
        }
      };
      if (WSMEM) {
        const WT* wc[TPW];
#pragma unroll
        for (int s = 0; s < TPW; ++s) wc[s] = ws + (size_t)(col[s] + g) * wst + t;
#pragma unroll 2
        for (int k0 = 0; k0 < dp; k0 += 8) {
#pragma unroll
          for (int s = 0; s < TPW; ++s) {
            if (has[s]) {
              double av[4];
              yfrag(av, s, k0);
              const WT wv[2] = {wc[s][k0], wc[s][k0 + 4]};
              dmma_tier<TIER>(c[s], av, wv);
            }
          }
        }
      } else {
        // from L2: the lane's rung entries for the next kAhead steps in
        // flight before their use
        for (int k0 = t; k0 < dp; k0 += 8 * kAhead) {
          WT wv[TPW][kAhead][2];
#pragma unroll
          for (int s = 0; s < TPW; ++s)
#pragma unroll
            for (int u = 0; u < kAhead; ++u)
#pragma unroll
              for (int h = 0; h < 2; ++h)
                if (has[s] && k0 + 8 * u < dp)
                  wv[s][u][h] = ws[(size_t)(k0 + 8 * u + 4 * h) * wst + col[s] + g];
#pragma unroll
          for (int u = 0; u < kAhead; ++u) {
            if (k0 + 8 * u < dp) {
#pragma unroll
              for (int s = 0; s < TPW; ++s) {
                if (has[s]) {
                  double av[4];
                  yfrag(av, s, k0 - t + 8 * u);
                  dmma_tier<TIER>(c[s], av, wv[s][u]);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int s = 0; s < TPW; ++s) {
        if (!has[s]) continue;
        const int j = col[s] + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row[s] + 8 * h;
          if (r >= nr) continue;
          double out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * h + e;
            const float p = TIER == TIER_HIGH ? (static_cast<float>(c[s][0][i]) +
                                                 static_cast<float>(c[s][1][i])) +
                                                    static_cast<float>(c[s][2][i])
                                              : static_cast<float>(c[s][0][i]);
            const size_t o = (size_t)r * cw + j + e;
            T v = static_cast<T>(p) + b[o];
            // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
            v = v < lo[o] ? lo[o] : v;
            v = v > hi[o] ? hi[o] : v;
            out[e] = static_cast<double>(v);
          }
          push16(cluster, nxt, yidx(rb, r, c0 + j), out);
        }
      }
    }
    lap<STAMPS>(a.stamps, mark, K3S_ITER);
    // every piece has landed everywhere, and every read of cur is done,
    // before the next iteration
    cluster.sync();
    lap<STAMPS>(a.stamps, mark, K3S_EXCH);
    double* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T, typename WT, bool WSMEM, bool STAMPS>
__global__ void __launch_bounds__(kBlockThreads, 1) k6_kernel(const Args<T> a) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int dp = a.dp, nxp = a.nxp, ncp = a.ncp, nup = a.nup, nplp = a.nplp, bp = a.bp;
  const int R = 2 * ncp + 2 * nxp, R2 = nxp + dp + nup + nplp;
  const int C = a.p.cluster, cw = a.p.cw;
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / C;
  const Layout& L = a.L;
  auto sm = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  double* cur = reinterpret_cast<double*>(smem + L.ya);
  double* nxt = reinterpret_cast<double*>(smem + L.yb);
  T *b = sm(L.b), *lo = sm(L.lo), *hi = sm(L.hi), *xr = sm(L.x), *ur = sm(L.u);
  T *gp = sm(L.g), *kxp = sm(L.kx), *axp = sm(L.ax);
  float* rr = reinterpret_cast<float*>(smem + L.rr);
  float* rmax = reinterpret_cast<float*>(smem + L.rmax);
  double* red = reinterpret_cast<double*>(smem + L.red);
  float* rho_s = reinterpret_cast<float*>(smem + L.rho);
  float* pri_s = reinterpret_cast<float*>(smem + L.pri);
  float* dua_s = reinterpret_cast<float*>(smem + L.dua);
  float* st_s = reinterpret_cast<float*>(smem + L.st);
  int* done_s = reinterpret_cast<int*>(smem + L.done);
  int* dec = reinterpret_cast<int*>(smem + L.dec);
  WT* slab = reinterpret_cast<WT*>(smem + L.slab);
  const WT* wt = static_cast<const WT*>(a.wt);
  const RowMajor<T> xrows{xr, nplp};

  // the block's shares of the lane spaces and its products' columns
  const K6Cols cols(dp, nxp, ncp, nup, nplp, C, cw, rank);
  const int c0 = cols.c0;
  const Range cl = cols.cl, vl = cols.vl, uc = cols.uc, xc = cols.xc;
  const int nvl_max = ceil_div(nxp, C), nuw = ceil_div(nup, C), nxw = ceil_div(nplp, C);
  const int nres = cols.n_res();
  const int nres_ld = 2 * ceil_div(ncp, C) + 2 * nvl_max;

  // block 0's last stage boundary and grid barriers (stamps only)
  unsigned long long mark = 0;
  int n_sync = 0;
  if constexpr (STAMPS) {
    if (threadIdx.x == 0) {
      mark = gtimer();
      atomicMin(a.stamps + K3S_START, mark);
    }
  }
  const int r0 = tile * a.p.rb;
  const int nr = min(a.p.rb, bp - r0);
  for (int i = threadIdx.x; i < nr * dp; i += blockDim.x)
    cur[yidx(a.p.rb, i / dp, i % dp)] = static_cast<double>(a.y0[(size_t)r0 * dp + i]);
  for (int i = threadIdx.x; i < nr * nplp; i += blockDim.x) xr[i] = a.x0[(size_t)r0 * nplp + i];
  int k_idx = a.rho0 < 0 ? 0 : (a.rho0 >= a.n_rho ? a.n_rho - 1 : a.rho0);
  int k_loaded = -1, n_loads = 0;
  int par = 0;
  const WT* ws = wt + (size_t)k_idx * dp * dp + c0;
  const int wst = WSMEM ? slab_stride<WT>(dp) : dp;
  // every block of the cluster has started before any block stores into
  // another's shared memory
  cluster.sync();
  lap<STAMPS>(a.stamps, mark, K3S_STAGED);

  for (int t = 0; t < a.n_steps; ++t) {
    // 1. refresh: the block's columns of x @ GL
    const int ng_ = vl.n, ns_ = ng_ + cw, nk_ = ns_ + uc.n;
    piece_product<T>(xrows, nr, a.gl, R2, nplp, cols.n_gl(), a.gl_steps,
                  [&](int lc) { return cols.gl(lc); },
                  [&](int r, int lc, float p) {
                    const T v = static_cast<T>(p);
                    if (lc < ng_) {
                      gp[r * nvl_max + lc] = a.g0w[vl.lo + lc] + v;
                    } else if (lc < ns_) {
                      const int j = lc - ng_;
                      lo[r * cw + j] = a.lo0[c0 + j] + v;  // +-inf padding absorbs the shift
                      hi[r * cw + j] = a.hi0[c0 + j] + v;
                    } else if (lc < nk_) {
                      kxp[r * nuw + lc - ns_] = v;
                    } else {
                      axp[r * nxw + lc - nk_] = v;
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
    lap<STAMPS>(a.stamps, mark, K2S_REFRESH);

    // 2. the warm solve, whole windows, the first one always
    int k = 0;
    for (;;) {
      if (k_idx != k_loaded) {
        // the rung changed (or the first window): the block's slab of it
        ws = wt + (size_t)k_idx * dp * dp + c0;
        if (WSMEM) {
          load_slab(slab, ws, dp, cw);
          ws = slab;
          ++n_loads;
        }
        k_loaded = k_idx;
        lap<STAMPS>(a.stamps, mark, K3S_STAGED);
      }
      const T* bc = a.bias_c + (size_t)k_idx * dp + c0;
      piece_product<T>(xrows, nr, a.m_aff + (size_t)k_idx * nplp * dp, dp, nplp, cw,
                    a.m_aff_steps,
                    [&](int lc) { return cols.m_aff(lc); },
                    [&](int r, int lc, float p) { b[r * cw + lc] = bc[lc] + static_cast<T>(p); });
      __syncthreads();
      lap<STAMPS>(a.stamps, mark, K3S_BIAS);
      if (a.tier == TIER_HIGHEST)
        iterate<T, WT, TIER_HIGHEST, WSMEM, STAMPS>(a, cluster, ws, wst, cur, nxt, b, lo, hi,
                                                    nr, mark);
      else if (a.tier == TIER_HIGH)
        iterate<T, WT, TIER_HIGH, WSMEM, STAMPS>(a, cluster, ws, wst, cur, nxt, b, lo, hi,
                                                 nr, mark);
      else
        iterate<T, WT, TIER_BF16, WSMEM, STAMPS>(a, cluster, ws, wst, cur, nxt, b, lo, hi,
                                                 nr, mark);

      // the residual products of the block's lanes: [Ax | z] of its
      // constraint lanes, [Hx | A'lam] of its variable lanes
      piece_product<double>(Chunked{cur, a.p.rb}, nr, a.m_res, R, dp, nres, a.m_res_steps,
                    [&](int lc) { return cols.m_res(lc); },
                    [&](int r, int lc, float p) { rr[r * nres_ld + lc] = p; });
      __syncthreads();
      // the rows' maxima over the block's lanes (warp w, rows w, w + nwarps,
      // ...), stored into slot `rank` of every block of the cluster
      for (int r = warp; r < nr; r += nwarps) {
        const float* q = rr + (size_t)r * nres_ld;
        float pri = 0.f, sp = 0.f, dua = 0.f, sd = 0.f;
        for (int i = lane; i < cl.n; i += 32) {
          const float axv = q[i], z = q[cl.n + i];
          pri = nmax(pri, fabsf(axv - z));
          sp = nmax(sp, nmax(fabsf(axv), fabsf(z)));
        }
        for (int i = lane; i < vl.n; i += 32) {
          const float hx = q[2 * cl.n + i], atl = q[2 * cl.n + vl.n + i];
          const float g32 = static_cast<float>(gp[r * nvl_max + i]);
          dua = nmax(dua, fabsf((hx + atl) + g32));
          sd = nmax(sd, nmax(nmax(fabsf(hx), fabsf(atl)), fabsf(g32)));
        }
        pri = warp_max(pri);
        sp = warp_max(sp);
        dua = warp_max(dua);
        sd = warp_max(sd);
        if (lane == 0) {
          const float v[4] = {pri, sp, dua, sd};
          push16(cluster, rmax, ((size_t)rank * a.p.rb + r) * 4, v);
        }
      }
      lap<STAMPS>(a.stamps, mark, K3S_CHECK);
      cluster.sync();

      // every block of the cluster: the rows' maxima over the slots in
      // block order, their rho estimates and done flags (identical in
      // every block); block 0 of the cluster writes them for the tile
      if (threadIdx.x < nr) {
        const int r = threadIdx.x;
        float pri = 0.f, sp = 0.f, dua = 0.f, sd = 0.f;
        for (int q = 0; q < C; ++q) {
          const float* v = rmax + ((size_t)q * a.p.rb + r) * 4;
          pri = nmax(pri, v[0]);
          sp = nmax(sp, v[1]);
          dua = nmax(dua, v[2]);
          sd = nmax(sd, v[3]);
        }
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
        if (rank == 0) {
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
      if constexpr (STAMPS) ++n_sync;

      // every block: the ensemble's rung and exit, from all rows in order
      const double* ex = a.exch + (size_t)par * bp * kExCols;
      for (int i = threadIdx.x; i < bp * 3; i += blockDim.x)
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
      lap<STAMPS>(a.stamps, mark, K3S_REDUCE);
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

    // 3. the block's columns of u = y @ S_u - Kx, pushed into every block
    // of the cluster; then of x+ = Ax + u @ Bdw + noise, likewise
    const size_t row0 = (size_t)t * bp + r0;
    piece_product<double>(Chunked{cur, a.p.rb}, nr, a.s_u, nup, dp, uc.n, a.s_u_steps,
                          [&](int lc) { return cols.s_u(lc); },
                  [&](int r, int lc, float p) {
                    const int j = uc.lo + lc;
                    const T u = static_cast<T>(p) - kxp[r * nuw + lc];
                    for (int q = 0; q < C; ++q) cluster.map_shared_rank(ur, q)[r * nup + j] = u;
                    a.us[(row0 + r) * nup + j] = u;
                  });
    cluster.sync();
    piece_product<T>(RowMajor<T>{ur, nup}, nr, a.bdw, nplp, nup, xc.n, a.bdw_steps,
                     [&](int lc) { return cols.bdw(lc); },
                  [&](int r, int lc, float p) {
                    const int j = xc.lo + lc;
                    const T xn = (axp[r * nxw + lc] + static_cast<T>(p)) +
                                 a.noise[(row0 + r) * nplp + j];
                    for (int q = 0; q < C; ++q) cluster.map_shared_rank(xr, q)[r * nplp + j] = xn;
                    a.xs[(row0 + r) * nplp + j] = xn;
                  });
    lap<STAMPS>(a.stamps, mark, K2S_PLANT);
    cluster.sync();
    lap<STAMPS>(a.stamps, mark, K2S_XEXCH);
    if constexpr (STAMPS) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        ++a.stamps[K2S_STEPS];
        if (t == 0) a.stamps[K2S_SYNC_FIRST] = n_sync;
      }
    }
  }
  for (int i = threadIdx.x; i < nr * cw; i += blockDim.x) {
    const int r = i / cw, j = c0 + i % cw;
    a.y_f[(size_t)(r0 + r) * dp + j] = static_cast<T>(cur[yidx(a.p.rb, r, j)]);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.loads = n_loads;
  if constexpr (STAMPS) {
    __syncthreads();
    if (threadIdx.x == 0) {
      if (blockIdx.x == 0) a.stamps[K2S_SYNCS] = n_sync;
      atomicMax(a.stamps + K3S_END, gtimer());
    }
  }
}

__global__ void k6_stamp_kernel(unsigned long long* stamps) { stamps[K3S_PRE] = gtimer(); }

// The kernel of a plan's slab placement; `stamps`: the instantiation that
// stamps its stages (k6_stage_split's launches only).
template <typename T, typename WT>
auto kernel_for(bool w_smem, bool stamps = false) {
  if (stamps) return w_smem ? k6_kernel<T, WT, true, true> : k6_kernel<T, WT, false, true>;
  return w_smem ? k6_kernel<T, WT, true, false> : k6_kernel<T, WT, false, false>;
}

// Launch configuration of a plan: a cluster dimension, and cooperative (so
// that grid.sync() is allowed and the runtime refuses a grid that is not
// co-resident).
struct LaunchCfg {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
};

void fill_cfg(LaunchCfg& lc, const Plan& q, cudaStream_t stream, bool cooperative) {
  lc.cfg = {};
  lc.attr[0].id = cudaLaunchAttributeClusterDimension;
  lc.attr[0].val.clusterDim.x = q.cluster;
  lc.attr[0].val.clusterDim.y = 1;
  lc.attr[0].val.clusterDim.z = 1;
  lc.attr[1].id = cudaLaunchAttributeCooperative;
  lc.attr[1].val.cooperative = 1;
  lc.cfg.gridDim = dim3(q.nblocks);
  lc.cfg.blockDim = dim3(q.threads);
  lc.cfg.dynamicSmemBytes = q.smem;
  lc.cfg.stream = stream;
  lc.cfg.attrs = lc.attr;
  lc.cfg.numAttrs = cooperative ? 2 : 1;
}

template <typename T, typename WT>
cudaError_t set_attributes(const Plan& q, bool stamps = false) {
  auto fn = kernel_for<T, WT>(q.w_smem, stamps);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
}

// How many clusters of the plan's shape the card holds at once (0 where it
// holds none).
template <typename T, typename WT>
cudaError_t active_clusters(const Plan& q, int* n) {
  cudaError_t e = set_attributes<T, WT>(q);
  if (e != cudaSuccess) return e;
  LaunchCfg lc;
  fill_cfg(lc, q, 0, false);
  *n = 0;
  e = cudaOccupancyMaxActiveClusters(n, kernel_for<T, WT>(q.w_smem), &lc.cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    *n = 0;
  }
  return cudaSuccess;
}

// The launch shape. For C in 16, 8, 4, 2, 1 (the largest first) whose
// column slab is a whole number of 16-byte groups: the smallest row tile
// (at most kMaxRows) whose clusters the card holds all at once, first with
// the slab in shared memory beside the rows and their column pieces, then
// (where no C allows that) with the slab read from L2. No shape: an error.
template <typename T, typename WT>
cudaError_t make_plan(int bp, int dp, int nxp, int ncp, int nup, int nplp,
                      Plan* plan) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int smem_optin = 0, coop = 0, cl = 0;
  if ((e = cudaDeviceGetAttribute(&smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return e;
  if ((e = cudaDeviceGetAttribute(&cl, cudaDevAttrClusterLaunch, dev))) return e;
  if (!coop || !cl) return cudaErrorNotSupported;
  constexpr int VW = Vec16<WT>::n;
  if (bp < 1 || dp < 1 || nxp < 1 || ncp < 1 || nup < 1 || nplp < 1 || dp % kWidthStep ||
      nup % kWidthStep || nplp % kWidthStep)
    return cudaErrorInvalidValue;
  const size_t budget = (size_t)(smem_optin - kSmemReserve);
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    for (int C : kClusters) {
      if (dp % C != 0) continue;
      Plan q{};
      q.cluster = C;
      q.cw = dp / C;
      // whole 8-column tiles; a whole number of 16-byte groups of the slab
      if (q.cw % 8 != 0 || (w_smem && q.cw % VW != 0)) continue;
      q.w_smem = w_smem;
      q.threads = kBlockThreads;
      for (int rb = kRowGroup; rb <= kMaxRows; rb += kRowGroup) {
        q.rb = rb;
        q.tiles = ceil_div(bp, rb);
        q.nblocks = C * q.tiles;
        const size_t smem = make_layout<T, WT>(q, dp, nxp, ncp, nup, nplp, bp).total;
        if (smem > budget) break;
        q.smem = (int)smem;
        int n = 0;
        if ((e = active_clusters<T, WT>(q, &n))) return e;
        if (q.tiles <= n) {
          q.max_clusters = n;
          *plan = q;
          return cudaSuccess;
        }
      }
    }
  }
  return cudaErrorCooperativeLaunchTooLarge;  // no shape puts every tile in one wave
}

// make_plan once per device and shape: its attribute and occupancy queries
// cost more host time than a launch.
template <typename T, typename WT>
cudaError_t cached_plan(int bp, int dp, int nxp, int ncp, int nup, int nplp,
                        Plan* plan) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int, int>, Plan> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, bp, dp, nxp, ncp, nup, nplp);
  std::lock_guard<std::mutex> lock(mu);
  auto it = cache.find(key);
  if (it != cache.end()) {
    *plan = it->second;
    return cudaSuccess;
  }
  if ((e = make_plan<T, WT>(bp, dp, nxp, ncp, nup, nplp, plan))) return e;
  cache[key] = *plan;
  return cudaSuccess;
}

template <typename T, typename WT>
cudaError_t launch(const K6Params& p, cudaStream_t stream) {
  Plan plan;
  cudaError_t e = cached_plan<T, WT>(p.bp, p.dp, p.nxp, p.ncp, p.nup, p.nplp, &plan);
  if (e != cudaSuccess) return e;
  const bool stamps = p.stamps != nullptr;
  // another shape's plan may have set a smaller limit since
  if ((e = set_attributes<T, WT>(plan, stamps))) return e;
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
  a.gl_steps = static_cast<const int2*>(p.gl_steps);
  a.m_aff_steps = static_cast<const int2*>(p.m_aff_steps);
  a.m_res_steps = static_cast<const int2*>(p.m_res_steps);
  a.s_u_steps = static_cast<const int2*>(p.s_u_steps);
  a.bdw_steps = static_cast<const int2*>(p.bdw_steps);
  a.rhos = static_cast<const float*>(p.rhos);
  a.pad = static_cast<const float*>(p.pad);
  a.xs = static_cast<T*>(p.xs);
  a.us = static_cast<T*>(p.us);
  a.y_f = static_cast<T*>(p.y_f);
  a.stats = static_cast<float*>(p.stats);
  a.exch = static_cast<double*>(p.exch);
  a.loads = static_cast<int*>(p.loads);
  a.stamps = static_cast<unsigned long long*>(p.stamps);
  a.n_rho = p.n_rho;
  a.dp = p.dp;
  a.nxp = p.nxp;
  a.ncp = p.ncp;
  a.nup = p.nup;
  a.nplp = p.nplp;
  a.bp = p.bp;
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
  a.p = plan;
  a.L = make_layout<T, WT>(plan, p.dp, p.nxp, p.ncp, p.nup, p.nplp, p.bp);
  LaunchCfg lc;
  fill_cfg(lc, plan, stream, true);
  e = cudaLaunchKernelEx(&lc.cfg, kernel_for<T, WT>(plan.w_smem, stamps), a);
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

// Adds one block's chains of a product (n columns col(lc) over k inputs, on
// row_tiles tiles of 16 rows) to o = {longest, dense, kept, dense summed}:
// piece_product's tiles of 8 columns (a column past n reads column c0's
// steps), each running the union of its columns' [lo, hi) steps `st`.
template <typename Col>
void count_chains(const int* st, int n, int k, Col col, int row_tiles, long long* o) {
  o[1] = k / 8;
  for (int c0 = 0; c0 < n; c0 += 8) {
    int lo = k / 8, hi = 0;
    for (int g = 0; g < 8; ++g) {
      const int cm = col(c0 + g < n ? c0 + g : c0);
      if (st[2 * cm] < st[2 * cm + 1]) {
        lo = std::min(lo, st[2 * cm]);
        hi = std::max(hi, st[2 * cm + 1]);
      }
    }
    const long long kept = hi > lo ? hi - lo : 0;
    o[0] = std::max(o[0], kept);
    o[2] += kept * row_tiles;
    o[3] += (long long)(k / 8) * row_tiles;
  }
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

// The launch shape k6_full_rollout_batched would use, for reports: out[0..8]
// = blocks, threads per block, cluster size, column slab width, rows per
// tile, tiles, dynamic shared memory, slab in shared memory (1) or read
// from L2 (0), clusters of this shape the card holds at once.
int k6_plan(int bp, int dp, int nxp, int ncp, int nup, int nplp, int y_dtype, int w_dtype,
            int* out) {
  Plan q;
  const cudaError_t e = dispatch(y_dtype, w_dtype, [&](auto t, auto w) {
    return cached_plan<decltype(t), decltype(w)>(bp, dp, nxp, ncp, nup, nplp, &q);
  });
  if (e != cudaSuccess) return (int)e;
  const int v[9] = {q.nblocks, q.threads, q.cluster, q.cw, q.rb,
                     q.tiles, q.smem, q.w_smem, q.max_clusters};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// The chain steps of each once-a-step product in the launch
// k6_full_rollout_batched makes at this shape, given the [lo, hi) steps of
// each operand column (host int32 pairs; steps[0..4]: gl, m_aff, m_res,
// s_u, bdw): out[4 i .. 4 i + 3] for product i (refresh, bias, check, u, x)
// = the longest tile's chain, the dense chain, and the chains summed over
// every 16x8 tile of the launch, kept and dense. Counted over the kernel's
// own plan, column maps (K6Cols) and tiles.
int k6_chain_steps(int bp, int dp, int nxp, int ncp, int nup, int nplp, int y_dtype,
                   int w_dtype, const int* const* steps, long long* out) {
  Plan q;
  const cudaError_t e = dispatch(y_dtype, w_dtype, [&](auto t, auto w) {
    return cached_plan<decltype(t), decltype(w)>(bp, dp, nxp, ncp, nup, nplp, &q);
  });
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < 20; ++i) out[i] = 0;
  for (int tile = 0; tile < q.tiles; ++tile) {
    const int row_tiles = ceil_div(std::min(q.rb, bp - tile * q.rb), 16);
    for (int rank = 0; rank < q.cluster; ++rank) {
      const K6Cols c(dp, nxp, ncp, nup, nplp, q.cluster, q.cw, rank);
      count_chains(steps[0], c.n_gl(), nplp, [&](int lc) { return c.gl(lc); }, row_tiles,
                   out);
      count_chains(steps[1], c.cw, nplp, [&](int lc) { return c.m_aff(lc); }, row_tiles,
                   out + 4);
      count_chains(steps[2], c.n_res(), dp, [&](int lc) { return c.m_res(lc); }, row_tiles,
                   out + 8);
      count_chains(steps[3], c.uc.n, dp, [&](int lc) { return c.s_u(lc); }, row_tiles,
                   out + 12);
      count_chains(steps[4], c.xc.n, nup, [&](int lc) { return c.bdw(lc); }, row_tiles,
                   out + 16);
    }
  }
  return 0;
}

// The K3S_PRE stamp on `stream`, just before a stamped K6 launch.
int k6_stamp_now(void* stamps, void* stream) {
  k6_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(stamps));
  return (int)cudaGetLastError();
}

const char* k6_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
