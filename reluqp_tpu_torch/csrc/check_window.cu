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
// C1, one QP, runs in one thread-block cluster (16 blocks where the card
// schedules them, else 8). Every block stages the vectors the products read
// (y, and lam, dx, dlam where they are needed) in shared memory; the
// products (y @ M_res when alpha = 1, else A x, H x and A'lam, and with the
// certificates A'dlam, H dx and A dx) are cut into units dealt to the
// cluster's blocks longest first: 16 output rows (a warp each, lanes along a
// contiguous row of the operand) or 64 output columns (a lane on two of
// them, 16 warps each summing 32 rows of every 512-row chunk, each batch of
// coefficient loads in flight at once; a block's first batch is started
// before y arrives). M_res's column blocks are summed over the rows where
// `build_residual_operator` puts their nonzeros (all rows when y holds a
// non-finite value). Each unit's sums are pushed into block 0's shared
// memory (distributed shared memory stores, after the first half of a
// cluster barrier that every block arrives at on entry and waits at once
// it has staged its vectors: no block writes into another before that
// block has started). After a second cluster barrier block 0 reduces the
// residuals' maxima, the certificates' maxima and their two sums in one
// multi-value pass, and one thread takes the decisions: the rho estimate,
// the +-1 walk or the jump, the stride's check ordinal, the solved test,
// the certificates, phase A's 3% stall test and the exit flags. Every
// block writes its slice of y as soon as it is staged (block 0 writes y
// after the decisions where p is re-encoded for the new rung, alpha != 1)
// and of the certificates' previous iterate. No ticket. Where a block's
// vectors and block 0's sums do not fit shared memory (past about
// nx = 2900 in fp64 with the certificates, nx = 10000 in fp32 through
// M_res), the kernel's global variant keeps the sums and each block's
// vectors in a scratch region (`part`, sized by c1_plan_of) instead; the
// sums and their order are the same.
//
// C2, a batch, in one of three regimes chosen by `c2_plan` from (nx, nc,
// dtype, per-problem H / A), its shape within the regime from B:
// - "smem": a shared H and A that fit shared memory. A grid of at most
//   three blocks an SM walks tiles of 32 rows (16 or 8 where the batch would
//   not fill the card); each block copies H and A once with 16-byte
//   cp.async and lays them out with consecutive outputs contiguous ([A; H]'
//   and A, each row padded to whole 32-byte groups). A lane per row: each
//   thread keeps a register micro-tile of one row by 8 (fp32) or 4 (fp64)
//   outputs, so one load of the row's element feeds 8 (4) multiply-adds and
//   the coefficients arrive as 16-byte broadcasts; the output groups are
//   dealt to the warps longest first. The row pass runs 256 / rows lanes a
//   row, every lane busy; the tile's row shares are summed by one warp
//   butterfly.
// - "stream": a per-problem H and/or A small enough for a warp's shared
//   memory. A warp per row: it copies its row's H and A with 16-byte
//   cp.async (the next row's while it computes this one, where a warp has
//   more than one row), a lane per output, and takes the row's decisions.
// - "tiles": everything else (the scenario's 320 KB operand, B = 1 at
//   Dp = 896, per-problem operands too large for a warp). A grid of (row
//   tile) x (output tile): a warp per output row of [A; H] with lanes along
//   the contraction, or 32 columns of A'lam by one 32-row segment of the
//   contraction with the warps on the tile's rows; the coefficients are
//   copied into shared memory with cp.async and each applied to every row
//   of the tile. Products and segment sums go to scratch; the last block of
//   each row tile (a per-row-tile ticket) adds the segments in order and
//   takes that tile's rows' decisions. Where even a one-row tile's vectors
//   and products outgrow shared memory (past about nx = 3400 in fp64 with
//   the certificates, nx = 6400 in fp64, 6800 and 12900 in fp32), the
//   global variant stages no vectors for the products (x and dx are read
//   in place, an A'lam block forms its segment of lam and dlam) and the
//   last block stages the rows' vectors into scratch and reads the products
//   there: the same values, sums and order, no size limit.
// Every regime stages a row's vectors with cp.async. The grid's last block
// (a ticket) sums the blocks' (row tiles') shares of the shared walk's log
// rho and active count, the open count and phase A's log residuals in a
// fixed order and decides the shared rung, the flags and phase A's test.
// Under the shared walk with alpha != 1 the re-encode of p needs the new
// rung: a second, elementwise launch does it. A row's results depend on the
// row, the decided rung and the regime only, never on B or on the row's
// place in the batch.
//
// Sums, each in a fixed order (so the check is deterministic): C1's
// products as chains of at most 32 terms (or nx / 32) in the state type,
// the chains' sums in fp64, rounded once to the state type (an fp32 -> fp64
// conversion per factor runs at 16 a clock per SM, slower than one
// cluster's loads); C2's in the state type: in "smem" and "stream" one
// chain per output in contraction order, in "tiles" lane-strided chains
// met by a butterfly (A x, H x) or 32-term segments added in segment order
// (A'lam); every sum over rows in fp64. Elementwise steps are single IEEE
// operations in the state type (the `_rn` intrinsics: no contraction into
// an FMA), as the plain version's separate torch ops are, and every
// threshold decision is taken in the state type with the host's values
// rounded to it. The kernels and the plain versions therefore differ by
// the products' rounding only. No cooperative launch and no spin barrier:
// the kernels run inside the conditional bodies of the solves' device
// programs (a cluster barrier is fine there).
//
// What bounds them: the bytes. A check reads its operands once (M_res
// Dp x R, or H and A) and the state, and writes the state back: at most a
// few MB, microseconds at 3.35 TB/s. At these sizes the launch and the
// dependent chain (stage, products, exchange, decision) bound the time; C1
// at Dp >= 640 also one cluster's share of L2 bandwidth (M_res's nonzero
// blocks: 0.8 MB at Dp = 640, 2.3 MB at 1024, read by 16 SMs), and C2's
// products the shared-memory loads that feed their multiply-adds.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success), the launch error
// checked right after the launch. A non-null `stamps` (never on a solve
// path) makes the kernels record %globaltimer at their stage boundaries.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

#include "tiers.cuh"

namespace cg = cooperative_groups;

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
  void* part;
  unsigned long long* stamps;
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
  unsigned long long* stamps;
  int B, dp, nx, nc, n_rho, h_per, a_per, g_per, wp_per, wd_per, reff_per, shared, n_steps,
      phase_a, adaptive, jump, stride, ci, budget, cap_a, certs, alpha, stop_open, dtype;
  double eps_pri, eps_dua, tol, rho_min, rho_max, eps_pinf, eps_dinf, stall;
};


namespace {

constexpr int kThreads = 256;                   // C2's blocks
constexpr int kWarps = kThreads / 32;
constexpr int kC1Threads = 512;                 // C1's blocks
constexpr int kC1Warps = kC1Threads / 32;
constexpr int kColRows = 32;                    // rows a warp sums per column tile
constexpr int kC1Chunk = kC1Warps * kColRows;   // rows of a column unit's chunk
constexpr int kC1Cols = 64;                     // outputs of a column unit
constexpr int kMaxSeg = 7;
constexpr int kMaxCluster = 16;
constexpr int kTileRows = 32;                   // C2 "smem": rows a tile at most (a lane each)
constexpr int kMaxTilesRows = 16;               // C2 "tiles": rows a row tile at most
constexpr int kTilesBuf = 1024;                 // C2 "tiles": a warp's coefficients
constexpr int kStreamWarps = 8;                 // C2 "stream": warps a block at most
constexpr long kSmemCap = 200 * 1024;           // shared memory a C2 block may take
constexpr long kSmemSM = 227 * 1024;            // shared memory of an SM's blocks
constexpr long kTilesStatic = 4096;             // C2 "tiles": its static shared memory, at most
constexpr int kStatSolved = 1, kStatPinf = 2, kStatDinf = 3, kRunning = -1;
enum { R_SMEM = 0, R_STREAM = 1, R_TILES = 2 };

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
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

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

// A batch of loads in flight at once: each sent by a volatile load
// (`ld_ahead`, which the compiler keeps in program order), then a barrier
// before the first use (`loads_fence`), so the batch's values wait in
// registers instead of each load waiting for the last one's use.
__device__ __forceinline__ float ld_ahead(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ double ld_ahead(const double* p) {
  double v;
  asm volatile("ld.global.nc.f64 %0, [%1];" : "=d"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ void loads_fence() { asm volatile("" ::: "memory"); }
// an accumulator "written" here: the multiply-adds into it stay below
__device__ __forceinline__ void pin(float& x) { asm volatile("" : "+f"(x)); }
__device__ __forceinline__ void pin(double& x) { asm volatile("" : "+d"(x)); }

template <typename T> __device__ __forceinline__ T shfl_xor(T v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}
// every lane ends with the same bits: each stage adds the same two values
template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v = add_rn(v, shfl_xor(v, o));
  return v;
}

__host__ __device__ inline int clamp_ind(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }
__host__ __device__ inline long round_up(long v, long m) { return (v + m - 1) / m * m; }

// Stage stamps (a null `stamps` on every solve path): %globaltimer at a
// stage boundary, slot 0 the earliest block's start, every other slot the
// latest time any block passed that boundary (ops/check_window.py
// STAMP_STAGES names them).
enum { S_START = 0, S_STAGED, S_PRODUCTS, S_ROWS, S_TICKET, S_REDUCED, S_WRITTEN, kStampSlots };
__device__ __forceinline__ void stamp(unsigned long long* s, int slot) {
  if (!s || threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (slot == S_START) atomicMin(s, t);
  else atomicMax(s + slot, t);
}

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

// A ticket of `n` blocks: the block that increments it last (after its
// results are fenced) proceeds and resets it for the next launch.
__device__ bool ticket(int* tick, int n) {
  __shared__ int s_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const int t = atomicAdd(tick, 1);
    s_last = t == n - 1;
    if (s_last) {
      __threadfence();
      *tick = 0;
    }
  }
  __syncthreads();
  return s_last != 0;
}

// ------------------------------------------------------------------------
// the residuals' and certificates' reduction, shared by C1 and C2
// ------------------------------------------------------------------------

constexpr int kNStat = 15;

// What a check reduces over a QP's outputs: the residuals' maxima and
// their scales' (pri, ax, z, dua, hx, atl, g), and with the certificates
// max |dlam|, max |dx|, max |A'dlam|, max |H dx|, the ray test's extremes
// (rh: max A dx where u is finite, rl: max -A dx where l is finite) and the
// support and g'dx sums. The maxima are torch's NaN-propagating amax, free
// of order; the sums are taken in an order fixed by the caller.
template <typename T> struct Stats {
  enum { PRI = 0, AX, Z, DUA, HX, ATL, G, DL, DX, AT, HD, RH, RL, NMAX };
  T v[NMAX];
  double sup, gdx;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int i = 0; i < NMAX; ++i) v[i] = T(0);
    v[RH] = v[RL] = static_cast<T>(-INFINITY);
    sup = gdx = 0.0;
  }
  __device__ __forceinline__ void max_in(int i, T x) { v[i] = nmax(v[i], x); }
  // a butterfly over aligned groups of W lanes (every lane of the warp
  // takes part): every lane of a group ends with the group's values
  template <int W> __device__ __forceinline__ void reduce_lanes(bool certs) {
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < NMAX; ++i)
        if (i < DL || certs) v[i] = nmax(v[i], shfl_xor(v[i], o));
      if (certs) {
        sup = sup + shfl_xor(sup, o);
        gdx = gdx + shfl_xor(gdx, o);
      }
    }
  }
  __device__ __forceinline__ void store(double* d) const {
#pragma unroll
    for (int i = 0; i < NMAX; ++i) d[i] = static_cast<double>(v[i]);
    d[NMAX] = sup, d[NMAX + 1] = gdx;
  }
  __device__ __forceinline__ void load(const double* d) {
#pragma unroll
    for (int i = 0; i < NMAX; ++i) v[i] = static_cast<T>(d[i]);
    sup = d[NMAX], gdx = d[NMAX + 1];
  }
  __device__ __forceinline__ T scale_p() const { return nmax(v[AX], v[Z]); }
  __device__ __forceinline__ T scale_d() const { return nmax(nmax(v[HX], v[ATL]), v[G]); }
  // the certificates (OSQP's tests on the deltas since the last check);
  // the ray test all(A dx <= eps_d where u is finite, A dx >= -eps_d where
  // l is finite) as two maxima against eps_d
  __device__ __forceinline__ void certificates(T eps_pinf, T eps_dinf, bool& pinf,
                                               bool& dinf) const {
    const T zero = T(0);
    const T eps_p = mul_rn(eps_pinf, v[DL]);
    const T eps_d = mul_rn(eps_dinf, v[DX]);
    const T support = static_cast<T>(sup), g_dx = static_cast<T>(gdx);
    const bool ray_ok = v[RH] <= eps_d && v[RL] <= eps_d;
    pinf = v[DL] > zero && v[AT] <= eps_p && support <= -eps_p;
    dinf = v[DX] > zero && v[HD] <= eps_d && g_dx <= -eps_d && ray_ok;
  }
};
static_assert(Stats<float>::NMAX + 2 == kNStat, "Stats' doubles");

// the OSQP rho estimate from the residuals and their scales
template <typename T>
__device__ __forceinline__ T rho_estimate(const Stats<T>& s, T rho, double rho_min,
                                          double rho_max) {
  const T tiny = static_cast<T>(1e-30);
  const T num = div_rn(s.v[Stats<T>::PRI], nmax(s.scale_p(), tiny));
  const T den = div_rn(s.v[Stats<T>::DUA], nmax(s.scale_d(), tiny));
  const T ratio = sqrt_rn(div_rn(num, nmax(den, tiny)));
  return clamp_t(mul_rn(rho, ratio), static_cast<T>(rho_min), static_cast<T>(rho_max));
}

// ------------------------------------------------------------------------
// C1
// ------------------------------------------------------------------------

enum { V_Y = 0, V_LAM, V_DX, V_DLAM };

// One product: out[o] = sum_k M[o*so + k*sk] v[k]. Row mode (so = ld,
// sk = 1): a warp per output, a unit of kC1Warps outputs. Column mode
// (so = 1, sk = ld): a lane per two outputs (j and j + 32), a unit of
// kC1Cols outputs, its rows cut into chunks of kC1Chunk (32 rows a warp).
// A column segment of M_res sums only the rows [k_lo, k_lo + n_k) where
// `build_residual_operator` puts its nonzeros, and all k_full rows when y
// holds a non-finite value (0 * inf is NaN in the plain product). Units are
// numbered across the segments from unit0 and dealt to the cluster's blocks
// (`c1_deal`); output j of a segment is sum out0 + j.
struct Seg {
  const void* m;
  int row, n_out, n_k, k_lo, k_full, ld, vec, units, unit0, out0;
};

constexpr int kMaxUnits = 512;
constexpr int kWpart = 2 * kC1Warps * kC1Cols * 8;  // two column units' warp sums

// The units' deal: block b takes units order[first[b] .. first[b + 1]);
// past kMaxUnits units, round robin. The outs sums (in the state type)
// and then, from vec_at, the vectors (nv elements: y, and lam, dx, dlam
// where needed) lie after the warp sums in shared memory (block 0's sums
// only are used), or in the global variant at part: the sums, then each
// block's vectors at vec_at + block * vstride.
struct C1Plan {
  Seg segs[kMaxSeg];
  int n_seg, units, outs, cluster, smem, nv, vec_at, vstride, global;
  short first[kMaxCluster + 1];
  short order[kMaxUnits];
};

inline void seg_add(C1Plan& p, const void* m, int row, int n_out, int n_k, int ld, int vec,
                    int k_lo = 0, int k_full = -1) {
  Seg& g = p.segs[p.n_seg++];
  g.m = m, g.row = row, g.n_out = n_out, g.n_k = n_k, g.ld = ld, g.vec = vec;
  g.k_lo = k_lo, g.k_full = k_full < 0 ? n_k : k_full;
  g.units = row ? (n_out + kC1Warps - 1) / kC1Warps : (n_out + kC1Cols - 1) / kC1Cols;
  g.unit0 = p.units;
  g.out0 = p.outs;
  p.units += g.units;
  p.outs += n_out;
}

void c1_deal(C1Plan& p);

// C1's products and their units for a cluster of `cs`, the deal, and the
// shared memory a block takes: two buffers of a column unit's warp sums,
// then (unless global) the sums and the vectors.
C1Plan c1_plan(const C1Args& a, int cs, bool global) {
  C1Plan p;
  memset(&p, 0, sizeof(p));
  const int certs = a.certs && !a.tail_mode;
  const int elt = a.dtype == DT_F64 ? 8 : 4;
  if (a.m_res) {
    // [A x | z | H x | A'lam]: its column blocks and their nonzero rows
    const int nx = a.nx, nc = a.nc, ncp = a.ncp, nxp = a.nxp, r = 2 * ncp + 2 * nxp;
    const char* m = static_cast<const char*>(a.m_res);
    seg_add(p, m, 0, ncp, nx, r, V_Y, 0, a.dp);
    seg_add(p, m + (size_t)ncp * elt, 0, ncp, nc, r, V_Y, nx, a.dp);
    seg_add(p, m + (size_t)2 * ncp * elt, 0, nxp, nx, r, V_Y, 0, a.dp);
    seg_add(p, m + (size_t)(2 * ncp + nxp) * elt, 0, nxp, nc, r, V_Y, nx + nc, a.dp);
  } else {
    seg_add(p, a.A, 1, a.nc, a.nx, a.nx, V_Y);    // A x
    seg_add(p, a.H, 1, a.nx, a.nx, a.nx, V_Y);    // H x
    seg_add(p, a.A, 0, a.nx, a.nc, a.nx, V_LAM);  // A' lam
  }
  if (certs) {
    seg_add(p, a.A, 0, a.nx, a.nc, a.nx, V_DLAM);  // A' dlam
    seg_add(p, a.H, 1, a.nx, a.nx, a.nx, V_DX);    // H dx
    seg_add(p, a.A, 1, a.nc, a.nx, a.nx, V_DX);    // A dx
  }
  p.cluster = cs;
  c1_deal(p);
  const bool need_lam = certs || !a.m_res;
  p.nv = a.dp + (need_lam ? a.nc : 0) + (certs ? a.nx + a.nc : 0);
  p.vec_at = (int)round_up(p.outs, 4);  // 16-byte aligned vectors
  p.vstride = (int)round_up(p.nv, 4);
  p.global = global;
  p.smem = kWpart + (global ? 0 : (int)((long)(p.vec_at + p.vstride) * elt));
  return p;
}

// The cluster barrier in two halves: arrive (relaxed: it orders no memory)
// and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// G: the global variant (the sums and the vectors in part).
template <typename T, bool G>
__global__ void __launch_bounds__(kC1Threads) c1_kernel(const C1Args a, const C1Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double s_wred[kC1Warps][kNStat];
  __shared__ int s_new_ind;
  typedef Stats<T> S;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = p.cluster;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dp = a.dp, nx = a.nx, nc = a.nc;
  const bool certs = a.certs && !a.tail_mode;
  const bool need_lam = certs || (!a.m_res);
  const bool reencode = !a.tail_mode && a.adaptive && a.alpha;
  const T* y_in = static_cast<const T*>(a.y_in);
  const T* reff = static_cast<const T*>(a.rho_eff);
  stamp(a.stamps, S_START);
  // every block of the cluster has started before any block writes into
  // another's shared memory: arrive now, wait once staged
  if (!G) cluster_arrive_relaxed();
  // the state's scalars (block 0 writes them after the cluster barrier)
  const int ind = clamp_ind(*a.rho_ind, a.n_rho);
  const int k_new = *a.k + a.n_steps;
  const T rho_old = *static_cast<const T*>(a.rho);
  T best_p = T(0), best_d = T(0);
  int n_stall_old = 0;
  if (a.phase_a && rank == 0 && threadIdx.x == 0) {
    best_p = *static_cast<const T*>(a.best_p), best_d = *static_cast<const T*>(a.best_d);
    n_stall_old = *a.n_stall;
  }

  // a column unit's warp sums (two buffers), then every output's sum (block
  // 0's are used) and the vectors the products and the elementwise steps
  // read: y, lam, dx, dlam
  double* wpart = reinterpret_cast<double*>(smem_raw);
  T* outv = G ? static_cast<T*>(a.part) : reinterpret_cast<T*>(smem_raw + kWpart);
  T* ys = outv + p.vec_at + (G ? (size_t)rank * p.vstride : 0);
  T* lam = ys + dp;
  T* dx = lam + nc;
  T* dlam = dx + nx;

  // The block's units, and its first unit's first coefficients: where that
  // is a column unit, each warp starts loading its first batch of rows (the
  // nonzero rows, as for a finite y) before y arrives, so that the two
  // loads overlap.
  const bool dealt = p.first[cs] == p.units;  // else round robin
  const int n_mine = dealt ? p.first[rank + 1] - p.first[rank] : (p.units - rank + cs - 1) / cs;
  auto unit_of = [&](int ui) { return dealt ? (int)p.order[p.first[rank] + ui] : rank + ui * cs; };
  auto seg_of = [&](int u) {
    int s = 0;
    while (u >= p.segs[s].unit0 + p.segs[s].units) ++s;
    return s;
  };
  constexpr int RB = sizeof(T) == 4 ? 32 : 16;  // rows of a batch
  T w0[RB], w1[RB];
  auto load_batch = [&](const Seg& g, int t, int kb, int nk, int k0, int h) {
    const int j0 = t * kC1Cols + lane;
    const bool in0 = j0 < g.n_out, in1 = j0 + 32 < g.n_out;
    const T* m0 = static_cast<const T*>(g.m) + (size_t)(kb + k0) * g.ld + j0;
    const int rows = min(kColRows, nk - k0);
#pragma unroll
    for (int q = 0; q < RB; ++q) {
      const bool in = h + q < rows;
      w0[q] = in && in0 ? ld_ahead(m0 + (size_t)(h + q) * g.ld) : T(0);
      w1[q] = in && in1 ? ld_ahead(m0 + (size_t)(h + q) * g.ld + 32) : T(0);
    }
  };
  bool pre = false;
  if (n_mine > 0) {
    const int u = unit_of(0);
    const Seg& g = p.segs[seg_of(u)];
    if (!g.row && warp * kColRows < g.n_k) {
      load_batch(g, u - g.unit0, g.k_lo, g.n_k, warp * kColRows, 0);
      pre = true;
    }
  }
  int bad = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < dp; i += kC1Threads) {
    const T v = y_in[i];
    ys[i] = v;
    bad |= !finite_t(v);
  }
  // a non-finite y: every product sums all its rows
  const bool y_bad = __syncthreads_or(bad) != 0;
  if (need_lam) {
    const T* lp = static_cast<const T*>(a.lam_prev);
    for (int i = threadIdx.x; i < nc; i += kC1Threads) {
      const T pv = ys[nx + nc + i];
      const T l = a.alpha ? mul_rn(reff[(size_t)ind * nc + i], sub_rn(pv, ys[nx + i])) : pv;
      lam[i] = l;
      if (certs) dlam[i] = sub_rn(l, lp[i]);
    }
  }
  if (certs) {
    const T* xp = static_cast<const T*>(a.x_prev);
    for (int i = threadIdx.x; i < nx; i += kC1Threads) dx[i] = sub_rn(ys[i], xp[i]);
  }
  __syncthreads();
  T* y = static_cast<T*>(a.y);
  const int gt = rank * kC1Threads + threadIdx.x, gs = cs * kC1Threads;
  if (!reencode)  // y does not wait for the decisions
    for (int i = gt; i < dp; i += gs) y[i] = ys[i];
  stamp(a.stamps, S_STAGED);

  // the products: this block's units, each lane's chain in the state type,
  // the chains' sums in fp64 (lanes by a butterfly, or warps and chunks in
  // order), rounded once to the state type into block 0's sums
  if (!G) cluster_wait();
  T* out0 = G ? outv : cluster.map_shared_rank(outv, 0);
  int par = 0;
  if (y_bad) pre = false;  // every row then: the batch is loaded anew
  for (int ui = 0; ui < n_mine; ++ui) {
    const int u = unit_of(ui);
    const Seg& g = p.segs[seg_of(u)];
    const int t = u - g.unit0;
    const T* v = g.vec == V_Y ? ys : g.vec == V_LAM ? lam : g.vec == V_DX ? dx : dlam;
    if (g.row) {
      const T* m = static_cast<const T*>(g.m);
      const int o = t * kC1Warps + warp;
      if (o < g.n_out) {
        T acc = T(0);
        const T* mr = m + (size_t)o * g.ld;
#pragma unroll 4
        for (int q = lane; q < g.n_k; q += 32) acc = fma_t(__ldg(mr + q), v[q], acc);
        const double sum = warp_sum(static_cast<double>(acc));
        if (lane == 0) out0[g.out0 + o] = static_cast<T>(sum);
      }
    } else {
      // lanes on columns j0 = t * 64 + lane and j0 + 32; warp w on rows
      // k_lo + c * 512 + 32 w ... of every chunk c; a warp's chunks summed
      // in order, then the warps in order
      const int kb = y_bad ? 0 : g.k_lo, nk = y_bad ? g.k_full : g.n_k;
      const T* vk = v + kb;
      double s0 = 0.0, s1 = 0.0;
      for (int k0 = warp * kColRows; k0 < nk; k0 += kC1Chunk) {
        const int rows = min(kColRows, nk - k0);
        T a0 = T(0), a1 = T(0);
        // the warp's rows in batches of RB, every load of a batch in flight
        // (rows past the segment's add +0); the first batch of the first
        // unit may be in flight already
#pragma unroll
        for (int h = 0; h < kColRows; h += RB) {
          if (!pre) load_batch(g, t, kb, nk, k0, h);
          pre = false;
          T x[RB];
#pragma unroll
          for (int q = 0; q < RB; ++q) x[q] = h + q < rows ? vk[k0 + h + q] : T(0);
          loads_fence();
          pin(a0), pin(a1);
#pragma unroll
          for (int q = 0; q < RB; ++q) {
            a0 = fma_t(w0[q], x[q], a0);
            a1 = fma_t(w1[q], x[q], a1);
          }
        }
        s0 += static_cast<double>(a0);
        s1 += static_cast<double>(a1);
      }
      double* wp = wpart + (size_t)par * kC1Warps * kC1Cols;
      wp[warp * kC1Cols + lane] = s0;
      wp[warp * kC1Cols + 32 + lane] = s1;
      __syncthreads();
      if (warp < 2) {
        const int col = warp * 32 + lane, j = t * kC1Cols + col;
        if (j < g.n_out) {
          double sum = 0.0;
          for (int w = 0; w < kC1Warps; ++w) sum += wp[w * kC1Cols + col];
          out0[g.out0 + j] = static_cast<T>(sum);
        }
      }
      par ^= 1;  // the next column unit fills the other buffer
    }
  }
  __syncthreads();
  stamp(a.stamps, S_PRODUCTS);
  cluster.sync();  // every output's sum is in block 0's (or the global) sums
  stamp(a.stamps, S_TICKET);
  if (certs) {
    T* xp = static_cast<T*>(a.x_prev);
    T* lp = static_cast<T*>(a.lam_prev);
    for (int i = gt; i < nx; i += gs) xp[i] = ys[i];
    for (int i = gt; i < nc; i += gs) lp[i] = lam[i];
  }
  if (rank != 0) return;

  // ---- block 0: the residuals' and certificates' reduction, one pass ----
  auto val = [&](int sg, int j) -> T {
    const T* v = outv + p.segs[sg].out0 + j;
    return G ? __ldcg(v) : *v;
  };
  Stats<T> st;
  st.init();
  if (a.m_res) {
    const int ncp = a.ncp, nxp = a.nxp;
    const T* grow = static_cast<const T*>(a.g_row);
    for (int i = threadIdx.x; i < ncp; i += kC1Threads) {
      const T ax = val(0, i), z = val(1, i);
      st.max_in(S::PRI, abs_t(sub_rn(ax, z)));
      st.max_in(S::AX, abs_t(ax));
      st.max_in(S::Z, abs_t(z));
    }
#pragma unroll 2
    for (int i = threadIdx.x; i < nxp; i += kC1Threads) {
      const T hx = val(2, i), atl = val(3, i), gr = grow[i];
      st.max_in(S::DUA, abs_t(add_rn(add_rn(hx, atl), gr)));
      st.max_in(S::HX, abs_t(hx));
      st.max_in(S::ATL, abs_t(atl));
      st.max_in(S::G, abs_t(gr));
    }
  } else {
    const T* wp = static_cast<const T*>(a.w_pri);
    const T* wd = static_cast<const T*>(a.w_dua);
    const T* gv = static_cast<const T*>(a.g);
#pragma unroll 2
    for (int i = threadIdx.x; i < nc; i += kC1Threads) {
      T ax = val(0, i), z = ys[nx + i];
      if (wp) ax = mul_rn(wp[i], ax), z = mul_rn(wp[i], z);
      st.max_in(S::PRI, abs_t(sub_rn(ax, z)));
      st.max_in(S::AX, abs_t(ax));
      st.max_in(S::Z, abs_t(z));
    }
#pragma unroll 2
    for (int i = threadIdx.x; i < nx; i += kC1Threads) {
      T hx = val(1, i), atl = val(2, i), gv_i = gv[i];
      if (wd) hx = mul_rn(wd[i], hx), atl = mul_rn(wd[i], atl), gv_i = mul_rn(wd[i], gv_i);
      st.max_in(S::DUA, abs_t(add_rn(add_rn(hx, atl), gv_i)));
      st.max_in(S::HX, abs_t(hx));
      st.max_in(S::ATL, abs_t(atl));
      st.max_in(S::G, abs_t(gv_i));
    }
  }
  if (certs) {
    const int s0 = a.m_res ? 4 : 3;  // A'dlam, H dx, A dx
    const T* lo = static_cast<const T*>(a.lo) + nx;
    const T* hi = static_cast<const T*>(a.hi) + nx;
    const T* gv = static_cast<const T*>(a.g);
    const T zero = T(0);
#pragma unroll 2
    for (int i = threadIdx.x; i < nc; i += kC1Threads) {
      const T dl = dlam[i];
      st.max_in(S::DL, abs_t(dl));
      const T term = dl > zero ? mul_rn(hi[i], dl) : (dl < zero ? mul_rn(lo[i], dl) : zero);
      st.sup += static_cast<double>(term);
      const T adx = val(s0 + 2, i);
      if (finite_t(hi[i])) st.max_in(S::RH, adx);
      if (finite_t(lo[i])) st.max_in(S::RL, -adx);
    }
#pragma unroll 2
    for (int i = threadIdx.x; i < nx; i += kC1Threads) {
      st.max_in(S::DX, abs_t(dx[i]));
      st.max_in(S::AT, abs_t(val(s0, i)));
      st.max_in(S::HD, abs_t(val(s0 + 1, i)));
      st.gdx = fma(static_cast<double>(gv[i]), static_cast<double>(dx[i]), st.gdx);
    }
  }
  // the warps in order, then the decisions on one thread
  st.template reduce_lanes<32>(certs);
  if (lane == 0) st.store(s_wred[warp]);
  __syncthreads();
  if (warp == 0) {
    Stats<T> r;
    if (lane < kC1Warps) r.load(s_wred[lane]);
    else r.init();
    r.template reduce_lanes<32>(certs);
    if (lane == 0) {
      stamp(a.stamps, S_REDUCED);
      bool pinf = false, dinf = false;
      if (certs)
        r.certificates(static_cast<T>(a.eps_pinf), static_cast<T>(a.eps_dinf), pinf, dinf);
      const T pri = r.v[S::PRI], dua = r.v[S::DUA];
      const T rho_new = rho_estimate(r, rho_old, a.rho_min, a.rho_max);
      const bool solved = pri < static_cast<T>(a.eps_pri) && dua < static_cast<T>(a.eps_dua);
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
          const T stl = static_cast<T>(a.stall);
          const bool improved = pri < mul_rn(stl, best_p) || dua < mul_rn(stl, best_d);
          const int n_stall = improved ? 0 : n_stall_old + 1;
          if (pri < best_p) *bp = pri;
          if (dua < best_d) *bd = dua;
          *a.n_stall = n_stall;
          *a.k_fast = k_new;
          *a.open_a = n_stall < 2 && k_new < a.cap_a && running;
        }
      }
      s_new_ind = new_ind;
    }
  }
  if (reencode) {
    // p re-encoded for the new rung: z + (rho_old / rho_new) (p - z)
    __syncthreads();
    const int new_ind = s_new_ind;
    for (int i = threadIdx.x; i < dp; i += kC1Threads) {
      T v = ys[i];
      if (i >= nx + nc && i < nx + 2 * nc) {
        const int j = i - nx - nc;
        const T z = ys[nx + j];
        const T s = div_rn(reff[(size_t)ind * nc + j], reff[(size_t)new_ind * nc + j]);
        v = add_rn(z, mul_rn(s, sub_rn(v, z)));
      }
      y[i] = v;
    }
  }
  __syncthreads();
  stamp(a.stamps, S_WRITTEN);
}

// A kernel's attributes, set once per device at its first launch: its
// dynamic shared memory limit raised to all that the card gives a block
// beside the kernel's static shared memory, and where asked the largest
// shared-memory carveout (so that a plan's blocks an SM fit at once) or
// clusters past the portable 8 blocks. *dyn: the dynamic shared memory the
// kernel may take.
cudaError_t kernel_init(const void* fn, bool carveout, bool big_clusters, int* dyn) {
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, fn);
  auto it = known.find(key);
  if (it != known.end()) {
    *dyn = it->second;
    return cudaSuccess;
  }
  int optin = 0;
  cudaFuncAttributes fa;
  if ((e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))) return e;
  if ((e = cudaFuncGetAttributes(&fa, fn))) return e;
  const int m = optin - (int)fa.sharedSizeBytes;
  if ((e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, m))) return e;
  if (carveout && (e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                            cudaSharedmemCarveoutMaxShared)))
    return e;
  if (big_clusters &&
      (e = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)))
    return e;
  known[key] = m;
  *dyn = m;
  return cudaSuccess;
}

// Deal the units to the cluster's blocks longest first (a unit's cost: its
// outputs times its rows), each to the least-loaded block (the lowest on a
// tie); round robin where there are more units than the deal holds. Which
// block sums a unit leaves its sums as they are.
void c1_deal(C1Plan& p) {
  const int cs = p.cluster;
  long load[kMaxCluster] = {0};
  std::vector<std::pair<long, int>> units;
  for (int s = 0; s < p.n_seg; ++s) {
    const Seg& g = p.segs[s];
    for (int t = 0; t < g.units; ++t) {
      const int outs = g.row ? kC1Warps : kC1Cols;
      units.push_back({-(long)outs * g.n_k, g.unit0 + t});
    }
  }
  std::vector<std::vector<int>> mine(cs);
  if (p.units <= kMaxUnits) {
    std::stable_sort(units.begin(), units.end(),
                     [](const std::pair<long, int>& x, const std::pair<long, int>& y) {
                       return x.first < y.first;
                     });
    for (auto& u : units) {
      int best = 0;
      for (int b = 1; b < cs; ++b) best = load[b] < load[best] ? b : best;
      load[best] -= u.first;
      mine[best].push_back(u.second);
    }
  }
  int at = 0;
  for (int b = 0; b < cs; ++b) {
    p.first[b] = (short)at;
    for (int u : mine[b]) p.order[at++] = (short)u;
  }
  p.first[cs] = (short)at;
}

// C1's plan for this launch: a cluster of 16 blocks where the card runs
// one at the plan's shared memory, else 8 (the portable size), and the
// global variant where the vectors and the sums do not fit a block's
// shared memory. Chosen once per shape and dtype; the plan itself (it holds the
// operands' addresses) is made anew.
template <typename T> cudaError_t c1_shape(const C1Args& a, C1Plan& p) {
  static std::mutex mu;
  static std::map<std::vector<int>, std::pair<int, int>> known;  // cluster, global
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e) return e;
  const std::vector<int> key = {dev, a.m_res != nullptr, a.dp, a.nx, a.nc, a.nxp, a.ncp,
                                a.certs && !a.tail_mode};
  std::lock_guard<std::mutex> lock(mu);
  auto it = known.find(key);
  if (it != known.end()) {
    p = c1_plan(a, it->second.first, it->second.second);
    return cudaSuccess;
  }
  const void* fn[2] = {reinterpret_cast<const void*>(c1_kernel<T, false>),
                       reinterpret_cast<const void*>(c1_kernel<T, true>)};
  int dyn[2];
  for (int g = 0; g < 2; ++g)
    if ((e = kernel_init(fn[g], false, true, &dyn[g]))) return e;
  for (int cs = kMaxCluster;; cs = 8) {
    p = c1_plan(a, cs, false);
    if (p.smem > dyn[0]) p = c1_plan(a, cs, true);
    if (p.smem > dyn[p.global]) return cudaErrorInvalidValue;
    if (cs == 8) break;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cs, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(cs), cfg.blockDim = dim3(kC1Threads);
    cfg.dynamicSmemBytes = p.smem, cfg.attrs = &attr, cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, fn[p.global], &cfg) != cudaSuccess) {
      cudaGetLastError();
      n = 0;
    }
    if (n > 0) break;
  }
  known[key] = std::make_pair(p.cluster, p.global);
  return cudaSuccess;
}

template <typename T>
cudaError_t c1_launch(const C1Args& a, cudaStream_t stream) {
  C1Plan p;
  cudaError_t e = c1_shape<T>(a, p);
  if (e) return e;
  if (p.global && !a.part) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = p.cluster, attr.val.clusterDim.y = 1, attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(p.cluster), cfg.blockDim = dim3(kC1Threads);
  cfg.dynamicSmemBytes = p.smem, cfg.stream = stream, cfg.attrs = &attr, cfg.numAttrs = 1;
  e = p.global ? cudaLaunchKernelEx(&cfg, c1_kernel<T, true>, a, p)
               : cudaLaunchKernelEx(&cfg, c1_kernel<T, false>, a, p);
  if (e) return e;
  return cudaGetLastError();
}

// ------------------------------------------------------------------------
// C2
// ------------------------------------------------------------------------

struct C2Plan {
  int regime, rows, group, threads, grid, smem, n_parts, elt;
  int vec_ld, out_ld;        // a staged row's vectors and products
  int ncx, ncx_pad, nx_pad;  // outputs of [A; H]; "smem": their padding
  int warps, nbuf, ha;       // "stream": warps a block, buffers a warp, a buffer's elements
  int n_rt, n_cxt, n_lt;     // "tiles": row tiles, output tiles of [A; H] and of A'
  long outs_at;              // "tiles": where the products start in part (doubles)
  long lpart_at;             // "tiles": where A'lam's segment sums start
  int lpart_ld;              // "tiles": their rows' stride (whole 16-byte pieces)
  int global;                // "tiles": the global variant (vectors in scratch)
  int vl;                    // "tiles": a row's stride in the staged vectors
  long vec_at;               // "tiles", global: where the rows' vectors start
  long scratch;              // doubles of scratch a launch takes
};

// The regime and its shape for `nsm` SMs whose blocks may opt in to `optin`
// bytes of shared memory. The regime follows from nx, nc, the dtype and the
// per-problem operands alone; B sets the grid, the rows of a "tiles" row
// tile and whether a "stream" warp double-buffers.
C2Plan c2_plan(const C2Args& a, int nsm, int optin) {
  C2Plan p;
  memset(&p, 0, sizeof(p));
  const int elt = a.dtype == DT_F64 ? 8 : 4;
  const int nx = a.nx, nc = a.nc, kout = 32 / elt, B = a.B;
  p.elt = elt;
  p.out_ld = (nc + 2 * nx) * (a.certs ? 2 : 1);
  p.vec_ld = nx + 2 * nc + (a.certs ? nx + nc : 0);
  p.ncx = nc + nx;
  p.ncx_pad = (int)round_up(p.ncx, kout);
  p.nx_pad = (int)round_up(nx, kout);
  p.threads = kThreads;
  const long ha = (long)(nx + nc) * nx * elt;
  const long rest = round_up((long)(p.vec_ld + p.out_ld) * elt, 16);
  if (B == 0) {
    // no rows: one warp takes the batch's flags
    p.regime = R_STREAM;
    p.group = 32, p.warps = 1, p.threads = 32, p.grid = 1, p.n_parts = 1;
    p.smem = (int)rest;
    p.scratch = 4;
    return p;
  }
  if (!a.h_per && !a.a_per) {
    // [A; H]' (nx x ncx_pad) and A (nc x nx_pad), then 32 rows of vectors
    // and products (odd strides), where H and A first land flat
    const long ops = round_up(((long)nx * p.ncx_pad + (long)nc * p.nx_pad) * elt, 16);
    const long tile = (long)kTileRows * ((p.vec_ld | 1) + (p.out_ld | 1)) * elt;
    const long smem = ops + (tile > ha ? tile : ha);
    if (smem <= kSmemCap) {
      // 32 rows a tile, or 16 or 8 where fewer tiles would leave SMs idle
      p.regime = R_SMEM;
      p.rows = kTileRows;
      while (p.rows > 8 && (B + p.rows - 1) / p.rows < nsm) p.rows /= 2;
      p.group = kThreads / p.rows;
      const long rtile = (long)p.rows * ((p.vec_ld | 1) + (p.out_ld | 1)) * elt;
      p.smem = (int)(ops + (rtile > ha ? rtile : ha));
      const int tiles = (B + p.rows - 1) / p.rows;
      long per_sm = kSmemSM / (p.smem + 1024);  // at most 3 (its launch bounds)
      per_sm = per_sm < 1 ? 1 : (per_sm > 3 ? 3 : per_sm);
      const int cap = nsm * (int)per_sm;
      p.grid = tiles < cap ? tiles : cap;
      p.n_parts = p.grid;
      p.scratch = 4L * p.n_parts;
      return p;
    }
  } else {
    // a warp per row: its H and A (one or two buffers), vectors, products
    const long buf = round_up(ha, 16);
    long w1 = kSmemCap / (buf + rest), w2 = kSmemCap / (2 * buf + rest);
    w1 = w1 > kStreamWarps ? kStreamWarps : w1;
    w2 = w2 > kStreamWarps ? kStreamWarps : w2;
    if (w1 >= 1) {
      p.regime = R_STREAM;
      p.group = 32;
      p.ha = (int)(buf / elt);
      // one row a warp where the card holds every row's warp at once, else
      // rows in turn, the next row's copy in flight during this one's
      const long s1 = (buf + rest) * w1;
      long per_sm = kSmemSM / (s1 + 1024);
      const int blocks1 = (int)((B + w1 - 1) / w1);
      if (blocks1 <= nsm * (per_sm < 1 ? 1 : per_sm) || w2 < 1) {
        p.nbuf = 1, p.warps = (int)w1;
      } else {
        p.nbuf = 2, p.warps = (int)w2;
      }
      p.threads = 32 * p.warps;
      p.smem = (int)((p.nbuf * buf + rest) * p.warps);
      per_sm = kSmemSM / (p.smem + 1024);
      const int cap = nsm * (int)(per_sm < 1 ? 1 : per_sm);
      const int blocks = (B + p.warps - 1) / p.warps;
      p.grid = blocks < cap ? blocks : cap;
      p.n_parts = p.grid;
      p.scratch = 4L * p.n_parts;
      return p;
    }
  }
  // "tiles": row tiles of up to 16 rows (one row where the operand is per
  // problem), a block per (row tile, output tile)
  p.regime = R_TILES;
  p.rows = (a.h_per || a.a_per) ? 1 : (B < kMaxTilesRows ? B : kMaxTilesRows);
  p.group = 16;
  p.n_cxt = (p.ncx + kWarps - 1) / kWarps;
  const long lsegs = (nc + 31) / 32;
  p.n_lt = (int)(((nx + 31) / 32) * lsegs);
  const long wbuf = (long)kWarps * kTilesBuf * elt;
  for (;;) {  // fewer rows a tile where the tile does not fit
    // the rows' vectors, then the warps' coefficients (the products) or,
    // in the row tile's last block once they are done, the rows' products
    const long outs = round_up((long)p.rows * p.out_ld * elt, 16);
    p.smem = (int)(round_up((long)p.rows * (p.vec_ld | 1) * elt, 16) + std::max(outs, wbuf));
    if (p.smem <= kSmemCap || p.rows == 1) break;
    p.rows /= 2;
  }
  p.vl = p.vec_ld | 1;
  if (p.smem > optin - kTilesStatic) {
    // even one row does not fit: the global variant keeps the rows'
    // vectors and products in scratch, a block's shared memory only the
    // warps' coefficients and an A'lam block's segment of lam and dlam, so
    // the row tile takes up to 16 rows again
    p.global = 1;
    p.rows = (a.h_per || a.a_per) ? 1 : (B < kMaxTilesRows ? B : kMaxTilesRows);
    p.vl = p.vec_ld;
    p.smem = (int)(wbuf + (long)p.rows * 64 * elt);
  }
  p.n_rt = (B + p.rows - 1) / p.rows;
  p.grid = (p.n_cxt + p.n_lt) * p.n_rt;
  p.n_parts = p.n_rt;
  p.outs_at = round_up(4L * p.n_parts, 2);  // 16-byte aligned
  p.lpart_at = p.outs_at + round_up(((long)B * p.out_ld * elt + 7) / 8, 2);
  p.lpart_ld = (int)round_up(nx, 16 / elt);
  const long lparts = (long)p.n_rt * lsegs * (a.certs ? 2 : 1) * p.rows * p.lpart_ld;
  p.vec_at = round_up(p.lpart_at + (lparts * elt + 7) / 8, 2);
  p.scratch = p.vec_at + (p.global ? ((long)p.n_rt * p.rows * p.vl * elt + 7) / 8 : 0);
  return p;
}

template <typename T>
__device__ __forceinline__ const T* reff_row(const C2Args& a, int b, int ind) {
  const T* r = static_cast<const T*>(a.rho_eff);
  const size_t base = a.reff_per ? (size_t)b * a.n_rho : 0;
  return r + (base + clamp_ind(ind, a.n_rho)) * a.nc;
}

// A row's share of the batch's sums.
struct Share {
  double logr, logres, act, open;
};

// What every C2 block reads before its rows (the last block writes it).
struct C2Ctx {
  int k_new, ind_shared;
  bool walk_rows;
};

__device__ __forceinline__ C2Ctx c2_ctx(const C2Args& a) {
  C2Ctx c;
  c.k_new = *a.k + a.n_steps;
  c.ind_shared = a.shared ? clamp_ind(*a.rho_ind, a.n_rho) : 0;
  c.walk_rows = a.adaptive && !a.shared && walk_now(c.k_new, a.ci, a.stride);
  return c;
}

__device__ __forceinline__ int row_ind(const C2Args& a, const C2Ctx& c, int b) {
  return a.shared ? c.ind_shared : clamp_ind(a.rho_ind[b], a.n_rho);
}

// Row b's vectors into v in two steps. `stage_copy` starts the copies
// (cp.async, one element each: the rows have odd strides): x, z and p of
// the row of Y, and with the certificates x_prev and lam_prev where dx and
// dlam go. After the caller's wait and barrier, `stage_fix` turns p into
// lam (rho_eff (p - z) under alpha != 1) and the previous iterates into
// dx = x - x_prev and dlam = lam - lam_prev. Lanes gl, gl + G, ... of a
// group of G.
template <typename T>
__device__ __forceinline__ void cp_elem(T* dst, const T* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

template <typename T, int G>
__device__ void stage_copy(const C2Args& a, int b, T* v, int gl) {
  const int nx = a.nx, nc = a.nc, n = nx + 2 * nc;
  const T* yr = static_cast<const T*>(a.Y_in) + (size_t)b * a.dp;
  for (int i = gl; i < n; i += G) cp_elem(v + i, yr + i);
  if (a.certs) {
    const T* xp = static_cast<const T*>(a.X_prev) + (size_t)b * nx;
    const T* lp = static_cast<const T*>(a.Lam_prev) + (size_t)b * nc;
    for (int i = gl; i < nx; i += G) cp_elem(v + n + i, xp + i);
    for (int i = gl; i < nc; i += G) cp_elem(v + n + nx + i, lp + i);
  }
}

template <typename T, int G>
__device__ void stage_fix(const C2Args& a, const C2Ctx& c, int b, T* v, int gl) {
  const int nx = a.nx, nc = a.nc;
  const T* rv = a.alpha ? reff_row<T>(a, b, row_ind(a, c, b)) : nullptr;
#pragma unroll 4
  for (int i = gl; i < nc; i += G) {
    const T z = v[nx + i], pl = v[nx + nc + i];
    const T l = rv ? mul_rn(rv[i], sub_rn(pl, z)) : pl;
    v[nx + nc + i] = l;
    if (a.certs) v[2 * nx + 2 * nc + i] = sub_rn(l, v[2 * nx + 2 * nc + i]);
  }
  if (a.certs)
    for (int i = gl; i < nx; i += G) v[nx + 2 * nc + i] = sub_rn(v[i], v[nx + 2 * nc + i]);
}

// lam_i (rho_eff (p - z) under alpha != 1) of row b, from the row of Y:
// the value stage_fix forms
template <typename T>
__device__ __forceinline__ T lam_at(const C2Args& a, const T* yr, const T* rv, int i) {
  const T z = yr[a.nx + i], pl = yr[a.nx + a.nc + i];
  return rv ? mul_rn(rv[i], sub_rn(pl, z)) : pl;
}

// "tiles"' global variant: row b's vectors straight into scratch (stage_copy
// and stage_fix's values; one group of G lanes per row, so no block stages
// another's row).
template <typename T, int G>
__device__ void stage_global(const C2Args& a, const C2Ctx& c, int b, T* v, int gl) {
  const int nx = a.nx, nc = a.nc, n = nx + 2 * nc;
  const T* yr = static_cast<const T*>(a.Y_in) + (size_t)b * a.dp;
  const T* xp = a.certs ? static_cast<const T*>(a.X_prev) + (size_t)b * nx : nullptr;
  const T* lp = a.certs ? static_cast<const T*>(a.Lam_prev) + (size_t)b * nc : nullptr;
  const T* rv = a.alpha ? reff_row<T>(a, b, row_ind(a, c, b)) : nullptr;
  for (int i = gl; i < nx; i += G) {
    v[i] = yr[i];
    if (xp) v[n + i] = sub_rn(yr[i], xp[i]);
  }
  for (int i = gl; i < nc; i += G) {
    const T l = lam_at(a, yr, rv, i);
    v[nx + i] = yr[nx + i];
    v[nx + nc + i] = l;
    if (lp) v[n + nx + i] = sub_rn(l, lp[i]);
  }
}

template <typename T> struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

// A row's staged vector or product: from shared memory, or (GL, "tiles"'
// global variant) from scratch through L2, where the other blocks' stores
// are seen past the row tile's ticket.
template <bool GL, typename T> __device__ __forceinline__ T ldv(const T* p) {
  if constexpr (GL) return __ldcg(p);
  else return *p;
}

// Row b's residuals, estimate and decisions, from its vectors v and
// products out [A x | H x | A'lam | A dx | H dx | A'dlam] (shared memory),
// by an aligned group of G lanes (gl its lane); every lane of the warp takes
// part (`valid` false: no row). Writes the row's results and its new state
// row, and returns its share of the batch's sums.
template <typename T, int G, bool GL = false>
__device__ Share row_pass(const C2Args& a, const C2Ctx& c, int b, bool valid, const T* v,
                          const T* out, int gl) {
  typedef Stats<T> S;
  const int nx = a.nx, nc = a.nc, dp = a.dp;
  const bool certs = a.certs;
  const T zero = T(0);
  Stats<T> st;
  st.init();
  const T* wp = a.w_pri ? static_cast<const T*>(a.w_pri) + (a.wp_per ? (size_t)b * nc : 0)
                        : nullptr;
  const T* wd = a.w_dua ? static_cast<const T*>(a.w_dua) + (a.wd_per ? (size_t)b * nx : 0)
                        : nullptr;
  const T* gr = static_cast<const T*>(a.G) + (a.g_per ? (size_t)b * nx : 0);
  const T* lo = static_cast<const T*>(a.lo) + (size_t)b * dp + nx;
  const T* hi = static_cast<const T*>(a.hi) + (size_t)b * dp + nx;
  // the row's old results, loaded while the lanes reduce
  T* rho_b = static_cast<T*>(a.rho) + b;
  T* pri_b = static_cast<T*>(a.pri) + b;
  T* dua_b = static_cast<T*>(a.dua) + b;
  bool done_old = false;
  T rho_old = zero, pri_old = zero, dua_old = zero;
  int iters_old = 0, status_old = 0, ind = 0;
  if (valid) {
    done_old = a.done[b] != 0;
    rho_old = *rho_b, pri_old = *pri_b, dua_old = *dua_b;
    iters_old = a.iters[b], status_old = a.status[b];
    ind = row_ind(a, c, b);
  }
  const int o3 = nc + 2 * nx;
  const int n_c = valid ? nc : 0, n_x = valid ? nx : 0;
#pragma unroll 8
  for (int i = gl; i < n_c; i += G) {
    T ax = ldv<GL>(out + i), z = ldv<GL>(v + nx + i);
    if (wp) ax = mul_rn(wp[i], ax), z = mul_rn(wp[i], z);
    st.max_in(S::PRI, abs_t(sub_rn(ax, z)));
    st.max_in(S::AX, abs_t(ax));
    st.max_in(S::Z, abs_t(z));
    if (certs) {
      const T dl = ldv<GL>(v + 2 * nx + 2 * nc + i);
      st.max_in(S::DL, abs_t(dl));
      const T term = dl > zero ? mul_rn(hi[i], dl) : (dl < zero ? mul_rn(lo[i], dl) : zero);
      st.sup += static_cast<double>(term);
      const T adx = ldv<GL>(out + o3 + i);
      if (finite_t(hi[i])) st.max_in(S::RH, adx);
      if (finite_t(lo[i])) st.max_in(S::RL, -adx);
    }
  }
#pragma unroll 8
  for (int i = gl; i < n_x; i += G) {
    T hx = ldv<GL>(out + nc + i), atl = ldv<GL>(out + nc + nx + i), gi = gr[i];
    if (wd) hx = mul_rn(wd[i], hx), atl = mul_rn(wd[i], atl), gi = mul_rn(wd[i], gi);
    st.max_in(S::DUA, abs_t(add_rn(add_rn(hx, atl), gi)));
    st.max_in(S::HX, abs_t(hx));
    st.max_in(S::ATL, abs_t(atl));
    st.max_in(S::G, abs_t(gi));
    if (certs) {
      const T dxi = ldv<GL>(v + nx + 2 * nc + i);
      st.max_in(S::DX, abs_t(dxi));
      st.max_in(S::HD, abs_t(ldv<GL>(out + o3 + nc + i)));
      st.max_in(S::AT, abs_t(ldv<GL>(out + o3 + nc + nx + i)));
      st.gdx += static_cast<double>(mul_rn(gr[i], dxi));
    }
  }
  st.template reduce_lanes<G>(certs);
  Share sh = {0.0, 0.0, 0.0, 0.0};
  if (!valid) return sh;
  bool pinf = false, dinf = false;
  if (certs) st.certificates(static_cast<T>(a.eps_pinf), static_cast<T>(a.eps_dinf), pinf, dinf);
  // the row's decisions (every lane of the group alike)
  const int k_new = c.k_new;
  const T rho_new = rho_estimate(st, rho_old, a.rho_min, a.rho_max);
  const T pri = done_old ? pri_old : st.v[S::PRI];
  const T dua = done_old ? dua_old : st.v[S::DUA];
  int new_ind = ind;
  if (c.walk_rows && !done_old)
    new_ind = ladder(static_cast<const T*>(a.rhos), a.n_rho, ind, rho_new, static_cast<T>(a.tol),
                     a.jump);
  const bool newly =
      !done_old && pri < static_cast<T>(a.eps_pri) && dua < static_cast<T>(a.eps_dua);
  int iters = newly ? k_new : iters_old;
  int status = newly ? kStatSolved : status_old;
  bool done = done_old || newly;
  if (certs) {
    if (!done && pinf) status = kStatPinf, iters = k_new, done = true;
    if (!done && dinf) status = kStatDinf, iters = k_new, done = true;
  }
  const T tiny = static_cast<T>(1e-30);
  sh.act = !done_old;
  sh.open = !done;
  sh.logr = (a.adaptive && a.shared && !done_old) ? static_cast<double>(log_t(rho_new)) : 0.0;
  sh.logres =
      (a.phase_a && !done) ? static_cast<double>(log_t(nmax(add_rn(pri, dua), tiny))) : 0.0;
  // every lane of the group has read the row's old results before its
  // first lane writes them
  const unsigned mask = (0xffffffffu >> (32 - G)) << ((threadIdx.x & 31) & ~(G - 1));
  __syncwarp(mask);
  if (gl == 0) {
    *rho_b = done_old ? rho_old : rho_new;
    *pri_b = pri;
    *dua_b = dua;
    a.done[b] = done;
    a.iters[b] = iters;
    a.status[b] = status;
    if (a.adaptive && !a.shared) a.rho_ind[b] = new_ind;
  }
  // the row of the new state: y (p re-encoded for the row's new rung) and
  // the certificates' previous iterate
  const bool reencode = a.adaptive && a.alpha && !a.shared;
  const T* rv_old = reencode ? reff_row<T>(a, b, ind) : nullptr;
  const T* rv_new = reencode ? reff_row<T>(a, b, new_ind) : nullptr;
  const T* yr = static_cast<const T*>(a.Y_in) + (size_t)b * dp;
  T* yo = static_cast<T*>(a.Y) + (size_t)b * dp;
  auto fix = [&](int i, T val) -> T {
    if (reencode && i >= nx + nc && i < nx + 2 * nc) {
      const int j = i - nx - nc;
      const T z = yr[nx + j];
      val = add_rn(z, mul_rn(div_rn(rv_old[j], rv_new[j]), sub_rn(val, z)));
    }
    return val;
  };
  constexpr int V = 16 / sizeof(T);
  if (dp % V == 0) {
#pragma unroll 8
    for (int q = gl; q < dp / V; q += G) {
      Pack<T> pk = reinterpret_cast<const Pack<T>*>(yr)[q];
      if (reencode)
#pragma unroll
        for (int e = 0; e < V; ++e) pk.e[e] = fix(q * V + e, pk.e[e]);
      reinterpret_cast<Pack<T>*>(yo)[q] = pk;
    }
  } else {
    for (int i = gl; i < dp; i += G) yo[i] = fix(i, yr[i]);
  }
  if (certs) {
    T* xp = static_cast<T*>(a.X_prev) + (size_t)b * nx;
    T* lp = static_cast<T*>(a.Lam_prev) + (size_t)b * nc;
    for (int i = gl; i < nx; i += G) xp[i] = ldv<GL>(v + i);
    for (int i = gl; i < nc; i += G) lp[i] = ldv<GL>(v + nx + nc + i);
  }
  return sh;
}

// The batch's sums from the n_parts partials (four doubles each, in part)
// in a fixed order, and its flags: the grid's last block.
template <typename T>
__device__ void c2_finish(const C2Args& a, const C2Ctx& c, int n_parts) {
  __shared__ double s_q[kStreamWarps][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  double q[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x)
#pragma unroll
    for (int j = 0; j < 4; ++j) q[j] += __ldcg(a.part + 4 * (size_t)i + j);
#pragma unroll
  for (int j = 0; j < 4; ++j) q[j] = warp_sum(q[j]);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) s_q[warp][j] = q[j];
  __syncthreads();
  if (threadIdx.x != 0) return;
  double logr = 0.0, logres = 0.0, act = 0.0, open = 0.0;
  for (int w = 0; w < nw; ++w)
    logr += s_q[w][0], logres += s_q[w][1], act += s_q[w][2], open += s_q[w][3];
  stamp(a.stamps, S_REDUCED);
  const long n_act = (long)act, n_open = (long)open;
  const int k_new = c.k_new;
  const T* rhos = static_cast<const T*>(a.rhos);
  if (a.adaptive && a.shared) {
    const int ind = c.ind_shared;
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
    const T metric = div_rn(static_cast<T>(logres), static_cast<T>(n_open > 1 ? n_open : 1));
    const bool improved = metric < sub_rn(*bm, static_cast<T>(a.stall)) || n_open < *a.best_open;
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
  stamp(a.stamps, S_WRITTEN);
}

// Block (or row tile) `at`'s partial (thread 0's `s`) into part, then the
// grid's ticket; the last block finishes.
template <typename T>
__device__ void c2_close(const C2Args& a, const C2Ctx& c, int n_parts, int at, const double* s) {
  if (threadIdx.x == 0) {
    double* pb = a.part + 4 * (size_t)at;
    pb[0] = s[0], pb[1] = s[1], pb[2] = s[2], pb[3] = s[3];
  }
  if (!ticket(a.tick, n_parts)) return;
  stamp(a.stamps, S_TICKET);
  c2_finish<T>(a, c, n_parts);
}

// cp.async of n elements src -> dst (shared) by `nt` threads from thread
// `t`: 16-byte copies where both ends are 16-byte aligned, else one element
// a copy; the caller commits and waits.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src, long n, int t, int nt) {
  const unsigned d0 = (unsigned)__cvta_generic_to_shared(dst);
  const bool vec = ((uintptr_t)src % 16 == 0) && (d0 % 16 == 0);
  constexpr int V = 16 / sizeof(T);
  const long nv = vec ? n / V : 0;
  for (long q = t; q < nv; q += nt)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d0 + (unsigned)(q * 16)),
                 "l"(src + q * V));
  for (long i = nv * V + t; i < n; i += nt) {
    if (sizeof(T) == 8)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                       d0 + (unsigned)(i * sizeof(T))),
                   "l"(src + i));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       d0 + (unsigned)(i * sizeof(T))),
                   "l"(src + i));
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 32 bytes of shared memory (a micro-tile's coefficients): 8 floats or 4
// doubles, as two 16-byte loads
template <typename T>
__device__ __forceinline__ void load_pack(const T* p, T (&v)[32 / sizeof(T)]) {
  constexpr int V = 16 / sizeof(T);
  const Pack<T> lo = reinterpret_cast<const Pack<T>*>(p)[0];
  const Pack<T> hi = reinterpret_cast<const Pack<T>*>(p)[1];
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = lo.e[e], v[V + e] = hi.e[e];
}

// ---- C2 "smem" ----
// RT rows a tile (32, or 16 or 8 where the batch would not fill the card):
// lane l of a warp on row l % RT of the tile and its S = 32 / RT output
// groups; GS = 256 / RT lanes a row in the staging and the row pass.
template <typename T, int RT>
__global__ void __launch_bounds__(kThreads, 3) c2_kernel_smem(const C2Args a, const C2Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double s_share[RT][4];
  __shared__ double s_blk[4];
  constexpr int KO = 32 / sizeof(T);  // outputs a thread's micro-tile
  constexpr int S = 32 / RT, GS = kThreads / RT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = a.B, nx = a.nx, nc = a.nc;
  const int ncx_pad = p.ncx_pad, nx_pad = p.nx_pad, vl = p.vec_ld | 1, ol = p.out_ld | 1;
  const bool certs = a.certs;
  T* cxt = reinterpret_cast<T*>(smem_raw);  // [A; H]', nx x ncx_pad
  T* al = cxt + (size_t)nx * ncx_pad;       // A, nc x nx_pad
  T* region = reinterpret_cast<T*>(
      smem_raw + round_up(((long)nx * ncx_pad + (long)nc * nx_pad) * sizeof(T), 16));
  T* vec = region;                          // RT rows of vl
  T* outs = vec + (size_t)RT * vl;          // RT rows of ol
  const C2Ctx c = c2_ctx(a);
  stamp(a.stamps, S_START);
  if ((int)blockIdx.x * RT < B) {
    // H and A: a flat 16-byte copy into the tiles' space, then laid out
    // with consecutive outputs contiguous
    T* flat = region;  // A (nc x nx), then H (nx x nx): the rows of [A; H]
    copy_async(flat, static_cast<const T*>(a.A), (long)nc * nx, threadIdx.x, kThreads);
    copy_async(flat + (size_t)nc * nx, static_cast<const T*>(a.H), (long)nx * nx, threadIdx.x,
               kThreads);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int k = warp; k < nx; k += kWarps)
      for (int o = lane; o < ncx_pad; o += 32)
        cxt[(size_t)k * ncx_pad + o] = o < p.ncx ? flat[(size_t)o * nx + k] : T(0);
    for (int i = warp; i < nc; i += kWarps)
      for (int j = lane; j < nx_pad; j += 32)
        al[(size_t)i * nx_pad + j] = j < nx ? flat[(size_t)i * nx + j] : T(0);
  }
  // the tasks: KO-wide output groups of [A; H] (x, and dx; nx steps
  // each), then of A' (lam, and dlam; nc steps). Dealt longest first, each
  // to the least-loaded of the 8 S slots (warp, sub), the lowest on a tie:
  // every thread makes the same deal and keeps its slot's tasks.
  const int n_gx = ncx_pad / KO, n_gl = nx_pad / KO, o3 = nc + 2 * nx;
  constexpr int NS = kWarps * S, kMaxMine = 48;  // (ample: at most 25 a slot fit 200 KB)
  __shared__ short s_deal[NS][kMaxMine];
  __shared__ int s_nmine[NS];
  if (warp == 0) {
    // lane s is slot s; each task to the least (load, slot) by a warp min
    const bool x_first = nx >= nc;
    unsigned load = 0;
    int n = 0;
    for (int q = 0; q < n_gx + n_gl; ++q) {
      const int task = x_first ? q : (q < n_gl ? n_gx + q : q - n_gl);
      unsigned long long key =
          lane < NS ? ((unsigned long long)load << 32) | (unsigned)lane : ~0ull;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long k2 = __shfl_xor_sync(0xffffffffu, key, o);
        key = k2 < key ? k2 : key;
      }
      if ((int)(key & 0xffffffffu) == lane) {
        load += task < n_gx ? nx : nc;
        if (n < kMaxMine) s_deal[lane][n] = (short)task;
        ++n;
      }
    }
    if (lane < NS && n > kMaxMine) __trap();  // (no operand the regime takes gets here)
    if (lane < NS) s_nmine[lane] = n;
  }
  __syncthreads();
  const int my_slot = warp * S + lane / RT;
  const int n_mine = s_nmine[my_slot];
  const short* mine = s_deal[my_slot];
  double blk[4] = {0.0, 0.0, 0.0, 0.0};
  for (int tile = blockIdx.x; tile * RT < B; tile += gridDim.x) {
    const int r0 = tile * RT;
    __syncthreads();  // the layout is done, the previous tile read
    {
      const int r = threadIdx.x / GS, gl = threadIdx.x % GS;
      if (r0 + r < B) stage_copy<T, GS>(a, r0 + r, vec + (size_t)r * vl, gl);
      cp_commit();
      cp_wait<0>();
      __syncthreads();
      if (r0 + r < B) stage_fix<T, GS>(a, c, r0 + r, vec + (size_t)r * vl, gl);
    }
    __syncthreads();
    stamp(a.stamps, S_STAGED);
    {
      const int row = lane % RT;
      const T* v = vec + (size_t)row * vl;
      T* o_row = outs + (size_t)row * ol;
      for (int mi = 0; mi < n_mine; ++mi) {
        const int task = mine[mi];
        const bool xs = task < n_gx;
        const int g0 = (xs ? task : task - n_gx) * KO;
        const T* coef = xs ? cxt + g0 : al + g0;
        const int ld = xs ? ncx_pad : nx_pad, n = xs ? nx : nc;
        const T* u = v + (xs ? 0 : nx + nc);
        const T* du = v + (xs ? nx + 2 * nc : 2 * nx + 2 * nc);
        T acc[KO], dacc[KO];
#pragma unroll
        for (int e = 0; e < KO; ++e) acc[e] = dacc[e] = T(0);
        if (certs) {
          for (int k = 0; k < n; ++k) {
            T w[KO];
            load_pack(coef + (size_t)k * ld, w);
            const T uk = u[k], dk = du[k];
#pragma unroll
            for (int e = 0; e < KO; ++e) {
              acc[e] = fma_t(w[e], uk, acc[e]);
              dacc[e] = fma_t(w[e], dk, dacc[e]);
            }
          }
        } else {
#pragma unroll 2
          for (int k = 0; k < n; ++k) {
            T w[KO];
            load_pack(coef + (size_t)k * ld, w);
            const T uk = u[k];
#pragma unroll
            for (int e = 0; e < KO; ++e) acc[e] = fma_t(w[e], uk, acc[e]);
          }
        }
        // [A x | H x] at g0..., A'lam at nc + nx + g0...
        const int base = xs ? g0 : nc + nx + g0, lim = xs ? p.ncx : nx;
#pragma unroll
        for (int e = 0; e < KO; ++e) {
          if (g0 + e < lim) {
            o_row[base + e] = acc[e];
            if (certs) o_row[o3 + base + e] = dacc[e];
          }
        }
      }
    }
    __syncthreads();
    stamp(a.stamps, S_PRODUCTS);
    {
      const int r = threadIdx.x / GS, gl = threadIdx.x % GS;
      const Share sh = row_pass<T, GS>(a, c, r0 + r, r0 + r < B, vec + (size_t)r * vl,
                                       outs + (size_t)r * ol, gl);
      if (gl == 0) {
        s_share[r][0] = sh.logr, s_share[r][1] = sh.logres;
        s_share[r][2] = sh.act, s_share[r][3] = sh.open;
      }
    }
    __syncthreads();
    stamp(a.stamps, S_ROWS);
    if (warp == 0) {
      // the tile's rows (one butterfly), then the tiles in order
#pragma unroll
      for (int j = 0; j < 4; ++j) blk[j] += warp_sum(lane < RT ? s_share[lane][j] : 0.0);
    }
  }
  if (threadIdx.x == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) s_blk[j] = blk[j];
  c2_close<T>(a, c, p.n_parts, blockIdx.x, s_blk);
}

// ---- C2 "stream" ----
template <typename T>
__global__ void __launch_bounds__(kStreamWarps * 32) c2_kernel_stream(const C2Args a,
                                                                      const C2Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double s_warp[kStreamWarps][4];
  __shared__ double s_blk[4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = a.B, nx = a.nx, nc = a.nc, ncx = p.ncx, o3 = nc + 2 * nx;
  const bool certs = a.certs;
  const long rest = round_up((long)(p.vec_ld + p.out_ld) * p.elt, 16) / p.elt;
  const long per_warp = (long)p.nbuf * p.ha + rest;
  T* base = reinterpret_cast<T*>(smem_raw) + (size_t)warp * per_warp;
  T* vec = base + (size_t)p.nbuf * p.ha;
  T* out = vec + p.vec_ld;
  const C2Ctx c = c2_ctx(a);
  stamp(a.stamps, S_START);
  const T* Hg = static_cast<const T*>(a.H);
  const T* Ag = static_cast<const T*>(a.A);
  // row b's A (nc x nx), then H (nx x nx), into buf
  auto fetch = [&](int b, T* buf) {
    copy_async(buf, Ag + (a.a_per ? (size_t)b * nc * nx : 0), (long)nc * nx, lane, 32);
    copy_async(buf + (size_t)nc * nx, Hg + (a.h_per ? (size_t)b * nx * nx : 0), (long)nx * nx,
               lane, 32);
  };
  const int n_warps = gridDim.x * p.warps;
  double acc4[4] = {0.0, 0.0, 0.0, 0.0};
  int b = blockIdx.x * p.warps + warp;
  if (b < B) fetch(b, base);
  cp_commit();
  for (int it = 0; b < B; ++it, b += n_warps) {
    T* cur = base + (size_t)(p.nbuf > 1 ? (it & 1) : 0) * p.ha;
    const int nb = b + n_warps;
    stage_copy<T, 32>(a, b, vec, lane);
    cp_commit();
    // the next row's operand in flight during this row (two buffers)
    if (p.nbuf > 1 && nb < B) fetch(nb, base + (size_t)((it + 1) & 1) * p.ha);
    cp_commit();
    cp_wait<1>();
    __syncwarp();
    stage_fix<T, 32>(a, c, b, vec, lane);
    __syncwarp();
    stamp(a.stamps, S_STAGED);
    // a lane per output: the rows of [A; H] (x, and dx), then the columns
    // of A (lam, and dlam), each one chain in contraction order
    const T* Am = cur;
    const T* Hm = cur + (size_t)nc * nx;
    for (int t = lane; t < ncx + nx; t += 32) {
      T s = T(0), ds = T(0);
      if (t < ncx) {
        const T* m = t < nc ? Am + (size_t)t * nx : Hm + (size_t)(t - nc) * nx;
        const T* dxv = vec + nx + 2 * nc;
        if (certs) {
          for (int k = 0; k < nx; ++k) s = fma_t(m[k], vec[k], s), ds = fma_t(m[k], dxv[k], ds);
        } else {
#pragma unroll 4
          for (int k = 0; k < nx; ++k) s = fma_t(m[k], vec[k], s);
        }
        out[t] = s;
        if (certs) out[o3 + t] = ds;
      } else {
        const int j = t - ncx;
        const T* lv = vec + nx + nc;
        const T* dlv = vec + 2 * nx + 2 * nc;
        if (certs) {
          for (int i = 0; i < nc; ++i) {
            const T w = Am[(size_t)i * nx + j];
            s = fma_t(w, lv[i], s), ds = fma_t(w, dlv[i], ds);
          }
        } else {
#pragma unroll 4
          for (int i = 0; i < nc; ++i) s = fma_t(Am[(size_t)i * nx + j], lv[i], s);
        }
        out[nc + nx + j] = s;
        if (certs) out[o3 + nc + nx + j] = ds;
      }
    }
    __syncwarp();
    stamp(a.stamps, S_PRODUCTS);
    const Share sh = row_pass<T, 32>(a, c, b, true, vec, out, lane);
    acc4[0] += sh.logr, acc4[1] += sh.logres, acc4[2] += sh.act, acc4[3] += sh.open;
    __syncwarp();
    stamp(a.stamps, S_ROWS);
    // one buffer: the next row's copy waits for this row's products
    if (p.nbuf == 1 && nb < B) fetch(nb, cur);
  }
  cp_wait<0>();
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) s_warp[warp][j] = acc4[j];
  __syncthreads();
  if (threadIdx.x == 0) {
    double q[4] = {0.0, 0.0, 0.0, 0.0};
    for (int w = 0; w < p.warps; ++w)
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] += s_warp[w][j];
#pragma unroll
    for (int j = 0; j < 4; ++j) s_blk[j] = q[j];
  }
  c2_close<T>(a, c, p.n_parts, blockIdx.x, s_blk);
}

// ---- C2 "tiles" ----

// The row tile's decisions, by its last block (G lanes a row), then the
// grid's ticket.
template <typename T, int G, bool GL>
__device__ void tiles_rows(const C2Args& a, const C2Ctx& c, const C2Plan& p, int rt, int nr,
                           const T* vec, const T* outs) {
  __shared__ double s_share[kThreads / 8][4];
  __shared__ double s_blk[4];
  const int gl = threadIdx.x % G, r = threadIdx.x / G;
  const bool valid = r < nr;
  const int rr = valid ? r : 0;
  const Share sh = row_pass<T, G, GL>(a, c, rt * p.rows + r, valid, vec + (size_t)rr * p.vl,
                                      outs + (size_t)rr * p.out_ld, gl);
  if (gl == 0 && valid) {
    s_share[r][0] = sh.logr, s_share[r][1] = sh.logres;
    s_share[r][2] = sh.act, s_share[r][3] = sh.open;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double q[4] = {0.0, 0.0, 0.0, 0.0};
    for (int i = 0; i < nr; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] += s_share[i][j];
#pragma unroll
    for (int j = 0; j < 4; ++j) s_blk[j] = q[j];
  }
  stamp(a.stamps, S_ROWS);
  c2_close<T>(a, c, p.n_parts, rt, s_blk);
}

// GL: the global variant (the plan's `global`). The rows' vectors are not
// staged for the products: a block of [A; H] reads x and forms dx = x -
// x_prev from global memory as it goes, a block of A'lam forms its segment
// of lam and dlam in shared memory, and the row tile's last block stages
// the rows' vectors into scratch and reads the products where the blocks
// left them. Every value and every sum is the one the staged kernel forms.
template <typename T, bool GL>
__global__ void __launch_bounds__(kThreads) c2_kernel_tiles(const C2Args a, const C2Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int B = a.B, nx = a.nx, nc = a.nc, R = p.rows, o3 = nc + 2 * nx;
  const int vl = p.vl;
  const bool certs = a.certs;
  const int rt = blockIdx.y, ot = blockIdx.x;
  const int r0 = rt * R, nr = min(R, B - r0);
  // R rows of vl: in shared memory, or (GL) the row tile's in scratch
  T* vec = GL ? reinterpret_cast<T*>(a.part + p.vec_at) + (size_t)r0 * vl
              : reinterpret_cast<T*>(smem_raw);
  // the warps' coefficients; in the row tile's last block, once every
  // product is formed, the tile's products (rows of out_ld) in their place
  T* work = GL ? reinterpret_cast<T*>(smem_raw)
               : reinterpret_cast<T*>(smem_raw + round_up((long)R * vl * sizeof(T), 16));
  T* wbuf = work;
  const C2Ctx c = c2_ctx(a);
  stamp(a.stamps, S_START);
  if (!GL) {
    // every row of the tile's vectors (a warp a row)
    for (int r = warp; r < nr; r += kWarps)
      stage_copy<T, 32>(a, r0 + r, vec + (size_t)r * vl, lane);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps)
      stage_fix<T, 32>(a, c, r0 + r, vec + (size_t)r * vl, lane);
    __syncthreads();
  }
  stamp(a.stamps, S_STAGED);
  T* outs_g = reinterpret_cast<T*>(a.part + p.outs_at);
  // GL: the tile's rows of Y and of x_prev, read in place
  const T* yg = static_cast<const T*>(a.Y_in) + (size_t)r0 * a.dp;
  const T* xpg = certs ? static_cast<const T*>(a.X_prev) + (size_t)r0 * nx : nullptr;
  // a warp's coefficients, copied in with cp.async (all in flight at once)
  T* wb = wbuf + (size_t)warp * kTilesBuf;
  if (ot < p.n_cxt) {
    // a warp per output row o of [A; H]: lanes along the contraction, each
    // coefficient read once for every row of the tile
    const int o = ot * kWarps + warp;
    if (o < p.ncx) {
      const T* m = o < nc ? static_cast<const T*>(a.A) + (a.a_per ? (size_t)r0 * nc * nx : 0) +
                                (size_t)o * nx
                          : static_cast<const T*>(a.H) + (a.h_per ? (size_t)r0 * nx * nx : 0) +
                                (size_t)(o - nc) * nx;
      T acc[kMaxTilesRows], dacc[kMaxTilesRows];
#pragma unroll
      for (int r = 0; r < kMaxTilesRows; ++r) acc[r] = dacc[r] = T(0);
      for (int kc = 0; kc < nx; kc += kTilesBuf) {
        const int nk = min(kTilesBuf, nx - kc);
        for (int q = lane; q < nk; q += 32) cp_elem(wb + q, m + kc + q);
        cp_commit();
        cp_wait<0>();
        __syncwarp();
        // the lane's k = lane, lane + 32, ... in order
        for (int q = lane; q < nk; q += 32) {
          const T w = wb[q];
          const int k = kc + q;
#pragma unroll
          for (int r = 0; r < kMaxTilesRows; ++r) {
            if (r < nr) {
              const T x = GL ? yg[(size_t)r * a.dp + k] : vec[(size_t)r * vl + k];
              acc[r] = fma_t(w, x, acc[r]);
              if (certs) {
                const T dx = GL ? sub_rn(x, xpg[(size_t)r * nx + k])
                                : vec[(size_t)r * vl + nx + 2 * nc + k];
                dacc[r] = fma_t(w, dx, dacc[r]);
              }
            }
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int r = 0; r < kMaxTilesRows; ++r) {
        if (r < nr) {
          const T s = warp_sum(acc[r]);
          const T ds = certs ? warp_sum(dacc[r]) : T(0);
          if (lane == r) {
            T* og = outs_g + (size_t)(r0 + r) * p.out_ld;
            og[o] = s;
            if (certs) og[o3 + o] = ds;
          }
        }
      }
    }
  } else {
    // one 32-row segment sg of the contraction for 32 columns j of A' (a
    // lane each), the warps on the tile's rows; the segments' sums go to
    // scratch, to be added in segment order by the row tile's last block
    const int lt = ot - p.n_cxt, lsegs = (nc + 31) / 32, nd = certs ? 2 : 1;
    const int sg = lt % lsegs, j0 = (lt / lsegs) * 32, j = j0 + lane;
    const int i0 = sg * 32, ni = min(nc - i0, 32);
    const T* Am = static_cast<const T*>(a.A) + (a.a_per ? (size_t)r0 * nc * nx : 0);
    // the segment: rows i0 ... of A's columns j0 ... j0 + 31, row by row
    for (int q = threadIdx.x; q < ni * 32; q += kThreads) {
      const int i = q >> 5, cj = j0 + (q & 31);
      if (cj < nx) cp_elem(wbuf + q, Am + (size_t)(i0 + i) * nx + cj);
    }
    cp_commit();
    // GL: the segment's lam and dlam of each row (32 + 32 a row)
    T* seg = wbuf + (size_t)kWarps * kTilesBuf;
    if (GL) {
      for (int q = threadIdx.x; q < nr * 32; q += kThreads) {
        const int r = q >> 5, i = q & 31, b = r0 + r;
        if (i < ni) {
          const T* rv = a.alpha ? reff_row<T>(a, b, row_ind(a, c, b)) : nullptr;
          const T l = lam_at(a, yg + (size_t)r * a.dp, rv, i0 + i);
          seg[r * 64 + i] = l;
          if (certs)
            seg[r * 64 + 32 + i] =
                sub_rn(l, static_cast<const T*>(a.Lam_prev)[(size_t)b * nc + i0 + i]);
        }
      }
    }
    cp_wait<0>();
    __syncthreads();
    T* lpart = reinterpret_cast<T*>(a.part + p.lpart_at);
    for (int r = warp; r < nr; r += kWarps) {
      const T* lv = GL ? seg + r * 64 : vec + (size_t)r * vl + nx + nc + i0;
      const T* dlv = GL ? seg + r * 64 + 32 : vec + (size_t)r * vl + 2 * nx + 2 * nc + i0;
      T acc = T(0), dacc = T(0);
      if (j < nx) {
        for (int q = 0; q < ni; ++q) {
          const T w = wbuf[q * 32 + lane];
          acc = fma_t(w, lv[q], acc);
          if (certs) dacc = fma_t(w, dlv[q], dacc);
        }
        T* lp = lpart + ((((size_t)rt * lsegs + sg) * nd) * R + r) * p.lpart_ld + j;
        lp[0] = acc;
        if (certs) lp[(size_t)R * p.lpart_ld] = dacc;
      }
    }
  }
  __syncthreads();
  stamp(a.stamps, S_PRODUCTS);
  // the row tile's last block takes its rows' decisions
  if (!ticket(a.tick + 2 + rt, p.n_cxt + p.n_lt)) return;
  // the tile's rows' products: one flat copy from scratch, or (GL) left
  // there, the rows' vectors staged there beside them
  T* outs = GL ? outs_g + (size_t)r0 * p.out_ld : work;
  if (GL) {
    for (int r = warp; r < nr; r += kWarps)
      stage_global<T, 32>(a, c, r0 + r, vec + (size_t)r * vl, lane);
  } else {
    const T* src = outs_g + (size_t)r0 * p.out_ld;
    const long n = (long)nr * p.out_ld;
    constexpr int V = 16 / sizeof(T);
    const long nv = ((uintptr_t)src % 16 == 0 && (uintptr_t)outs % 16 == 0) ? n / V : 0;
#pragma unroll 8
    for (long q = threadIdx.x; q < nv; q += kThreads) {
      const float4 w = __ldcg(reinterpret_cast<const float4*>(src) + q);
      reinterpret_cast<float4*>(outs)[q] = w;
    }
    for (long i = nv * V + threadIdx.x; i < n; i += kThreads) outs[i] = __ldcg(src + i);
  }
  __syncthreads();
  {
    // A'lam (and A'dlam): the segments' sums in segment order
    const int lsegs = (nc + 31) / 32, nd = certs ? 2 : 1;
    const T* lpart = reinterpret_cast<const T*>(a.part + p.lpart_at) +
                     (size_t)rt * lsegs * nd * R * p.lpart_ld;
    // 16 bytes of a row a thread (the rows padded to whole 16-byte
    // pieces), up to eight segments' loads in flight at once, the sums
    // then in segment order
    constexpr int V = 16 / sizeof(T);
    const int ld = p.lpart_ld, nxv = ld / V, n_g = nd * nr * nxv;
    const size_t seg_at = (size_t)nd * R * ld;
    for (int g = threadIdx.x; g < n_g; g += kThreads) {
      const int jv = g % nxv, r = (g / nxv) % nr, d = g / (nxv * nr);
      const T* lp = lpart + ((size_t)d * R + r) * ld + jv * V;
      T sum[V];
      for (int s0 = 0; s0 < lsegs; s0 += 8) {
        float4 raw[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (s0 + u < lsegs) raw[u] = __ldcg(reinterpret_cast<const float4*>(lp + (s0 + u) * seg_at));
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (s0 + u < lsegs) {
            const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(&raw[u]);
#pragma unroll
            for (int e = 0; e < V; ++e) sum[e] = s0 + u == 0 ? pk.e[e] : add_rn(sum[e], pk.e[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int j = jv * V + e;
        if (j < nx) outs[(size_t)r * p.out_ld + (d ? o3 : 0) + nc + nx + j] = sum[e];
      }
    }
  }
  __syncthreads();
  tiles_rows<T, 16, GL>(a, c, p, rt, nr, vec, outs);
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

int sm_count() {
  int dev, nsm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  return nsm;
}

// C2's plan on the current device (its SMs and opt-in shared memory).
C2Plan c2_plan_here(const C2Args& a) {
  int dev, optin = (int)kSmemSM;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return c2_plan(a, sm_count(), optin);
}

// A C2 kernel's attributes (kernel_init, the largest carveout), and
// whether the plan's shared memory fits it.
cudaError_t c2_init(const void* fn, int smem) {
  int dyn = 0;
  cudaError_t e = kernel_init(fn, true, false, &dyn);
  if (e) return e;
  return smem > dyn ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T>
cudaError_t c2_launch(const C2Args& a, cudaStream_t stream, int* launches) {
  const C2Plan p = c2_plan_here(a);
  const int nsm = sm_count();
  cudaError_t e;
  if (p.regime == R_SMEM) {
    auto fn = p.rows == 32 ? c2_kernel_smem<T, 32>
                           : (p.rows == 16 ? c2_kernel_smem<T, 16> : c2_kernel_smem<T, 8>);
    if ((e = c2_init(reinterpret_cast<const void*>(fn), p.smem))) return e;
    fn<<<p.grid, kThreads, p.smem, stream>>>(a, p);
  } else if (p.regime == R_STREAM) {
    if ((e = c2_init(reinterpret_cast<const void*>(c2_kernel_stream<T>), p.smem))) return e;
    c2_kernel_stream<T><<<p.grid, p.threads, p.smem, stream>>>(a, p);
  } else {
    auto fn = p.global ? c2_kernel_tiles<T, true> : c2_kernel_tiles<T, false>;
    if ((e = c2_init(reinterpret_cast<const void*>(fn), p.smem))) return e;
    fn<<<dim3(p.n_cxt + p.n_lt, p.n_rt), kThreads, p.smem, stream>>>(a, p);
  }
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

// c1_check's plan into out[0..4): the scratch elements (of the state type)
// its launch takes (0, or in the global variant the sums and a region of
// vectors per block), blocks in the cluster, the global variant (0 or 1),
// dynamic shared memory bytes. Returns cudaError_t.
int c1_plan_of(const C1Args* a, long long* out) {
  if (a->dp < 1 || a->nx < 1 || a->nc < 1 || a->n_rho < 1) return (int)cudaErrorInvalidValue;
  C1Plan p;
  cudaError_t e = a->dtype == DT_F64 ? c1_shape<double>(*a, p) : c1_shape<float>(*a, p);
  if (e) return (int)e;
  out[0] = p.global ? p.vec_at + (long long)p.cluster * p.vstride : 0;
  out[1] = p.cluster, out[2] = p.global, out[3] = p.smem;
  return 0;
}

// One launch of C1 on `stream`: one cluster. Returns cudaError_t.
int c1_check(const C1Args* a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->dp < 1 || a->nx < 1 || a->nc < 1 || a->n_rho < 1) return (int)cudaErrorInvalidValue;
  if (a->dtype == DT_F32) return (int)c1_launch<float>(*a, st);
  if (a->dtype == DT_F64) return (int)c1_launch<double>(*a, st);
  return (int)cudaErrorInvalidValue;
}

// What c2_check's launch takes: out[0] scratch doubles (four per block, per
// row tile in "tiles", with the rows' products, A'lam's segment sums and in
// the global variant the rows' vectors after them), out[1] ticket ints
// (zeroed once; every launch leaves them so: the grid's ticket, the shared
// walk's old rung, and one per row tile in "tiles").
void c2_sizes(const C2Args* a, long long* out) {
  const C2Plan p = c2_plan_here(*a);
  out[0] = p.scratch;
  out[1] = 2 + (p.regime == R_TILES ? p.n_rt : 0);
}

// c2_check's plan into out[0..9): the regime (0 "smem", 1 "stream",
// 2 "tiles"), rows a tile, lanes a row in the row pass, threads a block,
// blocks, dynamic shared memory bytes, warps a block ("stream"), operand
// buffers a warp ("stream"), the global variant ("tiles": 0 or 1).
void c2_plan_of(const C2Args* a, int* out) {
  const C2Plan p = c2_plan_here(*a);
  const int v[9] = {p.regime, p.rows, p.group,  p.threads, p.grid,
                    p.smem,   p.warps, p.nbuf, p.global};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
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
