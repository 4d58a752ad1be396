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
// Exchanges, with no grid barrier but the launch's first (gather_tagged):
// each block stores its new y lanes as tagged words every iteration, and
// every block reads all of them as their tags show. Cross-block decisions:
// each block stores its partial maxima as one tagged row of kPartCols (K2:
// its u lanes after the G rows) and every block reduces all G rows as they
// arrive. A max is exact in any order, so every block reaches bit-identical
// pri, dua, rho, rung and status and takes identical branches around every
// exchange -- or a block would poll for words no other block writes. (The
// grid-barrier exchange through `ybuf` and `part` below is reached by no
// kernel: both pass their tagged words. It stays because K3's compiled
// code moves without it, and its one-iteration solve took 7% longer on the
// H100, PERF.md section 6.) The certificates' two sums (the support
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

// K3's stage stamps (a null pointer in K2 and on every solve path;
// ops/solve_kernel.py K3_STAGES names the slots): K3S_PRE is written by a
// one-thread kernel launched just before K3, K3S_START takes the earliest
// block's start and K3S_END the latest block's end (%globaltimer, ns), and
// every other slot sums block 0's time in that stage over the launch.
enum {
  K3S_PRE = 0, K3S_START, K3S_STAGED, K3S_BIAS, K3S_ITER, K3S_EXCH, K3S_CHECK, K3S_REDUCE,
  K3S_END, kK3Slots
};
// K2's stamps (ops/solve_kernel.py K2_STAGES): the slots above, where the
// loop's stages land, then K2's own stages of a control step, the steps
// run, and block 0's grid barriers by the end of step 0 and in all.
enum {
  K2S_REFRESH = kK3Slots, K2S_PLANT, K2S_XEXCH, K2S_STEPS, K2S_SYNC_FIRST, K2S_SYNCS, kK2Slots
};

__device__ __forceinline__ unsigned long long gtimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

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

// Staging: one element global -> shared with cp.async (4- or 8-byte
// elements), committed in groups that the caller waits for in turn.
template <typename MT>
__device__ __forceinline__ void cpa_elem(MT* dst, const MT* src) {
  static_assert(sizeof(MT) == 4 || sizeof(MT) == 8, "cp.async copies 4 or 8 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (sizeof(MT) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cpa_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cpa_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// n elements of a vector into shared memory.
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cpa_elem(dst + i, src + i);
}

// Copy columns [col0, col0 + ncols) of a row-major (rows, ld) matrix into
// dst[c * rows + i], and return the accessor; or return the global one.
// Each thread takes one column and every (kThreads / ncols)-th row (no
// division per element), and every copy is in flight at once: cp.async for
// 4- and 8-byte elements (the caller commits and waits), a batch of loads
// into registers before their stores for bf16.
template <typename MT>
__device__ Cols<MT> stage_cols(MT* dst, const MT* src, int rows, int ld, int col0, int ncols,
                               bool resident) {
  if (!resident) return Cols<MT>{src + col0, ld, 1};
  if (ncols > 0) {
    const int per = kThreads / ncols, c = threadIdx.x % ncols, i0 = threadIdx.x / ncols;
    const MT* s = src + col0 + c;
    MT* d = dst + (size_t)c * rows;
    if (i0 < per) {
      if constexpr (sizeof(MT) == 4 || sizeof(MT) == 8) {
        for (int i = i0; i < rows; i += per) cpa_elem(d + i, s + (size_t)i * ld);
      } else {
        constexpr int kB = 8;
        for (int i = i0; i < rows; i += kB * per) {
          MT v[kB];
#pragma unroll
          for (int u = 0; u < kB; ++u)
            if (i + u * per < rows) v[u] = s[(size_t)(i + u * per) * ld];
#pragma unroll
          for (int u = 0; u < kB; ++u)
            if (i + u * per < rows) d[i + u * per] = v[u];
        }
      }
    }
  }
  return Cols<MT>{dst, 1, rows};
}

// The exchange without a grid barrier (K2 and K3): a value and the tag of
// the exchange that wrote it in one 64-bit word (an fp64 value takes two
// words, each of its halves beside the tag), stored and read whole with
// relaxed gpu-scope accesses, so a reader that sees the tag sees the value.
// Each kind of exchange (y; the checks' partials, with K2's u beside them;
// K2's x+) has its own two slots, which its exchanges take in turn by the
// ordinal of the exchange within its kind; the tag (1 or 2, bit 1 of the
// ordinal) tells a slot's value from the one two exchanges before it and
// from the zeros the launch starts the slots with. In every exchange each
// block writes its own words and reads every block's, and it writes those
// of exchange n + 1 of a kind only after it has read all of exchange n. So
// a block that writes exchange n + 2 into the slot of exchange n has read
// every block's n + 1, which every block wrote only after it had read n:
// no block overwrites a value another block has yet to read. That holds
// for any number of windows in a step and of steps in a launch.
template <typename T> struct TagWords {
  static constexpr int n = sizeof(T) / 4;
};

__device__ __forceinline__ void st_word(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ uint64_t ld_word(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t xtag(int ordinal) { return 1u + ((ordinal >> 1) & 1); }

__device__ __forceinline__ void put_tagged(uint64_t* w, float v, uint32_t tag) {
  st_word(w, ((uint64_t)tag << 32) | __float_as_uint(v));
}
__device__ __forceinline__ void put_tagged(uint64_t* w, double v, uint32_t tag) {
  const uint64_t b = (uint64_t)__double_as_longlong(v);
  st_word(w, ((uint64_t)tag << 32) | (b & 0xffffffffull));
  st_word(w + 1, ((uint64_t)tag << 32) | (b >> 32));
}
__device__ __forceinline__ void untag(const uint64_t* q, float& v) {
  v = __uint_as_float((uint32_t)q[0]);
}
__device__ __forceinline__ void untag(const uint64_t* q, double& v) {
  v = __longlong_as_double((long long)((q[1] << 32) | (q[0] & 0xffffffffull)));
}

// All n tagged values at src into put(i, value), by the block's threads:
// one value a thread, polled in a tight loop until its tag shows; or, where
// a thread has more, its values (up to eight at a time) loaded at once and
// every one whose tag is not there yet loaded again at once, until all are
// (one value after the other took a round trip each at Dp >= 640; the
// rounds took longer than the tight loop at Dp = 256, on the H100).
template <typename T, typename F>
__device__ __forceinline__ void gather_tagged(const uint64_t* src, int n, uint32_t tag, F put) {
  constexpr int N = TagWords<T>::n, K = 8;
  if (n <= kThreads) {
    if (threadIdx.x < n) {
      const uint64_t* w = src + (size_t)threadIdx.x * N;
      uint64_t q[N];
      for (;;) {
        bool ok = true;
#pragma unroll
        for (int m = 0; m < N; ++m) q[m] = ld_word(w + m);
#pragma unroll
        for (int m = 0; m < N; ++m) ok = ok && (uint32_t)(q[m] >> 32) == tag;
        if (ok) break;
      }
      T v;
      untag(q, v);
      put(threadIdx.x, v);
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < n; i0 += K * kThreads) {
    uint64_t q[K][N];
    unsigned need = 0;
#pragma unroll
    for (int u = 0; u < K; ++u)
      if (i0 + u * kThreads < n) need |= 1u << u;
    while (need) {
#pragma unroll
      for (int u = 0; u < K; ++u)
        if (need >> u & 1)
#pragma unroll
          for (int m = 0; m < N; ++m) q[u][m] = ld_word(src + (size_t)(i0 + u * kThreads) * N + m);
#pragma unroll
      for (int u = 0; u < K; ++u) {
        if (!(need >> u & 1)) continue;
        bool ok = true;
#pragma unroll
        for (int m = 0; m < N; ++m) ok = ok && (uint32_t)(q[u][m] >> 32) == tag;
        if (!ok) continue;
        T v;
        untag(q[u], v);
        put(i0 + u * kThreads, v);
        need &= ~(1u << u);
      }
    }
  }
}

// How a dot product accumulates. AccState<T> (K2): in the state type, with
// fused multiply-adds. AccF64 (K3): in fp64 with each product and each sum
// rounded on its own, in an fp32 run too; then the fp32 result depends on
// nothing but the order of the sum, and that order (below) is one that the
// plain version reproduces step for step, so the two agree bit for bit.
// kBatch: the products of that many terms are formed before they are added
// (in order), so their loads and conversions are not on the sum's chain.
// kU: the loop carries K2's u = y @ S_u - Kx, exchanged beside the checks'
// partials (compiled out of K3's loop).
template <typename T>
struct AccState {
  using type = T;
  static constexpr int kBatch = 1;
  static constexpr bool kU = true;
  static __device__ __forceinline__ T mac(T a, T x, T y) { return a + x * y; }
  static __device__ __forceinline__ T add(T a, T b) { return a + b; }
};
struct AccF64 {
  using type = double;
  static constexpr int kBatch = 8;
  static constexpr bool kU = false;
  static __device__ __forceinline__ double mul(double x, double y) { return __dmul_rn(x, y); }
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
  constexpr int B = Acc::kBatch;
  AT a = AT(0);
  int i = lane;
  if constexpr (B > 1) {
    for (; i + 32 * (B - 1) < n; i += 32 * B) {
      AT pr[B];
#pragma unroll
      for (int u = 0; u < B; ++u)
        pr[u] = Acc::mul(static_cast<AT>(v[i + 32 * u]), cvt<AT>(col[(size_t)(i + 32 * u) * si]));
#pragma unroll
      for (int u = 0; u < B; ++u) a = Acc::add(a, pr[u]);
    }
  }
  for (; i < n; i += 32) a = Acc::mac(a, static_cast<AT>(v[i]), cvt<AT>(col[(size_t)i * si]));
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
  // K2: u = y @ S_u - Kx on this block's n_u lanes from u_lo, computed with
  // every window's residuals (n_u = 0 in K3; u_out is set by no kernel)
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
  // the stage stamps (null: off) and block 0's last stage boundary
  unsigned long long* stamps;
  unsigned long long mark;
  // the exchange (ybuf and part: the barrier exchange no kernel takes):
  // tagged words of y (two slots of dp values) and of the checks' partials
  // (two slots of G rows of kPartCols, K2's nup u values after them), the
  // exchanges of each so far, and whether the check's operands are still
  // in flight (K3's first window)
  uint64_t *yx, *px;
  int n_ystep, n_check, in_flight;
  // the launch's one grid barrier still owed (before the first exchange,
  // once every block has cleared its words), and, in K3, y in fp64 for the
  // products (y itself in an fp64 run), so that each factor of y is
  // converted once an iteration, not once a column
  int first_sync;
  double* ysd;
  // K2: the u values in a partials slot (nup), where every block gathers
  // all of u (uv), and the grid barriers this block has taken
  int nup;
  T* uv;
  int n_sync;
};

// A product of y with one column: from the fp64 copy of y where there is
// one (K3; the same products and sums), else from y.
template <typename T, typename WT, typename Acc, typename MT>
__device__ __forceinline__ float ydot(const Loop<T, WT, Acc>& s, const MT* col, int si, int lane) {
  if constexpr (Acc::kBatch > 1)
    if (s.ysd) return dot32<Acc, double, MT>(s.ysd, col, si, s.dp, lane);
  return dot32<Acc, T, MT>(s.ys, col, si, s.dp, lane);
}

// y[i] = v, and its fp64 copy where K3 keeps one apart.
template <typename T, typename WT, typename Acc>
__device__ __forceinline__ void set_y(const Loop<T, WT, Acc>& s, int i, T v) {
  s.ys[i] = v;
  if constexpr (sizeof(T) == 4)
    if (s.ysd) s.ysd[i] = static_cast<double>(v);
}

// The stage that ends here into stamps[slot] (block 0, after a block
// barrier so that its slowest warp is counted); nothing when stamps are off.
template <typename T, typename WT, typename Acc>
__device__ __forceinline__ void lap(Loop<T, WT, Acc>& s, int slot) {
  if (!s.stamps) return;
  __syncthreads();
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const unsigned long long now = gtimer();
    s.stamps[slot] += now - s.mark;
    s.mark = now;
  }
}

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
  constexpr bool kU = Acc::kU;
  const int dp = s.dp, ncp = s.ncp, nplp = s.nplp;
  const Range ry = s.ry, rc = s.rc, rv = s.rv;
  const int k_idx = st.k_idx;
  constexpr int N = TagWords<T>::n;  // tagged words a value (K3)
  if (k_idx != s.resident_rung) {
    __syncthreads();
    s.wc = stage_cols(s.w_slab, s.wt + (size_t)k_idx * dp * dp, dp, dp, ry.lo, ry.n,
                      s.resident);
    if (s.xv)
      s.mac = stage_cols(s.ma_slab, s.m_aff + (size_t)k_idx * nplp * dp, nplp, dp, ry.lo,
                         ry.n, s.resident);
    cpa_commit();
    cpa_wait<0>();
    s.resident_rung = k_idx;
    __syncthreads();
    lap(s, K3S_STAGED);
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
  lap(s, K3S_BIAS);
  {
    // the hot loop reads its operands from locals, not through `s`
    const Cols<WT> wc = s.wc;
    T* const ys = s.ys;
    const T *const b_s = s.b_s, *const lo_s = s.lo_s, *const hi_s = s.hi_s;
    int parity = s.parity;
    for (int it = 0; it < n_steps; ++it) {
      T* dst = s.ybuf + (size_t)parity * dp;
      parity ^= 1;
      // K3: this iteration's slot of tagged words and its tag
      uint64_t* xs = s.yx ? s.yx + (size_t)(s.n_ystep & 1) * dp * N : nullptr;
      const uint32_t tag = xtag(s.n_ystep);
      for (int p = warp; p < ry.n; p += kWarps) {
        const float r = tier == TIER_HIGHEST ? ydot(s, wc.col(p), wc.si, lane)
                                             : iter_dot<Acc, T, WT>(ys, wc.col(p), wc.si, dp,
                                                                    lane, tier);
        if (lane == 0) {
          T v = static_cast<T>(r) + b_s[p];
          // comparisons (not fmin/fmax) so a NaN propagates like jnp.clip
          v = v < lo_s[p] ? lo_s[p] : v;
          v = v > hi_s[p] ? hi_s[p] : v;
          if (xs) put_tagged(xs + (size_t)(ry.lo + p) * N, v, tag);
          else dst[ry.lo + p] = v;
        }
      }
      lap(s, K3S_ITER);
      if (xs) {
        // every block reads each value as soon as its tag is there
        __syncthreads();
        if (s.first_sync) {
          grid.sync();
          if constexpr (kU) ++s.n_sync;
          s.first_sync = 0;
        }
        gather_tagged<T>(xs, dp, tag, [&](int i, T v) { set_y(s, i, v); });
        ++s.n_ystep;
      } else {
        grid.sync();
        for (int i = threadIdx.x; i < dp; i += kThreads) ys[i] = __ldcg(dst + i);
      }
      __syncthreads();
      lap(s, K3S_EXCH);
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

  if (s.in_flight) {
    // K3's first window: the check's operands have arrived
    cpa_wait<0>();
    __syncthreads();
    s.in_flight = 0;
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
      // K2's u lanes, published beside this block's partials
      q -= n_all;
      const T v0 = static_cast<T>(ydot(s, s.msu.col(q), s.msu.si, lane));
      if constexpr (kU) {
        if (lane == 0)
          put_tagged(s.px + ((size_t)(s.n_check & 1) * (gridDim.x * kPartCols + s.nup) +
                             gridDim.x * kPartCols + s.u_lo + q) * N,
                     v0 - s.kx[q], xtag(s.n_check));
      } else {
        if (lane == 0) s.u_out[s.u_lo + q] = v0 - s.kx[q];
      }
      continue;
    }
    if (q < rc.n) {
      r = ydot(s, s.mra.col(q), s.mra.si, lane);
    } else if ((q -= rc.n) < rc.n) {
      r = ydot(s, s.mrz.col(q), s.mrz.si, lane);
    } else if ((q -= rc.n) < rv.n) {
      r = ydot(s, s.mrh.col(q), s.mrh.si, lane);
    } else if ((q -= rv.n) < rv.n) {
      r = s.alpha ? dot32<Acc, T>(s.lam_s, s.maw.col(q), s.maw.si, ncp, lane)
                  : ydot(s, s.mrl.col(q), s.mrl.si, lane);
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
  lap(s, K3S_CHECK);
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
    const double pv[kPartCols] = {p_pri, static_cast<double>(p_dua), p_sp,
                                  static_cast<double>(p_sd), p_atdl, p_hdx, p_bad, 0.0};
    if (s.px) {
      // every column (each value exact in T), tagged for this check
      uint64_t* pw = kU ? s.px + ((size_t)(s.n_check & 1) * (gridDim.x * kPartCols + s.nup) +
                                  blockIdx.x * kPartCols) * N
                        : s.px + ((size_t)(s.n_check & 1) * gridDim.x + blockIdx.x) * kPartCols * N;
#pragma unroll
      for (int c = 0; c < kPartCols; ++c)
        put_tagged(pw + (size_t)c * N, static_cast<T>(pv[c]), xtag(s.n_check));
    } else {
      double* pp = s.part + (size_t)blockIdx.x * kPartCols;
#pragma unroll
      for (int c = 0; c < kPartCols - 1; ++c) pp[c] = pv[c];
    }
  }
  // the certificate columns only where this window wrote them
  const int n_cols = certs ? 7 : 4;
  // the columns' maxima over the blocks (thread 0's), exact in any order
  double m[kPartCols];
#pragma unroll
  for (int c = 0; c < kPartCols; ++c) m[c] = 0.0;
  if (s.px) {
    // every block gathers every block's tagged partials, a thread on one
    // column (kPartCols divides kThreads) and every 32nd block, and K2's u
    // with them
    __shared__ double red[kWarps][kPartCols];
    const int col = threadIdx.x % kPartCols;
    double mc = 0.0;
    if constexpr (kU) {
      const int n_part = (int)gridDim.x * kPartCols;
      const uint64_t* pw = s.px + (size_t)(s.n_check & 1) * (n_part + s.nup) * N;
      gather_tagged<T>(pw, n_part + s.nup, xtag(s.n_check), [&](int i, T v) {
        if (i >= n_part) s.uv[i - n_part] = v;
        else if (col < n_cols) mc = nmax(mc, static_cast<double>(v));
      });
    } else {
      const uint64_t* pw = s.px + (size_t)(s.n_check & 1) * gridDim.x * kPartCols * N;
      gather_tagged<T>(pw, (int)gridDim.x * kPartCols, xtag(s.n_check), [&](int, T v) {
        if (col < n_cols) mc = nmax(mc, static_cast<double>(v));
      });
    }
    ++s.n_check;
#pragma unroll
    for (int off = kPartCols; off < 32; off <<= 1)
      mc = nmax(mc, __shfl_xor_sync(0xffffffffu, mc, off));
    if (lane < kPartCols) red[warp][lane] = mc;
    __syncthreads();
    if (threadIdx.x == 0)
      for (int w = 0; w < kWarps; ++w)
#pragma unroll
        for (int c = 0; c < kPartCols; ++c) m[c] = nmax(m[c], red[w][c]);
  } else {
    grid.sync();
    if (warp == 0) {
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
    }
  }
  {
    if (threadIdx.x == 0) {
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
      set_y(s, s.nx + s.nc + i, s.ys[s.nx + s.nc + i] + static_cast<T>(static_cast<float>(corr)));
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
  lap(s, K3S_REDUCE);
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
