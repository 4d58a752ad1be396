// Native C++ runtime of the PyTorch port (reluqp_tpu_torch): the host-side
// fp64 weight-bank builder and a complete CPU solve loop, with a C ABI.
//
//   * rq_build_bank — fp64 weight-bank "compiler": per-ρ KKT Cholesky
//     factorization + block assembly of (W, B, b), OpenMP-parallel across
//     ladder rungs (each rung is independent).
//   * rq_solve — a complete CPU solve loop with the solver's semantics
//     (chunked iterations, ∞-norm residuals, OSQP-style ρ estimate, ±1
//     ladder walk, eps·√n exits), a second implementation for
//     cross-checking.
//
// All buffers are caller-owned numpy arrays; the library allocates only
// small scratch. This file is a copy of the JAX package's
// native/reluqp_native.cpp with the same code, built with the same flags,
// so the two libraries give the same bits.
//
// Build: reluqp_tpu_torch/native.py compiles it with g++ at first use
// (-O3 -march=native -std=c++17 -fPIC -fopenmp -shared) into
// reluqp_tpu_torch/_build/ and loads it with ctypes.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// ---- dense helpers (row-major) -------------------------------------------

// C (m x n) = A (m x k) @ B (k x n), accumulate if beta=1.
void gemm(const double* A, const double* B, double* C, int m, int k, int n,
          bool accumulate = false) {
  if (!accumulate) std::memset(C, 0, sizeof(double) * m * n);
  for (int i = 0; i < m; ++i) {
    const double* Ai = A + (size_t)i * k;
    double* Ci = C + (size_t)i * n;
    for (int p = 0; p < k; ++p) {
      const double a = Ai[p];
      if (a == 0.0) continue;
      const double* Bp = B + (size_t)p * n;
      for (int j = 0; j < n; ++j) Ci[j] += a * Bp[j];
    }
  }
}

// y (m) = A (m x n) @ x (n)
void gemv(const double* A, const double* x, double* y, int m, int n) {
  for (int i = 0; i < m; ++i) {
    const double* Ai = A + (size_t)i * n;
    double s = 0.0;
    for (int j = 0; j < n; ++j) s += Ai[j] * x[j];
    y[i] = s;
  }
}

double inf_norm(const double* v, int n) {
  double m = 0.0;
  for (int i = 0; i < n; ++i) {
    double a = std::fabs(v[i]);
    if (a > m) m = a;
  }
  return m;
}

// In-place lower Cholesky of SPD M (n x n). Returns 0 on success.
int cholesky(double* M, int n) {
  for (int j = 0; j < n; ++j) {
    double d = M[(size_t)j * n + j];
    for (int k = 0; k < j; ++k) d -= M[(size_t)j * n + k] * M[(size_t)j * n + k];
    if (d <= 0.0) return -1;
    const double dj = std::sqrt(d);
    M[(size_t)j * n + j] = dj;
    for (int i = j + 1; i < n; ++i) {
      double s = M[(size_t)i * n + j];
      for (int k = 0; k < j; ++k)
        s -= M[(size_t)i * n + k] * M[(size_t)j * n + k];
      M[(size_t)i * n + j] = s / dj;
    }
  }
  return 0;
}

// Solve L Lᵀ X = I into Kinv (n x n) given Cholesky factor L (lower, in M).
void cholesky_inverse(const double* L, double* Kinv, int n) {
  std::vector<double> col(n);
  for (int c = 0; c < n; ++c) {
    // forward solve L y = e_c
    for (int i = 0; i < n; ++i) {
      double s = (i == c) ? 1.0 : 0.0;
      for (int k = 0; k < i; ++k) s -= L[(size_t)i * n + k] * col[k];
      col[i] = s / L[(size_t)i * n + i];
    }
    // backward solve Lᵀ x = y
    for (int i = n - 1; i >= 0; --i) {
      double s = col[i];
      for (int k = i + 1; k < n; ++k) s -= L[(size_t)k * n + i] * col[k];
      col[i] = s / L[(size_t)i * n + i];
    }
    for (int i = 0; i < n; ++i) Kinv[(size_t)i * n + c] = col[i];
  }
}

}  // namespace

extern "C" {

struct RQInfo {
  int32_t iters;
  int32_t status;  // 1 = solved, 0 = max_iters_reached
  int32_t rho_ind;
  double pri_res;
  double dua_res;
  double rho_estimate;
  double obj_val;
};

int rq_version() { return 10; }  // 0.1.0

// Build the fp64 weight bank over the ρ ladder.
//   H (nx x nx), A (nc x nx), g (nx), eq_mask (nc), rhos (n_rho), sigma
//   W_out (n_rho x D x D), B_out (n_rho x D x nx), b_out (n_rho x D)
// with D = nx + 2 nc. Equality rows get rho * 1e3 (reference
// reluqpth.py:54); rho_cap bounds the per-row effective rho (precision-
// aware cap, see core/bank.py:auto_rho_cap — pass +inf to disable).
// Returns 0 on success, -1 if a KKT matrix was not SPD.
int rq_build_bank(const double* H, const double* A, const double* g,
                  const uint8_t* eq_mask, const double* rhos, int n_rho,
                  int nx, int nc, double sigma, double rho_cap,
                  double* W_out, double* B_out, double* b_out) {
  const int D = nx + 2 * nc;
  int fail = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic)
#endif
  for (int r = 0; r < n_rho; ++r) {
    std::vector<double> rho_vec(nc);
    for (int i = 0; i < nc; ++i) {
      const double rv = eq_mask[i] ? rhos[r] * 1e3 : rhos[r];
      rho_vec[i] = rv < rho_cap ? rv : rho_cap;
    }

    // M = H + sigma I + Aᵀ R A
    std::vector<double> M((size_t)nx * nx);
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j) {
        double s = H[(size_t)i * nx + j];
        if (i == j) s += sigma;
        for (int c = 0; c < nc; ++c)
          s += A[(size_t)c * nx + i] * rho_vec[c] * A[(size_t)c * nx + j];
        M[(size_t)i * nx + j] = s;
      }
    if (cholesky(M.data(), nx) != 0) {
#ifdef _OPENMP
#pragma omp atomic write
#endif
      fail = -1;
      continue;
    }
    std::vector<double> K((size_t)nx * nx);
    cholesky_inverse(M.data(), K.data(), nx);

    // KAt (nx x nc) = K Aᵀ ;  AK = (KAt)ᵀ (K symmetric)
    std::vector<double> KAt((size_t)nx * nc);
    for (int i = 0; i < nx; ++i)
      for (int c = 0; c < nc; ++c) {
        double s = 0.0;
        for (int j = 0; j < nx; ++j)
          s += K[(size_t)i * nx + j] * A[(size_t)c * nx + j];
        KAt[(size_t)i * nc + c] = s;
      }
    // KAtR = KAt * diag(rho)
    std::vector<double> KAtR((size_t)nx * nc);
    for (int i = 0; i < nx; ++i)
      for (int c = 0; c < nc; ++c)
        KAtR[(size_t)i * nc + c] = KAt[(size_t)i * nc + c] * rho_vec[c];
    // S = sigma K − KAtR A   (nx x nx)
    std::vector<double> S((size_t)nx * nx);
    gemm(KAtR.data(), A, S.data(), nx, nc, nx);
    for (size_t i = 0; i < (size_t)nx * nx; ++i)
      S[i] = sigma * K[i] - S[i];
    // AS = A S (nc x nx);  AKAt = A KAt (nc x nc)
    std::vector<double> AS((size_t)nc * nx);
    gemm(A, S.data(), AS.data(), nc, nx, nx);
    std::vector<double> AKAt((size_t)nc * nc);
    gemm(A, KAt.data(), AKAt.data(), nc, nx, nc);

    double* W = W_out + (size_t)r * D * D;
    double* B = B_out + (size_t)r * D * nx;
    double* b = b_out + (size_t)r * D;
    std::memset(W, 0, sizeof(double) * D * D);

    // Row block 0 (x-rows): [S, 2 KAtR, −KAt]
    for (int i = 0; i < nx; ++i) {
      double* Wi = W + (size_t)i * D;
      for (int j = 0; j < nx; ++j) Wi[j] = S[(size_t)i * nx + j];
      for (int c = 0; c < nc; ++c) {
        Wi[nx + c] = 2.0 * KAtR[(size_t)i * nc + c];
        Wi[nx + nc + c] = -KAt[(size_t)i * nc + c];
      }
    }
    // Row block 1 (z-rows): [AS + A, 2 AKAt R − I, −AKAt + R⁻¹]
    for (int c = 0; c < nc; ++c) {
      double* Wi = W + (size_t)(nx + c) * D;
      for (int j = 0; j < nx; ++j)
        Wi[j] = AS[(size_t)c * nx + j] + A[(size_t)c * nx + j];
      for (int c2 = 0; c2 < nc; ++c2) {
        Wi[nx + c2] = 2.0 * AKAt[(size_t)c * nc + c2] * rho_vec[c2]
                      - (c == c2 ? 1.0 : 0.0);
        Wi[nx + nc + c2] = -AKAt[(size_t)c * nc + c2]
                           + (c == c2 ? 1.0 / rho_vec[c2] : 0.0);
      }
    }
    // Row block 2 (λ-rows): [R A, −R, I]
    for (int c = 0; c < nc; ++c) {
      double* Wi = W + (size_t)(nx + nc + c) * D;
      for (int j = 0; j < nx; ++j) Wi[j] = rho_vec[c] * A[(size_t)c * nx + j];
      Wi[nx + c] = -rho_vec[c];
      Wi[nx + nc + c] = 1.0;
    }
    // B = [−K; −AK; 0];  b = B g
    for (int i = 0; i < nx; ++i)
      for (int j = 0; j < nx; ++j)
        B[(size_t)i * nx + j] = -K[(size_t)i * nx + j];
    for (int c = 0; c < nc; ++c)
      for (int j = 0; j < nx; ++j)
        B[(size_t)(nx + c) * nx + j] = -KAt[(size_t)j * nc + c];
    for (int i = 0; i < nc; ++i)
      std::memset(B + (size_t)(nx + nc + i) * nx, 0, sizeof(double) * nx);
    gemv(B, g, b, D, nx);
  }
  return fail;
}

// Full CPU solve loop; semantics match the solver's window loop
// (core/iteration.py) and the reference solve (reluqpth.py:201-249).
// y (D) is the in/out warm-start state.
int rq_solve(const double* H, const double* A, const double* g,
             const double* l, const double* u, const double* W_bank,
             const double* b_bank, const double* rhos, int n_rho, int nx,
             int nc, int max_iter, int check_interval, double eps_abs,
             double adaptive_rho_tol, int adaptive_rho, double rho_min,
             double rho_max, int rho_ind0, double* y, RQInfo* info) {
  const int D = nx + 2 * nc;
  std::vector<double> y_new(D), t1(nc), t2(nx), t3(nx), resid(nc > nx ? nc : nx);
  int rho_ind = rho_ind0;
  double rho = rhos[rho_ind];
  const double eps_pri = eps_abs * std::sqrt((double)nc);
  const double eps_dua = eps_abs * std::sqrt((double)nx);
  const double tiny = 1e-30;
  double pri = 0.0, dua = 0.0;
  int k = 0;
  int solved = 0;

  while (k < max_iter) {
    int steps = check_interval;
    if (k + steps > max_iter) steps = max_iter - k;
    const double* W = W_bank + (size_t)rho_ind * D * D;
    const double* b = b_bank + (size_t)rho_ind * D;
    for (int s = 0; s < steps; ++s) {
      gemv(W, y, y_new.data(), D, D);
      for (int i = 0; i < D; ++i) y_new[i] += b[i];
      for (int c = 0; c < nc; ++c) {
        double v = y_new[nx + c];
        if (v < l[c]) v = l[c];
        if (v > u[c]) v = u[c];
        y_new[nx + c] = v;
      }
      std::memcpy(y, y_new.data(), sizeof(double) * D);
    }
    k += steps;

    // residuals (reference compute_residuals, reluqpth.py:307-318)
    const double* x = y;
    const double* z = y + nx;
    const double* lam = y + nx + nc;
    gemv(A, x, t1.data(), nc, nx);                      // A x
    gemv(H, x, t2.data(), nx, nx);                      // H x
    for (int j = 0; j < nx; ++j) {                      // Aᵀ λ
      double s = 0.0;
      for (int c = 0; c < nc; ++c) s += A[(size_t)c * nx + j] * lam[c];
      t3[j] = s;
    }
    pri = 0.0;
    for (int c = 0; c < nc; ++c)
      pri = std::max(pri, std::fabs(t1[c] - z[c]));
    dua = 0.0;
    for (int j = 0; j < nx; ++j)
      dua = std::max(dua, std::fabs(t2[j] + t3[j] + g[j]));
    const double sp = std::max(inf_norm(t1.data(), nc), inf_norm(z, nc));
    const double sd = std::max(std::max(inf_norm(t2.data(), nx),
                                        inf_norm(t3.data(), nx)),
                               inf_norm(g, nx));
    const double num = pri / std::max(sp, tiny);
    const double den = dua / std::max(sd, tiny);
    double rho_new = rho * std::sqrt(num / std::max(den, tiny));
    if (rho_new < rho_min) rho_new = rho_min;
    if (rho_new > rho_max) rho_new = rho_max;
    rho = rho_new;

    if (adaptive_rho) {
      const double rho_k = rhos[rho_ind];
      if (rho_new > rho_k * adaptive_rho_tol && rho_ind < n_rho - 1)
        ++rho_ind;
      else if (rho_new < rho_k / adaptive_rho_tol && rho_ind > 0)
        --rho_ind;
    }
    if (pri < eps_pri && dua < eps_dua) {
      solved = 1;
      break;
    }
  }

  if (info) {
    info->iters = solved ? k : max_iter;
    info->status = solved;
    info->rho_ind = rho_ind;
    info->pri_res = pri;
    info->dua_res = dua;
    info->rho_estimate = rho;
    double obj = 0.0;
    gemv(H, y, t2.data(), nx, nx);
    for (int j = 0; j < nx; ++j) obj += 0.5 * y[j] * t2[j] + g[j] * y[j];
    info->obj_val = obj;
  }
  return 0;
}

}  // extern "C"
