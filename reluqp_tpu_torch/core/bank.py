"""Weight-bank construction: the setup-time "compiler" (host fp64 numpy).

For each ρ in the ladder this builds the affine map of one ADMM iteration on
the stacked state ``y = [x; z; λ] ∈ R^D`` (D = nx + 2·nc):

    y⁺ = clamp(W_k y + b_k)        with the clamp active on the z-segment

with ``K = (H + σI + Aᵀ diag(ρ⃗) A)⁻¹`` and the 3×3 block map

    W = [[ K(σI − AᵀRA),        2 K Aᵀ R,        −K Aᵀ          ],
         [ A K(σI − AᵀRA) + A,  2 A K Aᵀ R − I,  −A K Aᵀ + R⁻¹  ],
         [ R A,                 −R,               I             ]]
    B = [−K; −A K; 0],   b = B g

where R = diag(ρ⃗) and ρ⃗ boosts equality rows (u−l ≤ eq_tol) by 1e3.
Full clamp vectors lo/hi (±inf outside the z-segment) make the iteration a
branch- and slice-free ``clip(Wy+b, lo, hi)``. The device-side records
``Bank`` and ``DeviceQP`` hold torch tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "Bank",
    "DeviceQP",
    "EQ_RHO_BOOST",
    "equality_mask",
    "build_bank_np",
    "clamp_bounds",
    "stacked_dim",
    "auto_rho_cap",
    "certifiable_eps_floor",
    "effective_rho_ladder",
    "sigma_max_sq",
]

# Equality-row penalty boost: ρ⃗ = ρ · EQ_RHO_BOOST on rows with u−l ≤ eq_tol.
# The bank build and every λ = ρ⃗(p − z) reconstruction site MUST use the
# same per-row effective ρ — form it with ``effective_rho_ladder``.
EQ_RHO_BOOST = 1e3


def sigma_max_sq(A: np.ndarray, iters: int = 40) -> float:
    """σ_max(A)² via fp64 power iteration on AᵀA (deterministic start)."""
    A = np.asarray(A, dtype=np.float64)
    if A.size == 0:
        return 0.0
    v = np.ones(A.shape[1]) / np.sqrt(A.shape[1])
    s = 0.0
    for _ in range(iters):
        w = A.T @ (A @ v)
        s = float(np.linalg.norm(w))
        if s <= 0.0:
            return 0.0
        v = w / s
    return s


def _eps_mach(dtype) -> float:
    return float(torch.finfo(dtype).eps) if isinstance(dtype, torch.dtype) \
        else float(np.finfo(np.dtype(dtype)).eps)


def _is_f64(dtype) -> bool:
    return dtype == torch.float64 if isinstance(dtype, torch.dtype) \
        else np.dtype(dtype) == np.float64


def auto_rho_cap(A, eps_abs: float, dtype, nx: int,
                 theta: float = 0.1) -> float:
    """Precision-aware cap on the per-row effective ρ.

    In a reduced-precision iterate the dual variable carries an absolute
    noise floor ≈ ``eps_mach · ρ_row · σ_max(A)²``. Rungs whose effective ρ
    exceeds ``θ · eps_abs · √nx / (eps_mach · σ_max²)`` can never certify
    ``dua < eps_abs·√nx``; capping the per-row ρ there keeps the ρ walk
    from wasting check windows. Returns ``inf`` for float64 iterates and
    for a degenerate σ_max; otherwise the bound clamped to ≥ 1.0.
    ``dtype`` is a torch or numpy dtype.
    """
    if _is_f64(dtype):
        return float("inf")
    eps_mach = _eps_mach(dtype)
    s2 = sigma_max_sq(A)
    if not np.isfinite(s2) or s2 <= 0.0:
        return float("inf")
    cap = theta * float(eps_abs) * float(np.sqrt(max(nx, 1))) / (eps_mach * s2)
    return float(max(cap, 1.0))


def certifiable_eps_floor(rho_cap: float, s2: float, dtype, nx: int) -> float:
    """The tightest eps_abs a frozen ρ cap can still certify.

    A rung at the cap carries dual-residual noise
    ``eps_mach · rho_cap · σ_max²``; certification needs ``eps_abs · √nx``
    above that. Returns 0.0 for an uncapped ladder or a degenerate
    spectrum.
    """
    if not np.isfinite(rho_cap) or not np.isfinite(s2) or s2 <= 0.0:
        return 0.0
    return float(rho_cap * _eps_mach(dtype) * s2 / np.sqrt(max(nx, 1)))


def effective_rho_ladder(rhos: np.ndarray, eq_mask: np.ndarray,
                         rho_cap: float = np.inf) -> np.ndarray:
    """Per-rung effective per-row ρ: ``min(ρ_k · boost_row, rho_cap)``.

    Shape (N_rho, nc) fp64. This is THE definition of ρ⃗ everywhere — bank
    build, λ = ρ⃗(p − z) reconstruction, rung-switch re-encoding."""
    rhos = np.asarray(rhos, dtype=np.float64)
    boost = np.where(np.asarray(eq_mask, bool), EQ_RHO_BOOST, 1.0)
    return np.minimum(rhos[:, None] * boost[None, :], rho_cap)


class Bank(NamedTuple):
    """Device-resident weight bank over the ρ ladder."""

    W: torch.Tensor      # (N_rho, Dp, Dp)  Wᵀ per rung (runtime layout)
    B: torch.Tensor      # (N_rho, Dp, nx)  for b = B g updates
    b: torch.Tensor      # (N_rho, Dp)
    rhos: torch.Tensor   # (N_rho,)


class DeviceQP(NamedTuple):
    """Device-side problem data used by the iteration/residual path.

    ``w_pri``/``w_dua`` are optional residual unscale weights (OSQP's
    ``scaled_termination=False``): ``w_pri = 1/E`` (nc,) and
    ``w_dua = 1/(c·D)`` (nx,). ``None`` keeps residuals in the iterate's
    own units."""

    H: torch.Tensor     # (nx, nx)
    g: torch.Tensor     # (nx,)
    A: torch.Tensor     # (nc, nx)
    lo: torch.Tensor    # (Dp,)  -inf outside the z-segment, l inside
    hi: torch.Tensor    # (Dp,)  +inf outside the z-segment, u inside
    w_pri: Optional[torch.Tensor] = None
    w_dua: Optional[torch.Tensor] = None


def stacked_dim(nx: int, nc: int) -> int:
    return nx + 2 * nc


def equality_mask(l: np.ndarray, u: np.ndarray, eq_tol: float) -> np.ndarray:
    """Rows treated as equalities: u − l ≤ eq_tol."""
    return (np.asarray(u) - np.asarray(l)) <= eq_tol


def clamp_bounds(l, u, nx: int, nc: int):
    """Full-length fp64 clamp vectors: identity outside [nx, nx+nc)."""
    lo = np.concatenate([np.full((nx,), -np.inf), np.asarray(l, np.float64),
                         np.full((nc,), -np.inf)])
    hi = np.concatenate([np.full((nx,), np.inf), np.asarray(u, np.float64),
                         np.full((nc,), np.inf)])
    return lo, hi


def _bank_blocks_np(H, A, rho_vec, sigma, alpha=1.0):
    """One ladder rung in fp64 numpy. Returns (W, B) blocks.

    ``alpha == 1``: the parametrization ``y = [x; z; λ]``. ``alpha != 1``:
    the over-relaxed iteration in ``y = [x; z; p]`` (p = pre-clip z,
    λ = R(p − z)), where the z- and p-rows are the SAME affine map
    ``α A x⁺ + p − α z`` — z clamps, p passes through:

        W = [[ σK,        2 K Aᵀ R,          −K Aᵀ R        ],
             [ ασ A K,  2α A K Aᵀ R − αI,  −α A K Aᵀ R + I ],
             [ ασ A K,  2α A K Aᵀ R − αI,  −α A K Aᵀ R + I ]]
        B = [−K; −α A K; −α A K]
    """
    nx = H.shape[0]
    nc = A.shape[0]
    M = H + sigma * np.eye(nx) + A.T @ (rho_vec[:, None] * A)
    # SPD by construction for convex QPs; fall back to a general solve if
    # the Cholesky fails.
    I = np.eye(nx)
    try:
        c, low = _cho_factor(M)
        K = _cho_solve((c, low), I)
    except np.linalg.LinAlgError:
        K = np.linalg.solve(M, I)
    KAt = K @ A.T                      # (nx, nc)
    AK = KAt.T                         # A K  (K symmetric)
    KAtR = KAt * rho_vec               # K Aᵀ R
    Ic = np.eye(nc)
    D = nx + 2 * nc
    W = np.empty((D, D), dtype=np.float64)
    if alpha != 1.0:
        AKAtR = A @ KAtR               # A K Aᵀ R
        W[:nx, :nx] = sigma * K
        W[:nx, nx:nx + nc] = 2.0 * KAtR
        W[:nx, nx + nc:] = -KAtR
        zrow_x = alpha * sigma * AK
        zrow_z = 2.0 * alpha * AKAtR - alpha * Ic
        zrow_p = -alpha * AKAtR + Ic
        W[nx:nx + nc, :nx] = zrow_x
        W[nx:nx + nc, nx:nx + nc] = zrow_z
        W[nx:nx + nc, nx + nc:] = zrow_p
        W[nx + nc:, :nx] = zrow_x
        W[nx + nc:, nx:nx + nc] = zrow_z
        W[nx + nc:, nx + nc:] = zrow_p
        B = np.concatenate([-K, -alpha * AK, -alpha * AK], axis=0)
        return W, B
    S = sigma * K - KAtR @ A           # K (σI − AᵀRA)
    AS = A @ S
    AKAt = A @ KAt
    W[:nx, :nx] = S
    W[:nx, nx:nx + nc] = 2.0 * KAtR
    W[:nx, nx + nc:] = -KAt
    W[nx:nx + nc, :nx] = AS + A
    W[nx:nx + nc, nx:nx + nc] = 2.0 * (AKAt * rho_vec) - Ic
    W[nx:nx + nc, nx + nc:] = -AKAt + np.diag(1.0 / rho_vec)
    W[nx + nc:, :nx] = rho_vec[:, None] * A
    W[nx + nc:, nx:nx + nc] = -np.diag(rho_vec)
    W[nx + nc:, nx + nc:] = Ic
    B = np.concatenate([-K, -AK, np.zeros((nc, nx))], axis=0)
    return W, B


def _cho_factor(M):
    from scipy.linalg import cho_factor
    return cho_factor(M, lower=True, check_finite=False)


def _cho_solve(cf, I):
    from scipy.linalg import cho_solve
    return cho_solve(cf, I, check_finite=False)


def build_bank_np(H: np.ndarray, g: np.ndarray, A: np.ndarray,
                  eq_mask: np.ndarray, rhos: np.ndarray, sigma: float,
                  alpha: float = 1.0, rho_cap: float = np.inf):
    """fp64 host bank build over the whole ladder.

    Returns numpy ``(W, B, b)`` with shapes (N,D,D), (N,D,nx), (N,D).
    ``alpha != 1`` builds the over-relaxed [x; z; p] parametrization;
    ``rho_cap`` bounds the per-row effective ρ (``inf`` = uncapped).
    """
    H = np.asarray(H, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64).reshape(-1)
    A = np.asarray(A, dtype=np.float64)
    rhos = np.asarray(rhos, dtype=np.float64)
    nx, nc = H.shape[0], A.shape[0]
    D = stacked_dim(nx, nc)
    N = rhos.shape[0]
    W = np.empty((N, D, D), dtype=np.float64)
    B = np.empty((N, D, nx), dtype=np.float64)
    rho_eff = effective_rho_ladder(rhos, eq_mask, rho_cap)
    for k in range(N):
        W[k], B[k] = _bank_blocks_np(H, A, rho_eff[k], sigma, alpha)
    b = np.einsum("kdx,x->kd", B, g)
    return W, B, b
