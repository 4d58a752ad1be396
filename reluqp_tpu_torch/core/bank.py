"""Weight-bank construction: the setup-time "compiler" (fp64).

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

``build_bank_np`` / ``build_banks_np_batch`` build on the host with numpy;
``build_bank_torch`` builds a stack of problems' banks in one pass of
batched torch linear algebra on any device, in fp64.
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
    "build_banks_np_batch",
    "build_bank_torch",
    "clamp_bounds",
    "stacked_dim",
    "auto_rho_cap",
    "certifiable_eps_floor",
    "effective_rho_ladder",
    "sigma_max_sq",
    "sigma_max_sq_batch",
    "auto_rho_cap_batch",
    "effective_rho_ladder_batch",
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


def sigma_max_sq_batch(A, iters: int = 40) -> np.ndarray:
    """σ_max(A_b)² for a (B, nc, nx) stack by one vectorized fp64 power
    iteration (two batched contractions per step). Degenerate (all-zero)
    problems return 0."""
    A = np.asarray(A, dtype=np.float64)
    B = A.shape[0]
    v = np.ones((B, A.shape[2])) / np.sqrt(max(A.shape[2], 1))
    s = np.zeros(B)
    for _ in range(iters):
        w = np.einsum("bcx,bc->bx", A, np.einsum("bcx,bx->bc", A, v))
        s = np.linalg.norm(w, axis=-1)
        # degenerate problems stay at w = 0, s = 0; the guard avoids 0/0
        v = w / np.maximum(s, 1e-300)[:, None]
    return s


def auto_rho_cap_batch(A, eps_abs: float, dtype, nx: int,
                       theta: float = 0.1, iters: int = 40) -> np.ndarray:
    """``auto_rho_cap`` over a (B, nc, nx) stack of A's: (B,) caps, ``inf``
    under float64 iterates or a degenerate spectrum, else the θ-scaled
    bound clamped to ≥ 1. ``dtype`` is a torch or numpy dtype."""
    A = np.asarray(A, dtype=np.float64)
    B = A.shape[0]
    if _is_f64(dtype) or A.size == 0:
        return np.full(B, np.inf)
    s = sigma_max_sq_batch(A, iters=iters)
    bound = theta * float(eps_abs) * float(np.sqrt(max(nx, 1)))
    # divide only where s > 0 (s == 0 with bound == 0 would be 0/0); the
    # where() below takes the inf branch for those problems
    cap = bound / (_eps_mach(dtype) * np.where(s > 0.0, s, 1.0))
    return np.where(np.isfinite(s) & (s > 0.0), np.maximum(cap, 1.0),
                    np.inf)


def effective_rho_ladder_batch(rhos: np.ndarray, eq_masks: np.ndarray,
                               rho_caps: np.ndarray) -> np.ndarray:
    """``effective_rho_ladder`` per problem: (B, N_rho, nc) from (B, nc)
    equality masks and (B,) caps."""
    rhos = np.asarray(rhos, dtype=np.float64)
    boost = np.where(np.asarray(eq_masks, bool), EQ_RHO_BOOST, 1.0)
    return np.minimum(rhos[None, :, None] * boost[:, None, :],
                      np.reshape(np.asarray(rho_caps, np.float64),
                                 (-1, 1, 1)))


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


def build_bank_np(H: np.ndarray, g: np.ndarray, A: np.ndarray,
                  eq_mask: np.ndarray, rhos: np.ndarray, sigma: float,
                  alpha: float = 1.0, rho_cap: float = np.inf):
    """fp64 host bank build over the whole ladder.

    Returns numpy ``(W, B, b)`` with shapes (N,D,D), (N,D,nx), (N,D).
    ``alpha != 1`` builds the over-relaxed [x; z; p] parametrization;
    ``rho_cap`` bounds the per-row effective ρ (``inf`` = uncapped).
    """
    g = np.asarray(g, dtype=np.float64).reshape(-1)
    W, B = build_banks_np_batch(
        np.asarray(H, dtype=np.float64)[None],
        np.asarray(A, dtype=np.float64)[None],
        np.asarray(eq_mask)[None], rhos, sigma, alpha, np.array([rho_cap]))
    W, B = W[0], B[0]
    b = np.einsum("kdx,x->kd", B, g)
    return W, B, b


def build_banks_np_batch(H: np.ndarray, A: np.ndarray, eq_masks: np.ndarray,
                         rhos: np.ndarray, sigma: float, alpha: float = 1.0,
                         rho_caps=None):
    """The fp64 banks of a stack of problems: H (B, nx, nx), A (B, nc,
    nx), per-problem equality masks (B, nc) and ρ caps (B,) → W (B, N, D,
    D) and B (B, N, D, nx).

    ``alpha == 1``: the parametrization ``y = [x; z; λ]`` (module
    docstring). ``alpha != 1``: the over-relaxed iteration in
    ``y = [x; z; p]`` (p = pre-clip z, λ = R(p − z)), where the z- and
    p-rows are the SAME affine map ``α A x⁺ + p − α z`` — z clamps, p
    passes through:

        W = [[ σK,        2 K Aᵀ R,          −K Aᵀ R        ],
             [ ασ A K,  2α A K Aᵀ R − αI,  −α A K Aᵀ R + I ],
             [ ασ A K,  2α A K Aᵀ R − αI,  −α A K Aᵀ R + I ]]
        B = [−K; −α A K; −α A K]

    Each rung is formed for all problems at once: the stacked products run
    one BLAS call per problem with the operand layouts of the 2-D products,
    and K = M⁻¹ comes from ``cho_factor``/``cho_solve``'s LAPACK calls, so
    a problem's bank does not depend on the stack it is built in.
    Stacking removes the per-call overhead of a loop over problems at small
    nx.
    """
    H = np.asarray(H, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    rhos = np.asarray(rhos, dtype=np.float64)
    nb, nx, nc = H.shape[0], H.shape[1], A.shape[1]
    D = stacked_dim(nx, nc)
    N = rhos.shape[0]
    caps = np.full(nb, np.inf) if rho_caps is None else rho_caps
    rho_eff = effective_rho_ladder_batch(rhos, eq_masks, caps)  # (B, N, nc)
    # rung-major storage, so that each rung's blocks are written to
    # contiguous memory; returned as (B, N, ·, ·) views
    W = np.empty((N, nb, D, D), dtype=np.float64)
    Bm = np.empty((N, nb, D, nx), dtype=np.float64)
    At = np.swapaxes(A, 1, 2)
    I = np.eye(nx)
    Ic = np.eye(nc)
    for k in range(N):
        rv = rho_eff[:, k]                                  # (B, nc)
        M = H + sigma * I + At @ (rv[:, :, None] * A)
        K = _spd_inverse_batch(M)
        KAt = K @ At                                        # (B, nx, nc)
        AK = np.swapaxes(KAt, 1, 2)
        KAtR = KAt * rv[:, None, :]
        Wk, Bk = W[k], Bm[k]
        if alpha != 1.0:
            AKAtR = A @ KAtR
            zrow_x = alpha * sigma * AK
            zrow_z = 2.0 * alpha * AKAtR - alpha * Ic
            zrow_p = -alpha * AKAtR + Ic
            Wk[:, :nx, :nx] = sigma * K
            Wk[:, :nx, nx:nx + nc] = 2.0 * KAtR
            Wk[:, :nx, nx + nc:] = -KAtR
            for r0 in (nx, nx + nc):
                Wk[:, r0:r0 + nc, :nx] = zrow_x
                Wk[:, r0:r0 + nc, nx:nx + nc] = zrow_z
                Wk[:, r0:r0 + nc, nx + nc:] = zrow_p
            Bk[:, :nx] = -K
            Bk[:, nx:nx + nc] = Bk[:, nx + nc:] = -alpha * AK
            continue
        S = sigma * K - KAtR @ A
        AKAt = A @ KAt
        Wk[:, :nx, :nx] = S
        Wk[:, :nx, nx:nx + nc] = 2.0 * KAtR
        Wk[:, :nx, nx + nc:] = -KAt
        Wk[:, nx:nx + nc, :nx] = A @ S + A
        Wk[:, nx:nx + nc, nx:nx + nc] = 2.0 * (AKAt * rv[:, None, :]) - Ic
        Wk[:, nx:nx + nc, nx + nc:] = -AKAt + _diag_batch(1.0 / rv)
        Wk[:, nx + nc:, :nx] = rv[:, :, None] * A
        Wk[:, nx + nc:, nx:nx + nc] = -_diag_batch(rv)
        Wk[:, nx + nc:, nx + nc:] = Ic
        Bk[:, :nx] = -K
        Bk[:, nx:nx + nc] = -AK
        Bk[:, nx + nc:] = 0.0
    return np.swapaxes(W, 0, 1), np.swapaxes(Bm, 0, 1)


def _diag_batch(v):
    """(B, n) → (B, n, n) diagonal matrices."""
    out = np.zeros(v.shape + v.shape[-1:])
    idx = np.arange(v.shape[-1])
    out[:, idx, idx] = v
    return out


def _spd_inverse_batch(M):
    """M⁻¹ of every (n, n) matrix of a stack, each by ``cho_factor`` /
    ``cho_solve``'s LAPACK calls (SPD by construction for convex QPs; a
    general solve where Cholesky fails). Each slice is Fortran-ordered, as
    ``cho_solve`` returns it, so that the products that follow call BLAS
    with the operand layouts, and round, as they do after ``cho_solve``."""
    from scipy.linalg.lapack import dpotrf, dpotrs
    n = M.shape[-1]
    I = np.eye(n)
    K = np.empty_like(M).transpose(0, 2, 1)
    for i in range(M.shape[0]):
        c, info = dpotrf(M[i], lower=1, clean=0)
        if info == 0:
            K[i], info = dpotrs(c, I, lower=1)
        if info != 0:
            K[i] = np.linalg.solve(M[i], I)
    return K


def build_bank_torch(H, A, eq_masks, rhos, sigma: float, alpha: float = 1.0,
                     rho_caps=None, device=None):
    """The banks of a stack of problems in one pass of batched torch linear
    algebra over every (problem, rung) pair, in fp64 on ``device``.

    The batched form of ``build_banks_np_batch`` (same parametrizations, the
    equality boost and the per-problem cap): H (B, nx, nx), A (B, nc, nx),
    equality masks (B, nc) and caps (B,) (``None``: uncapped), as arrays or
    tensors, → W (B, N, D, D) and B (B, N, D, nx), fp64 tensors. K = M⁻¹
    comes from a batched Cholesky factorization (a general solve for any
    matrix it rejects). fp64 whatever the iteration dtype: an fp32 build
    would move the ADMM fixed point.
    """
    f64 = torch.float64
    if device is None:
        device = H.device if isinstance(H, torch.Tensor) else "cpu"
    put = lambda a: torch.as_tensor(np.asarray(a) if not isinstance(
        a, torch.Tensor) else a, device=device)
    H, A = put(H).to(f64), put(A).to(f64)
    eq = put(eq_masks).to(torch.bool)
    nb, nx, nc = H.shape[0], H.shape[1], A.shape[1]
    D = stacked_dim(nx, nc)
    rhos = torch.as_tensor(np.asarray(rhos, np.float64), device=device)
    N = rhos.shape[0]
    caps = (torch.full((nb,), float("inf"), dtype=f64, device=device)
            if rho_caps is None else put(rho_caps).to(f64))
    # (B, N, nc): min(ρ_k · boost_row, cap), effective_rho_ladder_batch
    boost = torch.where(eq, EQ_RHO_BOOST, 1.0).to(f64)
    rv = torch.minimum(rhos[None, :, None] * boost[:, None, :],
                       caps[:, None, None])
    Hn, An = H[:, None], A[:, None]                         # (B, 1, ·, nx)
    At = An.transpose(-1, -2)
    I = torch.eye(nx, dtype=f64, device=device)
    Ic = torch.eye(nc, dtype=f64, device=device)
    M = Hn + sigma * I + At @ (rv[..., :, None] * An)      # (B, N, nx, nx)
    L, info = torch.linalg.cholesky_ex(M)
    K = torch.cholesky_solve(I.expand_as(M), L)
    bad = info != 0
    if bool(bad.any()):
        K[bad] = torch.linalg.solve(M[bad], I.expand(M[bad].shape))
    KAt = K @ At                                            # (B, N, nx, nc)
    AK = KAt.transpose(-1, -2)
    KAtR = KAt * rv[..., None, :]
    W = torch.empty((nb, N, D, D), dtype=f64, device=device)
    Bm = torch.empty((nb, N, D, nx), dtype=f64, device=device)
    x, z, p = slice(0, nx), slice(nx, nx + nc), slice(nx + nc, D)
    Bm[..., x, :] = -K
    if alpha != 1.0:
        AKAtR = An @ KAtR
        zrow = (alpha * sigma * AK, 2.0 * alpha * AKAtR - alpha * Ic,
                -alpha * AKAtR + Ic)
        W[..., x, x] = sigma * K
        W[..., x, z] = 2.0 * KAtR
        W[..., x, p] = -KAtR
        for r in (z, p):
            for c, blk in zip((x, z, p), zrow):
                W[..., r, c] = blk
        Bm[..., z, :] = Bm[..., p, :] = -alpha * AK
        return W, Bm
    S = sigma * K - KAtR @ An
    AKAt = An @ KAt
    W[..., x, x] = S
    W[..., x, z] = 2.0 * KAtR
    W[..., x, p] = -KAt
    W[..., z, x] = An @ S + An
    W[..., z, z] = 2.0 * (AKAt * rv[..., None, :]) - Ic
    W[..., z, p] = -AKAt + torch.diag_embed(1.0 / rv)
    W[..., p, x] = rv[..., :, None] * An
    W[..., p, z] = -torch.diag_embed(rv)
    W[..., p, p] = Ic
    Bm[..., z, :] = -AK
    Bm[..., p, :] = 0.0
    return W, Bm
