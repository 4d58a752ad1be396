"""Problem generators, the canonical fixture, and fp64 oracles.

``rand_qp`` reproduces the reference generator's construction and sampling
order (``ReLU-QP-py/reluqp/utils.py:11-39``) so that, for a given seed, both
frameworks solve the *identical* problem instance: a feasible QP built
around a known KKT point, with ``n_eq`` equality rows (l==u==b) stacked on
``n_ineq`` one-sided inequality rows (d ≤ Cx ≤ +inf). The reference computes
ground truth via CVXPY (``utils.py:31-36``); we instead provide a
self-contained fp64 oracle (scipy ``trust-constr``, which natively handles
``l ≤ Ax ≤ u``) plus direct KKT-condition verification, so tests need no
external QP solver.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

__all__ = ["rand_qp", "update_qp", "canonical_qp", "solve_qp_oracle",
           "kkt_error", "QPInstance"]


class QPInstance(NamedTuple):
    H: np.ndarray
    g: np.ndarray
    A: np.ndarray
    l: np.ndarray
    u: np.ndarray
    x_sol: Optional[np.ndarray]


def rand_qp(nx=10, n_eq=5, n_ineq=5, seed=1, compute_sol=True) -> QPInstance:
    """Random feasible QP, sampling-order-identical to reference ``rand_qp``."""
    rng = np.random.RandomState(seed)
    H = rng.randn(nx, nx)
    H = H.T @ H + np.eye(nx)
    H = H + H.T

    A = rng.randn(n_eq, nx)
    C = rng.randn(n_ineq, nx)

    active_ineq = rng.randn(n_ineq) > 0.5

    mu = rng.randn(n_eq)
    lamb = rng.randn(n_ineq) * active_ineq

    x = rng.randn(nx)
    b = A @ x
    d = C @ x - rng.randn(n_ineq) * (~active_ineq)

    g = -H @ x - A.T @ mu - C.T @ lamb

    A_full = np.vstack((A, C))
    l_full = np.concatenate((b, d))
    u_full = np.concatenate((b, np.full(n_ineq, np.inf)))
    x_sol = None
    if compute_sol:
        x_sol = solve_qp_oracle(H, g, A_full, l_full, u_full, x0=x)
    return QPInstance(H, g, A_full, l_full, u_full, x_sol)


def update_qp(H, A, n_eq, n_ineq, seed=1, compute_sol=True) -> QPInstance:
    """New vectors (g, l, u) for fixed (H, A) — reference ``utils.py:42-70``."""
    rng = np.random.RandomState(seed)
    nx = H.shape[0]
    C = A[n_eq:]
    A_eq = A[:n_eq]

    active_ineq = rng.randn(n_ineq) > 0.5
    mu = rng.randn(n_eq)
    lamb = rng.randn(n_ineq) * active_ineq

    x = rng.randn(nx)
    b = A_eq @ x
    d = C @ x - rng.randn(n_ineq) * (~active_ineq)

    g = -H @ x - A_eq.T @ mu - C.T @ lamb

    A_full = np.vstack((A_eq, C))
    l_full = np.concatenate((b, d))
    u_full = np.concatenate((b, np.full(n_ineq, np.inf)))
    x_sol = None
    if compute_sol:
        x_sol = solve_qp_oracle(H, g, A_full, l_full, u_full, x0=x)
    return QPInstance(H, g, A_full, l_full, u_full, x_sol)


def canonical_qp() -> QPInstance:
    """The repo-wide canonical fixture: 3 vars, 5 rows, x* = [2, -1, 1].

    Same QP as the reference self-test (``reluqpth.py:342-346``) and the
    hard-coded structs in the C/CUDA standalones (``reluqp.cu:141-213``).
    """
    H = np.array([[6.0, 2, 1], [2, 5, 2], [1, 2, 4]])
    g = np.array([-8.0, -3, -3])
    A = np.array([[1.0, 0, 1], [0, 1, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    l = np.array([3.0, 0, -10.0, -10, -10])
    u = np.array([3.0, 0, np.inf, np.inf, np.inf])
    return QPInstance(H, g, A, l, u, np.array([2.0, -1.0, 1.0]))


def solve_qp_oracle(H, g, A, l, u, x0=None, tol=1e-10, max_iter=2000):
    """fp64 oracle for  min ½xᵀHx+gᵀx  s.t.  l ≤ Ax ≤ u  (scipy trust-constr)."""
    from scipy.optimize import LinearConstraint, minimize

    H = np.asarray(H, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    nx = H.shape[0]
    if x0 is None:
        x0 = np.zeros(nx)
    res = minimize(
        lambda x: 0.5 * x @ H @ x + g @ x,
        np.asarray(x0, dtype=np.float64),
        jac=lambda x: H @ x + g,
        hess=lambda x: H,
        constraints=[LinearConstraint(np.asarray(A), np.asarray(l),
                                      np.asarray(u))],
        method="trust-constr",
        options={"gtol": tol, "xtol": tol, "maxiter": max_iter},
    )
    return res.x


def kkt_error(H, g, A, l, u, x, z=None, lam=None, eq_tol=1e-6):
    """Direct KKT-condition residuals for a candidate solution.

    Returns (stationarity, primal_feasibility, complementarity) ∞-norms.
    When λ is given, stationarity is ‖Hx + g + Aᵀλ‖∞ (our solver's dual
    convention: λ ≥ 0 on active upper bounds, λ ≤ 0 on active lower bounds).
    Complementarity: λ_i must vanish unless row i is at a bound.
    """
    H = np.asarray(H, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    l = np.asarray(l, dtype=np.float64)
    u = np.asarray(u, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    Ax = A @ x
    pri = np.max(np.maximum(np.maximum(l - Ax, Ax - u), 0.0), initial=0.0)
    if lam is None:
        return None, pri, None
    lam = np.asarray(lam, dtype=np.float64)
    stat = np.max(np.abs(H @ x + g + A.T @ lam), initial=0.0)
    zz = Ax if z is None else np.asarray(z, dtype=np.float64)
    slack_lo = np.abs(zz - l)
    slack_hi = np.abs(u - zz)
    # complementarity: min distance to an active bound weighted by |λ|
    comp = np.max(np.minimum(slack_lo, slack_hi) * np.abs(lam), initial=0.0)
    return stat, pri, comp
