"""The benchmark's own problem data, in NumPy, from a seed.

Frozen copies, written apart from the program under test, of what its
configuration names: ``random_linear_system``, ``lqr_gain`` and
``condense``: the random plant of the ReLU-QP paper's MPC benchmark, its
infinite-horizon LQR gain and the prestabilised condensed QP with its
receding-horizon maps.

Nothing here imports the program: the reference and the judge use these,
and the benchmark hands the same raw data to the program.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


def seed_words(*parts: int) -> np.random.RandomState:
    """A ``RandomState`` keyed by any whole numbers (a run's seed may pass
    32 bits): they are mixed by a ``SeedSequence`` into one 32-bit key."""
    seq = np.random.SeedSequence([int(p) % (1 << 64) for p in parts])
    return np.random.RandomState(int(seq.generate_state(1)[0]))


def random_linear_system(nx: int, nu: int, seed: int,
                         spectral_radius: float):
    """The ReLU-QP paper's random plant: Gaussian ``Ad`` scaled to the
    given spectral radius, ``Bd`` Gaussian over sqrt(nx)."""
    rng = np.random.RandomState(seed)
    Ad = rng.randn(nx, nx)
    Ad *= spectral_radius / np.max(np.abs(np.linalg.eigvals(Ad)))
    Bd = rng.randn(nx, nu) / np.sqrt(nx)
    return Ad, Bd


def lqr_gain(Ad, Bd, Q, R, iters: int = 1000, tol: float = 1e-8):
    """Infinite-horizon discrete LQR ``(K, P)`` by Riccati iteration."""
    P = Q.copy()
    for _ in range(iters):
        BtP = Bd.T @ P
        K = np.linalg.solve(R + BtP @ Bd, BtP @ Ad)
        P_next = Q + Ad.T @ P @ (Ad - Bd @ K)
        if np.linalg.norm(P_next - P, 2) < tol:
            return K, P_next
        P = P_next
    raise RuntimeError("Riccati iteration did not converge")


class Condensed(NamedTuple):
    """``min ½vᵀHv + gᵀv, l ≤ Av ≤ u`` with ``g = g0 + g_x @ x``,
    ``l = l0 + lu_x @ x``, ``u = u0 + lu_x @ x`` at plant state x; the
    applied control is ``u_0 = -K x + v[:nu]``."""
    H: np.ndarray
    g0: np.ndarray
    g_x: np.ndarray
    A: np.ndarray
    l0: np.ndarray
    u0: np.ndarray
    lu_x: np.ndarray
    K: np.ndarray
    Ad: np.ndarray
    Bd: np.ndarray


def condense(Ad, Bd, Q, R, horizon: int, u_min: float, u_max: float,
             prestabilize: bool = True) -> Condensed:
    """The condensed MPC QP over the inputs ``v`` of ``u_k = -K x_k +
    v_k`` with the LQR value matrix as terminal cost and box bounds on
    every stage's control, built directly from the stage recursion
    ``x_{k+1} = Ā x_k + Bd v_k``, ``Ā = Ad - Bd K``."""
    nx, nu = Bd.shape
    N = horizon
    K, P = lqr_gain(Ad, Bd, Q, R)
    if not prestabilize:
        K = np.zeros_like(K)
    Abar = Ad - Bd @ K
    # x_k = Ax[k] x0 + Bv[k] v   (k = 0..N), u_k = -K x_k + v_k
    Ax = [np.eye(nx)]
    Bv = [np.zeros((nx, N * nu))]
    for k in range(N):
        Ax.append(Abar @ Ax[-1])
        nb = Abar @ Bv[-1]
        nb[:, k * nu:(k + 1) * nu] += Bd
        Bv.append(nb)
    H = np.zeros((N * nu, N * nu))
    g_x = np.zeros((N * nu, nx))
    A = np.zeros((N * nu, N * nu))
    lu_x = np.zeros((N * nu, nx))
    for k in range(N):
        # control of stage k: u_k = (-K Bv[k] + E_k) v - K Ax[k] x0
        Uv = -K @ Bv[k]
        Uv[:, k * nu:(k + 1) * nu] += np.eye(nu)
        Ux = -K @ Ax[k]
        H += Uv.T @ R @ Uv
        g_x += Uv.T @ R @ Ux
        # state of stage k + 1, the last one weighted by the LQR value
        W = P if k == N - 1 else Q
        H += Bv[k + 1].T @ W @ Bv[k + 1]
        g_x += Bv[k + 1].T @ W @ Ax[k + 1]
        A[k * nu:(k + 1) * nu] = Uv
        lu_x[k * nu:(k + 1) * nu] = -Ux
    H = 0.5 * (H + H.T)
    m = N * nu
    return Condensed(H=H, g0=np.zeros(m), g_x=g_x, A=A,
                     l0=np.full(m, float(u_min)), u0=np.full(m, float(u_max)),
                     lu_x=lu_x, K=K, Ad=Ad, Bd=Bd)


def mpc_qp_at(c: Condensed, X: np.ndarray):
    """The condensed QP's ``(g, l, u)`` at plant states ``X`` (rows)."""
    X = np.atleast_2d(X)
    return (c.g0 + X @ c.g_x.T, c.l0 + X @ c.lu_x.T, c.u0 + X @ c.lu_x.T)
