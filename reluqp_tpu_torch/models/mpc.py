"""Linear MPC: LQR, MPC→QP generators, receding-horizon control.

- ``ihlqr`` / ``constrained_ihlqr``: infinite-horizon discrete LQR gains
  by Riccati iteration;
- ``gen_sparse_mpc_qp``: stage-stacked sparse MPC QP, dynamics as
  equality rows;
- ``gen_condensed_mpc_qp``: state-eliminated dense MPC QP with a
  prestabilizing gain, plus the receding-horizon update maps ``g_x0`` /
  ``lu_x0``;
- ``MPC``: a host-driven receding-horizon controller over ``ReLU_QP``
  (``update(g,l,u)`` + warm-started ``solve`` per step);
- ``mpc_rollout_scan``: the closed loop (state feedback → QP refresh →
  warm-started solve → plant step) with the plant state kept on the
  device. ``kernel="loop"`` runs each step's solve through the solve loop
  (kernel K1 on CUDA); the whole-rollout kernel K2 (``kernel="scan"``) and
  the whole-solve kernel K3 (``kernel="fused"``) are later slices.

Condensed form (prestabilized with ``u_k = -K x_k + v_k``,
``Ā = Ad - Bd K``): stacking stage vectors ``s_k = [u_{k-1}; x_k]`` for
``k = 1..N`` gives ``s = F v + G x0`` with

    G_k = [ -K Ā^{k-1} ;  Ā^k ]
    F_{k,j} = [ I_nu ; Bd ]                       for j = k-1
              [ -K Ā^{k-2-j} Bd ; Ā^{k-1-j} Bd ]  for j < k-1

so the sparse cost ``½ sᵀ H_sp s + g_spᵀ s`` condenses to ``H = Fᵀ H_sp F``,
``g = g_x0 x0 + Fᵀ g_sp`` with ``g_x0 = Fᵀ H_sp G``, and row constraints
``l ≤ A_add s ≤ u`` become ``l + lu_x0 x0 ≤ (A_add F) v ≤ u + lu_x0 x0``
with ``lu_x0 = -A_add G``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "ihlqr",
    "constrained_ihlqr",
    "gen_sparse_mpc_qp",
    "gen_condensed_mpc_qp",
    "CondensedMPC",
    "double_integrator",
    "random_linear_system",
    "MPC",
    "mpc_rollout_scan",
    "auto_check_interval",
    "solver_plant_A",
    "solver_plant_B",
]


def ihlqr(Ad, Bd, Q, R, Qf=None, max_iters: int = 1000, tol: float = 1e-8):
    """Infinite-horizon discrete-time LQR gain by Riccati iteration.

    Returns ``(K, P)`` with ``u = -K x`` optimal and ``P`` the value matrix.
    """
    Ad = np.asarray(Ad, dtype=np.float64)
    Bd = np.asarray(Bd, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    P = Q.copy() if Qf is None else np.asarray(Qf, dtype=np.float64).copy()
    for _ in range(max_iters):
        BtP = Bd.T @ P
        K = np.linalg.solve(R + BtP @ Bd, BtP @ Ad)
        P_next = Q + Ad.T @ P @ (Ad - Bd @ K)
        if np.linalg.norm(P_next - P, 2) < tol:
            return K, P_next
        P = P_next
    raise RuntimeError("ihlqr did not converge")


def constrained_ihlqr(A, B_u, B_lam, C, Q, R, F, Qf=None,
                      max_iters: int = 1000, tol: float = 1e-8):
    """Equality-constrained infinite-horizon LQR via KKT Riccati iteration.

    Dynamics ``x⁺ = A x + B_u u + B_λ λ`` with constraint forces λ chosen
    so that ``C x⁺ = 0``; stage cost ``xᵀQx + uᵀRu + λᵀFλ``. Returns gains
    ``(K, L, P)`` with ``u = -K x``, ``λ = -L x``.
    """
    A = np.asarray(A, dtype=np.float64)
    B_u = np.asarray(B_u, dtype=np.float64)
    B_lam = np.asarray(B_lam, dtype=np.float64)
    C = np.asarray(C, dtype=np.float64)
    Q = np.asarray(Q, dtype=np.float64)
    R = np.asarray(R, dtype=np.float64)
    F = np.asarray(F, dtype=np.float64)
    nu, nlam, ncon = B_u.shape[1], B_lam.shape[1], C.shape[0]
    P = Q.copy() if Qf is None else np.asarray(Qf, dtype=np.float64).copy()
    for _ in range(max_iters):
        BuP = B_u.T @ P
        BlP = B_lam.T @ P
        kkt_lhs = np.block([
            [R + BuP @ B_u, BuP @ B_lam, B_u.T @ C.T],
            [BlP @ B_u, F + BlP @ B_lam, B_lam.T @ C.T],
            [C @ B_u, C @ B_lam, np.zeros((ncon, ncon))],
        ])
        kkt_rhs = np.vstack([BuP @ A, BlP @ A, C @ A])
        gains = np.linalg.solve(kkt_lhs, kkt_rhs)
        K = gains[:nu]
        L = gains[nu:nu + nlam]
        N = gains[nu + nlam:]
        Abar = A - B_u @ K - B_lam @ L
        P_next = Q + A.T @ P @ Abar - A.T @ C.T @ N
        P_next = 0.5 * (P_next + P_next.T)
        if np.linalg.norm(P_next - P, 2) < tol:
            return K, L, P_next
        P = P_next
    raise RuntimeError("constrained_ihlqr did not converge")


def _stage_cost_blockdiag(Q, R, Qf, horizon: int) -> np.ndarray:
    """H_sp = blockdiag(R, Q, R, Q, …, R, Qf) over [u_0, x_1, …, u_{N-1}, x_N]."""
    nx, nu = Q.shape[0], R.shape[0]
    ns = nu + nx
    H = np.zeros((horizon * ns, horizon * ns))
    for k in range(horizon):
        H[k * ns:k * ns + nu, k * ns:k * ns + nu] = R
        Qk = Qf if k == horizon - 1 else Q
        H[k * ns + nu:(k + 1) * ns, k * ns + nu:(k + 1) * ns] = Qk
    return H


def gen_sparse_mpc_qp(Ad, Bd, Q, R, Qf, horizon: int,
                      A_add=None, l_add=None, u_add=None):
    """Stage-stacked sparse MPC QP over ``s = [u_0, x_1, …, u_{N-1}, x_N]``.

    Dynamics are the first ``horizon·nx`` rows, as equality rows (l = u):
    ``Bd u_k + Ad x_k − x_{k+1} = 0`` for k ≥ 1 and
    ``Bd u_0 − x_1 = −Ad x_0`` (the x0-dependent right-hand side is zero
    here; shift ``l[:nx] = u[:nx] = −Ad x0`` per step). Extra row
    constraints ``l_add ≤ A_add s ≤ u_add`` are stacked below.
    """
    Ad = np.asarray(Ad, dtype=np.float64)
    Bd = np.asarray(Bd, dtype=np.float64)
    nx, nu = Ad.shape[0], Bd.shape[1]
    ns = nu + nx
    H = _stage_cost_blockdiag(np.asarray(Q, float), np.asarray(R, float),
                              np.asarray(Qf, float), horizon)
    g = np.zeros(H.shape[0])
    A = np.kron(np.eye(horizon), np.hstack([Bd, -np.eye(nx)]))
    if horizon > 1:
        A[nx:, nu:nu + (horizon - 1) * ns] += np.kron(
            np.eye(horizon - 1), np.hstack([Ad, np.zeros((nx, nu))]))
    l = np.zeros(A.shape[0])
    u = np.zeros(A.shape[0])
    if A_add is not None:
        A = np.vstack([A, np.asarray(A_add, float)])
        l = np.concatenate([l, np.asarray(l_add, float)])
        u = np.concatenate([u, np.asarray(u_add, float)])
    return H, g, A, l, u


class CondensedMPC(NamedTuple):
    """Condensed MPC QP + the receding-horizon update maps.

    The per-step cycle is ``g = g0 + g_x0 @ x0``,
    ``l = l0 + lu_x0 @ x0``, ``u = u0 + lu_x0 @ x0``.
    """

    H: np.ndarray        # (N·nu, N·nu)
    g0: np.ndarray       # (N·nu,)  x0-independent linear term  Fᵀ g_sp
    A: np.ndarray        # (m, N·nu)
    l0: np.ndarray       # (m,)
    u0: np.ndarray       # (m,)
    g_x0: np.ndarray     # (N·nu, nx)
    lu_x0: np.ndarray    # (m, nx)
    K: np.ndarray        # (nu, nx) prestabilizing gain (u = -Kx + v)
    F: np.ndarray        # (N·(nu+nx), N·nu) stage map  s = F v + G x0
    G: np.ndarray        # (N·(nu+nx), nx)


def gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, horizon: int,
                         A_add, l_add, u_add, K=None) -> CondensedMPC:
    """Condensed (state-eliminated) MPC QP with prestabilizing gain K
    (``K=0`` gives the standard condensed form)."""
    Ad = np.asarray(Ad, dtype=np.float64)
    Bd = np.asarray(Bd, dtype=np.float64)
    nx, nu = Ad.shape[0], Bd.shape[1]
    ns = nu + nx
    if K is None:
        K = np.zeros((nu, nx))
    K = np.asarray(K, dtype=np.float64)
    Abar = Ad - Bd @ K

    pows = [np.eye(nx)]
    for _ in range(horizon):
        pows.append(Abar @ pows[-1])

    F = np.zeros((horizon * ns, horizon * nu))
    G = np.zeros((horizon * ns, nx))
    for k in range(1, horizon + 1):
        r = (k - 1) * ns
        G[r:r + nu] = -K @ pows[k - 1]
        G[r + nu:r + ns] = pows[k]
        for j in range(k):
            c = j * nu
            if j == k - 1:
                F[r:r + nu, c:c + nu] = np.eye(nu)
                F[r + nu:r + ns, c:c + nu] = Bd
            else:
                F[r:r + nu, c:c + nu] = -K @ pows[k - 2 - j] @ Bd
                F[r + nu:r + ns, c:c + nu] = pows[k - 1 - j] @ Bd

    H_sp, g_sp, _, _, _ = gen_sparse_mpc_qp(Ad, Bd, Q, R, Qf, horizon)
    H = F.T @ H_sp @ F
    H = 0.5 * (H + H.T)
    g_x0 = F.T @ H_sp @ G
    g0 = F.T @ g_sp
    A_add = np.asarray(A_add, dtype=np.float64)
    A = A_add @ F
    lu_x0 = -A_add @ G
    return CondensedMPC(H=H, g0=g0, A=A,
                        l0=np.asarray(l_add, float),
                        u0=np.asarray(u_add, float),
                        g_x0=g_x0, lu_x0=lu_x0, K=K, F=F, G=G)


# --------------------------------------------------------------------- #
# example systems                                                       #
# --------------------------------------------------------------------- #

def double_integrator(dt: float = 0.05, n_masses: int = 1):
    """Chain of ``n_masses`` decoupled double integrators (2·n states)."""
    A1 = np.array([[1.0, dt], [0.0, 1.0]])
    B1 = np.array([[0.5 * dt * dt], [dt]])
    Ad = np.kron(np.eye(n_masses), A1)
    Bd = np.kron(np.eye(n_masses), B1)
    return Ad, Bd


def random_linear_system(nx: int, nu: int, seed: int = 0,
                         spectral_radius: float = 1.05):
    """Random (slightly unstable) controllable linear system."""
    rng = np.random.RandomState(seed)
    Ad = rng.randn(nx, nx)
    Ad *= spectral_radius / np.max(np.abs(np.linalg.eigvals(Ad)))
    Bd = rng.randn(nx, nu) / np.sqrt(nx)
    return Ad, Bd


# --------------------------------------------------------------------- #
# receding-horizon controller (host-driven)                             #
# --------------------------------------------------------------------- #

class MPC:
    """Receding-horizon linear MPC over the ReLU-QP solver.

    Each ``step(x0)`` runs ``update(g, l, u)`` from the measured state, a
    warm-started ``solve``, and returns ``u_0``. For closed-loop rollouts
    with the plant on the device use ``mpc_rollout_scan``.
    ``solver_settings`` go to ``ReLU_QP.setup`` (``device`` among them).
    """

    def __init__(self, Ad, Bd, Q, R, Qf=None, horizon: int = 10,
                 x_min=None, x_max=None, u_min=None, u_max=None,
                 prestabilize: bool = True, **solver_settings):
        Ad = np.asarray(Ad, dtype=np.float64)
        Bd = np.asarray(Bd, dtype=np.float64)
        self.nx, self.nu = Ad.shape[0], Bd.shape[1]
        self.Ad, self.Bd = Ad, Bd
        self.horizon = horizon
        if Qf is None:
            K_inf, Qf = ihlqr(Ad, Bd, Q, R)
        elif prestabilize:
            K_inf = ihlqr(Ad, Bd, Q, R, Qf)[0]
        K = K_inf if prestabilize else np.zeros((self.nu, self.nx))

        A_add, l_add, u_add = _box_rows(self.nx, self.nu, horizon,
                                        x_min, x_max, u_min, u_max)
        self.prob = gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, horizon,
                                         A_add, l_add, u_add, K=K)
        from ..solver import ReLU_QP
        self.solver = ReLU_QP()
        self.solver.setup(self.prob.H, self.prob.g0, self.prob.A,
                          self.prob.l0, self.prob.u0,
                          warm_starting=True, **solver_settings)

    def step(self, x0):
        """One receding-horizon step: returns ``(u_0, results)``."""
        x0 = np.asarray(x0, dtype=np.float64).reshape(self.nx)
        g = self.prob.g0 + self.prob.g_x0 @ x0
        shift = self.prob.lu_x0 @ x0
        self.solver.update(g=g, l=self.prob.l0 + shift,
                           u=self.prob.u0 + shift)
        res = self.solver.solve()
        v0 = res.x[:self.nu].detach().cpu().double().numpy()
        return -self.prob.K @ x0 + v0, res


def _box_rows(nx, nu, horizon, x_min, x_max, u_min, u_max):
    """Box constraints on every stage's u and x as extra rows over s.

    Rows whose bounds are both infinite are dropped — they can never be
    active, and every row costs 2 lanes of the stacked state D = nx + 2 nc.
    """
    ns = nu + nx
    A = np.eye(horizon * ns)
    lo = np.empty(horizon * ns)
    hi = np.empty(horizon * ns)
    u_lo = -np.inf if u_min is None else np.asarray(u_min, float)
    u_hi = np.inf if u_max is None else np.asarray(u_max, float)
    x_lo = -np.inf if x_min is None else np.asarray(x_min, float)
    x_hi = np.inf if x_max is None else np.asarray(x_max, float)
    for k in range(horizon):
        lo[k * ns:k * ns + nu] = u_lo
        hi[k * ns:k * ns + nu] = u_hi
        lo[k * ns + nu:(k + 1) * ns] = x_lo
        hi[k * ns + nu:(k + 1) * ns] = x_hi
    keep = np.isfinite(lo) | np.isfinite(hi)
    if not keep.any():
        keep[0] = True  # fully unconstrained: keep one inert row (nc ≥ 1)
    return A[keep], lo[keep], hi[keep]


# --------------------------------------------------------------------- #
# closed-loop rollout, plant state on the device                        #
# --------------------------------------------------------------------- #

def _rollout_impl(W_bank, B_bank, rhos, H, A, g0, g_x0, l0, u0_, lu_x0,
                  Kg, Ad, Bd, v0_scale, noise, y0, rho_ind0, x0,
                  W_hi=None, rho_eff=None, bias_c=None, M_hi=None, M_lo=None,
                  w_pri=None, w_dua=None, M_res=None, *,
                  nx_qp: int, nc: int, nu: int, Dp: int, n_steps: int,
                  max_iter: int, check_interval: int, adaptive_rho: bool,
                  adaptive_rho_tolerance: float, eps_abs: float,
                  rho_min: float, rho_max: float, chunk_runner,
                  iter_precision: str = "highest", refine: bool = True,
                  rho_jump: bool = False, adaptive_rho_interval: int = 1,
                  alpha: float = 1.0, check_infeasibility: bool = False,
                  eps_prim_inf: float = 1e-4, eps_dual_inf: float = 1e-4):
    """The loop-path rollout: one warm solve per control step.

    The g/l/u maps arrive PRE-SCALED into the solver's (possibly
    Ruiz-equilibrated) space; ``v0_scale`` maps the solved first-stage
    variable back to plant units. Returns ``(xs (T+1, nx), us (T, nu),
    iters (T,), status (T,), y_final, rho_ind_final)``; ``iters`` and
    ``status`` are CPU int32 tensors, the rest stay on the device.
    """
    from ..core.bank import Bank, DeviceQP
    from ..core.iteration import solve_loop

    dtype = y0.dtype
    dev = y0.device
    pad_lo = torch.full((Dp,), -float("inf"), dtype=dtype, device=dev)
    pad_hi = torch.full((Dp,), float("inf"), dtype=dtype, device=dev)
    # bank.b placeholder — the loop forms the bias lazily per rung
    b_unused = torch.zeros((rhos.shape[0], Dp), dtype=dtype, device=dev)
    # ONE stacked refresh matvec per step: g, the l/u shift, the feedback
    # term Kx and the plant drift Ax all consume the same x (Kx/Ax do not
    # depend on the solve, so computing them before it is exact).
    gl_map = torch.cat([g_x0, lu_x0, Kg, Ad], dim=0)
    n_g = g_x0.shape[0]
    n_lu = lu_x0.shape[0]
    n_u = Kg.shape[0]
    bank = Bank(W=W_bank, B=B_bank, b=b_unused, rhos=rhos)

    # the ladder index is carried on the device (for the kernel) and on the
    # host (to pick the rung's ρ without a sync)
    y, x = y0, x0
    rho_ind = int(rho_ind0)
    rho_ind_dev = torch.tensor(rho_ind, dtype=torch.int32, device=dev)
    xs, us, its, sts = [x0], [], [], []
    for t in range(n_steps):
        gs = gl_map @ x
        g = g0 + gs[:n_g]
        shift = gs[n_g:n_g + n_lu]
        kx = gs[n_g + n_lu:n_g + n_lu + n_u]
        ax = gs[n_g + n_lu + n_u:]
        lo = pad_lo.clone()
        lo[nx_qp:nx_qp + nc] = l0 + shift
        hi = pad_hi.clone()
        hi[nx_qp:nx_qp + nc] = u0_ + shift
        if M_hi is None:
            # b_k = B_k ḡ(x), formed per check window for the current
            # rung only
            bias_lazy = (None, B_bank, None, g)
        else:
            # State-affine bias precomputed in fp64 on the host:
            # b_k(x) = B_k(ḡ0 + Ḡx0 x) = c_k + M_k x, with M's storage
            # rounding removed by its cast residual M_lo.
            bias_lazy = (bias_c, M_hi, M_lo, x)
        qp = DeviceQP(H=H, g=g, A=A, lo=lo, hi=hi, w_pri=w_pri, w_dua=w_dua)
        res = solve_loop(
            bank, qp, y, rho_ind_dev, rhos[rho_ind], W_hi, rho_eff, bias_lazy,
            M_res,
            nx=nx_qp, nc=nc, max_iter=max_iter,
            check_interval=check_interval, adaptive_rho=adaptive_rho,
            adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
            rho_min=rho_min, rho_max=rho_max, chunk_runner=chunk_runner,
            iter_precision=iter_precision, refine=refine,
            rho_jump=rho_jump, adaptive_rho_interval=adaptive_rho_interval,
            alpha=alpha, with_obj=False,
            check_infeasibility=check_infeasibility,
            eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf)
        v0 = res.y[:nu] * v0_scale
        u = -kx + v0
        x = ax + Bd @ u + noise[t]
        y, rho_ind, rho_ind_dev = res.y, res.rho_ind, res.rho_ind_dev
        xs.append(x)
        us.append(u)
        its.append(res.iters)
        sts.append(res.status_code)
    us_t = torch.stack(us) if us else torch.zeros((0, nu), dtype=dtype,
                                                  device=dev)
    return (torch.stack(xs), us_t, torch.tensor(its, dtype=torch.int32),
            torch.tensor(sts, dtype=torch.int32), y, rho_ind)


def auto_check_interval(calib_iters, default_ci: int,
                        max_iter: int) -> int:
    """Check window from ci=1 calibration iteration counts.

    ``calib_iters``: per-step EXACT iteration needs of the calibration
    rollout (every iteration checks at ci=1). The first half is treated as
    transient; the window is the maximum WARM-step need, so every warm step
    certifies at its first residual check, CAPPED at ``default_ci`` (the
    window only ever shrinks from the settings default: ci=1 calibration
    walks the ρ ladder at every iteration, which inflates apparent warm
    needs). Falls back to ``default_ci`` when the "warm" steps still run
    long (>25% of ``max_iter``).
    """
    it = np.asarray(calib_iters)
    warm = it[len(it) // 2:] if len(it) > 1 else it
    need = int(warm.max()) if warm.size else default_ci
    if need > max(max_iter // 4, default_ci):
        return default_ci
    return int(min(max(need, 1), default_ci))


def mpc_rollout_scan(solver, prob: CondensedMPC, x_init, n_steps: int,
                     solve_max_iter: Optional[int] = None,
                     kernel: str = "loop", noise=None,
                     check_interval=None, calib_steps: int = 8,
                     return_stats: bool = False,
                     return_state: bool = False):
    """Closed-loop MPC rollout with the plant state on the device.

    Per control step: refresh ``g``/``l``/``u`` from the current plant
    state, run the warm-started solve loop (the bias is formed lazily for
    the current rung), apply ``u_0 = -K x + v_0`` to the plant and carry
    the solver state on. Returns ``(states (T+1, nx), controls (T, nu),
    iters (T,))``.

    Args:
      solver: a set-up ``ReLU_QP`` on ``prob``'s condensed QP.
      prob: the ``CondensedMPC`` maps.
      x_init: (nx,) initial plant state.
      n_steps: number of control steps.
      noise: optional (n_steps, nx_plant) process disturbance added to the
        plant update (numpy array or tensor).
      solve_max_iter: per-step iteration cap (defaults to settings).
      kernel: "loop" (each step's solve through the solve loop, i.e.
        kernel K1 on CUDA) or "auto" (= "loop" until K2 is ported);
        "scan" (whole-rollout kernel K2) and "fused" (whole-solve kernel
        K3) raise NotImplementedError.
      check_interval: ``None`` uses the solver settings; an int
        overrides; ``"auto"`` runs the first ``calib_steps`` steps at ci=1
        and sizes the window so every warm step certifies at its first
        check (``auto_check_interval``).
      return_stats: also return the per-step status codes.
      return_state: also return ``(y_final, rho_ind_final)``, to write
        back to ``solver.y`` / ``solver.rho_ind``.
    """
    stng = solver.settings
    dtype = stng.precision_dtype
    dev = stng.device
    npl = prob.K.shape[1]
    if noise is None:
        noise = torch.zeros((n_steps, npl), dtype=dtype, device=dev)
    else:
        noise = (noise.to(device=dev, dtype=dtype)
                 if isinstance(noise, torch.Tensor)
                 else torch.as_tensor(np.asarray(noise, np.float64),
                                      dtype=dtype, device=dev))
        if tuple(noise.shape) != (n_steps, npl):
            raise ValueError(f"noise must be (T={n_steps}, {npl})")
    n_used = [0]

    def run(ci, x0, y0, rho0, steps):
        w = noise[n_used[0]:n_used[0] + steps]
        n_used[0] += steps
        return _dispatch_rollout(solver, prob, x0, steps, solve_max_iter,
                                 kernel, ci, y0, rho0, w)

    if check_interval == "auto":
        out = _auto_ci_rollout(run, stng, x_init, n_steps, calib_steps,
                               solver.y, solver.rho_ind,
                               solve_max_iter or stng.max_iter)
    else:
        ci = (stng.check_interval if check_interval is None
              else int(check_interval))
        out = run(ci, x_init, solver.y, solver.rho_ind, n_steps)
    res = out[:3]
    if return_stats:
        res = res + (out[3],)
    if return_state:
        res = res + out[4:6]
    return res


def _auto_ci_rollout(run, stng, x_init, n_steps, calib_steps, y0, rho0,
                     max_iter):
    """``check_interval="auto"``: ci=1 calibration segment, window sizing,
    tuned continuation, stitched trajectory."""
    calib = max(1, min(int(calib_steps), int(n_steps)))
    st1, u1, it1, s1, y_f, r_f = run(1, x_init, y0, rho0, calib)
    ci = auto_check_interval(it1.numpy(), stng.check_interval, max_iter)
    if n_steps <= calib:
        return st1, u1, it1, s1, y_f, r_f
    st2, u2, it2, s2, y2, r2 = run(ci, st1[-1], y_f, r_f, n_steps - calib)
    return (torch.cat([st1, st2[1:]]), torch.cat([u1, u2]),
            torch.cat([it1, it2]), torch.cat([s1, s2]), y2, r2)


def _dispatch_rollout(solver, prob, x_init, n_steps, solve_max_iter,
                      kernel, ci, y0, rho_ind0, noise):
    """Single-segment rollout with an explicit check window and start
    state; returns ``(states, controls, iters, status, y_final,
    rho_ind_final)``."""
    if kernel not in ("loop", "fused", "auto", "scan"):
        raise ValueError("kernel must be 'loop', 'fused', 'scan' or "
                         "'auto'")
    if kernel == "scan":
        raise NotImplementedError(
            "kernel='scan' runs the whole-rollout kernel K2 "
            "(ops/solve_kernel.py full_rollout), which is not ported yet; "
            "use kernel='loop'")
    if kernel == "fused":
        raise NotImplementedError(
            "kernel='fused' runs the whole-solve kernel K3 "
            "(ops/solve_kernel.py full_solve) per step, which is not ported "
            "yet; use kernel='loop'")
    # "auto" is the loop path until K2 is ported.
    stng = solver.settings
    dtype = stng.precision_dtype
    dev = stng.device
    cst = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                    device=dev)
    nu = prob.K.shape[0]
    npl = prob.K.shape[1]
    # Map the receding-horizon update maps into the solver's (possibly
    # Ruiz-equilibrated) space: ḡ = c·D·g, l̄/ū = E·(l/u); the solved
    # first-stage variable unscales as v = D[:nu]·v̄.
    sc = solver.scal
    gD = sc.c * sc.D
    bias_c, M_hi, M_lo = _affine_bias_maps(
        solver._B_np, gD * prob.g0, gD[:, None] * prob.g_x0, dtype, dev)
    x0 = (x_init.to(device=dev, dtype=dtype)
          if isinstance(x_init, torch.Tensor) else cst(x_init))
    return _rollout_impl(
        solver.bank.W, solver.bank.B, solver.bank.rhos,
        solver.qp_dev.H, solver.qp_dev.A,
        cst(gD * prob.g0), cst(gD[:, None] * prob.g_x0),
        cst(sc.E * prob.l0), cst(sc.E * prob.u0),
        cst(sc.E[:, None] * prob.lu_x0), cst(prob.K),
        cst(solver_plant_A(prob)), cst(solver_plant_B(prob)),
        cst(sc.D[:nu]), noise, y0, rho_ind0, x0.reshape(npl),
        solver._W_hi, solver._rho_eff, bias_c, M_hi, M_lo,
        solver.qp_dev.w_pri, solver.qp_dev.w_dua,
        solver._M_res if solver._res_op_loop else None,
        nx_qp=solver.nx, nc=solver.nc, nu=nu, Dp=solver.Dp,
        n_steps=n_steps, max_iter=solve_max_iter or stng.max_iter,
        check_interval=ci,
        adaptive_rho=stng.adaptive_rho,
        adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
        eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
        rho_max=float(stng.rho_max), chunk_runner=solver._chunk_runner,
        iter_precision=stng.iter_precision, refine=bool(stng.refine),
        rho_jump=bool(stng.rho_jump),
        adaptive_rho_interval=int(stng.adaptive_rho_interval),
        alpha=float(stng.alpha),
        check_infeasibility=bool(stng.check_infeasibility),
        eps_prim_inf=float(stng.eps_prim_inf),
        eps_dual_inf=float(stng.eps_dual_inf))


def _cast_residual(arr64, dtype):
    """fp64 → the residual of its cast to ``dtype``, so that
    cast + residual ≈ arr64 to O(ulp²)."""
    arr64 = np.asarray(arr64, np.float64)
    if dtype == torch.float32:
        hi64 = arr64.astype(np.float32).astype(np.float64)
    else:   # bf16 has no numpy dtype
        hi64 = torch.as_tensor(arr64).to(dtype).double().numpy()
    return arr64 - hi64


def _affine_bias_fp64(B64, g0_s, gx0_s):
    """The fp64 products of the state-affine bias
    ``b_k(x) = B_k(ḡ0 + Ḡx0 x) = c_k + M_k x``: ``(c64 (N, Dp),
    M64 (N, Dp, nx_plant))``."""
    return (B64 @ np.asarray(g0_s, np.float64),
            B64 @ np.asarray(gx0_s, np.float64))


def _affine_bias_maps(B64, g0_s, gx0_s, dtype, device="cpu"):
    """fp64 host precompute of the state-affine bias refresh, cast for the
    loop rollout: ``(bias_c, M_hi, M_lo)`` in the iteration dtype.
    ``M_lo`` is M's cast residual (None when the cast is lossless, fp64).
    ``B64``: (N, Dp, nx) fp64 master; ``g0_s``/``gx0_s``: the SCALED g
    maps, (nx,) and (nx, nx_plant)."""
    c64, M64 = _affine_bias_fp64(B64, g0_s, gx0_s)
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    if dtype == torch.float64:
        return put(c64), put(M64), None
    return put(c64), put(M64), put(_cast_residual(M64, dtype))


def solver_plant_A(prob: CondensedMPC) -> np.ndarray:
    """Recover the plant ``Ad`` from the condensed maps.

    The first stage-block of ``G`` is ``[-K; Ā]`` and of ``F``'s first
    column ``[I; Bd]``, so ``Ad = Ā + Bd K``.
    """
    nx = prob.K.shape[1]
    nu = prob.K.shape[0]
    Bd = prob.F[nu:nu + nx, :nu]
    Abar = prob.G[nu:nu + nx, :]
    return Abar + Bd @ prob.K


def solver_plant_B(prob: CondensedMPC) -> np.ndarray:
    nx = prob.K.shape[1]
    nu = prob.K.shape[0]
    return prob.F[nu:nu + nx, :nu]
