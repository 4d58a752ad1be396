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
  (kernel K1 on CUDA); ``kernel="fused"`` runs each step's whole solve as
  one launch of the whole-solve kernel K3; ``kernel="scan"`` runs the
  whole rollout segment as one launch of the whole-rollout kernel K2;
- ``scenario_rollout_scan``: the closed loop of B plants under one
  controller on the batched solver: ``kernel="loop"`` one batched solve
  per step (kernel K4 on CUDA), ``kernel="scan"`` a whole segment as one
  launch of the batched whole-rollout kernel K6. On a batch solver split
  over a mesh each rank steps its own plants through the loop path (K4
  per rank, the exit collective).

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
import torch.distributed as dist

from ..core.graphs import sig, window_graphs
from ..core.iteration import STATUS_MAX_ITER
from ..ops.fused_step import (pad_dim, pallas_batched_chunk_runner,
                              round_up)
from ..parallel.sharded import gather_rows
from ..utils.timing import span
from ..ops.solve_kernel import (FullSolveOperand, build_residual_operator,
                                full_rollout, full_rollout_batched,
                                full_solve)

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
    "scenario_rollout_scan",
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

def _records(graphs, prefix: str, n_steps: int, x_shape, u_shape, dtype,
             dev):
    """A loop segment's static records, for capacity ``cap`` steps (the
    next power of two, so that segments of nearby lengths share graphs):
    states (cap+1, ...), controls (cap, ...), iterations and status (cap,)
    int32, the noise rows (cap, ...) and the device step index."""
    cap = _capacity(n_steps)
    buf = lambda name, shape, dt=dtype: graphs.buffer(prefix + name, shape,
                                                      dt, dev)
    i32 = torch.int32
    return dict(xs=buf("xs", (cap + 1, *x_shape)),
                us=buf("us", (cap, *u_shape)), its=buf("its", (cap,), i32),
                sts=buf("sts", (cap,), i32), noise=buf("noise",
                                                       (cap, *x_shape)),
                t=buf("t", (), torch.int64))


def _capacity(n_steps: int) -> int:
    return 1 << max(n_steps - 1, 0).bit_length()


def _record_step(rec: dict, x_new, u, iters, status) -> None:
    """A control step's plant state, control, iterations and status into
    the records at the device step index, which then moves on."""
    t = rec["t"].reshape(1)
    rec["xs"].index_copy_(0, t + 1, x_new[None])
    rec["us"].index_copy_(0, t, u[None])
    rec["its"].index_copy_(0, t, iters.reshape(1).to(torch.int32))
    rec["sts"].index_copy_(0, t, status.reshape(1).to(torch.int32))
    rec["t"].add_(1)


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
                  eps_prim_inf: float = 1e-4, eps_dual_inf: float = 1e-4,
                  _graphs=None):
    """The loop-path rollout: one warm solve per control step.

    The g/l/u maps arrive PRE-SCALED into the solver's (possibly
    Ruiz-equilibrated) space; ``v0_scale`` maps the solved first-stage
    variable back to plant units. Returns ``(xs (T+1, nx), us (T, nu),
    iters (T,), status (T,), y_final, rho_ind_final)``; ``iters`` and
    ``status`` are CPU int32 tensors, the rest stay on the device.

    A control step is one program (``core.graphs``): the refresh of g, l,
    u, the feedback and the drift from the plant state, the solve
    (``core.iteration.solve_program``: its start, windows, tail and exit
    on the device, its rung and ρ carried there from the last step), the
    plant step, and the step's records written at a device step index. On
    ``cuda`` a step is one graph launch (the JAX package's ``lax.scan``
    body) and the segment one host read at its end, of the iterations,
    the status and the final rung. ``_graphs``: the solver's
    ``core.graphs.WindowGraphs``.
    """
    dtype, dev = y0.dtype, y0.device
    graphs = window_graphs(_graphs, dev)
    # ONE stacked refresh matvec per step: g, the l/u shift, the feedback
    # term Kx and the plant drift Ax all consume the same x (Kx/Ax do not
    # depend on the solve, so computing them before it is exact).
    gl_map = graphs.stage("mpc.gl_map", torch.cat([g_x0, lu_x0, Kg, Ad]))
    sizes = (g_x0.shape[0], lu_x0.shape[0], Kg.shape[0], x0.shape[0], nx_qp,
             nc, nu, Dp, tuple(y0.shape), dtype, dev, _capacity(n_steps))
    kw = dict(max_iter=max_iter, check_interval=check_interval,
              adaptive_rho=adaptive_rho,
              adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
              rho_min=rho_min, rho_max=rho_max, chunk_runner=chunk_runner,
              iter_precision=iter_precision, refine=refine,
              rho_jump=rho_jump, adaptive_rho_interval=adaptive_rho_interval,
              alpha=alpha, check_infeasibility=check_infeasibility,
              eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf)
    # a control step's program is made once per solver, prob and segment
    # capacity: it closes over static buffers and these operands only
    prog, x, lo, hi, st, rec = graphs.made(
        ("mpc.step", gl_map, W_bank, B_bank, rhos, H, A, g0, l0, u0_, Bd,
         v0_scale, W_hi, rho_eff, bias_c, M_hi, M_lo, w_pri, w_dua, M_res,
         sizes, frozenset(kw.items())),
        lambda: _step_program(graphs, gl_map, W_bank, B_bank, rhos, H, A,
                              g0, l0, u0_, Bd, v0_scale, W_hi, rho_eff,
                              bias_c, M_hi, M_lo, w_pri, w_dua, M_res, y0,
                              sizes, kw))

    # the segment's start: the plant state, the solver state, the noise
    lo.fill_(-float("inf"))
    hi.fill_(float("inf"))
    x.copy_(x0)
    st.y.copy_(y0)
    if isinstance(rho_ind0, torch.Tensor):
        st.rho_ind.copy_(rho_ind0.reshape(()))
    else:
        st.rho_ind.fill_(int(rho_ind0))
    rec["xs"][0].copy_(x0)
    rec["noise"][:n_steps].copy_(noise)
    rec["t"].zero_()
    for _ in range(n_steps):
        graphs.program(prog, dev)
    # the segment's one host read
    its, sts, rung = graphs.read(rec["its"][:n_steps], rec["sts"][:n_steps],
                                 st.rho_ind, programs=(prog,))
    return (rec["xs"][:n_steps + 1].clone(), rec["us"][:n_steps].clone(),
            torch.from_numpy(its), torch.from_numpy(sts), st.y.clone(),
            int(rung))


def _step_program(graphs, gl_map, W_bank, B_bank, rhos, H, A, g0, l0, u0_,
                  Bd, v0_scale, W_hi, rho_eff, bias_c, M_hi, M_lo, w_pri,
                  w_dua, M_res, y0, sizes, kw):
    """A loop-path control step as a program (``_rollout_impl``'s) and the
    static buffers it works on: ``(program, x, lo, hi, state, records)``."""
    from ..core.bank import Bank, DeviceQP
    from ..core.iteration import solve_program, state_buffers

    n_g, n_lu, n_u, npl, nx_qp, nc, nu, Dp, _, dtype, dev, cap = sizes
    buf = lambda name, shape, dt=dtype: graphs.buffer("mpc." + name, shape,
                                                      dt, dev)
    x, g, kx, ax = buf("x", (npl,)), buf("g", (nx_qp,)), buf("kx", (n_u,)), \
        buf("ax", (npl,))
    lo, hi = buf("lo", (Dp,)), buf("hi", (Dp,))
    max_iter = kw["max_iter"]
    st = state_buffers(graphs, "mpc.", y0, nx_qp, nc,
                       check_infeasibility=kw["check_infeasibility"],
                       two_phase=(kw["refine"]
                                  and kw["iter_precision"] != "highest"))
    rec = _records(graphs, "mpc.", cap, (npl,), (nu,), dtype, dev)
    qp = DeviceQP(H=H, g=g, A=A, lo=lo, hi=hi, w_pri=w_pri, w_dua=w_dua)
    bank = Bank(W=W_bank, B=B_bank, b=None, rhos=rhos)
    if M_hi is None:
        # b_k = B_k ḡ(x), formed per check window for the current rung only
        bias_lazy = (None, B_bank, None, g)
    else:
        # State-affine bias precomputed in fp64 on the host:
        # b_k(x) = B_k(ḡ0 + Ḡx0 x) = c_k + M_k x, with M's storage
        # rounding removed by its cast residual M_lo.
        bias_lazy = (bias_c, M_hi, M_lo, x)

    def refresh():
        gs = gl_map @ x
        g.copy_(g0 + gs[:n_g])
        shift = gs[n_g:n_g + n_lu]
        kx.copy_(gs[n_g + n_lu:n_g + n_lu + n_u])
        ax.copy_(gs[n_g + n_lu + n_u:])
        lo[nx_qp:nx_qp + nc] = l0 + shift
        hi[nx_qp:nx_qp + nc] = u0_ + shift
        # the solve starts from the carried rung's ρ, indexed on the device
        st.rho.copy_(rhos.index_select(0, st.rho_ind.reshape(1))[0])

    def plant():
        v0 = st.y[:nu] * v0_scale
        u = -kx + v0
        x_new = ax + Bd @ u + rec["noise"].index_select(
            0, rec["t"].reshape(1))[0]
        x.copy_(x_new)
        status = torch.where(st.status < 0, STATUS_MAX_ITER, st.status)
        iters = torch.where(status != STATUS_MAX_ITER, st.k, max_iter)
        _record_step(rec, x_new, u, iters, status)

    touched = sig((gl_map, g0, l0, u0_, x, g, kx, ax, lo, hi, rhos, Bd,
                   v0_scale, st, tuple(rec.values()))) + (
        n_g, n_lu, n_u, nx_qp, nc, nu, max_iter)
    prog, _ = solve_program(
        graphs, bank, qp, st, W_hi, rho_eff, bias_lazy, M_res, nx=nx_qp,
        nc=nc, with_obj=False, with_result=False,
        pre=(("refresh", touched), refresh),
        post=(("plant", touched), plant), prefix="mpc.", **kw)
    return prog, x, lo, hi, st, rec


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
    state, run the warm-started solve (the bias is formed for the current
    rung), apply ``u_0 = -K x + v_0`` to the plant and carry the solver
    state on. Returns ``(states (T+1, nx), controls (T, nu), iters (T,))``;
    ``iters`` (and the status codes) are CPU int32 tensors.

    Args:
      solver: a set-up ``ReLU_QP`` on ``prob``'s condensed QP.
      prob: the ``CondensedMPC`` maps.
      x_init: (nx,) initial plant state.
      n_steps: number of control steps.
      noise: optional (n_steps, nx_plant) process disturbance added to the
        plant update (numpy array or tensor).
      solve_max_iter: per-step iteration cap (defaults to settings).
      kernel: "loop" (each step's solve through the solve loop, i.e.
        kernel K1 on CUDA); "scan" — every control step of a segment in
        ONE launch of the whole-rollout kernel K2
        (``ops.solve_kernel.full_rollout``; its plain torch version on
        the CPU), which needs alpha=1, no infeasibility checks,
        iter_precision="highest" or refine=False, and an iteration budget
        of at least one check window (the budget is rounded down to whole
        windows); "auto" takes "scan" on CUDA whenever it is eligible,
        else "loop" (always "loop" on the CPU and for a tensor-parallel
        solver), never "fused"; "fused" —
        each control step's whole solve as ONE launch of the whole-solve
        kernel K3 (``ops.solve_kernel.full_solve``; its plain version on
        the CPU), which needs alpha=1, no infeasibility checks and the
        lane-padded layout (any iteration budget: K3 runs the
        ``max_iter % check_interval`` tail window).
      check_interval: ``None`` uses the solver settings; an int
        overrides; ``"auto"`` runs the first ``calib_steps`` steps at ci=1
        and sizes the window so every warm step certifies at its first
        check (``auto_check_interval``).
      return_stats: also return the per-step status codes.
      return_state: also return ``(y_final, rho_ind_final)``, to write
        back to ``solver.y`` / ``solver.rho_ind``.

    The call is the span ``rollout`` (``utils.timing.span``) and, on the
    scan path, each segment's staging, launch, read and finish are its
    ``rollout.stage``, ``rollout.launch``, ``rollout.read`` and
    ``rollout.finish``.
    """
    with span("rollout"):
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
    if kernel == "fused":
        if not _kernel_rollout_eligible(solver):
            raise ValueError(
                "kernel='fused' rollout needs alpha=1, no infeasibility "
                "checks, the fp64 bias masters, and the lane-padded layout "
                "(not backend='xla')")
        return _kernel_rollout(solver, prob, x_init, n_steps, solve_max_iter,
                               ci, y0, rho_ind0, noise)
    stng = solver.settings
    if kernel == "auto":
        # K2 on the card by the static gate, with no fallback: once picked
        # it runs or the call raises. The CPU keeps the loop path, as the
        # JAX package picks "scan" only on its accelerator.
        kernel = ("scan" if stng.device.type == "cuda"
                  and _scan_rollout_eligible(solver, ci, solve_max_iter)
                  else "loop")
    if kernel == "scan":
        if not _scan_rollout_eligible(solver, ci, solve_max_iter):
            raise ValueError(
                "kernel='scan' rollout needs alpha=1, iter_precision="
                "'highest' or refine=False, no infeasibility checks, the "
                "fp64 bias masters, and an iteration budget of at least one "
                "full check window")
        return _scan_rollout(solver, prob, x_init, n_steps, solve_max_iter,
                             ci, y0, rho_ind0, noise)
    dtype = stng.precision_dtype
    dev = stng.device
    nu = prob.K.shape[0]
    npl = prob.K.shape[1]
    # the update maps in the solver's (possibly Ruiz-equilibrated) space,
    # made once per prob and bank: the solves' graphs key them by identity
    maps, (bias_c, M_hi, M_lo) = _loop_scenario_operands(solver, prob)
    x0 = (x_init.to(device=dev, dtype=dtype)
          if isinstance(x_init, torch.Tensor)
          else torch.as_tensor(np.asarray(x_init, np.float64), dtype=dtype,
                               device=dev))
    return _rollout_impl(
        solver.bank.W, solver.bank.B, solver.bank.rhos,
        solver.qp_dev.H, solver.qp_dev.A, *maps, noise, y0, rho_ind0,
        x0.reshape(npl),
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
        eps_dual_inf=float(stng.eps_dual_inf),
        _graphs=solver._window_graphs)


def _kernel_rollout_eligible(solver) -> bool:
    """Gate for the whole-solve-kernel rollout (K3 per control step): alpha=1,
    no infeasibility certificates, the fp64 bias master, and the solver's
    lane-padded layout (the rollout hands ``solver.bank.W`` to K3 as it
    is). The TPU's Mosaic and VMEM clauses do not apply on the card."""
    stng = solver.settings
    return (stng.alpha == 1.0 and not stng.check_infeasibility
            and getattr(solver, "_B_np", None) is not None
            and solver._tp_group is None
            and solver.Dp == pad_dim(solver.D))


def _fused_operands(solver, prob: CondensedMPC) -> dict:
    """The constant operands of the whole-solve-kernel rollout, cached on
    the solver per prob and bank: the residual operator, the state-affine
    bias ``b_k(x) = c_k + x @ M_aff[k]`` (c_k as the bank rows, M_aff
    (N, nplp, Dp) transposed and lane-padded from the fp64 master), the
    stacked refresh map [wd·Ḡx; Ē·LUx] and the plant maps, in the
    solver's dtype on its device."""
    cache = getattr(solver, "_fused_ops_cache", None)
    if cache is not None and cache[0] == id(prob) \
            and cache[3] is solver.bank.W:
        return cache[1]
    stng = solver.settings
    dtype, dev = stng.precision_dtype, stng.device
    cst = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                    device=dev)
    nu, npl = prob.K.shape
    sc = solver.scal
    gD = sc.c * sc.D
    g0_s = gD * prob.g0
    gx0_s = gD[:, None] * prob.g_x0
    wd = np.ones(solver.nx) if solver._w_dua_np is None \
        else np.asarray(solver._w_dua_np, np.float64)
    M_res, _, nxp, ncp = build_residual_operator(
        solver._H_s, solver._A_s, solver._g_s, solver.Dp, dtype,
        w_pri=solver._w_pri_np, w_dua=solver._w_dua_np, device=dev)
    # M's storage rounding is accepted here, as in the JAX package (the
    # loop path's M_lo compensation is below the fp32 iterate's own noise)
    c64, M64 = _affine_bias_fp64(solver._B_np, g0_s, gx0_s)
    nplp = pad_dim(npl)
    M_aff = np.zeros((c64.shape[0], nplp, solver.Dp))
    M_aff[:, :npl, :] = np.swapaxes(M64, 1, 2)
    ops = dict(
        M_res=M_res, M_aff=cst(M_aff), bias_c=cst(c64),
        gl_map=cst(np.concatenate([wd[:, None] * gx0_s,
                                   sc.E[:, None] * prob.lu_x0], axis=0)),
        g0w=cst(wd * g0_s), l0=cst(sc.E * prob.l0), u0=cst(sc.E * prob.u0),
        Kg=cst(prob.K), Ad=cst(solver_plant_A(prob)),
        Bd=cst(solver_plant_B(prob)), v0_scale=cst(sc.D[:nu]), nxp=nxp,
        ncp=ncp, nplp=nplp)
    # prob is held so that its id stays unique while the entry lives
    solver._fused_ops_cache = (id(prob), ops, prob, solver.bank.W)
    return ops


def _fused_step(solver, ops: dict, x):
    """One control step's K3 operand and state-affine bias for the plant
    state ``x`` (npl,): the refreshed weighted g row and bounds, and
    ``(M_aff, x_row)``. Returns ``(op, bias_affine)``."""
    dtype, dev = x.dtype, x.device
    nx, nc, Dp = solver.nx, solver.nc, solver.Dp
    gs = ops["gl_map"] @ x
    g_row = torch.zeros((1, ops["nxp"]), dtype=dtype, device=dev)
    g_row[0, :nx] = ops["g0w"] + gs[:nx]
    lo = torch.full((Dp,), -float("inf"), dtype=dtype, device=dev)
    hi = torch.full((Dp,), float("inf"), dtype=dtype, device=dev)
    lo[nx:nx + nc] = ops["l0"] + gs[nx:]
    hi[nx:nx + nc] = ops["u0"] + gs[nx:]
    x_row = torch.zeros((ops["nplp"],), dtype=dtype, device=dev)
    x_row[:x.shape[0]] = x
    op = FullSolveOperand(Wt_bank=solver.bank.W, b_bank=ops["bias_c"],
                          rhos=solver.bank.rhos, M_res=ops["M_res"],
                          g_row=g_row, lo=lo, hi=hi)
    return op, (ops["M_aff"], x_row)


def _fused_kw(solver, ops: dict, solve_max_iter=None, ci=None) -> dict:
    """The settings of the rollout's K3 launches."""
    stng = solver.settings
    return dict(nx=solver.nx, nc=solver.nc, nxp=ops["nxp"], ncp=ops["ncp"],
                max_iter=solve_max_iter or stng.max_iter,
                check_interval=stng.check_interval if ci is None
                else int(ci),
                adaptive_rho=stng.adaptive_rho,
                adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
                eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
                rho_max=float(stng.rho_max), rho_jump=bool(stng.rho_jump),
                adaptive_rho_interval=int(stng.adaptive_rho_interval),
                iter_precision=stng.iter_precision,
                refine=bool(stng.refine), verbose=bool(stng.verbose))


def _kernel_rollout(solver, prob: CondensedMPC, x_init, n_steps: int,
                    solve_max_iter, ci, y0, rho_ind0, noise):
    """The whole-solve-kernel rollout: per control step the whole solve,
    with the state-affine bias refreshed inside, is ONE launch of K3
    (``full_solve``); the g/bound refresh (``_fused_step``) and the plant
    step are plain torch between launches. The start rung of each solve is
    the previous solve's final rung, read on the device, so nothing syncs
    until the per-step stats are read once at the end. Returns
    ``(states, controls, iters, status, y_final, rho_ind_final)`` like the
    other paths."""
    stng = solver.settings
    dtype, dev = stng.precision_dtype, stng.device
    ops = _fused_operands(solver, prob)
    kw = _fused_kw(solver, ops, solve_max_iter, ci)
    nu, npl = prob.K.shape
    x = (x_init.to(device=dev, dtype=dtype) if isinstance(x_init, torch.Tensor)
         else torch.as_tensor(np.asarray(x_init, np.float64), dtype=dtype,
                              device=dev)).reshape(npl)
    y = solver.y if y0 is None else y0
    rho0 = int(solver.rho_ind if rho_ind0 is None else rho_ind0)
    rho = (torch.tensor([rho0], dtype=torch.int32, device=dev)
           if dev.type == "cuda" else rho0)
    xs, us, stats = [x], [], []
    for t in range(n_steps):
        op, bias = _fused_step(solver, ops, x)
        y, st = full_solve(op, y, rho, bias, **kw)
        rho = (st[4:5].to(torch.int32) if dev.type == "cuda"
               else int(st[4]))
        u = -(ops["Kg"] @ x) + y[:nu] * ops["v0_scale"]
        x = ops["Ad"] @ x + ops["Bd"] @ u + noise[t]
        xs.append(x)
        us.append(u)
        stats.append(st)
    # the segment's one device→host read
    st = torch.stack(stats).cpu() if stats else torch.zeros((0, 8))
    us_t = torch.stack(us) if us else torch.zeros((0, nu), dtype=dtype,
                                                  device=dev)
    rho_f = int(st[-1, 4]) if n_steps else rho0
    return (torch.stack(xs), us_t, st[:, 0].to(torch.int32),
            st[:, 5].to(torch.int32), y, rho_f)


def _scan_rollout_eligible(solver, ci=None, budget=None) -> bool:
    """Gate for the whole-rollout kernel K2 on any device: alpha=1, no
    infeasibility certificates, single-phase iteration (reduced
    ``iter_precision`` only with ``refine=False``: K2 carries no two-phase
    refine; its residual checks always run at full precision), the fp64
    bias master, and an iteration budget (``solve_max_iter`` or
    ``settings.max_iter``) that holds at least one full check window — K2
    runs whole windows only and never rounds a budget up — and no
    tensor-parallel solver (``setup(mesh=)``): K2 holds the whole bank, so
    such a solver's rollout takes the loop path, as in the JAX package.
    The TPU's VMEM gates do not apply on the card (ROADMAP §C)."""
    stng = solver.settings
    if stng.alpha != 1.0 or stng.check_infeasibility \
            or getattr(solver, "_B_np", None) is None \
            or solver._tp_group is not None:
        return False
    if stng.iter_precision != "highest" and stng.refine:
        return False
    ci_eff = stng.check_interval if ci is None else int(ci)
    eff_budget = stng.max_iter if budget is None else int(budget)
    return eff_budget >= ci_eff


def _build_rollout_operators(prob: CondensedMPC, sc, H_s, A_s, wp_np, wd_np,
                             B64, nx_qp: int, nc: int, Dp: int, dtype,
                             device="cpu"):
    """Host fp64 build of the K2 operands, then cast: the residual
    operator, the state-affine bias ``b_k(x) = c_k + x @ M_aff[k]``, the
    stacked refresh operator GL (segments [wd·Ḡx | Ē·LUx | Kᵀ | Adᵀ] with
    the bound-shift segment pre-scattered into Dp layout, zeros in the
    padding, so the ±inf bounds stay inf), the base bounds, the v0
    selector and the plant-step map.

    ``B64``: the fp64 bias master padded to (N, Dp, nx_qp). Returns a dict
    of tensors of ``dtype`` on ``device`` plus the padded dims.
    """
    cst = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                    device=device)
    nu = prob.K.shape[0]
    npl = prob.K.shape[1]
    gD = sc.c * sc.D
    g0_s = gD * prob.g0
    gx0_s = gD[:, None] * prob.g_x0
    wd = np.ones(nx_qp) if wd_np is None else np.asarray(wd_np, np.float64)
    M_res, _, nxp, ncp = build_residual_operator(
        H_s, A_s, np.zeros(nx_qp), Dp, dtype, w_pri=wp_np, w_dua=wd_np,
        device=device)
    c64, M64 = _affine_bias_fp64(B64, g0_s, gx0_s)
    nplp, nup = pad_dim(npl), pad_dim(nu)
    n_rho = B64.shape[0]
    M_aff = np.zeros((n_rho, nplp, Dp))
    M_aff[:, :npl, :] = np.swapaxes(M64, 1, 2)
    GL = np.zeros((nplp, nxp + Dp + nup + nplp))
    GL[:npl, :nx_qp] = (wd[:, None] * gx0_s).T
    GL[:npl, nxp + nx_qp:nxp + nx_qp + nc] = (sc.E[:, None] * prob.lu_x0).T
    GL[:npl, nxp + Dp:nxp + Dp + nu] = prob.K.T
    GL[:npl, nxp + Dp + nup:nxp + Dp + nup + npl] = solver_plant_A(prob).T
    g0w = np.zeros((1, nxp))
    g0w[0, :nx_qp] = wd * g0_s
    lo0 = np.full((1, Dp), -np.inf)
    hi0 = np.full((1, Dp), np.inf)
    lo0[0, nx_qp:nx_qp + nc] = sc.E * prob.l0
    hi0[0, nx_qp:nx_qp + nc] = sc.E * prob.u0
    S_u = np.zeros((Dp, nup))
    S_u[np.arange(nu), np.arange(nu)] = np.asarray(sc.D[:nu], np.float64)
    Bdw = np.zeros((nup, nplp))
    Bdw[:nu, :npl] = solver_plant_B(prob).T
    return dict(M_res=M_res, bias_c=cst(c64), M_aff=cst(M_aff), GL=cst(GL),
                g0w=cst(g0w), lo0=cst(lo0), hi0=cst(hi0), S_u=cst(S_u),
                Bdw=cst(Bdw), nxp=nxp, ncp=ncp, nplp=nplp, nup=nup)


def _scan_operands(solver, prob, Dp: int) -> dict:
    """``_build_rollout_operators`` for this solver and prob, plus the bank
    at the kernel's padded dim, cached on the solver per (prob, Dp) and
    bank (the check_interval="auto" segments and repeated rollouts reuse
    them)."""
    cache = getattr(solver, "_scan_ops_cache", None)
    key = (id(prob), Dp)
    if cache is not None and cache[0] == key and cache[3] is solver.bank.W:
        return cache[1]
    stng = solver.settings
    dev = stng.device
    B64 = solver._B_np
    W = solver.bank.W
    if solver.Dp != Dp:
        # an unpadded solver layout (backend="xla"): pad the kernel's own
        # operand copies, once
        B_p = np.zeros((B64.shape[0], Dp, solver.nx))
        B_p[:, :B64.shape[1], :] = B64
        B64 = B_p
        W_p = torch.zeros((W.shape[0], Dp, Dp), dtype=W.dtype, device=dev)
        W_p[:, :W.shape[1], :W.shape[2]] = W
        W = W_p
    ops = _build_rollout_operators(
        prob, solver.scal, solver._H_s, solver._A_s, solver._w_pri_np,
        solver._w_dua_np, B64, solver.nx, solver.nc, Dp,
        stng.precision_dtype, dev)
    ops["Wt"] = W
    # prob is held so that its id stays unique while the entry lives
    solver._scan_ops_cache = (key, ops, prob, solver.bank.W)
    return ops


def _scan_call(solver, prob: CondensedMPC, x_init, n_steps: int, ci=None,
               budget=None, y0=None, rho_ind0=None, noise=None):
    """The arguments ``(args, kw)`` of one K2 launch, ``full_rollout(*args,
    **kw)``, for a rollout segment: the cached ``_scan_operands``, the start
    state ``y0`` (default ``solver.y``, padded to the kernel's layout) and
    rung (default ``solver.rho_ind``), ``x_init`` and ``noise`` (T,
    nx_plant; default zero) padded to the kernel's plant width on the
    solver's device, and the budget (default ``settings.max_iter``) rounded
    down to whole check windows."""
    stng = solver.settings
    dtype = stng.precision_dtype
    dev = stng.device
    npl = prob.K.shape[1]
    D = solver.D
    Dp = pad_dim(D)
    ops = _scan_operands(solver, prob, Dp)
    nplp = ops["nplp"]
    ci_eff = stng.check_interval if ci is None else int(ci)
    budget = budget or stng.max_iter
    if budget < ci_eff:
        # never round a sub-window budget UP to a full window: that would
        # exceed the caller's per-step iteration cap
        raise ValueError(
            f"scan-rollout iteration budget {budget} is smaller than one "
            f"check window ({ci_eff}); lower check_interval or raise the "
            "budget")
    # whole windows only: round the budget DOWN to a multiple of the window
    mi = (budget // ci_eff) * ci_eff
    y0 = solver.y if y0 is None else y0
    if y0.shape[0] != Dp:    # unpadded-solver state -> kernel layout
        y_p = torch.zeros((Dp,), dtype=dtype, device=dev)
        y_p[:D] = y0[:D]
        y0 = y_p
    rho_ind0 = solver.rho_ind if rho_ind0 is None else int(rho_ind0)
    x0 = torch.zeros((nplp,), dtype=dtype, device=dev)
    x0[:npl] = (x_init.to(device=dev, dtype=dtype).reshape(npl)
                if isinstance(x_init, torch.Tensor)
                else torch.as_tensor(np.asarray(x_init, np.float64)
                                     .reshape(npl), dtype=dtype, device=dev))
    noise_k = torch.zeros((n_steps, nplp), dtype=dtype, device=dev)
    if noise is not None:
        noise_k[:, :npl] = torch.as_tensor(noise, dtype=dtype, device=dev)
    args = [ops["Wt"], ops["bias_c"], ops["M_aff"], solver.bank.rhos,
            ops["M_res"], ops["g0w"], ops["GL"], ops["lo0"], ops["hi0"],
            ops["S_u"], ops["Bdw"], y0, x0, noise_k, rho_ind0]
    kw = dict(nx=solver.nx, nc=solver.nc, nxp=ops["nxp"], ncp=ops["ncp"],
              nup=ops["nup"], nplp=nplp, n_steps=n_steps, max_iter=mi,
              check_interval=ci_eff, adaptive_rho=stng.adaptive_rho,
              adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
              eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
              rho_max=float(stng.rho_max), rho_jump=bool(stng.rho_jump),
              adaptive_rho_interval=int(stng.adaptive_rho_interval),
              iter_precision=stng.iter_precision)
    return args, kw


def _scan_rollout(solver, prob: CondensedMPC, x_init, n_steps: int,
                  solve_max_iter, ci, y0, rho_ind0, noise=None):
    """One rollout segment as one launch of K2 (``full_rollout``): every
    per-step refresh is a product with the ``_build_rollout_operators``
    operands. Reads the per-step stats back once, so ``iters``/``status``
    come back as CPU int32 tensors and the final rung as an int."""
    with span("rollout.stage"):
        args, kw = _scan_call(solver, prob, x_init, n_steps, ci,
                              solve_max_iter, y0, rho_ind0, noise)
    xs, us, stats, y_f = full_rollout(*args, **kw)
    with span("rollout.read"):
        st = stats.cpu()   # the segment's one device→host read
    with span("rollout.finish"):
        nu, npl = prob.K.shape
        x0, rho_ind0 = args[12], args[14]
        states = torch.cat([x0[None, :npl], xs[:, :npl]])
        rho_f = int(st[-1, 4]) if n_steps else rho_ind0
        # kernel padding slots are exactly 0, so slicing back is lossless
        return (states, us[:, :nu], st[:, 0].to(torch.int32),
                st[:, 5].to(torch.int32), y_f[:solver.Dp], rho_f)


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


# --------------------------------------------------------------------- #
# scenario MPC: a batch of plants under one controller                  #
# --------------------------------------------------------------------- #

def _scenario_rollout_impl(Wt_bank, rhos, H, A, g0, g_x0, l0, u0_, lu_x0, Kg,
                           Ad, Bd, v0_scale, noise, Y0, rho_ind0, X0,
                           Wt_hi=None, rho_eff=None, bias_c=None, M_hi=None,
                           M_lo=None, w_pri=None, w_dua=None, done0=None, *,
                           nx_qp: int, nc: int, nu: int, n_steps: int,
                           max_iter: int, check_interval: int,
                           adaptive_rho: bool,
                           adaptive_rho_tolerance: float, eps_abs: float,
                           rho_min: float, rho_max: float, rho_jump: bool,
                           chunk_runner=None, iter_precision: str = "highest",
                           refine: bool = True,
                           adaptive_rho_interval: int = 1,
                           alpha: float = 1.0,
                           check_infeasibility: bool = False,
                           eps_prim_inf: float = 1e-4,
                           eps_dual_inf: float = 1e-4, group=None,
                           _graphs=None):
    """The loop-path scenario rollout: one batched warm solve per control
    step for the whole ensemble.

    Per step every scenario's g, l, u refresh from its own plant state, the
    batched solve (``core.batched.batch_program``, rho_mode "shared", from
    the carried states and rung) runs with the state-affine bias ``c_k + X
    M_kᵀ`` formed for the current rung once per window, and each plant
    steps with its own control and noise row. ``Y0`` may hold padded rows
    (``done0``): they run the x = 0 scenario, start done and are sliced
    off. Returns ``(states (T+1, B, nx), controls (T, B, nu), iters (T,),
    status (T,), Y_final, rho_ind_final)``; the status lane is ``min`` over
    the scenarios of the step's status codes, as the JAX package reduces it
    (an infeasible scenario reads as SOLVED next to solved ones;
    ROADMAP §C, F-w2). ``iters``/``status`` are CPU int32 tensors.

    A control step is one program (``core.graphs``), on ``cuda`` one graph
    launch, and the segment one host read at its end. With a process
    ``group`` the rows are this rank's plants: every solve's exit is
    collective, walked window by window from the host, and the status lane
    is the ``min`` over every rank's scenarios (one all-reduce per
    segment). ``_graphs``: the batch solver's ``core.graphs.WindowGraphs``.
    """
    from ..core import batched as cb

    B_pad, Dp = Y0.shape
    B_n, npl = X0.shape
    dtype, dev = Y0.dtype, Y0.device
    graphs = window_graphs(_graphs, dev)
    rhos_t = cb._rhos_in(graphs, rhos, dtype)
    st, cold = cb._cold_state(graphs, Y0, rho_ind0, rhos_t, done0, max_iter,
                              check_infeasibility, nx_qp, nc, alpha,
                              rho_eff, refine and iter_precision != "highest")
    sizes = (B_pad, Dp, B_n, npl, g0.shape[0], nx_qp, nc, nu, dtype, dev,
             _capacity(n_steps))
    kw = dict(shared=True, chunk_runner=chunk_runner or cb._chunk_shared_rho,
              nx=nx_qp, nc=nc, max_iter=max_iter,
              check_interval=check_interval, adaptive_rho=adaptive_rho,
              adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
              rho_min=rho_min, rho_max=rho_max, rho_jump=rho_jump,
              check_infeasibility=check_infeasibility,
              eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf,
              iter_precision=iter_precision, refine=refine,
              adaptive_rho_interval=adaptive_rho_interval, alpha=alpha,
              group=group, stats=False)
    # a control step's program is made once per solver, prob and segment
    # capacity: it closes over static buffers and these operands only
    prog, Xp, lo, hi, rec = graphs.made(
        ("scen.step", Wt_bank, Wt_hi, rhos_t, H, A, g0, g_x0, l0, u0_, lu_x0,
         Kg, Ad, Bd, v0_scale, rho_eff, bias_c, M_hi, M_lo, w_pri, w_dua, st,
         cold[0], sizes, frozenset(kw.items())),
        lambda: _scenario_step_program(
            graphs, Wt_bank, Wt_hi, rhos_t, H, A, g0, g_x0, l0, u0_, lu_x0,
            Kg, Ad, Bd, v0_scale, rho_eff, bias_c, M_hi, M_lo, w_pri, w_dua,
            st, cold, sizes, kw))
    X = Xp[:B_n]

    # the segment's start: the plant states, the noise
    lo.fill_(-float("inf"))
    hi.fill_(float("inf"))
    Xp.zero_()
    X.copy_(X0)
    rec["xs"][0].copy_(X0)
    rec["noise"][:n_steps].copy_(noise)
    rec["t"].zero_()
    for _ in range(n_steps):
        graphs.program(prog, dev, per_window=group is not None)
    sts = rec["sts"][:n_steps]
    if group is not None and n_steps:
        sts = sts.clone()
        dist.all_reduce(sts, op=dist.ReduceOp.MIN, group=group)
    # the segment's one host read
    its, sts, rung = graphs.read(rec["its"][:n_steps], sts, st.rho_ind,
                                 programs=(prog,))
    return (rec["xs"][:n_steps + 1].clone(), rec["us"][:n_steps].clone(),
            torch.from_numpy(its), torch.from_numpy(sts), st.Y.clone(),
            int(rung))


def _scenario_step_program(graphs, Wt_bank, Wt_hi, rhos_t, H, A, g0, g_x0,
                           l0, u0_, lu_x0, Kg, Ad, Bd, v0_scale, rho_eff,
                           bias_c, M_hi, M_lo, w_pri, w_dua, st, cold, sizes,
                           kw):
    """A scenario control step as a program (``_scenario_rollout_impl``'s)
    and the static buffers it works on: ``(program, padded plant states,
    lo, hi, records)``."""
    from ..core import batched as cb

    B_pad, Dp, B_n, npl, n_g, nx_qp, nc, nu, dtype, dev, cap = sizes
    buf = lambda name, shape: graphs.buffer("scen." + name, shape, dtype, dev)
    # the plant states, padded rows 0 (the x = 0 scenario); X its first rows
    Xp = buf("X", (B_pad, npl))
    X = Xp[:B_n]
    G, lo, hi = buf("G", (B_pad, n_g)), buf("lo", (B_pad, Dp)), \
        buf("hi", (B_pad, Dp))
    rec = _records(graphs, "scen.", cap, (B_n, npl), (B_n, nu), dtype, dev)
    ops = cb._Ops(rhos_t, H, A, G, lo, hi, w_pri, w_dua, rho_eff,
                  ("lazy", bias_c, M_hi, M_lo, Xp))

    def refresh():
        G.copy_(g0[None, :] + Xp @ g_x0.T)
        shift = Xp @ lu_x0.T
        lo[:, nx_qp:nx_qp + nc] = l0[None, :] + shift
        hi[:, nx_qp:nx_qp + nc] = u0_[None, :] + shift

    def plant():
        # unscale the first-stage variable back to plant units
        V0 = st.Y[:B_n, :nu] * v0_scale[None, :]
        U = -(X @ Kg.T) + V0
        X_new = (X @ Ad.T + U @ Bd.T) + rec["noise"].index_select(
            0, rec["t"].reshape(1))[0]
        X.copy_(X_new)
        _record_step(rec, X_new, U, st.k, st.status[:B_n].min())

    touched = sig((Xp, G, lo, hi, g0, g_x0, l0, u0_, lu_x0, Kg, Ad, Bd,
                   v0_scale, st, tuple(rec.values()))) + (nx_qp, nc, nu, B_n)
    prog, _ = cb.batch_program(
        graphs, ops, st, Wt_bank, Wt_hi, cold=cold,
        pre=(("refresh", touched), refresh),
        post=(("plant", touched), plant), **kw)
    return prog, Xp, lo, hi, rec


def scenario_rollout_scan(batch_solver, prob: CondensedMPC, X_init,
                          n_steps: int, noise=None,
                          solve_max_iter: Optional[int] = None,
                          kernel: str = "loop", check_interval=None,
                          calib_steps: int = 8, return_stats: bool = False,
                          return_state: bool = False):
    """Closed-loop SCENARIO MPC: B plants under one shared condensed
    controller.

    Per step every scenario's (g, l, u) refreshes from its own plant state,
    the batched shared-bank solver runs all scenarios with one shared ρ
    rung and a collective exit, and each plant steps with its own control
    (plus an optional per-scenario disturbance ``noise (T, B, nx)``).

    Args:
      batch_solver: a ``BatchedReLU_QP`` set up on ``prob``'s condensed QP
        for B scenarios (shared H/A; its g/l/u are refreshed per step),
        ``rho_mode="shared"``.
      prob: the ``CondensedMPC`` maps.
      X_init: (B, nx_plant) initial plant states.
      kernel: "loop" (each step's batched solve through the solve loop,
        i.e. kernel K4 on CUDA under the padded layout); "scan" — every
        step of a segment in ONE launch of the batched whole-rollout kernel
        K6 (``ops.solve_kernel.full_rollout_batched``; its plain version on
        the CPU), which needs alpha=1, no infeasibility checks,
        iter_precision="highest" or refine=False, and a budget of at least
        one check window (rounded down to whole windows), and a solver on
        one device: K6 walks its ρ ladder inside the kernel, which cannot
        reduce across a mesh's ranks; "auto" takes "scan" on CUDA whenever
        it is eligible (then K6 runs or the call raises), else "loop"
        (always "loop" on the CPU and under a mesh).
      check_interval: ``None`` (settings) / an int / ``"auto"`` — the
        first ``calib_steps`` steps at ci=1, then the window sized by
        ``auto_check_interval`` on the ensemble's per-step iterations.
      return_stats: also return the per-step status lane (the ``min``
        over the scenarios' status codes, as the JAX package reports it).
      return_state: also return ``(Y_final, rho_ind_final)`` (under a mesh
        this rank's rows of Y).

    Under a mesh, ``X_init`` and ``noise`` hold the whole ensemble (this
    rank's scenarios with ``process_local``); each rank steps its own
    plants, and the states and controls of every rank are gathered once
    at the end. Returns ``(states (T+1, B, nx), controls (T, B, nu),
    iters (T,))``. Spans as ``mpc_rollout_scan``'s.
    """
    m = batch_solver
    with span("rollout"):
        if m.rho_mode != "shared":
            raise ValueError("scenario_rollout_scan requires "
                             "rho_mode='shared'")
        if kernel not in ("loop", "scan", "auto"):
            raise ValueError("kernel must be 'loop', 'scan' or 'auto'")
        stng = m.settings
        ci_gate = None if check_interval in (None, "auto") \
            else check_interval
        if kernel == "auto":
            # K6 on the card by the static gate, with no fallback; the CPU
            # keeps the loop path, as the JAX package picks "scan" only on
            # its accelerator
            kernel = ("scan" if stng.device.type == "cuda"
                      and _scan_scenario_eligible(m, ci_gate, solve_max_iter)
                      else "loop")
        if kernel == "scan" and not _scan_scenario_eligible(m, ci_gate,
                                                            solve_max_iter):
            raise ValueError(
                "kernel='scan' scenario rollout needs alpha=1, "
                "iter_precision='highest' or refine=False, no infeasibility "
                "checks, rho_mode='shared', a shared-(H,A) single-chip batch "
                "(no mesh), and a budget of at least one full check window")
        B_n, npl = np.shape(X_init)
        if B_n != m._caller_rows():
            raise ValueError(f"X_init batch {B_n} != solver batch "
                             f"{m._caller_rows()}")
        if noise is not None and tuple(np.shape(noise)) != (n_steps, B_n,
                                                              npl):
            raise ValueError(f"noise must be (T={n_steps}, B={B_n}, {npl})")
        if kernel == "scan":
            # K6's staging (``_scenario_scan_call``, each segment's
            # ``rollout.stage``) converts and pads the caller's inputs; a K6
            # batch has no mesh, so they are this rank's plants
            X0, segment = X_init, _scan_scenario_rollout
        else:
            dtype, dev = stng.precision_dtype, stng.device
            X0 = (X_init.to(device=dev, dtype=dtype)
                  if isinstance(X_init, torch.Tensor)
                  else torch.as_tensor(np.asarray(X_init, np.float64),
                                       dtype=dtype, device=dev))
            if noise is None:
                noise = torch.zeros((n_steps, B_n, npl), dtype=dtype,
                                    device=dev)
            elif isinstance(noise, torch.Tensor):
                noise = noise.to(device=dev, dtype=dtype)
            else:
                noise = torch.as_tensor(np.asarray(noise, np.float64),
                                        dtype=dtype, device=dev)
            # this rank's plants
            X0, noise = X0[m._rows], noise[:, m._rows]
            segment = _loop_scenario_rollout
        n_used = [0]

        def run(ci, X_seg, Y0, rho0, steps):
            w = None if noise is None \
                else noise[n_used[0]:n_used[0] + steps]
            n_used[0] += steps
            return segment(m, prob, X_seg, steps, solve_max_iter, ci, Y0,
                           rho0, w)

        if check_interval == "auto":
            out = _auto_ci_rollout(run, stng, X0, n_steps, calib_steps, m.Y,
                                   m.rho_ind, solve_max_iter or stng.max_iter)
        else:
            ci = (stng.check_interval if check_interval is None
                  else int(check_interval))
            out = run(ci, X0, m.Y, m.rho_ind, n_steps)
        if m._group is not None:
            # every rank's plants, in rank order
            out = (gather_rows(out[0], m._group, axis=1),
                   gather_rows(out[1], m._group, axis=1)) + tuple(out[2:])
        res = out[:3]
        if return_stats:
            res = res + (out[3],)
        if return_state:
            res = res + out[4:6]
        return res


def _loop_scenario_operands(m, prob: CondensedMPC) -> tuple:
    """The loop segment's constants for a solver (a ``ReLU_QP`` or a batch
    solver) and prob, on its device: the g/l/u maps mapped into its
    (possibly Ruiz-equilibrated) space (ḡ = c·D·g, l̄/ū = E·(l/u)), the
    plant maps, the first-stage unscale D[:nu] and the fp64 affine bias
    maps, in ``_rollout_impl``'s and ``_scenario_rollout_impl``'s order
    from ``g0`` to ``v0_scale`` and then ``(bias_c, M_hi, M_lo)``. Cached
    on the solver per prob and bank, as the scan path's operands are, so
    that a warm segment uploads nothing and the solves' window graphs,
    which key these operands by identity, replay."""
    bank = m.Wt_bank if hasattr(m, "Wt_bank") else m.bank.W
    cache = getattr(m, "_loop_ops_cache", None)
    if cache is not None and cache[0] == id(prob) and cache[3] is bank:
        return cache[1]
    stng = m.settings
    dtype, dev = stng.precision_dtype, stng.device
    cst = lambda a: torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                    device=dev)
    sc = m.scal
    nu = prob.K.shape[0]
    gD = sc.c * sc.D
    maps = tuple(cst(a) for a in (
        gD * prob.g0, gD[:, None] * prob.g_x0, sc.E * prob.l0,
        sc.E * prob.u0, sc.E[:, None] * prob.lu_x0, prob.K,
        solver_plant_A(prob), solver_plant_B(prob), sc.D[:nu]))
    bias = _affine_bias_maps(m._B_np, gD * prob.g0, gD[:, None] * prob.g_x0,
                             dtype, dev)
    # prob is held so that its id stays unique while the entry lives
    m._loop_ops_cache = (id(prob), (maps, bias), prob, bank)
    return maps, bias


def _loop_scenario_rollout(m, prob: CondensedMPC, X0, n_steps: int,
                           solve_max_iter, ci, Y0, rho_ind0, noise):
    """One loop-path segment (``_scenario_rollout_impl``) for a batch
    solver: its cached ``_loop_scenario_operands`` and its padded rows
    marked done."""
    stng = m.settings
    maps, (bias_c, M_hi, M_lo) = _loop_scenario_operands(m, prob)
    return _scenario_rollout_impl(
        m.Wt_bank, m.rhos, m.H_dev, m.A_dev, *maps, noise, Y0, rho_ind0, X0,
        m._Wt_hi, m._rho_eff, bias_c, M_hi, M_lo, m._w_pri, m._w_dua,
        m._done0(), nx_qp=m.nx, nc=m.nc, nu=prob.K.shape[0], n_steps=n_steps,
        max_iter=solve_max_iter or stng.max_iter, check_interval=ci,
        adaptive_rho=stng.adaptive_rho,
        adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
        eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
        rho_max=float(stng.rho_max), rho_jump=bool(stng.rho_jump),
        chunk_runner=(pallas_batched_chunk_runner if m._use_pallas
                      else None),
        iter_precision=stng.iter_precision, refine=bool(stng.refine),
        adaptive_rho_interval=int(stng.adaptive_rho_interval),
        alpha=float(stng.alpha),
        check_infeasibility=bool(stng.check_infeasibility),
        eps_prim_inf=float(stng.eps_prim_inf),
        eps_dual_inf=float(stng.eps_dual_inf), group=m._group,
        _graphs=m._window_graphs)


def _scan_scenario_eligible(m, ci=None, budget=None) -> bool:
    """Gate for the batched whole-rollout kernel K6 on any device: a
    shared-(H, A) batch on one device (no mesh: the in-kernel ρ walk cannot
    reduce across ranks) walking one shared rung, alpha=1, no infeasibility
    certificates, single-phase iteration (a reduced ``iter_precision``
    only with ``refine=False``) and a budget of at least one full check
    window. The TPU's VMEM and Dp > 768 precision gates do not apply on the
    card (ROADMAP §C)."""
    stng = m.settings
    if getattr(m, "hetero", False) or m.rho_mode != "shared" \
            or m.mesh is not None:
        return False
    if stng.alpha != 1.0 or stng.check_infeasibility:
        return False
    if stng.iter_precision != "highest" and stng.refine:
        return False
    ci_eff = stng.check_interval if ci is None else int(ci)
    eff_budget = stng.max_iter if budget is None else int(budget)
    return eff_budget >= ci_eff


def _scenario_scan_operands(m, prob: CondensedMPC, Dp: int) -> dict:
    """K2's operands (``_build_rollout_operators``) for a batch solver and
    prob, plus its bank at the kernel's padded dim, cached on the solver
    per (prob, Dp) and bank. H is taken in the iteration dtype (the values
    the loop's residuals contract against), A and B from the fp64
    masters."""
    cache = getattr(m, "_scan_ops_cache", None)
    key = (id(prob), Dp)
    if cache is not None and cache[0] == key and cache[3] is m.Wt_bank:
        return cache[1]
    stng = m.settings
    dev = stng.device
    n_rho, D = m.Wt_bank.shape[0], m.D
    B64 = np.zeros((n_rho, Dp, m.nx))
    B64[:, :D] = m._B_np[:, :D]
    W = m.Wt_bank
    if m.Dp != Dp:
        # an unpadded solver layout (backend="xla"): pad the kernel's own
        # bank copy, once
        W = torch.zeros((n_rho, Dp, Dp), dtype=W.dtype, device=dev)
        W[:, :D, :D] = m.Wt_bank[:, :D, :D]
    ops = _build_rollout_operators(
        prob, m.scal, m.H_dev.double().cpu().numpy(), m._A_scaled_np,
        m._w_pri_np, m._w_dua_np, B64, m.nx, m.nc, Dp, stng.precision_dtype,
        dev)
    ops["Wt"] = W
    # prob is held so that its id stays unique while the entry lives
    m._scan_ops_cache = (key, ops, prob, m.Wt_bank)
    return ops


def _scenario_scan_call(m, prob: CondensedMPC, X_init, n_steps: int,
                        ci=None, budget=None, Y0=None, rho_ind0=None,
                        noise=None, rows=None):
    """The arguments ``(args, kw)`` of one K6 launch,
    ``full_rollout_batched(*args, **kw)``, for a scenario segment: the
    cached ``_scenario_scan_operands``; the start states ``Y0`` (default
    ``m.Y``) moved from the batch solver's (B_pad, Dp) layout into the
    kernel's (Bp, Dp_k) one, Bp = B rounded up to 8 rows (pad rows and
    lanes exactly 0); the start rung (default ``m.rho_ind``); ``X_init``
    (B, nx_plant) and ``noise`` (T, B, nx_plant; default zero) padded to
    (Bp, nplp) on the solver's device; the padding mask; and the budget
    (default ``settings.max_iter``) rounded down to whole check windows.
    B is the solver's batch, or ``rows``: the ensemble of its first
    ``rows`` scenarios (``X_init`` and ``noise`` then hold those rows)."""
    stng = m.settings
    dtype, dev = stng.precision_dtype, stng.device
    npl = prob.K.shape[1]
    D = m.D
    B_n = m.B_n if rows is None else int(rows)
    if not 0 < B_n <= m.B_n:
        raise ValueError(f"rows={rows} is not within the solver's batch "
                         f"{m.B_n}")
    Dp = pad_dim(D)
    Bp = round_up(max(B_n, 8), 8)
    ops = _scenario_scan_operands(m, prob, Dp)
    nplp = ops["nplp"]
    ci_eff = stng.check_interval if ci is None else int(ci)
    budget = budget or stng.max_iter
    if budget < ci_eff:
        raise ValueError(
            f"scan-rollout iteration budget {budget} is smaller than one "
            f"check window ({ci_eff}); lower check_interval or raise the "
            "budget")
    mi = (budget // ci_eff) * ci_eff
    Y0 = m.Y if Y0 is None else Y0
    Yk = torch.zeros((Bp, Dp), dtype=dtype, device=dev)
    Yk[:B_n, :D] = Y0[:B_n, :D].to(device=dev, dtype=dtype)
    rho_ind0 = int(m.rho_ind if rho_ind0 is None else rho_ind0)
    X = (X_init.to(device=dev, dtype=dtype)
         if isinstance(X_init, torch.Tensor)
         else torch.as_tensor(np.asarray(X_init, np.float64), dtype=dtype,
                              device=dev))
    Xk = torch.zeros((Bp, nplp), dtype=dtype, device=dev)
    Xk[:B_n, :npl] = X.reshape(B_n, npl)
    Nk = torch.zeros((n_steps, Bp, nplp), dtype=dtype, device=dev)
    if noise is not None:
        Nk[:, :B_n, :npl] = torch.as_tensor(noise, dtype=dtype, device=dev)
    pad = torch.zeros((Bp,), dtype=torch.float32, device=dev)
    pad[B_n:] = 1.0
    args = [ops["Wt"], ops["bias_c"], ops["M_aff"], m.rhos, ops["M_res"],
            ops["g0w"], ops["GL"], ops["lo0"], ops["hi0"], ops["S_u"],
            ops["Bdw"], Yk, Xk, pad, Nk, rho_ind0]
    kw = dict(nx=m.nx, nc=m.nc, nxp=ops["nxp"], ncp=ops["ncp"],
              nup=ops["nup"], nplp=nplp, n_steps=n_steps, max_iter=mi,
              check_interval=ci_eff, adaptive_rho=stng.adaptive_rho,
              adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
              eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
              rho_max=float(stng.rho_max), rho_jump=bool(stng.rho_jump),
              adaptive_rho_interval=int(stng.adaptive_rho_interval),
              iter_precision=stng.iter_precision)
    return args, kw


def _scan_scenario_rollout(m, prob: CondensedMPC, X0, n_steps: int,
                           solve_max_iter, ci, Y0, rho_ind0, noise=None):
    """One scenario segment as one launch of K6 (``full_rollout_batched``).
    Reads the per-step stats back once; returns ``(states (T+1, B, nx),
    controls (T, B, nu), iters (T,), status (T,), Y_final in the batch
    solver's layout, rho_ind_final)`` like the loop path, the status lane
    being the ensemble's min status."""
    with span("rollout.stage"):
        args, kw = _scenario_scan_call(m, prob, X0, n_steps, ci,
                                       solve_max_iter, Y0, rho_ind0, noise)
    xs, us, stats, Y_f = full_rollout_batched(*args, **kw)
    with span("rollout.read"):
        st = stats.cpu()   # the segment's one device→host read
    with span("rollout.finish"):
        nu, npl = prob.K.shape
        B_n, D = m.B_n, m.D
        states = torch.cat([args[12][None, :B_n, :npl], xs[:, :B_n, :npl]])
        rho_f = int(st[-1, 4]) if n_steps else args[15]
        # back to the batch solver's layout for continuation segments
        # (kernel padding rows and lanes are dropped)
        Y_out = torch.zeros_like(m.Y)
        Y_out[:B_n, :D] = Y_f[:B_n, :D]
        return (states, us[:, :B_n, :nu], st[:, 0].to(torch.int32),
                st[:, 5].to(torch.int32), Y_out, rho_f)
