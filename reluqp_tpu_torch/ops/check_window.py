"""The solve loops' check window: kernels C1 and C2 and their plain versions.

After a window's chunk kernel (K1, K4, K5 or a plain runner) the loop checks
the new iterate: the residuals and the OSQP ρ estimate, the ρ-ladder walk
(every ``rho_stride``-th check), the status, the infeasibility
certificates, the exit flags and, in a two-phase refine's phase A, the
stall test. This module holds that arithmetic for both loops:

- ``check_window_ref`` (``core.iteration``'s single QP) and
  ``batched_check_ref`` (``core.batched``'s shared, per-problem and
  heterogeneous batches): the plain torch versions, which return the new
  loop state;
- ``check_window`` and ``batched_check``: on CUDA tensors one launch of
  the hand-written kernel C1 (``csrc/check_window.cu``), or one or two of
  C2, which write the new state straight into the loop's static buffers;
  on CPU tensors the plain version, its state copied into the buffers.

The kernels have no Pallas counterpart: they replace the check that XLA
compiles into the JAX package's ``lax.while_loop`` bodies
(``reluqp_tpu/core/iteration.py`` ``step``/``check``,
``reluqp_tpu/core/batched.py`` ``step``/``check``), which the port ran as
some fifty small torch ops per window. ``check_window.launches`` and
``batched_check.launches`` count kernel launches through
``core.graphs.on_launch``, so a launch captured in a window's graph counts
once per replay. A CUDA tensor never reaches a plain version through a
wrapper: the kernel runs or the call raises.
"""
from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..core.graphs import on_launch
from .fused_step import _DTYPE_CODE, device_guard, pad_dim

__all__ = [
    "STATUS_MAX_ITER", "STATUS_SOLVED", "STATUS_PRIMAL_INFEASIBLE",
    "STATUS_DUAL_INFEASIBLE", "STATUS_STRINGS", "assign",
    "infeasibility_certificates", "compute_residuals",
    "compute_residuals_op", "rho_ladder_step", "batched_residuals",
    "batched_infeasibility_certificates", "check_window_ref",
    "check_window", "batched_check_ref", "batched_check", "graph_kernels",
    "batched_check_plan", "check_window_plan", "STAMP_STAGES",
    "stage_split",
]

_TINY = 1e-30

STATUS_MAX_ITER = 0
STATUS_SOLVED = 1
STATUS_PRIMAL_INFEASIBLE = 2
STATUS_DUAL_INFEASIBLE = 3
STATUS_STRINGS = {
    STATUS_MAX_ITER: "max_iters_reached",
    STATUS_SOLVED: "solved",
    STATUS_PRIMAL_INFEASIBLE: "primal_infeasible",
    STATUS_DUAL_INFEASIBLE: "dual_infeasible",
}
_RUNNING = -1


def assign(dst: tuple, src: tuple) -> None:
    """Write a piece's new state ``src`` into the static buffers ``dst``
    (the kernels' outputs stay distinct allocations, copied in at the
    piece's end; a field left as it was is not copied)."""
    for d, s in zip(dst, src):
        if d is not None and s is not None and s is not d:
            d.copy_(s)


# --------------------------------------------------------------------- #
# the single QP's arithmetic                                            #
# --------------------------------------------------------------------- #

def infeasibility_certificates(H, A, g, l, u, dx, dlam, eps_pinf: float,
                               eps_dinf: float):
    """OSQP-style primal/dual infeasibility tests on iterate deltas.

    δλ certifies primal infeasibility when Aᵀδλ ≈ 0 and the support
    function uᵀ(δλ)₊ + lᵀ(δλ)₋ is negative; δx certifies dual infeasibility
    when Hδx ≈ 0, gᵀδx < 0 and Aδx is a feasible ray direction.
    Returns (pinf, dinf) bool tensors.
    """
    norm_dlam = dlam.abs().max()
    norm_dx = dx.abs().max()
    eps_p = eps_pinf * norm_dlam
    eps_d = eps_dinf * norm_dx

    At_dlam = A.T @ dlam
    support = torch.where(dlam > 0, u * dlam,
                          torch.where(dlam < 0, l * dlam, 0.0)).sum()
    pinf = (norm_dlam > 0) & (At_dlam.abs().max() <= eps_p) \
        & (support <= -eps_p)

    H_dx = H @ dx
    A_dx = A @ dx
    ray_ok = torch.all(
        torch.where(torch.isfinite(u), A_dx <= eps_d, True)
        & torch.where(torch.isfinite(l), A_dx >= -eps_d, True))
    dinf = (norm_dx > 0) & (H_dx.abs().max() <= eps_d) \
        & (torch.dot(g, dx) <= -eps_d) & ray_ok
    return pinf, dinf


def compute_residuals(H, A, g, x, z, lam, rho, rho_min: float,
                      rho_max: float, w_pri=None, w_dua=None):
    """Residuals + OSQP-style ρ rebalancing estimate.

    Tiny-guarded denominators keep an all-zero iterate from poisoning the
    estimate with NaNs. Optional ``w_pri``/``w_dua`` weight the residual
    vectors (and the relative-scale terms) into UNSCALED units under Ruiz
    equilibration.

    The products run in full fp32 (the package turns TF32 off at import):
    residuals computed from reduced-precision passes carry noise ~1e-2 and
    stall the solver short of eps_abs.
    """
    t1 = A @ x
    t2 = H @ x
    t3 = A.T @ lam
    if w_pri is not None:
        t1 = w_pri * t1
        z = w_pri * z
    if w_dua is not None:
        t2 = w_dua * t2
        t3 = w_dua * t3
        g = w_dua * g
    pri = (t1 - z).abs().max()
    dua = (t2 + t3 + g).abs().max()
    scale_p = torch.maximum(t1.abs().max(), z.abs().max())
    scale_d = torch.maximum(torch.maximum(t2.abs().max(), t3.abs().max()),
                            g.abs().max())
    return _rho_estimate(pri, dua, scale_p, scale_d, rho, rho_min, rho_max)


def _rho_estimate(pri, dua, scale_p, scale_d, rho, rho_min, rho_max):
    num = pri / scale_p.clamp_min(_TINY)
    den = dua / scale_d.clamp_min(_TINY)
    ratio = torch.sqrt(num / den.clamp_min(_TINY))
    rho_new = torch.clamp(rho * ratio, rho_min, rho_max)
    return pri, dua, rho_new


def compute_residuals_op(M_res, g_row, y, nxp: int, ncp: int, rho,
                         rho_min: float, rho_max: float):
    """One-matmul residuals: ``r = y @ M_res`` instead of three matvecs.

    ``M_res`` is ``ops.solve_kernel.build_residual_operator``'s stacked
    operator (segments [w⊙Ax | w⊙z | w⊙Hx | w⊙Aᵀλ], lane-padded);
    ``g_row``: (nxp,) lane-padded ``w_dua ⊙ g``. Valid for alpha=1 only
    (the last y slot must BE λ).
    """
    r = (y[None, :] @ M_res)[0]
    ax = r[0:ncp]
    z = r[ncp:2 * ncp]
    hx = r[2 * ncp:2 * ncp + nxp]
    atl = r[2 * ncp + nxp:2 * ncp + 2 * nxp]
    pri = (ax - z).abs().max()
    dua = (hx + atl + g_row).abs().max()
    scale_p = torch.maximum(ax.abs().max(), z.abs().max())
    scale_d = torch.maximum(torch.maximum(hx.abs().max(), atl.abs().max()),
                            g_row.abs().max())
    return _rho_estimate(pri, dua, scale_p, scale_d, rho, rho_min, rho_max)


def rho_ladder_step(rhos, rho_ind, rho_est, tol, jump: bool, done=None):
    """One ρ-ladder index update on the device.

    ``jump=False``: the ±1 walk when the estimate leaves [ρ_k/τ, ρ_k·τ].
    ``jump=True``: move straight to the rung nearest the estimate. Works
    for a 0-d or a (B,) int32 ``rho_ind``; entries with ``done`` set are
    frozen.
    """
    n_rho = rhos.shape[0]
    rho_k = rhos.index_select(0, rho_ind.reshape(-1)).reshape(rho_ind.shape)
    if jump:
        moved = (rho_est > rho_k * tol) | (rho_est < rho_k / tol)
        log_d = torch.log(rhos) - torch.log(rho_est)[..., None]
        nearest = torch.argmin(log_d.abs(), dim=-1).to(torch.int32)
        new = torch.where(moved, nearest, rho_ind)
    else:
        up = (rho_est > rho_k * tol) & (rho_ind < n_rho - 1)
        dn = (rho_est < rho_k / tol) & (rho_ind > 0) & ~up
        new = rho_ind + up.to(torch.int32) - dn.to(torch.int32)
    if done is not None:
        new = torch.where(done, rho_ind, new)
    return new


def lam_of(y, rho_ind, op, cfg):
    """True λ of a single QP's state: the slot (alpha = 1) or ρ⃗(p − z)."""
    nx, nc = cfg.nx, cfg.nc
    last = y[nx + nc:nx + 2 * nc]
    if cfg.alpha == 1.0:
        return last
    rv = op.rho_eff.index_select(0, rho_ind.reshape(1))[0]
    return rv * (last - y[nx:nx + nc])


def _residuals(y, rho, rho_ind, op, cfg):
    """The window's residuals and ρ estimate."""
    nx, nc = cfg.nx, cfg.nc
    if op.M_res is not None:
        return compute_residuals_op(op.M_res, op.g_row, y, pad_dim(nx),
                                    pad_dim(nc), rho, cfg.rho_min,
                                    cfg.rho_max)
    return compute_residuals(op.H, op.A, op.g, y[:nx], y[nx:nx + nc],
                             lam_of(y, rho_ind, op, cfg), rho, cfg.rho_min,
                             cfg.rho_max, op.w_pri, op.w_dua)


def check_window_ref(st, op, cfg, y, n_steps: int, phase: str):
    """Plain torch version of C1: the check of a single QP's window.

    ``st`` the loop state before the window (``core.iteration._Dev``),
    ``op``/``cfg`` the solve's operands and settings, ``y`` the chunk
    runner's output after ``n_steps`` iterations, ``phase`` "" (one phase),
    "A" or "B" (the two-phase refine's) or "tail" (the ``max_iter %
    check_interval`` tail: the residuals and the solved test only).
    Returns the new state; nothing is written."""
    nx, nc = cfg.nx, cfg.nc
    if phase == "tail":
        pri, dua, rho = _residuals(y, st.rho, st.rho_ind, op, cfg)
        solved = (pri < cfg.eps_pri) & (dua < cfg.eps_dua)
        return st._replace(y=y, rho=rho, pri=pri, dua=dua,
                           k=st.k + n_steps,
                           status=torch.where(solved, STATUS_SOLVED,
                                              st.status))
    pri, dua, rho_new = _residuals(y, st.rho, st.rho_ind, op, cfg)
    if cfg.check_infeasibility:
        lam_now = lam_of(y, st.rho_ind, op, cfg)
    rho_ind = st.rho_ind
    k = st.k + n_steps
    if cfg.adaptive_rho:
        new_ind = rho_ladder_step(op.rhos, rho_ind, rho_new, cfg.tol,
                                  cfg.rho_jump)
        if cfg.rho_stride > 1:
            # the ceil-div check ordinal, branch-free as the JAX package's
            chk = torch.div(k + (cfg.check_interval - 1), cfg.check_interval,
                            rounding_mode="floor")
            new_ind = torch.where(chk % cfg.rho_stride == 0, new_ind,
                                  rho_ind)
        if cfg.alpha != 1.0:
            # p is rung-scaled (p = z + R⁻¹λ): re-encode it for the new
            # rung with the elementwise ρ⃗_old/ρ⃗_new (all-ones when the
            # rung held).
            scale = (op.rho_eff.index_select(0, rho_ind.reshape(1))[0]
                     / op.rho_eff.index_select(0, new_ind.reshape(1))[0])
            z_cur = y[nx:nx + nc]
            p_cur = y[nx + nc:nx + 2 * nc]
            y = torch.cat([y[:nx + nc], z_cur + scale * (p_cur - z_cur),
                           y[nx + 2 * nc:]])
        rho_ind = new_ind
    solved = (pri < cfg.eps_pri) & (dua < cfg.eps_dua)
    status = torch.where(solved, STATUS_SOLVED, _RUNNING)
    new = {}
    if cfg.check_infeasibility:
        x = y[:nx]
        pinf, dinf = infeasibility_certificates(
            op.H, op.A, op.g, op.lo[nx:nx + nc], op.hi[nx:nx + nc],
            x - st.x_prev, lam_now - st.lam_prev, cfg.eps_prim_inf,
            cfg.eps_dual_inf)
        status = torch.where((status < 0) & pinf,
                             STATUS_PRIMAL_INFEASIBLE, status)
        status = torch.where((status < 0) & dinf,
                             STATUS_DUAL_INFEASIBLE, status)
        new.update(x_prev=x, lam_prev=lam_now)
    running = (status < 0) & (k < cfg.budget)
    if phase == "A":
        # 3% better than the best so far in either residual, in the
        # iterate's dtype; two stalled windows in a row end the phase
        improved = (pri < cfg.stall * st.best_p) | (dua < cfg.stall
                                                    * st.best_d)
        n_stall = torch.where(improved, 0, st.n_stall + 1)
        new.update(best_p=torch.where(pri < st.best_p, pri, st.best_p),
                   best_d=torch.where(dua < st.best_d, dua, st.best_d),
                   n_stall=n_stall, k_fast=k,
                   open_a=(n_stall < 2) & (k < cfg.cap_a) & running)
    return st._replace(y=y, rho_ind=rho_ind, rho=rho_new, k=k,
                       status=status, pri=pri, dua=dua, open=running,
                       tail=status < 0, **new)


# --------------------------------------------------------------------- #
# the batched loops' arithmetic                                         #
# --------------------------------------------------------------------- #

def batched_residuals(H, A, g, X, Z, Lam, rho, rho_min: float,
                      rho_max: float, w_pri=None, w_dua=None):
    """Per-problem residuals and ρ estimates.

    ``X`` (B, nx), ``Z``/``Lam`` (B, nc), ``g`` (B, nx) or (nx,), ``rho``
    (B,); ``H``/``A`` shared (nx, nx)/(nc, nx) or per problem (B, ·, nx);
    optional ``w_pri`` (nc,) or (B, nc) / ``w_dua`` (nx,) or (B, nx) weight
    the residual vectors into UNSCALED units under Ruiz equilibration. All
    products are full-precision GEMMs (TF32 is off). Returns ``(pri, dua,
    rho_new)``, each (B,).
    """
    AX = _mv(A, X)
    HX = _mv(H, X)
    AtL = _mv(A.transpose(-1, -2), Lam)
    g = torch.broadcast_to(g, HX.shape)
    if w_pri is not None:
        AX = w_pri * AX
        Z = w_pri * Z
    if w_dua is not None:
        HX = w_dua * HX
        AtL = w_dua * AtL
        g = w_dua * g
    amax = lambda v: v.abs().amax(dim=-1)
    pri = amax(AX - Z)
    dua = amax(HX + AtL + g)
    scale_p = torch.maximum(amax(AX), amax(Z))
    scale_d = torch.maximum(torch.maximum(amax(HX), amax(AtL)), amax(g))
    num = pri / scale_p.clamp_min(_TINY)
    den = dua / scale_d.clamp_min(_TINY)
    ratio = torch.sqrt(num / den.clamp_min(_TINY))
    return pri, dua, torch.clamp(rho * ratio, rho_min, rho_max)


def _mv(M, v):
    """Row-wise products ``M @ vᵢ``: ``M`` (m, n) shared or (B, m, n) per
    problem, ``v`` (B, n) → (B, m)."""
    if M.dim() == 3:
        return torch.bmm(M, v[:, :, None])[:, :, 0]
    return v @ M.T


def batched_infeasibility_certificates(H, A, g, l, u, dX, dLam,
                                       eps_pinf: float, eps_dinf: float):
    """Per-problem OSQP-style infeasibility certificates on iterate deltas:
    δλ certifies primal infeasibility when Aᵀδλ ≈ 0 and the support
    function uᵀ(δλ)₊ + lᵀ(δλ)₋ is negative; δx certifies dual infeasibility
    when Hδx ≈ 0, gᵀδx < 0 and Aδx is a feasible ray.

    ``dX`` (B, nx), ``dLam`` (B, nc), ``l``/``u`` (B, nc), ``g`` (B, nx) or
    (nx,); ``H``/``A`` shared, or per problem (B, ·, nx).
    Returns ``(pinf, dinf)`` bool (B,) tensors.
    """
    amax = lambda v: v.abs().amax(dim=-1)
    norm_dlam = amax(dLam)
    norm_dx = amax(dX)
    eps_p = eps_pinf * norm_dlam
    eps_d = eps_dinf * norm_dx
    At_dlam = _mv(A.transpose(-1, -2), dLam)
    H_dx = _mv(H, dX)
    A_dx = _mv(A, dX)
    zero = torch.zeros((), dtype=dLam.dtype, device=dLam.device)
    support = torch.where(dLam > 0, u * dLam,
                          torch.where(dLam < 0, l * dLam, zero)).sum(dim=-1)
    pinf = (norm_dlam > 0) & (amax(At_dlam) <= eps_p) & (support <= -eps_p)
    ray_ok = torch.all(
        torch.where(torch.isfinite(u), A_dx <= eps_d[:, None], True)
        & torch.where(torch.isfinite(l), A_dx >= -eps_d[:, None], True),
        dim=-1)
    g_dx = (torch.broadcast_to(g, dX.shape) * dX).sum(dim=-1)
    dinf = (norm_dx > 0) & (amax(H_dx) <= eps_d) & (g_dx <= -eps_d) & ray_ok
    return pinf, dinf


def rho_vec(rho_eff, rho_ind):
    """ρ⃗ at the rung(s): (1, nc) shared, (B, nc) per problem, from a
    shared (N, nc) or a per-problem (B, N, nc) ladder."""
    if rho_eff.dim() == 3:
        rows = torch.arange(rho_ind.shape[0], device=rho_ind.device)
        return rho_eff[rows, rho_ind.long()]
    return rho_eff.index_select(0, rho_ind.reshape(-1).long())


def batched_lam_of(Y, rho_ind, nx: int, nc: int, alpha: float, rho_eff):
    """True λ: the slot (alpha = 1) or ρ⃗(p − z) of the relaxed
    parametrization."""
    last = Y[:, nx + nc:nx + 2 * nc]
    if alpha == 1.0:
        return last
    return rho_vec(rho_eff, rho_ind) * (last - Y[:, nx:nx + nc])


def batched_check_ref(st, op, cfg, Y, n_steps: int, phase: str):
    """Plain torch version of C2: the check of a batched window.

    ``st`` the loop state before the window (``core.batched._Dev``),
    ``op``/``cfg`` the solve's operands and settings, ``Y`` the chunk
    runner's output after ``n_steps`` iterations, ``phase`` "A" in a
    two-phase refine's phase A (the stall test), anything else otherwise.
    Under a process group (``cfg.group``) the open count, the stall
    metric's sum and the shared walk's statistics are all-reduced over it.
    Returns the new state; nothing is written."""
    nx, nc = cfg.nx, cfg.nc
    dtype = st.Y.dtype
    X, Z = Y[:, :nx], Y[:, nx:nx + nc]
    lam_now = batched_lam_of(Y, st.rho_ind, nx, nc, cfg.alpha, op.rho_eff)
    pri_n, dua_n, rho_new = batched_residuals(op.H, op.A, op.G, X, Z,
                                              lam_now, st.rho, cfg.rho_min,
                                              cfg.rho_max, op.w_pri,
                                              op.w_dua)
    done = st.done
    # freeze the stats of problems that already converged
    pri = torch.where(done, st.pri, pri_n)
    dua = torch.where(done, st.dua, dua_n)
    rho = torch.where(done, st.rho, rho_new)
    rho_ind = st.rho_ind
    k = st.k + n_steps
    if cfg.adaptive_rho:
        if cfg.shared:
            # the geometric mean of the active problems' estimates drives
            # the one shared ladder index
            rho_k = op.rhos.index_select(0, rho_ind.reshape(1)).reshape(())
            logr = torch.where(done, 0.0, torch.log(rho_new)).sum()
            n_act = (~done).sum()
            if cfg.group is not None:
                red = torch.stack([logr, n_act.to(dtype)])
                dist.all_reduce(red, group=cfg.group)
                logr, n_act = red[0], red[1]
            rho_gm = torch.exp(logr / n_act.clamp_min(1).to(dtype))
            rho_gm = torch.where(n_act > 0, rho_gm, rho_k)
            new_ind = rho_ladder_step(op.rhos, rho_ind, rho_gm, cfg.tol,
                                      cfg.rho_jump)
        else:
            new_ind = rho_ladder_step(op.rhos, rho_ind, rho_new, cfg.tol,
                                      cfg.rho_jump, done=done)
        if cfg.rho_stride > 1:
            # ρ moves only at every rho_stride-th check. Ceil-div: the
            # max_iter % check_interval tail counts as its own check
            # ordinal, not a repeat of the last window's.
            chk = torch.div(k + (cfg.check_interval - 1), cfg.check_interval,
                            rounding_mode="floor")
            new_ind = torch.where(chk % cfg.rho_stride == 0, new_ind,
                                  rho_ind)
        if cfg.alpha != 1.0:
            # re-encode p for the new rung with ρ⃗_old/ρ⃗_new (all ones
            # where it held, capped rows and frozen rows included)
            scale = rho_vec(op.rho_eff, rho_ind) / rho_vec(op.rho_eff,
                                                           new_ind)
            P_cur = Y[:, nx + nc:nx + 2 * nc]
            Y = torch.cat([Y[:, :nx + nc], Z + scale * (P_cur - Z),
                           Y[:, nx + 2 * nc:]], dim=1)
        rho_ind = new_ind
    newly = ~done & (pri < cfg.eps_pri) & (dua < cfg.eps_dua)
    iters = torch.where(newly, k, st.iters).to(torch.int32)
    status = torch.where(newly, STATUS_SOLVED, st.status).to(torch.int32)
    done = done | newly
    new = {}
    if cfg.check_infeasibility:
        pinf, dinf = batched_infeasibility_certificates(
            op.H, op.A, op.G, op.lo[:, nx:nx + nc], op.hi[:, nx:nx + nc],
            X - st.X_prev, lam_now - st.Lam_prev, cfg.eps_prim_inf,
            cfg.eps_dual_inf)
        for flag, code in ((pinf, STATUS_PRIMAL_INFEASIBLE),
                           (dinf, STATUS_DUAL_INFEASIBLE)):
            newly_i = ~done & flag
            status = torch.where(newly_i, code, status).to(torch.int32)
            iters = torch.where(newly_i, k, iters).to(torch.int32)
            done = done | newly_i
        new.update(X_prev=X, Lam_prev=lam_now)
    n_open = (~done).sum()
    stats_a = phase == "A"
    if stats_a:
        logres = torch.where(done, 0.0, torch.log(
            torch.clamp_min(pri + dua, 1e-30))).sum()
    if cfg.group is not None:
        red = torch.stack([n_open.to(dtype)] + ([logres] if stats_a else []))
        dist.all_reduce(red, group=cfg.group)
        n_open = red[0]
        if stats_a:
            logres = red[1]
    running = (n_open > cfg.stop_open) & (k < cfg.budget)
    if stats_a:
        # the mean log-residual of the open problems 0.03 below its best
        # so far, or fewer open problems than ever: progress; two stalled
        # windows in a row end the phase
        metric = logres / n_open.clamp_min(1)
        improved = ((metric < st.best_m - cfg.stall)
                    | (n_open < st.best_open))
        n_stall = torch.where(improved, 0, st.n_stall + 1)
        new.update(
            best_m=torch.where(metric < st.best_m, metric, st.best_m),
            best_open=torch.where(n_open < st.best_open, n_open,
                                  st.best_open),
            n_stall=n_stall, k_fast=k,
            open_a=(n_stall < 2) & (k < cfg.cap_a) & running)
    return st._replace(Y=Y, rho_ind=rho_ind, rho=rho, pri=pri, dua=dua,
                       done=done, iters=iters, status=status, k=k,
                       n_open=n_open, open=running, tail=n_open > 0, **new)


# --------------------------------------------------------------------- #
# C1 and C2                                                             #
# --------------------------------------------------------------------- #

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double


class _C1Args(ctypes.Structure):
    """``C1Args`` of ``csrc/check_window.cu``, field for field."""
    _fields_ = [(n, _P) for n in (
        "y_in", "m_res", "g_row", "H", "A", "g", "lo", "hi", "w_pri",
        "w_dua", "rhos", "rho_eff", "y", "rho_ind", "rho", "k", "status",
        "pri", "dua", "open", "tail", "x_prev", "lam_prev", "open_a",
        "best_p", "best_d", "n_stall", "k_fast", "part", "stamps")] + [
        (n, _I) for n in (
            "dp", "nx", "nc", "nxp", "ncp", "n_rho", "n_steps", "tail_mode",
            "phase_a", "adaptive", "jump", "stride", "ci", "budget", "cap_a",
            "certs", "alpha", "dtype")] + [
        (n, _D) for n in (
            "eps_pri", "eps_dua", "tol", "rho_min", "rho_max", "eps_pinf",
            "eps_dinf", "stall")]


class _C2Args(ctypes.Structure):
    """``C2Args`` of ``csrc/check_window.cu``, field for field."""
    _fields_ = [(n, _P) for n in (
        "Y_in", "H", "A", "G", "lo", "hi", "w_pri", "w_dua", "rhos",
        "rho_eff", "Y", "rho_ind", "rho", "pri", "dua", "done", "iters",
        "status", "k", "X_prev", "Lam_prev", "n_open", "open", "tail",
        "open_a", "best_m", "best_open", "n_stall", "k_fast", "part",
        "tick", "stamps")] + [
        (n, _I) for n in (
            "B", "dp", "nx", "nc", "n_rho", "h_per", "a_per", "g_per",
            "wp_per", "wd_per", "reff_per", "shared", "n_steps", "phase_a",
            "adaptive", "jump", "stride", "ci", "budget", "cap_a", "certs",
            "alpha", "stop_open", "dtype")] + [
        (n, _D) for n in (
            "eps_pri", "eps_dua", "tol", "rho_min", "rho_max", "eps_pinf",
            "eps_dinf", "stall")]


def _lib():
    from .cuda_build import load
    lib = load("check_window")
    if not getattr(lib, "_cw_typed", False):
        lib.c1_check.argtypes = [ctypes.POINTER(_C1Args), _P]
        lib.c1_check.restype = _I
        lib.c1_plan_of.argtypes = [ctypes.POINTER(_C1Args),
                                   ctypes.POINTER(ctypes.c_longlong)]
        lib.c1_plan_of.restype = _I
        lib.c2_check.argtypes = [ctypes.POINTER(_C2Args), _P,
                                 ctypes.POINTER(_I)]
        lib.c2_check.restype = _I
        lib.c2_sizes.argtypes = [ctypes.POINTER(_C2Args),
                                 ctypes.POINTER(ctypes.c_longlong)]
        lib.c2_sizes.restype = None
        lib.c2_plan_of.argtypes = [ctypes.POINTER(_C2Args),
                                   ctypes.POINTER(_I)]
        lib.c2_plan_of.restype = None
        lib.cw_graph_kernels.argtypes = [_P, ctypes.c_char_p, _I]
        lib.cw_graph_kernels.restype = _I
        lib.cw_error_string.argtypes = [_I]
        lib.cw_error_string.restype = ctypes.c_char_p
        lib._cw_typed = True
    return lib


def _raise(lib, code: int, what: str):
    msg = lib.cw_error_string(code).decode()
    raise RuntimeError(f"{what} failed: CUDA error {code} ({msg})")


def _ptr(t):
    """A tensor's device address, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _need(kname, dev, dtype, **ts):
    """Every tensor given (None: not used) on ``dev``, contiguous and of
    ``dtype``."""
    for name, t in ts.items():
        if t is None:
            continue
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{kname}: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kname}: {name} must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{kname}: {name} must be {dtype}, not "
                             f"{t.dtype}")


def _settings(cfg, y_dtype):
    """The settings both kernels bake in, as ``ctypes`` values."""
    return dict(
        adaptive=int(cfg.adaptive_rho), jump=int(cfg.rho_jump),
        stride=int(cfg.rho_stride), ci=int(cfg.check_interval),
        budget=int(cfg.budget), cap_a=int(cfg.cap_a),
        certs=int(cfg.check_infeasibility), alpha=int(cfg.alpha != 1.0),
        dtype=_DTYPE_CODE[y_dtype], eps_pri=cfg.eps_pri,
        eps_dua=cfg.eps_dua, tol=cfg.tol, rho_min=cfg.rho_min,
        rho_max=cfg.rho_max, eps_pinf=cfg.eps_prim_inf,
        eps_dinf=cfg.eps_dual_inf, stall=cfg.stall)


def _c1_args(st, op, cfg, y, n_steps, phase) -> _C1Args:
    """C1's launch arguments for this window (``part`` still unset), the
    tensors checked."""
    dev, dt = y.device, y.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"C1: state dtype {dt} is not float32/float64")
    i32 = torch.int32
    tail = phase == "tail"
    certs = cfg.check_infeasibility and not tail
    mres = op.M_res is not None
    if mres and cfg.alpha != 1.0:
        raise ValueError("C1: M_res needs alpha = 1")
    dp, nx, nc = y.shape[0], cfg.nx, cfg.nc
    nxp, ncp = pad_dim(nx), pad_dim(nc)
    _need("C1", dev, dt, y=y, y_out=st.y,
          rhos=op.rhos, rho=st.rho, pri=st.pri,
          dua=st.dua, lo=op.lo, hi=op.hi,
          M_res=op.M_res if mres else None,
          g_row=op.g_row if mres else None,
          H=None if mres and not certs else op.H,
          A=None if mres and not certs else op.A,
          g=None if mres and not certs else op.g,
          w_pri=None if mres else op.w_pri,
          w_dua=None if mres else op.w_dua,
          rho_eff=op.rho_eff if cfg.alpha != 1.0 else None,
          x_prev=st.x_prev if certs else None,
          lam_prev=st.lam_prev if certs else None,
          best_p=st.best_p if phase == "A" else None,
          best_d=st.best_d if phase == "A" else None)
    _need("C1", dev, i32, rho_ind=st.rho_ind, k=st.k,
          status=st.status, open=st.open,
          tail=st.tail,
          open_a=st.open_a if phase == "A" else None,
          n_stall=st.n_stall if phase == "A" else None,
          k_fast=st.k_fast if phase == "A" else None)
    if y.shape != st.y.shape or y.data_ptr() == st.y.data_ptr():
        raise ValueError("C1: y must be the runner's own (Dp,) output")
    if mres and tuple(op.M_res.shape) != (dp, 2 * ncp + 2 * nxp):
        raise ValueError(f"C1: M_res {tuple(op.M_res.shape)} does not match "
                         f"Dp={dp}")
    a = _C1Args(
        y_in=y.data_ptr(), m_res=_ptr(op.M_res) if mres else None,
        g_row=_ptr(op.g_row) if mres else None,
        H=_ptr(op.H), A=_ptr(op.A), g=_ptr(op.g), lo=op.lo.data_ptr(),
        hi=op.hi.data_ptr(), w_pri=None if mres else _ptr(op.w_pri),
        w_dua=None if mres else _ptr(op.w_dua), rhos=op.rhos.data_ptr(),
        rho_eff=_ptr(op.rho_eff) if cfg.alpha != 1.0 else None,
        y=st.y.data_ptr(), rho_ind=st.rho_ind.data_ptr(),
        rho=st.rho.data_ptr(), k=st.k.data_ptr(),
        status=st.status.data_ptr(), pri=st.pri.data_ptr(),
        dua=st.dua.data_ptr(), open=st.open.data_ptr(),
        tail=st.tail.data_ptr(),
        x_prev=_ptr(st.x_prev) if certs else None,
        lam_prev=_ptr(st.lam_prev) if certs else None,
        open_a=_ptr(st.open_a), best_p=_ptr(st.best_p),
        best_d=_ptr(st.best_d), n_stall=_ptr(st.n_stall),
        k_fast=_ptr(st.k_fast), stamps=_ptr(check_window.stamps),
        dp=dp, nx=nx, nc=nc, nxp=nxp, ncp=ncp, n_rho=op.rhos.shape[0],
        n_steps=int(n_steps), tail_mode=int(tail), phase_a=int(phase == "A"),
        **_settings(cfg, dt))
    if tail:
        a.adaptive = a.certs = 0
    return a


def _c1_plan(lib, a) -> list:
    out = (ctypes.c_longlong * 4)()
    rc = lib.c1_plan_of(ctypes.byref(a), out)
    if rc != 0:
        _raise(lib, rc, "C1 plan")
    return list(out)


def check_window_plan(st, op, cfg, y, n_steps: int = 1,
                      phase: str = "") -> dict:
    """The shape C1 takes for this window on the card: blocks in its
    cluster, its variant ("shared", or "global" where a block's vectors
    and sums outgrow its shared memory and lie in a scratch region), the
    scratch's elements and the dynamic shared memory a block takes."""
    lib = _lib()
    with device_guard(y.device):
        n, cluster, glob, smem = _c1_plan(
            lib, _c1_args(st, op, cfg, y, n_steps, phase))
    return dict(cluster=cluster, variant="global" if glob else "shared",
                scratch=n, smem=smem)


def _c1_launch(st, op, cfg, y, n_steps, phase):
    dev = y.device
    a = _c1_args(st, op, cfg, y, n_steps, phase)
    lib = _lib()
    # scratch only where a block's vectors and sums outgrow its shared memory
    n = _c1_plan(lib, a)[0]
    part = torch.empty((n,), dtype=y.dtype, device=dev) if n else None
    a.part = _ptr(part)
    rc = lib.c1_check(ctypes.byref(a),
                      torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise(lib, rc, "C1 launch")
    on_launch(_count_check_window)


def check_window(st, op, cfg, y, n_steps: int, phase: str) -> None:
    """The check of a single QP's window, written into the loop's static
    buffers ``st`` (``check_window_ref``'s arguments). CUDA tensors launch
    kernel C1 once (or raise); CPU tensors run ``check_window_ref`` and
    copy its state into ``st``."""
    if y.is_cuda:
        with device_guard(y.device):
            _c1_launch(st, op, cfg, y, n_steps, phase)
        return
    assign(st, check_window_ref(st, op, cfg, y, n_steps, phase))


check_window.launches = 0
# an int64 (7,) tensor on the card, or None: the kernel's stage stamps
# (`stage_split`); None on every solve path
check_window.stamps = None


def _count_check_window():
    check_window.launches += 1


def _c2_args(st, op, cfg, Y, n_steps, phase) -> _C2Args:
    """C2's launch arguments for this window (``part`` still unset), the
    tensors checked."""
    dev, dt = Y.device, Y.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"C2: state dtype {dt} is not float32/float64")
    if cfg.group is not None:
        raise ValueError("C2: a process group's window keeps the plain "
                         "check (its all-reduces sit inside it)")
    if st.tick is None:
        raise ValueError("C2: the state has no tick buffer "
                         "(core.batched's state buffers make it)")
    i32 = torch.int32
    B, dp = Y.shape
    nx, nc = cfg.nx, cfg.nc
    certs = cfg.check_infeasibility
    phase_a = phase == "A"
    alpha = cfg.alpha != 1.0
    _need("C2", dev, dt, Y=Y, Y_out=st.Y, H=op.H,
          A=op.A, G=op.G, lo=op.lo,
          hi=op.hi, w_pri=op.w_pri, w_dua=op.w_dua,
          rhos=op.rhos, rho_eff=op.rho_eff if alpha else None,
          rho=st.rho, pri=st.pri, dua=st.dua,
          X_prev=st.X_prev if certs else None,
          Lam_prev=st.Lam_prev if certs else None,
          best_m=st.best_m if phase_a else None)
    _need("C2", dev, i32, rho_ind=st.rho_ind,
          iters=st.iters, status=st.status, k=st.k,
          n_open=st.n_open, open=st.open,
          tail=st.tail, tick=st.tick,
          open_a=st.open_a if phase_a else None,
          best_open=st.best_open if phase_a else None,
          n_stall=st.n_stall if phase_a else None,
          k_fast=st.k_fast if phase_a else None)
    _need("C2", dev, torch.bool, done=st.done)
    if st.Y.shape != Y.shape or Y.data_ptr() == st.Y.data_ptr():
        raise ValueError("C2: Y must be the runner's own (B, Dp) output")
    if st.rho_ind.dim() != (0 if cfg.shared else 1):
        raise ValueError("C2: rho_ind must be 0-d (shared walk) or (B,)")
    h_per, a_per = op.H.dim() == 3, op.A.dim() == 3
    if (op.H.shape[-2:] != (nx, nx) or op.A.shape[-2:] != (nc, nx)
            or (h_per and op.H.shape[0] != B)
            or (a_per and op.A.shape[0] != B)):
        raise ValueError("C2: H and A must be (nx, nx)/(nc, nx) or per "
                         "problem (B, ·, nx)")
    per = lambda t: int(t is not None and t.dim() == 2)
    a = _C2Args(
        Y_in=Y.data_ptr(), H=op.H.data_ptr(), A=op.A.data_ptr(),
        G=op.G.data_ptr(), lo=op.lo.data_ptr(), hi=op.hi.data_ptr(),
        w_pri=_ptr(op.w_pri), w_dua=_ptr(op.w_dua), rhos=op.rhos.data_ptr(),
        rho_eff=_ptr(op.rho_eff) if alpha else None, Y=st.Y.data_ptr(),
        rho_ind=st.rho_ind.data_ptr(), rho=st.rho.data_ptr(),
        pri=st.pri.data_ptr(), dua=st.dua.data_ptr(),
        done=st.done.data_ptr(), iters=st.iters.data_ptr(),
        status=st.status.data_ptr(), k=st.k.data_ptr(),
        X_prev=_ptr(st.X_prev) if certs else None,
        Lam_prev=_ptr(st.Lam_prev) if certs else None,
        n_open=st.n_open.data_ptr(), open=st.open.data_ptr(),
        tail=st.tail.data_ptr(), open_a=_ptr(st.open_a),
        best_m=_ptr(st.best_m), best_open=_ptr(st.best_open),
        n_stall=_ptr(st.n_stall), k_fast=_ptr(st.k_fast), part=None,
        tick=st.tick.data_ptr(), stamps=_ptr(batched_check.stamps),
        B=B, dp=dp, nx=nx, nc=nc,
        n_rho=op.rhos.shape[0], h_per=int(h_per), a_per=int(a_per),
        g_per=per(op.G), wp_per=per(op.w_pri), wd_per=per(op.w_dua),
        reff_per=int(alpha and op.rho_eff.dim() == 3),
        shared=int(cfg.shared), n_steps=int(n_steps), phase_a=int(phase_a),
        stop_open=int(cfg.stop_open), **_settings(cfg, dt))
    return a


_C2_REGIMES = ("smem", "stream", "tiles")


def batched_check_plan(st, op, cfg, Y, n_steps: int = 1,
                       phase: str = "") -> dict:
    """The shape C2 takes for this window on the card: its regime
    ("smem", "stream" or "tiles"), rows a tile, lanes a row in the row
    pass, threads a block, blocks, dynamic shared memory, in "stream" warps
    a block and operand buffers a warp, its variant ("shared", or "global"
    where even a one-row "tiles" tile outgrows a block's shared memory and
    the rows' vectors and products lie in the scratch region) and the
    scratch's doubles."""
    lib = _lib()
    out = (_I * 9)()
    sizes = (ctypes.c_longlong * 2)()
    with device_guard(Y.device):
        a = _c2_args(st, op, cfg, Y, n_steps, phase)
        lib.c2_plan_of(ctypes.byref(a), out)
        lib.c2_sizes(ctypes.byref(a), sizes)
    keys = ("regime", "rows", "group", "threads", "blocks", "smem",
            "warps", "buffers", "variant")
    plan = dict(zip(keys, list(out)))
    plan["regime"] = _C2_REGIMES[plan["regime"]]
    plan["variant"] = "global" if plan["variant"] else "shared"
    plan["scratch"] = sizes[0]
    return plan


def _c2_launch(st, op, cfg, Y, n_steps, phase):
    dev = Y.device
    a = _c2_args(st, op, cfg, Y, n_steps, phase)
    lib = _lib()
    sizes = (ctypes.c_longlong * 2)()
    lib.c2_sizes(ctypes.byref(a), sizes)
    if st.tick.numel() < sizes[1]:
        raise ValueError("C2: the state's tick buffer is too short "
                         "(core.batched's state buffers size it)")
    part = torch.empty((sizes[0],), dtype=torch.float64, device=dev)
    a.part = part.data_ptr()
    n = ctypes.c_int(0)
    rc = lib.c2_check(ctypes.byref(a),
                      torch.cuda.current_stream(dev).cuda_stream,
                      ctypes.byref(n))
    if rc != 0:
        _raise(lib, rc, "C2 launch")
    for _ in range(n.value):
        on_launch(_count_batched_check)


def batched_check(st, op, cfg, Y, n_steps: int, phase: str) -> None:
    """The check of a batched window, written into the loop's static
    buffers ``st`` (``batched_check_ref``'s arguments). CUDA tensors launch
    kernel C2 once, or twice where the shared walk re-encodes p for its new
    rung (alpha != 1), or raise; CPU tensors run ``batched_check_ref`` and
    copy its state into ``st``."""
    if Y.is_cuda:
        with device_guard(Y.device):
            _c2_launch(st, op, cfg, Y, n_steps, phase)
        return
    assign(st, batched_check_ref(st, op, cfg, Y, n_steps, phase))


batched_check.launches = 0
batched_check.stamps = None


def _count_batched_check():
    batched_check.launches += 1


# the stage boundaries a stamped launch records, in order (slot 0: the
# earliest block's start; ``csrc/check_window.cu``'s S_* slots): the
# vectors staged, the products formed, C2's row pass done, the ticket
# passed (C1: its cluster barrier), the partials reduced, the state written
STAMP_STAGES = ("staged", "products", "rows", "ticket", "reduced", "written")


def stage_split(run, kernel, reps: int = 20) -> dict:
    """Where one launch's time goes: ``run()`` (one launch of ``kernel``,
    ``check_window`` or ``batched_check``, on the card) ``reps`` times with
    its stage stamps on, each launch alone. Returns, per stage of
    ``STAMP_STAGES`` that the kernel stamps, the mean µs from the earliest
    block's start to the latest block's pass of that boundary."""
    dev = torch.device("cuda", torch.cuda.current_device())
    stamps = torch.zeros(len(STAMP_STAGES) + 1, dtype=torch.int64,
                         device=dev)
    sums, seen = [0.0] * len(STAMP_STAGES), [0] * len(STAMP_STAGES)
    kernel.stamps = stamps
    try:
        for _ in range(reps):
            stamps.zero_()
            stamps[0] = -1          # the start slot takes the least time
            run()
            t = stamps.cpu().tolist()
            for i in range(len(STAMP_STAGES)):
                if t[i + 1] > 0:
                    sums[i] += (t[i + 1] - t[0]) / 1e3
                    seen[i] += 1
    finally:
        kernel.stamps = None
    return {s: sums[i] / seen[i] for i, s in enumerate(STAMP_STAGES)
            if seen[i]}


def graph_kernels(raw_graph: int) -> list:
    """The nodes of a captured CUDA graph (``torch.cuda.CUDAGraph.
    raw_cuda_graph()``) in the order they run: a kernel node by its
    function's name, any other node by its type ("memcpy", "memset",
    ...)."""
    lib = _lib()
    buf = ctypes.create_string_buffer(1 << 16)
    rc = lib.cw_graph_kernels(raw_graph, buf, len(buf))
    if rc != 0:
        _raise(lib, rc, "graph walk")
    return [s for s in buf.value.decode().split("\n") if s]
