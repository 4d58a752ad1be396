"""The solve loop: check windows, residuals, the ρ walk and the exit.

A Python loop over check windows. Everything inside a window stays on the
device: the chunk runner (kernel K1 on CUDA), the residual reduction, the
ρ-index walk over the device-resident bank, the status decision and, when
asked, the infeasibility certificates. The rung index lives in a device
int32 tensor that the kernel reads itself. The loop syncs to the host ONCE
per window, in one bundled transfer of (status, pri, dua, rho_ind, ρ
estimate): a per-field ``.item()`` would cost one device round trip each.
The iteration count ``k`` is kept on the host, since every window has a
length fixed before it runs.

On ``cuda`` each window runs as one replay of a CUDA graph
(``core.graphs``), keyed by what it bakes in: its length, W operand and
tier, whether ρ moves, the tail, and the solver's operands by identity.
The solve's vectors and start state are staged into the cache's static
buffers at entry; the host keeps the window's one read and its decisions.

The chunk runner is pluggable: ``chunk_runner(W_bank, b_bank, rho_ind, lo,
hi, y, n_steps, iter_precision)``. State vectors may be padded beyond
D = nx+2nc; all slicing here uses static [0, nx+2nc) bounds so padding is
inert.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.fused_step import fused_chunk_ref, pad_dim
from .bank import Bank, DeviceQP
from .graphs import run_window, sig, window_graphs

__all__ = [
    "SolveResult",
    "xla_chunk_runner",
    "compute_residuals",
    "compute_residuals_op",
    "compute_objective",
    "infeasibility_certificates",
    "rho_ladder_step",
    "rho_update_stride",
    "run_refined_phases",
    "solve_loop",
    "ChunkRunner",
    "STATUS_MAX_ITER", "STATUS_SOLVED", "STATUS_PRIMAL_INFEASIBLE",
    "STATUS_DUAL_INFEASIBLE", "STATUS_STRINGS",
]

ChunkRunner = Callable[..., torch.Tensor]

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


class SolveResult(NamedTuple):
    y: torch.Tensor       # (Dp,) final stacked state [x; z; λ; pad]
    iters: int            # iterations executed when the status was decided
    pri_res: float        # primal residual ‖Ax−z‖∞ at exit
    dua_res: float        # dual residual ‖Hx+Aᵀλ+g‖∞ at exit
    rho_estimate: float   # last OSQP-style ρ estimate
    rho_ind: int          # final ladder index
    converged: bool
    obj_val: float        # ½xᵀHx + gᵀx at exit (0.0 when with_obj=False)
    status_code: int      # 0 max_iter, 1 solved, 2 primal_inf, 3 dual_inf
    rho_ind_dev: Optional[torch.Tensor] = None   # final index, 0-d int32


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


def xla_chunk_runner(W_bank, b_bank, rho_ind, lo, hi, y, n_steps: int,
                     iter_precision: str = "highest"):
    """``n_steps`` iterations ``y ← clip(y Wᵀ + b, lo, hi)`` in plain torch
    (``backend="xla"``), on any device and any (unpadded) D."""
    b = b_bank.index_select(0, rho_ind.reshape(1))[0]
    return fused_chunk_ref(W_bank, b, lo, hi, y, rho_ind, n_steps,
                           iter_precision)


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


def compute_objective(H, g, x):
    """½ xᵀHx + gᵀx."""
    return 0.5 * torch.dot(x, H @ x) + torch.dot(g, x)


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


def rho_update_stride(adaptive_rho_interval: int, check_interval: int) -> int:
    """Checks between ρ-ladder updates for an iteration-count interval.

    Updates happen only at residual checks, so the interval is rounded up
    to the check cadence; 0 and anything ≤ ``check_interval`` mean every
    check.
    """
    if adaptive_rho_interval <= check_interval:
        return 1
    return -(-adaptive_rho_interval // check_interval)  # ceil div


def run_refined_phases(step, running, state0, W_fast, W_high, *, refine,
                       iter_precision: str, cap_a: int, check_interval: int,
                       metric, improved, best0):
    """Drive the window loop to completion, in two phases when a reduced
    iteration precision is refined.

    Phase A runs reduced-precision windows while the solve still
    progresses; phase B polishes with "highest" windows to the true
    tolerance. ``metric(state)`` returns host stats carried as elementwise
    best-so-far minima and ``improved(m, best)`` says whether this window
    beat the best. Two consecutive stalled windows end phase A, as does the
    ``cap_a`` iteration budget (half the total, so the polish phase always
    keeps iterations). ``step(state, n_steps, W, precision)`` runs one
    window; ``state.k`` is the host iteration counter. Returns
    ``(state, k_fast, tail_W, tail_prec)``.
    """
    two_phase = refine and iter_precision != "highest"
    W_polish = W_fast if W_high is None else W_high
    if two_phase and W_polish.dtype == torch.bfloat16:
        raise ValueError(
            "refine=True with a bfloat16-stored W bank needs a full-"
            "precision polish copy (W_hi): the highest-precision refine "
            "phase would silently run at bf16 precision and tight "
            "tolerances would never be reached")
    state = state0
    if not two_phase:
        while running(state):
            state = step(state, check_interval, W_fast, iter_precision)
        return state, 0, W_fast, iter_precision
    best, n_stall = tuple(best0), 0
    while n_stall < 2 and state.k < cap_a and running(state):
        state = step(state, check_interval, W_fast, iter_precision)
        m = metric(state)
        n_stall = 0 if improved(m, best) else n_stall + 1
        best = tuple(min(b, v) for b, v in zip(best, m))
    k_fast = state.k
    while running(state):
        state = step(state, check_interval, W_polish, "highest")
    return state, k_fast, W_polish, "highest"


class _Dev(NamedTuple):
    """The device state a check window reads and writes."""
    y: torch.Tensor                           # (Dp,) stacked state
    rho_ind: torch.Tensor                     # 0-d int32 ladder index
    rho: torch.Tensor                         # 0-d: last ρ estimate
    x_prev: Optional[torch.Tensor] = None     # infeasibility deltas
    lam_prev: Optional[torch.Tensor] = None


class _Ops(NamedTuple):
    """What a window reads besides its state and W: the solver's operands
    and the solve's vectors (``g``, ``lo``, ``hi``, ``g_row`` and the
    bias's state part, staged into static buffers under graphs)."""
    rhos: torch.Tensor
    H: torch.Tensor
    A: torch.Tensor
    g: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    w_pri: Optional[torch.Tensor]
    w_dua: Optional[torch.Tensor]
    rho_eff: Optional[torch.Tensor]
    M_res: Optional[torch.Tensor]
    g_row: Optional[torch.Tensor]
    bias: tuple     # ("bank", b (N, Dp)) or ("lazy", c, M_hi, M_lo, x)


class _Cfg(NamedTuple):
    """The host values a window bakes into its launches."""
    chunk_runner: Callable
    nx: int
    nc: int
    alpha: float
    adaptive_rho: bool
    rho_jump: bool
    tol: float
    eps_pri: float
    eps_dua: float
    rho_min: float
    rho_max: float
    check_infeasibility: bool
    eps_prim_inf: float
    eps_dual_inf: float


class _State(NamedTuple):
    dev: _Dev
    k: int                    # host iteration counter
    status: int               # host copies from the window's bundle
    pri: float
    dua: float
    rho_ind_h: int
    rho_h: float


def _host_scalar_type(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _lam_of(y, rho_ind, op: _Ops, cfg: _Cfg):
    """True λ: the slot (alpha = 1) or ρ⃗(p − z)."""
    nx, nc = cfg.nx, cfg.nc
    last = y[nx + nc:nx + 2 * nc]
    if cfg.alpha == 1.0:
        return last
    rv = op.rho_eff.index_select(0, rho_ind.reshape(1))[0]
    return rv * (last - y[nx:nx + nc])


def _check(y, rho, rho_ind, op: _Ops, cfg: _Cfg):
    """The window's residuals and ρ estimate."""
    nx, nc = cfg.nx, cfg.nc
    if op.M_res is not None:
        return compute_residuals_op(op.M_res, op.g_row, y, pad_dim(nx),
                                    pad_dim(nc), rho, cfg.rho_min,
                                    cfg.rho_max)
    return compute_residuals(op.H, op.A, op.g, y[:nx], y[nx:nx + nc],
                             _lam_of(y, rho_ind, op, cfg), rho, cfg.rho_min,
                             cfg.rho_max, op.w_pri, op.w_dua)


def _bias_of(rho_ind, op: _Ops, dtype):
    """The bias bank for the runner: the stored bank, or (lazy) the
    current rung's state-affine bias expanded to bank shape (the runner's
    index_select reads only that one row)."""
    if op.bias[0] == "bank":
        return op.bias[1]
    _, c_b, M_b, Ml_b, x_b = op.bias
    idx = rho_ind.reshape(1)
    b_loc = M_b.index_select(0, idx)[0] @ x_b
    if Ml_b is not None:
        b_loc = b_loc + Ml_b.index_select(0, idx)[0] @ x_b
    if c_b is not None:
        b_loc = b_loc + c_b.index_select(0, idx)[0]
    b_loc = b_loc.to(dtype)
    return b_loc.expand(op.rhos.shape[0], b_loc.shape[0])


def _bundle(status, pri, dua, rho_ind, rho):
    """The window's scalars for its ONE device→host transfer."""
    f64 = torch.float64
    return torch.stack([status.to(f64), pri.to(f64), dua.to(f64),
                        rho_ind.to(f64), rho.to(f64)])


def _window(st: _Dev, op: _Ops, cfg: _Cfg, n_steps: int, W_op,
            precision: str, upd: bool):
    """One check window: ``n_steps`` iterations, the residuals, the ρ walk
    (moved only when ``upd``: the host knows which checks update ρ), the
    status and the certificates. Returns the new state and the bundle."""
    nx, nc = cfg.nx, cfg.nc
    y = cfg.chunk_runner(W_op, _bias_of(st.rho_ind, op, st.y.dtype),
                         st.rho_ind, op.lo, op.hi, st.y, n_steps, precision)
    pri, dua, rho_new = _check(y, st.rho, st.rho_ind, op, cfg)
    if cfg.check_infeasibility:
        lam_now = _lam_of(y, st.rho_ind, op, cfg)
    rho_ind = st.rho_ind
    if cfg.adaptive_rho:
        new_ind = (rho_ladder_step(op.rhos, rho_ind, rho_new, cfg.tol,
                                   cfg.rho_jump) if upd else rho_ind)
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
    x_prev = lam_prev = None
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
        x_prev, lam_prev = x, lam_now
    return (_Dev(y, rho_ind, rho_new, x_prev, lam_prev),
            _bundle(status, pri, dua, rho_ind, rho_new))


def _tail(st: _Dev, op: _Ops, cfg: _Cfg, rem: int, W_op, precision: str):
    """The ``max_iter % check_interval`` tail iterations and one final
    residual evaluation (no ρ walk, no certificates)."""
    y = cfg.chunk_runner(W_op, _bias_of(st.rho_ind, op, st.y.dtype),
                         st.rho_ind, op.lo, op.hi, st.y, rem, precision)
    pri, dua, rho = _check(y, st.rho, st.rho_ind, op, cfg)
    solved = (pri < cfg.eps_pri) & (dua < cfg.eps_dua)
    status = torch.where(solved, STATUS_SOLVED, _RUNNING)
    return (st._replace(y=y, rho=rho),
            _bundle(status, pri, dua, st.rho_ind, rho))


def solve_loop(bank: Bank, qp: DeviceQP, y0, rho_ind0, rho0, W_hi=None,
               rho_eff=None, bias_lazy=None, M_res=None, *,
               nx: int, nc: int, max_iter: int, check_interval: int,
               adaptive_rho: bool, adaptive_rho_tolerance: float,
               eps_abs: float, rho_min: float, rho_max: float,
               chunk_runner: ChunkRunner = xla_chunk_runner,
               verbose: bool = False,
               check_infeasibility: bool = False,
               eps_prim_inf: float = 1e-4,
               eps_dual_inf: float = 1e-4,
               rho_jump: bool = False,
               iter_precision: str = "highest",
               refine: bool = True,
               adaptive_rho_interval: int = 1,
               alpha: float = 1.0,
               with_obj: bool = True,
               _graphs=None) -> SolveResult:
    """Run the solver to convergence or ``max_iter``.

    Iterations run in ``check_interval`` windows; after each window the
    residuals are reduced on the device, the ρ index walks ±1 (or jumps)
    along the ladder when the estimate leaves [ρ_k/τ, ρ_k·τ], and the loop
    exits when pri < eps·√nc ∧ dua < eps·√nx. Convergence is checked even
    when ``adaptive_rho=False``; ``check_infeasibility`` adds OSQP
    certificates on iterate deltas; ``adaptive_rho_interval`` sets the
    iterations between ρ updates (``rho_update_stride``).

    ``bias_lazy``: optional ``(bias_c, M_hi, M_lo, x)`` state-affine bias —
    the bias at rung k is ``b_k = c_k + M_k x``, formed for the CURRENT
    rung only on window entry. ``bias_c``/``M_lo`` may be ``None``. When
    set, ``bank.b`` is ignored.

    ``alpha != 1`` runs the [x; z; p] bank: λ is reconstructed as
    ``ρ⃗ (p − z)`` with ``rho_eff`` (N_rho, nc), and every check re-encodes
    p by ρ⃗_old/ρ⃗_new.

    ``M_res``: optional stacked residual operator (alpha=1): one
    ``y @ M_res`` per check instead of three matvecs; ``g_row`` is derived
    here from ``qp.g``/``qp.w_dua``.

    ``_graphs``: the ``core.graphs.WindowGraphs`` the windows run through
    (a solver's own; a fresh one per call when None, which on ``cuda``
    graphs each window and on the CPU runs it eagerly); ``False`` runs
    every window eagerly (the A/B of the graphed path).
    """
    dtype = y0.dtype
    dev = y0.device
    # Constants stay Python numbers, rounded to the iterate dtype on the
    # host exactly as the device would round them: a tensor made on the
    # GPU from a host value is a pageable copy, which waits for the stream
    # like a sync.
    eps = torch.tensor(eps_abs, dtype=dtype)
    eps_pri = float(eps * torch.sqrt(torch.tensor(float(nc), dtype=dtype)))
    eps_dua = float(eps * torch.sqrt(torch.tensor(float(nx), dtype=dtype)))
    tol = float(torch.tensor(adaptive_rho_tolerance, dtype=dtype))
    n_chunks = max_iter // check_interval
    rem = max_iter - n_chunks * check_interval
    rho_stride = rho_update_stride(adaptive_rho_interval, check_interval)
    graphs = window_graphs(_graphs, dev)

    g_row = None
    if M_res is not None:
        if alpha != 1.0:
            raise ValueError("M_res (stacked residual operator) requires "
                             "alpha=1 — the operator reads the λ slot "
                             "directly")
        nxp, ncp = pad_dim(nx), pad_dim(nc)
        if tuple(M_res.shape) != (y0.shape[0], 2 * ncp + 2 * nxp):
            raise ValueError(f"M_res shape {tuple(M_res.shape)} does not "
                             f"match (Dp={y0.shape[0]}, "
                             f"R={2 * ncp + 2 * nxp})")
        gv = qp.g if qp.w_dua is None else qp.w_dua * qp.g
        g_row = torch.zeros((nxp,), dtype=dtype, device=dev)
        g_row[:nx] = gv.to(dtype)
    cfg = _Cfg(chunk_runner, nx, nc, alpha, adaptive_rho, rho_jump, tol,
               eps_pri, eps_dua, float(rho_min), float(rho_max),
               check_infeasibility, float(eps_prim_inf), float(eps_dual_inf))
    bias = ("bank", bank.b) if bias_lazy is None else ("lazy", *bias_lazy)
    ops = _Ops(bank.rhos, qp.H, qp.A, qp.g, qp.lo, qp.hi, qp.w_pri,
               qp.w_dua, rho_eff, M_res, g_row, bias)

    # the start index and ρ may already be device tensors (the rollout
    # carries them from step to step); a host value costs one copy here
    if isinstance(rho_ind0, torch.Tensor):
        rho_ind_t = rho_ind0.to(device=dev, dtype=torch.int32).reshape(())
        rho_ind_h = -1      # not read: the first window's bundle sets it
    else:
        rho_ind_t = torch.tensor(int(rho_ind0), dtype=torch.int32,
                                 device=dev)
        rho_ind_h = int(rho_ind0)
    rho_t = torch.as_tensor(rho0, dtype=dtype, device=dev).reshape(())
    dev0 = _Dev(y0, rho_ind_t, rho_t)
    if check_infeasibility:
        dev0 = dev0._replace(x_prev=y0[:nx],
                             lam_prev=_lam_of(y0, rho_ind_t, ops, cfg))
    bundle_buf = None
    if graphs is not None:
        # the solve's vectors and start state into the static buffers the
        # graphs read; the solver's operands stay where they are
        st_in = lambda name, t: graphs.stage("qp." + name, t)
        bias = (("bank", st_in("b", bias[1])) if bias[0] == "bank"
                else bias[:4] + (st_in("x", bias[4]),))
        ops = ops._replace(g=st_in("g", ops.g), lo=st_in("lo", ops.lo),
                           hi=st_in("hi", ops.hi),
                           g_row=st_in("g_row", ops.g_row), bias=bias)
        dev0 = _Dev(*(st_in(f, t) for f, t in zip(_Dev._fields, dev0)))
        bundle_buf = graphs.buffer("qp.bundle", (5,), torch.float64, dev)
    base = (sig(ops), sig(dev0), cfg)

    def run(kind, st: _State, n_steps: int, W_op, precision: str, upd,
            fn) -> _State:
        key = (kind, n_steps, precision, upd, sig(W_op), base)
        dev_st, h = run_window(graphs, key, fn, st.dev, bundle_buf)
        status_h, pri_h, dua_h, ind_h, rho_h = (int(h[0]), h[1], h[2],
                                                int(h[3]), h[4])
        if verbose and kind == "window":
            print(f"Iter: {st.k + n_steps}, rho: {rho_h:.2e}, res_p: "
                  f"{pri_h:.2e}, res_d: {dua_h:.2e}")
        return _State(dev_st, st.k + n_steps, status_h, pri_h, dua_h,
                      ind_h, rho_h)

    def step(st: _State, n_steps: int, W_op, precision: str) -> _State:
        # ρ updates only every rho_stride-th check (host-known: every
        # window has a fixed length)
        k = st.k + n_steps
        upd = rho_stride == 1 or (-((-k) // check_interval)) % rho_stride == 0
        return run("window", st, n_steps, W_op, precision, upd,
                   lambda s: _window(s, ops, cfg, n_steps, W_op, precision,
                                     upd))

    def running(st: _State) -> bool:
        return st.status < 0 and st.k < n_chunks * check_interval

    # every solve runs at least one window or the tail, which sets the
    # host copy of the ρ estimate; NaN only stands in until then
    state0 = _State(dev0, 0, _RUNNING, 0.0, 0.0, rho_ind_h, float("nan"))

    # Phase policy (reduced-precision phase A + "highest" polish) in
    # run_refined_phases; the stall metric is the residual pair with a 3%
    # improvement threshold, compared in the iterate's own precision.
    sc = _host_scalar_type(dtype)
    inf0 = float("inf")
    st, _, tail_W, tail_prec = run_refined_phases(
        step, running, state0, bank.W, W_hi, refine=refine,
        iter_precision=iter_precision,
        cap_a=(n_chunks // 2) * check_interval,
        check_interval=check_interval,
        metric=lambda s: (s.pri, s.dua),
        improved=lambda m, best: bool(sc(m[0]) < sc(0.97) * sc(best[0])
                                      or sc(m[1]) < sc(0.97) * sc(best[1])),
        best0=(inf0, inf0))

    if rem > 0 and st.status < 0:
        # Tail iterations when max_iter % check_interval != 0, then one
        # final residual evaluation.
        st = run("tail", st, rem, tail_W, tail_prec, None,
                 lambda s: _tail(s, ops, cfg, rem, tail_W, tail_prec))

    status = STATUS_MAX_ITER if st.status < 0 else st.status
    iters = st.k if status != STATUS_MAX_ITER else max_iter
    y, rho_ind = st.dev.y, st.dev.rho_ind
    if graphs is not None:
        # the static buffers belong to the next solve
        y, rho_ind = y.clone(), rho_ind.clone()
    obj = (float(compute_objective(qp.H, qp.g, y[:nx])) if with_obj
           else 0.0)
    return SolveResult(y=y, iters=iters, pri_res=st.pri, dua_res=st.dua,
                       rho_estimate=st.rho_h, rho_ind=st.rho_ind_h,
                       converged=status == STATUS_SOLVED, obj_val=obj,
                       status_code=status, rho_ind_dev=rho_ind)
