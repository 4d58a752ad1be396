"""The batched solve loops: many QPs in one loop of check windows.

Two regimes:

- **shared (H, A)** (``solve_batched_shared``): all problems share one
  weight bank; one iteration of the whole batch is a (B, Dp) @ (Dp, Dp)
  product per step. Two ρ-adaptation modes:

  * ``rho_mode="shared"``: one ladder index for the batch, walked by the
    geometric mean of the active problems' OSQP ρ estimates; the chunk runs
    through kernel K4 on CUDA (``ops.fused_step.pallas_batched_chunk_runner``)
    or the plain runner ``_chunk_shared_rho``;
  * ``rho_mode="per_problem"``: every problem walks its own index; the plain
    runners gather per-problem Wᵀ (small batches) or run every rung and
    select one-hot (large ones).

  ``solve_batched_shared_repack`` runs the same loop over a schedule of
  shrinking row buffers, compacting the open rows between stages.

- **heterogeneous** (``solve_batched_hetero``): every problem has its own H,
  A and so its own (N, Dp, Dp) bank, and walks its own ladder index; the
  chunk runs through kernel K5 on CUDA
  (``ops.fused_step.pallas_hetero_chunk_runner``, each problem's rung read
  by the kernel from the (B, N, Dp, Dp) bank) or the plain runner
  ``_chunk_hetero`` (a per-problem gather and a batched product).

Each problem carries its own ``done`` flag, first-convergence iteration
count and status; converged problems keep iterating (a converged ADMM
iterate is a fixed point up to noise) but their ρ index and stats are
frozen. Each window's check is kernel C2 on ``cuda`` (``ops.check_window``;
its plain version on the CPU and under a process group). A solve is one
device program (``core.graphs``, as ``core.iteration``'s): its start piece
builds the cold state, the windows run under a loop whose exit (the open
count, the budget and, under a two-phase refine, the stall test on the
mean log-residual of the open problems) the device decides, the tail window under an IF, and the result
piece bundles the iteration counts with the per-problem stats for the
solve's one host read. On ``cuda`` that is one graph launch; repack stages
(their compaction between stages stays eager) and a process group walk
the windows from the host, one replay each.

Given a process ``group`` (one process per device, each holding its rows of
the batch; ``parallel.sharded``), the exit is collective: the window's open
count and stall-metric sums are all-reduced on the device before its exit
flag is written (and read by the host), and under the shared ρ walk so
are the sum of the open
rows' log ρ estimates and their count, before the rung decision. That is
two reductions per window walking one rung, one per problem; every rank
then takes the same decisions and leaves the loop together.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.check_window import (STATUS_MAX_ITER, STATUS_SOLVED, assign,
                                batched_check, batched_check_ref,
                                batched_infeasibility_certificates,
                                batched_lam_of, batched_residuals)
from ..ops.fused_step import _bf16, fused_chunk_ref
from .graphs import Cond, Piece, Program, sig, window_graphs
from .iteration import _host_scalar_type, refine_items, rho_update_stride

__all__ = [
    "BatchSolveResult",
    "batched_residuals",
    "batched_infeasibility_certificates",
    "solve_batched_shared",
    "solve_batched_shared_repack",
    "solve_batched_hetero",
    "batch_program",
]

_TINY = 1e-30
# Below this batch size the per-problem-W gather is the cheaper plain
# per-problem runner; above it, every rung's product and a one-hot select.
_GATHER_BATCH_MAX = 32


class BatchSolveResult(NamedTuple):
    Y: torch.Tensor          # (B, Dp) final stacked states
    iters: torch.Tensor      # (B,) int32 first-convergence iteration (or max_iter)
    pri_res: torch.Tensor    # (B,) primal residuals at exit
    dua_res: torch.Tensor    # (B,) dual residuals at exit
    rho_estimate: torch.Tensor   # (B,) last ρ estimates
    rho_ind: torch.Tensor    # () or (B,) int32 final ladder indices (device)
    converged: torch.Tensor  # (B,) bool (status == STATUS_SOLVED)
    n_iter_total: int        # iterations the batch ran
    status: torch.Tensor     # (B,) int32 per-problem STATUS_* codes
    n_iter_fast: int         # iterations run at reduced precision (0 unless
                             # the two-phase refine was active)
    stats: Optional[np.ndarray] = None   # (6, B) host copy of iters,
                             # status, pri, dua, ρ estimate and rung, read
                             # with the result bundle (None after repack)
    out: Optional[torch.Tensor] = None   # the result bundle unread (under
                             # a process group: n_iter_* are then None)


# --------------------------------------------------------------------- #
# plain chunk runners                                                   #
# --------------------------------------------------------------------- #

def _tier_product(Y, W, iter_precision: str, mm):
    """``mm(Y, W)`` at the iteration tier, as ``fused_chunk_ref`` runs K1's
    tiers: "highest" full precision, "high" the bf16 hi/lo split with lo·lo
    dropped, "default"/"bf16" (or a bf16 bank) bf16-rounded inputs."""
    dt = Y.dtype
    if iter_precision in ("default", "bf16") or W.dtype == torch.bfloat16:
        return mm(_bf16(Y, dt), _bf16(W, dt))
    W = W.to(dt)
    if iter_precision == "high":
        w_h = _bf16(W, dt)
        w_l = _bf16(W - w_h, dt)
        y_h = _bf16(Y, dt)
        y_l = _bf16(Y - y_h, dt)
        return (mm(y_h, w_l) + mm(y_l, w_h)) + mm(y_h, w_h)
    return mm(Y, W)


def _chunk_shared_rho(Wt_bank, bias_all, rho_ind, lo, hi, Y, n_steps: int,
                      iter_precision: str = "highest"):
    """One shared ladder index: ``Y ← clip(Y Wᵀ + b)`` as one product per
    step, in plain torch (``backend="xla"``). ``bias_all`` (N, B, Dp)."""
    b = bias_all.index_select(0, rho_ind.reshape(1))[0]
    return fused_chunk_ref(Wt_bank, b, lo, hi, Y, rho_ind, n_steps,
                           iter_precision)


def _chunk_rung_gemm(Wt_bank, bias_all, rho_inds, lo, hi, Y, n_steps: int,
                     iter_precision: str = "highest"):
    """Per-problem ρ via every rung's product and a one-hot select (large
    batches)."""
    n_rho = Wt_bank.shape[0]
    onehot = torch.nn.functional.one_hot(rho_inds.long(), n_rho).to(Y.dtype)
    b = torch.einsum("nbd,bn->bd", bias_all, onehot)
    mm = lambda y, w: torch.einsum("bd,ndk->nbk", y, w)
    for _ in range(n_steps):
        Zall = _tier_product(Y, Wt_bank, iter_precision, mm)
        YW = torch.einsum("nbk,bn->bk", Zall, onehot)
        Y = torch.minimum(torch.maximum(YW + b, lo), hi)
    return Y


def _chunk_gathered(Wt_bank, bias_all, rho_inds, lo, hi, Y, n_steps: int,
                    iter_precision: str = "highest"):
    """Per-problem ρ via a per-problem Wᵀ gather and a batched product
    (small batches)."""
    idx = rho_inds.long()
    Wt = Wt_bank[idx]                                          # (B, Dp, Dp)
    b = bias_all[idx, torch.arange(Y.shape[0], device=Y.device)]  # (B, Dp)
    return _batched_steps(Wt, b, lo, hi, Y, n_steps, iter_precision)


def _chunk_hetero(Wt_bank, bias_bank, rho_inds, lo, hi, Y, n_steps: int,
                  iter_precision: str = "highest"):
    """Per-problem banks (``backend="xla"``): gather each problem's current
    rung once per window and run a batched product per step.
    ``Wt_bank`` (B, N, Dp, Dp); ``bias_bank`` (B, N, Dp)."""
    rows = torch.arange(Y.shape[0], device=Y.device)
    idx = rho_inds.long()
    return _batched_steps(Wt_bank[rows, idx], bias_bank[rows, idx], lo, hi,
                          Y, n_steps, iter_precision)


def _batched_steps(Wt, b, lo, hi, Y, n_steps: int, iter_precision: str):
    """``n_steps`` of ``Y ← clip(Y Wtᵢ + b, lo, hi)`` with one (Dp, Dp)
    block per row (``Wt`` (B, Dp, Dp))."""
    mm = lambda y, w: torch.bmm(y[:, None, :], w)[:, 0, :]
    for _ in range(n_steps):
        YW = _tier_product(Y, Wt, iter_precision, mm)
        Y = torch.minimum(torch.maximum(YW + b, lo), hi)
    return Y


# --------------------------------------------------------------------- #
# shared-(H, A) batch                                                   #
# --------------------------------------------------------------------- #

class _Dev(NamedTuple):
    """The device state of a batched solve: static buffers its pieces read
    and write (a cache's, or this call's own when eager). The int32
    scalars but the rung are elements of ``ctl``, which a host walk reads
    in one copy."""
    Y: torch.Tensor           # (B, Dp) stacked states
    rho_ind: torch.Tensor     # () or (B,) int32 ladder indices
    rho: torch.Tensor         # (B,) last ρ estimates
    pri: torch.Tensor
    dua: torch.Tensor
    done: torch.Tensor        # (B,) bool
    iters: torch.Tensor       # (B,) int32
    status: torch.Tensor      # (B,) int32
    k: torch.Tensor           # () int32 iterations run
    X_prev: Optional[torch.Tensor] = None     # infeasibility deltas
    Lam_prev: Optional[torch.Tensor] = None
    n_open: Optional[torch.Tensor] = None     # () int32 open problems
    open: Optional[torch.Tensor] = None       # () int32: the loop runs
    tail: Optional[torch.Tensor] = None       # () int32: the tail runs
    open_a: Optional[torch.Tensor] = None     # two-phase refine: phase A
    best_m: Optional[torch.Tensor] = None     # runs; its best metric and
    best_open: Optional[torch.Tensor] = None  # open count, stalled
    n_stall: Optional[torch.Tensor] = None    # windows in a row and
    k_fast: Optional[torch.Tensor] = None     # iterations run
    ctl: Optional[torch.Tensor] = None        # (n,) int32: the scalars
    tick: Optional[torch.Tensor] = None       # (B + 2,) int32: C2's
                                              # tickets and the old rung


class _Ops(NamedTuple):
    """What a window reads besides its state and W: the solver's operands
    and the solve's vectors, staged into static buffers."""
    rhos: torch.Tensor        # (N,) in the iterate dtype
    H: torch.Tensor
    A: torch.Tensor
    G: torch.Tensor
    lo: torch.Tensor
    hi: torch.Tensor
    w_pri: Optional[torch.Tensor]
    w_dua: Optional[torch.Tensor]
    rho_eff: Optional[torch.Tensor]   # (N, nc) or, per problem, (B, N, nc)
    # ("bank", (N, B, Dp) | (B, N, Dp)), ("lazy", c | None, M_hi, M_lo |
    # None, X) or ("rows", (N, B_all, Dp), row map (B,))
    bias: tuple


class _Cfg(NamedTuple):
    """The host values a batched solve's pieces bake into their
    launches."""
    shared: bool
    chunk_runner: object
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
    two_phase: bool
    group: object
    check_interval: int
    budget: int           # iterations of the full windows
    rho_stride: int       # checks between ρ updates
    cap_a: int            # phase A's iteration cap
    stall: float          # phase A's progress margin 0.03, iterate dtype
    stop_open: int        # the stage ends at this many open problems
    kernel_check: bool = True   # C2 on cuda; off: the plain check (A/B)


def _start(Y0, rho_ind0, rhos_t, done0, max_iter, check_infeasibility, nx,
           nc, alpha, rho_eff) -> _Dev:
    """The cold loop state from the start rung(s) (an int32 tensor) and
    the done mask (a bool tensor or None) on Y0's device."""
    B = Y0.shape[0]
    dtype, dev = Y0.dtype, Y0.device
    # index_select, not rhos_t[rho_ind0]: a 0-d index tensor is read to the
    # host (a sync)
    rho0 = (rhos_t.index_select(0, rho_ind0.reshape(-1).long())
            * torch.ones((B,), dtype=dtype, device=dev))
    zeros = torch.zeros((B,), dtype=dtype, device=dev)
    done = (torch.zeros((B,), dtype=torch.bool, device=dev) if done0 is None
            else done0)
    iters = torch.where(done, 0, max_iter).to(torch.int32)
    # inert (padding) rows report "solved" so they never hold the loop open
    status = torch.where(done, STATUS_SOLVED, STATUS_MAX_ITER).to(torch.int32)
    k = torch.zeros((), dtype=torch.int32, device=dev)
    d = _Dev(Y0, rho_ind0, rho0, zeros, zeros, done, iters, status, k)
    if check_infeasibility:
        d = d._replace(X_prev=Y0[:, :nx],
                       Lam_prev=batched_lam_of(Y0, rho_ind0, nx, nc, alpha,
                                               rho_eff))
    return d


def _cold_state(graphs, Y0, rho_ind0, rhos_t, done0, max_iter,
                check_infeasibility, nx, nc, alpha, rho_eff, two_phase):
    """The static state of a solve and the piece that makes it cold: the
    start states and rungs (and the done mask) are copied in; the cold
    piece (``(what it reads, fn)``) computes the rest there, inside the
    solve's program. Returns ``(state, cold)``."""
    B, dtype, dev = Y0.shape[0], Y0.dtype, Y0.device
    if isinstance(rho_ind0, torch.Tensor):
        rho_ind0 = rho_ind0.to(device=dev, dtype=torch.int32)
    elif np.ndim(rho_ind0) == 0:
        rho_ind0 = int(rho_ind0)     # written by a fill: no upload
    else:
        rho_ind0 = torch.as_tensor(np.asarray(rho_ind0, np.int32),
                                   device=dev)
    if done0 is not None:
        done0 = torch.as_tensor(done0, dtype=torch.bool, device=dev)
    args = (max_iter, check_infeasibility, nx, nc, alpha, rho_eff)
    st = lambda name, t: graphs.stage("batch." + name, t)
    shapes = (B, tuple(Y0.shape), tuple(np.shape(rho_ind0)), dtype, dev, nx,
              nc, check_infeasibility, two_phase)
    d = graphs.made(("batch.state",) + shapes,
                    lambda: _buffers(graphs, *shapes))
    d.Y.copy_(Y0)
    if isinstance(rho_ind0, int):
        d.rho_ind.fill_(rho_ind0)
    else:
        d.rho_ind.copy_(rho_ind0)
    done_in = st("done0", done0)

    def cold():
        assign(d, _start(d.Y, d.rho_ind, rhos_t, done_in, *args))
        d.n_open.fill_(B)

    return d, (("cold", done_in, rhos_t) + args, cold)


def _buffers(graphs, B, y_shape, ind_shape, dtype, dev, nx, nc,
             check_infeasibility, two_phase) -> _Dev:
    """The static state buffers for ``B`` rows (named by field)."""
    buf = lambda name, shape, dt=dtype: graphs.buffer("batch." + name,
                                                      shape, dt, dev)
    i32 = torch.int32
    ints = ["k", "n_open", "open", "tail"] + (
        ["open_a", "best_open", "n_stall", "k_fast"] if two_phase else [])
    ctl = buf("ctl", (len(ints),), i32)
    c = {name: ctl[i] for i, name in enumerate(ints)}
    d = _Dev(buf("Y", y_shape), buf("rho_ind", ind_shape, i32),
             buf("rho", (B,)), buf("pri", (B,)), buf("dua", (B,)),
             buf("done", (B,), torch.bool), buf("iters", (B,), i32),
             buf("status", (B,), i32), c["k"], n_open=c["n_open"],
             open=c["open"], tail=c["tail"], ctl=ctl,
             # C2's tickets (the grid's, one per row tile) start at 0,
             # and every launch leaves them so
             tick=buf("tick", (B + 2,), i32).zero_())
    if check_infeasibility:
        d = d._replace(X_prev=buf("X_prev", (B, nx)),
                       Lam_prev=buf("Lam_prev", (B, nc)))
    if two_phase:
        d = d._replace(open_a=c["open_a"], best_m=buf("best_m", ()),
                       best_open=c["best_open"], n_stall=c["n_stall"],
                       k_fast=c["k_fast"])
    return d


def solve_batched_shared(Wt_bank, bias_all, rhos, H, A, G, lo, hi, Y0,
                         rho_ind0, done0=None, Wt_bank_hi=None,
                         rho_eff=None, w_pri=None, w_dua=None,
                         bias_lazy=None, *,
                         nx: int, nc: int, max_iter: int,
                         check_interval: int, adaptive_rho: bool,
                         adaptive_rho_tolerance: float, eps_abs: float,
                         rho_min: float, rho_max: float,
                         rho_mode: str = "shared", chunk_runner=None,
                         rho_jump: bool = False,
                         check_infeasibility: bool = False,
                         eps_prim_inf: float = 1e-4,
                         eps_dual_inf: float = 1e-4,
                         iter_precision: str = "highest",
                         refine: bool = True,
                         adaptive_rho_interval: int = 1,
                         alpha: float = 1.0,
                         group=None, _graphs=None) -> BatchSolveResult:
    """Solve a batch of QPs sharing (H, A).

    Args:
      Wt_bank: (N_rho, Dp, Dp) shared transposed (padded) bank.
      bias_all: (N_rho, B, Dp) per-rung biases ``b_k = B_k g_i``.
      rhos: (N_rho,) ladder values.
      H, A: shared problem matrices (unpadded), for the residuals.
      G: (B, nx) per-problem linear terms.
      lo, hi: (B, Dp) per-problem clamp bounds.
      Y0: (B, Dp) start states.
      rho_ind0: int or 0-d int32 tensor ("shared"), (B,) ("per_problem").
      done0: optional (B,) bool mask of rows treated as converged from the
        start (inert batch-padding rows), left out of the ρ walk.
      chunk_runner: the ``_chunk_*`` signature; K4's runner plugs in here
        (shared mode only).
      bias_lazy: optional ``(bias_c (N, Dp) | None, M_hi (N, Dp, np),
        M_lo | None, X (B, np))`` state-affine bias (shared mode only): per
        window the loop forms the CURRENT rung's bias ``c_k + X M_kᵀ`` as
        one product; ``bias_all`` is then not read.
      group: optional process group whose ranks each solve their rows of
        one batch with this call: the exit (and the shared ρ walk) is
        all-reduced over it, the windows walked from the host, and the
        result bundle left unread in ``out`` (``n_iter_total`` and
        ``n_iter_fast`` None) for the caller's one read.
      _graphs: the ``core.graphs.WindowGraphs`` the solve runs through (as
        ``iteration.solve_loop``'s; ``False``: every piece eager).
    """
    B = Y0.shape[0]
    shared = rho_mode == "shared"
    if chunk_runner is None:
        if shared:
            chunk_runner = _chunk_shared_rho
        else:
            chunk_runner = (_chunk_gathered if B <= _GATHER_BATCH_MAX
                            else _chunk_rung_gemm)
    if bias_lazy is not None and not shared:
        raise ValueError("bias_lazy requires rho_mode='shared' (one rung "
                         "per window; per-problem rungs need the full "
                         "materialized bias bank)")
    bias = ("bank", bias_all) if bias_lazy is None else ("lazy", *bias_lazy)
    return _solve_batched(
        Wt_bank, bias, rhos, H, A, G, lo, hi, Y0, rho_ind0, done0,
        Wt_bank_hi, rho_eff, w_pri, w_dua, shared=shared,
        chunk_runner=chunk_runner, nx=nx, nc=nc,
        max_iter=max_iter, check_interval=check_interval,
        adaptive_rho=adaptive_rho,
        adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
        rho_min=rho_min, rho_max=rho_max, rho_jump=rho_jump,
        check_infeasibility=check_infeasibility, eps_prim_inf=eps_prim_inf,
        eps_dual_inf=eps_dual_inf, iter_precision=iter_precision,
        refine=refine, adaptive_rho_interval=adaptive_rho_interval,
        alpha=alpha, group=group, _graphs=_graphs)


def solve_batched_shared_repack(Wt_bank, bias_all, rhos, H, A, G, lo, hi,
                                Y0, rho_ind0, done0=None, rho_eff=None,
                                w_pri=None, w_dua=None, *, schedule,
                                nx: int, nc: int, max_iter: int,
                                check_interval: int, adaptive_rho: bool,
                                adaptive_rho_tolerance: float,
                                eps_abs: float, rho_min: float,
                                rho_max: float, rho_mode: str = "shared",
                                chunk_runner=None, rho_jump: bool = False,
                                check_infeasibility: bool = False,
                                eps_prim_inf: float = 1e-4,
                                eps_dual_inf: float = 1e-4,
                                iter_precision: str = "highest",
                                adaptive_rho_interval: int = 1,
                                alpha: float = 1.0,
                                _graphs=None) -> BatchSolveResult:
    """Shared-(H, A) batched solve that drops converged rows as it goes.

    The dense loop keeps every row in the iteration until the last one
    converges. Here the solve runs as a fixed ``schedule`` of shrinking row
    capacities: stage s runs the window loop until the open rows fit the
    next capacity (``n_open <= schedule[s+1]``, decided on the device like
    the dense loop's exit); between stages a stable ``argsort(done)``
    compacts the open rows, in their original order, to the front on the
    device (the open count carried and capped there), and each
    stage's per-row results are scattered into full-size accumulators. The
    iteration counter carries across stages, so ``max_iter`` and the
    per-row ``iters`` are the dense loop's. Only converged rows are
    dropped, and they already count for nothing in the shared-ρ walk, so
    open rows follow the dense loop's trajectories. Each stage is walked
    from the host, window by window (every stage capacity has its own
    graphs), one read of the control vector per window; the next stage
    starts from the open count and iterations of that last read (its flags
    the host's: a carried stage has no start piece), so a stage boundary
    adds no read and no launch. The compaction between stages runs
    eagerly.

    Single-phase only (``refine=False`` semantics: a phase switch cannot be
    carried across stage boundaries), and ``max_iter`` a multiple of
    ``check_interval``: a stage that exits on the budget may hold more open
    rows than the next capacity, and the final stage's partial-window tail
    would then miss the dropped ones.

    Args:
      schedule: strictly decreasing row capacities, ``schedule[0]`` the
        batch's rows (``BatchedReLU_QP._make_repack_schedule``).
      The rest as ``solve_batched_shared`` (no ``bias_lazy``). In
      ``rho_mode="shared"`` a stage after the first reads the current
      rung's bias row of the full batch through the row map, not a
      gathered (N, B_s, Dp) bank; ``"per_problem"`` gathers the bank. The
      per-problem plain runner is the one the initial batch size picks,
      pinned for every stage (another one would sum in another order).
    """
    B = Y0.shape[0]
    if not schedule or schedule[0] != B:
        raise ValueError(f"schedule[0] must equal the padded batch size "
                         f"{B}, got {schedule}")
    if any(b >= a for a, b in zip(schedule, schedule[1:])):
        raise ValueError(f"schedule must be strictly decreasing: {schedule}")
    if len(schedule) > 1 and max_iter % check_interval != 0:
        raise ValueError(
            f"repack with max_iter={max_iter} % check_interval="
            f"{check_interval} != 0 would drop open rows before the final "
            "partial-window tail; round max_iter to a multiple of the "
            "window")
    shared = rho_mode == "shared"
    if chunk_runner is None:
        chunk_runner = (_chunk_shared_rho if shared else
                        _chunk_gathered if B <= _GATHER_BATCH_MAX
                        else _chunk_rung_gemm)
    dev_t = Y0.device
    graphs = window_graphs(_graphs, dev_t)
    rhos_t = _rhos_in(graphs, rhos, Y0.dtype)
    loop = dict(shared=shared, chunk_runner=chunk_runner, nx=nx, nc=nc,
                max_iter=max_iter, check_interval=check_interval,
                adaptive_rho=adaptive_rho,
                adaptive_rho_tolerance=adaptive_rho_tolerance,
                eps_abs=eps_abs, rho_min=rho_min, rho_max=rho_max,
                rho_jump=rho_jump, check_infeasibility=check_infeasibility,
                eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf,
                iter_precision=iter_precision, refine=False,
                adaptive_rho_interval=adaptive_rho_interval, alpha=alpha)
    st, cold = _cold_state(graphs, Y0, rho_ind0, rhos_t, done0, max_iter,
                           check_infeasibility, nx, nc, alpha, rho_eff,
                           False)
    # per-row leaves; the ladder index is per row only per problem
    rows = ["Y", "rho", "pri", "dua", "done", "iters", "status"]
    if not shared:
        rows.append("rho_ind")
    carried = rows + (["X_prev", "Lam_prev"] if check_infeasibility else [])
    acc = None
    orig = torch.arange(B, device=dev_t)
    if shared:
        # every stage reads the full batch's bias bank: staged once
        bias_all = graphs.stage("batch.bias", bias_all)
    G_s, lo_s, hi_s, bias_s, wp_s, wd_s = G, lo, hi, bias_all, w_pri, w_dua
    budget = (max_iter // check_interval) * check_interval
    # the open rows and iterations the next stage starts from, known to the
    # host from the last stage's last read of its control vector
    n_open = k = None
    for si in range(len(schedule)):
        last = si == len(schedule) - 1
        stop = 0 if last else schedule[si + 1]
        bias = (("rows", bias_all, orig) if shared and si > 0
                else ("bank", bias_s))
        ops, st = _staged(graphs, _Ops(rhos_t, H, A, G_s, lo_s, hi_s, wp_s,
                                       wd_s, rho_eff, bias), st)
        # a stage's program is made once per solver: it closes over static
        # buffers and the solver's operands only
        first = cold if si == 0 else None
        prog, _ = graphs.made(
            ("repack", Wt_bank, tuple(ops), st, None if first is None
             else first[0], stop, last, frozenset(loop.items())),
            lambda: batch_program(
                graphs, ops, st, Wt_bank, None, cold=first, stop_open=stop,
                with_rem=last, stats=False, with_result=False, **loop))
        # a carried stage starts from the flags of the last read
        known = () if si == 0 else (
            (st.k, k), (st.n_open, n_open),
            (st.open, int(n_open > stop and k < budget)),
            (st.tail, int(n_open > 0)))
        graphs.program(prog, dev_t, per_window=True, known=known)
        n_open, k = prog.value(st.n_open), prog.value(st.k)
        if acc is None:
            acc = {f: getattr(st, f).clone() for f in rows}
        else:
            for f in rows:
                acc[f][orig] = getattr(st, f)
        if last:
            if k is None:
                # a tail window ran after the walk's last read
                k = int(graphs.read(st.k))
            break
        # stable sort: the open rows first, in their original order
        cap = schedule[si + 1]
        sel = torch.argsort(st.done.to(torch.int8), stable=True)[:cap]
        st.n_open.clamp_(max=cap)
        n_open = min(n_open, cap)
        st = st._replace(**{f: getattr(st, f)[sel] for f in carried})
        orig = orig[sel]
        G_s, lo_s, hi_s = G_s[sel], lo_s[sel], hi_s[sel]
        if not shared:
            bias_s = bias_s[:, sel]
        if wp_s is not None and wp_s.dim() == 2:
            wp_s = wp_s[sel]
        if wd_s is not None and wd_s.dim() == 2:
            wd_s = wd_s[sel]
    return _wrap_result(st._replace(**acc), [k, 0, 0])


def solve_batched_hetero(Wt_bank, bias_bank, rhos, H, A, G, lo, hi, Y0,
                         rho_ind0, Wt_bank_hi=None, rho_eff=None,
                         w_pri=None, w_dua=None, *,
                         nx: int, nc: int, max_iter: int,
                         check_interval: int, adaptive_rho: bool,
                         adaptive_rho_tolerance: float, eps_abs: float,
                         rho_min: float, rho_max: float,
                         chunk_runner=None,
                         rho_jump: bool = False,
                         check_infeasibility: bool = False,
                         eps_prim_inf: float = 1e-4,
                         eps_dual_inf: float = 1e-4,
                         iter_precision: str = "highest",
                         refine: bool = True,
                         adaptive_rho_interval: int = 1,
                         alpha: float = 1.0,
                         group=None, _graphs=None) -> BatchSolveResult:
    """Solve a batch of QPs with per-problem (H, A).

    Args:
      Wt_bank: (B, N_rho, Dp, Dp) per-problem transposed (padded) banks.
      bias_bank: (B, N_rho, Dp) per-problem per-rung biases.
      rhos: (N_rho,) ladder values (one ladder; the effective per-row ρ⃗
        ``rho_eff`` (B, N_rho, nc) differs by problem).
      H: (B, nx, nx); A: (B, nc, nx); G: (B, nx).
      lo, hi, Y0: (B, Dp). rho_ind0: (B,) int32: every problem walks its
        own index.
      chunk_runner: ``_chunk_hetero``'s signature; K5's runner
        (``ops.fused_step.pallas_hetero_chunk_runner``) plugs in here.
      group: optional process group of the ranks that each solve their
        problems of one batch: the exit is all-reduced over it.
      _graphs: as ``solve_batched_shared``'s.
    """
    if chunk_runner is None:
        chunk_runner = _chunk_hetero
    return _solve_batched(
        Wt_bank, ("bank", bias_bank), rhos, H, A, G, lo, hi, Y0,
        rho_ind0, None, Wt_bank_hi, rho_eff, w_pri, w_dua, shared=False,
        chunk_runner=chunk_runner, nx=nx, nc=nc,
        max_iter=max_iter, check_interval=check_interval,
        adaptive_rho=adaptive_rho,
        adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
        rho_min=rho_min, rho_max=rho_max, rho_jump=rho_jump,
        check_infeasibility=check_infeasibility, eps_prim_inf=eps_prim_inf,
        eps_dual_inf=eps_dual_inf, iter_precision=iter_precision,
        refine=refine, adaptive_rho_interval=adaptive_rho_interval,
        alpha=alpha, group=group, _graphs=_graphs)


def _rhos_in(graphs, rhos, dtype):
    """The ladder in the iterate dtype: the solver's own tensor where it is
    (a graph keys it by identity), else a converted copy, staged under
    graphs."""
    if rhos.dtype == dtype or graphs is None:
        return rhos.to(dtype)
    return graphs.stage("batch.rhos", rhos.to(dtype))


def _bias_of(op: _Ops, rho_ind, dtype):
    """The bias bank for the runner: materialized, the current rung's row
    of the full batch through a row map (a repack stage), or (lazy) the
    current rung's per-problem bias ``c_k + X M_kᵀ``, expanded to bank
    shape (the runner reads only that one row)."""
    kind = op.bias[0]
    if kind == "bank":
        return op.bias[1]
    n_rho = op.rhos.shape[0]
    idx = rho_ind.reshape(1)
    if kind == "rows":
        _, bank, sel = op.bias
        b = bank.index_select(0, idx)[0]
        b = b.index_select(0, sel)
        return b.expand(n_rho, *b.shape)
    _, c_b, M_b, Ml_b, X_b = op.bias
    b_loc = X_b @ M_b.index_select(0, idx)[0].T
    if Ml_b is not None:
        b_loc = b_loc + X_b @ Ml_b.index_select(0, idx)[0].T
    if c_b is not None:
        b_loc = b_loc + c_b.index_select(0, idx)
    b_loc = b_loc.to(dtype)
    return b_loc.expand(n_rho, *b_loc.shape)


def _solve_batched(Wt_bank, bias, rhos, H, A, G, lo, hi, Y0, rho_ind0,
                   done0, Wt_bank_hi, rho_eff, w_pri, w_dua, *,
                   max_iter: int, check_infeasibility: bool, nx: int,
                   nc: int, alpha: float, _graphs=None,
                   **loop) -> BatchSolveResult:
    """Both regimes' solve, from a cold loop state: one program, on
    ``cuda`` one graph launch and one host read (walked window by window
    under a process group)."""
    graphs = window_graphs(_graphs, Y0.device)
    rhos_t = _rhos_in(graphs, rhos, Y0.dtype)
    two_phase = loop["refine"] and loop["iter_precision"] != "highest"
    st, cold = _cold_state(graphs, Y0, rho_ind0, rhos_t, done0, max_iter,
                           check_infeasibility, nx, nc, alpha, rho_eff,
                           two_phase)
    ops = _staged(graphs, _Ops(rhos_t, H, A, G, lo, hi, w_pri, w_dua,
                               rho_eff, bias))
    kw = dict(loop, max_iter=max_iter,
              check_infeasibility=check_infeasibility, nx=nx, nc=nc,
              alpha=alpha)
    # a solver's program is made once: the pieces close over static
    # buffers and the solver's operands only
    prog, out = graphs.made(
        ("batch", Wt_bank, Wt_bank_hi, tuple(ops), st, cold[0],
         frozenset(kw.items())),
        lambda: batch_program(graphs, ops, st, Wt_bank, Wt_bank_hi,
                              cold=cold, **kw))
    if loop.get("group") is not None:
        # walked window by window; the result bundle is read with the
        # results' one gather (``BatchedReLU_QP._fill_results``)
        graphs.program(prog, Y0.device, per_window=True)
        return _wrap_result(st, None, out.clone())
    prog = graphs.program(prog, Y0.device)
    return _wrap_result(st, graphs.read(out, programs=(prog,)))


def _window(st: _Dev, op: _Ops, cfg: _Cfg, n_steps: int, W_op,
            precision: str, phase: str) -> None:
    """One batched check window on the device: ``n_steps`` iterations of
    every row, then the check (``ops.check_window``): the residuals, the ρ
    walk (at every ``rho_stride``-th check, decided from the device's
    iteration count), first-convergence iterations and status, the
    certificates, the open count (all-reduced over the process group when
    there is one) and the loop's exit flags and, in phase A, the progress
    test, written into the static state ``st``: kernel C2 on ``cuda``, the
    plain check on the CPU, under a process group (whose all-reduces sit
    inside the check) and in the plain-check A/B (``cfg.kernel_check``
    off)."""
    Y = cfg.chunk_runner(W_op, _bias_of(op, st.rho_ind, st.Y.dtype),
                         st.rho_ind, op.lo, op.hi, st.Y, n_steps, precision)
    if cfg.kernel_check and cfg.group is None:
        batched_check(st, op, cfg, Y, n_steps, phase)
    else:
        assign(st, batched_check_ref(st, op, cfg, Y, n_steps, phase))


def _staged(graphs, ops: _Ops, dev: Optional[_Dev] = None):
    """The solve's vectors (and the rows of ``dev``, a compacted state) in
    ``graphs``' static buffers (a bias bank or row map staged already is
    kept; the scalars stay where they are)."""
    st = lambda name, t: graphs.stage("batch." + name, t)
    kind = ops.bias[0]
    if kind == "bank":
        bias = ("bank", st("bias", ops.bias[1]))
    elif kind == "rows":
        bias = ("rows", ops.bias[1], st("sel", ops.bias[2]))
    else:
        bias = ops.bias[:4] + (st("bias_x", ops.bias[4]),)
    ops = ops._replace(G=st("G", ops.G),
                       lo=st("lo", ops.lo), hi=st("hi", ops.hi),
                       w_pri=st("w_pri", ops.w_pri),
                       w_dua=st("w_dua", ops.w_dua), bias=bias)
    if dev is None:
        return ops
    return ops, _Dev(*(t if t is None or t.dim() == 0 or f in ("ctl", "tick")
                       else st(f, t) for f, t in zip(_Dev._fields, dev)))


def batch_program(graphs, ops: _Ops, st: _Dev, Wt_bank, Wt_bank_hi, *,
                  shared: bool, chunk_runner, nx: int, nc: int,
                  max_iter: int, check_interval: int, adaptive_rho: bool,
                  adaptive_rho_tolerance: float, eps_abs: float,
                  rho_min: float, rho_max: float, rho_jump: bool,
                  check_infeasibility: bool, eps_prim_inf: float,
                  eps_dual_inf: float, iter_precision: str, refine: bool,
                  adaptive_rho_interval: int, alpha: float, cold=None,
                  stop_open: int = 0, with_rem: bool = True, group=None,
                  stats: bool = True, with_result: bool = True, pre=None,
                  post=None):
    """A batched solve (or one repack stage) as a program (``core.graphs``)
    over the static state ``st`` and vectors ``ops``: the start piece (the
    ``cold`` state and the exit flags; a carried state, ``cold`` None, has
    none: its flags are the host's, handed to the walk), the window loop
    (or the two refine phases), the ``max_iter % check_interval`` tail
    window under an IF (``with_rem``) and the result piece. The loop runs until at most
    ``stop_open`` problems are open or the ``max_iter`` budget (counted
    in the carried iterations) is spent. ``shared`` walks one index by the
    geometric mean, else every problem walks its own. With a process
    ``group`` the open count, the stall metric's sums and the shared walk's
    statistics are sums over its ranks. ``pre`` / ``post``: ``(key, fn)``
    pieces of a caller fused into the start and the result piece (a
    control step's refresh and plant step). Returns
    ``(program, out)``: a ``core.graphs.Program`` over ``st.ctl``, and
    ``out`` the static float64 result bundle ``[k, k_fast, n_open]`` and,
    with ``stats``, the (6, B) per-problem iterations, status, residuals,
    ρ estimates and rungs (``_wrap_result``), written by the result piece
    (left out without ``with_result`` and ``post``)."""
    dtype, dev = st.Y.dtype, st.Y.device
    sc = _host_scalar_type(dtype)
    eps = torch.tensor(eps_abs, dtype=dtype)
    eps_pri = float(eps * torch.sqrt(torch.tensor(float(nc), dtype=dtype)))
    eps_dua = float(eps * torch.sqrt(torch.tensor(float(nx), dtype=dtype)))
    tol = float(torch.tensor(adaptive_rho_tolerance, dtype=dtype))
    n_chunks = max_iter // check_interval
    rem = (max_iter - n_chunks * check_interval) if with_rem else 0
    two_phase = refine and iter_precision != "highest"
    cfg = _Cfg(shared, chunk_runner, nx, nc, alpha, adaptive_rho, rho_jump,
               tol, eps_pri, eps_dua, float(rho_min), float(rho_max),
               check_infeasibility, float(eps_prim_inf),
               float(eps_dual_inf), two_phase, group, check_interval,
               n_chunks * check_interval,
               rho_update_stride(adaptive_rho_interval, check_interval),
               (n_chunks // 2) * check_interval, float(sc(0.03)),
               int(stop_open), graphs.check_kernels)
    B = st.Y.shape[0]
    out = graphs.buffer("batch.out", (3 + 6 * B * stats,), torch.float64,
                        dev)
    key = lambda p: None if p is None else p[0]
    base = (sig(ops), sig(st), cfg, sig(out), sig(key(cold)), key(pre),
            key(post))

    def begin():
        if pre is not None:
            pre[1]()
        cold[1]()
        running = (st.n_open > cfg.stop_open) & (st.k < cfg.budget)
        st.open.copy_(running)
        st.tail.copy_(st.n_open > 0)
        if two_phase:
            st.open_a.copy_(running & (st.k < cfg.cap_a))
            st.best_m.fill_(float("inf"))
            st.best_open.fill_(int(np.iinfo(np.int32).max))
            st.n_stall.zero_()
            st.k_fast.zero_()

    def finish():
        if with_result:
            f64 = torch.float64
            k_fast = (torch.zeros((), dtype=f64, device=dev)
                      if st.k_fast is None else st.k_fast.to(f64))
            parts = [torch.stack([st.k.to(f64), k_fast,
                                  st.n_open.to(f64)])]
            if stats:
                rungs = torch.broadcast_to(st.rho_ind, st.iters.shape)
                parts.append(torch.stack([st.iters, st.status, st.pri,
                                          st.dua, st.rho, rungs]
                                         ).to(f64).reshape(-1))
            out.copy_(torch.cat(parts))
        if post is not None:
            post[1]()

    def window(W_op, precision, phase, n_steps=check_interval):
        return Piece(("window", n_steps, precision, phase, sig(W_op), base),
                     lambda: _window(st, ops, cfg, n_steps, W_op, precision,
                                     phase))

    loops, tail_W, tail_prec = refine_items(
        window, st.open, st.open_a, Wt_bank, Wt_bank_hi, refine=refine,
        iter_precision=iter_precision)
    items = list(loops)
    if cold is not None:
        # what the start piece leaves in the flags, known to the host
        running = int(B > cfg.stop_open and cfg.budget > 0)
        sets = ((st.k, 0), (st.n_open, B), (st.open, running),
                (st.tail, int(B > 0)))
        if two_phase:
            sets += ((st.open_a, int(running and cfg.cap_a > 0)),
                     (st.best_open, int(np.iinfo(np.int32).max)),
                     (st.n_stall, 0), (st.k_fast, 0))
        items.insert(0, Piece(("start", base), begin, sets=sets))
    elif two_phase or pre is not None:
        raise ValueError("a carried state (cold=None) is single-phase and "
                         "has no pre piece")
    if rem > 0:
        items.append(Cond(st.tail, (window(tail_W, tail_prec, "tail",
                                           rem),)))
    if with_result or post is not None:
        items.append(Piece(("finish", stats, with_result, base), finish))
    return Program(items, st.ctl), out


def _wrap_result(st: _Dev, host, out=None) -> BatchSolveResult:
    """The result from the static state ``st`` (cloned: its buffers belong
    to the next solve) and the read result bundle ``host``
    (``batch_program``'s), or, unread, its device copy ``out``."""
    d = st._replace(**{f: getattr(st, f).clone() for f in (
        "Y", "iters", "pri", "dua", "rho", "rho_ind", "status")})
    B = d.Y.shape[0]
    stats = (np.asarray(host[3:], np.float64).reshape(6, B)
             if host is not None and len(host) > 3 else None)
    n_total, n_fast = (None, None) if host is None else (int(host[0]),
                                                          int(host[1]))
    return BatchSolveResult(Y=d.Y, iters=d.iters, pri_res=d.pri,
                            dua_res=d.dua, rho_estimate=d.rho,
                            rho_ind=d.rho_ind,
                            converged=d.status == STATUS_SOLVED,
                            n_iter_total=n_total, status=d.status,
                            n_iter_fast=n_fast, stats=stats, out=out)
