"""The solve loop: check windows, residuals, the ρ walk and the exit.

A solve is one device program (``core.graphs``): a start piece, the check
windows under a loop whose exit the device decides, the tail window under
an IF and the result bundle. Everything stays on the device: the chunk
runner (kernel K1 on CUDA) and the window's check (kernel C1 on CUDA, its
plain version on the CPU: ``ops.check_window``): the residual reduction,
the ρ-index walk over the device-resident bank (every
``rho_update_stride``-th check, decided from the device's iteration
count), the status decision, the infeasibility certificates when asked,
the two-phase refine's stall test and the loop's exit flag. The rung
index lives in a device int32 tensor that the kernels read themselves.

On ``cuda`` the program is one launch of a CUDA graph whose conditional
WHILE nodes run the windows (the counterpart of the JAX package's
``lax.while_loop``), and the host reads the solve's result bundle once
after it. The solve's vectors and start state are staged into the cache's
static buffers at entry. ``verbose`` walks the windows from the host,
printing each, as does the A/B path (``WindowGraphs.device_exit =
False``); the CPU runs the same pieces eagerly.

The chunk runner is pluggable: ``chunk_runner(W_bank, b_bank, rho_ind, lo,
hi, y, n_steps, iter_precision)``. State vectors may be padded beyond
D = nx+2nc; all slicing here uses static [0, nx+2nc) bounds so padding is
inert.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.check_window import (_RUNNING, STATUS_DUAL_INFEASIBLE,
                                STATUS_MAX_ITER, STATUS_PRIMAL_INFEASIBLE,
                                STATUS_SOLVED, STATUS_STRINGS, assign,
                                check_window, check_window_ref,
                                compute_residuals, compute_residuals_op,
                                infeasibility_certificates, lam_of,
                                rho_ladder_step)
from ..ops.fused_step import fused_chunk_ref, pad_dim
from .bank import Bank, DeviceQP
from .graphs import Cond, Loop, Piece, Program, sig, window_graphs

__all__ = [
    "SolveResult",
    "xla_chunk_runner",
    "compute_residuals",
    "compute_residuals_op",
    "compute_objective",
    "infeasibility_certificates",
    "rho_ladder_step",
    "rho_update_stride",
    "refine_items",
    "solve_program",
    "state_buffers",
    "solve_loop",
    "ChunkRunner",
    "STATUS_MAX_ITER", "STATUS_SOLVED", "STATUS_PRIMAL_INFEASIBLE",
    "STATUS_DUAL_INFEASIBLE", "STATUS_STRINGS",
]

ChunkRunner = Callable[..., torch.Tensor]


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
    k_fast: int = 0       # iterations run in the reduced-precision phase


def xla_chunk_runner(W_bank, b_bank, rho_ind, lo, hi, y, n_steps: int,
                     iter_precision: str = "highest"):
    """``n_steps`` iterations ``y ← clip(y Wᵀ + b, lo, hi)`` in plain torch
    (``backend="xla"``), on any device and any (unpadded) D."""
    b = b_bank.index_select(0, rho_ind.reshape(1))[0]
    return fused_chunk_ref(W_bank, b, lo, hi, y, rho_ind, n_steps,
                           iter_precision)


def compute_objective(H, g, x):
    """½ xᵀHx + gᵀx."""
    return 0.5 * torch.dot(x, H @ x) + torch.dot(g, x)


def rho_update_stride(adaptive_rho_interval: int, check_interval: int) -> int:
    """Checks between ρ-ladder updates for an iteration-count interval.

    Updates happen only at residual checks, so the interval is rounded up
    to the check cadence; 0 and anything ≤ ``check_interval`` mean every
    check.
    """
    if adaptive_rho_interval <= check_interval:
        return 1
    return -(-adaptive_rho_interval // check_interval)  # ceil div


def refine_items(window, open_flag, open_a, W_fast, W_high, *, refine,
                 iter_precision: str, hoist_first: bool = False):
    """The window loops of a solve program, in two phases when a reduced
    iteration precision is refined. Shared by ``solve_loop`` and the
    batched loops so the phase policy cannot silently diverge (the JAX
    package's ``run_refined_phases``).

    Phase A runs reduced-precision windows while the solve still
    progresses; phase B polishes with "highest" windows to the true
    tolerance. ``window(W, precision, phase)`` makes the window piece of a
    phase ("" single-phase, "A", "B"). Every window writes ``open_flag``
    (the solve still runs); a phase-A window also writes ``open_a`` (it
    runs and still progresses: fewer than two consecutive stalled windows,
    and within the ``cap_a`` iterations that leave the polish phase half
    the budget), from its progress test on the device. ``hoist_first``
    runs the first single-phase window before the loop (callers guarantee
    one full window fits the budget): a warm solve that certifies at its
    first check never enters the loop. Returns ``(items, tail_W,
    tail_prec)``: the loops and the bank and precision of any ``max_iter %
    check_interval`` tail.
    """
    two_phase = refine and iter_precision != "highest"
    W_polish = W_fast if W_high is None else W_high
    if two_phase and W_polish.dtype == torch.bfloat16:
        raise ValueError(
            "refine=True with a bfloat16-stored W bank needs a full-"
            "precision polish copy (W_hi): the highest-precision refine "
            "phase would silently run at bf16 precision and tight "
            "tolerances would never be reached")
    if not two_phase:
        win = window(W_fast, iter_precision, "")
        items = ([win] if hoist_first else []) + [Loop(open_flag, (win,))]
        return items, W_fast, iter_precision
    return ([Loop(open_a, (window(W_fast, iter_precision, "A"),)),
             Loop(open_flag, (window(W_polish, "highest", "B"),))],
            W_polish, "highest")


class _Dev(NamedTuple):
    """The device state of a solve: static buffers its pieces read and
    write (a cache's, or this call's own when eager). The int32 scalars
    are elements of ``ctl``, which a host walk reads in one copy."""
    y: torch.Tensor                           # (Dp,) stacked state
    rho_ind: torch.Tensor                     # 0-d int32 ladder index
    rho: torch.Tensor                         # 0-d: last ρ estimate
    k: torch.Tensor                           # 0-d int32 iterations run
    status: torch.Tensor                      # 0-d int32, -1 running
    pri: torch.Tensor                         # 0-d residuals at the last
    dua: torch.Tensor                         # check
    open: torch.Tensor                        # 0-d int32: the solve runs
    tail: torch.Tensor                        # 0-d int32: the tail runs
    ctl: torch.Tensor                         # (n,) int32: the scalars
    x_prev: Optional[torch.Tensor] = None     # infeasibility deltas
    lam_prev: Optional[torch.Tensor] = None
    open_a: Optional[torch.Tensor] = None     # two-phase refine: phase A
    best_p: Optional[torch.Tensor] = None     # runs; its best residuals,
    best_d: Optional[torch.Tensor] = None     # stalled windows in a row
    n_stall: Optional[torch.Tensor] = None    # and iterations run
    k_fast: Optional[torch.Tensor] = None


class _Ops(NamedTuple):
    """What a window reads besides its state and W: the solver's operands
    and the solve's vectors (``g``, ``lo``, ``hi``, ``g_row`` and the
    lazy bias's state, static buffers)."""
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
    """The host values a solve's pieces bake into their launches."""
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
    check_interval: int
    budget: int          # iterations of the full windows: n_chunks * ci
    rho_stride: int      # checks between ρ updates
    cap_a: int           # phase A's iteration cap
    stall: float         # phase A's progress factor 0.97, iterate dtype
    two_phase: bool
    kernel_check: bool = True   # C1 on cuda; off: the plain check (A/B)


def _host_scalar_type(dtype):
    return np.float64 if dtype == torch.float64 else np.float32


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


def _start(st: _Dev, op: _Ops, cfg: _Cfg) -> None:
    """The loop state before the first window: nothing run, the loop
    (and phase A) open when a full window fits the budget, and the
    certificates' previous iterate the start state."""
    st.k.zero_()
    st.status.fill_(_RUNNING)
    st.pri.zero_()
    st.dua.zero_()
    st.open.fill_(int(cfg.budget > 0))
    st.tail.fill_(1)
    if op.g_row is not None:
        gv = op.g if op.w_dua is None else op.w_dua * op.g
        op.g_row.zero_()
        op.g_row[:cfg.nx] = gv.to(op.g_row.dtype)
    if cfg.check_infeasibility:
        st.x_prev.copy_(st.y[:cfg.nx])
        st.lam_prev.copy_(lam_of(st.y, st.rho_ind, op, cfg))
    if cfg.two_phase:
        st.open_a.fill_(int(cfg.budget > 0 and cfg.cap_a > 0))
        st.best_p.fill_(float("inf"))
        st.best_d.fill_(float("inf"))
        st.n_stall.zero_()
        st.k_fast.zero_()


def _checked(st: _Dev, op: _Ops, cfg: _Cfg, y, n_steps: int,
             phase: str) -> None:
    """The window's check of the runner's output ``y``, written into the
    static buffers: kernel C1 on ``cuda`` (``ops.check_window``), its plain
    version on the CPU and in the plain-check A/B (``cfg.kernel_check``
    off)."""
    if cfg.kernel_check:
        check_window(st, op, cfg, y, n_steps, phase)
    else:
        assign(st, check_window_ref(st, op, cfg, y, n_steps, phase))


def _window(st: _Dev, op: _Ops, cfg: _Cfg, n_steps: int, W_op,
            precision: str, phase: str) -> None:
    """One check window on the device: ``n_steps`` iterations, the
    residuals, the ρ walk (at every ``rho_stride``-th check, decided from
    the device's iteration count), the status, the certificates, the
    loop's exit flags and, in phase A, the progress test, written into the
    static state ``st``."""
    y = cfg.chunk_runner(W_op, _bias_of(st.rho_ind, op, st.y.dtype),
                         st.rho_ind, op.lo, op.hi, st.y, n_steps, precision)
    _checked(st, op, cfg, y, n_steps, phase)


def _tail(st: _Dev, op: _Ops, cfg: _Cfg, rem: int, W_op,
          precision: str) -> None:
    """The ``max_iter % check_interval`` tail iterations and one final
    residual evaluation (no ρ walk, no certificates)."""
    y = cfg.chunk_runner(W_op, _bias_of(st.rho_ind, op, st.y.dtype),
                         st.rho_ind, op.lo, op.hi, st.y, rem, precision)
    _checked(st, op, cfg, y, rem, "tail")


def _result(st: _Dev, op: _Ops, cfg: _Cfg, out: torch.Tensor,
            with_obj: bool) -> None:
    """The solve's result bundle, for its one host read: the raw status,
    iterations, phase-A iterations, residuals, rung, ρ estimate and the
    objective ½xᵀHx + gᵀx (0 when not asked for)."""
    f64 = torch.float64
    zero = torch.zeros((), dtype=f64, device=out.device)
    obj = (compute_objective(op.H, op.g, st.y[:cfg.nx]).to(f64) if with_obj
           else zero)
    k_fast = zero if st.k_fast is None else st.k_fast.to(f64)
    out.copy_(torch.stack([st.status.to(f64), st.k.to(f64), k_fast,
                           st.pri.to(f64), st.dua.to(f64),
                           st.rho_ind.to(f64), st.rho.to(f64), obj]))


RESULT_SIZE = 8


def state_buffers(graphs, prefix: str, y_like, nx: int, nc: int, *,
                  check_infeasibility: bool, two_phase: bool) -> _Dev:
    """A solve's static device state in ``graphs`` (names ``prefix`` +
    field): y like ``y_like``, the residuals and ρ in its dtype, the int32
    scalars (flags and counts) the elements of one vector ``ctl``."""
    dtype, dev = y_like.dtype, y_like.device
    buf = lambda name, shape=(), dt=dtype: graphs.buffer(prefix + name,
                                                         shape, dt, dev)
    ints = ["k", "status", "open", "tail"] + (
        ["open_a", "n_stall", "k_fast"] if two_phase else [])
    ctl = buf("ctl", (len(ints),), torch.int32)
    c = {name: ctl[i] for i, name in enumerate(ints)}
    st = _Dev(buf("y", y_like.shape), buf("rho_ind", (), torch.int32),
              buf("rho"), c["k"], c["status"], buf("pri"), buf("dua"),
              c["open"], c["tail"], ctl)
    if check_infeasibility:
        st = st._replace(x_prev=buf("x_prev", (nx,)),
                         lam_prev=buf("lam_prev", (nc,)))
    if two_phase:
        st = st._replace(open_a=c["open_a"], best_p=buf("best_p"),
                         best_d=buf("best_d"), n_stall=c["n_stall"],
                         k_fast=c["k_fast"])
    return st


def solve_program(graphs, bank: Bank, qp: DeviceQP, st: _Dev, W_hi=None,
                  rho_eff=None, bias_lazy=None, M_res=None, *, nx: int,
                  nc: int, max_iter: int, check_interval: int,
                  adaptive_rho: bool, adaptive_rho_tolerance: float,
                  eps_abs: float, rho_min: float, rho_max: float,
                  chunk_runner: ChunkRunner = xla_chunk_runner,
                  verbose: bool = False, check_infeasibility: bool = False,
                  eps_prim_inf: float = 1e-4, eps_dual_inf: float = 1e-4,
                  rho_jump: bool = False, iter_precision: str = "highest",
                  refine: bool = True, adaptive_rho_interval: int = 1,
                  alpha: float = 1.0, with_obj: bool = True,
                  with_result: bool = True, pre=None, post=None,
                  prefix: str = "qp."):
    """A solve as a program (``core.graphs``) over the static state
    ``st`` (``state_buffers``; ``st.y``, ``st.rho_ind`` and ``st.rho``
    hold the start state when the program starts) and the static vectors
    of ``qp`` and ``bias_lazy``: the start piece, the hoisted first window
    and the window loop (or the two refine phases), the tail under an IF
    and the result bundle (``with_result``). ``pre`` / ``post``: ``(key,
    fn)`` pieces of a caller fused into the start and the result piece (a
    control step's refresh and plant step). Returns ``(program, out)``: a
    ``core.graphs.Program`` over ``st.ctl``, and ``out`` the static float64
    (``RESULT_SIZE``,) result bundle (``_result``)."""
    dtype, dev = st.y.dtype, st.y.device
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
    two_phase = refine and iter_precision != "highest"
    cfg = _Cfg(chunk_runner, nx, nc, alpha, adaptive_rho, rho_jump, tol,
               eps_pri, eps_dua, float(rho_min), float(rho_max),
               check_infeasibility, float(eps_prim_inf), float(eps_dual_inf),
               check_interval, n_chunks * check_interval,
               rho_update_stride(adaptive_rho_interval, check_interval),
               (n_chunks // 2) * check_interval,
               float(_host_scalar_type(dtype)(0.97)), two_phase,
               graphs.check_kernels)

    g_row = None
    if M_res is not None:
        if alpha != 1.0:
            raise ValueError("M_res (stacked residual operator) requires "
                             "alpha=1 — the operator reads the λ slot "
                             "directly")
        nxp, ncp = pad_dim(nx), pad_dim(nc)
        if tuple(M_res.shape) != (st.y.shape[0], 2 * ncp + 2 * nxp):
            raise ValueError(f"M_res shape {tuple(M_res.shape)} does not "
                             f"match (Dp={st.y.shape[0]}, "
                             f"R={2 * ncp + 2 * nxp})")
        # written from the static g by the start piece
        g_row = graphs.buffer(prefix + "g_row", (nxp,), dtype, dev)
    bias = ("bank", bank.b) if bias_lazy is None else ("lazy", *bias_lazy)
    op = _Ops(bank.rhos, qp.H, qp.A, qp.g, qp.lo, qp.hi, qp.w_pri, qp.w_dua,
              rho_eff, M_res, g_row, bias)
    out = graphs.buffer(prefix + "out", (RESULT_SIZE,), torch.float64, dev)
    base = (sig(op), sig(st), cfg, sig(out),
            None if pre is None else pre[0], None if post is None else post[0])

    def start():
        if pre is not None:
            pre[1]()
        _start(st, op, cfg)

    def finish():
        if with_result:
            _result(st, op, cfg, out, with_obj)
        if post is not None:
            post[1]()

    def show(host):
        # read by the host walk with the window's control vector; (no
        # reference to the cache: a cycle would leave its graphs to the
        # cyclic collector, which may run during another capture)
        k, rho, pri, dua = (float(v) for v in host)
        print(f"Iter: {int(k)}, rho: {rho:.2e}, res_p: {pri:.2e}, res_d: "
              f"{dua:.2e}")

    def window(W_op, precision, phase):
        return Piece(("window", check_interval, precision, phase, sig(W_op),
                      base),
                     lambda: _window(st, op, cfg, check_interval, W_op,
                                     precision, phase),
                     ((st.k, st.rho, st.pri, st.dua), show) if verbose
                     else None)

    loops, tail_W, tail_prec = refine_items(
        window, st.open, st.open_a, bank.W, W_hi, refine=refine,
        iter_precision=iter_precision, hoist_first=n_chunks >= 1)
    # what the start piece leaves in the flags, known to the host
    sets = ((st.k, 0), (st.status, _RUNNING),
            (st.open, int(cfg.budget > 0)), (st.tail, 1))
    if two_phase:
        sets += ((st.open_a, int(cfg.budget > 0 and cfg.cap_a > 0)),
                 (st.n_stall, 0), (st.k_fast, 0))
    items = [Piece(("start", base), start, sets=sets)] + loops
    if rem > 0:
        items.append(Cond(st.tail, (Piece(
            ("tail", rem, tail_prec, sig(tail_W), base),
            lambda: _tail(st, op, cfg, rem, tail_W, tail_prec)),
        )))
    items.append(Piece(("finish", with_obj, with_result, base), finish))
    return Program(items, st.ctl), out


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
               _graphs=None, _per_window: bool = False) -> SolveResult:
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
    on the device from ``qp.g``/``qp.w_dua``.

    The solve is one program (``solve_program``): on ``cuda`` one launch of
    a CUDA graph whose WHILE nodes run the windows until the card's own
    exit flag stops them, then one host read of the result bundle.
    ``_graphs``: the ``core.graphs.WindowGraphs`` it runs through (a
    solver's own; a fresh one per call when None, which on ``cuda`` exits
    on the device and on the CPU runs eagerly); ``False`` runs every piece
    eagerly. ``verbose`` and ``_per_window`` (a chunk runner with
    collectives: tensor parallelism) walk the windows from the host, each
    one replay of its graph.
    """
    dtype, dev = y0.dtype, y0.device
    graphs = window_graphs(_graphs, dev)
    two_phase = refine and iter_precision != "highest"
    # the solve's vectors and start state into the static buffers the
    # pieces read; the solver's operands stay where they are
    stage = lambda name, t: graphs.stage("qp." + name, t)
    qp = qp._replace(g=stage("g", qp.g), lo=stage("lo", qp.lo),
                     hi=stage("hi", qp.hi))
    if bias_lazy is None:
        bank = bank._replace(b=stage("b", bank.b))
    else:
        bias_lazy = tuple(bias_lazy[:3]) + (stage("x", bias_lazy[3]),)
    st = graphs.made(
        ("qp.state", tuple(y0.shape), dtype, dev, nx, nc,
         check_infeasibility, two_phase),
        lambda: state_buffers(graphs, "qp.", y0, nx, nc,
                              check_infeasibility=check_infeasibility,
                              two_phase=two_phase))
    st.y.copy_(y0)
    # a host start index or ρ is written by a fill (no host→device copy)
    for buf, v in ((st.rho_ind, rho_ind0), (st.rho, rho0)):
        if isinstance(v, torch.Tensor):
            buf.copy_(v.reshape(()))
        else:
            buf.fill_(v)
    kw = dict(nx=nx, nc=nc, max_iter=max_iter, check_interval=check_interval,
              adaptive_rho=adaptive_rho,
              adaptive_rho_tolerance=adaptive_rho_tolerance,
              eps_abs=eps_abs, rho_min=rho_min, rho_max=rho_max,
              chunk_runner=chunk_runner, verbose=verbose,
              check_infeasibility=check_infeasibility,
              eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf,
              rho_jump=rho_jump, iter_precision=iter_precision,
              refine=refine, adaptive_rho_interval=adaptive_rho_interval,
              alpha=alpha, with_obj=with_obj)
    # a solver's program is made once: the pieces close over static
    # buffers and the solver's operands only
    prog, out = graphs.made(
        ("solve", tuple(bank), tuple(qp), st, W_hi, rho_eff, bias_lazy,
         M_res, frozenset(kw.items())),
        lambda: solve_program(graphs, bank, qp, st, W_hi, rho_eff,
                              bias_lazy, M_res, **kw))
    prog = graphs.program(prog, dev, per_window=verbose or _per_window)
    # the solve's one host read
    h = graphs.read(out, programs=(prog,)).tolist()
    raw, k, k_fast, pri, dua, rho_ind_h, rho_h, obj = h
    status = STATUS_MAX_ITER if raw < 0 else int(raw)
    iters = int(k) if status != STATUS_MAX_ITER else max_iter
    # the static buffers belong to the next solve
    return SolveResult(y=st.y.clone(), iters=iters, pri_res=pri, dua_res=dua,
                       rho_estimate=rho_h, rho_ind=int(rho_ind_h),
                       converged=status == STATUS_SOLVED, obj_val=obj,
                       status_code=status, k_fast=int(k_fast))
