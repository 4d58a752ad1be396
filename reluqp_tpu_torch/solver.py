"""OSQP-style stateful solver API: ``ReLU_QP`` on PyTorch.

``setup / solve / update(g,l,u) / update_matrices / update_settings /
warm_start / clear_primal_dual`` returning ``Results(x, z, lam, Info)``.

- ``setup`` builds the ρ ladder and the fp64 weight bank once on the host,
  then puts it on the device in the iteration dtype, transposed and
  lane-padded so the hot loop is a row-vector product;
- ``solve`` runs ``core.iteration.solve_loop``: on ``cuda`` through the
  chunk kernel K1 (``backend="auto"``/``"pallas"``), on ``cpu`` through its
  plain torch version; ``backend="xla"`` runs the plain torch runner on
  either device; ``backend="fused"`` runs the whole solve as one launch of
  the whole-solve kernel K3 (``ops.solve_kernel.full_solve``; its plain
  version on cpu), with one read of its stats;
- ``setup(mesh=)`` (a 1-D ``DeviceMesh``, one process per device) splits
  the bank by output columns over the mesh's ranks: each keeps its
  (N, Dp, Dp/n) block and ``solve`` runs the loop with one all-gather of
  the iterate per iteration (``parallel.tensor``);
- timers are host clocks around work that ends in a device sync.

λ is not zeroed after a solve (it warm-starts the next one);
``warm_start`` re-packs the stacked state at once.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from . import native
from .classes import QP, SETTINGS_FIELDS, Info, Results, Settings
from .core.bank import (Bank, DeviceQP, auto_rho_cap, build_bank_np,
                        certifiable_eps_floor, clamp_bounds,
                        effective_rho_ladder, equality_mask, sigma_max_sq,
                        stacked_dim)
from .core.graphs import WindowGraphs
from .core.iteration import (STATUS_STRINGS, compute_objective, solve_loop,
                             xla_chunk_runner)
from .core.ladder import initial_rho_index, setup_rhos
from .ops.fused_step import pad_dim, pallas_chunk_runner
from .ops.solve_kernel import (FullSolveOperand, build_alpha_operand,
                               build_infeas_operand, build_residual_operator,
                               full_solve)
from .parallel.sharded import mesh_group
from .parallel.tensor import (tp_align, tp_chunk_runner, tp_columns,
                              tp_pad_dim)
from .utils.scaling import (identity_scaling, residual_unscale_weights,
                            ruiz_equilibrate)

__all__ = ["ReLU_QP", "prepare_bank"]


def prepare_bank(W_np, B_np, b_np, rhos_np, dtype, dp: int, device="cpu",
                 w_dtype=None, cols=slice(None)) -> Bank:
    """Host fp64 bank → device runtime layout.

    ``W`` holds Wᵀ per rung, padded to (dp, dp); ``B`` is row-padded to
    (dp, nx) so ``b = B @ g`` lands in padded layout; ``b`` is (dp,)-padded
    with zeros. Zero padding + ±inf clamp bounds keep padded lanes exactly
    0. ``w_dtype`` overrides the storage dtype of ``W`` only
    (``iter_precision="bf16"`` stores the bank in bfloat16). ``cols``
    keeps only those output columns of ``W`` (a tensor-parallel rank's
    block); only they go to the device.
    """
    n, d, _ = W_np.shape
    nx = B_np.shape[2]
    Wt = np.zeros((n, dp, dp), dtype=np.float64)
    Wt[:, :d, :d] = np.swapaxes(W_np, 1, 2)
    Wt = np.ascontiguousarray(Wt[:, :, cols])
    Bp = np.zeros((n, dp, nx), dtype=np.float64)
    Bp[:, :d, :] = B_np
    bp = np.zeros((n, dp), dtype=np.float64)
    bp[:, :d] = b_np
    put = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    return Bank(W=put(Wt, w_dtype or dtype), B=put(Bp, dtype),
                b=put(bp, dtype), rhos=put(np.asarray(rhos_np), dtype))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ReLU_QP:
    """ReLU-QP solver with the OSQP-style lifecycle API."""

    def __init__(self):
        self.info = Info()
        self.results = Results(info=self.info)
        self._ready = False
        self._mesh, self._tp_axis = None, "tp"
        self._tp_group, self._tp_rank, self._tp_size = None, 0, 1
        # the solves' device programs and window graphs (core.graphs);
        # False runs every piece eagerly
        self._window_graphs = WindowGraphs()

    # ------------------------------------------------------------------ #
    # setup                                                              #
    # ------------------------------------------------------------------ #
    def setup(self, H, g, A, l, u,
              verbose=False,
              warm_starting=True,
              scaling=False,
              scaled_termination=False,
              rho=0.1,
              rho_min=1e-6,
              rho_max=1e6,
              sigma=1e-6,
              adaptive_rho=True,
              adaptive_rho_interval=1,
              adaptive_rho_tolerance=5,
              max_iter=4000,
              eps_abs=1e-3,
              eq_tol=1e-6,
              check_interval=25,
              check_infeasibility=False,
              eps_prim_inf=1e-4,
              eps_dual_inf=1e-4,
              rho_jump=False,
              alpha=1.0,
              iter_precision="highest",
              refine=True,
              rho_cap="auto",
              device=None,
              precision="float32",
              backend="auto",
              bank_backend="auto",
              mesh=None,
              tp_axis="tp"):
        """Set up the solver for

            minimize     1/2 x' H x + g' x
            subject to   l <= A x <= u

        ``device`` defaults to ``cuda`` (raises without a GPU; pass
        ``device="cpu"`` for the CPU). The bank is factorized in fp64 on
        the host whatever ``precision`` is: ``bank_backend="native"`` by
        the C++ builder (``native.py``; ``alpha = 1`` only), ``"numpy"``
        by ``core.bank.build_bank_np``, ``"auto"`` the former where it
        builds and alpha = 1, else the latter;
        ``setup_breakdown["bank_backend"]`` says which ran.

        ``mesh``: a 1-D ``DeviceMesh`` (``parallel.make_mesh``) turns on
        the tensor-parallel solve: the bank is split by output columns over
        its ``tp_axis`` ranks (one process per device, every rank calling
        setup with the same arguments) and ``solve`` runs the loop with one
        all-gather of the iterate per iteration (``parallel.tensor``).
        Requires ``backend`` "auto" or "xla"; the plain runner's product
        runs on each rank's block.
        """
        t0 = time.perf_counter()
        if mesh is not None and backend in ("pallas", "fused"):
            raise ValueError(
                "tensor-parallel solve (mesh=...) supports "
                "backend='auto'/'xla' only")
        if bank_backend not in ("auto", "numpy", "native"):
            raise ValueError(f"Invalid bank_backend {bank_backend!r}")
        if bank_backend == "native" and alpha != 1.0:
            raise ValueError(
                "bank_backend='native' does not support alpha != 1")
        self.settings = Settings(
            verbose=verbose, warm_starting=warm_starting, scaling=scaling,
            scaled_termination=scaled_termination,
            rho=rho, rho_min=rho_min, rho_max=rho_max, sigma=sigma,
            adaptive_rho=adaptive_rho,
            adaptive_rho_interval=adaptive_rho_interval,
            adaptive_rho_tolerance=adaptive_rho_tolerance,
            max_iter=max_iter, eps_abs=eps_abs, eq_tol=eq_tol,
            check_interval=check_interval,
            check_infeasibility=check_infeasibility,
            eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf,
            rho_jump=rho_jump, alpha=alpha, iter_precision=iter_precision,
            refine=refine, rho_cap=rho_cap, device=device,
            precision=precision, backend=backend)
        stng = self.settings
        if self._window_graphs:
            self._window_graphs.clear()   # new operands
        self._mesh, self._tp_axis = mesh, tp_axis
        self._tp_group, self._tp_rank, self._tp_size = None, 0, 1
        if mesh is not None:
            (self._tp_group, self._tp_rank, self._tp_size,
             mdev) = mesh_group(mesh, tp_axis)
            if stng.device.type != mdev.type:
                raise ValueError(f"device {stng.device} is not the mesh's "
                                 f"device type {mdev.type!r}")
            if stng.device.index is None:
                stng.device = mdev
        self._set_problem(H, g, A, l, u)

        # fp64 host bank build on the scaled problem. "auto" takes the
        # OpenMP C++ builder where it builds (rungs factorize in parallel)
        # and numpy otherwise; the C++ builder makes the alpha = 1 blocks
        # only, so relaxed banks build with numpy.
        use_native = (bank_backend == "native"
                      or (bank_backend == "auto" and stng.alpha == 1.0
                          and native.available()))
        t_pre = time.perf_counter()
        if use_native:
            W_np, B_np, b_np = native.build_bank(
                self._H_s, self._A_s, self._g_s, self.eq_mask, self.rhos_np,
                stng.sigma, rho_cap=self.rho_cap)
        else:
            W_np, B_np, b_np = build_bank_np(
                self._H_s, self._g_s, self._A_s, self.eq_mask, self.rhos_np,
                stng.sigma, alpha=float(stng.alpha), rho_cap=self.rho_cap)
        t_bank = time.perf_counter()
        self._set_bank(W_np, B_np, b_np)
        t_layout = time.perf_counter()
        self._set_operands()
        self.y = torch.zeros((self.Dp,), dtype=stng.precision_dtype,
                             device=stng.device)
        _sync(stng.device)
        t_end = time.perf_counter()
        self.info.setup_time = t_end - t0
        self.setup_breakdown = {
            "host_prep_s": t_pre - t0,
            "bank_build_s": t_bank - t_pre,
            "bank_layout_transfer_s": t_layout - t_bank,
            "device_data_operands_s": t_end - t_layout,
            "bank_backend": "native" if use_native else "numpy",
        }
        self.info.update_time = 0.0
        self._ready = True

    def _set_problem(self, H, g, A, l, u, scal=None, rho_cap=None):
        """The problem's host state: fp64 masters, equality mask, Ruiz
        scaling (``scal``, else computed per the settings), the scaled
        copies, the ρ ladder and cap (``rho_cap``, else resolved per the
        settings), and the backend's layout (``Dp``)."""
        stng = self.settings
        dtype = stng.precision_dtype
        self.QP = QP(H, g, A, l, u, precision=dtype, device=stng.device)
        nx, nc = self.QP.nx, self.QP.nc
        self.nx, self.nc = nx, nc
        self.D = stacked_dim(nx, nc)

        # Equality detection on the UNSCALED problem, then optional Ruiz
        # equilibration; everything after this works on the scaled copies.
        self.eq_mask = equality_mask(self.QP.l_np, self.QP.u_np, stng.eq_tol)
        if scal is not None:
            self.scal = scal
        elif stng.scaling:
            self.scal = ruiz_equilibrate(self.QP.H_np, self.QP.A_np,
                                         self.QP.g_np)
        else:
            self.scal = identity_scaling(nx, nc)
        sc = self.scal
        self._H_s = sc.c * (self.QP.H_np * sc.D[:, None] * sc.D[None, :])
        self._A_s = self.QP.A_np * sc.E[:, None] * sc.D[None, :]
        self._g_s = sc.c * sc.D * self.QP.g_np
        self._l_s = sc.E * self.QP.l_np
        self._u_s = sc.E * self.QP.u_np

        self.rhos_np = setup_rhos(stng.rho, stng.rho_min, stng.rho_max,
                                  stng.adaptive_rho,
                                  stng.adaptive_rho_tolerance)
        self.rho_ind = initial_rho_index(self.rhos_np, stng.rho)
        if rho_cap is None:
            rho_cap = (auto_rho_cap(self._A_s, stng.eps_abs, dtype, nx)
                       if stng.rho_cap == "auto" else float(stng.rho_cap))
        self.rho_cap = float(rho_cap)
        self._sigma_max_sq = None   # lazy: eps-floor guard in update_settings
        self._rho_eff_np = effective_rho_ladder(self.rhos_np, self.eq_mask,
                                                self.rho_cap)

        # Backend: K1 ("auto"/"pallas"; the CUDA kernel on cuda, its plain
        # version on cpu) on the lane-padded layout, or the plain torch
        # runner ("xla") on the unpadded one. On cuda "auto" always takes
        # K1: unlike the TPU's VMEM, nothing gates it by size. "fused" (the
        # whole-solve kernel K3, one launch per solve) is taken by name
        # only, as in the JAX package. A mesh overrides the tiers: the
        # tensor-parallel runner, each block's width aligned (tp_align).
        self._fused = stng.backend == "fused"
        if self._tp_group is not None:
            self._chunk_runner = tp_chunk_runner(self._tp_group)
            self.Dp = tp_pad_dim(self.D, self._tp_size,
                                 tp_align(stng.device))
        elif stng.backend == "xla":
            self._chunk_runner = xla_chunk_runner
            self.Dp = self.D
        else:
            self._chunk_runner = pallas_chunk_runner
            self.Dp = pad_dim(self.D)

    def _set_bank(self, W_np, B_np, b_np):
        """Put a bank (``W_np`` (N, D, D) not transposed, ``B_np``
        (N, D, nx), the biases ``b_np`` (N, D)) on the device in the runtime
        layout, and keep the fp64 B master."""
        stng = self.settings
        dtype, dev = stng.precision_dtype, stng.device
        w_dtype = torch.bfloat16 if stng.iter_precision == "bf16" else None
        # a tensor-parallel rank keeps its column block of W only
        cols = (slice(None) if self._tp_group is None
                else tp_columns(self.Dp, self._tp_rank, self._tp_size))
        self.bank = prepare_bank(W_np, B_np, b_np, self.rhos_np, dtype,
                                 self.Dp, dev, w_dtype=w_dtype, cols=cols)
        # fp64 B master in padded layout: update(g) recomputes the bias
        # bank on the HOST in fp64 (a device GEMV in the iteration dtype
        # carries enough error to shift the ADMM fixed point).
        self._B_np = np.zeros((len(self.rhos_np), self.Dp, self.nx))
        self._B_np[:, :W_np.shape[1], :] = B_np
        # The refine phase under a bf16-stored bank needs an fp32 copy.
        self._W_hi = None
        if stng.iter_precision == "bf16" and stng.refine:
            self._W_hi = prepare_bank(W_np, B_np, b_np, self.rhos_np, dtype,
                                      self.Dp, dev, cols=cols).W

    def _set_operands(self):
        """The device data of the iteration and its checks: bounds, problem
        matrices, unscale vectors, ρ⃗ and K3's operands."""
        stng = self.settings
        dtype, dev = stng.precision_dtype, stng.device
        nx, nc = self.nx, self.nc
        lo, hi = self._padded_bounds(self._l_s, self._u_s)
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
        w_pri_np, w_dua_np = residual_unscale_weights(self.scal, stng)
        self._w_pri_np, self._w_dua_np = w_pri_np, w_dua_np
        self.qp_dev = DeviceQP(
            H=put(self._H_s), g=put(self._g_s), A=put(self._A_s),
            lo=put(lo), hi=put(hi),
            w_pri=None if w_pri_np is None else put(w_pri_np),
            w_dua=None if w_dua_np is None else put(w_dua_np))
        self._unscale_x = put(self.scal.D)
        self._unscale_z = put(self.scal.Einv)
        self._unscale_lam = put(self.scal.E * self.scal.cinv)
        # Per-rung effective per-row ρ: reconstructs λ = ρ⃗(p − z) under
        # the relaxed (alpha != 1) parametrization.
        self._rho_eff = None
        if stng.alpha != 1.0:
            self._rho_eff = put(self._rho_eff_np)

        # Stacked residual operator: K3's residual check, and on the GPU
        # (alpha=1) the loop's one y @ M_res per check instead of three
        # small latency-bound matvecs. The CPU loop keeps the matvecs.
        self._M_res = self._g_row = None
        self._res_op_loop = (not self._fused and stng.alpha == 1.0
                             and dev.type == "cuda")
        if self._fused or self._res_op_loop:
            self._M_res, self._g_row, self._nxp, self._ncp = \
                build_residual_operator(
                    self._H_s, self._A_s, self._g_s, self.Dp, dtype,
                    w_pri=w_pri_np, w_dua=w_dua_np,
                    lam_segment=stng.alpha == 1.0, device=dev)
        self._alpha_op = self._infeas_op = None
        if self._fused and stng.alpha != 1.0:
            self._alpha_op = build_alpha_operand(
                self._A_s, self._rho_eff_np, nx, nc, self.Dp, self._nxp,
                self._ncp, dtype, w_dua=w_dua_np, device=dev)
        if self._fused and stng.check_infeasibility:
            self._infeas_op = self._build_infeas_op()

    def _padded_bounds(self, l_np, u_np):
        lo_d, hi_d = clamp_bounds(l_np, u_np, self.nx, self.nc)
        lo = np.full((self.Dp,), -np.inf)
        hi = np.full((self.Dp,), np.inf)
        lo[:self.D] = lo_d
        hi[:self.D] = hi_d
        return lo, hi

    def _put(self, a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=self.settings.precision_dtype,
                               device=self.settings.device)

    def _build_infeas_op(self):
        """K3's certificate operands; they carry copies of g, l and u."""
        stng = self.settings
        return build_infeas_operand(
            self._A_s, self._g_s, self._l_s, self._u_s, self.nx, self.nc,
            self.Dp, self._nxp, self._ncp, stng.precision_dtype,
            alpha=float(stng.alpha), w_pri=self._w_pri_np,
            w_dua=self._w_dua_np, device=stng.device)

    # ------------------------------------------------------------------ #
    # update / settings                                                  #
    # ------------------------------------------------------------------ #
    def update(self, g=None, l=None, u=None, Hx=None, Ax=None):
        """Update problem vectors; ``Hx``/``Ax`` go through
        ``update_matrices``. A g-update recomputes the whole bias bank on
        the host in fp64 from the B master."""
        if Hx is not None or Ax is not None:
            self.update_matrices(H=Hx, A=Ax)
        self._check_ready()
        t0 = time.perf_counter()
        dtype = self.settings.precision_dtype
        if g is not None:
            g_np = np.asarray(g, dtype=np.float64).reshape(-1)
            if g_np.shape != (self.nx,):
                raise ValueError(f"g must have shape ({self.nx},)")
            self.QP.g_np = g_np
            self._g_s = self.scal.c * self.scal.D * g_np
            self.bank = self.bank._replace(b=self._put(self._B_np @ self._g_s))
            self.qp_dev = self.qp_dev._replace(g=self._put(self._g_s))
            self.QP.g = self._put(g_np)
            if self._fused:
                # K3's dual residual reads the w_dua-weighted g row
                wd = np.ones(self.nx) if self._w_dua_np is None \
                    else self._w_dua_np
                g_row = np.zeros((1, self._nxp))
                g_row[0, :self.nx] = wd * self._g_s
                self._g_row = self._put(g_row)
        if l is not None or u is not None:
            if l is not None:
                l_np = np.asarray(l, dtype=np.float64).reshape(-1)
                if l_np.shape != (self.nc,):
                    raise ValueError(f"l must have shape ({self.nc},)")
                self.QP.l_np = l_np
                self._l_s = self.scal.E * l_np
                self.QP.l = self._put(l_np)
            if u is not None:
                u_np = np.asarray(u, dtype=np.float64).reshape(-1)
                if u_np.shape != (self.nc,):
                    raise ValueError(f"u must have shape ({self.nc},)")
                self.QP.u_np = u_np
                self._u_s = self.scal.E * u_np
                self.QP.u = self._put(u_np)
            lo, hi = self._padded_bounds(self._l_s, self._u_s)
            self.qp_dev = self.qp_dev._replace(lo=self._put(lo),
                                               hi=self._put(hi))
        if self._infeas_op is not None and (
                g is not None or l is not None or u is not None):
            self._infeas_op = self._build_infeas_op()
        _sync(self.settings.device)
        self.info.update_time = time.perf_counter() - t0

    def update_matrices(self, H=None, A=None):
        """Replace H and/or A: re-factorizes the bank (one setup-cost
        operation) while keeping the warm-start state and settings."""
        self._check_ready()
        if H is None and A is None:
            return
        # Carry the warm state across in UNSCALED units (the new setup may
        # compute a different equilibration).
        old = self.scal
        y_np = self.y.detach().cpu().double().numpy()
        x_u = y_np[:self.nx] * old.D
        z_s = y_np[self.nx:self.nx + self.nc]
        z_u = z_s * old.Einv
        last = y_np[self.nx + self.nc:self.nx + 2 * self.nc]
        if self.settings.alpha != 1.0:
            last = self._rho_eff_np[self.rho_ind] * (last - z_s)
        lam_u = last * old.E * old.cinv
        rho_ind_keep = self.rho_ind
        stng = self.settings
        self.setup(self.QP.H_np if H is None else H,
                   self.QP.g_np,
                   self.QP.A_np if A is None else A,
                   self.QP.l_np, self.QP.u_np, mesh=self._mesh,
                   tp_axis=self._tp_axis,
                   **{k: getattr(stng, k) for k in SETTINGS_FIELDS})
        # Restore the ladder position BEFORE re-injecting the warm state:
        # under alpha != 1 the p slot is encoded against the current rung.
        self.rho_ind = rho_ind_keep
        self.warm_start(x=x_u, z=z_u, lam=lam_u)

    def _warn_eps_floor(self, eps_new: float) -> None:
        """Warn when eps_abs is tightened past the frozen rho_cap's floor."""
        if not np.isfinite(self.rho_cap):
            return
        if self._sigma_max_sq is None:
            self._sigma_max_sq = sigma_max_sq(self._A_s)
        floor = certifiable_eps_floor(self.rho_cap, self._sigma_max_sq,
                                      self.settings.precision_dtype, self.nx)
        if eps_new < floor * (1.0 - 1e-9):
            warnings.warn(
                f"eps_abs={eps_new:g} is below {floor:g}, the certifiable "
                f"floor of the rho_cap={self.rho_cap:g} frozen at setup: "
                "the capped ladder's dual-residual noise floor may keep the "
                "solve at max_iter. Re-derive the cap with "
                "update_matrices(H, A), or set rho_cap/precision at setup.",
                RuntimeWarning, stacklevel=3)

    def update_settings(self, **kwargs):
        """Update runtime-mutable settings: ``max_iter``, ``eps_abs``,
        ``verbose``, ``check_interval``. The ρ/σ family raises (it would
        invalidate the bank). Tightening eps_abs below the frozen ρ cap's
        certifiable floor warns."""
        for key, value in kwargs.items():
            if key in ("max_iter", "eps_abs", "verbose", "check_interval"):
                if key == "eps_abs":
                    self._warn_eps_floor(float(value))
                setattr(self.settings, key, value)
            elif key in ("rho", "rho_min", "rho_max", "sigma", "adaptive_rho",
                         "adaptive_rho_interval", "adaptive_rho_tolerance",
                         "alpha", "rho_cap"):
                raise ValueError(f"Cannot change {key} after setup")
            else:
                raise ValueError(f"Invalid setting: {key}")

    # ------------------------------------------------------------------ #
    # solve                                                              #
    # ------------------------------------------------------------------ #
    def solve(self) -> Results:
        """Solve the QP from the current (warm) state."""
        self._check_ready()
        t0 = time.perf_counter()
        stng = self.settings
        if self._fused:
            return self._solve_fused(t0)
        res = solve_loop(
            self.bank, self.qp_dev, self.y, self.rho_ind,
            self.bank.rhos[self.rho_ind], self._W_hi, self._rho_eff, None,
            self._M_res if self._res_op_loop else None,
            nx=self.nx, nc=self.nc, max_iter=stng.max_iter,
            check_interval=stng.check_interval,
            adaptive_rho=stng.adaptive_rho,
            adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
            eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
            rho_max=float(stng.rho_max), chunk_runner=self._chunk_runner,
            verbose=bool(stng.verbose),
            check_infeasibility=bool(stng.check_infeasibility),
            eps_prim_inf=float(stng.eps_prim_inf),
            eps_dual_inf=float(stng.eps_dual_inf),
            rho_jump=bool(stng.rho_jump),
            iter_precision=stng.iter_precision, refine=bool(stng.refine),
            adaptive_rho_interval=int(stng.adaptive_rho_interval),
            alpha=float(stng.alpha), _graphs=self._window_graphs)
        run_time = time.perf_counter() - t0   # solve_loop ends in a sync
        return self._finish(res.y, res.rho_ind, res.iters, res.status_code,
                            res.obj_val, res.pri_res, res.dua_res,
                            res.rho_estimate, run_time)

    def _fused_call(self):
        """The arguments ``(op, kw)`` of this solver's K3 launch,
        ``full_solve(op, y0, rho_ind0, **kw)``: the setup's operands and
        the current settings."""
        stng = self.settings
        op = FullSolveOperand(
            Wt_bank=self.bank.W, b_bank=self.bank.b, rhos=self.bank.rhos,
            M_res=self._M_res, g_row=self._g_row, lo=self.qp_dev.lo,
            hi=self.qp_dev.hi, alpha_op=self._alpha_op,
            infeas_op=self._infeas_op)
        kw = dict(nx=self.nx, nc=self.nc, nxp=self._nxp, ncp=self._ncp,
                  max_iter=stng.max_iter, check_interval=stng.check_interval,
                  adaptive_rho=stng.adaptive_rho,
                  adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
                  eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
                  rho_max=float(stng.rho_max), rho_jump=bool(stng.rho_jump),
                  adaptive_rho_interval=int(stng.adaptive_rho_interval),
                  alpha_mode=stng.alpha != 1.0, verbose=bool(stng.verbose),
                  iter_precision=stng.iter_precision,
                  refine=bool(stng.refine),
                  check_infeasibility=bool(stng.check_infeasibility),
                  eps_prim_inf=float(stng.eps_prim_inf),
                  eps_dual_inf=float(stng.eps_dual_inf))
        return op, kw

    def _solve_fused(self, t0: float) -> Results:
        """One launch of the whole-solve kernel K3 (its plain version on
        the CPU), then one read of its stats and the objective.

        Under iter_precision="bf16" the bank is stored in bf16 and the
        refine phase polishes on it, as the JAX package's fused backend
        does (ROADMAP §C); the fp32 copy ``_W_hi`` serves the loop only."""
        op, kw = self._fused_call()
        y, stats = full_solve(op, self.y, self.rho_ind, **kw)
        obj = compute_objective(self.qp_dev.H, self.qp_dev.g, y[:self.nx])
        # the solve's one device→host read
        st = torch.cat([stats.double(), obj.double().reshape(1)]).tolist()
        run_time = time.perf_counter() - t0
        return self._finish(y, int(st[4]), int(st[0]), int(st[5]), st[8],
                            st[1], st[2], st[3], run_time)

    def _finish(self, y, rho_ind, iters, status_code, obj_val, pri, dua,
                rho_est, run_time) -> Results:
        """Unscale the solve's final state and record its ``Info``."""
        stng = self.settings
        self.y = y
        self.rho_ind = rho_ind
        nx, nc = self.nx, self.nc
        x = y[:nx] * self._unscale_x
        z_s = y[nx:nx + nc]
        z = z_s * self._unscale_z
        last = y[nx + nc:nx + 2 * nc]
        if stng.alpha != 1.0:
            # λ = ρ⃗(p − z) at the rung the solve finished on.
            last = self._rho_eff[self.rho_ind] * (last - z_s)
        lam = last * self._unscale_lam

        # A fresh Info per solve: a Results held across a later
        # update()+solve() does not change under the caller.
        info = dataclasses.replace(self.info)
        info.iter = iters
        info.status = STATUS_STRINGS[status_code]
        info.obj_val = obj_val * self.scal.cinv
        info.pri_res = pri
        info.dua_res = dua
        info.rho_estimate = rho_est
        info.run_time = run_time
        info.solve_time = info.update_time + run_time
        self.info = info
        self.results = Results(x=x, z=z, lam=lam, info=info)
        if not stng.warm_starting:
            self.clear_primal_dual()
        return self.results

    # ------------------------------------------------------------------ #
    # warm start / reset / state                                         #
    # ------------------------------------------------------------------ #
    def warm_start(self, x=None, z=None, lam=None, rho: Optional[float] = None):
        """Inject primal/dual state (unscaled units) and/or re-pick ρ."""
        self._check_ready()
        stng = self.settings
        sc = self.scal
        nx, nc = self.nx, self.nc
        if stng.alpha != 1.0:
            # Relaxed parametrization: the p slot encodes λ against BOTH z
            # and the current rung, so decode to λ-space, apply the
            # updates, and re-encode against the (possibly re-picked) rung.
            y_np = self.y.detach().cpu().double().numpy().copy()
            z_s = y_np[nx:nx + nc]
            lam_s = self._rho_eff_np[self.rho_ind] \
                * (y_np[nx + nc:nx + 2 * nc] - z_s)
            if x is not None:
                y_np[:nx] = sc.Dinv * np.asarray(x, dtype=np.float64)
            if z is not None:
                z_s = sc.E * np.asarray(z, dtype=np.float64)
                y_np[nx:nx + nc] = z_s
            if lam is not None:
                lam_s = sc.c * sc.Einv * np.asarray(lam, dtype=np.float64)
            if rho is not None:
                self.rho_ind = initial_rho_index(self.rhos_np, rho)
            y_np[nx + nc:nx + 2 * nc] = \
                z_s + lam_s / self._rho_eff_np[self.rho_ind]
            self.y = self._put(y_np)
            return
        y = self.y.clone()
        if x is not None:
            y[:nx] = self._put(sc.Dinv * np.asarray(x, dtype=np.float64))
        if z is not None:
            y[nx:nx + nc] = self._put(sc.E * np.asarray(z, dtype=np.float64))
        if lam is not None:
            y[nx + nc:nx + 2 * nc] = self._put(
                sc.c * sc.Einv * np.asarray(lam, dtype=np.float64))
        self.y = y
        if rho is not None:
            self.rho_ind = initial_rho_index(self.rhos_np, rho)

    def clear_primal_dual(self):
        """Zero the stacked state and reset ρ."""
        self._check_ready()
        self.y = torch.zeros((self.Dp,), dtype=self.settings.precision_dtype,
                             device=self.settings.device)
        self.rho_ind = initial_rho_index(self.rhos_np, self.settings.rho)

    def load_state(self, y, rho_ind: int):
        """Load a stacked state (iterate units, length D or Dp) and ladder
        index, e.g. one taken from another implementation."""
        self._check_ready()
        y_np = (y.detach().cpu().double().numpy()
                if isinstance(y, torch.Tensor)
                else np.asarray(y, np.float64)).reshape(-1)
        if y_np.shape[0] not in (self.D, self.Dp):
            raise ValueError(f"state must have length D={self.D} or "
                             f"Dp={self.Dp}, got {y_np.shape[0]}")
        if not 0 <= int(rho_ind) < len(self.rhos_np):
            raise ValueError(f"rho_ind {rho_ind} is off the ladder")
        full = np.zeros(self.Dp)
        full[:self.D] = y_np[:self.D]
        self.y = self._put(full)
        self.rho_ind = int(rho_ind)

    def _check_ready(self):
        if not self._ready:
            raise RuntimeError("call setup() first")
