"""Batched solver API: many QPs sharing (H, A) in one solve loop.

``BatchedReLU_QP`` carries the ``ReLU_QP`` lifecycle (``setup / solve /
update / update_matrices / update_settings / warm_start /
clear_primal_dual``) over a leading batch axis, for the shared regime:
``H (nx, nx)``, ``A (nc, nx)`` and batched ``g / l / u (B, ·)`` with one
weight bank for the whole batch (scenario MPC, perturbed right-hand
sides). The solve is ``core.batched.solve_batched_shared``:

- ``backend="auto"``/``"pallas"``: the batched chunk kernel K4 on the
  lane-padded layout (the CUDA kernel on ``cuda``, its plain version on
  ``cpu``; on ``cuda`` nothing gates it by size), the batch padded to a
  multiple of 8 rows with inert rows (b = 0, ±inf bounds) that start done;
- ``backend="xla"``: the plain torch runners on the unpadded layout.

The bank and every bias are computed on the host in fp64, at setup and at
``update(g)``; the device holds them in the iteration dtype. (The JAX
package refreshes the bias on the TPU with a double-fp32 contraction
because the TPU has no fp64; the host fp64 product gives that accuracy
directly.)

Not ported yet, and raising ``NotImplementedError``: per-problem H / A
(the heterogeneous regime and its kernel K5), ``mesh=`` and
``process_local=`` (the multi-device paths), ``tail_policy="repack"`` and
``bank_build="device"``.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from .classes import SETTINGS_FIELDS, Settings
from .core.bank import (auto_rho_cap, build_bank_np, certifiable_eps_floor,
                        effective_rho_ladder, equality_mask, sigma_max_sq,
                        stacked_dim)
from .core.batched import BatchSolveResult, solve_batched_shared
from .core.iteration import STATUS_STRINGS
from .core.ladder import initial_rho_index, setup_rhos
from .ops.fused_step import pad_dim, pallas_batched_chunk_runner, round_up
from .utils.scaling import (identity_scaling, residual_unscale_weights,
                            ruiz_equilibrate)

__all__ = ["BatchedReLU_QP", "BatchResults", "BatchInfo"]

# Batch rows are padded to a multiple of this on the lane-padded layout.
_ROW_ALIGN = 8


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class BatchInfo:
    """Per-batch solve metadata (batched analogue of ``classes.Info``)."""

    iter: Optional[np.ndarray] = None          # (B,) first-convergence iters
    status: Optional[np.ndarray] = None        # (B,) bool converged
    status_code: Optional[np.ndarray] = None   # (B,) int32 STATUS_* codes
    obj_val: Optional[np.ndarray] = None       # (B,)
    pri_res: Optional[np.ndarray] = None       # (B,)
    dua_res: Optional[np.ndarray] = None       # (B,)
    rho_estimate: Optional[np.ndarray] = None  # (B,)
    setup_time: float = 0.0
    solve_time: float = 0.0
    update_time: float = 0.0
    run_time: float = 0.0
    n_iter_total: int = 0                      # iterations the batch ran
    n_iter_fast: int = 0                       # of which at reduced precision

    def status_strings(self):
        """Per-problem status strings (``core.iteration.STATUS_STRINGS``)."""
        if self.status_code is None:
            raise RuntimeError("no solve has run yet — call solve() first")
        return [STATUS_STRINGS[int(c)] for c in self.status_code]


@dataclasses.dataclass
class BatchResults:
    x: Optional[torch.Tensor] = None    # (B, nx)
    z: Optional[torch.Tensor] = None    # (B, nc)
    lam: Optional[torch.Tensor] = None  # (B, nc)
    info: Optional[BatchInfo] = None


class BatchedReLU_QP:
    """Batch-of-QPs solver with the ``ReLU_QP`` lifecycle."""

    def __init__(self):
        self.info = BatchInfo()
        self.results = BatchResults(info=self.info)
        self._ready = False

    # ------------------------------------------------------------------ #
    def setup(self, H, g, A, l, u, *, rho_mode: str = "shared",
              mesh=None, axis_name: str = "qp", bank_build: str = "host",
              process_local: bool = False, tail_policy: str = "dense",
              **settings_kw):
        """Set up a batch of QPs sharing (H, A).

        Args:
          H: (nx, nx); g: (B, nx); A: (nc, nx); l, u: (B, nc).
          rho_mode: "shared" (one ladder index for the batch; K4 runs it)
            or "per_problem" (each problem walks its own index; the plain
            runners).
          settings_kw: the ``Settings`` fields (``device`` defaults to
            ``cuda`` and raises without a GPU).
        """
        t0 = time.perf_counter()
        if mesh is not None or process_local:
            raise NotImplementedError(
                "mesh= / process_local= (the multi-device batched solve) is "
                "not ported yet (ROADMAP A.12)")
        if bank_build == "device":
            raise NotImplementedError(
                "bank_build='device' is not ported yet; 'host' builds the "
                "bank in fp64 on the host")
        if bank_build != "host":
            raise ValueError(f"Invalid bank_build {bank_build!r}")
        if tail_policy == "repack":
            raise NotImplementedError(
                "tail_policy='repack' (solve_batched_shared_repack) is not "
                "ported yet; use tail_policy='dense'")
        if tail_policy != "dense":
            raise ValueError(f"tail_policy must be 'dense' or 'repack', got "
                             f"{tail_policy!r}")
        if rho_mode not in ("shared", "per_problem"):
            raise ValueError(f"Invalid rho_mode {rho_mode!r}")
        self.settings = Settings(**settings_kw)
        stng = self.settings
        dtype = stng.precision_dtype
        dev = stng.device
        self.axis_name = axis_name

        g = np.asarray(g, dtype=np.float64)
        if g.ndim != 2:
            raise ValueError("g must be (B, nx) for the batched solver")
        H = np.asarray(H, dtype=np.float64)
        A = np.asarray(A, dtype=np.float64)
        if H.ndim == 3 or A.ndim == 3:
            raise NotImplementedError(
                "per-problem H/A (the heterogeneous batch and its chunk "
                "kernel K5) is not ported yet; pass shared (nx, nx) / "
                "(nc, nx) matrices")
        l = np.asarray(l, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        B_n, nx = g.shape
        nc = A.shape[0]
        if H.shape != (nx, nx) or A.shape != (nc, nx):
            raise ValueError(f"H must be ({nx}, {nx}) and A (nc, {nx})")
        if l.shape != (B_n, nc) or u.shape != (B_n, nc):
            raise ValueError(f"l/u must be (B, nc) = ({B_n}, {nc})")
        # unscaled fp64 masters: update()/update_matrices() rebuild from them
        self._H_np, self._A_np, self._g_np = H.copy(), A.copy(), g.copy()
        self.hetero = False
        self.B_n, self.nx, self.nc = B_n, nx, nc
        self.D = stacked_dim(nx, nc)
        self.rho_mode = rho_mode

        # Backend: K4 on the lane-padded layout ("auto"/"pallas"; the CUDA
        # kernel on cuda, its plain version on cpu) for the shared walk, or
        # the plain runners on the unpadded layout ("xla", and every
        # per-problem walk). On cuda "auto" always takes K4.
        if stng.backend == "fused":
            raise ValueError("the batched solver has no whole-solve kernel; "
                             "use backend='auto', 'pallas' or 'xla'")
        if rho_mode != "shared" and stng.backend == "pallas":
            raise ValueError("the pallas batched backend requires "
                             "rho_mode='shared'")
        self._use_pallas = rho_mode == "shared" and stng.backend != "xla"
        if self._use_pallas:
            self.Dp = pad_dim(self.D)
            self.B_pad = round_up(B_n, _ROW_ALIGN)
        else:
            self.Dp = self.D
            self.B_pad = B_n

        self.rhos_np = setup_rhos(stng.rho, stng.rho_min, stng.rho_max,
                                  stng.adaptive_rho,
                                  stng.adaptive_rho_tolerance)
        self._keep_hi = stng.iter_precision == "bf16" and stng.refine
        self._setup_shared(H, g, A, l, u, dtype, dev)
        self.rhos = torch.as_tensor(self.rhos_np, dtype=dtype, device=dev)
        self.clear_primal_dual()
        _sync(dev)
        self.info.setup_time = time.perf_counter() - t0
        self.info.update_time = 0.0
        self._ready = True

    def _put(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=dtype or self.settings.precision_dtype,
                               device=self.settings.device)

    def _setup_shared(self, H, g, A, l, u, dtype, dev):
        stng = self.settings
        # equality detection on UNSCALED bounds; the pattern shapes the
        # shared bank, so it must be the same across the batch
        eqs = equality_mask(l, u, stng.eq_tol)
        eq = eqs[0]
        if not (eqs == eq[None, :]).all():
            raise ValueError(
                "equality-row pattern differs across the batch; the shared "
                "bank would be wrong — pass batched H/A (hetero mode)")
        self._eq_pattern = eq
        self._l_np, self._u_np = l.copy(), u.copy()

        # optional Ruiz equilibration of the shared matrices, the cost
        # normalized by the batch-mean |g|
        if stng.scaling:
            self.scal = ruiz_equilibrate(H, A, np.mean(np.abs(g), axis=0))
        else:
            self.scal = identity_scaling(self.nx, self.nc)
        sc = self.scal
        H = sc.c * (H * sc.D[:, None] * sc.D[None, :])
        A = A * sc.E[:, None] * sc.D[None, :]
        self._unx = self._put(sc.D)
        self._unz = self._put(sc.Einv)
        self._unlam = self._put(sc.E * sc.cinv)
        wp, wd = residual_unscale_weights(sc, stng)
        self._w_pri = None if wp is None else self._put(wp)
        self._w_dua = None if wd is None else self._put(wd)
        self._w_pri_np, self._w_dua_np = wp, wd

        # precision-aware effective-ρ cap on the SCALED A, and the per-rung
        # ρ⃗ ladder it induces
        self.rho_cap = (auto_rho_cap(A, stng.eps_abs, dtype, self.nx)
                        if stng.rho_cap == "auto" else float(stng.rho_cap))
        self._A_scaled_np = A
        self._H_scaled_np = H
        self._sigma_max_sq = None
        self._rho_eff_np = effective_rho_ladder(self.rhos_np, eq,
                                                self.rho_cap)
        self._rho_eff = (self._put(self._rho_eff_np) if stng.alpha != 1.0
                         else None)

        W, Bm, _ = build_bank_np(H, np.zeros(self.nx), A, eq, self.rhos_np,
                                 stng.sigma, alpha=float(stng.alpha),
                                 rho_cap=self.rho_cap)
        # runtime layout: Wᵀ per rung, zero-padded to Dp
        N, D, Dp = W.shape[0], self.D, self.Dp
        Wt = np.zeros((N, Dp, Dp))
        Wt[:, :D, :D] = np.swapaxes(W, 1, 2)
        self._B_np = np.zeros((N, Dp, self.nx))   # fp64 bias master
        self._B_np[:, :D] = Bm
        w_dtype = torch.bfloat16 if stng.iter_precision == "bf16" else dtype
        self.Wt_bank = self._put(Wt, w_dtype)
        self._Wt_hi = self._put(Wt) if self._keep_hi else None
        self.H_dev = self._put(H)
        self.A_dev = self._put(A)
        self._set_g(g)
        self._set_bounds(l * sc.E[None, :], u * sc.E[None, :])

    def _set_g(self, g):
        """The scaled, row-padded G and the per-rung bias ``b_k = B_k g``,
        (N, B_pad, Dp), both from the fp64 host product."""
        sc = self.scal
        g_pad = np.zeros((self.B_pad, self.nx))
        g_pad[:self.B_n] = sc.c * (g * sc.D[None, :])
        self.G = self._put(g_pad)
        self.bias_all = self._put(
            np.matmul(g_pad[None], np.swapaxes(self._B_np, 1, 2)))

    def _set_bounds(self, l_s, u_s):
        # padding (extra lanes AND extra batch rows) is ±inf, inert; the
        # clamp is active only on the z segment [nx, nx + nc)
        lo = np.full((self.B_pad, self.Dp), -np.inf)
        hi = np.full((self.B_pad, self.Dp), np.inf)
        lo[:self.B_n, self.nx:self.nx + self.nc] = l_s
        hi[:self.B_n, self.nx:self.nx + self.nc] = u_s
        self.lo = self._put(lo)
        self.hi = self._put(hi)

    # ------------------------------------------------------------------ #
    def update(self, g=None, l=None, u=None):
        """Refresh the batched problem vectors (UNSCALED units); a g update
        recomputes every rung's bias in fp64 on the host."""
        self._check_ready()
        t0 = time.perf_counter()
        sc = self.scal
        if g is not None:
            g = np.asarray(g, dtype=np.float64)
            if g.shape != (self.B_n, self.nx):
                raise ValueError(f"g must be ({self.B_n}, {self.nx})")
            self._g_np = g.copy()
            self._set_g(g)
        if l is not None or u is not None:
            l_np = self._l_np if l is None else np.asarray(l, np.float64)
            u_np = self._u_np if u is None else np.asarray(u, np.float64)
            if l_np.shape != (self.B_n, self.nc) \
                    or u_np.shape != (self.B_n, self.nc):
                raise ValueError(f"l/u must be ({self.B_n}, {self.nc})")
            eqs = equality_mask(l_np, u_np, self.settings.eq_tol)
            if not (eqs == self._eq_pattern[None, :]).all():
                raise ValueError(
                    "bound update changes the equality-row pattern baked "
                    "into the shared bank — re-run setup()")
            self._l_np, self._u_np = l_np.copy(), u_np.copy()
            self._set_bounds(l_np * sc.E, u_np * sc.E)
        _sync(self.settings.device)
        self.info.update_time = time.perf_counter() - t0

    def update_matrices(self, H=None, A=None):
        """Replace the shared H and/or A, re-factorizing the bank at one
        setup's cost while keeping the warm state (carried in UNSCALED
        units), the ladder position and the settings."""
        self._check_ready()
        if H is None and A is None:
            return
        t0 = time.perf_counter()
        old = self.scal
        nx, nc, Bn = self.nx, self.nc, self.B_n
        Y = self.Y[:Bn].detach().cpu().double().numpy()
        z_s = Y[:, nx:nx + nc]
        last = Y[:, nx + nc:nx + 2 * nc]
        if self.settings.alpha != 1.0:
            last = self._rho_vec_rows() * (last - z_s)   # p → λ
        x_u = Y[:, :nx] * old.D
        z_u = z_s * old.Einv
        lam_u = last * old.E * old.cinv
        old_ind = self.rho_ind.detach().cpu().numpy()
        stng = self.settings
        self.setup(self._H_np if H is None else H, self._g_np,
                   self._A_np if A is None else A, self._l_np, self._u_np,
                   rho_mode=self.rho_mode, axis_name=self.axis_name,
                   **{k: getattr(stng, k) for k in SETTINGS_FIELDS})
        # the ladder position BEFORE the warm state: under alpha != 1 the p
        # slot is encoded against the current rung
        self.rho_ind = torch.as_tensor(old_ind.astype(np.int32),
                                       device=self.settings.device)
        self.warm_start(x=x_u, z=z_u, lam=lam_u)
        self.info.update_time = time.perf_counter() - t0

    def _warn_eps_floor(self, eps_new: float) -> None:
        """Warn when eps_abs is tightened past the frozen cap's floor."""
        cap = float(self.rho_cap)
        if not np.isfinite(cap):
            return
        if self._sigma_max_sq is None:
            self._sigma_max_sq = sigma_max_sq(self._A_scaled_np)
        floor = certifiable_eps_floor(cap, self._sigma_max_sq,
                                      self.settings.precision_dtype, self.nx)
        if eps_new < floor * (1.0 - 1e-9):
            warnings.warn(
                f"eps_abs={eps_new:g} is below {floor:g}, the certifiable "
                "floor of the rho cap frozen at setup (derived for the "
                "setup-time eps_abs): the capped ladder's dual-residual "
                "noise floor may keep some problems at max_iter. Re-derive "
                "the cap with update_matrices (a full re-setup), or set "
                "rho_cap/precision at setup.", RuntimeWarning, stacklevel=3)

    def update_settings(self, **kwargs):
        """Runtime-mutable settings, as ``ReLU_QP``: ``max_iter``,
        ``eps_abs``, ``verbose``, ``check_interval``; the ρ/σ family
        raises. Tightening eps_abs below the frozen cap's floor warns."""
        for key, value in kwargs.items():
            if key in ("max_iter", "eps_abs", "verbose", "check_interval"):
                if key == "eps_abs":
                    self._warn_eps_floor(float(value))
                setattr(self.settings, key, value)
            elif key in ("rho", "rho_min", "rho_max", "sigma",
                         "adaptive_rho", "adaptive_rho_interval",
                         "adaptive_rho_tolerance", "alpha"):
                raise ValueError(f"Cannot change {key} after setup")
            else:
                raise ValueError(f"Invalid setting: {key}")

    # ------------------------------------------------------------------ #
    def _solve_kw(self):
        """The settings of the ``core.batched`` loop."""
        stng = self.settings
        return dict(nx=self.nx, nc=self.nc, max_iter=stng.max_iter,
                    check_interval=stng.check_interval,
                    adaptive_rho=stng.adaptive_rho,
                    adaptive_rho_tolerance=float(
                        stng.adaptive_rho_tolerance),
                    eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
                    rho_max=float(stng.rho_max),
                    rho_jump=bool(stng.rho_jump),
                    check_infeasibility=bool(stng.check_infeasibility),
                    eps_prim_inf=float(stng.eps_prim_inf),
                    eps_dual_inf=float(stng.eps_dual_inf),
                    iter_precision=stng.iter_precision,
                    refine=bool(stng.refine),
                    adaptive_rho_interval=int(stng.adaptive_rho_interval),
                    alpha=float(stng.alpha))

    def _done0(self):
        """Inert padded rows start done (None when there are none)."""
        if self.B_pad == self.B_n:
            return None
        return torch.arange(self.B_pad,
                            device=self.settings.device) >= self.B_n

    def solve(self) -> BatchResults:
        """Solve the whole batch from the current (warm) state."""
        self._check_ready()
        t0 = time.perf_counter()
        runner = pallas_batched_chunk_runner if self._use_pallas else None
        res = solve_batched_shared(
            self.Wt_bank, self.bias_all, self.rhos, self.H_dev, self.A_dev,
            self.G, self.lo, self.hi, self.Y, self.rho_ind, self._done0(),
            self._Wt_hi, self._rho_eff, self._w_pri, self._w_dua,
            rho_mode=self.rho_mode, chunk_runner=runner, **self._solve_kw())
        self._fill_results(res, t0)
        if not self.settings.warm_starting:
            self.clear_primal_dual()
        return self.results

    def _fill_results(self, res: BatchSolveResult, t0: float):
        self.Y = res.Y
        self.rho_ind = res.rho_ind
        nx, nc, Bn = self.nx, self.nc, self.B_n
        f64 = torch.float64
        # the solve's one bulk device→host read of the per-problem stats
        host = torch.stack([res.iters.to(f64), res.status.to(f64),
                            res.pri_res.to(f64), res.dua_res.to(f64),
                            res.rho_estimate.to(f64)])[:, :Bn].cpu().numpy()
        run_time = time.perf_counter() - t0
        # a fresh BatchInfo per solve: results held by the caller do not
        # change under a later solve
        info = dataclasses.replace(self.info)
        info.iter = host[0].astype(np.int32)
        info.status_code = host[1].astype(np.int32)
        info.status = info.status_code == 1
        info.pri_res, info.dua_res, info.rho_estimate = host[2], host[3], \
            host[4]
        info.n_iter_total = int(res.n_iter_total)
        info.n_iter_fast = int(res.n_iter_fast)
        info.obj_val = None   # computed on demand by objective()
        info.run_time = run_time
        info.solve_time = info.update_time + run_time
        z_s = res.Y[:Bn, nx:nx + nc]
        last = res.Y[:Bn, nx + nc:nx + 2 * nc]
        if self.settings.alpha != 1.0:
            # λ = ρ⃗(p − z) at each problem's final rung
            last = self._rho_eff_at(res.rho_ind) * (last - z_s)
        self.info = info
        self.results = BatchResults(x=res.Y[:Bn, :nx] * self._unx,
                                    z=z_s * self._unz,
                                    lam=last * self._unlam, info=info)

    def objective(self) -> np.ndarray:
        """Per-problem objective ½xᵀHx + gᵀx in UNSCALED units."""
        x = self.Y[:self.B_n, :self.nx]   # scaled iterate
        G = self.G[:self.B_n]
        obj_s = 0.5 * (x * (x @ self.H_dev.T)).sum(-1) + (G * x).sum(-1)
        return obj_s.detach().cpu().double().numpy() * self.scal.cinv

    # ------------------------------------------------------------------ #
    def _rho_eff_at(self, rho_ind):
        """(1, nc) or (Bn, nc) effective ρ⃗ at the given rung(s)."""
        rv = self._rho_eff.index_select(0, rho_ind.reshape(-1).long())
        return rv if rv.shape[0] == 1 else rv[:self.B_n]

    def _rho_vec_rows(self) -> np.ndarray:
        """(Bn, nc) per-problem ρ⃗ at the current ladder indices (host)."""
        ind = np.broadcast_to(self.rho_ind.detach().cpu().numpy(),
                              (self.B_n,))
        return self._rho_eff_np[ind]

    def warm_start(self, x=None, z=None, lam=None):
        """Inject primal/dual state (UNSCALED units, (B, ·) rows)."""
        self._check_ready()
        stng = self.settings
        sc = self.scal
        nx, nc, Bn = self.nx, self.nc, self.B_n
        put = self._put
        Y = self.Y.clone()
        if stng.alpha != 1.0:
            # p encodes λ against both z and the current rung: decode to
            # λ space, apply the updates, re-encode
            rv = self._rho_eff_at(self.rho_ind)
            z_s = Y[:Bn, nx:nx + nc]
            lam_s = rv * (Y[:Bn, nx + nc:nx + 2 * nc] - z_s)
            if x is not None:
                Y[:Bn, :nx] = put(np.asarray(x, np.float64) * sc.Dinv)
            if z is not None:
                z_s = put(np.asarray(z, np.float64) * sc.E)
                Y[:Bn, nx:nx + nc] = z_s
            if lam is not None:
                lam_s = put(np.asarray(lam, np.float64) * (sc.c * sc.Einv))
            Y[:Bn, nx + nc:nx + 2 * nc] = z_s + lam_s / rv
            self.Y = Y
            return
        if x is not None:
            Y[:Bn, :nx] = put(np.asarray(x, np.float64) * sc.Dinv)
        if z is not None:
            Y[:Bn, nx:nx + nc] = put(np.asarray(z, np.float64) * sc.E)
        if lam is not None:
            Y[:Bn, nx + nc:nx + 2 * nc] = put(
                np.asarray(lam, np.float64) * (sc.c * sc.Einv))
        self.Y = Y

    def clear_primal_dual(self):
        """Zero the stacked states and reset ρ."""
        stng = self.settings
        self.Y = torch.zeros((self.B_pad, self.Dp),
                             dtype=stng.precision_dtype, device=stng.device)
        r0 = initial_rho_index(self.rhos_np, stng.rho)
        shape = () if self.rho_mode == "shared" else (self.B_pad,)
        self.rho_ind = torch.full(shape, r0, dtype=torch.int32,
                                  device=stng.device)

    def load_state(self, Y, rho_ind):
        """Load stacked states (iterate units, (B, D) or (B, Dp) rows, or
        the padded (B_pad, ·) block) and the ladder index (an int for the
        shared walk, (B,) per problem), e.g. taken from another
        implementation."""
        self._check_ready()
        Y_np = (Y.detach().cpu().double().numpy() if isinstance(Y, torch.Tensor)
                else np.asarray(Y, np.float64))
        if Y_np.ndim != 2 or Y_np.shape[0] < self.B_n \
                or Y_np.shape[1] not in (self.D, self.Dp):
            raise ValueError(f"state must be (B={self.B_n}, D={self.D} or "
                             f"Dp={self.Dp}), got {Y_np.shape}")
        ind = np.asarray(rho_ind, np.int64).reshape(-1)
        want = 1 if self.rho_mode == "shared" else self.B_n
        if ind.size < want or ((ind < 0) | (ind >= len(self.rhos_np))).any():
            raise ValueError(f"rho_ind {rho_ind} is off the ladder or the "
                             "batch")
        full = np.zeros((self.B_pad, self.Dp))
        full[:self.B_n, :self.D] = Y_np[:self.B_n, :self.D]
        self.Y = self._put(full)
        if self.rho_mode == "shared":
            self.rho_ind = torch.tensor(int(ind[0]), dtype=torch.int32,
                                        device=self.settings.device)
        else:
            r = np.full((self.B_pad,), ind[0], np.int32)
            r[:self.B_n] = ind[:self.B_n]
            self.rho_ind = torch.as_tensor(r, device=self.settings.device)

    def _check_ready(self):
        if not self._ready:
            raise RuntimeError("call setup() first")
