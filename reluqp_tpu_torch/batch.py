"""Batched solver API: many QPs in one solve loop.

``BatchedReLU_QP`` carries the ``ReLU_QP`` lifecycle (``setup / solve /
update / update_matrices / update_settings / warm_start /
clear_primal_dual``) over a leading batch axis, in two regimes chosen by
the rank of H / A at ``setup``:

- **shared**: ``H (nx, nx)``, ``A (nc, nx)`` and batched ``g / l / u
  (B, ·)``, one weight bank for the whole batch (scenario MPC, perturbed
  right-hand sides); the equality-row pattern must be the same across the
  batch. The solve is ``core.batched.solve_batched_shared``:

  - ``backend="auto"``/``"pallas"``: the batched chunk kernel K4 on the
    lane-padded layout (the CUDA kernel on ``cuda``, its plain version on
    ``cpu``; on ``cuda`` nothing gates it by size), the batch padded to a
    multiple of 8 rows with inert rows (b = 0, ±inf bounds) that start done;
  - ``backend="xla"``: the plain torch runners on the unpadded layout.

- **heterogeneous**: ``H (B, nx, nx)`` and/or ``A (B, nc, nx)`` (a shared
  matrix beside a batched one is promoted; the fp64 masters keep it
  shared), one bank per problem, every problem walking its own ladder
  index. The solve is ``core.batched.solve_batched_hetero``:

  - ``backend="auto"``/``"pallas"``: the per-problem chunk kernel K5 on the
    lane-padded layout (the CUDA kernel on ``cuda`` at any B and any Dp,
    its plain version on ``cpu``); the batch is never padded;
  - ``backend="xla"``: the plain runner ``_chunk_hetero`` on the unpadded
    layout.

  ``bank_build="host"`` builds the banks on the host in fp64, over chunks
  of problems on one thread (with the native C++ builder where it builds
  and ``alpha == 1``, else stacked numpy), written straight into the
  iteration dtype; ``bank_build="device"`` builds them all in one pass of
  batched fp64 torch linear algebra on the solver's device
  (``core.bank.build_bank_torch``). Their device footprint is checked at
  setup against a cap: 3/4 of the card's memory on ``cuda``, 8 GiB on the
  CPU; ``RELUQP_MAX_BANK_BYTES`` overrides it.

Every bias is formed in fp64 and stored in the iteration dtype, at setup and
at ``update(g)``: from the fp64 host masters of the B banks (shared regime,
host-built heterogeneous banks), or from the fp64 B master a device build
keeps on the device. (The JAX package refreshes the bias on the TPU with a
double-fp32 contraction because the TPU has no fp64; an fp64 product gives
that accuracy directly.)

``tail_policy="repack"`` (shared (H, A) only) solves over a schedule of
shrinking row buffers (``repack_schedule``,
``core.batched.solve_batched_shared_repack``).

``mesh=`` (a 1-D ``DeviceMesh`` from ``parallel.make_mesh``, one process per
device) splits the batch over the ranks in rank order: each rank keeps its
rows, builds the shared bank (the same on every rank) or its own problems'
banks, forms its rows' biases in fp64 on the host, and runs the per-device
kernel on them (K4 or K5 on ``cuda``), the loop's exit all-reduced over the
mesh (``core.batched``). Every rank is handed the global batch, or, with
``process_local=True``, only its own rows (the global batch is then
``world size × local rows``). ``solve()`` returns the global results on
every rank, gathered once after the loop; ``local_rows`` picks this rank's.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

import torch.distributed as dist

from . import native
from .classes import SETTINGS_FIELDS, Settings
from .core.bank import (auto_rho_cap, auto_rho_cap_batch, build_bank_np,
                        build_bank_torch, build_banks_np_batch,
                        certifiable_eps_floor,
                        effective_rho_ladder,
                        effective_rho_ladder_batch, equality_mask,
                        sigma_max_sq, sigma_max_sq_batch, stacked_dim)
from .core.batched import (BatchSolveResult, solve_batched_hetero,
                           solve_batched_shared, solve_batched_shared_repack)
from .core.graphs import WindowGraphs
from .core.iteration import STATUS_STRINGS
from .core.ladder import initial_rho_index, setup_rhos
from .ops.fused_step import (batched_plan, pad_dim,
                             pallas_batched_chunk_runner,
                             pallas_hetero_chunk_runner, round_up)
from .parallel.sharded import gather_rows, mesh_group
from .utils.scaling import (identity_scaling, residual_unscale_weights,
                            ruiz_equilibrate, ruiz_equilibrate_batch)

__all__ = ["BatchedReLU_QP", "BatchResults", "BatchInfo"]

# Batch rows are padded to a multiple of this on the lane-padded layout.
_ROW_ALIGN = 8
# Smallest repack stage (tail_policy="repack"): below this row count the
# iteration is launch-bound and shrinking further buys nothing.
_REPACK_MIN_ROWS = 512
# Problems per step of the heterogeneous bank build: stacked products of a
# few dozen problems amortize numpy's per-call cost. The build runs on one
# thread: at B=1024, nx=50 on an 8-core H100 host a pool of one task per
# problem took 43.9 s (numpy's small calls hold the GIL and the BLAS
# library's own threads fight the pool's), these chunks 11.9 s on 8 threads
# and 7.8 s on one (PERF.md, section 6).
_BUILD_CHUNK = 64
# The heterogeneous banks' cap on the CPU, where they are host memory: the
# host's free memory is shared with everything else and not the solver's to
# measure, so a fixed cap keeps a stray batch size from exhausting it.
_CPU_BANK_CAP = 8 << 30


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _hetero_eps_floor(caps, A_scaled, dtype, nx: int) -> float:
    """Batch-wide certifiable eps floor: the largest per-problem floor (one
    problem stalling is enough to warrant the update_settings warning).
    0.0 when every cap is inf (nothing frozen)."""
    caps = np.asarray(caps, np.float64)
    finite = np.isfinite(caps)
    if not np.any(finite):
        return 0.0
    s2 = sigma_max_sq_batch(np.asarray(A_scaled, np.float64))
    ok = finite & (s2 > 0.0)
    eps_mach = float(torch.finfo(dtype).eps)
    floors = np.where(ok, caps, 0.0) * eps_mach * s2 / np.sqrt(max(nx, 1))
    return float(np.max(floors))


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
    rho_ind: Optional[np.ndarray] = None       # (B,) final rungs
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


def repack_schedule(b_pad: int, align: int) -> tuple:
    """Row capacities of ``tail_policy="repack"``: halving from ``b_pad``
    down to ``_REPACK_MIN_ROWS`` (or ``align``, where larger), at most 4
    stages (the last halvings save few row-iterations), every capacity
    after the first a multiple of ``align``. A one-entry schedule (the
    batch already at the floor) is the dense loop."""
    floor = max(_REPACK_MIN_ROWS, align)
    caps = [b_pad]
    for _ in range(3):
        nxt = round_up(max(caps[-1] // 2, floor), align)
        if nxt >= caps[-1]:
            break
        caps.append(nxt)
        if nxt <= floor:
            break
    return tuple(caps)


class BatchedReLU_QP:
    """Batch-of-QPs solver with the ``ReLU_QP`` lifecycle."""

    def __init__(self):
        self.info = BatchInfo()
        self.results = BatchResults(info=self.info)
        self._ready = False
        self.mesh, self.axis_name = None, "qp"
        self._group, self._rank, self._size = None, 0, 1
        self._process_local = False
        self._rows = slice(None)
        # the solves' device programs and window graphs (core.graphs);
        # False runs every piece eagerly
        self._window_graphs = WindowGraphs()

    # ------------------------------------------------------------------ #
    def setup(self, H, g, A, l, u, *, rho_mode: str = "shared",
              mesh=None, axis_name: str = "qp", bank_build: str = "host",
              process_local: bool = False, tail_policy: str = "dense",
              **settings_kw):
        """Set up a batch of QPs.

        Args:
          H: (nx, nx) shared or (B, nx, nx) per-problem Hessians.
          g: (B, nx); A: (nc, nx) or (B, nc, nx); l, u: (B, nc). A batched
            H or A selects the heterogeneous regime (one bank per problem,
            kernel K5).
          rho_mode: "shared" (one ladder index for the batch; K4 runs it)
            or "per_problem" (each problem walks its own index; the plain
            runners). Heterogeneous batches always walk per problem.
          bank_build: "host" (fp64 on the host: the native builder where
            it builds and alpha = 1, else numpy) or "device" (one pass of
            batched fp64 torch linear algebra on the solver's device, the
            B banks kept there in fp64 as the bias masters). Heterogeneous
            batches only; a shared batch builds its one bank on the host.
          tail_policy: "dense" (every row iterates until the last
            converges) or "repack" (shrink-on-converge: a schedule of
            halving row buffers, the open rows compacted between stages on
            the device). Repack needs a shared-(H, A) batch, no mesh,
            single-phase iteration (iter_precision="highest" or
            refine=False) and max_iter a multiple of check_interval.
          mesh: a 1-D ``DeviceMesh`` (``parallel.make_mesh``) to split the
            batch over, one process per device; ``axis_name`` names its
            dimension. The batch must divide by the mesh size. Every rank
            calls setup with the same arguments.
          process_local: with a mesh, the batch-led arrays (g, l, u, and a
            batched H or A) are THIS rank's rows of a global batch of
            ``world size × B`` problems (equal on every rank); a shared H/A
            must be the same on every rank. ``update``, ``warm_start``,
            ``update_matrices`` and ``load_state`` then take local rows too.
          settings_kw: the ``Settings`` fields (``device`` defaults to
            ``cuda`` and raises without a GPU; under a mesh it must be the
            mesh's device type).
        """
        t0 = time.perf_counter()
        if bank_build not in ("host", "device"):
            raise ValueError(f"bank_build must be 'host' or 'device', got "
                             f"{bank_build!r}")
        if tail_policy not in ("dense", "repack"):
            raise ValueError(f"tail_policy must be 'dense' or 'repack', got "
                             f"{tail_policy!r}")
        self.settings = Settings(**settings_kw)
        stng = self.settings
        if self._window_graphs:
            self._window_graphs.clear()   # new operands
        if process_local and mesh is None:
            raise ValueError("process_local=True requires a mesh")
        if tail_policy == "repack":
            self._check_repack(np.ndim(H) == 3 or np.ndim(A) == 3, mesh)
        if rho_mode not in ("shared", "per_problem"):
            raise ValueError(f"Invalid rho_mode {rho_mode!r}")
        self.mesh, self.axis_name = mesh, axis_name
        self._process_local = bool(process_local)
        self._group, self._rank, self._size = None, 0, 1
        if mesh is not None:
            self._group, self._rank, self._size, mdev = mesh_group(
                mesh, axis_name)
            if stng.device.type != mdev.type:
                raise ValueError(f"device {stng.device} is not the mesh's "
                                 f"device type {mdev.type!r}")
            if stng.device.index is None:
                stng.device = mdev
        dtype = stng.precision_dtype
        dev = stng.device

        g = np.asarray(g, dtype=np.float64)
        if g.ndim != 2:
            raise ValueError("g must be (B, nx) for the batched solver")
        H = np.asarray(H, dtype=np.float64)
        A = np.asarray(A, dtype=np.float64)
        l = np.asarray(l, dtype=np.float64)
        u = np.asarray(u, dtype=np.float64)
        B_in, nx = g.shape
        hetero = H.ndim == 3 or A.ndim == 3
        nc = A.shape[-2] if A.ndim >= 2 else -1
        if H.shape not in ((nx, nx), (B_in, nx, nx)) \
                or A.shape not in ((nc, nx), (B_in, nc, nx)):
            raise ValueError(f"H must be ({nx}, {nx}) or ({B_in}, {nx}, {nx}) "
                             f"and A (nc, {nx}) or ({B_in}, nc, {nx})")
        if l.shape != (B_in, nc) or u.shape != (B_in, nc):
            raise ValueError(f"l/u must be (B, nc) = ({B_in}, {nc})")
        # unscaled fp64 masters in their pre-promotion shapes (a shared
        # matrix beside a batched one is not repeated B times), the rows
        # the caller passed: update()/update_matrices() rebuild from them
        self._H_np, self._A_np, self._g_np = H.copy(), A.copy(), g.copy()
        self._l_np, self._u_np = l.copy(), u.copy()
        # this rank's rows; Ruiz's batch-mean |g| from the whole batch
        self._rows = self._my_rows(B_in, dev)
        gbar = (self._ruiz_gbar(g, dev) if stng.scaling and not hetero
                else None)
        rows = self._rows
        g, l, u = g[rows], l[rows], u[rows]
        H = H[rows] if H.ndim == 3 else H
        A = A[rows] if A.ndim == 3 else A
        B_loc = g.shape[0]
        self.hetero = hetero
        self.B_local, self.nx, self.nc = B_loc, nx, nc
        self.B_n = B_loc * self._size
        self.D = stacked_dim(nx, nc)
        self._rho_mode_req = rho_mode
        self.rho_mode = "per_problem" if hetero else rho_mode
        self._bank_build = bank_build

        # Backend: K4 (shared walk) or K5 (heterogeneous) on the lane-padded
        # layout ("auto"/"pallas"; the CUDA kernel on cuda, its plain
        # version on cpu), or the plain runners on the unpadded layout
        # ("xla", and every per-problem walk of a shared bank). On cuda
        # "auto" always takes K4 or K5: no size gate, no fallback.
        if stng.backend == "fused":
            raise ValueError("the batched solver has no whole-solve kernel; "
                             "use backend='auto', 'pallas' or 'xla'")
        if not hetero and rho_mode != "shared" and stng.backend == "pallas":
            raise ValueError("the pallas batched backend requires "
                             "rho_mode='shared' for shared-(H, A) batches")
        self._use_pallas = (not hetero and rho_mode == "shared"
                            and stng.backend != "xla")
        self._hetero_pallas = hetero and stng.backend != "xla"
        if self._use_pallas:
            self.Dp = pad_dim(self.D)
            self.B_pad = round_up(B_loc, _ROW_ALIGN)
        elif self._hetero_pallas:
            self.Dp = pad_dim(self.D)   # lane-aligned per-problem blocks
            self.B_pad = B_loc
        else:
            self.Dp = self.D
            self.B_pad = B_loc

        self.tail_policy = tail_policy
        self._repack_sched = (self._make_repack_schedule()
                              if tail_policy == "repack" else None)

        self.rhos_np = setup_rhos(stng.rho, stng.rho_min, stng.rho_max,
                                  stng.adaptive_rho,
                                  stng.adaptive_rho_tolerance)
        self._keep_hi = stng.iter_precision == "bf16" and stng.refine
        self._B_np = self._B_dev = None
        if hetero:
            self._setup_hetero(np.broadcast_to(H, (B_loc, nx, nx)), g,
                               np.broadcast_to(A, (B_loc, nc, nx)), l, u,
                               dtype, dev)
        else:
            self._setup_shared(H, g, A, l, u, dtype, dev, gbar)
        self.rhos = torch.as_tensor(self.rhos_np, dtype=dtype, device=dev)
        self.clear_primal_dual()
        _sync(dev)
        self.info.setup_time = time.perf_counter() - t0
        self.info.update_time = 0.0
        self._ready = True

    def _my_rows(self, n: int, dev) -> slice:
        """This rank's slice of the ``n`` batch rows the caller passed: an
        even split in rank order under a mesh (the batch must divide), all
        of them with ``process_local`` (every rank's count must be equal,
        checked by one all-gather) or without a mesh."""
        if self.mesh is None:
            return slice(0, n)
        if self._process_local:
            counts = gather_rows(torch.tensor([n], device=dev), self._group)
            if bool((counts != n).any()):
                raise ValueError(f"process_local ranks hold "
                                 f"{counts.tolist()} rows: every rank must "
                                 "hold the same number")
            return slice(0, n)
        if n % self._size != 0:
            raise ValueError(f"batch {n} not divisible by mesh axis "
                             f"{self._size} — pad the batch (inert rows: "
                             "lo=-inf, hi=+inf)")
        per = n // self._size
        return slice(self._rank * per, (self._rank + 1) * per)

    def _ruiz_gbar(self, g, dev) -> np.ndarray:
        """The batch-mean |g| that normalizes a shared batch's Ruiz cost:
        over the rows passed, or, with ``process_local``, the mean of every
        rank's mean in rank order (one all-gather), so every rank
        equilibrates identically."""
        gbar = np.mean(np.abs(g), axis=0)
        if self._process_local and self._size > 1:
            t = torch.as_tensor(gbar, dtype=torch.float64, device=dev)
            gbar = np.mean(gather_rows(t[None], self._group).cpu().numpy(),
                           axis=0)
        return gbar

    def _same_on_every_rank(self, a: np.ndarray, what: str) -> None:
        """Raise unless every rank of the mesh holds the same ``a`` (one
        all-gather)."""
        if self._size == 1:
            return
        t = torch.as_tensor(np.ascontiguousarray(a, np.float64),
                            device=self.settings.device)
        allr = gather_rows(t[None], self._group)
        if not bool((allr == t[None]).all()):
            raise ValueError(f"{what} differs across the mesh's ranks")

    def _put(self, a, dtype=None):
        # a writable C-ordered fp64 array (a broadcast view is copied)
        return torch.as_tensor(np.require(a, np.float64, ("C", "W")),
                               dtype=dtype or self.settings.precision_dtype,
                               device=self.settings.device)

    def _check_repack(self, hetero: bool, mesh):
        """The setups ``tail_policy="repack"`` cannot run."""
        stng = self.settings
        if hetero:
            raise ValueError(
                "tail_policy='repack' supports shared-(H,A) batches only "
                "(per-problem banks would need a B·N·Dp² gather per stage; "
                "use tail_policy='dense')")
        if mesh is not None:
            raise ValueError(
                "tail_policy='repack' is per-chip (compaction across mesh "
                "shards would need resharding collectives); drop the mesh "
                "or use tail_policy='dense'")
        if stng.refine and stng.iter_precision != "highest":
            raise ValueError(
                "tail_policy='repack' cannot carry the two-phase refine "
                "switch across its stage boundaries — use "
                "iter_precision='highest' or refine=False")
        if stng.max_iter % stng.check_interval != 0:
            raise ValueError(
                "tail_policy='repack' requires max_iter to be a multiple of "
                "check_interval: a stage that exits on budget exhaustion "
                "would otherwise compact away OPEN rows before the final "
                "partial-window tail, diverging from tail_policy='dense' — "
                f"round max_iter={stng.max_iter} to a multiple of "
                f"{stng.check_interval}")

    def _make_repack_schedule(self):
        """Row capacities of ``tail_policy="repack"`` (``repack_schedule``)
        aligned to K4's row tile from its plan on ``cuda`` (shared-ρ walk),
        else to 8."""
        stng = self.settings
        align = 8
        if self._use_pallas and stng.device.type == "cuda":
            align = batched_plan(
                self.B_pad, self.Dp, stng.precision_dtype,
                self._w_dtype(stng.precision_dtype),
                stng.iter_precision, device=stng.device)["rows_per_tile"]
        return repack_schedule(self.B_pad, align)

    def _w_dtype(self, dtype):
        """Storage dtype of the W banks (bf16 under iter_precision='bf16')."""
        return torch.bfloat16 if self.settings.iter_precision == "bf16" \
            else dtype

    def _setup_shared(self, H, g, A, l, u, dtype, dev, gbar):
        stng = self.settings
        # equality detection on UNSCALED bounds; the pattern shapes the
        # shared bank, so it must be the same across the batch (and the
        # mesh's ranks)
        eqs = equality_mask(l, u, stng.eq_tol)
        eq = eqs[0]
        if not (eqs == eq[None, :]).all():
            raise ValueError(
                "equality-row pattern differs across the batch; the shared "
                "bank would be wrong — pass batched H/A (hetero mode)")
        self._same_on_every_rank(eq, "the equality-row pattern")
        self._eq_pattern = eq

        # optional Ruiz equilibration of the shared matrices, the cost
        # normalized by the batch-mean |g|
        if stng.scaling:
            self.scal = ruiz_equilibrate(H, A, gbar)
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
        self.Wt_bank = self._put(Wt, self._w_dtype(dtype))
        self._Wt_hi = self._put(Wt) if self._keep_hi else None
        self.H_dev = self._put(H)
        self.A_dev = self._put(A)
        self._set_g(g)
        self._set_bounds(l * sc.E[None, :], u * sc.E[None, :])

    def _setup_hetero(self, H, g, A, l, u, dtype, dev):
        stng = self.settings
        nx, nc, Bn = self.nx, self.nc, self.B_local
        # per-problem equality patterns from the UNSCALED bounds (row
        # scaling changes the u − l gaps), then per-problem Ruiz scaling
        eq_masks = equality_mask(l, u, stng.eq_tol)
        self._eq_pattern = None
        self.scal = (ruiz_equilibrate_batch(H, A, g) if stng.scaling
                     else identity_scaling(nx, nc))
        sc = self.scal
        Dv, Ev = np.asarray(sc.D), np.asarray(sc.E)
        H = np.reshape(sc.c, (-1, 1, 1)) * (H * Dv[..., :, None]
                                            * Dv[..., None, :])
        A = A * Ev[..., :, None] * Dv[..., None, :]
        self._unx = self._put(np.broadcast_to(Dv, (Bn, nx)))
        self._unz = self._put(np.broadcast_to(np.asarray(sc.Einv), (Bn, nc)))
        self._unlam = self._put(np.broadcast_to(
            Ev * np.reshape(sc.cinv, (-1, 1)), (Bn, nc)))
        wp, wd = residual_unscale_weights(sc, stng)
        self._w_pri = (None if wp is None
                       else self._put(np.broadcast_to(wp, (Bn, nc))))
        self._w_dua = None if wd is None else self._put(wd)

        # per-problem precision-aware ρ caps on the SCALED A, in one batched
        # power iteration, and the per-problem ρ⃗ ladders they induce
        caps = (auto_rho_cap_batch(A, stng.eps_abs, dtype, nx)
                if stng.rho_cap == "auto"
                else np.full(Bn, float(stng.rho_cap)))
        self.rho_cap = caps
        # the eps floor of the update_settings guard, while the scaled A
        # stack is at hand (keeping it would pin B·nc·nx fp64): the largest
        # over the whole batch, every rank's problems
        self._eps_floor = _hetero_eps_floor(caps, A, dtype, nx)
        if self._group is not None:
            t = torch.tensor([self._eps_floor], dtype=torch.float64,
                             device=dev)
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self._group)
            self._eps_floor = float(t.item())
        self._rho_eff_np = effective_rho_ladder_batch(self.rhos_np, eq_masks,
                                                      caps)
        self._rho_eff = (self._put(self._rho_eff_np) if stng.alpha != 1.0
                         else None)
        self._check_bank_memory(len(self.rhos_np), dtype)
        if self._bank_build == "device":
            self._build_hetero_banks_device(H, A, eq_masks, caps, dtype, dev)
        else:
            self._build_hetero_banks(H, A, eq_masks, caps, dtype, dev)
        self.H_dev = self._put(H)
        self.A_dev = self._put(A)
        self._set_g(g)
        self._set_bounds(l * Ev, u * Ev)

    def _build_hetero_banks(self, H, A, eq_masks, caps, dtype, dev):
        """Every problem's bank in fp64 on the host, over chunks of
        ``_BUILD_CHUNK`` problems in one loop: the native builder per
        problem where it builds and alpha = 1 (as the JAX package picks
        it), else ``build_banks_np_batch`` per chunk (equal to each
        problem's own ``build_bank_np``). W goes straight into a buffer of
        the iteration dtype: the fp64 (B, N, Dp, Dp) stack is never formed
        (2.4 GB at B=1024, Dp=128). ``_B_np`` keeps the fp64 bias masters
        (B, N, D, nx): their rows beyond D would be zero."""
        stng = self.settings
        D, Dp, Bn = self.D, self.Dp, self.B_local
        N = len(self.rhos_np)
        Wt = np.zeros((Bn, N, Dp, Dp), dtype=np.float64
                      if dtype == torch.float64 else np.float32)
        self._B_np = np.empty((Bn, N, D, self.nx))
        use_native = stng.alpha == 1.0 and native.available()
        zero_g = np.zeros(self.nx)

        for i in range(0, Bn, _BUILD_CHUNK):
            rows = slice(i, min(i + _BUILD_CHUNK, Bn))
            if use_native:
                for j in range(rows.start, rows.stop):
                    W, Bm, _ = native.build_bank(H[j], A[j], zero_g,
                                                 eq_masks[j], self.rhos_np,
                                                 stng.sigma, rho_cap=caps[j])
                    Wt[j, :, :D, :D] = np.swapaxes(W, 1, 2)
                    self._B_np[j] = Bm
                continue
            W, Bm = build_banks_np_batch(H[rows], A[rows], eq_masks[rows],
                                         self.rhos_np, stng.sigma,
                                         alpha=float(stng.alpha),
                                         rho_caps=caps[rows])
            Wt[rows, :, :D, :D] = np.swapaxes(W, 2, 3)
            self._B_np[rows] = Bm
        Wt = torch.from_numpy(Wt)
        self.Wt_bank = Wt.to(device=dev, dtype=self._w_dtype(dtype))
        self._Wt_hi = (Wt.to(device=dev, dtype=dtype) if self._keep_hi
                       else None)

    def _build_hetero_banks_device(self, H, A, eq_masks, caps, dtype, dev):
        """Every problem's bank in one pass of batched fp64 torch linear
        algebra on ``dev`` (``build_bank_torch``), transposed and zero-padded
        to Dp there (padded lanes stay exactly 0). The B banks stay on the
        device in fp64, padded to (B, N, Dp, nx): the bias masters
        ``_B_dev`` that ``_set_g`` forms every bias from."""
        stng = self.settings
        D, Dp = self.D, self.Dp
        W, Bm = build_bank_torch(H, A, eq_masks, self.rhos_np, stng.sigma,
                                 alpha=float(stng.alpha), rho_caps=caps,
                                 device=dev)
        shape = W.shape[:2]
        self.Wt_bank = torch.zeros(shape + (Dp, Dp), device=dev,
                                   dtype=self._w_dtype(dtype))
        self.Wt_bank[..., :D, :D] = W.transpose(-1, -2)
        self._Wt_hi = None
        if self._keep_hi:
            self._Wt_hi = torch.zeros(shape + (Dp, Dp), device=dev,
                                      dtype=dtype)
            self._Wt_hi[..., :D, :D] = W.transpose(-1, -2)
        del W
        self._B_dev = torch.zeros(shape + (Dp, self.nx), device=dev,
                                  dtype=torch.float64)
        self._B_dev[..., :D, :] = Bm

    def _check_bank_memory(self, n_rho: int, dtype):
        """Fail fast when the per-problem banks would not fit the device.

        The device holds B·N·(Dp²·w + Dp·s) bytes of banks and biases (w, s
        the W bank's and the state's element sizes; the fp32 polish copy of
        a bf16 bank adds Dp²·s): ~1.2 GB at B=1024, N=18, Dp=128 in fp32. A
        device build adds its fp64 B masters, B·N·Dp·nx·8 bytes (0.94 GB at
        B=1024, N=18, Dp=128, nx=50).
        The cap is 3/4 of the card's memory on cuda (the rest holds the
        states, the solve's temporaries and PyTorch's cache), a fixed 8 GiB
        on the CPU (``_CPU_BANK_CAP``); ``RELUQP_MAX_BANK_BYTES`` overrides
        both. It is per device: under a mesh each rank counts its own
        problems' banks.
        """
        dev = self.settings.device
        env = os.environ.get("RELUQP_MAX_BANK_BYTES")
        if env is not None:
            cap = int(float(env))
        elif dev.type == "cuda":
            cap = torch.cuda.get_device_properties(dev).total_memory * 3 // 4
        else:
            cap = _CPU_BANK_CAP
        bs = torch.finfo(dtype).bits // 8
        w_bs = torch.finfo(self._w_dtype(dtype)).bits // 8
        if self._keep_hi:
            w_bs += bs
        dp = self.Dp
        total = self.B_local * n_rho * (dp * dp * w_bs + dp * bs)
        if self._bank_build == "device":
            total += self.B_local * n_rho * dp * self.nx * 8
        if total > cap:
            shards = (f", {self._size} mesh shards" if self._size > 1
                      else "")
            raise ValueError(
                f"heterogeneous bank needs ~{total / 2**30:.1f} GiB per "
                f"device on {dev} (B={self.B_n}, N_rho={n_rho}, D={self.D}"
                f"{shards}) which exceeds the {cap / 2**30:.1f} GiB cap — "
                "reduce the batch size, split it over (more) devices with "
                "mesh=, or raise RELUQP_MAX_BANK_BYTES")

    def _set_g(self, g):
        """The scaled G and the per-rung bias ``b_k = B_k g`` from an fp64
        product: (N, B_pad, Dp) for the shared bank (padded rows zero),
        (B, N, Dp) for per-problem banks — on the host from ``_B_np``, or on
        the device from a device build's ``_B_dev``."""
        sc = self.scal
        if self.hetero:
            g_s = np.reshape(sc.c, (-1, 1)) * (g * sc.D)
            self.G = self._put(g_s)
            if self._B_dev is not None:
                g64 = self._put(g_s, torch.float64)
                self.bias_all = torch.matmul(
                    self._B_dev, g64[:, None, :, None])[..., 0].to(
                        self.settings.precision_dtype)
                return
            bias = np.zeros((self.B_local, len(self.rhos_np), self.Dp))
            bias[:, :, :self.D] = np.matmul(self._B_np,
                                            g_s[:, None, :, None])[..., 0]
            self.bias_all = self._put(bias)
            return
        g_pad = np.zeros((self.B_pad, self.nx))
        g_pad[:self.B_local] = sc.c * (g * sc.D[None, :])
        self.G = self._put(g_pad)
        self.bias_all = self._put(
            np.matmul(g_pad[None], np.swapaxes(self._B_np, 1, 2)))

    def _set_bounds(self, l_s, u_s):
        # padding (extra lanes AND extra batch rows) is ±inf, inert; the
        # clamp is active only on the z segment [nx, nx + nc)
        lo = np.full((self.B_pad, self.Dp), -np.inf)
        hi = np.full((self.B_pad, self.Dp), np.inf)
        lo[:self.B_local, self.nx:self.nx + self.nc] = l_s
        hi[:self.B_local, self.nx:self.nx + self.nc] = u_s
        self.lo = self._put(lo)
        self.hi = self._put(hi)

    # ------------------------------------------------------------------ #
    def _caller_rows(self) -> int:
        """Rows of the batch-led arrays the caller passes: this rank's with
        ``process_local``, else the whole batch."""
        return self.B_local if self._process_local else self.B_n

    def update(self, g=None, l=None, u=None):
        """Refresh the batched problem vectors (UNSCALED units); a g update
        recomputes every rung's bias in fp64 on the host. A bound update may
        not change any problem's equality-row pattern (it shapes the
        bank). Under a mesh, the whole batch's rows, or this rank's with
        ``process_local``."""
        self._check_ready()
        t0 = time.perf_counter()
        sc = self.scal
        eB, rows = self._caller_rows(), self._rows
        if g is not None:
            g = np.asarray(g, dtype=np.float64)
            if g.shape != (eB, self.nx):
                raise ValueError(f"g must be ({eB}, {self.nx})")
            self._g_np = g.copy()
            self._set_g(g[rows])
        if l is not None or u is not None:
            l_np = self._l_np if l is None else np.asarray(l, np.float64)
            u_np = self._u_np if u is None else np.asarray(u, np.float64)
            if l_np.shape != (eB, self.nc) or u_np.shape != (eB, self.nc):
                raise ValueError(f"l/u must be ({eB}, {self.nc})")
            eqs = equality_mask(l_np, u_np, self.settings.eq_tol)
            if self._eq_pattern is not None:
                if not (eqs == self._eq_pattern[None, :]).all():
                    raise ValueError(
                        "bound update changes the equality-row pattern baked "
                        "into the shared bank — re-run setup()")
            elif not (eqs == equality_mask(self._l_np, self._u_np,
                                           self.settings.eq_tol)).all():
                raise ValueError(
                    "bound update changes a problem's equality-row pattern "
                    "baked into its bank — re-run setup()")
            self._l_np, self._u_np = l_np.copy(), u_np.copy()
            E = np.asarray(sc.E)
            self._set_bounds(l_np[rows] * E, u_np[rows] * E)
        _sync(self.settings.device)
        self.info.update_time = time.perf_counter() - t0

    def update_matrices(self, H=None, A=None):
        """Replace H and/or A, re-factorizing the bank(s) at one setup's
        cost while keeping the warm state (carried in UNSCALED units), the
        ladder position and the settings. Shared ``(nx, nx)``/``(nc, nx)``
        or per-problem ``(B, nx, nx)``/``(B, nc, nx)`` matrices; a batched
        one switches a shared batch to the heterogeneous regime, where
        every problem resumes at the old shared ladder index. Under a mesh
        the whole batch's rows, or this rank's with ``process_local``: each
        rank re-factorizes only its own problems' banks."""
        self._check_ready()
        if H is None and A is None:
            return
        if self._H_np is None:
            raise ValueError(
                "update_matrices needs the fp64 master problem data, which "
                "this solver (loaded from a checkpoint written without them) "
                "does not carry — re-run setup with the full problem instead")
        t0 = time.perf_counter()
        old = self.scal
        nx, nc, Bn = self.nx, self.nc, self.B_local
        Y = self.Y[:Bn].detach().cpu().double().numpy()
        z_s = Y[:, nx:nx + nc]
        last = Y[:, nx + nc:nx + 2 * nc]
        if self.settings.alpha != 1.0:
            last = self._rho_vec_rows() * (last - z_s)   # p → λ
        x_u = Y[:, :nx] * old.D
        z_u = z_s * old.Einv
        lam_u = last * old.E * np.reshape(old.cinv, (-1, 1))
        old_mode = self.rho_mode
        old_ind = self.rho_ind.detach().cpu().numpy()
        stng = self.settings
        tp = self.tail_policy
        if any(m is not None and np.ndim(m) == 3 for m in (H, A)):
            tp = "dense"   # shared → hetero switch: repack unsupported
        self.setup(self._H_np if H is None else H, self._g_np,
                   self._A_np if A is None else A, self._l_np, self._u_np,
                   rho_mode=self._rho_mode_req, mesh=self.mesh,
                   axis_name=self.axis_name, bank_build=self._bank_build,
                   process_local=self._process_local, tail_policy=tp,
                   **{k: getattr(stng, k) for k in SETTINGS_FIELDS})
        # the ladder position BEFORE the warm state: under alpha != 1 the p
        # slot is encoded against the current rung
        dev = self.settings.device
        if self.rho_mode == old_mode:
            self.rho_ind = torch.as_tensor(old_ind.astype(np.int32),
                                           device=dev)
        elif self.rho_mode == "per_problem":
            # shared → hetero: every problem resumes at the old shared
            # index (the reverse switch cannot keep per-problem positions;
            # the fresh setup's index stands)
            self.rho_ind = torch.full((self.B_pad,), int(old_ind),
                                      dtype=torch.int32, device=dev)
        self._warm_local(x_u, z_u, lam_u)
        self.info.update_time = time.perf_counter() - t0

    def _warn_eps_floor(self, eps_new: float) -> None:
        """Warn when eps_abs is tightened past the frozen caps' floor (the
        largest per-problem floor of a heterogeneous batch)."""
        if self.hetero:
            floor = self._eps_floor
        else:
            cap = float(self.rho_cap)
            if not np.isfinite(cap):
                return
            if self._sigma_max_sq is None:
                self._sigma_max_sq = sigma_max_sq(self._A_scaled_np)
            floor = certifiable_eps_floor(cap, self._sigma_max_sq,
                                          self.settings.precision_dtype,
                                          self.nx)
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

    def _shared_runner(self):
        """K4's runner on the lane-padded shared-ρ layout, else the plain
        runner the loop picks (``None``). Looked up at solve time."""
        return pallas_batched_chunk_runner if self._use_pallas else None

    def _done0(self):
        """Inert padded rows start done (None when there are none)."""
        if self.B_pad == self.B_local:
            return None
        return torch.arange(self.B_pad,
                            device=self.settings.device) >= self.B_local

    def solve(self) -> BatchResults:
        """Solve the whole batch from the current (warm) state."""
        self._check_ready()
        t0 = time.perf_counter()
        if self.hetero:
            runner = (pallas_hetero_chunk_runner if self._hetero_pallas
                      else None)
            res = solve_batched_hetero(
                self.Wt_bank, self.bias_all, self.rhos, self.H_dev,
                self.A_dev, self.G, self.lo, self.hi, self.Y, self.rho_ind,
                self._Wt_hi, self._rho_eff, self._w_pri, self._w_dua,
                chunk_runner=runner, group=self._group,
                _graphs=self._window_graphs, **self._solve_kw())
        elif self._repack_sched is not None and len(self._repack_sched) > 1:
            kw = self._solve_kw()
            kw.pop("refine")   # repack stages are single-phase
            res = solve_batched_shared_repack(
                self.Wt_bank, self.bias_all, self.rhos, self.H_dev,
                self.A_dev, self.G, self.lo, self.hi, self.Y, self.rho_ind,
                self._done0(), self._rho_eff, self._w_pri, self._w_dua,
                schedule=self._repack_sched, rho_mode=self.rho_mode,
                chunk_runner=self._shared_runner(),
                _graphs=self._window_graphs, **kw)
        else:
            res = solve_batched_shared(
                self.Wt_bank, self.bias_all, self.rhos, self.H_dev,
                self.A_dev, self.G, self.lo, self.hi, self.Y, self.rho_ind,
                self._done0(), self._Wt_hi, self._rho_eff, self._w_pri,
                self._w_dua, rho_mode=self.rho_mode,
                chunk_runner=self._shared_runner(), group=self._group,
                _graphs=self._window_graphs, **self._solve_kw())
        self._fill_results(res, t0)
        if not self.settings.warm_starting:
            self.clear_primal_dual()
        return self.results

    def _fill_results(self, res: BatchSolveResult, t0: float):
        self.Y = res.Y
        self.rho_ind = res.rho_ind
        nx, nc, Bn = self.nx, self.nc, self.B_local
        f64 = torch.float64
        z_s = res.Y[:Bn, nx:nx + nc]
        last = res.Y[:Bn, nx + nc:nx + 2 * nc]
        if self.settings.alpha != 1.0:
            # λ = ρ⃗(p − z) at each problem's final rung
            last = self._rho_eff_at(res.rho_ind) * (last - z_s)
        x, z, lam = (res.Y[:Bn, :nx] * self._unx, z_s * self._unz,
                     last * self._unlam)
        if res.stats is not None and self._group is None:
            # read with the solve's result bundle: no second read
            host = res.stats[:, :Bn]
            stats = None
        else:
            rungs = torch.broadcast_to(res.rho_ind, res.iters.shape)
            stats = torch.stack([res.iters.to(f64), res.status.to(f64),
                                 res.pri_res.to(f64), res.dua_res.to(f64),
                                 res.rho_estimate.to(f64),
                                 rungs.to(f64)])[:, :Bn]
        if self._group is not None:
            # every rank's rows, in rank order: ONE all-gather per solve
            dt = x.dtype
            rows = gather_rows(torch.cat([stats.T, x.to(f64), z.to(f64),
                                          lam.to(f64)], dim=1), self._group)
            stats = rows[:, :6].T
            x, z, lam = (rows[:, 6:6 + nx].to(dt),
                         rows[:, 6 + nx:6 + nx + nc].to(dt),
                         rows[:, 6 + nx + nc:].to(dt))
        n_total, n_fast = res.n_iter_total, res.n_iter_fast
        if res.out is not None:
            # the gathered stats and the loop's result bundle: one read
            both = torch.cat([stats.reshape(-1), res.out[:2]]).cpu().numpy()
            host = both[:-2].reshape(6, -1)
            n_total, n_fast = int(both[-2]), int(both[-1])
        elif stats is not None:
            # one bulk device→host read of the per-problem stats
            host = stats.cpu().numpy()
        run_time = time.perf_counter() - t0
        # a fresh BatchInfo per solve: results held by the caller do not
        # change under a later solve
        info = dataclasses.replace(self.info)
        info.iter = host[0].astype(np.int32)
        info.status_code = host[1].astype(np.int32)
        info.status = info.status_code == 1
        info.pri_res, info.dua_res, info.rho_estimate = host[2], host[3], \
            host[4]
        info.rho_ind = host[5].astype(np.int32)
        info.n_iter_total = int(n_total)
        info.n_iter_fast = int(n_fast)
        info.obj_val = None   # computed on demand by objective()
        info.run_time = run_time
        info.solve_time = info.update_time + run_time
        self.info = info
        self.results = BatchResults(x=x, z=z, lam=lam, info=info)

    def objective(self) -> np.ndarray:
        """Per-problem objective ½xᵀHx + gᵀx in UNSCALED units: the whole
        batch's (B,) on every rank under a mesh (one all-gather)."""
        x = self.Y[:self.B_local, :self.nx]   # scaled iterate
        G = self.G[:self.B_local]
        Hx = (torch.bmm(self.H_dev, x[:, :, None])[:, :, 0] if self.hetero
              else x @ self.H_dev.T)
        obj_s = 0.5 * (x * Hx).sum(-1) + (G * x).sum(-1)
        obj = obj_s.detach().cpu().double().numpy() * self.scal.cinv
        if self._group is None:
            return obj
        t = torch.as_tensor(obj, device=self.settings.device)
        return gather_rows(t, self._group).cpu().numpy()

    def local_rows(self, arr) -> np.ndarray:
        """Host copy of THIS rank's rows of a batch-led result (e.g.
        ``results.x``, ``info.iter``): the whole batch without a mesh."""
        a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
             else np.asarray(arr))
        per = self.B_local
        if self.mesh is None:
            return a.copy()
        return a[self._rank * per:(self._rank + 1) * per].copy()

    # ------------------------------------------------------------------ #
    def _rho_eff_at(self, rho_ind):
        """(1, nc) or (Bn, nc) effective ρ⃗ at the given rung(s)."""
        if self.hetero:
            rows = torch.arange(self.B_local, device=rho_ind.device)
            return self._rho_eff[rows, rho_ind[:self.B_local].long()]
        rv = self._rho_eff.index_select(0, rho_ind.reshape(-1).long())
        return rv if rv.shape[0] == 1 else rv[:self.B_local]

    def _rho_vec_rows(self) -> np.ndarray:
        """(Bn, nc) per-problem ρ⃗ at the current ladder indices (host)."""
        ind = np.broadcast_to(self.rho_ind.detach().cpu().numpy(),
                              (self.B_pad,))[:self.B_local]
        if self.hetero:
            return self._rho_eff_np[np.arange(self.B_local), ind]
        return self._rho_eff_np[ind]

    def warm_start(self, x=None, z=None, lam=None):
        """Inject primal/dual state (UNSCALED units, (B, ·) rows: the whole
        batch's under a mesh, this rank's with ``process_local``)."""
        self._check_ready()
        pick = lambda a: (None if a is None
                          else np.asarray(a, np.float64)[self._rows])
        self._warm_local(pick(x), pick(z), pick(lam))

    def _warm_local(self, x, z, lam):
        """``warm_start`` on this rank's rows."""
        stng = self.settings
        sc = self.scal
        nx, nc, Bn = self.nx, self.nc, self.B_local
        put = self._put
        # the scalings are (n,) shared or (B, n) per problem, c a scalar or
        # (B,)
        c_col = np.reshape(sc.c, (-1, 1))
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
                lam_s = put(np.asarray(lam, np.float64) * (c_col * sc.Einv))
            Y[:Bn, nx + nc:nx + 2 * nc] = z_s + lam_s / rv
            self.Y = Y
            return
        if x is not None:
            Y[:Bn, :nx] = put(np.asarray(x, np.float64) * sc.Dinv)
        if z is not None:
            Y[:Bn, nx:nx + nc] = put(np.asarray(z, np.float64) * sc.E)
        if lam is not None:
            Y[:Bn, nx + nc:nx + 2 * nc] = put(
                np.asarray(lam, np.float64) * (c_col * sc.Einv))
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
        shared walk, (B,) per problem and in the heterogeneous regime), e.g.
        taken from another implementation. Under a mesh the whole batch's
        rows, or this rank's with ``process_local``."""
        self._check_ready()
        Y_np = (Y.detach().cpu().double().numpy() if isinstance(Y, torch.Tensor)
                else np.asarray(Y, np.float64))
        eB = self._caller_rows()
        if Y_np.ndim != 2 or Y_np.shape[0] < eB \
                or Y_np.shape[1] not in (self.D, self.Dp):
            raise ValueError(f"state must be (B={eB}, D={self.D} or "
                             f"Dp={self.Dp}), got {Y_np.shape}")
        ind = np.asarray(rho_ind, np.int64).reshape(-1)
        want = 1 if self.rho_mode == "shared" else eB
        if ind.size < want or ((ind < 0) | (ind >= len(self.rhos_np))).any():
            raise ValueError(f"rho_ind {rho_ind} is off the ladder or the "
                             "batch")
        Y_np = Y_np[:eB][self._rows]
        if ind.size >= eB:
            ind = ind[:eB][self._rows]
        full = np.zeros((self.B_pad, self.Dp))
        full[:self.B_local, :self.D] = Y_np[:, :self.D]
        self.Y = self._put(full)
        if self.rho_mode == "shared":
            self.rho_ind = torch.tensor(int(ind[0]), dtype=torch.int32,
                                        device=self.settings.device)
        else:
            r = np.full((self.B_pad,), ind[0], np.int32)
            r[:self.B_local] = ind[:self.B_local]
            self.rho_ind = torch.as_tensor(r, device=self.settings.device)

    def _check_ready(self):
        if not self._ready:
            raise RuntimeError("call setup() first")
