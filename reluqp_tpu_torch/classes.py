"""Data model of the PyTorch ReLU-QP solver.

``QP`` keeps a float64 numpy master copy of the problem (the bank is
factorized on the host in fp64) plus tensors in the iteration dtype on the
solver's device. ``Settings`` holds every knob with its validation;
``Info``/``Results`` are plain records filled after each solve.

Devices: every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``. Without a GPU and without an explicit CPU device,
``Settings`` raises; it never falls back to the CPU silently.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["QP", "Settings", "Info", "Results", "as_dtype",
           "resolve_device", "SETTINGS_FIELDS"]


_DTYPE_ALIASES = {
    "float32": torch.float32,
    "f32": torch.float32,
    "fp32": torch.float32,
    "single": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "fp64": torch.float64,
    "double": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def as_dtype(precision: Any) -> torch.dtype:
    """Normalize a user-facing precision spec to a torch dtype."""
    if isinstance(precision, torch.dtype):
        if precision not in _DTYPE_ALIASES.values():
            raise ValueError(f"Unknown precision {precision!r}")
        return precision
    if isinstance(precision, str):
        key = precision.lower()
        if key not in _DTYPE_ALIASES:
            raise ValueError(f"Unknown precision {precision!r}")
        return _DTYPE_ALIASES[key]
    try:
        name = np.dtype(precision).name
    except TypeError:
        raise ValueError(f"Unknown precision {precision!r}") from None
    if name not in _DTYPE_ALIASES:
        raise ValueError(f"Unknown precision {precision!r}")
    return _DTYPE_ALIASES[name]


def resolve_device(device) -> torch.device:
    """``None`` means ``cuda``; a CUDA device without a GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: pass device='cpu' to run on the "
            "CPU (the solver never falls back to it on its own)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _to_np(x, dtype=np.float64) -> np.ndarray:
    """Accept numpy / torch / list inputs, return fp64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=dtype)


class QP:
    """Problem container for  min ½xᵀHx + gᵀx  s.t.  l ≤ Ax ≤ u."""

    def __init__(self, H, g, A, l, u, precision=torch.float32,
                 device="cpu"):
        dtype = as_dtype(precision)
        self.H_np = _to_np(H)
        self.g_np = _to_np(g).reshape(-1)
        self.A_np = _to_np(A)
        self.l_np = _to_np(l).reshape(-1)
        self.u_np = _to_np(u).reshape(-1)

        if self.H_np.ndim != 2 or self.H_np.shape[0] != self.H_np.shape[1]:
            raise ValueError(f"H must be square, got {self.H_np.shape}")
        if self.A_np.ndim != 2 or self.A_np.shape[1] != self.H_np.shape[0]:
            raise ValueError(
                f"A must be (nc, nx) with nx={self.H_np.shape[0]}, "
                f"got {self.A_np.shape}")

        self.nx = int(self.H_np.shape[0])
        self.nc = int(self.A_np.shape[0])
        if self.g_np.shape != (self.nx,):
            raise ValueError(
                f"g must have shape ({self.nx},), got {self.g_np.shape}")
        if self.l_np.shape != (self.nc,) or self.u_np.shape != (self.nc,):
            raise ValueError("l/u must have shape (nc,)")

        self.dtype = dtype
        put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.H = put(self.H_np)
        self.g = put(self.g_np)
        self.A = put(self.A_np)
        self.l = put(self.l_np)
        self.u = put(self.u_np)


@dataclasses.dataclass
class Settings:
    """All solver knobs.

    ``adaptive_rho_interval`` is the number of ITERATIONS between ρ-ladder
    updates, rounded up to the ``check_interval`` cadence; 0 or anything
    ≤ ``check_interval`` means every check.
    """

    verbose: bool = False
    warm_starting: bool = True
    # Modified Ruiz equilibration (utils/scaling.py): scales the problem at
    # setup, iterates on the scaled problem, unscales x/z/λ/objective.
    scaling: bool = False
    # False (OSQP's default): residuals, the ρ estimator and Info residuals
    # are UNSCALED. True: check the scaled residuals.
    scaled_termination: bool = False
    rho: float = 0.1
    rho_min: float = 1e-6
    rho_max: float = 1e6
    sigma: float = 1e-6
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 1
    adaptive_rho_tolerance: float = 5.0
    max_iter: int = 4000
    eps_abs: float = 1e-3
    eq_tol: float = 1e-6
    check_interval: int = 25
    # OSQP-style infeasibility certificates at every check.
    check_infeasibility: bool = False
    eps_prim_inf: float = 1e-4
    eps_dual_inf: float = 1e-4
    # Jump to the ladder rung nearest the ρ estimate instead of ±1.
    rho_jump: bool = False
    # ADMM over-relaxation; alpha≠1 switches the stacked state to the
    # [x; z; p] parametrization. Bank-invalidating, range (0, 2).
    alpha: float = 1.0
    # Precision of the iteration product y ← clip(y Wᵀ + b) only;
    # residuals and ρ estimates always run in the storage dtype at full
    # precision:
    #   "highest" -> plain fp32 (no TF32)
    #   "high"    -> bf16 hi/lo split of W and y, lo·lo term dropped
    #   "default" -> bf16-rounded inputs, fp32 accumulation
    #   "bf16"    -> like "default" AND the W bank is stored in bf16
    iter_precision: str = "highest"
    # Two-phase refine for reduced iter_precision: fast phase until
    # convergence or stall, then "highest" to the true tolerance.
    refine: bool = True
    # Precision-aware cap on the per-row effective ρ
    # (core.bank.auto_rho_cap). Bank-invalidating.
    rho_cap: Any = "auto"
    # torch device; None means cuda.
    device: Optional[Any] = None
    precision: Any = "float32"
    # Iteration backend:
    #   "auto"/"pallas" -> chunk kernel K1 (CUDA kernel on cuda, its plain
    #                      torch version on cpu)
    #   "xla"           -> the plain torch chunk runner
    #   "fused"         -> whole-solve kernel K3 (not ported yet: raises)
    backend: str = "auto"

    def __post_init__(self):
        self.precision_dtype = as_dtype(self.precision)
        if self.check_interval < 1:
            raise ValueError("check_interval must be >= 1")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if self.adaptive_rho_tolerance <= 1.0:
            raise ValueError("adaptive_rho_tolerance must be > 1")
        if self.adaptive_rho_interval < 0:
            raise ValueError("adaptive_rho_interval must be >= 0")
        if not (0.0 < self.alpha < 2.0):
            raise ValueError("alpha must be in (0, 2)")
        if isinstance(self.rho_cap, str):
            if self.rho_cap != "auto":
                raise ValueError(
                    f"rho_cap must be 'auto' or a positive float, got "
                    f"{self.rho_cap!r}")
        elif not (float(self.rho_cap) > 0.0):
            raise ValueError("rho_cap must be > 0")
        if self.backend not in ("auto", "xla", "pallas", "fused"):
            raise ValueError(f"Invalid backend {self.backend!r}")
        if self.iter_precision not in ("highest", "high", "default", "bf16"):
            raise ValueError(
                f"Invalid iter_precision {self.iter_precision!r}")
        self.device = resolve_device(self.device)


# Every Settings field name: the single source for code that must carry a
# full settings snapshot (update_matrices rebuilds).
SETTINGS_FIELDS = tuple(f.name for f in dataclasses.fields(Settings))


@dataclasses.dataclass
class Info:
    """Solve metadata."""

    iter: Optional[int] = None
    status: Optional[str] = None
    obj_val: Optional[float] = None
    pri_res: Optional[float] = None
    dua_res: Optional[float] = None
    setup_time: float = 0.0
    solve_time: float = 0.0
    update_time: float = 0.0
    run_time: float = 0.0
    rho_estimate: Optional[float] = None


@dataclasses.dataclass
class Results:
    """Solve results: ``x``/``z``/``lam`` are tensors in the iteration
    dtype on the solver's device."""

    x: Optional[torch.Tensor] = None
    z: Optional[torch.Tensor] = None
    lam: Optional[torch.Tensor] = None
    info: Optional[Info] = None
