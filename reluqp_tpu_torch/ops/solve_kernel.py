"""Residual operator, the whole-solve kernel K3 and the whole-rollout
kernel K2.

- ``build_residual_operator``: the one-matmul residual check. With
  lane-aligned segment padding,

      y @ M_res = [A x | z | H x | Aᵀ λ]     M_res (Dp, R), R = 2·ncp + 2·nxp

  built from rows ``[[Aᵀ,0,H,0],[0,I,0,0],[0,0,0,A]]`` (zero rows in the
  padding keep every segment exact).
- ``full_solve``: one whole solve (check windows, residuals, the ρ walk,
  the exit at eps, and the options of ``backend="fused"``: alpha ≠ 1,
  infeasibility certificates, two-phase refine, verbose, a state-affine
  bias, the ``max_iter % check_interval`` tail) in ONE launch of the
  hand-written CUDA kernel ``csrc/full_solve.cu`` for CUDA tensors, or of
  the plain torch version ``full_solve_ref`` for CPU tensors. Its extra
  operands come from ``build_alpha_operand`` / ``build_infeas_operand``.
- ``full_rollout``: T warm-started MPC control steps in ONE launch of the
  hand-written CUDA kernel ``csrc/solve_kernel.cu`` for CUDA tensors, or of
  the plain torch version ``full_rollout_ref`` for CPU tensors.

- ``full_rollout_batched``: K2 for a B-plant scenario ensemble, T steps in
  ONE launch of the hand-written CUDA kernel ``csrc/rollout_batched.cu``
  (K6) for CUDA tensors, or of ``full_rollout_batched_ref`` for CPU
  tensors.

A CUDA tensor never reaches a plain version: the kernel runs or the call
raises. ``full_solve.launches``, ``full_rollout.launches`` and
``full_rollout_batched.launches`` count kernel launches. K2 and K3 share
their device solve loop (``csrc/solve_loop.cuh``); see the sources'
headers for the design.

Numerics follow the TPU kernels they replace: every product (refresh, bias,
iteration, residual, selector, certificate, control, plant) is rounded to
fp32, as the TPU kernels' fp32-result dots are, and then cast to the state
dtype (a no-op in fp32). K2 sums each product in the state dtype; K3 sums
in fp64 in the fixed order of ``_lane_dot``, which its kernel follows, so
the two agree bit for bit; K6 sums in fp64 in input order, and its plain
version through cuBLAS (``_dot64``), which sums in that order too at the
widths measured (Dp <= 640 on the H100), so there the two agree bit for
bit, elsewhere but where a product lies within fp64 rounding of an fp32
tie. The residual maxima, the ρ estimate, the ladder
``rhos`` and the tolerances are fp32 in an fp64 run too.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.iteration import rho_update_stride
from .check_window import (_RUNNING, _TINY, STATUS_DUAL_INFEASIBLE,
                           STATUS_MAX_ITER, STATUS_PRIMAL_INFEASIBLE,
                           STATUS_SOLVED)
from .fused_step import _DTYPE_CODE, _bf16, device_guard, pad_dim

__all__ = ["AlphaOperand", "InfeasOperand", "FullSolveOperand",
           "build_residual_operator", "build_alpha_operand",
           "build_infeas_operand", "full_solve", "full_solve_ref",
           "solve_plan", "k3_stage_split", "K3_STAGES", "full_rollout",
           "full_rollout_ref", "rollout_plan", "k2_stage_split", "K2_STAGES",
           "full_rollout_batched", "full_rollout_batched_ref",
           "rollout_batched_plan"]

# Iteration tiers of the rollout: "bf16" one bf16 pass, "high" the bf16x3
# split, anything else (including "default") full precision — as the TPU
# rollout kernel maps them. K3 maps them the same way.
_ROLLOUT_TIER = {"highest": 0, "default": 0, "high": 1, "bf16": 2}


def build_residual_operator(H, A, g, dp: int, dtype, w_pri=None,
                            w_dua=None, lam_segment: bool = True,
                            device="cpu"):
    """Host fp64 build of ``(M_res, g_row, nxp, ncp)``.

    Segment layout in the result row: [Ax | z | Hx | Aᵀλ] with nc, nc, nx,
    nx entries padded to ncp/ncp/nxp/nxp (multiples of 128). Optional
    ``w_pri`` (nc,) / ``w_dua`` (nx,) fold the residual unscale weights
    into the operator columns and ``g_row``. ``lam_segment=False`` drops
    the Aᵀλ segment (alpha ≠ 1, where the last y slot holds p, not λ).
    ``M_res`` (Dp, R) and ``g_row`` (1, nxp) come back as tensors of
    ``dtype`` on ``device``.
    """
    H = np.asarray(H, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64).reshape(-1)
    nx, nc = H.shape[0], A.shape[0]
    wp = np.ones(nc) if w_pri is None else np.asarray(w_pri, np.float64)
    wd = np.ones(nx) if w_dua is None else np.asarray(w_dua, np.float64)
    nxp, ncp = pad_dim(nx), pad_dim(nc)
    R = 2 * ncp + (2 * nxp if lam_segment else nxp)
    M = np.zeros((dp, R), dtype=np.float64)
    M[:nx, 0:nc] = A.T * wp[None, :]                    # → w_pri ⊙ Ax
    M[:nx, 2 * ncp:2 * ncp + nx] = H * wd[None, :]      # → w_dua ⊙ Hx
    M[nx:nx + nc, ncp:ncp + nc] = np.diag(wp)           # → w_pri ⊙ z
    if lam_segment:
        M[nx + nc:nx + 2 * nc, 2 * ncp + nxp:2 * ncp + nxp + nx] = \
            A * wd[None, :]                             # → w_dua ⊙ Aᵀλ
    g_row = np.zeros((1, nxp), dtype=np.float64)
    g_row[0, :nx] = wd * g
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return put(M), put(g_row), nxp, ncp


class AlphaOperand(NamedTuple):
    """Extra operands for the relaxed (alpha != 1) parametrization."""

    S_pz: torch.Tensor      # (Dp, ncp)  y @ S_pz = p − z
    A_w: torch.Tensor       # (ncp, nxp) w_dua-weighted A: λ @ A_w = w∘Aᵀλ
    S_sc: torch.Tensor      # (ncp, Dp)  scatter corrections into p slots
    rho_eff: torch.Tensor   # (N, 1, ncp) fp32 per-rung ρ⃗ (1.0 in the padding)


class InfeasOperand(NamedTuple):
    """Extra operands for in-kernel infeasibility certificates."""

    S_lam: torch.Tensor     # (Dp, ncp)  y @ S_lam = λ (alpha == 1; else 0-size)
    A_inf: torch.Tensor     # (ncp, nxp) UNWEIGHTED scaled A (δλ @ A_inf = Aᵀδλ)
    inv_wp: torch.Tensor    # (1, ncp) 1/w_pri (ones when unweighted)
    inv_wd: torch.Tensor    # (1, nxp) 1/w_dua
    l_nc: torch.Tensor      # (1, ncp) scaled l (0 in the padding)
    u_nc: torch.Tensor      # (1, ncp) scaled u (0 in the padding)
    fin_l: torch.Tensor     # (1, ncp) 1.0 where l finite, else 0
    fin_u: torch.Tensor     # (1, ncp) 1.0 where u finite, else 0
    g_dp: torch.Tensor      # (1, Dp) UNWEIGHTED scaled g in the x slot


class FullSolveOperand(NamedTuple):
    """Constant operands of one whole solve, prepared at setup time."""

    Wt_bank: torch.Tensor   # (N, Dp, Dp) transposed padded bank
    b_bank: torch.Tensor    # (N, Dp)
    rhos: torch.Tensor      # (N,)
    M_res: torch.Tensor     # (Dp, R) residual operator
    g_row: torch.Tensor     # (1, nxp) padded w_dua∘g
    lo: torch.Tensor        # (Dp,)
    hi: torch.Tensor        # (Dp,)
    alpha_op: Optional[AlphaOperand] = None
    infeas_op: Optional[InfeasOperand] = None


def build_alpha_operand(A, rho_eff_np, nx: int, nc: int, dp: int, nxp: int,
                        ncp: int, dtype, w_dua=None,
                        device="cpu") -> AlphaOperand:
    """Host fp64 build of the alpha != 1 selector/scatter operands.

    ``rho_eff_np``: (N, nc) per-rung effective per-row ρ
    (``core.bank.effective_rho_ladder``). Padding lanes get ρ⃗ = 1 so the
    rung-switch ratio ρ⃗_old/ρ⃗_new is exactly 1 there (d is 0 anyway).
    """
    A = np.asarray(A, dtype=np.float64)
    wd = np.ones(nx) if w_dua is None else np.asarray(w_dua, np.float64)
    S_pz = np.zeros((dp, ncp))
    S_sc = np.zeros((ncp, dp))
    j = np.arange(nc)
    S_pz[nx + nc + j, j] = 1.0     # p slot
    S_pz[nx + j, j] = -1.0         # −z slot
    S_sc[j, nx + nc + j] = 1.0
    A_w = np.zeros((ncp, nxp))
    A_w[:nc, :nx] = A * wd[None, :]
    reff = np.ones((rho_eff_np.shape[0], 1, ncp))
    reff[:, 0, :nc] = np.asarray(rho_eff_np, np.float64)
    put = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=device)
    return AlphaOperand(S_pz=put(S_pz), A_w=put(A_w), S_sc=put(S_sc),
                        rho_eff=put(reff, torch.float32))


def build_infeas_operand(A, g, l, u, nx: int, nc: int, dp: int, nxp: int,
                         ncp: int, dtype, alpha: float, w_pri=None,
                         w_dua=None, device="cpu") -> InfeasOperand:
    """Host fp64 build of the in-kernel infeasibility-certificate operands.

    The certificates test SCALED-space products, as the loop path's
    ``core.iteration.infeasibility_certificates`` does: ``inv_wp`` /
    ``inv_wd`` divide the residual-unscale weights back out of the shared
    M_res segments.
    """
    A = np.asarray(A, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64).reshape(-1)
    l = np.asarray(l, dtype=np.float64).reshape(-1)
    u = np.asarray(u, dtype=np.float64).reshape(-1)
    wp = np.ones(nc) if w_pri is None else np.asarray(w_pri, np.float64)
    wd = np.ones(nx) if w_dua is None else np.asarray(w_dua, np.float64)
    if alpha == 1.0:
        S_lam = np.zeros((dp, ncp))
        S_lam[nx + nc + np.arange(nc), np.arange(nc)] = 1.0
    else:
        S_lam = np.zeros((0, 0))   # λ comes from the alpha operand instead
    A_inf = np.zeros((ncp, nxp))
    A_inf[:nc, :nx] = A

    def row(n, vals, at=0):
        r = np.zeros((1, n))
        r[0, at:at + len(vals)] = vals
        return r

    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return InfeasOperand(
        S_lam=put(S_lam), A_inf=put(A_inf), inv_wp=put(row(ncp, 1.0 / wp)),
        inv_wd=put(row(nxp, 1.0 / wd)), l_nc=put(row(ncp, l)),
        u_nc=put(row(ncp, u)),
        fin_l=put(row(ncp, np.isfinite(l).astype(np.float64))),
        fin_u=put(row(ncp, np.isfinite(u).astype(np.float64))),
        g_dp=put(row(dp, g)))


# --------------------------------------------------------------------- #
# arithmetic shared by the plain versions of K2 and K3                   #
# --------------------------------------------------------------------- #

def _f32(v) -> float:
    """A host constant rounded to fp32, as the kernel holds it."""
    return float(np.float32(v))


def _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                    rho_max):
    eps = np.float32(eps_abs)
    return dict(eps_pri=float(eps * np.sqrt(nc).astype(np.float32)),
                eps_dua=float(eps * np.sqrt(nx).astype(np.float32)),
                tol=_f32(adaptive_rho_tolerance), rho_min=_f32(rho_min),
                rho_max=_f32(rho_max))


def _dot32(v, m):
    """``v @ m`` rounded to fp32 (the TPU kernel's fp32-result dot)."""
    return (v @ m.to(v.dtype)).float()


def _dot64(v, m):
    """``v @ m`` summed in fp64 and rounded to fp32 (K6's sums)."""
    return (v.double() @ m.double()).float()


def _lane_dot(v, m):
    """``v (1, K) @ m (K, N)`` in K3's summation order, rounded to fp32: in
    fp64, each product and each sum rounded on its own, lane l (0..31) sums
    rows l, l + 32, ... in order, then the lanes are added as a tree (lane
    l + 16 into lane l, then 8, 4, 2, 1) -- what one warp of the kernel
    does for one column, so the two agree bit for bit."""
    f64 = torch.float64
    K, n = m.shape[0], m.shape[1]
    kp = -(-K // 32) * 32
    vv = torch.zeros((kp, 1), dtype=f64, device=m.device)
    vv[:K, 0] = v.reshape(-1)
    mm = torch.zeros((kp, n), dtype=f64, device=m.device)
    mm[:K] = m
    prod = (vv * mm).reshape(kp // 32, 32, n)
    acc = prod[0]
    for k in range(1, kp // 32):
        acc = acc + prod[k]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:off] + acc[off:2 * off]
    return acc.reshape(1, n).float()


def _lane_sum(t):
    """The sum of fp32 values ``t`` in fp64, in K3's lane order, rounded
    to fp32."""
    t = t.reshape(-1)
    return _lane_dot(t, torch.ones((t.numel(), 1), dtype=torch.float64,
                                   device=t.device))[0, 0]


def _iter_product(y, w, tier: int, dot=_dot32):
    """``y @ w`` at the iteration tier, each dot by ``dot`` (rounded to
    fp32), returned in y's dtype. "high" rounds each of its three
    bf16-split passes to fp32 and adds them in fp32, as the TPU kernel
    does."""
    dt = y.dtype
    if tier == 2:
        p = dot(_bf16(y, dt), _bf16(w, dt))
    elif tier == 1:
        w = w.to(dt)
        w_h = _bf16(w, dt)
        w_l = _bf16(w - w_h, dt)
        y_h = _bf16(y, dt)
        y_l = _bf16(y - y_h, dt)
        p = (dot(y_h, w_l) + dot(y_l, w_h)) + dot(y_h, w_h)
    else:
        p = dot(y, w.to(dt))
    return p.to(dt)


def _estimate(ax, z, hx, atl, g_row, rho, c):
    """Residual maxima and the clamped ρ estimate from one check's fp32
    segments ``ax, z`` (ncp,) and ``hx, atl`` (nxp,) and the state-dtype
    ``g_row`` (nxp,): ``(pri, dua, rho_new)``, all fp32. The dual sum and
    its scale take the state dtype, as the TPU kernels promote them."""
    dt = g_row.dtype
    pri = (ax - z).abs().max()
    dua = ((hx + atl).to(dt) + g_row).abs().max()
    sp = torch.maximum(ax.abs().max(), z.abs().max())
    sd = torch.maximum(torch.maximum(hx.abs().max(), atl.abs().max()).to(dt),
                       g_row.abs().max())
    num = pri / sp.clamp_min(_TINY)
    den = dua / sd.clamp_min(_TINY)
    rho_new = torch.clamp(rho.to(dt) * torch.sqrt(num.to(dt)
                                                  / den.clamp_min(_TINY)),
                          c["rho_min"], c["rho_max"]).float()
    return pri, dua.float(), rho_new


def _rho_walk(rhos32, log_rhos, rho_new, k_idx: int, k: int, ci: int,
              stride: int, jump: bool, c) -> int:
    """The rung after one check: ±1 step or a jump to the nearest rung when
    the estimate leaves [ρ_k/τ, ρ_k·τ], only at every ``stride``-th check
    (``k`` iterations ran before this window)."""
    n_rho = rhos32.shape[0]
    rho_k = rhos32[k_idx]
    above = bool(rho_new > rho_k * c["tol"])
    below = bool(rho_new < rho_k / c["tol"])
    if jump:
        near = int(torch.argmin((log_rhos - torch.log(rho_new)).abs()))
        new_idx = near if (above or below) else k_idx
    else:
        up = above and k_idx < n_rho - 1
        dn = below and k_idx > 0 and not up
        new_idx = k_idx + int(up) - int(dn)
    if stride > 1 and ((k // ci) + 1) % stride != 0:
        new_idx = k_idx
    return new_idx


def full_rollout_ref(Wt_bank, bias_c, M_aff, rhos, M_res, g0w, gl_op, lo0,
                     hi0, S_u, Bdw, y0, x0, noise, rho_ind0, *,
                     nx: int, nc: int, nxp: int, ncp: int, nup: int,
                     nplp: int, n_steps: int, max_iter: int,
                     check_interval: int, adaptive_rho: bool,
                     adaptive_rho_tolerance: float, eps_abs: float,
                     rho_min: float, rho_max: float, rho_jump: bool = False,
                     adaptive_rho_interval: int = 1,
                     iter_precision: str = "highest"):
    """Plain torch version of K2: what the kernel computes.

    Per control step: one refresh product ``x @ GL`` gives the weighted g
    refresh, the bound shift (pre-scattered into Dp layout), Kx and Ax;
    the warm solve runs whole check windows from the carried state (the
    first window always runs) with the bias ``c_k + x @ M_aff[k]`` of the
    current rung, the one-matmul residuals, the ρ walk (±1 step or jump,
    every ``stride``-th check) and the exit at eps; then ``u = y @ S_u −
    Kx`` and ``x⁺ = Ax + u @ Bdw + noise``. A step that ends running
    reports status 0 (max_iter). Returns ``(xs (T, nplp), us (T, nup),
    stats (T, 8) fp32, y_f (Dp,))`` with stats rows ``[iters, pri, dua, ρ
    estimate, rung, status, 0, 0]``.
    """
    dt = y0.dtype
    dp = Wt_bank.shape[1]
    ci = int(check_interval)
    limit = (max_iter // ci) * ci
    stride = rho_update_stride(adaptive_rho_interval, ci)
    tier = _ROLLOUT_TIER[iter_precision]
    c = _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                        rho_max)
    rhos32 = rhos.to(torch.float32)
    log_rhos = torch.log(rhos32)
    g0w = g0w.reshape(1, nxp)
    lo0 = lo0.reshape(1, dp)
    hi0 = hi0.reshape(1, dp)
    y = y0.reshape(1, dp)
    x = x0.reshape(1, nplp)
    k_idx = int(rho_ind0)
    xs, us, stats = [], [], []
    for t in range(n_steps):
        r2 = _dot32(x, gl_op).to(dt)
        g_row = (g0w + r2[:, :nxp])[0]
        sz = r2[:, nxp:nxp + dp]
        kx = r2[:, nxp + dp:nxp + dp + nup]
        ax = r2[:, nxp + dp + nup:]
        lo, hi = lo0 + sz, hi0 + sz
        rho = rhos32[k_idx]
        k, status = 0, _RUNNING
        while True:
            w = Wt_bank[k_idx]
            b = bias_c[k_idx] + _dot32(x, M_aff[k_idx]).to(dt)
            for _ in range(ci):
                y = torch.minimum(torch.maximum(_iter_product(y, w, tier) + b,
                                                lo), hi)
            r = _dot32(y, M_res)[0]
            pri, dua, rho_new = _estimate(
                r[:ncp], r[ncp:2 * ncp], r[2 * ncp:2 * ncp + nxp],
                r[2 * ncp + nxp:], g_row, rho, c)
            if adaptive_rho:
                k_idx = _rho_walk(rhos32, log_rhos, rho_new, k_idx, k, ci,
                                  stride, rho_jump, c)
            if status < 0 and bool(pri < c["eps_pri"]) \
                    and bool(dua < c["eps_dua"]):
                status = STATUS_SOLVED
            rho = rho_new
            k += ci
            if not (status < 0 and k < limit):
                break
        status = STATUS_MAX_ITER if status < 0 else status
        v0 = _dot32(y, S_u).to(dt)
        u = v0 - kx
        x = (ax + _dot32(u, Bdw).to(dt)) + noise[t].reshape(1, nplp)
        xs.append(x[0])
        us.append(u[0])
        stats.append(torch.stack([
            torch.tensor(float(k)), pri.cpu(), dua.cpu(), rho.cpu(),
            torch.tensor(float(k_idx)), torch.tensor(float(status)),
            torch.tensor(0.0), torch.tensor(0.0)]).float())
    dev = y0.device
    empty = lambda n: torch.zeros((0, n), dtype=dt, device=dev)
    return (torch.stack(xs) if xs else empty(nplp),
            torch.stack(us) if us else empty(nup),
            (torch.stack(stats) if stats
             else torch.zeros((0, 8))).to(dev),
            y.reshape(dp).clone())


class _K2Params(ctypes.Structure):
    """Mirror of ``K2Params`` in ``csrc/solve_kernel.cu`` (same order)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "wt", "bias_c", "m_aff", "rhos", "m_res", "g0w", "gl", "lo0", "hi0",
        "s_u", "bdw", "y0", "x0", "noise", "xs", "us", "stats", "y_f",
        "yx", "px", "xx", "stamps")]
        + [(n, ctypes.c_int) for n in (
            "w_dtype", "y_dtype", "n_rho", "dp", "nxp", "ncp", "nup", "nplp",
            "n_steps", "max_iter", "ci", "rho0", "adaptive", "jump",
            "stride", "tier", "part_rows")]
        + [(n, ctypes.c_float) for n in (
            "eps_pri", "eps_dua", "tol", "rho_min", "rho_max")])


def _lib():
    from .cuda_build import load
    lib = load("solve_kernel")
    if not getattr(lib, "_k2_typed", False):
        i = ctypes.c_int
        lib.k2_full_rollout.argtypes = [ctypes.POINTER(_K2Params),
                                        ctypes.c_void_p]
        lib.k2_full_rollout.restype = i
        lib.k2_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 3
        lib.k2_plan.restype = i
        lib.k2_stamp_now.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.k2_stamp_now.restype = i
        lib.k2_error_string.argtypes = [i]
        lib.k2_error_string.restype = ctypes.c_char_p
        lib._k2_typed = True
    return lib


def _raise_cuda(lib, code: int, what: str):
    msg = lib.k2_error_string(code).decode()
    raise RuntimeError(f"K2 {what} failed: CUDA error {code} ({msg})")


def rollout_plan(dp: int, nxp: int, ncp: int, nup: int, nplp: int,
                 n_rho: int, dtype=torch.float32, w_dtype=None,
                 device=None) -> dict:
    """The launch shape of K2 on ``device`` (default the current GPU) for
    a ladder of ``n_rho`` rungs: blocks, y lanes (columns of W) per block,
    dynamic shared memory, whether every operand slab is held in shared
    memory (else streamed from L2), and the exchange: "tagged words", each
    value beside its exchange's tag in ``words_per_value`` 64-bit words (1
    in fp32, 2 in fp64), read by every block with no grid barrier but the
    launch's first, in ``scratch_bytes`` of words (``_k2_words``)."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(3)]
    with torch.cuda.device(device):
        rc = lib.k2_plan(dp, nxp, ncp, nup, nplp, n_rho, _DTYPE_CODE[dtype],
                         _DTYPE_CODE[w_dtype or dtype],
                         *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _raise_cuda(lib, rc, "plan")
    blocks, smem, resident = (v.value for v in vals)
    n_w = 2 if dtype == torch.float64 else 1
    words = sum(math.prod(s) for s in _k2_words(dp, nup, nplp, blocks, n_w))
    return {"blocks": blocks, "cols_per_block": -(-dp // blocks),
            "smem_bytes": smem, "resident": bool(resident),
            "exchange": "tagged words", "words_per_value": n_w,
            "scratch_bytes": 8 * words}


def _k2_words(dp, nup, nplp, blocks, n_w):
    """Shapes of K2's exchange words (int64; the kernel clears them): two
    slots each of y (Dp values), of the blocks' partials (``blocks`` rows
    of 8) with u (nup values) after them, and of x+ (nplp values), ``n_w``
    words a value."""
    return ((2, dp, n_w), (2, blocks * 8 + nup, n_w), (2, nplp, n_w))


def _check_operands(ops: dict, *, nxp, ncp, nup, nplp, n_steps):
    """Shapes of the rollout operands (both paths); dtypes, devices and
    contiguity are checked again for the kernel."""
    wt = ops["Wt_bank"]
    if wt.dim() != 3 or wt.shape[1] != wt.shape[2]:
        raise ValueError("K2: Wt_bank must be (N, Dp, Dp)")
    n_rho, dp = wt.shape[0], wt.shape[1]
    want = {"bias_c": (n_rho, dp), "M_aff": (n_rho, nplp, dp),
            "rhos": (n_rho,), "M_res": (dp, 2 * ncp + 2 * nxp),
            "g0w": (nxp,), "gl_op": (nplp, nxp + dp + nup + nplp),
            "lo0": (dp,), "hi0": (dp,), "S_u": (dp, nup), "Bdw": (nup, nplp),
            "y0": (dp,), "x0": (nplp,), "noise": (n_steps, nplp)}
    flat = {"rhos", "g0w", "lo0", "hi0", "y0", "x0"}
    for name, shape in want.items():
        t = ops[name]
        got = (t.numel(),) if name in flat else tuple(t.shape)
        if got != shape:
            raise ValueError(f"K2: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    return n_rho, dp


def _full_rollout_cuda(ops, rho_ind0, *, n_rho, dp, nx, nc, nxp, ncp, nup,
                       nplp, n_steps, max_iter, check_interval, adaptive_rho,
                       adaptive_rho_tolerance, eps_abs, rho_min, rho_max,
                       rho_jump, adaptive_rho_interval, iter_precision):
    y0 = ops["y0"]
    dev, dt = y0.device, y0.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"K2: state dtype {dt} is not float32/float64")
    ops = dict(ops, rhos=ops["rhos"].to(torch.float32).contiguous())
    for name, t in ops.items():
        if t.device != dev:
            raise ValueError(f"K2: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"K2: {name} must be contiguous")
        if name == "Wt_bank":
            ok = t.dtype == dt or (t.dtype == torch.bfloat16
                                   and dt == torch.float32)
        else:
            ok = t.dtype == (torch.float32 if name == "rhos" else dt)
        if not ok:
            raise ValueError(f"K2: {name} dtype {t.dtype} does not go with "
                             f"state dtype {dt}")
    xs = torch.empty((n_steps, nplp), dtype=dt, device=dev)
    us = torch.empty((n_steps, nup), dtype=dt, device=dev)
    stats = torch.empty((n_steps, 8), dtype=torch.float32, device=dev)
    if n_steps == 0:
        return xs, us, stats, y0.reshape(dp).clone()
    y_f = torch.empty((dp,), dtype=dt, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    yx, px, xx = (torch.empty(shape, dtype=torch.int64, device=dev)
                  for shape in _k2_words(dp, nup, nplp, n_sm,
                                         2 if dt == torch.float64 else 1))
    c = _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                        rho_max)
    ptr = lambda t: t.data_ptr()
    p = _K2Params(
        wt=ptr(ops["Wt_bank"]), bias_c=ptr(ops["bias_c"]),
        m_aff=ptr(ops["M_aff"]), rhos=ptr(ops["rhos"]),
        m_res=ptr(ops["M_res"]), g0w=ptr(ops["g0w"]), gl=ptr(ops["gl_op"]),
        lo0=ptr(ops["lo0"]), hi0=ptr(ops["hi0"]), s_u=ptr(ops["S_u"]),
        bdw=ptr(ops["Bdw"]), y0=ptr(y0), x0=ptr(ops["x0"]),
        noise=ptr(ops["noise"]), xs=ptr(xs), us=ptr(us), stats=ptr(stats),
        y_f=ptr(y_f), yx=ptr(yx), px=ptr(px), xx=ptr(xx),
        stamps=None if full_rollout.stamps is None
        else full_rollout.stamps.data_ptr(),
        w_dtype=_DTYPE_CODE[ops["Wt_bank"].dtype], y_dtype=_DTYPE_CODE[dt],
        n_rho=n_rho, dp=dp, nxp=nxp, ncp=ncp, nup=nup, nplp=nplp,
        n_steps=n_steps, max_iter=max_iter, ci=check_interval,
        rho0=rho_ind0, adaptive=int(bool(adaptive_rho)),
        jump=int(bool(rho_jump)),
        stride=rho_update_stride(adaptive_rho_interval, check_interval),
        tier=_ROLLOUT_TIER[iter_precision], part_rows=n_sm, **c)
    lib = _lib()
    rc = lib.k2_full_rollout(ctypes.byref(p),
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise_cuda(lib, rc, "launch")
    full_rollout.launches += 1
    return xs, us, stats, y_f


def full_rollout(Wt_bank, bias_c, M_aff, rhos, M_res, g0w, gl_op, lo0, hi0,
                 S_u, Bdw, y0, x0, noise, rho_ind0, *, nx: int, nc: int,
                 nxp: int, ncp: int, nup: int, nplp: int, n_steps: int,
                 max_iter: int, check_interval: int, adaptive_rho: bool,
                 adaptive_rho_tolerance: float, eps_abs: float,
                 rho_min: float, rho_max: float, rho_jump: bool = False,
                 adaptive_rho_interval: int = 1,
                 iter_precision: str = "highest"):
    """T warm-started MPC control steps as ONE kernel launch.

    Operands (``models.mpc._build_rollout_operators``): the transposed
    padded bank ``Wt_bank`` (N, Dp, Dp), ``bias_c`` (N, Dp), ``M_aff``
    (N, nplp, Dp), ``rhos`` (N,), ``M_res`` (Dp, 2·ncp + 2·nxp), ``g0w``
    (nxp,), ``gl_op`` (nplp, nxp + Dp + nup + nplp), ``lo0``/``hi0``
    (Dp,), ``S_u`` (Dp, nup), ``Bdw`` (nup, nplp), the start state ``y0``
    (Dp,) and plant state ``x0`` (nplp,), ``noise`` (T, nplp), and the
    start rung ``rho_ind0`` (an int). Returns ``(xs (T, nplp), us (T,
    nup), stats (T, 8), y_f (Dp,))``, see ``full_rollout_ref``. CUDA
    tensors launch the CUDA kernel (or raise); CPU tensors run
    ``full_rollout_ref``.
    """
    if max_iter % check_interval != 0:
        raise ValueError("the scan-rollout kernel requires max_iter to be a "
                         "multiple of check_interval")
    if iter_precision not in _ROLLOUT_TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")
    ops = dict(Wt_bank=Wt_bank, bias_c=bias_c, M_aff=M_aff, rhos=rhos,
               M_res=M_res, g0w=g0w, gl_op=gl_op, lo0=lo0, hi0=hi0, S_u=S_u,
               Bdw=Bdw, y0=y0, x0=x0, noise=noise)
    n_rho, dp = _check_operands(ops, nxp=nxp, ncp=ncp, nup=nup,
                                nplp=nplp, n_steps=n_steps)
    rho_ind0 = int(rho_ind0)
    if not 0 <= rho_ind0 < n_rho:
        raise ValueError(f"K2: rho_ind0 {rho_ind0} is off the ladder")
    kw = dict(nx=nx, nc=nc, nxp=nxp, ncp=ncp, nup=nup, nplp=nplp,
              n_steps=n_steps, max_iter=max_iter,
              check_interval=check_interval, adaptive_rho=adaptive_rho,
              adaptive_rho_tolerance=adaptive_rho_tolerance,
              eps_abs=eps_abs, rho_min=rho_min, rho_max=rho_max,
              rho_jump=rho_jump,
              adaptive_rho_interval=adaptive_rho_interval,
              iter_precision=iter_precision)
    if y0.is_cuda:
        with device_guard(y0.device):
            return _full_rollout_cuda(ops, rho_ind0, n_rho=n_rho, dp=dp,
                                      **kw)
    return full_rollout_ref(Wt_bank, bias_c, M_aff, rhos, M_res, g0w, gl_op,
                            lo0, hi0, S_u, Bdw, y0, x0, noise, rho_ind0,
                            **kw)


full_rollout.launches = 0
# an int64 (_K2_SLOTS,) tensor on the card, or None: the kernel's stage
# stamps (``k2_stage_split``); None on every rollout path
full_rollout.stamps = None

# block 0's stages of a K2 launch (``csrc/solve_loop.cuh``'s K3S_* and
# K2S_* slots): the operands staged (the prologue and every rung change),
# then per control step the refresh x @ GL, the bias formed, the
# iterations' products, their exchange of y, the checks' products (u's
# with them), the checks' partials exchanged, reduced and decided, the
# plant step (u gathered, x+ formed) and the exchange of x+
K2_STAGES = ("staged", "refresh", "bias", "iteration", "exchange", "check",
             "reduced", "plant", "x exchange")
_K2_SLOT = dict(staged=2, bias=3, iteration=4, exchange=5, check=6,
                reduced=7, refresh=9, plant=10, **{"x exchange": 11})
# the other slots: K3S_PRE, K3S_START, K3S_END, K2S_STEPS, K2S_SYNC_FIRST,
# K2S_SYNCS, and kK2Slots
_PRE, _START, _END, _STEPS, _SYNC_FIRST, _SYNCS, _K2_SLOTS = \
    0, 1, 8, 12, 13, 14, 15


def _graph_behind_stamp(run, stamps, stamp_now, fail):
    """``run()`` captured in a CUDA graph behind the one-thread kernel
    ``stamp_now`` that stamps the time into ``stamps``, after a warm-up
    call outside the capture."""
    run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        run()
        with torch.cuda.graph(graph, stream=side):
            rc = stamp_now(stamps.data_ptr(), side.cuda_stream)
            if rc != 0:
                fail(rc)
            run()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def k2_stage_split(run, reps: int = 20) -> dict:
    """Where one K2 launch's time goes: ``run()`` (one ``full_rollout`` on
    the card) captured in a CUDA graph behind a one-thread kernel that
    stamps the time, replayed ``reps`` times with the stage stamps on.
    Returns means over the replays: ``launch`` (µs, the stamp to the
    earliest block's start) and ``staged`` (µs, block 0's staging over the
    launch) per launch; each other stage of ``K2_STAGES`` in µs per
    control step (block 0's time in it over the launch, over the steps);
    ``step`` (µs per step: the earliest start to the latest end, less the
    staging, over the steps); ``total`` (µs, the stamp to the latest end);
    ``steps``; and block 0's grid barriers ``barriers_per_launch`` and
    ``barriers_per_warm_step`` (those after step 0, over the steps after
    it)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    stamps = torch.zeros(_K2_SLOTS, dtype=torch.int64, device=dev)
    lib = _lib()
    full_rollout.stamps = stamps
    try:
        graph = _graph_behind_stamp(
            run, stamps, lib.k2_stamp_now,
            lambda rc: _raise_cuda(lib, rc, "stamp"))
        keys = ("launch",) + K2_STAGES + ("step", "total", "steps",
                                         "barriers_per_launch",
                                         "barriers_per_warm_step")
        sums = dict.fromkeys(keys, 0.0)
        for _ in range(reps):
            stamps.zero_()
            stamps[_START] = -1     # the start slot takes the least time
            graph.replay()
            t = stamps.cpu().tolist()
            n = t[_STEPS]
            sums["launch"] += (t[_START] - t[_PRE]) / 1e3
            for name, slot in _K2_SLOT.items():
                sums[name] += t[slot] / 1e3 / (1 if name == "staged" else n)
            sums["step"] += (t[_END] - t[_START] - t[_K2_SLOT["staged"]]) \
                / 1e3 / n
            sums["total"] += (t[_END] - t[_PRE]) / 1e3
            sums["steps"] += n
            sums["barriers_per_launch"] += t[_SYNCS]
            sums["barriers_per_warm_step"] += \
                (t[_SYNCS] - t[_SYNC_FIRST]) / max(n - 1, 1)
    finally:
        full_rollout.stamps = None
    return {k: v / reps for k, v in sums.items()}


# --------------------------------------------------------------------- #
# whole-SOLVE kernel K3: one solve in one launch                         #
# --------------------------------------------------------------------- #

def _verbose_line(k: int, rho, pri, dua) -> str:
    """The per-check line of a verbose solve. Each float prints as
    ``<mantissa×100>e<exp−2>`` in integers (123e-5 == 1.23e-3), computed
    in fp32 as the kernel prints it."""
    def fmt(v):
        v32 = torch.clamp_min(v.reshape(()).float(), 1e-30)
        e = torch.floor(torch.log(v32) * _f32(1.0 / np.log(10.0)))
        mant = v32 * torch.exp(-e * _f32(np.log(10.0)))
        return int((mant * 100).to(torch.int32)), int(e) - 2

    (rm, re_), (pm, pe), (dm, de) = fmt(rho), fmt(pri), fmt(dua)
    return f"Iter: {k}, rho: {rm}e{re_}, res_p: {pm}e{pe}, res_d: {dm}e{de}"


def _certificates(y, y_prev, lam, lam_prev, M_res, io, nx, ncp, nxp,
                  eps_pinf, eps_dinf):
    """OSQP-style infeasibility tests on the iterate deltas since the last
    check, in scaled space: ``(pinf, dinf)`` as Python bools. The two sums
    (the support function and g·δx) add their fp32 terms in fp64 in K3's
    lane order and round once."""
    dt = y.dtype
    dy = (y - y_prev).float()
    dlam = (lam - lam_prev).float()
    r_d = _lane_dot(dy.to(dt), M_res)
    adx = r_d[:, :ncp] * io.inv_wp.float()
    hdx = r_d[:, 2 * ncp:2 * ncp + nxp] * io.inv_wd.float()
    atdl = _lane_dot(dlam.to(dt), io.A_inf)
    norm_dlam = dlam.abs().max()
    norm_dx = dy[:, :nx].abs().max()
    eps_p = eps_pinf * norm_dlam
    eps_d = eps_dinf * norm_dx
    terms = torch.where(dlam > 0, io.u_nc.float() * dlam,
                        torch.where(dlam < 0, io.l_nc.float() * dlam, 0.0))
    support = _lane_sum(terms)
    pinf = bool(norm_dlam > 0) and bool(atdl.abs().max() <= eps_p) \
        and bool(support <= -eps_p)
    ok = (((adx <= eps_d) | (io.fin_u == 0))
          & ((adx >= -eps_d) | (io.fin_l == 0)))
    gdx = _lane_sum(dy * io.g_dp.float())
    dinf = bool(norm_dx > 0) and bool(hdx.abs().max() <= eps_d) \
        and bool(gdx <= -eps_d) and bool(ok.all())
    return pinf, dinf


def full_solve_ref(op: FullSolveOperand, y0, rho_ind0, bias_affine=None, *,
                   nx: int, nc: int, nxp: int, ncp: int, max_iter: int,
                   check_interval: int, adaptive_rho: bool,
                   adaptive_rho_tolerance: float, eps_abs: float,
                   rho_min: float, rho_max: float, rho_jump: bool = False,
                   adaptive_rho_interval: int = 1, alpha_mode: bool = False,
                   verbose: bool = False, iter_precision: str = "highest",
                   refine: bool = True, check_infeasibility: bool = False,
                   eps_prim_inf: float = 1e-4, eps_dual_inf: float = 1e-4,
                   stream_bank: bool = False):
    """Plain torch version of K3: what the kernel computes.

    Whole check windows run while the solve is running and the budget
    holds one more (none when ``max_iter < check_interval``); each one
    iterates ``y ← clip(y @ W_k + b_k, lo, hi)`` with ``b_k`` the bank row,
    or ``c_k + x @ M_aff[k]`` under ``bias_affine = (M_aff, x_row)``, then
    checks: the one-matmul residuals (under alpha ≠ 1 with λ = ρ⃗ ⊙ (p − z)
    and Aᵀλ = λ @ A_w), the ρ walk with the p re-encode for the new rung
    (alpha ≠ 1), the verbose line, the exit at eps and the certificates.
    ``refine`` with a reduced ``iter_precision`` runs the windows in two
    phases: the reduced tier until two consecutive windows improve neither
    residual by 3% or half the budget is spent, then full precision
    ("default" is full precision in both phases, but still two-phase). A
    ``max_iter % check_interval`` tail window then runs if the solve is
    still running: residuals and the exit only, the rung held.
    ``stream_bank`` does not change the numbers.

    Returns ``(y (Dp,), stats (8,) fp32)`` with stats ``[iters, pri, dua,
    ρ estimate, rung, status, iterations of the reduced phase, 0]``.
    """
    dt = y0.dtype
    wt = op.Wt_bank
    n_rho, dp = wt.shape[0], wt.shape[1]
    ci = int(check_interval)
    n_chunks = max_iter // ci
    limit = n_chunks * ci
    stride = rho_update_stride(adaptive_rho_interval, ci)
    tier = _ROLLOUT_TIER[iter_precision]
    c = _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                        rho_max)
    eps_pinf, eps_dinf = _f32(eps_prim_inf), _f32(eps_dual_inf)
    rhos32 = op.rhos.to(torch.float32)
    log_rhos = torch.log(rhos32)
    b_bank = op.b_bank.reshape(n_rho, 1, dp)
    lo, hi = op.lo.reshape(1, dp), op.hi.reshape(1, dp)
    g_row = op.g_row.reshape(nxp)
    ao, io = op.alpha_op, op.infeas_op
    need_lam = alpha_mode or check_infeasibility

    def chunk(y, k_idx, n_steps, t):
        w = wt[k_idx]
        b = b_bank[k_idx]
        if bias_affine is not None:
            M_aff, x_row = bias_affine
            b = b + _lane_dot(x_row, M_aff[k_idx]).to(dt)
        for _ in range(n_steps):
            y = torch.minimum(
                torch.maximum(_iter_product(y, w, t, _lane_dot) + b, lo), hi)
        return y

    def lam_and_d(y, k_idx):
        if alpha_mode:
            d = _lane_dot(y, ao.S_pz).to(dt)
            return ao.rho_eff[k_idx].to(dt) * d, d
        return _lane_dot(y, io.S_lam).to(dt), None

    def residuals(y, rho, k_idx):
        r = _lane_dot(y, op.M_res)[0]
        lam = d = None
        if need_lam:
            lam, d = lam_and_d(y, k_idx)
        atl = (_lane_dot(lam, ao.A_w)[0] if alpha_mode
               else r[2 * ncp + nxp:2 * ncp + 2 * nxp])
        pri, dua, rho_new = _estimate(r[:ncp], r[ncp:2 * ncp],
                                      r[2 * ncp:2 * ncp + nxp], atl, g_row,
                                      rho, c)
        return pri, dua, rho_new, lam, d

    def solved(pri, dua):
        return bool(pri < c["eps_pri"]) and bool(dua < c["eps_dua"])

    def window(s, t):
        y = chunk(s["y"], s["k_idx"], ci, t)
        pri, dua, rho_new, lam, d = residuals(y, s["rho"], s["k_idx"])
        k_idx = s["k_idx"]
        if adaptive_rho:
            old = k_idx
            k_idx = _rho_walk(rhos32, log_rhos, rho_new, k_idx, s["k"], ci,
                              stride, rho_jump, c)
            if alpha_mode:
                # p is rung-scaled (p = z + R⁻¹λ): re-encode it for the new
                # rung (the correction is exactly 0 when the rung held)
                corr = (ao.rho_eff[old].to(dt) / ao.rho_eff[k_idx].to(dt)
                        - 1.0) * d
                y = y + _lane_dot(corr, ao.S_sc).to(dt)
        if verbose:
            print(_verbose_line(s["k"] + ci, rho_new, pri, dua), flush=True)
        status = s["status"]
        if status < 0 and solved(pri, dua):
            status = STATUS_SOLVED
        if check_infeasibility:
            pinf, dinf = _certificates(y, s["y_prev"], lam, s["lam_prev"],
                                       op.M_res, io, nx, ncp, nxp, eps_pinf,
                                       eps_dinf)
            if status < 0 and pinf:
                status = STATUS_PRIMAL_INFEASIBLE
            if status < 0 and dinf:
                status = STATUS_DUAL_INFEASIBLE
            s.update(y_prev=y, lam_prev=lam)
        s.update(y=y, k_idx=k_idx, rho=rho_new, k=s["k"] + ci, pri=pri,
                 dua=dua, status=status)

    k0 = int(rho_ind0)
    zero = torch.zeros((), dtype=torch.float32)
    s = dict(y=y0.reshape(1, dp), k_idx=k0, rho=rhos32[k0], k=0, pri=zero,
             dua=zero, status=_RUNNING)
    if check_infeasibility:
        s.update(y_prev=s["y"], lam_prev=lam_and_d(s["y"], k0)[0])
    running = lambda: s["status"] < 0 and s["k"] < limit

    k_fast = 0
    if refine and iter_precision != "highest":
        cap_a = (n_chunks // 2) * ci
        best_p = best_d = torch.tensor(float("inf"))
        n_stall = 0
        while n_stall < 2 and s["k"] < cap_a and running():
            window(s, tier)
            improved = bool(s["pri"] < 0.97 * best_p) \
                or bool(s["dua"] < 0.97 * best_d)
            n_stall = 0 if improved else n_stall + 1
            best_p = torch.minimum(best_p, s["pri"])
            best_d = torch.minimum(best_d, s["dua"])
        k_fast = s["k"]
        tier = _ROLLOUT_TIER["highest"]
    while running():
        window(s, tier)

    rem = max_iter - limit
    if rem > 0 and s["status"] < 0:
        y = chunk(s["y"], s["k_idx"], rem, tier)
        pri, dua, rho_new, _, _ = residuals(y, s["rho"], s["k_idx"])
        s.update(y=y, rho=rho_new, k=s["k"] + rem, pri=pri, dua=dua,
                 status=STATUS_SOLVED if solved(pri, dua) else _RUNNING)
    status = STATUS_MAX_ITER if s["status"] < 0 else s["status"]
    stats = torch.tensor([s["k"], float(s["pri"]), float(s["dua"]),
                          float(s["rho"]), s["k_idx"], status, k_fast, 0.0],
                         dtype=torch.float32, device=y0.device)
    return s["y"].reshape(dp).clone(), stats


class _K3Params(ctypes.Structure):
    """Mirror of ``K3Params`` in ``csrc/full_solve.cu`` (same order)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "wt", "b", "rhos", "m_res", "g_row", "lo", "hi", "y0", "a_w",
        "rho_eff", "a_inf", "inv_wp", "inv_wd", "l_nc", "u_nc", "fin_l",
        "fin_u", "g_dp", "m_aff", "x_row", "rho0_dev", "y_out", "stats",
        "ybuf", "part", "stamps")]
        + [(n, ctypes.c_int) for n in (
            "w_dtype", "y_dtype", "n_rho", "dp", "nx", "nc", "nxp", "ncp",
            "nplp", "max_iter", "ci", "rho0", "adaptive", "jump", "stride",
            "tier", "two_phase", "alpha", "infeas", "verbose", "part_rows")]
        + [(n, ctypes.c_float) for n in (
            "eps_pri", "eps_dua", "tol", "rho_min", "rho_max", "eps_pinf",
            "eps_dinf")])


def _k3_lib():
    from .cuda_build import load
    lib = load("full_solve")
    if not getattr(lib, "_k3_typed", False):
        i = ctypes.c_int
        lib.k3_full_solve.argtypes = [ctypes.POINTER(_K3Params),
                                      ctypes.c_void_p]
        lib.k3_full_solve.restype = i
        lib.k3_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)] * 3
        lib.k3_plan.restype = i
        lib.k3_stamp_now.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.k3_stamp_now.restype = i
        lib.k3_error_string.argtypes = [i]
        lib.k3_error_string.restype = ctypes.c_char_p
        lib._k3_typed = True
    return lib


def _k3_raise(lib, code: int, what: str):
    msg = lib.k3_error_string(code).decode()
    raise RuntimeError(f"K3 {what} failed: CUDA error {code} ({msg})")


def solve_plan(dp: int, nxp: int, ncp: int, dtype=torch.float32,
               device=None, w_dtype=None) -> dict:
    """The launch shape of K3 on ``device`` (default the current GPU) for
    a plain solve (no alpha, certificates or affine bias) with state dtype
    ``dtype`` and bank dtype ``w_dtype`` (default ``dtype``): blocks, y
    lanes (columns of W) per block, dynamic shared memory, whether every
    operand slab is held in shared memory (else read from L2), how the
    slabs are staged ("cp.async"; "loads", a batch of loads before their
    stores, for a bf16 bank, which cp.async cannot copy element by element;
    "none" where they are read from L2), and the exchange: "tagged words",
    each value beside its exchange's tag in ``words_per_value`` 64-bit
    words (1 in fp32, 2 in fp64), read by every block with no grid barrier
    but the launch's first."""
    lib = _k3_lib()
    vals = [ctypes.c_int() for _ in range(3)]
    code = _DTYPE_CODE[dtype]
    w_dtype = dtype if w_dtype is None else w_dtype
    with torch.cuda.device(device):
        rc = lib.k3_plan(dp, nxp, ncp, 0, code, _DTYPE_CODE[w_dtype], 0, 0,
                         *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _k3_raise(lib, rc, "plan")
    blocks, smem, resident = (v.value for v in vals)
    staging = ("none" if not resident else
               "loads" if w_dtype == torch.bfloat16 else "cp.async")
    return {"blocks": blocks, "cols_per_block": -(-dp // blocks),
            "smem_bytes": smem, "resident": bool(resident),
            "staging": staging, "exchange": "tagged words",
            "words_per_value": 2 if dtype == torch.float64 else 1}


def _k3_operands(op: FullSolveOperand, y0, bias_affine, *, nx, nc, nxp, ncp,
                 alpha_mode, check_infeasibility) -> dict:
    """Check the shapes of one solve's operands (both paths) and return
    the ones the kernel reads, by name, flattened where they are rows."""
    wt = op.Wt_bank
    if wt.dim() != 3 or wt.shape[1] != wt.shape[2]:
        raise ValueError("K3: Wt_bank must be (N, Dp, Dp)")
    n_rho, dp = wt.shape[0], wt.shape[1]
    if nx + 2 * nc > dp or nx > nxp or nc > ncp:
        raise ValueError(f"K3: nx={nx}, nc={nc} do not fit Dp={dp}, "
                         f"nxp={nxp}, ncp={ncp}")
    R = 2 * ncp + (nxp if alpha_mode else 2 * nxp)
    want = {"Wt_bank": (wt, (n_rho, dp, dp)), "b_bank": (op.b_bank, n_rho * dp),
            "rhos": (op.rhos, n_rho), "M_res": (op.M_res, (dp, R)),
            "g_row": (op.g_row, nxp), "lo": (op.lo, dp), "hi": (op.hi, dp),
            "y0": (y0, dp)}
    if alpha_mode:
        ao = op.alpha_op
        if ao is None:
            raise ValueError("K3: alpha_mode needs op.alpha_op")
        want.update(S_pz=(ao.S_pz, (dp, ncp)), A_w=(ao.A_w, (ncp, nxp)),
                    S_sc=(ao.S_sc, (ncp, dp)),
                    rho_eff=(ao.rho_eff, n_rho * ncp))
    if check_infeasibility:
        io = op.infeas_op
        if io is None:
            raise ValueError("K3: check_infeasibility needs op.infeas_op")
        want.update(S_lam=(io.S_lam, (0, 0) if alpha_mode else (dp, ncp)),
                    A_inf=(io.A_inf, (ncp, nxp)), inv_wp=(io.inv_wp, ncp),
                    inv_wd=(io.inv_wd, nxp), l_nc=(io.l_nc, ncp),
                    u_nc=(io.u_nc, ncp), fin_l=(io.fin_l, ncp),
                    fin_u=(io.fin_u, ncp), g_dp=(io.g_dp, dp))
    if bias_affine is not None:
        if alpha_mode:
            raise ValueError(
                "bias_affine with alpha_mode is unsupported: the relaxed "
                "bank's b_k folds alpha per rung, and an affine part built "
                "from the unrelaxed B would disagree with it silently")
        M_aff, x_row = bias_affine
        if M_aff.dim() != 3:
            raise ValueError("K3: M_aff must be (N, nplp, Dp)")
        nplp = M_aff.shape[1]
        want.update(M_aff=(M_aff, (n_rho, nplp, dp)), x_row=(x_row, nplp))
    out = {}
    for name, (t, shape) in want.items():
        got = tuple(t.shape) if isinstance(shape, tuple) else t.numel()
        if got != shape:
            raise ValueError(f"K3: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        out[name] = t if isinstance(shape, tuple) else t.reshape(-1)
    return out


def _full_solve_cuda(ops: dict, rho_ind0, *, nx, nc, nxp, ncp,
                     max_iter, check_interval, adaptive_rho,
                     adaptive_rho_tolerance, eps_abs, rho_min, rho_max,
                     rho_jump, adaptive_rho_interval, alpha_mode, verbose,
                     iter_precision, refine, check_infeasibility,
                     eps_prim_inf, eps_dual_inf):
    y0 = ops["y0"]
    dev, dt = y0.device, y0.dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"K3: state dtype {dt} is not float32/float64")
    # the selectors S_pz, S_sc and S_lam pick fixed lanes of the stacked
    # layout; the kernel reads those lanes directly
    for name in ("S_pz", "S_sc", "S_lam"):
        ops.pop(name, None)
    ops["rhos"] = ops["rhos"].to(torch.float32)
    for name, t in ops.items():
        if t.device != dev:
            raise ValueError(f"K3: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"K3: {name} must be contiguous")
        if name == "Wt_bank":
            ok = t.dtype in (dt, torch.bfloat16)
        elif name == "rho0_dev":
            ok = True
        else:
            ok = t.dtype == (torch.float32 if name in ("rhos", "rho_eff")
                             else dt)
        if not ok:
            raise ValueError(f"K3: {name} dtype {t.dtype} does not go with "
                             f"state dtype {dt}")
    dp = ops["Wt_bank"].shape[1]
    y_out = torch.empty((dp,), dtype=dt, device=dev)
    stats = torch.empty((8,), dtype=torch.float32, device=dev)
    # the exchange's tagged words (the kernel clears them): two slots of y
    # and of the blocks' partials, one word a value (two in fp64)
    n_w = 2 if dt == torch.float64 else 1
    ybuf = torch.empty((2, dp, n_w), dtype=torch.int64, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.empty((2, n_sm, 8, n_w), dtype=torch.int64, device=dev)
    c = _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                        rho_max)
    ptr = lambda name: ops[name].data_ptr() if name in ops else None
    p = _K3Params(
        wt=ptr("Wt_bank"), b=ptr("b_bank"), rhos=ptr("rhos"),
        m_res=ptr("M_res"), g_row=ptr("g_row"), lo=ptr("lo"), hi=ptr("hi"),
        y0=ptr("y0"), a_w=ptr("A_w"), rho_eff=ptr("rho_eff"),
        a_inf=ptr("A_inf"), inv_wp=ptr("inv_wp"), inv_wd=ptr("inv_wd"),
        l_nc=ptr("l_nc"), u_nc=ptr("u_nc"), fin_l=ptr("fin_l"),
        fin_u=ptr("fin_u"), g_dp=ptr("g_dp"), m_aff=ptr("M_aff"),
        x_row=ptr("x_row"), rho0_dev=ptr("rho0_dev"),
        y_out=y_out.data_ptr(),
        stats=stats.data_ptr(), ybuf=ybuf.data_ptr(), part=part.data_ptr(),
        stamps=None if full_solve.stamps is None
        else full_solve.stamps.data_ptr(),
        w_dtype=_DTYPE_CODE[ops["Wt_bank"].dtype], y_dtype=_DTYPE_CODE[dt],
        n_rho=ops["Wt_bank"].shape[0], dp=dp, nx=nx, nc=nc, nxp=nxp,
        ncp=ncp, nplp=ops["M_aff"].shape[1] if "M_aff" in ops else 0,
        max_iter=max_iter, ci=check_interval,
        rho0=-1 if "rho0_dev" in ops else rho_ind0,
        adaptive=int(bool(adaptive_rho)), jump=int(bool(rho_jump)),
        stride=rho_update_stride(adaptive_rho_interval, check_interval),
        tier=_ROLLOUT_TIER[iter_precision],
        two_phase=int(bool(refine) and iter_precision != "highest"),
        alpha=int(bool(alpha_mode)), infeas=int(bool(check_infeasibility)),
        verbose=int(bool(verbose)), part_rows=n_sm,
        eps_pinf=_f32(eps_prim_inf), eps_dinf=_f32(eps_dual_inf), **c)
    lib = _k3_lib()
    rc = lib.k3_full_solve(ctypes.byref(p),
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _k3_raise(lib, rc, "launch")
    full_solve.launches += 1
    return y_out, stats


def full_solve(op: FullSolveOperand, y0, rho_ind0, bias_affine=None, *,
               nx: int, nc: int, nxp: int, ncp: int, max_iter: int,
               check_interval: int, adaptive_rho: bool,
               adaptive_rho_tolerance: float, eps_abs: float,
               rho_min: float, rho_max: float, rho_jump: bool = False,
               adaptive_rho_interval: int = 1, alpha_mode: bool = False,
               verbose: bool = False, iter_precision: str = "highest",
               refine: bool = True, check_infeasibility: bool = False,
               eps_prim_inf: float = 1e-4, eps_dual_inf: float = 1e-4,
               stream_bank: bool = False):
    """One whole solve as ONE kernel launch. Returns ``(y (Dp,), stats
    (8,))``, see ``full_solve_ref``.

    ``op``: the ``FullSolveOperand`` (``alpha_op`` under ``alpha_mode``,
    ``infeas_op`` under ``check_infeasibility``); ``y0`` (Dp,) the start
    state; ``rho_ind0`` the start rung: an int (a launch argument), or for
    CUDA tensors also a one-element int32 tensor on the device that the
    kernel reads itself (a previous solve's rung, with no host sync);
    ``bias_affine``: optional ``(M_aff (N, nplp, Dp), x_row
    (nplp,))``, the state-affine bias ``b_k = c_k + x @ M_aff[k]`` with
    ``op.b_bank`` holding ``c_k`` (not with ``alpha_mode``).
    ``stream_bank`` is accepted for the TPU kernel's signature and changes
    nothing: K3 holds the current rung's columns in shared memory and
    reloads them on a rung change in every case. CUDA tensors launch the
    CUDA kernel (or raise); CPU tensors run ``full_solve_ref``.
    """
    if iter_precision not in _ROLLOUT_TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")
    if check_interval < 1 or max_iter < 0:
        raise ValueError("K3: check_interval must be >= 1 and max_iter >= 0")
    ops = _k3_operands(op, y0, bias_affine, nx=nx, nc=nc, nxp=nxp, ncp=ncp,
                       alpha_mode=alpha_mode,
                       check_infeasibility=check_infeasibility)
    if isinstance(rho_ind0, torch.Tensor) and y0.is_cuda:
        # read on the device by the kernel (clamped to the ladder there)
        if rho_ind0.dtype != torch.int32 or rho_ind0.numel() != 1:
            raise ValueError("K3: a rung tensor must be one int32 element")
        ops["rho0_dev"] = rho_ind0
    else:
        rho_ind0 = int(rho_ind0)
        if not 0 <= rho_ind0 < op.Wt_bank.shape[0]:
            raise ValueError(f"K3: rho_ind0 {rho_ind0} is off the ladder")
    kw = dict(nx=nx, nc=nc, nxp=nxp, ncp=ncp, max_iter=max_iter,
              check_interval=check_interval, adaptive_rho=adaptive_rho,
              adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
              rho_min=rho_min, rho_max=rho_max, rho_jump=rho_jump,
              adaptive_rho_interval=adaptive_rho_interval,
              alpha_mode=alpha_mode, verbose=verbose,
              iter_precision=iter_precision, refine=refine,
              check_infeasibility=check_infeasibility,
              eps_prim_inf=eps_prim_inf, eps_dual_inf=eps_dual_inf)
    if y0.is_cuda:
        with device_guard(y0.device):
            return _full_solve_cuda(ops, rho_ind0, **kw)
    return full_solve_ref(op, y0, rho_ind0, bias_affine,
                          stream_bank=stream_bank, **kw)


full_solve.launches = 0
# an int64 (len(K3_STAGES) + 3,) tensor on the card, or None: the kernel's
# stage stamps (``k3_stage_split``); None on every solve path
full_solve.stamps = None

# block 0's stages of a K3 launch, in order (``csrc/solve_loop.cuh``'s K3S_*
# slots after K3S_START): the operands staged (the prologue and every rung
# change), the bias formed, the iterations' products, their exchange (the
# grid barrier and the y reload), the checks' products, the checks' partials
# reduced and decided
K3_STAGES = ("staged", "bias", "iteration", "exchange", "check", "reduced")


def k3_stage_split(run, reps: int = 20) -> dict:
    """Where one K3 launch's time goes: ``run()`` (one ``full_solve`` on the
    card) captured in a CUDA graph behind a one-thread kernel that stamps
    the time, replayed ``reps`` times with the stage stamps on. Returns the
    mean µs of: ``launch`` (the stamp to the earliest block's start), each
    stage of ``K3_STAGES`` (block 0's time in it, summed over the launch),
    ``blocks`` (the earliest block's start to the latest block's end) and
    ``total`` (the stamp to that end)."""
    dev = torch.device("cuda", torch.cuda.current_device())
    n = len(K3_STAGES) + 3
    stamps = torch.zeros(n, dtype=torch.int64, device=dev)
    lib = _k3_lib()
    full_solve.stamps = stamps
    try:
        graph = _graph_behind_stamp(
            run, stamps, lib.k3_stamp_now,
            lambda rc: _k3_raise(lib, rc, "stamp"))
        sums = dict.fromkeys(("launch",) + K3_STAGES + ("blocks", "total"),
                             0.0)
        for _ in range(reps):
            stamps.zero_()
            stamps[1] = -1          # the start slot takes the least time
            graph.replay()
            t = stamps.cpu().tolist()
            sums["launch"] += (t[1] - t[0]) / 1e3
            for i, name in enumerate(K3_STAGES):
                sums[name] += t[2 + i] / 1e3
            sums["blocks"] += (t[-1] - t[1]) / 1e3
            sums["total"] += (t[-1] - t[0]) / 1e3
    finally:
        full_solve.stamps = None
    return {k: v / reps for k, v in sums.items()}


# --------------------------------------------------------------------- #
# batched whole-ROLLOUT kernel K6: T scenario-MPC steps in ONE launch    #
# --------------------------------------------------------------------- #

def _estimate_rows(ax, z, hx, atl, g32, rho, c):
    """Per-row residual maxima and clamped ρ estimates of K6, all fp32
    (the TPU kernel promotes the g row to fp32 before the dual sum):
    ``(pri, dua, rho_new)``, each (Bp,)."""
    amax = lambda v: v.abs().amax(dim=1)
    pri = amax(ax - z)
    dua = amax((hx + atl) + g32)
    sp = torch.maximum(amax(ax), amax(z))
    sd = torch.maximum(torch.maximum(amax(hx), amax(atl)), amax(g32))
    num = pri / sp.clamp_min(_TINY)
    den = dua / sd.clamp_min(_TINY)
    rho_new = torch.clamp(rho * torch.sqrt(num / den.clamp_min(_TINY)),
                          c["rho_min"], c["rho_max"])
    return pri, dua, rho_new


def _geometric_mean(rho_new, open_rows, rho_k):
    """The ensemble's ρ: the geometric mean of the open rows' estimates,
    their logs summed in fp64 one row after the other (the kernel's order),
    rounded to fp32; ``rho_k`` when no row is open."""
    logs = torch.where(open_rows, rho_new.double().log(), 0.0).tolist()
    n_act = int(open_rows.sum())
    if n_act == 0:
        return rho_k
    s = 0.0
    for v in logs:
        s += v
    return torch.tensor(float(np.float32(math.exp(s / n_act))),
                        dtype=torch.float32, device=rho_k.device)


def full_rollout_batched_ref(Wt_bank, bias_c, M_aff, rhos, M_res, g0w, gl_op,
                             lo0, hi0, S_u, Bdw, Y0, X0, pad_mask, noise,
                             rho_ind0, *, nx: int, nc: int, nxp: int,
                             ncp: int, nup: int, nplp: int, n_steps: int,
                             max_iter: int, check_interval: int,
                             adaptive_rho: bool,
                             adaptive_rho_tolerance: float, eps_abs: float,
                             rho_min: float, rho_max: float,
                             rho_jump: bool = False,
                             adaptive_rho_interval: int = 1,
                             iter_precision: str = "highest"):
    """Plain torch version of K6: what the kernel computes.

    K2 (``full_rollout_ref``) for a B-plant ensemble on (Bp, Dp) states and
    (Bp, nplp) plants. Per control step every row refreshes from its own
    plant state; the warm solve runs whole windows (the first always) with
    per-row residuals from one ``Y @ M_res``, per-row done flags (a done
    row's pri, dua and ρ estimate freeze), ONE shared rung walked by the
    geometric mean of the open rows' ρ estimates (``_geometric_mean``), and
    exits when every row is done or the budget is spent; ``pad_mask`` (Bp,)
    marks inert rows, which start done and report SOLVED. Then every row's
    ``u = y @ S_u − Kx`` and ``x⁺ = Ax + u @ Bdw + noise[t]``. Every
    product is summed in fp64 and rounded to fp32 (``_dot64``); the
    residual maxima and ρ are fp32.
    Returns ``(xs (T, Bp, nplp), us (T, Bp, nup), stats (T, 8) fp32, Y_f
    (Bp, Dp))``, stats rows ``[iterations, max pri, max dua, real rows,
    rung, min status, unsolved rows, 0]``.
    """
    dt = Y0.dtype
    dev = Y0.device
    bp, dp = Y0.shape
    ci = int(check_interval)
    limit = (max_iter // ci) * ci
    stride = rho_update_stride(adaptive_rho_interval, ci)
    tier = _ROLLOUT_TIER[iter_precision]
    c = _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                        rho_max)
    rhos32 = rhos.to(torch.float32)
    log_rhos = torch.log(rhos32)
    g0w = g0w.reshape(1, nxp)
    lo0 = lo0.reshape(1, dp)
    hi0 = hi0.reshape(1, dp)
    pad = pad_mask.reshape(bp) > 0.5
    n_real = float((~pad).sum())
    Y, X = Y0, X0
    k_idx = int(rho_ind0)
    xs, us, stats = [], [], []
    for t in range(n_steps):
        r2 = _dot64(X, gl_op).to(dt)
        g32 = (g0w + r2[:, :nxp]).float()
        sz = r2[:, nxp:nxp + dp]
        kx = r2[:, nxp + dp:nxp + dp + nup]
        ax = r2[:, nxp + dp + nup:]
        lo, hi = lo0 + sz, hi0 + sz
        rho = rhos32[k_idx].expand(bp).clone()
        pri = torch.zeros((bp,), dtype=torch.float32, device=dev)
        dua = pri.clone()
        done = pad.clone()
        status = pad.float()
        k = 0
        while True:
            w = Wt_bank[k_idx]
            b = bias_c[k_idx] + _dot64(X, M_aff[k_idx]).to(dt)
            for _ in range(ci):
                Y = torch.minimum(torch.maximum(
                    _iter_product(Y, w, tier, _dot64) + b, lo), hi)
            r = _dot64(Y, M_res)
            pri_n, dua_n, rho_new = _estimate_rows(
                r[:, :ncp], r[:, ncp:2 * ncp], r[:, 2 * ncp:2 * ncp + nxp],
                r[:, 2 * ncp + nxp:], g32, rho, c)
            open_rows = ~done
            pri = torch.where(open_rows, pri_n, pri)
            dua = torch.where(open_rows, dua_n, dua)
            rho = torch.where(open_rows, rho_new, rho)
            if adaptive_rho:
                rho_gm = _geometric_mean(rho_new, open_rows, rhos32[k_idx])
                k_idx = _rho_walk(rhos32, log_rhos, rho_gm, k_idx, k, ci,
                                  stride, rho_jump, c)
            newly = open_rows & (pri < c["eps_pri"]) & (dua < c["eps_dua"])
            k += ci
            status = torch.where(newly, 1.0, status)
            done = done | newly
            if bool(done.all()) or k >= limit:
                break
        v0 = _dot64(Y, S_u).to(dt)
        u = v0 - kx
        X = (ax + _dot64(u, Bdw).to(dt)) + noise[t]
        xs.append(X)
        us.append(u)
        stats.append(torch.stack([
            torch.tensor(float(k)), pri.max().cpu(), dua.max().cpu(),
            torch.tensor(n_real), torch.tensor(float(k_idx)),
            status.min().cpu(), (1.0 - status).sum().cpu(),
            torch.tensor(0.0)]).float())
    empty = lambda n: torch.zeros((0, bp, n), dtype=dt, device=dev)
    return (torch.stack(xs) if xs else empty(nplp),
            torch.stack(us) if us else empty(nup),
            (torch.stack(stats) if stats
             else torch.zeros((0, 8))).to(dev),
            Y.clone())


class _K6Params(ctypes.Structure):
    """Mirror of ``K6Params`` in ``csrc/rollout_batched.cu`` (same
    order)."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "wt", "bias_c", "m_aff", "rhos", "m_res", "g0w", "gl", "lo0", "hi0",
        "s_u", "bdw", "y0", "x0", "pad", "noise", "xs", "us", "stats", "y_f",
        "exch", "loads")]
        + [(n, ctypes.c_int) for n in (
            "w_dtype", "y_dtype", "n_rho", "dp", "nxp", "ncp", "nup", "nplp",
            "bp", "n_steps", "max_iter", "ci", "rho0", "adaptive", "jump",
            "stride", "tier")]
        + [(n, ctypes.c_float) for n in (
            "eps_pri", "eps_dua", "tol", "rho_min", "rho_max")])


# doubles per row of K6's cross-block exchange array
_K6_EXCH_COLS = 6
# K6 takes widths (Dp, nup, nplp) in multiples of this (kWidthStep)
_K6_WIDTH_STEP = 16


def _k6_lib():
    from .cuda_build import load
    lib = load("rollout_batched")
    if not getattr(lib, "_k6_typed", False):
        i = ctypes.c_int
        lib.k6_full_rollout_batched.argtypes = [ctypes.POINTER(_K6Params),
                                                ctypes.c_void_p]
        lib.k6_full_rollout_batched.restype = i
        lib.k6_plan.argtypes = [i] * 8 + [ctypes.POINTER(i)]
        lib.k6_plan.restype = i
        lib.k6_error_string.argtypes = [i]
        lib.k6_error_string.restype = ctypes.c_char_p
        lib._k6_typed = True
    return lib


def _k6_raise(lib, code: int, what: str):
    msg = lib.k6_error_string(code).decode()
    raise RuntimeError(f"K6 {what} failed: CUDA error {code} ({msg})")


# the fields of k6_plan's report, in its order
_K6_PLAN_KEYS = ("blocks", "threads", "cluster", "column_width",
                 "rows_per_tile", "tiles", "smem_bytes", "slab_in_smem",
                 "max_clusters")


def rollout_batched_plan(bp: int, dp: int, nxp: int, ncp: int, nup: int,
                         nplp: int, dtype=torch.float32,
                         device=None) -> dict:
    """The launch shape of K6 on ``device`` (default the current GPU):
    blocks of ``threads``, ``tiles`` thread-block clusters of ``cluster``
    blocks, each block a ``column_width`` slab of the rung's columns for
    ``rows_per_tile`` scenario rows, the dynamic shared memory, whether the
    slab is held in shared memory (else read from L2), and how many such
    clusters the card holds at once. Raises where no shape puts every tile
    in one wave."""
    lib = _k6_lib()
    out = (ctypes.c_int * len(_K6_PLAN_KEYS))()
    with torch.cuda.device(device):
        rc = lib.k6_plan(bp, dp, nxp, ncp, nup, nplp, _DTYPE_CODE[dtype],
                         _DTYPE_CODE[dtype], out)
    if rc != 0:
        _k6_raise(lib, rc, "plan")
    plan = dict(zip(_K6_PLAN_KEYS, out))
    plan["slab_in_smem"] = bool(plan["slab_in_smem"])
    return plan


def _check_batched_operands(ops: dict, *, nxp, ncp, nup, nplp, n_steps):
    """Shapes of K6's operands (both paths)."""
    wt = ops["Wt_bank"]
    if wt.dim() != 3 or wt.shape[1] != wt.shape[2]:
        raise ValueError("K6: Wt_bank must be (N, Dp, Dp)")
    n_rho, dp = wt.shape[0], wt.shape[1]
    if ops["Y0"].dim() != 2:
        raise ValueError("K6: Y0 must be (Bp, Dp)")
    bp = ops["Y0"].shape[0]
    want = {"bias_c": (n_rho, dp), "M_aff": (n_rho, nplp, dp),
            "rhos": (n_rho,), "M_res": (dp, 2 * ncp + 2 * nxp),
            "g0w": (nxp,), "gl_op": (nplp, nxp + dp + nup + nplp),
            "lo0": (dp,), "hi0": (dp,), "S_u": (dp, nup), "Bdw": (nup, nplp),
            "Y0": (bp, dp), "X0": (bp, nplp), "pad_mask": (bp,),
            "noise": (n_steps, bp, nplp)}
    flat = {"rhos", "g0w", "lo0", "hi0", "pad_mask"}
    for name, shape in want.items():
        t = ops[name]
        got = (t.numel(),) if name in flat else tuple(t.shape)
        if got != shape:
            raise ValueError(f"K6: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
    dt = ops["Y0"].dtype
    if dt not in (torch.float32, torch.float64):
        raise ValueError(f"K6: state dtype {dt} is not float32/float64")
    f32 = torch.float32
    for name, t in ops.items():
        if name == "Wt_bank":
            ok = t.dtype == dt or (t.dtype == torch.bfloat16 and dt == f32)
        else:
            ok = name in ("rhos", "pad_mask") or t.dtype == dt
        if not ok:
            raise ValueError(f"K6: {name} dtype {t.dtype} does not go with "
                             f"state dtype {dt}")
    # the kernel's products take whole steps of 8 inputs, its loads whole
    # 16-byte groups
    for name, n in (("Dp", dp), ("nup", nup), ("nplp", nplp)):
        if n % _K6_WIDTH_STEP:
            raise ValueError(f"K6: {name}={n} is not a multiple of "
                             f"{_K6_WIDTH_STEP}")
    return n_rho, dp, bp


def _full_rollout_batched_cuda(ops, rho_ind0, *, n_rho, dp, bp, nx, nc, nxp,
                               ncp, nup, nplp, n_steps, max_iter,
                               check_interval, adaptive_rho,
                               adaptive_rho_tolerance, eps_abs, rho_min,
                               rho_max, rho_jump, adaptive_rho_interval,
                               iter_precision):
    Y0 = ops["Y0"]
    dev, dt = Y0.device, Y0.dtype
    f32 = torch.float32
    ops = dict(ops, rhos=ops["rhos"].to(f32).contiguous(),
               pad_mask=ops["pad_mask"].to(f32).contiguous())
    for name, t in ops.items():
        if t.device != dev:
            raise ValueError(f"K6: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"K6: {name} must be contiguous")
    xs = torch.empty((n_steps, bp, nplp), dtype=dt, device=dev)
    us = torch.empty((n_steps, bp, nup), dtype=dt, device=dev)
    stats = torch.empty((n_steps, 8), dtype=f32, device=dev)
    if n_steps == 0:
        return xs, us, stats, Y0.clone()
    y_f = torch.empty((bp, dp), dtype=dt, device=dev)
    exch = torch.empty((2, bp, _K6_EXCH_COLS), dtype=torch.float64,
                       device=dev)
    loads = torch.zeros((1,), dtype=torch.int32, device=dev)
    c = _rollout_consts(nx, nc, eps_abs, adaptive_rho_tolerance, rho_min,
                        rho_max)
    ptr = lambda name: ops[name].data_ptr()
    p = _K6Params(
        wt=ptr("Wt_bank"), bias_c=ptr("bias_c"), m_aff=ptr("M_aff"),
        rhos=ptr("rhos"), m_res=ptr("M_res"), g0w=ptr("g0w"),
        gl=ptr("gl_op"), lo0=ptr("lo0"), hi0=ptr("hi0"), s_u=ptr("S_u"),
        bdw=ptr("Bdw"), y0=ptr("Y0"), x0=ptr("X0"), pad=ptr("pad_mask"),
        noise=ptr("noise"), xs=xs.data_ptr(), us=us.data_ptr(),
        stats=stats.data_ptr(), y_f=y_f.data_ptr(), exch=exch.data_ptr(),
        loads=loads.data_ptr(),
        w_dtype=_DTYPE_CODE[ops["Wt_bank"].dtype], y_dtype=_DTYPE_CODE[dt],
        n_rho=n_rho, dp=dp, nxp=nxp, ncp=ncp, nup=nup, nplp=nplp, bp=bp,
        n_steps=n_steps, max_iter=max_iter, ci=check_interval, rho0=rho_ind0,
        adaptive=int(bool(adaptive_rho)), jump=int(bool(rho_jump)),
        stride=rho_update_stride(adaptive_rho_interval, check_interval),
        tier=_ROLLOUT_TIER[iter_precision], **c)
    lib = _k6_lib()
    rc = lib.k6_full_rollout_batched(
        ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _k6_raise(lib, rc, "launch")
    full_rollout_batched.launches += 1
    full_rollout_batched.slab_loads = loads
    return xs, us, stats, y_f


def full_rollout_batched(Wt_bank, bias_c, M_aff, rhos, M_res, g0w, gl_op,
                         lo0, hi0, S_u, Bdw, Y0, X0, pad_mask, noise,
                         rho_ind0, *, nx: int, nc: int, nxp: int, ncp: int,
                         nup: int, nplp: int, n_steps: int, max_iter: int,
                         check_interval: int, adaptive_rho: bool,
                         adaptive_rho_tolerance: float, eps_abs: float,
                         rho_min: float, rho_max: float,
                         rho_jump: bool = False,
                         adaptive_rho_interval: int = 1,
                         iter_precision: str = "highest"):
    """T warm-started SCENARIO-MPC steps (B plants) as ONE kernel launch.

    The operands are K2's (``models.mpc._build_rollout_operators``) with
    the state and plant as (Bp, ·) blocks: ``Y0`` (Bp, Dp), ``X0`` (Bp,
    nplp), ``pad_mask`` (Bp,) (1.0 = inert padding row), ``noise`` (T, Bp,
    nplp), and the start rung ``rho_ind0`` (an int). Returns ``(xs (T, Bp,
    nplp), us (T, Bp, nup), stats (T, 8), Y_f (Bp, Dp))``, see
    ``full_rollout_batched_ref``. CUDA tensors launch the CUDA kernel K6
    (or raise); CPU tensors run ``full_rollout_batched_ref``.
    """
    if max_iter % check_interval != 0:
        raise ValueError("the scan-rollout kernel requires max_iter to be a "
                         "multiple of check_interval")
    if iter_precision not in _ROLLOUT_TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")
    ops = dict(Wt_bank=Wt_bank, bias_c=bias_c, M_aff=M_aff, rhos=rhos,
               M_res=M_res, g0w=g0w, gl_op=gl_op, lo0=lo0, hi0=hi0, S_u=S_u,
               Bdw=Bdw, Y0=Y0, X0=X0, pad_mask=pad_mask, noise=noise)
    n_rho, dp, bp = _check_batched_operands(ops, nxp=nxp, ncp=ncp, nup=nup,
                                            nplp=nplp, n_steps=n_steps)
    rho_ind0 = int(rho_ind0)
    if not 0 <= rho_ind0 < n_rho:
        raise ValueError(f"K6: rho_ind0 {rho_ind0} is off the ladder")
    kw = dict(nx=nx, nc=nc, nxp=nxp, ncp=ncp, nup=nup, nplp=nplp,
              n_steps=n_steps, max_iter=max_iter,
              check_interval=check_interval, adaptive_rho=adaptive_rho,
              adaptive_rho_tolerance=adaptive_rho_tolerance, eps_abs=eps_abs,
              rho_min=rho_min, rho_max=rho_max, rho_jump=rho_jump,
              adaptive_rho_interval=adaptive_rho_interval,
              iter_precision=iter_precision)
    if Y0.is_cuda:
        with device_guard(Y0.device):
            return _full_rollout_batched_cuda(ops, rho_ind0, n_rho=n_rho,
                                              dp=dp, bp=bp, **kw)
    return full_rollout_batched_ref(Wt_bank, bias_c, M_aff, rhos, M_res, g0w,
                                    gl_op, lo0, hi0, S_u, Bdw, Y0, X0,
                                    pad_mask, noise, rho_ind0, **kw)


full_rollout_batched.launches = 0
# the last launch's count of rung slab loads by the kernel's first block
# (a device int32 tensor: 0 where the slab is read from L2)
full_rollout_batched.slab_loads = None
