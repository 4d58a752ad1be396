"""Residual operator and the whole-rollout kernel K2.

- ``build_residual_operator``: the one-matmul residual check. With
  lane-aligned segment padding,

      y @ M_res = [A x | z | H x | Aᵀ λ]     M_res (Dp, R), R = 2·ncp + 2·nxp

  built from rows ``[[Aᵀ,0,H,0],[0,I,0,0],[0,0,0,A]]`` (zero rows in the
  padding keep every segment exact).
- ``full_rollout``: T warm-started MPC control steps in ONE launch of the
  hand-written CUDA kernel ``csrc/solve_kernel.cu`` for CUDA tensors (see
  its header for the design), or of the plain torch version
  ``full_rollout_ref`` for CPU tensors. A CUDA tensor never reaches the
  plain version: the kernel runs or the call raises.
  ``full_rollout.launches`` counts kernel launches.

The whole-solve kernel K3 (``full_solve``) and the batched rollout K6
(``full_rollout_batched``) are later slices of the port.

Numerics of the rollout follow the TPU kernel it replaces: every product
(refresh, bias, iteration, residual, control, plant) is rounded to fp32,
as the TPU kernel's fp32-result dots are, and then cast to the state dtype
(a no-op in fp32). The residual maxima, the ρ estimate, the ladder
``rhos`` and the tolerances are fp32 in an fp64 run too.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.iteration import (_RUNNING, _TINY, STATUS_MAX_ITER,
                              STATUS_SOLVED, rho_update_stride)
from .fused_step import _DTYPE_CODE, _bf16, pad_dim

__all__ = ["build_residual_operator", "full_rollout", "full_rollout_ref",
           "rollout_plan"]

# Iteration tiers of the rollout: "bf16" one bf16 pass, "high" the bf16x3
# split, anything else (including "default") full precision — as the TPU
# rollout kernel maps them.
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


# --------------------------------------------------------------------- #
# whole-ROLLOUT kernel K2: T control steps in one launch                 #
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


def _iter_product(y, w, tier: int):
    """``y @ w`` at the rollout's iteration tier, rounded to fp32 and
    returned in y's dtype. "high" sums its three bf16-split passes in
    fp32, as the TPU kernel does."""
    dt = y.dtype
    if tier == 2:
        p = (_bf16(y, dt) @ _bf16(w, dt)).float()
    elif tier == 1:
        w = w.to(dt)
        w_h = _bf16(w, dt)
        w_l = _bf16(w - w_h, dt)
        y_h = _bf16(y, dt)
        y_l = _bf16(y - y_h, dt)
        p = ((y_h @ w_l).float() + (y_l @ w_h).float()) + (y_h @ w_h).float()
    else:
        p = (y @ w.to(dt)).float()
    return p.to(dt)


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
    n_rho, dp = Wt_bank.shape[0], Wt_bank.shape[1]
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
            axx, z = r[:ncp], r[ncp:2 * ncp]
            hx, atl = r[2 * ncp:2 * ncp + nxp], r[2 * ncp + nxp:]
            pri = (axx - z).abs().max()
            dua = ((hx + atl).to(dt) + g_row).abs().max()
            sp = torch.maximum(axx.abs().max(), z.abs().max())
            sd = torch.maximum(torch.maximum(hx.abs().max(),
                                             atl.abs().max()).to(dt),
                               g_row.abs().max())
            num = pri / sp.clamp_min(_TINY)
            den = dua / sd.clamp_min(_TINY)
            rho_new = torch.clamp(
                rho.to(dt) * torch.sqrt(num.to(dt) / den.clamp_min(_TINY)),
                c["rho_min"], c["rho_max"]).float()
            dua = dua.float()
            if adaptive_rho:
                rho_k = rhos32[k_idx]
                hi_t = bool(rho_new > rho_k * c["tol"])
                lo_t = bool(rho_new < rho_k / c["tol"])
                if rho_jump:
                    near = int(torch.argmin((log_rhos
                                             - torch.log(rho_new)).abs()))
                    new_idx = near if (hi_t or lo_t) else k_idx
                else:
                    up = hi_t and k_idx < n_rho - 1
                    dn = lo_t and k_idx > 0 and not up
                    new_idx = k_idx + int(up) - int(dn)
                if stride > 1 and ((k // ci) + 1) % stride != 0:
                    new_idx = k_idx
                k_idx = new_idx
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
        "ybuf", "ubuf", "xbuf", "part")]
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
        lib.k2_plan.argtypes = [i] * 7 + [ctypes.POINTER(i)] * 3
        lib.k2_plan.restype = i
        lib.k2_error_string.argtypes = [i]
        lib.k2_error_string.restype = ctypes.c_char_p
        lib._k2_typed = True
    return lib


def _raise_cuda(lib, code: int, what: str):
    msg = lib.k2_error_string(code).decode()
    raise RuntimeError(f"K2 {what} failed: CUDA error {code} ({msg})")


def rollout_plan(dp: int, nxp: int, ncp: int, nup: int, nplp: int,
                 dtype=torch.float32, w_dtype=None) -> dict:
    """The launch shape of K2 on the current GPU: blocks, y lanes
    (columns of W) per block, dynamic shared memory, and whether every
    operand slab is held in shared memory (else streamed from L2)."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(3)]
    rc = lib.k2_plan(dp, nxp, ncp, nup, nplp, _DTYPE_CODE[dtype],
                     _DTYPE_CODE[w_dtype or dtype],
                     *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _raise_cuda(lib, rc, "plan")
    blocks, smem, resident = (v.value for v in vals)
    return {"blocks": blocks, "cols_per_block": -(-dp // blocks),
            "smem_bytes": smem, "resident": bool(resident)}


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
    ybuf = torch.empty((2, dp), dtype=dt, device=dev)
    ubuf = torch.empty((nup,), dtype=dt, device=dev)
    xbuf = torch.empty((nplp,), dtype=dt, device=dev)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    part = torch.empty((n_sm, 4), dtype=torch.float64, device=dev)
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
        y_f=ptr(y_f), ybuf=ptr(ybuf), ubuf=ptr(ubuf), xbuf=ptr(xbuf),
        part=ptr(part),
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
        return _full_rollout_cuda(ops, rho_ind0, n_rho=n_rho, dp=dp, **kw)
    return full_rollout_ref(Wt_bank, bias_c, M_aff, rhos, M_res, g0w, gl_op,
                            lo0, hi0, S_u, Bdw, y0, x0, noise, rho_ind0,
                            **kw)


full_rollout.launches = 0
