"""Solver checkpoints: save a set-up solver to one ``.npz``, load it back.

A checkpoint holds the problem data, the settings, the weight bank(s) in the
runtime layout with their fp64 B masters, and the warm-start state, so a
deployment resumes without paying the setup's factorizations again: a load
is file IO and the copy to the device. ``save_solver`` / ``load_solver``
serve ``ReLU_QP``; ``save_batched_solver`` / ``load_batched_solver`` serve
``BatchedReLU_QP``, where the per-problem banks of a heterogeneous batch
are the costly part.

The files use the JAX package's ``.npz`` keys, so a file written by either
package loads into the other. A file whose layout differs from the one the
loading solver runs (the JAX package on the CPU does not pad D or B) is
re-padded on load. Files are written uncompressed (``np.savez``; the JAX
package compresses, and either reads both): a B=1024 heterogeneous batch's
banks are ~2 GB, which zlib takes tens of seconds to pack. The port keeps no
cast residuals of the fp64 masters: it writes empty ``B_lo`` / ``G_lo`` and,
on load, rebuilds its fp64 B master as ``B_bank + B_lo`` where a file
carries ``B_lo``. bf16 banks are saved as
their fp32 copy. Loaded solvers run on ``cuda`` unless ``device`` says
otherwise. Single-process files only: the multi-device shard files wait for
the multi-device port (ROADMAP A.6).
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch

from ..batch import _ROW_ALIGN, BatchedReLU_QP, _hetero_eps_floor
from ..classes import SETTINGS_FIELDS, Settings
from ..core.bank import (effective_rho_ladder, effective_rho_ladder_batch,
                         equality_mask, stacked_dim)
from ..core.ladder import initial_rho_index
from ..ops.fused_step import pad_dim, round_up
from ..solver import ReLU_QP, _sync
from .scaling import Scaling, residual_unscale_weights

__all__ = ["save_solver", "load_solver", "save_batched_solver",
           "load_batched_solver"]

# every Settings field but ``device`` (placement, not state)
_SETTINGS_KEYS = [k for k in SETTINGS_FIELDS if k != "device"]
_EMPTY = np.zeros((0,), np.float32)


def _np(t) -> np.ndarray:
    """Host copy; bf16 banks round-trip through fp32 (.npz has no bf16)."""
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.detach().cpu().numpy()


def _settings_json(settings) -> str:
    stng = {k: getattr(settings, k) for k in _SETTINGS_KEYS}
    stng["precision"] = str(settings.precision_dtype).replace("torch.", "")
    return json.dumps(stng)


def _load_npz(path: str) -> dict:
    """Every array of the file at ``path`` (or ``path + ".npz"``, the name
    ``np.savez`` gives a path without the suffix)."""
    try:
        z = np.load(path, allow_pickle=False)
    except FileNotFoundError:
        z = np.load(path + ".npz", allow_pickle=False)
    with z:
        return {k: z[k] for k in z.files}


def _fit(a, shape, fill=0.0) -> np.ndarray:
    """``a`` in the leading corner of a ``shape`` array of ``fill``, in
    ``a``'s dtype (``a`` itself where it has that shape)."""
    a = np.asarray(a)
    if a.shape == tuple(shape):
        return a
    out = np.full(shape, fill, dtype=a.dtype)
    out[tuple(slice(0, min(m, n)) for m, n in zip(a.shape, shape))] = \
        a[tuple(slice(0, min(m, n)) for m, n in zip(a.shape, shape))]
    return out


# --------------------------------------------------------------------- #
# single QP                                                             #
# --------------------------------------------------------------------- #

def save_solver(solver, path: str) -> None:
    """Write a set-up ``ReLU_QP`` (bank, state, settings) to ``path``."""
    if not getattr(solver, "_ready", False):
        raise RuntimeError("solver not set up")
    # under a bf16 bank the fp32 refine copy, so a reload loses nothing
    W = solver._W_hi if solver._W_hi is not None else solver.bank.W
    np.savez(
        path,
        settings=_settings_json(solver.settings),
        H=solver.QP.H_np, g=solver.QP.g_np, A=solver.QP.A_np,
        l=solver.QP.l_np, u=solver.QP.u_np,
        bank_W=_np(W), bank_B=solver._B_np, bank_b=_np(solver.bank.b),
        rhos=solver.rhos_np, y=_np(solver.y),
        rho_ind=np.asarray(solver.rho_ind), Dp=np.asarray(solver.Dp),
        scal_D=solver.scal.D, scal_E=solver.scal.E,
        scal_c=np.asarray(solver.scal.c), rho_cap=np.asarray(solver.rho_cap))


def load_solver(path: str, device=None):
    """Restore a ``ReLU_QP`` from ``save_solver``'s file without
    factorizing: the saved bank goes to ``device`` (default ``cuda``),
    re-padded to the backend's layout. Every backend restores, ``"fused"``
    included (its operands are derived, not factorized)."""
    t0 = time.perf_counter()
    data = _load_npz(path)
    stng_kw = json.loads(str(data["settings"]))
    stng_kw["device"] = device
    solver = ReLU_QP()
    solver.settings = Settings(**stng_kw)
    D_s, E_s = np.asarray(data["scal_D"]), np.asarray(data["scal_E"])
    c_s = float(data["scal_c"])
    scal = Scaling(D=D_s, E=E_s, c=c_s, Dinv=1.0 / D_s, Einv=1.0 / E_s,
                   cinv=1.0 / c_s)
    # files written before the cap was saved were built uncapped
    cap = float(data["rho_cap"]) if "rho_cap" in data else float("inf")
    solver._set_problem(data["H"], data["g"], data["A"], data["l"],
                        data["u"], scal=scal, rho_cap=cap)
    D = solver.D
    W_rt = np.asarray(data["bank_W"], np.float64)[:, :D, :D]
    solver._set_bank(np.swapaxes(W_rt, 1, 2),
                     np.asarray(data["bank_B"], np.float64)[:, :D],
                     np.asarray(data["bank_b"], np.float64)[:, :D])
    solver._set_operands()
    y = np.zeros(solver.Dp)
    y[:D] = np.asarray(data["y"], np.float64)[:D]
    solver.y = solver._put(y)
    solver.rho_ind = int(data["rho_ind"])
    _sync(solver.settings.device)
    solver.info.setup_time = time.perf_counter() - t0
    solver.info.update_time = 0.0
    solver._ready = True
    return solver


# --------------------------------------------------------------------- #
# batched solver                                                        #
# --------------------------------------------------------------------- #

def save_batched_solver(m, path: str) -> None:
    """Write a set-up ``BatchedReLU_QP`` (banks, biases, state, settings)
    to ``path``."""
    if not getattr(m, "_ready", False):
        raise RuntimeError("solver not set up")
    if m._B_dev is not None:
        B_bank = _np(m._B_dev)
    elif m.hetero:   # the host masters are (B, N, D, nx): pad to Dp
        B_bank = _fit(m._B_np, m._B_np.shape[:2] + (m.Dp, m.nx))
    else:
        B_bank = m._B_np
    eq = (np.zeros((0,), np.bool_) if m._eq_pattern is None
          else np.asarray(m._eq_pattern, np.bool_))
    np.savez(
        path,
        settings=_settings_json(m.settings),
        n_procs=np.asarray(1), proc_id=np.asarray(0),
        hetero=np.asarray(m.hetero), rho_mode=np.asarray(m.rho_mode),
        B_n=np.asarray(m.B_n), B_pad=np.asarray(m.B_pad),
        nx=np.asarray(m.nx), nc=np.asarray(m.nc), Dp=np.asarray(m.Dp),
        Wt_bank=_np(m._Wt_hi if m._Wt_hi is not None else m.Wt_bank),
        B_bank=B_bank, H=_np(m.H_dev), A=_np(m.A_dev), G=_np(m.G),
        lo=_np(m.lo), hi=_np(m.hi), Y=_np(m.Y), rho_ind=_np(m.rho_ind),
        rhos=m.rhos_np, unx=_np(m._unx), unz=_np(m._unz),
        unlam=_np(m._unlam), scal_D=np.asarray(m.scal.D),
        scal_E=np.asarray(m.scal.E), scal_c=np.asarray(m.scal.c),
        rho_cap=np.asarray(m.rho_cap), eq_pattern=eq, l_np=m._l_np,
        u_np=m._u_np, bias_all=_np(m.bias_all), G_lo=_EMPTY, B_lo=_EMPTY,
        H_np=m._H_np, A_np=m._A_np, g_np=m._g_np,
        rho_mode_req=np.asarray(m._rho_mode_req),
        bank_build=np.asarray(m._bank_build),
        tail_policy=np.asarray(m.tail_policy))


def load_batched_solver(path: str, mesh=None, axis_name: str = "qp",
                        device=None):
    """Restore a ``BatchedReLU_QP`` from ``save_batched_solver``'s file
    without factorizing the banks, on ``device`` (default ``cuda``), in the
    layout a fresh setup would give it (D and B re-padded to the backend's).
    A ``"repack"`` file restored into a regime that cannot run repack (a
    heterogeneous batch, a two-phase refine) runs ``"dense"``, as in the
    JAX package. A file without the fp64 problem masters loads and solves;
    its ``update_matrices`` raises."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (restoring onto several devices) is not ported yet "
            "(ROADMAP A.6)")
    t0 = time.perf_counter()
    data = _load_npz(path)
    if int(data.get("n_procs", 1)) > 1:
        raise NotImplementedError(
            "multi-process shard files are not ported yet (ROADMAP A.6)")
    stng_kw = json.loads(str(data["settings"]))
    stng_kw["device"] = device
    m = BatchedReLU_QP()
    m.settings = Settings(**stng_kw)
    stng = m.settings
    dtype, dev = stng.precision_dtype, stng.device
    m.axis_name = axis_name
    m.hetero = bool(data["hetero"])
    m.rho_mode = str(data["rho_mode"])
    m.B_n, m.nx, m.nc = int(data["B_n"]), int(data["nx"]), int(data["nc"])
    Bn, nx, nc = m.B_n, m.nx, m.nc
    D = m.D = stacked_dim(nx, nc)
    m.rhos_np = np.asarray(data["rhos"], np.float64)
    N = len(m.rhos_np)

    # the layout a fresh setup picks (BatchedReLU_QP.setup)
    m._use_pallas = (not m.hetero and m.rho_mode == "shared"
                     and stng.backend != "xla")
    m._hetero_pallas = m.hetero and stng.backend != "xla"
    m.Dp = pad_dim(D) if m._use_pallas or m._hetero_pallas else D
    m.B_pad = round_up(Bn, _ROW_ALIGN) if m._use_pallas else Bn
    Dp, Bp = m.Dp, m.B_pad

    D_s, E_s = np.asarray(data["scal_D"]), np.asarray(data["scal_E"])
    c_s = np.asarray(data["scal_c"], np.float64)
    c_s = float(c_s) if c_s.ndim == 0 else c_s
    m.scal = Scaling(D=D_s, E=E_s, c=c_s, Dinv=1.0 / D_s, Einv=1.0 / E_s,
                     cinv=1.0 / c_s)
    eq = np.asarray(data["eq_pattern"])
    m._eq_pattern = None if eq.size == 0 else eq
    m._l_np = np.asarray(data["l_np"], np.float64)
    m._u_np = np.asarray(data["u_np"], np.float64)
    if "H_np" in data:
        m._H_np, m._A_np, m._g_np = (np.asarray(data[k], np.float64)
                                     for k in ("H_np", "A_np", "g_np"))
        m._rho_mode_req = str(data["rho_mode_req"])
        m._bank_build = ("device" if str(data["bank_build"]) == "device"
                         else "host")
    else:
        m._H_np = m._A_np = m._g_np = None
        m._rho_mode_req = m.rho_mode
        m._bank_build = "host"
    m.tail_policy = (str(data["tail_policy"]) if "tail_policy" in data
                     else "dense")
    if m.tail_policy == "repack" and (m.hetero or (
            stng.refine and stng.iter_precision != "highest")):
        m.tail_policy = "dense"   # restored into a regime repack cannot run
    m._repack_sched = (m._make_repack_schedule()
                       if m.tail_policy == "repack" else None)

    def put(a, dt=None):
        """To the device in the file's dtype, then cast there: a 1.2 GB
        fp32 bank is not widened to fp64 on the host first."""
        return torch.as_tensor(np.require(a, requirements=("C", "W"))).to(
            device=dev, dtype=dt or dtype)
    wd = m._w_dtype(dtype)
    m._keep_hi = stng.iter_precision == "bf16" and stng.refine
    lead = (Bn, N) if m.hetero else (N,)
    Wt = _fit(data["Wt_bank"][..., :D, :D], lead + (Dp, Dp))
    m.Wt_bank = put(Wt, wd)
    m._Wt_hi = put(Wt) if m._keep_hi else None
    # the fp64 B master: hi + lo where the file has the cast residual
    B64 = np.asarray(data["B_bank"], np.float64)
    if data["B_lo"].size:
        B64 = B64 + np.asarray(data["B_lo"], np.float64)
    B64 = B64[..., :D, :]
    m._B_np = m._B_dev = None
    if m.hetero and m._bank_build == "device":
        m._B_dev = put(_fit(B64, lead + (Dp, nx)), torch.float64)
    elif m.hetero:
        m._B_np = np.ascontiguousarray(B64)
    else:
        m._B_np = _fit(B64, (N, Dp, nx))
    m.H_dev, m.A_dev = put(data["H"]), put(data["A"])
    m.G = put(_fit(data["G"][:Bn], (Bp, nx)))
    m.lo = put(_fit(data["lo"][:Bn, :D], (Bp, Dp), -np.inf))
    m.hi = put(_fit(data["hi"][:Bn, :D], (Bp, Dp), np.inf))
    m.Y = put(_fit(data["Y"][:Bn, :D], (Bp, Dp)))
    bias = np.asarray(data["bias_all"])
    m.bias_all = put(_fit(bias[:, :Bn, :D], (N, Bp, Dp)) if not m.hetero
                     else _fit(bias[..., :D], (Bn, N, Dp)))
    m.rhos = put(m.rhos_np)
    r0 = initial_rho_index(m.rhos_np, stng.rho)
    ind = np.asarray(data["rho_ind"], np.int64).reshape(-1)
    if m.rho_mode == "shared":
        m.rho_ind = torch.tensor(int(ind[0]), dtype=torch.int32, device=dev)
    else:
        r = np.full((Bp,), r0, np.int32)
        r[:Bn] = ind[:Bn]
        m.rho_ind = torch.as_tensor(r, device=dev)
    m._unx, m._unz, m._unlam = (put(data[k]) for k in ("unx", "unz",
                                                       "unlam"))

    # derived state, as setup forms it
    if m.hetero:
        caps = (np.asarray(data["rho_cap"], np.float64) if "rho_cap" in data
                else np.full(Bn, np.inf))
        m.rho_cap = np.broadcast_to(caps, (Bn,)).copy()
        m._eps_floor = _hetero_eps_floor(m.rho_cap, data["A"], dtype, nx)
        m._rho_eff_np = effective_rho_ladder_batch(
            m.rhos_np, equality_mask(m._l_np, m._u_np, stng.eq_tol),
            m.rho_cap)
    else:
        m.rho_cap = (float(data["rho_cap"]) if "rho_cap" in data
                     else float("inf"))
        if m._A_np is not None:
            m._A_scaled_np = m._A_np * E_s[:, None] * D_s[None, :]
            m._H_scaled_np = c_s * (m._H_np * D_s[:, None] * D_s[None, :])
        else:
            m._A_scaled_np = np.asarray(data["A"], np.float64)
            m._H_scaled_np = np.asarray(data["H"], np.float64)
        m._sigma_max_sq = None
        m._rho_eff_np = effective_rho_ladder(m.rhos_np, m._eq_pattern,
                                             m.rho_cap)
    m._rho_eff = put(m._rho_eff_np) if stng.alpha != 1.0 else None
    wp, wdu = residual_unscale_weights(m.scal, stng)
    m._w_pri_np, m._w_dua_np = wp, wdu
    m._w_pri = m._w_dua = None
    if wp is not None:
        m._w_pri = put(np.broadcast_to(wp, (Bn, nc)) if m.hetero else wp)
        m._w_dua = put(wdu)
    _sync(dev)
    m.info.setup_time = time.perf_counter() - t0
    m.info.update_time = 0.0
    m._ready = True
    return m
