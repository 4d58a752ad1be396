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
otherwise.

A batched solver split over a mesh of more than one rank checkpoints by
shard: every rank writes ``<prefix>.proc<k>of<n>.npz`` holding its rows of
the batch (call it on every rank with the same path). Such a set restores
onto the same layout (``load_batched_solver(path, mesh=)``: each rank loads
its own file) or into one process (the shards merged in rank order). A
tensor-parallel ``ReLU_QP`` saves its whole bank (its column blocks
gathered), which loads into one device.
"""
from __future__ import annotations

import glob
import json
import re
import time

import numpy as np
import torch

from ..batch import _ROW_ALIGN, BatchedReLU_QP, _hetero_eps_floor
from ..classes import SETTINGS_FIELDS, Settings
from ..core.bank import (effective_rho_ladder, effective_rho_ladder_batch,
                         equality_mask, stacked_dim)
from ..core.ladder import initial_rho_index
from ..ops.fused_step import pad_dim, round_up
from ..parallel.sharded import gather_rows, mesh_group
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
    if solver._tp_group is not None:
        # a tensor-parallel bank: every rank's column block, gathered (call
        # on every rank)
        W = gather_rows(W.float() if W.dtype == torch.bfloat16 else W,
                        solver._tp_group, axis=2)
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

def _shard_path(path: str, pid: int, n: int) -> str:
    """Rank ``pid``'s file of an ``n``-rank checkpoint: the caller's path is
    the common prefix, each rank writes ``<prefix>.proc<k>of<n>.npz``."""
    base = path[:-4] if path.endswith(".npz") else path
    return f"{base}.proc{pid}of{n}.npz"


def save_batched_solver(m, path: str) -> None:
    """Write a set-up ``BatchedReLU_QP`` (banks, biases, state, settings)
    to ``path``. Split over a mesh of more than one rank, every rank writes
    its rows to ``<path>.proc<k>of<n>.npz`` (call it on every rank)."""
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
    multi = m._size > 1
    l_np, u_np, g_np, H_np, A_np = (m._l_np, m._u_np, m._g_np, m._H_np,
                                    m._A_np)
    B_save, Bp_save = m.B_n, m.B_pad
    G, lo, hi, Y, bias, rho_ind = (_np(t) for t in (
        m.G, m.lo, m.hi, m.Y, m.bias_all, m.rho_ind))
    if multi:
        # this rank's rows, unpadded (a merge concatenates them in rank
        # order); the masters the caller passed are cut to the same rows
        path = _shard_path(path, m._rank, m._size)
        B_save = Bp_save = Bl = m.B_local
        G, lo, hi, Y = G[:Bl], lo[:Bl], hi[:Bl], Y[:Bl]
        bias = bias[:Bl] if m.hetero else bias[:, :Bl]
        if rho_ind.ndim:
            rho_ind = rho_ind[:Bl]
        rows = m._rows
        l_np, u_np, g_np = (None if a is None else a[rows]
                            for a in (l_np, u_np, g_np))
        H_np, A_np = (a if a is None or a.ndim < 3 else a[rows]
                      for a in (H_np, A_np))
    np.savez(
        path,
        settings=_settings_json(m.settings),
        n_procs=np.asarray(m._size), proc_id=np.asarray(m._rank),
        hetero=np.asarray(m.hetero), rho_mode=np.asarray(m.rho_mode),
        B_n=np.asarray(B_save), B_pad=np.asarray(Bp_save),
        nx=np.asarray(m.nx), nc=np.asarray(m.nc), Dp=np.asarray(m.Dp),
        Wt_bank=_np(m._Wt_hi if m._Wt_hi is not None else m.Wt_bank),
        B_bank=B_bank, H=_np(m.H_dev), A=_np(m.A_dev), G=G,
        lo=lo, hi=hi, Y=Y, rho_ind=rho_ind,
        rhos=m.rhos_np, unx=_np(m._unx), unz=_np(m._unz),
        unlam=_np(m._unlam), scal_D=np.asarray(m.scal.D),
        scal_E=np.asarray(m.scal.E), scal_c=np.asarray(m.scal.c),
        rho_cap=np.asarray(m.rho_cap), eq_pattern=eq, l_np=l_np,
        u_np=u_np, bias_all=bias, G_lo=_EMPTY, B_lo=_EMPTY,
        H_np=H_np, A_np=A_np, g_np=g_np,
        rho_mode_req=np.asarray(m._rho_mode_req),
        bank_build=np.asarray(m._bank_build),
        tail_policy=np.asarray(m.tail_policy))


# the rank of a per-problem scaling array (a shared one has one less)
_BATCH_NDIM = {"scal_D": 2, "scal_E": 2, "scal_c": 1}


def _merge_shards(path: str) -> dict:
    """Reassemble a shard-file checkpoint (``<prefix>.proc<k>of<n>.npz``)
    into one record, the ranks' rows concatenated in rank order; ``path``
    is the prefix or one shard's name (whose n pins the set)."""
    base = path[:-4] if path.endswith(".npz") else path
    suffix = re.search(r"\.proc\d+of(\d+)$", base)
    base = re.sub(r"\.proc\d+of\d+$", "", base)
    if suffix:
        n = int(suffix.group(1))
    else:
        first = sorted(glob.glob(f"{base}.proc0of*.npz"))
        if not first:
            raise FileNotFoundError(
                f"no checkpoint at {path} and no multi-host shard files "
                f"{base}.proc0of*.npz")
        if len(first) > 1:
            # shard sets of different sizes share the prefix: refuse
            # rather than mix them
            raise ValueError(
                f"ambiguous checkpoint: multiple shard sets match {base} "
                f"({', '.join(first)}); delete the stale set or pass one "
                f"shard file explicitly (e.g. {first[0]}) to pin the set")
        n = int(first[0].rsplit("of", 1)[1][:-4])
    shards = [_load_npz(_shard_path(base, k, n)) for k in range(n)]
    d0 = shards[0]
    hetero = bool(d0["hetero"])
    # batch-led keys concatenate in rank order; the shared ones are the
    # same in every shard (shard 0's)
    cat0 = ["G", "G_lo", "lo", "hi", "Y", "l_np", "u_np", "g_np"]
    if str(d0["rho_mode"]) != "shared":
        cat0.append("rho_ind")
    if hetero:
        cat0 += ["Wt_bank", "B_bank", "H", "A", "unx", "unz", "unlam",
                 "bias_all", "H_np", "A_np", "scal_D", "scal_E", "scal_c",
                 "rho_cap"]
        if d0["B_lo"].size:
            cat0.append("B_lo")
    merged = dict(d0)
    for key in cat0:
        # an unscaled hetero batch's identity scaling is shared: (nx,) D
        # and E, a scalar c
        if key in d0 and d0[key].ndim >= _BATCH_NDIM.get(key, 1):
            merged[key] = np.concatenate([s[key] for s in shards], axis=0)
    if not hetero:
        # the shared regime's bias is (N_rho, B, Dp): batch axis 1
        merged["bias_all"] = np.concatenate([s["bias_all"] for s in shards],
                                            axis=1)
    merged["B_n"] = np.asarray(sum(int(s["B_n"]) for s in shards))
    merged["B_pad"] = merged["B_n"]
    merged["n_procs"] = np.asarray(1)
    return merged


def _load_record(path: str) -> dict:
    """One file's record, or the merged shard set at ``path``."""
    try:
        data = _load_npz(path)
    except FileNotFoundError:
        return _merge_shards(path)
    return _merge_shards(path) if int(data.get("n_procs", 1)) > 1 else data


def load_batched_solver(path: str, mesh=None, axis_name: str = "qp",
                        device=None):
    """Restore a ``BatchedReLU_QP`` from ``save_batched_solver``'s file(s)
    without factorizing the banks, on ``device`` (default ``cuda``, or the
    mesh's device), in the layout a fresh setup would give it (D and B
    re-padded to the backend's). A ``"repack"`` file restored into a regime
    that cannot run repack (a heterogeneous batch, a two-phase refine, a
    mesh) runs ``"dense"``, as in the JAX package. A file without the fp64
    problem masters loads and solves; its ``update_matrices`` raises.

    A shard set restores two ways. With a ``mesh`` of the set's size, every
    rank loads its own file and holds its rows, as after
    ``setup(process_local=True)`` (call it on every rank). Without a mesh
    (or on a one-rank mesh), the shards are merged into one batch in rank
    order."""
    t0 = time.perf_counter()
    group, rank, size = None, 0, 1
    if mesh is not None:
        group, rank, size, mdev = mesh_group(mesh, axis_name)
        if device is None:
            device = mdev
    if size > 1:
        shard = _shard_path(path, rank, size)
        data = _load_npz(shard)
        if int(data.get("n_procs", 1)) != size:
            raise ValueError(
                f"checkpoint {shard} was written by "
                f"{int(data.get('n_procs', 1))} processes but this mesh has "
                f"{size} — restore on the same layout, or single-process")
    else:
        data = _load_record(path)
    stng_kw = json.loads(str(data["settings"]))
    stng_kw["device"] = device
    m = BatchedReLU_QP()
    m.settings = Settings(**stng_kw)
    stng = m.settings
    dtype, dev = stng.precision_dtype, stng.device
    m.mesh, m.axis_name = mesh, axis_name
    m._group, m._rank, m._size = group, rank, size
    m._process_local = size > 1
    m.hetero = bool(data["hetero"])
    m.rho_mode = str(data["rho_mode"])
    m.B_local, m.nx, m.nc = (int(data["B_n"]), int(data["nx"]),
                             int(data["nc"]))
    m.B_n = m.B_local * size
    Bn, nx, nc = m.B_local, m.nx, m.nc
    m._rows = slice(0, Bn)
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
    if m.tail_policy == "repack" and (m.hetero or mesh is not None or (
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
        if group is not None:
            t = torch.tensor([m._eps_floor], dtype=torch.float64, device=dev)
            torch.distributed.all_reduce(
                t, op=torch.distributed.ReduceOp.MAX, group=group)
            m._eps_floor = float(t.item())
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
