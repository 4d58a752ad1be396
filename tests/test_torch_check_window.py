"""The check window's plain versions against the JAX package.

``check_window_ref`` (kernel C1's plain version: a single QP's check) and
``batched_check_ref`` (C2's: the shared, per-problem and heterogeneous
batches) take the loop state before the check and the chunk runner's
output, and return the new state. The same seeded numpy inputs (fp64) go
through them and through the JAX package's own check arithmetic
(``compute_residuals_op``, ``compute_residuals``, ``rho_ladder_step``,
``infeasibility_certificates`` of ``reluqp_tpu/core/iteration.py``;
``batched_residuals``, ``_hetero_residuals`` and
``batched_infeasibility_certificates`` of ``reluqp_tpu/core/batched.py``),
composed as the JAX loops' ``step`` composes them. Residuals, estimates and
states agree within 1e-12; rungs, status, iterations and flags are equal.
The wrappers ``check_window`` and ``batched_check`` write the same state
into static buffers on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reluqp_tpu.core.batched as jb
import reluqp_tpu.core.iteration as ji

from reluqp_tpu_torch.core import batched as tb
from reluqp_tpu_torch.core import iteration as ti
from reluqp_tpu_torch.ops.check_window import (batched_check,
                                               batched_check_ref,
                                               check_window, check_window_ref)
from reluqp_tpu_torch.ops.fused_step import pad_dim
from reluqp_tpu_torch.ops.solve_kernel import build_residual_operator

TOL = 1e-12   # fp64; the two sum the same products in other orders
N_RHO = 8
RHOS = np.geomspace(1e-3, 1e3, N_RHO)
F64 = torch.float64


def _t(a, dtype=F64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _close(a, b, what):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               torch.as_tensor(b).double().numpy(),
                               rtol=TOL, atol=TOL, err_msg=what)


def _eq(a, b, what):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  torch.as_tensor(b).long().numpy(),
                                  err_msg=what)


# --------------------------------------------------------------------- #
# C1: a single QP                                                       #
# --------------------------------------------------------------------- #

def _spd(rng, n):
    M = rng.randn(n, n)
    return M @ M.T / n + np.eye(n)


# option sets: (alpha, M_res, weights, certificates, phase, stride, jump)
SINGLE = {
    "mres": (1.0, True, False, None, "", 1, False),
    "mres_weighted": (1.0, True, True, None, "", 1, False),
    "matvec": (1.0, False, False, None, "", 1, False),
    "alpha": (1.6, False, True, None, "", 1, False),
    "certs_feasible": (1.0, False, False, "feasible", "", 1, False),
    "certs_mres": (1.0, True, False, "feasible", "", 1, False),
    "certs_pinf": (1.0, False, False, "pinf", "", 1, False),
    "certs_dinf": (1.6, False, False, "dinf", "", 1, False),
    "phase_a": (1.0, True, False, None, "A", 1, False),
    "stride": (1.6, False, False, None, "", 3, False),
    "jump": (1.0, True, False, None, "", 1, True),
    "tail": (1.6, False, True, None, "tail", 1, False),
}


def _single_case(name, seed, eps_abs):
    """One window's check inputs for both packages (fp64 numpy)."""
    alpha, mres, weights, certs, phase, stride, jump = SINGLE[name]
    rng = np.random.RandomState(seed)
    nx, nc = (2, 2) if certs in ("pinf", "dinf") else (9, 6)
    H, A, g = _spd(rng, nx), rng.randn(nc, nx), rng.randn(nx)
    lo, hi = -1.0 - rng.rand(nc), 1.0 + rng.rand(nc)
    hi[0] = np.inf
    if certs == "pinf":
        # x0 >= 1 and x0 <= 0: dλ = (-1, 1) has Aᵀdλ = 0 and support -1
        A = np.array([[1.0, 0.0], [1.0, 0.0]])
        lo, hi = np.array([1.0, -np.inf]), np.array([np.inf, 0.0])
    if certs == "dinf":
        # H dx = 0, gᵀdx = -1 and A dx = 0 along dx = (0, -1)
        H, g = np.diag([1.0, 0.0]), np.array([0.0, 1.0])
        A = np.array([[1.0, 0.0], [0.0, 0.0]])
    D = nx + 2 * nc
    dp = pad_dim(D)
    y = np.zeros(dp)
    y[:D] = rng.randn(D)
    ladder_eff = RHOS[:, None] * (1.0 + rng.rand(N_RHO, nc))
    c = dict(name=name, nx=nx, nc=nc, dp=dp, H=H, A=A, g=g, y=y,
             lo=np.r_[np.full(nx, -np.inf), lo, np.full(dp - nx - nc, -np.inf)],
             hi=np.r_[np.full(nx, np.inf), hi, np.full(dp - nx - nc, np.inf)],
             w_pri=rng.rand(nc) + 0.5 if weights else None,
             w_dua=rng.rand(nx) + 0.5 if weights else None,
             rho_eff=ladder_eff if alpha != 1.0 else None,
             alpha=alpha, mres=mres, certs=certs is not None, phase=phase,
             stride=stride, jump=jump, ind=int(rng.randint(1, N_RHO - 1)),
             rho=float(RHOS[3] * np.exp(rng.randn())), k=25 * (2 + seed % 3),
             eps_abs=eps_abs, ci=25, budget=400, cap_a=200,
             best_p=float(rng.rand()), best_d=float(rng.rand()),
             n_stall=int(seed % 2), status=-1)
    if certs == "pinf":
        dlam = np.array([-1.0, 1.0])
        c["x_prev"] = y[:nx] - 1e-9 * rng.randn(nx)
    elif certs == "dinf":
        dlam = 1e-9 * rng.randn(nc)
        c["x_prev"] = y[:nx] - np.array([0.0, -1.0])
    else:
        dlam = 0.1 * rng.randn(nc)
        c["x_prev"] = y[:nx] - 0.1 * rng.randn(nx)
    c["dlam"] = dlam
    return c


def _lam_np(c, y, ind):
    nx, nc = c["nx"], c["nc"]
    last = y[nx + nc:nx + 2 * nc]
    if c["alpha"] == 1.0:
        return last
    return c["rho_eff"][ind] * (last - y[nx:nx + nc])


def _mres(c):
    """The stacked residual operator and its g row (the port's builder, in
    fp64; the same matrix goes to both packages)."""
    M, _, nxp, ncp = build_residual_operator(
        c["H"], c["A"], c["g"], c["dp"], F64, w_pri=c["w_pri"],
        w_dua=c["w_dua"], lam_segment=True, device="cpu")
    gv = c["g"] if c["w_dua"] is None else c["w_dua"] * c["g"]
    g_row = np.zeros(nxp)
    g_row[:c["nx"]] = gv
    return M.numpy(), g_row, nxp, ncp


def _eps(c):
    return (c["eps_abs"] * np.sqrt(c["nc"]), c["eps_abs"] * np.sqrt(c["nx"]))


def _jax_single(c):
    """The JAX package's check of this window (its loop's ``step`` after
    the chunk runner)."""
    nx, nc = c["nx"], c["nc"]
    j = lambda a: None if a is None else jnp.asarray(a, jnp.float64)
    y, ind, rho = j(c["y"]), jnp.asarray(c["ind"], jnp.int32), c["rho"]
    if c["mres"]:
        M, g_row, nxp, ncp = _mres(c)
        pri, dua, rho_new = ji.compute_residuals_op(
            j(M), j(g_row), y, nxp, ncp, jnp.float64(rho), 1e-6, 1e6)
    else:
        pri, dua, rho_new = ji.compute_residuals(
            j(c["H"]), j(c["A"]), j(c["g"]), y[:nx], y[nx:nx + nc],
            j(_lam_np(c, c["y"], c["ind"])), jnp.float64(rho), 1e-6, 1e6,
            j(c["w_pri"]), j(c["w_dua"]))
    eps_pri, eps_dua = _eps(c)
    solved = bool(pri < eps_pri) and bool(dua < eps_dua)
    k = c["k"] + c["ci"]
    out = dict(pri=pri, dua=dua, rho=rho_new, k=k)
    if c["phase"] == "tail":
        out.update(y=c["y"], ind=c["ind"], status=1 if solved else c["status"])
        return out
    lam_now = _lam_np(c, c["y"], c["ind"])
    new = ind
    y_out = c["y"].copy()
    new = ji.rho_ladder_step(j(RHOS), ind, rho_new, 5.0, c["jump"])
    if c["stride"] > 1 and (-(-k // c["ci"])) % c["stride"] != 0:
        new = ind
    new = int(new)
    if c["alpha"] != 1.0:
        s = c["rho_eff"][c["ind"]] / c["rho_eff"][new]
        z = y_out[nx:nx + nc]
        y_out[nx + nc:nx + 2 * nc] = z + s * (y_out[nx + nc:nx + 2 * nc] - z)
    status = 1 if solved else -1
    if c["certs"]:
        pinf, dinf = ji.infeasibility_certificates(
            j(c["H"]), j(c["A"]), j(c["g"]), j(c["lo"][nx:nx + nc]),
            j(c["hi"][nx:nx + nc]), j(c["y"][:nx] - c["x_prev"]),
            j(c["dlam"]), 1e-4, 1e-4)
        if status < 0 and bool(pinf):
            status = 2
        if status < 0 and bool(dinf):
            status = 3
        out.update(pinf=bool(pinf), dinf=bool(dinf), x_prev=c["y"][:nx],
                   lam_prev=lam_now)
    running = status < 0 and k < c["budget"]
    out.update(y=y_out, ind=new, status=status, open=running,
               tail=status < 0)
    if c["phase"] == "A":
        p, d = float(pri), float(dua)
        improved = p < 0.97 * c["best_p"] or d < 0.97 * c["best_d"]
        n_stall = 0 if improved else c["n_stall"] + 1
        out.update(best_p=min(p, c["best_p"]), best_d=min(d, c["best_d"]),
                   n_stall=n_stall, k_fast=k,
                   open_a=n_stall < 2 and k < c["cap_a"] and running)
    return out


def _port_single(c):
    """The port's state, operands and settings for this window."""
    nx, nc = c["nx"], c["nc"]
    eps_pri, eps_dua = _eps(c)
    M_res = g_row = None
    if c["mres"]:
        M, g_np, _, _ = _mres(c)
        M_res, g_row = _t(M), _t(g_np)
    op = ti._Ops(_t(RHOS), _t(c["H"]), _t(c["A"]), _t(c["g"]), _t(c["lo"]),
                 _t(c["hi"]), None if c["w_pri"] is None else _t(c["w_pri"]),
                 None if c["w_dua"] is None else _t(c["w_dua"]),
                 None if c["rho_eff"] is None else _t(c["rho_eff"]),
                 M_res, g_row, ("bank", None))
    cfg = ti._Cfg(None, nx, nc, c["alpha"], True, c["jump"], 5.0, eps_pri,
                  eps_dua, 1e-6, 1e6, c["certs"], 1e-4, 1e-4, c["ci"],
                  c["budget"], c["stride"], c["cap_a"], 0.97,
                  c["phase"] == "A")
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    lam_prev = _lam_np(c, c["y"], c["ind"]) - c["dlam"]
    st = ti._Dev(_t(c["y"]), i32(c["ind"]), _t(c["rho"]), i32(c["k"]),
                 i32(c["status"]), _t(0.0), _t(0.0), i32(1), i32(1),
                 i32([0] * 7), _t(c["x_prev"]), _t(lam_prev), i32(1),
                 _t(c["best_p"]), _t(c["best_d"]), i32(c["n_stall"]), i32(0))
    y_new = _t(c["y"])
    return st, op, cfg, y_new


def _check_single(c, new, ref):
    for f in ("pri", "dua", "rho"):
        _close(ref[f], getattr(new, f), f"{c['name']}: {f}")
    _close(ref["y"], new.y, f"{c['name']}: y")
    _eq(ref["ind"], new.rho_ind, f"{c['name']}: rung")
    _eq(ref["status"], new.status, f"{c['name']}: status")
    _eq(ref["k"], new.k, f"{c['name']}: k")
    if c["phase"] == "tail":
        return
    _eq(ref["open"], new.open, f"{c['name']}: open")
    _eq(ref["tail"], new.tail, f"{c['name']}: tail")
    if c["certs"]:
        _close(ref["x_prev"], new.x_prev, f"{c['name']}: x_prev")
        _close(ref["lam_prev"], new.lam_prev, f"{c['name']}: lam_prev")
    if c["phase"] == "A":
        for f in ("best_p", "best_d"):
            _close(ref[f], getattr(new, f), f"{c['name']}: {f}")
        for f in ("n_stall", "k_fast", "open_a"):
            _eq(ref[f], getattr(new, f), f"{c['name']}: {f}")


@pytest.mark.parametrize("eps_abs", [1e-3, 1e3])
@pytest.mark.parametrize("name", sorted(SINGLE))
def test_check_window_ref_matches_jax(name, eps_abs):
    moved = set()
    for seed in range(4):
        c = _single_case(name, seed, eps_abs)
        ref = _jax_single(c)
        st, op, cfg, y = _port_single(c)
        new = check_window_ref(st, op, cfg, y, c["ci"], c["phase"])
        _check_single(c, new, ref)
        moved.add(int(new.rho_ind) != c["ind"])
        if c["certs"] and name != "certs_feasible" and name != "certs_mres":
            assert ref["pinf" if name == "certs_pinf" else "dinf"], name
            if eps_abs < 1:
                assert int(new.status) in (2, 3), name
    if name != "tail" and SINGLE[name][5] == 1:
        assert True in moved, f"{name}: the rung never moved"


@pytest.mark.parametrize("name", ["mres", "alpha", "certs_pinf", "phase_a",
                                  "tail"])
def test_check_window_writes_the_plain_state_on_cpu(name):
    c = _single_case(name, 1, 1e-3)
    st, op, cfg, y = _port_single(c)
    ref = check_window_ref(st, op, cfg, y, c["ci"], c["phase"])
    check_window(st, op, cfg, y, c["ci"], c["phase"])
    for f, a in zip(ti._Dev._fields, st):
        b = getattr(ref, f)
        if a is not None and f != "ctl":
            assert torch.equal(a, b.to(a.dtype)), f


# --------------------------------------------------------------------- #
# C2: a batch                                                           #
# --------------------------------------------------------------------- #

# (mode, alpha, weights, certificates, phase, stride, jump)
BATCH = {
    "shared": ("shared", 1.0, None, False, "", 1, False),
    "shared_weighted": ("shared", 1.0, "shared", False, "", 1, False),
    "shared_alpha": ("shared", 1.6, "rows", False, "", 1, False),
    "shared_certs": ("shared", 1.0, None, True, "", 1, False),
    "shared_phase_a": ("shared", 1.0, None, False, "A", 1, False),
    "shared_stride_jump": ("shared", 1.6, None, False, "", 2, True),
    "per_problem": ("per_problem", 1.0, "rows", False, "", 1, False),
    "per_problem_alpha_certs": ("per_problem", 1.6, None, True, "A", 1,
                                False),
    "per_problem_jump": ("per_problem", 1.0, None, False, "", 3, True),
    "hetero": ("hetero", 1.0, "rows", False, "", 1, False),
    "hetero_alpha_certs": ("hetero", 1.6, "rows", True, "A", 1, False),
    "hetero_jump": ("hetero", 1.6, None, False, "", 1, True),
}


def _batch_case(name, seed, B):
    mode, alpha, weights, certs, phase, stride, jump = BATCH[name]
    rng = np.random.RandomState(100 + seed)
    nx, nc = 7, 5
    D = nx + 2 * nc
    dp = pad_dim(D)
    hetero = mode == "hetero"
    H = (np.stack([_spd(rng, nx) for _ in range(B)]) if hetero
         else _spd(rng, nx))
    A = rng.randn(B, nc, nx) if hetero else rng.randn(nc, nx)
    Y = np.zeros((B, dp))
    Y[:, :D] = rng.randn(B, D)
    lo = np.full((B, dp), -np.inf)
    hi = np.full((B, dp), np.inf)
    lo[:, nx:nx + nc] = -1.0 - rng.rand(B, nc)
    hi[:, nx:nx + nc] = 1.0 + rng.rand(B, nc)
    hi[:, nx] = np.inf
    w = {None: (None, None),
         "shared": (rng.rand(nc) + 0.5, rng.rand(nx) + 0.5),
         "rows": (rng.rand(B, nc) + 0.5, rng.rand(B, nx) + 0.5)}[weights]
    rho_eff = None
    if alpha != 1.0:
        rho_eff = (RHOS[None, :, None] * (1.0 + rng.rand(B, N_RHO, nc))
                   if hetero else RHOS[:, None] * (1.0 + rng.rand(N_RHO, nc)))
    shared = mode == "shared"
    done = rng.rand(B) < 0.25
    ind = (int(rng.randint(1, N_RHO - 1)) if shared
           else rng.randint(0, N_RHO, size=B))
    # scale a third of the rows down so that they certify at eps 1e-2
    small = rng.rand(B) < 0.35
    Y[small] *= 1e-4
    return dict(name=name, mode=mode, shared=shared, hetero=hetero, B=B,
                nx=nx, nc=nc, dp=dp, H=H, A=A, G=rng.randn(B, nx) * np.where(
                    small, 1e-4, 1.0)[:, None], Y=Y, lo=lo, hi=hi,
                w_pri=w[0], w_dua=w[1], rho_eff=rho_eff, alpha=alpha,
                certs=certs, phase=phase, stride=stride, jump=jump, ind=ind,
                rho=RHOS[3] * np.exp(rng.randn(B)), done=done,
                pri=rng.rand(B), dua=rng.rand(B),
                iters=np.where(done, 50, 400), status=np.where(done, 1, 0),
                k=25 * (1 + seed % 3), ci=25, budget=400, cap_a=200,
                X_prev=Y[:, :nx] - 0.1 * rng.randn(B, nx),
                dLam=0.1 * rng.randn(B, nc), best_m=float(rng.randn()),
                best_open=int(B // 2 + seed), n_stall=int(seed % 2),
                eps_abs=1e-2)


def _lam_b(c, Y, ind):
    nx, nc = c["nx"], c["nc"]
    last = Y[:, nx + nc:nx + 2 * nc]
    if c["alpha"] == 1.0:
        return last
    rv = (c["rho_eff"][np.arange(c["B"]), ind] if c["hetero"]
          else c["rho_eff"][ind])
    return rv * (last - Y[:, nx:nx + nc])


def _jax_batch(c):
    """The JAX package's batched check of this window (its ``step``)."""
    nx, nc, B = c["nx"], c["nc"], c["B"]
    j = lambda a: None if a is None else jnp.asarray(a, jnp.float64)
    Y = c["Y"]
    ind = c["ind"]
    lam = _lam_b(c, Y, ind)
    res = jb._hetero_residuals if c["hetero"] else jb.batched_residuals
    pri_n, dua_n, rho_new = (np.asarray(v) for v in res(
        j(c["H"]), j(c["A"]), j(c["G"]), j(Y[:, :nx]), j(Y[:, nx:nx + nc]),
        j(lam), j(c["rho"]), 1e-6, 1e6, j(c["w_pri"]), j(c["w_dua"])))
    done = c["done"].copy()
    pri = np.where(done, c["pri"], pri_n)
    dua = np.where(done, c["dua"], dua_n)
    rho = np.where(done, c["rho"], rho_new)
    k = c["k"] + c["ci"]
    ind_j = jnp.asarray(ind, jnp.int32)
    if c["shared"]:
        n_act = int((~done).sum())
        logr = float(np.where(done, 0.0, np.log(rho_new)).sum())
        gm = np.exp(logr / max(n_act, 1)) if n_act else RHOS[ind]
        new = ji.rho_ladder_step(j(RHOS), ind_j, jnp.float64(gm), 5.0,
                                 c["jump"])
    else:
        new = ji.rho_ladder_step(j(RHOS), ind_j, j(rho_new), 5.0, c["jump"],
                                 done=jnp.asarray(done))
    new = np.asarray(new)
    if c["stride"] > 1 and (-(-k // c["ci"])) % c["stride"] != 0:
        new = np.asarray(ind)
    Y_out = Y.copy()
    if c["alpha"] != 1.0:
        s = _lam_scale(c, ind, new)
        Z = Y[:, nx:nx + nc]
        Y_out[:, nx + nc:nx + 2 * nc] = Z + s * (Y[:, nx + nc:nx + 2 * nc] - Z)
    eps_pri, eps_dua = (c["eps_abs"] * np.sqrt(c["nc"]),
                        c["eps_abs"] * np.sqrt(c["nx"]))
    newly = ~done & (pri < eps_pri) & (dua < eps_dua)
    iters = np.where(newly, k, c["iters"])
    status = np.where(newly, 1, c["status"])
    done = done | newly
    out = dict(pri=pri, dua=dua, rho=rho, ind=new, Y=Y_out, k=k)
    if c["certs"]:
        pinf, dinf = jb.batched_infeasibility_certificates(
            j(c["H"]), j(c["A"]), j(c["G"]), j(c["lo"][:, nx:nx + nc]),
            j(c["hi"][:, nx:nx + nc]), j(Y[:, :nx] - c["X_prev"]),
            j(c["dLam"]), 1e-4, 1e-4, hetero=c["hetero"])
        for flag, code in ((np.asarray(pinf), 2), (np.asarray(dinf), 3)):
            n_i = ~done & flag
            status = np.where(n_i, code, status)
            iters = np.where(n_i, k, iters)
            done = done | n_i
        out.update(X_prev=Y[:, :nx], Lam_prev=lam)
    n_open = int((~done).sum())
    running = n_open > 0 and k < c["budget"]
    out.update(done=done, iters=iters, status=status, n_open=n_open,
               open=running, tail=n_open > 0)
    if c["phase"] == "A":
        logres = float(np.where(done, 0.0, np.log(np.maximum(
            pri + dua, 1e-30))).sum())
        metric = logres / max(n_open, 1)
        improved = (metric < c["best_m"] - 0.03) or n_open < c["best_open"]
        n_stall = 0 if improved else c["n_stall"] + 1
        out.update(best_m=min(metric, c["best_m"]),
                   best_open=min(n_open, c["best_open"]), n_stall=n_stall,
                   k_fast=k, open_a=n_stall < 2 and k < c["cap_a"]
                   and running)
    return out


def _lam_scale(c, old, new):
    if c["hetero"]:
        rows = np.arange(c["B"])
        return c["rho_eff"][rows, old] / c["rho_eff"][rows, new]
    return c["rho_eff"][old] / c["rho_eff"][new]


def _port_batch(c):
    nx, nc, B = c["nx"], c["nc"], c["B"]
    opt = lambda a: None if a is None else _t(a)
    op = tb._Ops(_t(RHOS), _t(c["H"]), _t(c["A"]), _t(c["G"]), _t(c["lo"]),
                 _t(c["hi"]), opt(c["w_pri"]), opt(c["w_dua"]),
                 opt(c["rho_eff"]), ("bank", None))
    eps = c["eps_abs"]
    cfg = tb._Cfg(c["shared"], None, nx, nc, c["alpha"], True, c["jump"],
                  5.0, eps * np.sqrt(nc), eps * np.sqrt(nx), 1e-6, 1e6,
                  c["certs"], 1e-4, 1e-4, c["phase"] == "A", None, c["ci"],
                  c["budget"], c["stride"], c["cap_a"], 0.03, 0)
    i32 = lambda v: torch.as_tensor(np.asarray(v), dtype=torch.int32)
    lam_prev = _lam_b(c, c["Y"], c["ind"]) - c["dLam"]
    st = tb._Dev(_t(c["Y"]), i32(c["ind"]), _t(c["rho"]), _t(c["pri"]),
                 _t(c["dua"]), torch.as_tensor(c["done"]), i32(c["iters"]),
                 i32(c["status"]), i32(c["k"]), _t(c["X_prev"]),
                 _t(lam_prev), i32(B), i32(1), i32(1), i32(1),
                 _t(c["best_m"]), i32(c["best_open"]), i32(c["n_stall"]),
                 i32(0), i32([0] * 8))
    return st, op, cfg, _t(c["Y"])


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("name", sorted(BATCH))
def test_batched_check_ref_matches_jax(name, B):
    newly = moved = 0
    for seed in range(3):
        c = _batch_case(name, seed, B)
        ref = _jax_batch(c)
        st, op, cfg, Y = _port_batch(c)
        new = batched_check_ref(st, op, cfg, Y, c["ci"], c["phase"])
        for f in ("pri", "dua", "rho"):
            _close(ref[f], getattr(new, f), f"{name}: {f}")
        _close(ref["Y"], new.Y, f"{name}: Y")
        for f, g in (("ind", "rho_ind"), ("done", "done"), ("iters", "iters"),
                     ("status", "status"), ("k", "k"), ("n_open", "n_open"),
                     ("open", "open"), ("tail", "tail")):
            _eq(ref[f], getattr(new, g), f"{name}: {g}")
        if c["certs"]:
            _close(ref["X_prev"], new.X_prev, f"{name}: X_prev")
            _close(ref["Lam_prev"], new.Lam_prev, f"{name}: Lam_prev")
        if c["phase"] == "A":
            _close(ref["best_m"], new.best_m, f"{name}: best_m")
            for f in ("best_open", "n_stall", "k_fast", "open_a"):
                _eq(ref[f], getattr(new, f), f"{name}: {f}")
        newly += int((ref["done"] & ~c["done"]).sum())
        moved += int((np.asarray(ref["ind"]) != c["ind"]).sum())
    if B == 16:
        assert newly > 0, f"{name}: no row certified"
        if BATCH[name][5] == 1:
            assert moved > 0, f"{name}: no rung moved"


@pytest.mark.parametrize("name", ["shared_alpha", "per_problem_alpha_certs",
                                  "hetero_alpha_certs"])
def test_batched_check_writes_the_plain_state_on_cpu(name):
    c = _batch_case(name, 0, 16)
    st, op, cfg, Y = _port_batch(c)
    ref = batched_check_ref(st, op, cfg, Y, c["ci"], c["phase"])
    batched_check(st, op, cfg, Y, c["ci"], c["phase"])
    for f, a in zip(tb._Dev._fields, st):
        b = getattr(ref, f)
        if a is not None and f not in ("ctl", "tick"):
            assert torch.equal(a, torch.as_tensor(b).to(a.dtype)), f


@pytest.mark.parametrize("nx,nc", [(30, 16), (100, 50), (200, 200)])
def test_residual_operator_nonzeros_lie_in_its_column_blocks(nx, nc):
    """Kernel C1 sums each column block of M_res over the rows where
    ``build_residual_operator`` puts its nonzeros only (A x and H x: the x
    rows, z: the z rows, Aᵀλ: the λ rows); every other entry is zero."""
    from reluqp_tpu_torch.ops.solve_kernel import build_residual_operator
    rng = np.random.RandomState(nx)
    H = rng.randn(nx, nx)
    A = rng.randn(nc, nx)
    dp = pad_dim(nx + 2 * nc)
    M, _, nxp, ncp = build_residual_operator(
        H, A, rng.randn(nx), dp, torch.float64, w_pri=rng.rand(nc) + 0.5,
        w_dua=rng.rand(nx) + 0.5)
    M = M.numpy()
    blocks = [(0, ncp, 0, nx), (ncp, 2 * ncp, nx, nx + nc),
              (2 * ncp, 2 * ncp + nxp, 0, nx),
              (2 * ncp + nxp, 2 * ncp + 2 * nxp, nx + nc, nx + 2 * nc)]
    assert M.shape == (dp, blocks[-1][1])
    outside = np.ones_like(M, dtype=bool)
    for c0, c1, r0, r1 in blocks:
        outside[r0:r1, c0:c1] = False
    assert not M[outside].any()
