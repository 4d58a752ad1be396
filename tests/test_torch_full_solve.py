"""The whole-solve path of the PyTorch port against the JAX package.

Kernel K3 (``full_solve``) runs on the CPU as its plain torch version
``full_solve_ref``; the JAX side runs its Pallas kernel ``full_solve`` in
interpret mode, as ``tests/test_fused_features.py`` does. Both get the same
operands, built from the same numpy arrays by each package's own builders.

Tolerances. Both round every product to fp32 as the TPU kernel does, so in
fp64 the two differ only in the order of fp64 sums: equal iterations,
status, rung and reduced-phase iterations, and y within 1e-9. Two places
round differently and get 1e-6 (fp32 roundings) instead:

- the reduced tiers ("high", "bf16") sum their exact bf16 products in fp64
  in the port (as K2 does) and in fp32 in JAX. The "bf16" tier re-rounds y
  to bf16 every iteration, so a flipped fp32 rounding moves a lane by a
  bf16 ulp that later iterations carry on (y within 1e-4 there), and on
  some instances the solve certifies a window earlier or later. The
  instances here are ones where the two certify at the same checks; the
  counts must then be equal.
- JAX's forced contraction tiles round each tile's sum to fp32.

In fp32 K3 sums every product in fp64 before rounding it to fp32 (so that
the CUDA kernel and its plain version certify at the same checks), where
JAX sums in fp32: the fp32 comparisons run above the fp32 dual-residual
floor (eps 1e-3) and hold status, iterations within two check windows and
x, z, λ within a few eps.
"""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reluqp_tpu as J
import reluqp_tpu.models.mpc as JM
import reluqp_tpu.ops.solve_kernel as JSK
import reluqp_tpu.solver as JS
from reluqp_tpu.utils.problems import canonical_qp, rand_qp

import reluqp_tpu_torch as T
import reluqp_tpu_torch.models.mpc as TM
import reluqp_tpu_torch.ops.solve_kernel as TSK
from reluqp_tpu_torch.core.bank import (build_bank_np, clamp_bounds,
                                        effective_rho_ladder, equality_mask)
from reluqp_tpu_torch.core.ladder import initial_rho_index, setup_rhos
from reluqp_tpu_torch.ops.fused_step import pad_dim

ATOL = 1e-9          # fp64, summation order only
ATOL_F32 = 1e-6      # fp32 roundings ("high" tier, JAX's tiles)
ATOL_BF16 = 1e-4     # a flipped bf16 rounding of y, carried on
A16 = 1.6


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _operands(H, g, A, l, u, alpha=1.0, infeas=False, rho_cap=np.inf,
              precision="float64"):
    """The same whole-solve operands for both packages, built the way the
    solvers' setup builds them (no scaling): ``(jax_op, port_op, meta)``."""
    import jax.numpy as jnp
    H, g, A, l, u = (np.asarray(a, np.float64) for a in (H, g, A, l, u))
    nx, nc = H.shape[0], A.shape[0]
    D = nx + 2 * nc
    dp = pad_dim(D)
    rhos = setup_rhos(0.1, 1e-6, 1e6, True, 5.0)
    eq = equality_mask(l, u, 1e-6)
    W, B, b = build_bank_np(H, g, A, eq, rhos, 1e-6, alpha=alpha,
                            rho_cap=rho_cap)
    N = len(rhos)
    Wt = np.zeros((N, dp, dp))
    Wt[:, :D, :D] = np.swapaxes(W, 1, 2)
    bp = np.zeros((N, dp))
    bp[:, :D] = b
    lo_d, hi_d = clamp_bounds(l, u, nx, nc)
    lo = np.full(dp, -np.inf)
    hi = np.full(dp, np.inf)
    lo[:D], hi[:D] = lo_d, hi_d
    reff = effective_rho_ladder(rhos, eq, rho_cap)
    jdt = jnp.float64 if precision == "float64" else jnp.float32
    tdt = torch.float64 if precision == "float64" else torch.float32
    ops = {}
    for pkg, dt, cst in (
            (JSK, jdt, lambda a, d: jnp.asarray(a, d)),
            (TSK, tdt, lambda a, d: torch.as_tensor(a, dtype=d))):
        M, g_row, nxp, ncp = pkg.build_residual_operator(
            H, A, g, dp, dt, lam_segment=alpha == 1.0)
        f32 = jnp.float32 if pkg is JSK else torch.float32
        ops[pkg] = pkg.FullSolveOperand(
            Wt_bank=cst(Wt, dt), b_bank=cst(bp, dt), rhos=cst(rhos, f32),
            M_res=M, g_row=g_row, lo=cst(lo, dt), hi=cst(hi, dt),
            alpha_op=(pkg.build_alpha_operand(A, reff, nx, nc, dp, nxp, ncp,
                                              dt) if alpha != 1.0 else None),
            infeas_op=(pkg.build_infeas_operand(A, g, l, u, nx, nc, dp, nxp,
                                                ncp, dt, alpha=alpha)
                       if infeas else None))
    meta = dict(nx=nx, nc=nc, nxp=nxp, ncp=ncp, dp=dp, rhos=rhos,
                jdt=jdt, tdt=tdt)
    return ops[JSK], ops[TSK], meta


def _kw(meta, **kw):
    base = dict(nx=meta["nx"], nc=meta["nc"], nxp=meta["nxp"],
                ncp=meta["ncp"], max_iter=2000, check_interval=25,
                adaptive_rho=True, adaptive_rho_tolerance=5.0, eps_abs=1e-6,
                rho_min=1e-6, rho_max=1e6)
    base.update(kw)
    return base


def _both(jop, top, meta, y0=None, rho0=None, bias=None, **kw):
    """JAX full_solve (interpret mode) and the port's full_solve on the
    same operands: ``((y, stats) jax, (y, stats) port)``."""
    import jax.numpy as jnp
    dp = meta["dp"]
    y0 = np.zeros(dp) if y0 is None else np.asarray(y0, np.float64)
    rho0 = initial_rho_index(meta["rhos"], 0.1) if rho0 is None else rho0
    kw = _kw(meta, **kw)
    jb = tb = None
    if bias is not None:
        jb = tuple(jnp.asarray(a, meta["jdt"]) for a in bias)
        tb = tuple(torch.as_tensor(a, dtype=meta["tdt"]) for a in bias)
    with pltpu.force_tpu_interpret_mode():
        jy, js = JSK.full_solve(jop, jnp.asarray(y0, meta["jdt"]), rho0, jb,
                                **kw)
        jy, js = np.asarray(jy, np.float64), np.asarray(js)
    ty, ts = TSK.full_solve(top, torch.as_tensor(y0, dtype=meta["tdt"]),
                            rho0, tb, **kw)
    return (jy, js), (_np(ty), ts.numpy())


def _assert_same(jo, to, meta, atol=ATOL, status=None, rung=True):
    (jy, js), (ty, ts) = jo, to
    for lane, what in ((0, "iterations"), (4, "rung"), (5, "status"),
                       (6, "reduced-phase iterations")):
        if lane != 4 or rung:
            assert js[lane] == ts[lane], (what, js, ts)
    if status is not None:
        assert ts[5] == status, ts
    D = meta["nx"] + 2 * meta["nc"]
    # under alpha != 1 the last slot holds p, encoded against the rung
    n = D if rung else meta["nx"] + meta["nc"]
    np.testing.assert_allclose(jy[:n], ty[:n], rtol=0, atol=atol)
    assert (ty[D:] == 0.0).all(), "padded y lanes must stay exactly 0"


def _rand(nx=20, seed=0):
    return rand_qp(nx, nx // 4, nx // 4, seed=seed, compute_sol=False)[:5]


PINF = (np.eye(2), np.zeros(2), np.array([[1.0, 0.0], [1.0, 0.0],
                                          [0.0, 1.0]]),
        np.array([1.0, -np.inf, -1.0]), np.array([np.inf, -1.0, 1.0]))
DINF = (np.diag([1.0, 0.0]), np.array([0.0, 1.0]), np.array([[1.0, 0.0]]),
        np.array([-1.0]), np.array([1.0]))

# name -> (problem, operand build options, solve options, expected status)
CASES = {
    "canonical": (canonical_qp()[:5], {}, {}, 1),
    "rand": (_rand(), {}, {}, 1),
    "rand_jump": (_rand(24, 4), {}, dict(rho_jump=True, eps_abs=1e-5), 1),
    "stride": (_rand(24, 4), {}, dict(adaptive_rho_interval=60,
                                      eps_abs=1e-5), 1),
    "alpha": (canonical_qp()[:5], dict(alpha=A16), dict(alpha_mode=True), 1),
    "alpha_cap_walk": (rand_qp(16, 4, 4, seed=3, compute_sol=False)[:5],
                       dict(alpha=A16, rho_cap=50.0),
                       dict(alpha_mode=True, eps_abs=1e-4), 1),
    "primal_infeasible": (PINF, dict(infeas=True),
                          dict(max_iter=4000, check_infeasibility=True), 2),
    "dual_infeasible": (DINF, dict(infeas=True),
                        dict(max_iter=4000, check_infeasibility=True), 3),
    "alpha_primal_infeasible": (PINF, dict(alpha=A16, infeas=True),
                                dict(max_iter=4000, alpha_mode=True,
                                     check_infeasibility=True), 2),
    "feasible_checks_on": (canonical_qp()[:5], dict(infeas=True),
                           dict(check_infeasibility=True), 1),
    "tail_window": (_rand(), {}, dict(max_iter=110, eps_abs=1e-12), 0),
    "budget_below_window": (_rand(), {}, dict(max_iter=10), 0),
    "no_adaptive_rho": (_rand(), {}, dict(adaptive_rho=False,
                                          eps_abs=1e-4), 1),
}


@pytest.mark.parametrize("name", list(CASES))
def test_full_solve_ref_matches_jax_fp64(name):
    """On the primal-infeasible instance the dual residual cancels to 0 or
    to 1e-17 depending on the order of the fp64 sums, so the ρ estimate (a
    ratio of it) and with it the final rung are rounding noise there; the
    status and the iterations are not."""
    data, build, kw, status = CASES[name]
    jop, top, meta = _operands(*data, **build)
    jo, to = _both(jop, top, meta, **kw)
    _assert_same(jo, to, meta, status=status,
                 rung="primal_infeasible" not in name)
    if name == "budget_below_window":
        assert to[1][0] == 10     # no window: the tail alone ran


# tier, refine, instance, eps: instances where both certify at the same
# checks (see the module docstring); each runs both phases when refined
TIERS = {
    "high_refine": ("high", True, rand_qp(16, 4, 4, seed=3,
                                          compute_sol=False)[:5], 1e-4),
    "bf16_refine": ("bf16", True, _rand(24, 4), 1e-5),
    "default_refine": ("default", True, _rand(20, 0), 1e-5),
    "high_no_refine": ("high", False, canonical_qp()[:5], 1e-5),
}


@pytest.mark.parametrize("name", list(TIERS))
def test_reduced_tiers_match_jax_fp64(name):
    prec, refine, data, eps = TIERS[name]
    jop, top, meta = _operands(*data)
    jo, to = _both(jop, top, meta, eps_abs=eps, iter_precision=prec,
                   refine=refine)
    atol = {"default": ATOL, "high": ATOL_F32, "bf16": ATOL_BF16}[prec]
    _assert_same(jo, to, meta, atol=atol, status=1)
    if refine:
        assert 0 < to[1][6] <= to[1][0], "no reduced-precision phase ran"
    else:
        assert to[1][6] == 0


def test_fp32_matches_jax():
    jop, top, meta = _operands(*_rand(), precision="float32")
    jo, to = _both(jop, top, meta, eps_abs=1e-3)
    assert jo[1][5] == to[1][5] == 1
    assert abs(jo[1][0] - to[1][0]) <= 50
    np.testing.assert_allclose(jo[0], to[0], rtol=0, atol=5e-3)


def test_warm_start_matches_jax():
    """From a mid-solve state and rung (a max_iter-bound first solve)."""
    jop, top, meta = _operands(*_rand(24, 4))
    (_, _), (y1, s1) = _both(jop, top, meta, max_iter=75)
    assert s1[5] == 0
    jo, to = _both(jop, top, meta, y0=y1, rho0=int(s1[4]))
    _assert_same(jo, to, meta, status=1)


def test_affine_bias_matches_jax():
    """b_k = c_k + x @ M_aff[k], the warm-MPC rollout's in-kernel bias."""
    jop, top, meta = _operands(*_rand())
    rng = np.random.RandomState(5)
    n_rho, dp = len(meta["rhos"]), meta["dp"]
    M_aff = np.zeros((n_rho, 128, dp))
    M_aff[:, :3, :meta["nx"]] = 0.05 * rng.randn(n_rho, 3, meta["nx"])
    x_row = np.zeros((1, 128))
    x_row[0, :3] = rng.randn(3)
    jo, to = _both(jop, top, meta, bias=(M_aff, x_row), max_iter=150)
    _assert_same(jo, to, meta)
    plain = TSK.full_solve(top, torch.zeros(meta["dp"], dtype=torch.float64),
                           9, **_kw(meta, max_iter=150))
    assert float((plain[0] - torch.as_tensor(to[0])).abs().max()) > 1e-3


def test_stream_bank_changes_nothing():
    jop, top, meta = _operands(*_rand(24, 4))
    kw = _kw(meta)
    y0 = torch.zeros(meta["dp"], dtype=torch.float64)
    a = TSK.full_solve(top, y0, 9, **kw)
    b = TSK.full_solve(top, y0, 9, stream_bank=True, **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    jo, to = _both(jop, top, meta, stream_bank=True)
    _assert_same(jo, to, meta, status=1)


def test_tiled_partial_tile_matches_jax(monkeypatch):
    """JAX's contraction-tiled dots forced onto Dp=128 with 48-wide tiles,
    a PARTIAL final tile (48+48+32, F-w1): JAX rounds each tile's sum to
    fp32, the port sums whole columns, so they differ by fp32 roundings;
    a dropped tile would miss by O(1)."""
    jop, top, meta = _operands(*_rand())
    monkeypatch.setattr(JSK, "_TILE_ABOVE", 0)
    monkeypatch.setattr(JSK, "_DOT_TILE", 48)
    JSK.full_solve.clear_cache()
    try:
        jo, to = _both(jop, top, meta, stream_bank=True)
    finally:
        JSK.full_solve.clear_cache()   # leak no tiled executables
    _assert_same(jo, to, meta, atol=ATOL_F32, status=1)


def test_verbose_lines_match_jax(capfd):
    jop, top, meta = _operands(*canonical_qp()[:5])
    capfd.readouterr()
    jo, to = _both(jop, top, meta, verbose=True, eps_abs=1e-4)
    out = capfd.readouterr().out
    lines = [ln for ln in out.splitlines() if ln.startswith("Iter:")]
    n = int(to[1][0]) // 25
    assert len(lines) == 2 * n and n >= 1, out
    assert lines[:n] == lines[n:], out    # JAX's lines, then the port's
    _assert_same(jo, to, meta, status=1)


def test_operand_builders_match_jax():
    """``build_alpha_operand`` / ``build_infeas_operand`` element for
    element, with unscale weights."""
    H, g, A, l, u = _rand(12, 2)
    nx, nc = 12, 6
    dp, nxp, ncp = pad_dim(nx + 2 * nc), 128, 128
    rng = np.random.RandomState(0)
    reff = rng.rand(18, nc) + 0.5
    wp, wd = rng.rand(nc) + 0.5, rng.rand(nx) + 0.5
    ja = JSK.build_alpha_operand(A, reff, nx, nc, dp, nxp, ncp, np.float64,
                                 w_dua=wd)
    ta = TSK.build_alpha_operand(A, reff, nx, nc, dp, nxp, ncp,
                                 torch.float64, w_dua=wd)
    for alpha in (1.0, A16):
        ji = JSK.build_infeas_operand(A, g, l, u, nx, nc, dp, nxp, ncp,
                                      np.float64, alpha, w_pri=wp, w_dua=wd)
        ti = TSK.build_infeas_operand(A, g, l, u, nx, nc, dp, nxp, ncp,
                                      torch.float64, alpha, w_pri=wp,
                                      w_dua=wd)
        for jo, to in ((ja, ta), (ji, ti)):
            for f in jo._fields:
                np.testing.assert_array_equal(np.asarray(getattr(jo, f)),
                                              _np(getattr(to, f)),
                                              err_msg=f)
    assert ta.rho_eff.dtype == torch.float32


def test_full_solve_checks_its_operands():
    _, top, meta = _operands(*canonical_qp()[:5])
    kw = _kw(meta)
    y0 = torch.zeros(meta["dp"], dtype=torch.float64)
    with pytest.raises(ValueError, match="M_res"):
        TSK.full_solve(top._replace(M_res=top.M_res[:, :256]), y0, 0, **kw)
    with pytest.raises(ValueError, match="alpha_op"):
        TSK.full_solve(top, y0, 0, alpha_mode=True, **kw)
    with pytest.raises(ValueError, match="ladder"):
        TSK.full_solve(top, y0, 99, **kw)
    with pytest.raises(ValueError, match="iter_precision"):
        TSK.full_solve(top, y0, 0, **dict(kw, iter_precision="fp8"))


# --------------------------------------------------------------------- #
# ReLU_QP(backend="fused") against the JAX solver's fused backend       #
# --------------------------------------------------------------------- #

def _solver_pair(monkeypatch, data, **kw):
    """The JAX solver with backend="fused" (its TPU gate opened, interpret
    mode) and the port's on the CPU, both fp32."""
    monkeypatch.setattr(JS, "_is_tpu", lambda device=None: True)
    kw = dict(dict(eps_abs=1e-3, precision="float32"), **kw)
    j = J.ReLU_QP()
    with pltpu.force_tpu_interpret_mode():
        j.setup(*data, backend="fused", bank_backend="numpy", **kw)
    t = T.ReLU_QP()
    t.setup(*data, backend="fused", device="cpu", bank_backend="numpy",
            **kw)
    assert t._fused and t._M_res is not None
    return j, t


def _solve_both(j, t):
    with pltpu.force_tpu_interpret_mode():
        jr = j.solve()
    return jr, t.solve()


def _agree_fp32(jr, tr, j, t):
    assert jr.info.status == tr.info.status
    assert abs(jr.info.iter - tr.info.iter) <= 50
    for a, b in ((jr.x, tr.x), (jr.z, tr.z), (jr.lam, tr.lam)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-2)


def test_solver_fused_canonical(monkeypatch):
    qp = canonical_qp()
    j, t = _solver_pair(monkeypatch, qp[:5])
    jr, tr = _solve_both(j, t)
    assert tr.info.status == "solved"
    np.testing.assert_allclose(_np(tr.x), qp.x_sol, atol=1e-2)
    _agree_fp32(jr, tr, j, t)
    assert abs(jr.info.obj_val - tr.info.obj_val) < 1e-2


def test_solver_fused_lifecycle_matches_jax(monkeypatch):
    """Scaling and certificates on; update(g), update(l, u),
    update_settings(eps_abs) and a warm start, each followed by a solve."""
    inst = _rand(20, 8)
    upd = _rand(20, 9)
    j, t = _solver_pair(monkeypatch, inst, scaling=True,
                        check_infeasibility=True)
    steps = [
        lambda m: None,
        lambda m: m.update(g=upd[1]),
        lambda m: m.update(l=inst[3] - 0.1, u=inst[4] + 0.1),
        lambda m: m.update_settings(eps_abs=5e-4),
        lambda m: m.warm_start(x=np.ones(20), rho=1.0),
    ]
    for k, step in enumerate(steps):
        step(j)
        step(t)
        jr, tr = _solve_both(j, t)
        assert tr.info.status == "solved", k
        _agree_fp32(jr, tr, j, t)


def test_solver_fused_alpha_matches_jax(monkeypatch):
    j, t = _solver_pair(monkeypatch, _rand(16, 3), alpha=A16)
    jr, tr = _solve_both(j, t)
    assert tr.info.status == "solved"
    _agree_fp32(jr, tr, j, t)


def test_solver_fused_bf16_refine_polishes_on_the_bf16_bank(monkeypatch):
    """The JAX solver's fused backend hands the bf16-stored bank to the
    kernel, so the "highest" polish of a bf16 refine iterates with
    bf16-rounded weights and, on this instance, never certifies, where the
    loop path (polishing on the fp32 copy) solves. The port computes the
    same, on purpose (ROADMAP §C)."""
    data = rand_qp(60, 15, 15, seed=2, compute_sol=False)[:5]
    kw = dict(scaling=True, iter_precision="bf16", max_iter=1000)
    j, t = _solver_pair(monkeypatch, data, eps_abs=1e-4, **kw)
    jr, tr = _solve_both(j, t)
    assert jr.info.status == tr.info.status == "max_iters_reached"
    assert jr.info.iter == tr.info.iter == 1000
    assert tr.info.dua_res > 0.1 and abs(jr.info.dua_res - tr.info.dua_res) \
        < 1e-3 * jr.info.dua_res
    loop = T.ReLU_QP()
    loop.setup(*data, device="cpu", precision="float32", eps_abs=1e-4, **kw)
    assert loop.solve().info.status == "solved"


def test_solver_fused_is_taken_by_name_only():
    qp = canonical_qp()
    t = T.ReLU_QP()
    t.setup(*qp[:5], device="cpu")
    assert not t._fused
    f = T.ReLU_QP()
    f.setup(*qp[:5], device="cpu", backend="fused", precision="float64",
            eps_abs=1e-6)
    r = f.solve()
    assert r.info.status == "solved" and f.Dp == 128
    np.testing.assert_allclose(_np(r.x), qp.x_sol, atol=1e-5)


# --------------------------------------------------------------------- #
# mpc_rollout_scan(kernel="fused") against JAX's _kernel_rollout        #
# --------------------------------------------------------------------- #

def _mpc_pair(monkeypatch, **kw):
    """The JAX controller in its lane-padded layout (its TPU and Mosaic
    gates opened, as its fused rollout consumes the padded bank) and the
    port's on the CPU, fp64."""
    monkeypatch.setattr(JS, "_is_tpu", lambda device=None: True)
    monkeypatch.setattr(JS, "_mosaic_supports", lambda dtype: True)
    Ad, Bd = TM.random_linear_system(6, 2, seed=0)
    base = dict(horizon=5, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
                precision="float64")
    base.update(kw)
    args = (Ad, Bd, np.eye(6), 0.1 * np.eye(2))
    j = JM.MPC(*args, bank_backend="numpy", **base)
    t = TM.MPC(*args, device="cpu", bank_backend="numpy", **base)
    assert j.solver.Dp == t.solver.Dp == pad_dim(t.solver.D)
    return j, t


def _jax_fused(j, x0, T, ci=None, y0=None, rho0=None, noise=None):
    with pltpu.force_tpu_interpret_mode():
        return JM._kernel_rollout(j.solver, j.prob, x0, T, None, True, ci,
                                  y0, rho0, noise)


def _port_fused(t, x0, T, **kw):
    return TM.mpc_rollout_scan(t.solver, t.prob, x0, T, kernel="fused",
                               return_stats=True, return_state=True, **kw)


def _assert_rollouts(jo, to, t):
    jx, ju, jit, jst, jy, jr = jo
    tx, tu, tit, tst, ty, tr = to
    np.testing.assert_array_equal(np.asarray(jit), tit.numpy())
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    assert int(jr) == tr
    for a, b in ((jx, tx), (ju, tu)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=ATOL)
    D = t.solver.D
    np.testing.assert_allclose(_np(jy)[:D], _np(ty)[:D], rtol=0, atol=ATOL)
    assert (_np(ty)[D:] == 0.0).all()


@pytest.mark.parametrize("ci", [5, 7])
def test_fused_rollout_matches_jax(monkeypatch, ci):
    """A fixed window (7 does not divide max_iter: K3 runs the tail), with
    numpy process noise and Ruiz scaling."""
    j, t = _mpc_pair(monkeypatch, scaling=True, max_iter=200)
    T_ = 10
    noise = 0.05 * np.random.RandomState(9).randn(T_, 6)
    x0 = np.random.RandomState(1).randn(6)
    to = _port_fused(t, x0, T_, check_interval=ci, noise=noise)
    _assert_rollouts(_jax_fused(j, x0, T_, ci=ci, noise=noise), to, t)
    assert (to[3].numpy() == 1).all()


def test_fused_rollout_auto_window_matches_jax(monkeypatch):
    j, t = _mpc_pair(monkeypatch)
    T_ = 12
    x0 = np.random.RandomState(2).randn(6)
    noise = 0.01 * np.random.RandomState(5).randn(T_, 6)
    used = [0]

    def run(ci, x, y0, rho0, steps):
        w = noise[used[0]:used[0] + steps]
        used[0] += steps
        return _jax_fused(j, x, steps, ci=ci, y0=y0, rho0=rho0, noise=w)

    stng = j.solver.settings
    jo = JM._auto_ci_rollout(run, stng, x0, T_, 5, j.solver.y,
                             j.solver.rho_ind, stng.max_iter)
    to = _port_fused(t, x0, T_, check_interval="auto", calib_steps=5,
                     noise=noise)
    _assert_rollouts(jo, to, t)


def test_fused_rollout_gating():
    Ad, Bd = TM.double_integrator(dt=0.1)
    base = dict(horizon=4, u_min=-1.0, u_max=1.0, device="cpu")
    x0 = np.array([1.0, 0.0])
    for kw in (dict(alpha=A16), dict(check_infeasibility=True),
               dict(backend="xla")):
        t = TM.MPC(Ad, Bd, np.eye(2), np.eye(1), **base, **kw)
        assert not TM._kernel_rollout_eligible(t.solver)
        with pytest.raises(ValueError, match="fused"):
            TM.mpc_rollout_scan(t.solver, t.prob, x0, 2, kernel="fused")
    t = TM.MPC(Ad, Bd, np.eye(2), np.eye(1), **base)
    out = TM.mpc_rollout_scan(t.solver, t.prob, x0, 0, kernel="fused",
                              return_stats=True, return_state=True)
    assert out[0].shape == (1, 2) and out[2].shape == (0,)
    assert out[5] == t.solver.rho_ind
