"""Scenario MPC of the PyTorch port against the JAX package.

B plants under one controller (``scenario_rollout_scan``) on the
double integrator, horizon 8, with the per-stage input bounds of the JAX
package's scenario tests, in fp64. Both packages get the same numpy
initial states and noise.

- The loop path (``kernel="loop"``): one batched solve per control step.
  The JAX side runs ``backend="xla"`` (its scenario loop needs the unpadded
  batch); the port runs ``"xla"`` and also ``"auto"``, the padded layout
  through kernel K4's plain version. The two sum in different orders only:
  per-step collective iterations and the status lane are EQUAL, and
  trajectories agree to 1e-9.
- The scan path (``kernel="scan"``): on the CPU the port runs kernel K6's
  plain version ``full_rollout_batched_ref``; the JAX side its Pallas
  kernel ``full_rollout_batched`` in interpret mode. Both round every
  product to fp32 as the TPU kernel does: equal iterations, rung and stats
  lanes, trajectories within 1e-9.

The two packages' fp64 states differ by summation order (~1e-14). A
window whose residuals sit at the rounding floor of plants that have come
to rest makes a ρ estimate of rounding noise, and there that difference
can move the rung (and later a step by a window); so the runs here keep
their plants away from rest: short, or under process noise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reluqp_tpu.models.mpc as JM
import reluqp_tpu.ops.solve_kernel as JSK
from reluqp_tpu.batch import BatchedReLU_QP as JB

import reluqp_tpu_torch as T
import reluqp_tpu_torch.models.mpc as TM
import reluqp_tpu_torch.ops.solve_kernel as TSK

ATOL = 1e-9   # fp64, summation order only


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _prob(M, state_row=False):
    """The condensed double-integrator QP of the JAX scenario tests, u in
    [-1, 1] at every stage; ``state_row`` adds the bound |x_1[0]| <= 0.5,
    which a plant far from the origin cannot meet (primal infeasible)."""
    Ad, Bd = M.double_integrator(dt=0.1)
    Q, R = np.diag([10.0, 1.0]), np.array([[0.1]])
    K, Qf = M.ihlqr(Ad, Bd, Q, R)
    N, ns = 8, 3
    rows, lo, hi = [], list(-np.ones(N)), list(np.ones(N))
    for k in range(N):
        r = np.zeros((1, N * ns))
        r[0, k * ns] = 1.0
        rows.append(r)
    if state_row:
        r = np.zeros((1, N * ns))
        r[0, 1] = 1.0
        rows.append(r)
        lo.append(-0.5)
        hi.append(0.5)
    return M.gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, N, np.vstack(rows),
                                  np.array(lo), np.array(hi), K=K)


def _x0(B, seed=3):
    return np.array([[1.0, 0.0]]) + 0.2 * np.random.RandomState(seed).randn(
        B, 2)


def _noise(T_, B, scale, seed=7):
    return scale * np.random.RandomState(seed).randn(T_, B, 2)


def _setup(solver, prob, B, **kw):
    solver.setup(prob.H, np.tile(prob.g0, (B, 1)), prob.A,
                 np.tile(prob.l0, (B, 1)), np.tile(prob.u0, (B, 1)), **kw)
    return solver


def _pair(B=5, port_backend="xla", state_row=False, **kw):
    base = dict(dict(eps_abs=1e-6, precision="float64"), **kw)
    jp, tp = _prob(JM, state_row), _prob(TM, state_row)
    j = _setup(JB(), jp, B, backend="xla", **base)
    t = _setup(T.BatchedReLU_QP(), tp, B, backend=port_backend,
               device="cpu", **base)
    return j, jp, t, tp


def _assert_same(jo, to, B, D):
    """``(states, controls, iters, status, Y_f, rho_f)`` of both packages:
    equal iterations, status lane and final rung, the rest within ATOL."""
    jx, ju, jit, jst, jy, jr = jo
    tx, tu, tit, tst, ty, tr = to
    np.testing.assert_array_equal(np.asarray(jit), tit.numpy())
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    assert int(jr) == int(tr)
    np.testing.assert_allclose(_np(jx), _np(tx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(ju), _np(tu), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(jy)[:B, :D], _np(ty)[:B, :D], rtol=0,
                               atol=ATOL)


def _port(t, tp, X0, T_, kernel, **kw):
    return TM.scenario_rollout_scan(t, tp, X0, T_, kernel=kernel,
                                    return_stats=True, return_state=True,
                                    **kw)


# --------------------------------------------------------------------- #
# the loop path                                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("name,backend,kw,noise", [
    ("plain", "xla", {}, 0.0),
    ("noise", "xla", {}, 0.02),
    # (at eps 1e-6 one step of this run certifies a window apart on a
    # residual within fp64 rounding of eps)
    ("alpha", "xla", dict(alpha=1.6, eps_abs=1e-7), 0.02),
    ("padded K4 layout", "auto", {}, 0.02),
])
def test_loop_rollout_matches_jax(name, backend, kw, noise):
    B, T_ = 5, 30
    j, jp, t, tp = _pair(B, backend, **kw)
    X0, w = _x0(B), _noise(T_, B, noise)
    jo = JM.scenario_rollout_scan(j, jp, X0, T_, noise=w, return_stats=True,
                                  return_state=True)
    to = _port(t, tp, X0, T_, "loop", noise=w)
    _assert_same(jo, to, B, t.D)
    assert (to[3].numpy() == 1).all()
    assert to[0].shape == (T_ + 1, B, 2) and to[1].shape == (T_, B, 1)
    if backend == "auto":
        assert t._use_pallas and t.B_pad == 8 and t.Dp == 128
        # the inert padding rows and lanes stay exactly 0
        assert not to[4][B:].any() and not to[4][:, t.D:].any()


def test_status_lane_hides_an_infeasible_scenario():
    """F-w2, as the JAX package has it: the loop's status lane is the min
    over the scenarios' status codes, so a scenario certified primal
    infeasible (2) reads as SOLVED (1) beside solved ones. The same step's
    batched solve shows the infeasible scenario; both packages agree."""
    B, T_ = 3, 3
    X0 = np.array([[0.2, 0.0], [-0.3, 0.1], [5.0, 0.0]])
    j, jp, t, tp = _pair(B, state_row=True, check_infeasibility=True)
    for m, p in ((j, jp), (t, tp)):
        m.update(g=p.g0[None] + X0 @ p.g_x0.T,
                 l=p.l0[None] + X0 @ p.lu_x0.T,
                 u=p.u0[None] + X0 @ p.lu_x0.T)
    jr, tr = j.solve(), t.solve()
    np.testing.assert_array_equal(tr.info.status_code, [1, 1, 2])
    np.testing.assert_array_equal(jr.info.status_code, tr.info.status_code)
    np.testing.assert_array_equal(jr.info.iter, tr.info.iter)
    j.clear_primal_dual()
    t.clear_primal_dual()
    jo = JM.scenario_rollout_scan(j, jp, X0, T_, return_stats=True,
                                  return_state=True)
    to = _port(t, tp, X0, T_, "loop")
    _assert_same(jo, to, B, t.D)
    assert (to[3].numpy() == 1).all()   # the min hides the infeasible one


# --------------------------------------------------------------------- #
# the scan path: K6's plain version                                     #
# --------------------------------------------------------------------- #

def _jax_scan(j, jp, X0, T_, ci=None, noise=None, Y0=None, rho0=None):
    """JAX's scan path: the Pallas K6 in interpret mode."""
    noise = np.zeros((T_, X0.shape[0], 2)) if noise is None else noise
    with pltpu.force_tpu_interpret_mode():
        return JM._scan_scenario_rollout(
            j, jp, jnp.asarray(X0, jnp.float64), T_, None, ci,
            j.Y if Y0 is None else Y0, j.rho_ind if rho0 is None else rho0,
            noise)


@pytest.mark.parametrize("ci,noise,T_", [(None, 0.0, 15), (5, 0.02, 20),
                                         (3, 0.3, 20)])
def test_scan_rollout_matches_jax(ci, noise, T_):
    """``kernel="scan"`` (K6's plain version) against JAX's kernel; a
    window of 3 does not divide max_iter (the budget is rounded down to
    whole windows); 0.3·randn is a cold, ladder-walking disturbance."""
    B = 5
    j, jp, t, tp = _pair(B, eps_abs=1e-5)
    X0, w = _x0(B), _noise(T_, B, noise)
    to = _port(t, tp, X0, T_, "scan", noise=w, check_interval=ci)
    _assert_same(_jax_scan(j, jp, X0, T_, ci, w), to, B, t.D)
    assert (to[3].numpy() == 1).all()
    if ci:
        assert (to[2].numpy() % ci == 0).all()


def test_scan_matches_loop():
    """The two paths of the port solve the same ensemble to eps: the
    trajectories agree to the solve tolerance."""
    B, T_ = 5, 20
    _, _, t, tp = _pair(B, "auto", eps_abs=1e-7)
    _, _, t2, _ = _pair(B, eps_abs=1e-7)
    X0 = _x0(B)
    xl = _port(t, tp, X0, T_, "loop", check_interval=5)[0]
    xs = _port(t2, tp, X0, T_, "scan", check_interval=5)[0]
    np.testing.assert_allclose(_np(xl), _np(xs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kernel", ["loop", "scan"])
def test_continuation_equals_one_run(kernel):
    """Two stitched segments (carrying Y in the batch solver's layout, the
    rung and X) equal one run of 16 steps: what check_interval="auto"
    relies on."""
    B = 4
    _, _, t, tp = _pair(B, "auto")
    _, _, t2, _ = _pair(B, "auto")
    X0 = _x0(B)
    a = _port(t, tp, X0, 8, kernel)
    seg = TM._scan_scenario_rollout if kernel == "scan" \
        else TM._loop_scenario_rollout
    b = seg(t, tp, a[0][-1], 8, None, t.settings.check_interval, a[4], a[5],
            torch.zeros((8, B, 2), dtype=torch.float64))
    assert a[4].shape == t.Y.shape and not a[4][B:].any()
    full = _port(t2, tp, X0, 16, kernel)
    np.testing.assert_array_equal(torch.cat([a[2], b[2]]).numpy(),
                                  full[2].numpy())
    np.testing.assert_allclose(_np(torch.cat([a[0], b[0][1:]])),
                               _np(full[0]), rtol=0, atol=0)
    assert int(b[5]) == int(full[5])


def test_auto_window_matches_jax():
    """``check_interval="auto"``: a ci=1 calibration segment, then the
    window sized from it, in both packages through their scan paths."""
    B, T_ = 4, 24
    j, jp, t, tp = _pair(B)
    X0 = _x0(B)
    w = _noise(T_, B, 0.1)
    with pltpu.force_tpu_interpret_mode():
        jo = JM._scenario_scan_driver(j, jp, X0, T_, w, None, "auto", 6,
                                      True, True)
    to = _port(t, tp, X0, T_, "scan", noise=w, check_interval="auto",
               calib_steps=6)
    _assert_same(jo, to, B, t.D)
    ci = TM.auto_check_interval(to[2].numpy()[:6], t.settings.check_interval,
                                t.settings.max_iter)
    assert ci > 1 and (to[2].numpy()[6:] % ci == 0).all()


# --------------------------------------------------------------------- #
# operand level: full_rollout_batched_ref against the JAX kernel        #
# --------------------------------------------------------------------- #

def _k6_against_jax(monkeypatch, B, T_, tiled=False, rho_jump=False):
    """K6's plain version and JAX ``full_rollout_batched`` (interpret mode)
    on the same numpy operands (the port's ``_scenario_scan_call``), cold,
    0.3·randn noise, B scenarios in Bp = B rounded up to 8 rows: every stats
    lane (iterations, max residuals, real rows, rung, min status, unsolved
    rows), the trajectories, and the padding rows and lanes exactly 0."""
    ci = 5
    _, _, t, tp = _pair(B, eps_abs=1e-5, rho_jump=rho_jump)
    args, kw = TM._scenario_scan_call(
        t, tp, _x0(B), T_, ci=ci, Y0=torch.zeros_like(t.Y),
        noise=_noise(T_, B, 0.3, seed=4))
    to = TSK.full_rollout_batched(*args, **kw)
    jargs = [jnp.asarray(_np(a)) for a in args[:-1]] + [
        jnp.asarray(args[-1], jnp.int32)]
    jargs[13] = jargs[13].reshape(-1, 1).astype(jnp.float32)  # (Bp, 1) mask
    if tiled:
        monkeypatch.setattr(JSK, "_TILE_ABOVE", 0)
        monkeypatch.setattr(JSK, "_DOT_TILE", 48)
    JSK.full_rollout_batched.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            jo = JSK.full_rollout_batched(*jargs, **kw)
    finally:
        JSK.full_rollout_batched.clear_cache()   # leak no tiled executables
    js, ts = np.asarray(jo[2]), _np(to[2])
    for lane in (0, 3, 4, 5, 6, 7):
        np.testing.assert_array_equal(js[:, lane], ts[:, lane], err_msg=lane)
    np.testing.assert_allclose(js[:, 1:3], ts[:, 1:3], rtol=1e-5, atol=0)
    assert len(set(ts[:, 4].tolist())) > 1, "the rung never moved"
    assert ts[0, 3] == B and (ts[:, 5] == 1).all()
    atol = 1e-6 if tiled else ATOL
    for a, b in zip(jo[:2], to[:2]):
        np.testing.assert_allclose(np.asarray(a), _np(b), rtol=0, atol=atol)
    # the padding rows and lanes stay exactly 0
    assert not to[3][B:].any() and not to[3][:, t.D:].any()
    assert not to[0][:, B:].any()


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("rho_jump", [False, True])
def test_full_rollout_batched_ref_matches_jax_kernel(monkeypatch, tiled,
                                                     rho_jump):
    """K6's plain version against JAX ``full_rollout_batched`` at B=5 in
    Bp=8 rows, 12 steps (``_k6_against_jax``). ``tiled`` forces JAX's
    contraction-tiled dots onto Dp=128 with 48-wide tiles, a PARTIAL final
    tile (48+48+32, F-w1): JAX then rounds every tile's partial sum to fp32,
    where the port rounds each product once, so the two differ by fp32
    roundings (~1e-7 relative) instead of fp64 ones; a dropped tile would
    miss by O(1)."""
    _k6_against_jax(monkeypatch, 5, 12, tiled, rho_jump)


@pytest.mark.parametrize("B", [13, 21])
def test_full_rollout_batched_ref_matches_jax_kernel_uneven_rows(monkeypatch,
                                                                 B):
    """The same at ensembles that the CUDA kernel's row tiles split
    unevenly (B=13 in Bp=16 rows, B=21 in Bp=24: on the card a tile of 2-4
    rows per cluster leaves a partial last tile and padding rows beside
    real ones): the row-order ρ decision over more rows (equal rung and
    stats lanes) and the padding exactly 0."""
    _k6_against_jax(monkeypatch, B, 8)


def _widen(args, kw, extra):
    """K6's operands with ``extra`` more zero lanes of y (Dp + extra)."""
    Wt, bias_c, M_aff, rhos, M_res, g0w, GL, lo0, hi0, S_u, Bdw, Y0 = args[:12]
    pad = lambda t, dim: torch.cat(
        [t, torch.zeros(t.shape[:dim] + (extra,) + t.shape[dim + 1:],
                        dtype=t.dtype)], dim)
    at = kw["nxp"] + Wt.shape[1]   # the y columns of GL end here
    GL = torch.cat([GL[:, :at], torch.zeros((GL.shape[0], extra),
                                            dtype=GL.dtype), GL[:, at:]], 1)
    return [pad(pad(Wt, 1), 2), pad(bias_c, 1), pad(M_aff, 2), rhos,
            pad(M_res, 0), g0w, GL, pad(lo0, lo0.dim() - 1),
            pad(hi0, hi0.dim() - 1), pad(S_u, 0),
            Bdw, pad(Y0, 1)] + list(args[12:])


@pytest.mark.parametrize("case", ["bf16_bank_fp64_state", "float16_state",
                                  "odd_width"])
def test_full_rollout_batched_refuses_what_the_kernel_does_not_take(case):
    """On the CPU too (where the plain version would compute it), the
    wrapper refuses what the CUDA kernel does not take: a bf16 bank under
    fp64 states, a state dtype other than fp32/fp64, and a width Dp that is
    not a multiple of 16 (the kernel's products take whole steps of 8
    inputs and its loads whole 16-byte groups)."""
    B = 3
    _, _, t, tp = _pair(B)
    args, kw = TM._scenario_scan_call(t, tp, _x0(B), 2, ci=25)
    assert args[11].dtype == torch.float64
    # the operands as they are pass the check
    TSK.full_rollout_batched(*args, **kw)
    if case == "bf16_bank_fp64_state":
        bad, match = [args[0].to(torch.bfloat16)] + list(args[1:]), "Wt_bank"
    elif case == "float16_state":
        bad = [a.to(torch.float16) if isinstance(a, torch.Tensor)
               and a.is_floating_point() else a for a in args]
        match = "not float32/float64"
    else:
        bad, match = _widen(args, kw, 8), "Dp=136"
        # 16 more zero lanes pass the check (Dp=144)
        TSK.full_rollout_batched(*_widen(args, kw, 16), **kw)
    with pytest.raises(ValueError, match=match):
        TSK.full_rollout_batched(*bad, **kw)


def test_full_rollout_batched_checks_its_operands():
    B = 3
    _, _, t, tp = _pair(B)
    args, kw = TM._scenario_scan_call(t, tp, _x0(B), 3, ci=25)
    with pytest.raises(ValueError, match="multiple of check_interval"):
        TSK.full_rollout_batched(*args, **dict(kw, max_iter=110))
    bad = list(args)
    bad[9] = args[9][:, :64]
    with pytest.raises(ValueError, match="S_u"):
        TSK.full_rollout_batched(*bad, **kw)
    bad = list(args)
    bad[15] = 99
    with pytest.raises(ValueError, match="off the ladder"):
        TSK.full_rollout_batched(*bad, **kw)
    args0, kw0 = TM._scenario_scan_call(t, tp, _x0(B), 0, ci=25)
    out = TSK.full_rollout_batched(*args0, **kw0)
    assert out[0].shape == (0, 8, kw0["nplp"]) and out[2].shape == (0, 8)


def test_scan_call_takes_the_first_rows():
    """``_scenario_scan_call(rows=B)`` on a solver set up for 12 scenarios
    makes the K6 call of a solver set up for B: the plain version gives
    equal iterations, rung and status per step and the same trajectories
    (the two banks may differ by the rounding of the Ruiz scaling, which
    scales on the batch mean of |g|: hence 1e-12, not 0)."""
    B, T_ = 5, 8
    _, _, small, tp = _pair(B, eps_abs=1e-5)
    _, _, big, _ = _pair(12, eps_abs=1e-5)
    X0, w = _x0(12)[:B], _noise(T_, B, 0.3, seed=4)
    outs = []
    for m, rows in ((small, None), (big, B)):
        args, kw = TM._scenario_scan_call(m, tp, X0, T_, ci=5,
                                          Y0=torch.zeros_like(m.Y), noise=w,
                                          rows=rows)
        assert args[11].shape[0] == 8
        outs.append(TSK.full_rollout_batched(*args, **kw))
    (xa, ua, sa, ya), (xb, ub, sb, yb) = outs
    for lane in (0, 3, 4, 5, 6):
        np.testing.assert_array_equal(sa[:, lane].numpy(), sb[:, lane].numpy(),
                                      err_msg=lane)
    assert len(set(sa[:, 4].tolist())) > 1, "the rung never moved"
    for a, b in ((xa, xb), (ua, ub), (ya, yb)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12)
    assert not xb[:, B:].any() and not yb[B:].any()
    for rows in (0, 13):
        with pytest.raises(ValueError, match="rows"):
            TM._scenario_scan_call(big, tp, X0, T_, rows=rows)


def test_loop_segment_operands_are_cached():
    """The loop path uploads its constants once per prob and bank: a warm
    segment reuses them; a new bank (``update_matrices``) rebuilds them."""
    B = 3
    _, _, t, tp = _pair(B, "auto")
    maps, bias = TM._loop_scenario_operands(t, tp)
    first = _port(t, tp, _x0(B), 4, "loop")
    assert TM._loop_scenario_operands(t, tp)[0] is maps
    t.update_matrices(H=tp.H)
    maps2, bias2 = TM._loop_scenario_operands(t, tp)
    assert maps2 is not maps
    for a, b in zip(maps + bias[:2], maps2 + bias2[:2]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-12)
    t.clear_primal_dual()
    again = _port(t, tp, _x0(B), 4, "loop")
    np.testing.assert_array_equal(first[2].numpy(), again[2].numpy())
    np.testing.assert_allclose(_np(first[0]), _np(again[0]), rtol=0,
                               atol=1e-12)


# --------------------------------------------------------------------- #
# kernel choice and gates                                               #
# --------------------------------------------------------------------- #

def test_kernel_choice_and_gates():
    B = 4
    X0 = _x0(B)
    _, _, t, tp = _pair(B, "auto")
    # on the CPU "auto" keeps the loop path
    auto = _port(t, tp, X0, 5, "auto")
    t.clear_primal_dual()
    loop = _port(t, tp, X0, 5, "loop")
    np.testing.assert_array_equal(auto[2].numpy(), loop[2].numpy())
    np.testing.assert_allclose(_np(auto[0]), _np(loop[0]), rtol=0, atol=0)
    assert TM._scan_scenario_eligible(t)
    assert not TM._scan_scenario_eligible(t, ci=25, budget=10)
    for kw in (dict(alpha=1.6), dict(check_infeasibility=True),
               dict(iter_precision="high")):
        _, _, m, _ = _pair(B, **kw)
        assert not TM._scan_scenario_eligible(m)
        with pytest.raises(ValueError, match="scan"):
            TM.scenario_rollout_scan(m, tp, X0, 3, kernel="scan")
    _, _, m, _ = _pair(B, iter_precision="high", refine=False)
    assert TM._scan_scenario_eligible(m)
    with pytest.raises(ValueError, match="kernel"):
        TM.scenario_rollout_scan(t, tp, X0, 3, kernel="fused")
    with pytest.raises(ValueError, match="batch"):
        TM.scenario_rollout_scan(t, tp, X0[:2], 3)
    with pytest.raises(ValueError, match="noise"):
        TM.scenario_rollout_scan(t, tp, X0, 3, noise=np.zeros((2, B, 2)))
    _, _, m, _ = _pair(B, rho_mode="per_problem")
    with pytest.raises(ValueError, match="shared"):
        TM.scenario_rollout_scan(m, tp, X0, 3)
