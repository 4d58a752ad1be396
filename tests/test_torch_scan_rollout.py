"""The whole-rollout path of the PyTorch port against the JAX package.

``mpc_rollout_scan(kernel="scan")`` runs kernel K2 (``full_rollout``); on
the CPU that is its plain torch version ``full_rollout_ref``. The JAX side
runs its own scan path as ``tests/test_scan_rollout.py`` does: the Pallas
kernel in interpret mode, ``backend="xla"``, in fp64. Both round every
product to fp32 as the TPU kernel does, so the two differ only in the order
of fp64 summation: per-step iterations, status and the final rung are
equal, and trajectories agree to 1e-9. Noise is made with numpy and handed
to both.
"""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reluqp_tpu.models.mpc as JM
import reluqp_tpu.ops.solve_kernel as JSK
import reluqp_tpu_torch.models.mpc as TM
import reluqp_tpu_torch.ops.solve_kernel as TSK

ATOL = 1e-9   # fp64, summation order only


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _system(name):
    if name == "double_integrator":
        Ad, Bd = TM.double_integrator(dt=0.1)
        return Ad, Bd, np.diag([10.0, 1.0]), np.array([[0.1]]), 8
    Ad, Bd = TM.random_linear_system(6, 2, seed=0)
    return Ad, Bd, np.eye(6), 0.1 * np.eye(2), 5


def _pair(system="double_integrator", backend="auto", **kw):
    Ad, Bd, Q, R, horizon = _system(system)
    base = dict(horizon=horizon, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
                precision="float64")
    base.update(kw)
    j = JM.MPC(Ad, Bd, Q, R, backend="xla", bank_backend="numpy", **base)
    t = TM.MPC(Ad, Bd, Q, R, device="cpu", backend=backend,
               bank_backend="numpy", **base)
    return j, t


def _x0(nx, seed=1):
    return np.random.RandomState(seed).randn(nx)


def _jax_scan(j, x0, T, ci=None, y0=None, rho0=None, noise=None):
    """JAX's scan path: (states, us, iters, status, y_f, rho_f)."""
    with pltpu.force_tpu_interpret_mode():
        return JM._scan_rollout(j.solver, j.prob, x0, T, None, ci, y0, rho0,
                                noise)


def _port_scan(t, x0, T, **kw):
    return TM.mpc_rollout_scan(t.solver, t.prob, x0, T, kernel="scan",
                               return_stats=True, return_state=True, **kw)


def _assert_same(jo, to, t):
    jx, ju, jit, jst, jy, jr = jo
    tx, tu, tit, tst, ty, tr = to
    np.testing.assert_array_equal(np.asarray(jit), tit.numpy())
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    assert int(jr) == tr
    np.testing.assert_allclose(_np(jx), _np(tx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_np(ju), _np(tu), rtol=0, atol=ATOL)
    D = t.solver.D
    np.testing.assert_allclose(_np(jy)[:D], _np(ty)[:D], rtol=0, atol=ATOL)
    assert (_np(ty)[D:] == 0.0).all(), "padded y lanes must stay exactly 0"


@pytest.mark.parametrize("scaling", [False, True])
@pytest.mark.parametrize("system", ["double_integrator", "random"])
def test_scan_matches_jax(system, scaling):
    j, t = _pair(system, scaling=scaling)
    x0 = _x0(j.nx)
    to = _port_scan(t, x0, 12)
    _assert_same(_jax_scan(j, x0, 12), to, t)
    assert (to[3].numpy() == 1).all()
    assert to[0].shape == (13, j.nx) and to[1].shape == (12, j.nu)


@pytest.mark.parametrize("ci", [5, 3])
def test_scan_window_and_noise_match_jax(ci):
    """An explicit window (3 does not divide max_iter=4000: the budget is
    rounded down to whole windows) with numpy process noise."""
    j, t = _pair("random", backend="xla")
    T = 15
    noise = 0.03 * np.random.RandomState(9).randn(T, j.nx)
    x0 = _x0(j.nx)
    to = _port_scan(t, x0, T, check_interval=ci, noise=noise)
    _assert_same(_jax_scan(j, x0, T, ci=ci, noise=noise), to, t)
    assert (to[2].numpy() % ci == 0).all()
    assert to[4].shape == (t.solver.Dp,)   # back in the unpadded layout


def test_scan_cold_start_under_disturbance_matches_jax():
    """A cold start under a heavy disturbance (0.3·randn, as the JAX
    disturbance sweep uses): long, ladder-walking solves stay in step with
    JAX (the operand-level test below checks that the rung moves)."""
    j, t = _pair("double_integrator", eps_abs=1e-5)
    T = 20
    noise = 0.3 * np.random.RandomState(4).randn(T, j.nx)
    x0 = np.array([1.0, 0.0])
    to = _port_scan(t, x0, T, check_interval=5, noise=noise)
    jo = _jax_scan(j, x0, T, ci=5, noise=noise)
    _assert_same(jo, to, t)


def test_scan_continuation_matches_one_run():
    """Two stitched segments (carrying y, the rung and x) equal one run of
    16 steps — what check_interval="auto" relies on."""
    j, t = _pair()
    x0 = np.array([1.0, 0.0])
    a = _port_scan(t, x0, 8)
    b = TM._scan_rollout(t.solver, t.prob, a[0][-1], 8, None, None, a[4],
                         a[5])
    full = _port_scan(_pair()[1], x0, 16)
    np.testing.assert_array_equal(torch.cat([a[2], b[2]]).numpy(),
                                  full[2].numpy())
    np.testing.assert_allclose(_np(torch.cat([a[0], b[0][1:]])),
                               _np(full[0]), rtol=0, atol=0)
    _assert_same(_jax_scan(j, x0, 16), full, t)


def test_scan_budget_bound_steps_match_jax():
    """eps 1e-12 under max_iter 50: every step spends its budget and
    reports status 0 (max_iter), and the rollout stays finite."""
    j, t = _pair(eps_abs=1e-12, max_iter=50)
    x0 = np.array([1.0, 0.0])
    to = _port_scan(t, x0, 6, check_interval=25)
    _assert_same(_jax_scan(j, x0, 6, ci=25), to, t)
    assert (to[2].numpy() == 50).all() and (to[3].numpy() == 0).all()
    assert np.isfinite(_np(to[0])).all()


def test_scan_auto_window_matches_jax():
    j, t = _pair("random")
    T = 16
    x0 = _x0(j.nx)
    noise = 0.01 * np.random.RandomState(5).randn(T, j.nx)
    used = [0]

    def run(ci, x, y0, rho0, steps):
        w = noise[used[0]:used[0] + steps]
        used[0] += steps
        return _jax_scan(j, x, steps, ci=ci, y0=y0, rho0=rho0, noise=w)

    stng = j.solver.settings
    jo = JM._auto_ci_rollout(run, stng, x0, T, 6, j.solver.y,
                             j.solver.rho_ind, stng.max_iter)
    to = _port_scan(t, x0, T, check_interval="auto", calib_steps=6,
                    noise=noise)
    _assert_same(jo, to, t)


def test_scan_gating():
    x0 = np.array([1.0, 0.0])
    for kw in (dict(iter_precision="high"), dict(check_infeasibility=True)):
        _, t = _pair(eps_abs=1e-4, precision="float32", **kw)
        with pytest.raises(ValueError, match="scan"):
            TM.mpc_rollout_scan(t.solver, t.prob, x0, 3, kernel="scan")
    # the budget must hold at least one full window
    _, t = _pair(eps_abs=1e-4, max_iter=100)
    with pytest.raises(ValueError, match="scan"):
        TM.mpc_rollout_scan(t.solver, t.prob, x0, 3, kernel="scan",
                            check_interval=200)
    with pytest.raises(ValueError, match="scan"):
        TM._scan_rollout(t.solver, t.prob, x0, 3, 10, 25, None, None)
    # reduced precision without the two-phase refine is eligible
    _, t = _pair(iter_precision="high", refine=False)
    assert TM._scan_rollout_eligible(t.solver)


# --------------------------------------------------------------------- #
# operand level: _build_rollout_operators and full_rollout_ref          #
# --------------------------------------------------------------------- #

_OP_KEYS = ("M_res", "bias_c", "M_aff", "GL", "g0w", "lo0", "hi0", "S_u",
            "Bdw")


def test_rollout_operators_match_jax():
    """The K2 operands equal JAX's element for element in fp64, with Ruiz
    scaling folding its weights into M_res, GL and g0w."""
    j, t = _pair("random", scaling=True)
    js, ts = j.solver, t.solver
    jops = JM._build_rollout_operators(
        j.prob, js.scal, js._H_s, js._A_s, js._w_pri_np, js._w_dua_np,
        _padded_B(js, ts.Dp), js.nx, js.nc, ts.Dp, js.settings.precision_dtype)
    tops = TM._build_rollout_operators(
        t.prob, ts.scal, ts._H_s, ts._A_s, ts._w_pri_np, ts._w_dua_np,
        ts._B_np, ts.nx, ts.nc, ts.Dp, torch.float64)
    for key in _OP_KEYS:
        np.testing.assert_array_equal(np.asarray(jops[key]), _np(tops[key]),
                                      err_msg=key)
    for key in ("nxp", "ncp", "nplp", "nup"):
        assert jops[key] == tops[key], key


def _padded_B(js, Dp):
    B = np.zeros((js._B_np.shape[0], Dp, js.nx))
    B[:, :js._B_np.shape[1]] = js._B_np
    return B


def _operand_rollout(fn, t, x0, T, noise, ci, to=None, replace=None,
                     **kw_over):
    """``fn`` (JAX ``full_rollout`` or the port's) on the port's K2 call
    for a cold segment (``TM._scan_call``); ``to`` maps each operand, as a
    numpy array, to the callee's array type; ``replace`` swaps operands by
    position and ``kw_over`` settings, after the call is made."""
    args, kw = TM._scan_call(t.solver, t.prob, x0, T, ci=ci,
                             y0=torch.zeros_like(t.solver.y), noise=noise)
    for i, a in (replace or {}).items():
        args[i] = a
    if to is not None:
        args = [to(_np(a)) if isinstance(a, torch.Tensor) else a
                for a in args]
    return fn(*args, **dict(kw, **kw_over))


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("rho_jump", [False, True])
def test_full_rollout_ref_matches_jax_kernel(monkeypatch, tiled, rho_jump):
    """``full_rollout_ref`` against JAX ``full_rollout`` on the same numpy
    operands, from a cold start under a 0.3·randn disturbance. ``tiled``
    forces JAX's contraction-tiled dots onto Dp=128 with 48-wide tiles, a
    PARTIAL final tile (48+48+32, F-w1): JAX then rounds every tile's
    partial sum to fp32 and adds them in fp32, where the port rounds each
    product once, so the two differ by fp32 roundings (~1e-7 relative)
    instead of fp64 ones; a dropped tile would miss by O(1)."""
    import jax.numpy as jnp
    _, t = _pair(eps_abs=1e-5, rho_jump=rho_jump)
    T, ci = 16, 5
    noise = 0.3 * np.random.RandomState(4).randn(T, 2)
    x0 = np.array([1.0, 0.0])
    if tiled:
        monkeypatch.setattr(JSK, "_TILE_ABOVE", 0)
        monkeypatch.setattr(JSK, "_DOT_TILE", 48)
    JSK.full_rollout.clear_cache()
    try:
        with pltpu.force_tpu_interpret_mode():
            jo = _operand_rollout(JSK.full_rollout, t, x0, T, noise, ci,
                                  to=lambda a: jnp.asarray(a, jnp.float64))
    finally:
        JSK.full_rollout.clear_cache()   # leak no tiled executables
    to = _operand_rollout(TSK.full_rollout, t, x0, T, noise, ci)
    js, ts = np.asarray(jo[2]), _np(to[2])
    for lane in (0, 4, 5):   # iterations, rung, status
        np.testing.assert_array_equal(js[:, lane], ts[:, lane])
    assert len(set(ts[:, 4].tolist())) > 1, "the rung never moved"
    atol = 1e-6 if tiled else ATOL
    for a, b in zip(jo[:2], to[:2]):
        np.testing.assert_allclose(np.asarray(a), _np(b), rtol=0, atol=atol)
    assert (_np(to[3])[t.solver.D:] == 0.0).all()


def test_full_rollout_checks_its_operands():
    _, t = _pair()
    ops = TM._scan_operands(t.solver, t.prob, t.solver.Dp)
    noise = np.zeros((3, 2))
    with pytest.raises(ValueError, match="multiple of check_interval"):
        _operand_rollout(TSK.full_rollout, t, [1.0, 0.0], 3, noise, 25,
                         max_iter=110)
    with pytest.raises(ValueError, match="S_u"):
        _operand_rollout(TSK.full_rollout, t, [1.0, 0.0], 3, noise, 25,
                         replace={9: ops["S_u"][:, :64]})
    out = _operand_rollout(TSK.full_rollout, t, [1.0, 0.0], 0,
                           np.zeros((0, 2)), 25)
    assert out[0].shape == (0, ops["nplp"]) and out[2].shape == (0, 8)
