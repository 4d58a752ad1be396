"""The MPC layer of the PyTorch port against the JAX package.

Small plants (a double integrator, a random 6-state/2-input system),
horizon 5, a u box. The JAX side runs its loop path (``kernel="loop"``);
the port its loop path through the plain version of kernel K1. In fp64
the trajectories agree to 1e-8 and the per-step iteration counts are
equal; the process noise is made with numpy and handed to both.
"""
import numpy as np
import pytest
import torch

import reluqp_tpu.models.mpc as JM
import reluqp_tpu_torch.models.mpc as TM


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _system(name):
    if name == "double_integrator":
        Ad, Bd = TM.double_integrator(dt=0.1)
        for a, b in zip((Ad, Bd), JM.double_integrator(dt=0.1)):
            np.testing.assert_array_equal(a, b)
        return Ad, Bd, np.diag([10.0, 1.0]), np.array([[0.1]])
    Ad, Bd = TM.random_linear_system(6, 2, seed=0)
    for a, b in zip((Ad, Bd), JM.random_linear_system(6, 2, seed=0)):
        np.testing.assert_array_equal(a, b)
    return Ad, Bd, np.eye(6), 0.1 * np.eye(2)


KW = dict(horizon=5, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
          precision="float64")


def _pair(system):
    Ad, Bd, Q, R = _system(system)
    j = JM.MPC(Ad, Bd, Q, R, bank_backend="numpy", **KW)
    t = TM.MPC(Ad, Bd, Q, R, device="cpu", bank_backend="numpy", **KW)
    for a, b in zip(j.prob, t.prob):
        np.testing.assert_array_equal(a, b)
    return j, t, Ad.shape[0]


@pytest.mark.parametrize("system", ["double_integrator", "random"])
def test_mpc_step_matches_jax(system):
    j, t, nx = _pair(system)
    x = np.random.RandomState(1).randn(nx)
    for _ in range(4):
        uj, rj = j.step(x)
        ut, rt = t.step(x)
        assert rj.info.iter == rt.info.iter
        assert rt.info.status == "solved"
        np.testing.assert_allclose(uj, ut, rtol=0, atol=1e-8)
        x = j.Ad @ x + j.Bd @ ut


@pytest.mark.parametrize("ci", [25, "auto"])
@pytest.mark.parametrize("noisy", [False, True])
@pytest.mark.parametrize("system", ["double_integrator", "random"])
def test_rollout_matches_jax(system, noisy, ci):
    j, t, nx = _pair(system)
    rng = np.random.RandomState(2)
    x0 = rng.randn(nx)
    noise = 0.01 * rng.randn(20, nx) if noisy else None
    jx, ju, jit, jst = JM.mpc_rollout_scan(
        j.solver, j.prob, x0, 20, kernel="loop", noise=noise,
        check_interval=ci, return_stats=True)
    tx, tu, tit, tst, y_f, rho_f = TM.mpc_rollout_scan(
        t.solver, t.prob, x0, 20, kernel="loop", noise=noise,
        check_interval=ci, return_stats=True, return_state=True)
    assert tx.shape == (21, nx) and tu.shape == (20, j.nu)
    np.testing.assert_array_equal(np.asarray(jit), tit.numpy())
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())
    assert (tst.numpy() == 1).all()
    np.testing.assert_allclose(_np(jx), _np(tx), rtol=0, atol=1e-8)
    np.testing.assert_allclose(_np(ju), _np(tu), rtol=0, atol=1e-8)
    assert y_f.shape == (t.solver.Dp,) and 0 <= rho_f < len(t.solver.rhos_np)


def test_rollout_kernel_choice():
    _, t, nx = _pair("double_integrator")
    x0 = np.ones(nx)
    xs_auto = TM.mpc_rollout_scan(t.solver, t.prob, x0, 3, kernel="auto")[0]
    xs_loop = TM.mpc_rollout_scan(t.solver, t.prob, x0, 3, kernel="loop")[0]
    torch.testing.assert_close(xs_auto, xs_loop, rtol=0, atol=0)
    # "scan" and "fused" run K2's and K3's plain versions on the CPU: the
    # same steps to the solve tolerance (the fused path has no M_lo
    # compensation of the bias, so it is not bit-equal to the loop)
    for kernel in ("scan", "fused"):
        xs_k = TM.mpc_rollout_scan(t.solver, t.prob, x0, 3,
                                   kernel=kernel)[0]
        assert xs_k.shape == xs_loop.shape and torch.isfinite(xs_k).all()
        torch.testing.assert_close(xs_k, xs_loop, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        TM.mpc_rollout_scan(t.solver, t.prob, x0, 3, kernel="pallas")
    with pytest.raises(ValueError):
        TM.mpc_rollout_scan(t.solver, t.prob, x0, 3, noise=np.zeros((2, nx)))


def test_auto_check_interval_and_lqr_match_jax():
    for it, ci, mi in (([40, 30, 5, 3, 2, 2], 25, 2000),
                       ([90, 80, 70, 60], 25, 200), ([1], 25, 100)):
        assert TM.auto_check_interval(it, ci, mi) == \
            JM.auto_check_interval(it, ci, mi)
    Ad, Bd, Q, R = _system("random")
    for a, b in zip(TM.ihlqr(Ad, Bd, Q, R), JM.ihlqr(Ad, Bd, Q, R)):
        np.testing.assert_array_equal(a, b)
