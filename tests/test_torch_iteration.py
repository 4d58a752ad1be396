"""Solve-loop building blocks of the PyTorch port against the JAX package.

The same numpy inputs (fp64) go through both; residuals, ρ estimates and
certificates agree to fp64 rounding, ladder steps exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reluqp_tpu.core.iteration as jit_
from reluqp_tpu.ops.solve_kernel import \
    build_residual_operator as j_residual_operator

import reluqp_tpu_torch.core.iteration as tit
from reluqp_tpu_torch.ops.solve_kernel import \
    build_residual_operator as t_residual_operator

TOL = 1e-12   # fp64; the two sum the same products in different orders


def _both(*arrs):
    return ([jnp.asarray(a, jnp.float64) for a in arrs],
            [torch.as_tensor(a, dtype=torch.float64) for a in arrs])


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               torch.as_tensor(b).double().numpy(),
                               rtol=tol, atol=tol)


def _qp(nx=9, nc=6, seed=0):
    rng = np.random.RandomState(seed)
    H = rng.randn(nx, nx)
    H = H @ H.T + np.eye(nx)
    A = rng.randn(nc, nx)
    return (H, A, rng.randn(nx), rng.randn(nx), rng.randn(nc),
            rng.randn(nc))


@pytest.mark.parametrize("weighted", [False, True])
def test_compute_residuals(weighted):
    H, A, g, x, z, lam = _qp()
    rng = np.random.RandomState(1)
    wp, wd = rng.rand(6) + 0.5, rng.rand(9) + 0.5
    J, T = _both(H, A, g, x, z, lam, wp, wd)
    jr = jit_.compute_residuals(*J[:6], jnp.asarray(0.3), 1e-6, 1e6,
                                *(J[6:] if weighted else (None, None)))
    tr = tit.compute_residuals(*T[:6], torch.tensor(0.3, dtype=torch.float64),
                               1e-6, 1e6,
                               *(T[6:] if weighted else (None, None)))
    for a, b in zip(jr, tr):
        _close(a, b)
    _close(jit_.compute_objective(J[0], J[2], J[3]),
           tit.compute_objective(T[0], T[2], T[3]))


@pytest.mark.parametrize("weighted", [False, True])
def test_compute_residuals_op(weighted):
    H, A, g, x, z, lam = _qp(seed=2)
    rng = np.random.RandomState(3)
    wp = rng.rand(6) + 0.5 if weighted else None
    wd = rng.rand(9) + 0.5 if weighted else None
    dp = 128
    y = np.zeros(dp)
    y[:9], y[9:15], y[15:21] = x, z, lam
    Mj, gj, nxp, ncp = j_residual_operator(H, A, g, dp, jnp.float64,
                                           w_pri=wp, w_dua=wd)
    Mt, gt, _, _ = t_residual_operator(H, A, g, dp, torch.float64,
                                       w_pri=wp, w_dua=wd)
    jr = jit_.compute_residuals_op(Mj, gj[0], jnp.asarray(y), nxp, ncp,
                                   jnp.asarray(0.3), 1e-6, 1e6)
    tr = tit.compute_residuals_op(Mt, gt[0], torch.as_tensor(y), nxp, ncp,
                                  torch.tensor(0.3, dtype=torch.float64),
                                  1e-6, 1e6)
    for a, b in zip(jr, tr):
        _close(a, b)
    # and the matvec form agrees with the one-matmul form
    J, T = _both(H, A, g, x, z, lam, *([wp, wd] if weighted else []))
    mv = tit.compute_residuals(*T[:6], torch.tensor(0.3, dtype=torch.float64),
                               1e-6, 1e6, *(T[6:] if weighted else ()))
    for a, b in zip(mv, tr):
        _close(a.numpy(), b, 1e-10)


RHOS = np.array([1e-3, 5e-3, 2.5e-2, 0.125, 0.625, 3.125])


@pytest.mark.parametrize("jump", [False, True])
@pytest.mark.parametrize("batched", [False, True])
def test_rho_ladder_step(jump, batched):
    rng = np.random.RandomState(4 + jump + 2 * batched)
    ests = 10.0 ** rng.uniform(-4.5, 1.5, size=12)
    inds = rng.randint(0, len(RHOS), size=12)
    inds[:2] = (0, len(RHOS) - 1)          # the ends of the ladder
    done = rng.rand(12) < 0.3
    if batched:
        cases = [(inds, ests, done)]
    else:
        cases = [(np.asarray(i), np.asarray(e), None)
                 for i, e in zip(inds, ests)]
    for ind, est, dn in cases:
        j = jit_.rho_ladder_step(jnp.asarray(RHOS), jnp.asarray(ind, jnp.int32),
                                 jnp.asarray(est), jnp.asarray(5.0), jump,
                                 None if dn is None else jnp.asarray(dn))
        t = tit.rho_ladder_step(
            torch.as_tensor(RHOS), torch.as_tensor(ind, dtype=torch.int32),
            torch.as_tensor(est), torch.tensor(5.0, dtype=torch.float64),
            jump, None if dn is None else torch.as_tensor(dn))
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(j), t.numpy())


def test_rho_update_stride():
    for interval in (0, 1, 24, 25, 26, 50, 51, 100, 1000):
        for ci in (1, 10, 25):
            assert tit.rho_update_stride(interval, ci) == \
                jit_.rho_update_stride(interval, ci)


def _certs(lib, arrs, eps):
    return [bool(v) for v in lib.infeasibility_certificates(*arrs, eps, eps)]


@pytest.mark.parametrize("case", ["random", "primal_inf", "dual_inf"])
def test_infeasibility_certificates(case):
    rng = np.random.RandomState(5)
    if case == "random":
        H, A, g, dx, _, dlam = _qp(seed=6)
        l = -np.abs(rng.randn(6))
        u = np.where(rng.rand(6) < 0.3, np.inf, np.abs(rng.randn(6)))
    elif case == "primal_inf":
        # x1 >= 1 and x1 <= -1: δλ = (-1, 1) has Aᵀδλ = 0, negative support
        H, g = np.eye(2), np.zeros(2)
        A = np.array([[1.0, 0.0], [1.0, 0.0]])
        l, u = np.array([1.0, -np.inf]), np.array([np.inf, -1.0])
        dx, dlam = np.zeros(2), np.array([-1.0, 1.0])
    else:
        # min -x1 with H = 0 on the unbounded ray x1 → +inf
        H, g = np.zeros((2, 2)), np.array([-1.0, 0.0])
        A = np.array([[0.0, 1.0]])
        l, u = np.array([-1.0]), np.array([1.0])
        dx, dlam = np.array([1.0, 0.0]), np.zeros(1)
    J, T = _both(H, A, g, l, u, dx, dlam)
    j = _certs(jit_, J, 1e-4)
    t = _certs(tit, T, 1e-4)
    assert j == t
    if case != "random":
        assert t == [case == "primal_inf", case == "dual_inf"]
