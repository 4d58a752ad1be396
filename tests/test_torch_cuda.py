"""Tests of the PyTorch port that need an NVIDIA GPU.

Kernel K1 is CUDA code with no CPU mode, so these skip without a GPU. On
the GPU machine (which has no JAX) run them without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package.
"""
import numpy as np
import pytest
import torch

import reluqp_tpu_torch as rqt
from reluqp_tpu_torch.models import mpc
from reluqp_tpu_torch.ops.fused_step import (fused_chunk, fused_chunk_ref,
                                             pallas_chunk_runner)
from reluqp_tpu_torch.utils.problems import canonical_qp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU "
                    "mode")
    return torch.device("cuda")


def _inputs(dp, dev, rows=1, n_rho=4, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    wt = rn(n_rho, dp, dp) * (0.7 / dp ** 0.5)
    lo = torch.full((rows, dp), -0.8, device=dev)
    return wt, 0.1 * rn(rows, dp), lo, -lo, 0.5 * rn(rows, dp)


# Kernel and plain version sum in different orders (fp32 rounding only);
# the bf16 tier re-rounds y every step, so one flipped rounding moves a
# lane by a bf16 ulp that later steps carry on.
@pytest.mark.parametrize("dp", [128, 640, 896])
def test_k1_matches_plain_version(dev, dp):
    wt, b, lo, hi, y = _inputs(dp, dev)
    rho = torch.tensor([3], dtype=torch.int32, device=dev)
    for tier, tol in (("highest", 1e-5), ("high", 1e-5), ("bf16", 3e-2)):
        before = fused_chunk.launches
        out = fused_chunk(wt, b, lo, hi, y, rho, 25, tier)
        assert fused_chunk.launches == before + 1
        ref = fused_chunk_ref(wt, b, lo, hi, y, rho, 25, tier)
        assert out.data_ptr() not in (y.data_ptr(), ref.data_ptr())
        assert float((out - ref).abs().max()) <= tol, tier


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(dev):
    wt, b, lo, hi, y = _inputs(128, dev, rows=2)
    rho = torch.tensor([0], dtype=torch.int32, device=dev)
    bad = [
        (wt, b, lo, hi, y[:, :64], rho),                  # strided view
        (wt, b, lo, hi, y.t().contiguous().t(), rho),     # column-major
        (wt, b, lo, hi, y, rho.long()),                   # index dtype
        (wt, b.double(), lo, hi, y, rho),                 # mixed dtypes
        (wt.cpu(), b, lo, hi, y, rho),                    # mixed devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fused_chunk(*args, 5)


def test_solver_on_cuda_runs_k1(dev):
    qp = canonical_qp()
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4)
    assert m.settings.device.type == "cuda"
    assert m._chunk_runner is pallas_chunk_runner
    before = fused_chunk.launches
    res = m.solve()
    assert fused_chunk.launches > before
    assert res.info.status == "solved" and res.x.is_cuda
    np.testing.assert_allclose(res.x.cpu().double().numpy(), qp.x_sol,
                               atol=1e-3)
    # the plain runner on the card gives the same answer without K1
    x = rqt.ReLU_QP()
    x.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4, backend="xla")
    before = fused_chunk.launches
    rx = x.solve()
    assert fused_chunk.launches == before
    assert rx.info.iter == res.info.iter
    torch.testing.assert_close(rx.x, res.x, rtol=0, atol=1e-5)


def test_mpc_rollout_on_cuda_matches_cpu(dev):
    Ad, Bd = mpc.double_integrator(dt=0.1)
    kw = dict(horizon=5, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
              precision="float64")
    Q, R = np.diag([10.0, 1.0]), np.array([[0.1]])
    g = mpc.MPC(Ad, Bd, Q, R, **kw)
    c = mpc.MPC(Ad, Bd, Q, R, device="cpu", **kw)
    x0 = np.array([1.0, -0.5])
    before = fused_chunk.launches
    xg, ug, ig = mpc.mpc_rollout_scan(g.solver, g.prob, x0, 15,
                                      check_interval="auto")
    assert fused_chunk.launches > before and xg.is_cuda
    xc, uc, ic = mpc.mpc_rollout_scan(c.solver, c.prob, x0, 15,
                                      check_interval="auto")
    np.testing.assert_array_equal(ig.numpy(), ic.numpy())
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=1e-8)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=1e-8)
