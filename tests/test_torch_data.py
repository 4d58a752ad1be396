"""Host-side data of the PyTorch port against the JAX package, in fp64.

Ladder, problem generators, Ruiz scaling, the bank compiler, the residual
operator, the padded runtime bank layout and Settings validation. The
host code is the same numpy arithmetic in both packages, so the arrays
must be identical, not merely close.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import reluqp_tpu.classes as jcls
import reluqp_tpu.core.bank as jbank
import reluqp_tpu.core.ladder as jladder
import reluqp_tpu.solver as jsolver
import reluqp_tpu.utils.problems as jprob
import reluqp_tpu.utils.scaling as jscal
from reluqp_tpu.ops.solve_kernel import \
    build_residual_operator as j_residual_operator

import reluqp_tpu_torch.classes as tcls
import reluqp_tpu_torch.core.bank as tbank
import reluqp_tpu_torch.core.ladder as tladder
import reluqp_tpu_torch.solver as tsolver
import reluqp_tpu_torch.utils.problems as tprob
import reluqp_tpu_torch.utils.scaling as tscal
from reluqp_tpu_torch.ops.fused_step import pad_dim
from reluqp_tpu_torch.ops.solve_kernel import \
    build_residual_operator as t_residual_operator


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _same(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("args", [
    (0.1, 1e-6, 1e6, True, 5.0),
    (0.5, 1e-4, 1e3, True, 3.0),
    (0.1, 1e-6, 1e6, False, 5.0),
])
def test_ladder_identical(args):
    j = jladder.setup_rhos(*args)
    t = tladder.setup_rhos(*args)
    _same(j, t)
    assert jladder.initial_rho_index(j, args[0]) == \
        tladder.initial_rho_index(t, args[0])


@pytest.mark.parametrize("nx,seed", [(10, 0), (23, 3), (60, 1)])
def test_problem_generators_identical(nx, seed):
    j = jprob.rand_qp(nx, nx // 4, nx // 4, seed=seed, compute_sol=False)
    t = tprob.rand_qp(nx, nx // 4, nx // 4, seed=seed, compute_sol=False)
    for a, b in zip(j[:5], t[:5]):
        _same(a, b)
    ju = jprob.update_qp(j.H, j.A, nx // 4, nx // 4, seed=seed + 7,
                         compute_sol=False)
    tu = tprob.update_qp(t.H, t.A, nx // 4, nx // 4, seed=seed + 7,
                         compute_sol=False)
    for a, b in zip(ju[:5], tu[:5]):
        _same(a, b)
    for a, b in zip(jprob.canonical_qp(), tprob.canonical_qp()):
        _same(a, b)


def test_ruiz_scaling_identical():
    inst = jprob.rand_qp(30, 7, 7, seed=2, compute_sol=False)
    j = jscal.ruiz_equilibrate(inst.H, inst.A, inst.g)
    t = tscal.ruiz_equilibrate(inst.H, inst.A, inst.g)
    for a, b in zip(j, t):
        _same(a, b)
    stng = dataclasses.make_dataclass(
        "S", [("scaling", bool, True), ("scaled_termination", bool, False)])()
    for a, b in zip(jscal.residual_unscale_weights(j, stng),
                    tscal.residual_unscale_weights(t, stng)):
        _same(a, b)
    for a, b in zip(jscal.identity_scaling(4, 3),
                    tscal.identity_scaling(4, 3)):
        _same(a, b)


@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_bank_identical(alpha):
    inst = jprob.rand_qp(20, 5, 5, seed=4, compute_sol=False)
    eq = jbank.equality_mask(inst.l, inst.u, 1e-6)
    _same(eq, tbank.equality_mask(inst.l, inst.u, 1e-6))
    rhos = jladder.setup_rhos(0.1, 1e-6, 1e6, True, 5.0)
    # the fp32 ρ cap is finite here, so capped rungs are covered
    cap_j = jbank.auto_rho_cap(inst.A, 1e-3, jnp.float32, 20)
    cap_t = tbank.auto_rho_cap(inst.A, 1e-3, torch.float32, 20)
    assert cap_j == cap_t and np.isfinite(cap_t)
    assert tbank.auto_rho_cap(inst.A, 1e-3, torch.float64, 20) == np.inf
    s2 = jbank.sigma_max_sq(inst.A)
    assert s2 == tbank.sigma_max_sq(inst.A)
    assert jbank.certifiable_eps_floor(cap_j, s2, jnp.float32, 20) == \
        tbank.certifiable_eps_floor(cap_t, s2, torch.float32, 20)
    _same(jbank.effective_rho_ladder(rhos, eq, cap_j),
          tbank.effective_rho_ladder(rhos, eq, cap_t))
    assert jbank.EQ_RHO_BOOST == tbank.EQ_RHO_BOOST
    jW = jbank.build_bank_np(inst.H, inst.g, inst.A, eq, rhos, 1e-6,
                             alpha=alpha, rho_cap=cap_j)
    tW = tbank.build_bank_np(inst.H, inst.g, inst.A, eq, rhos, 1e-6,
                             alpha=alpha, rho_cap=cap_t)
    for a, b in zip(jW, tW):
        _same(a, b)
    for a, b in zip(jbank.clamp_bounds(inst.l, inst.u, 20, 10),
                    tbank.clamp_bounds(inst.l, inst.u, 20, 10)):
        _same(a, b)
    assert jbank.stacked_dim(20, 10) == tbank.stacked_dim(20, 10)


@pytest.mark.parametrize("weighted,lam_segment",
                         [(False, True), (True, True), (True, False)])
def test_residual_operator_identical(weighted, lam_segment):
    inst = jprob.rand_qp(12, 3, 4, seed=5, compute_sol=False)
    rng = np.random.RandomState(0)
    wp = rng.rand(7) + 0.5 if weighted else None
    wd = rng.rand(12) + 0.5 if weighted else None
    dp = pad_dim(12 + 14)
    j = j_residual_operator(inst.H, inst.A, inst.g, dp, jnp.float64,
                            w_pri=wp, w_dua=wd, lam_segment=lam_segment)
    t = t_residual_operator(inst.H, inst.A, inst.g, dp, torch.float64,
                            w_pri=wp, w_dua=wd, lam_segment=lam_segment)
    _same(j[0], t[0])
    _same(j[1], t[1])
    assert j[2:] == t[2:]


@pytest.mark.parametrize("w_bf16", [False, True])
def test_prepare_bank_layout_identical(w_bf16):
    inst = jprob.rand_qp(20, 5, 5, seed=6, compute_sol=False)
    eq = jbank.equality_mask(inst.l, inst.u, 1e-6)
    rhos = jladder.setup_rhos(0.1, 1e-6, 1e6, True, 5.0)
    W, B, b = jbank.build_bank_np(inst.H, inst.g, inst.A, eq, rhos, 1e-6)
    dp = pad_dim(W.shape[1])
    jb = jsolver.prepare_bank(W, B, b, rhos, jnp.float64, dp,
                              w_dtype=jnp.bfloat16 if w_bf16 else None)
    tb = tsolver.prepare_bank(W, B, b, rhos, torch.float64, dp,
                              w_dtype=torch.bfloat16 if w_bf16 else None)
    assert tb.W.shape == (len(rhos), dp, dp)
    assert tb.W.dtype == (torch.bfloat16 if w_bf16 else torch.float64)
    for a, c in zip(jb, tb):
        _same(a, c)
    # padding is inert: zero weights and zero bias beyond D
    d = W.shape[1]
    assert not _np(tb.W)[:, d:, :].any() and not _np(tb.W)[:, :, d:].any()
    assert not _np(tb.b)[:, d:].any()


def test_solver_setup_state_identical():
    """The two solvers set up on one instance hold the same device data."""
    inst = jprob.rand_qp(16, 4, 4, seed=7, compute_sol=False)
    j = jsolver.ReLU_QP()
    j.setup(*inst[:5], precision="float64", backend="xla",
            bank_backend="numpy", scaling=True)
    t = tsolver.ReLU_QP()
    t.setup(*inst[:5], precision="float64", backend="xla", device="cpu",
            bank_backend="numpy", scaling=True)
    assert (j.D, j.Dp) == (t.D, t.Dp)
    for a, b in zip(j.bank, t.bank):
        _same(a, b)
    for a, b in zip(j.qp_dev, t.qp_dev):
        _same(a, b)
    assert j.rho_ind == t.rho_ind and j.rho_cap == t.rho_cap


INVALID = [
    ("check_interval", 0), ("max_iter", 0), ("adaptive_rho_tolerance", 1.0),
    ("adaptive_rho_interval", -1), ("alpha", 0.0), ("alpha", 2.0),
    ("rho_cap", "manual"), ("rho_cap", 0.0), ("backend", "triton"),
    ("iter_precision", "fp8"), ("precision", "int8"),
]


@pytest.mark.parametrize("field,value", INVALID,
                         ids=[f"{f}={v}" for f, v in INVALID])
def test_invalid_settings_raise_in_both(field, value):
    with pytest.raises(ValueError):
        jcls.Settings(**{field: value})
    with pytest.raises(ValueError):
        tcls.Settings(device="cpu", **{field: value})


def test_settings_fields_and_dtypes():
    assert jcls.SETTINGS_FIELDS == tcls.SETTINGS_FIELDS
    for spec, dt in [("fp64", torch.float64), ("float32", torch.float32),
                     ("bf16", torch.bfloat16), (np.float64, torch.float64),
                     (torch.float32, torch.float32)]:
        assert tcls.as_dtype(spec) == dt


def test_default_device_is_cuda_or_raises():
    """No device given means cuda; without a GPU that raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        assert tcls.Settings().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcls.Settings()
        with pytest.raises(RuntimeError):
            tsolver.ReLU_QP().setup(*tprob.canonical_qp()[:5])
    assert tcls.Settings(device="cpu").device == torch.device("cpu")
