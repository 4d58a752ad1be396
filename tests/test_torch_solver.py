"""``ReLU_QP`` of the PyTorch port against the JAX package's solver.

Both solve bit-identical instances (the same ``rand_qp`` sampling). In
fp64 the two run the same arithmetic up to summation order, so status,
iteration count and final ρ index must be EQUAL and x/z/λ agree to 1e-8.
In fp32 rounding can move a certification by a window: status equal,
iterations within one check window, x within 1e-3. The JAX side pins
``bank_backend="numpy"`` (it would otherwise take a native library built
by another test) and ``backend="xla"``, its CPU path; the port runs its
default backend, the plain version of kernel K1 on the CPU.
"""
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reluqp_tpu as J
from reluqp_tpu.utils.problems import canonical_qp, rand_qp

import reluqp_tpu_torch as T
from reluqp_tpu_torch.convert import bank_from_arrays
from reluqp_tpu_torch.ops.fused_step import pallas_chunk_runner


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _pair(data, jax_backend="xla", **kw):
    j = J.ReLU_QP()
    j.setup(*data, backend=jax_backend, bank_backend="numpy", **kw)
    t = T.ReLU_QP()
    t.setup(*data, device="cpu", **kw)
    return j, t


def _agree_fp64(jr, tr, j, t, tol=1e-8):
    assert jr.info.status == tr.info.status
    assert jr.info.iter == tr.info.iter
    assert j.rho_ind == t.rho_ind
    for a, b in ((jr.x, tr.x), (jr.z, tr.z), (jr.lam, tr.lam)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_canonical_qp(backend):
    qp = canonical_qp()
    m = T.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4, device="cpu",
            backend=backend)
    res = m.solve()
    assert res.info.status == "solved"
    np.testing.assert_allclose(_np(res.x), qp.x_sol, atol=1e-3)
    assert (m._chunk_runner is pallas_chunk_runner) == (backend == "auto")
    assert m.Dp == (128 if backend == "auto" else m.D)


@pytest.mark.parametrize("nx", [10, 30, 60])
def test_rand_qp_fp64_matches_jax(nx):
    inst = rand_qp(nx, nx // 4, nx // 4, seed=nx, compute_sol=False)
    j, t = _pair(inst[:5], eps_abs=1e-6, precision="float64")
    jr, tr = j.solve(), t.solve()
    assert tr.info.status == "solved"
    _agree_fp64(jr, tr, j, t)
    assert abs(jr.info.obj_val - tr.info.obj_val) < 1e-8


@pytest.mark.parametrize("nx", [10, 30, 60])
def test_rand_qp_fp32_matches_jax(nx):
    inst = rand_qp(nx, nx // 4, nx // 4, seed=nx, compute_sol=False)
    j, t = _pair(inst[:5], eps_abs=1e-3, precision="float32")
    jr, tr = j.solve(), t.solve()
    assert tr.x.dtype == torch.float32
    assert jr.info.status == tr.info.status == "solved"
    assert abs(jr.info.iter - tr.info.iter) <= 25
    np.testing.assert_allclose(_np(jr.x), _np(tr.x), rtol=0, atol=1e-3)


INFEASIBLE = (np.eye(2), np.zeros(2), np.array([[1.0, 0.0], [1.0, 0.0]]),
              np.array([1.0, -np.inf]), np.array([np.inf, -1.0]))

FEATURES = {
    "alpha": dict(alpha=1.6),
    "scaling": dict(scaling=True),
    "rho_jump": dict(rho_jump=True),
    "rho_interval": dict(adaptive_rho_interval=50),
    "infeasible": dict(check_infeasibility=True),
    "bf16_refine": dict(iter_precision="bf16", refine=True),
    "tail_window": dict(max_iter=110, eps_abs=1e-12),
}


@pytest.mark.parametrize("name", list(FEATURES))
def test_features_fp64_match_jax(name):
    data = INFEASIBLE if name == "infeasible" else \
        rand_qp(30, 7, 7, seed=3, compute_sol=False)[:5]
    kw = dict(eps_abs=1e-6, precision="float64")
    kw.update(FEATURES[name])
    j, t = _pair(data, **kw)
    jr, tr = j.solve(), t.solve()
    expect = {"infeasible": "primal_infeasible",
              "tail_window": "max_iters_reached"}.get(name, "solved")
    assert tr.info.status == expect
    _agree_fp64(jr, tr, j, t)


def test_high_tier_with_refine_matches_jax_kernel():
    """"high" is the bf16 hi/lo split inside the kernel; the JAX package
    runs it only in its Pallas kernel (interpret mode on the CPU)."""
    inst = rand_qp(30, 7, 7, seed=3, compute_sol=False)
    kw = dict(eps_abs=1e-3, precision="float32", iter_precision="high",
              refine=True)
    with pltpu.force_tpu_interpret_mode():
        j, t = _pair(inst[:5], jax_backend="pallas", **kw)
        jr = j.solve()
    tr = t.solve()
    assert jr.info.status == tr.info.status == "solved"
    assert abs(jr.info.iter - tr.info.iter) <= 25
    np.testing.assert_allclose(_np(jr.x), _np(tr.x), rtol=0, atol=1e-3)


def test_lifecycle_sequence_matches_jax():
    """warm_start, update(g, l, u), update_settings, update_matrices and
    clear_primal_dual, each followed by a solve, in both packages."""
    inst = rand_qp(20, 5, 5, seed=8, compute_sol=False)
    upd = rand_qp(20, 5, 5, seed=9, compute_sol=False)
    j, t = _pair(inst[:5], eps_abs=1e-6, precision="float64")
    steps = [
        lambda m: None,
        lambda m: m.warm_start(x=np.ones(20), rho=1.0),
        lambda m: m.update(g=upd.g, l=inst.l - 0.1, u=inst.u + 0.1),
        lambda m: m.update_settings(eps_abs=1e-7, max_iter=3000),
        lambda m: m.update_matrices(H=upd.H),
        lambda m: m.clear_primal_dual(),
    ]
    for k, step in enumerate(steps):
        step(j)
        step(t)
        jr, tr = j.solve(), t.solve()
        assert tr.info.status == "solved", k
        _agree_fp64(jr, tr, j, t)
    with pytest.raises(ValueError):
        t.update_settings(rho=1.0)
    with pytest.raises(ValueError):
        t.update(g=np.ones(3))


def test_same_bank_and_state_through_convert():
    """The JAX bank and a mid-solve JAX state loaded into the port: the
    iteration alone is compared, with the bank build taken out."""
    inst = rand_qp(24, 6, 6, seed=10, compute_sol=False)
    j = J.ReLU_QP()
    j.setup(*inst[:5], eps_abs=1e-6, precision="float64", backend="xla",
            bank_backend="numpy", max_iter=100)
    j.solve()                       # leaves a warm, unconverged state
    t = T.ReLU_QP()
    t.setup(*inst[:5], eps_abs=1e-6, precision="float64", backend="xla",
            device="cpu", max_iter=100)
    t.bank = bank_from_arrays(*(np.asarray(a) for a in j.bank),
                              dtype=torch.float64)
    t.load_state(np.asarray(j.y), j.rho_ind)
    j.update_settings(max_iter=4000)
    t.update_settings(max_iter=4000)
    jr, tr = j.solve(), t.solve()
    assert tr.info.status == "solved"
    _agree_fp64(jr, tr, j, t)
    with pytest.raises(ValueError):
        t.load_state(np.zeros(5), 0)
    with pytest.raises(ValueError):
        bank_from_arrays(np.zeros((2, 4, 4)), np.zeros((2, 4, 1)),
                         np.zeros((3, 4)), np.zeros(2))


@pytest.mark.parametrize("kw,err", [
    (dict(backend="fused"), "K3"),
    (dict(bank_backend="native"), "native"),
    (dict(mesh=object()), "mesh"),
])
def test_unported_paths_raise(kw, err):
    qp = canonical_qp()
    with pytest.raises(NotImplementedError, match=err):
        T.ReLU_QP().setup(qp.H, qp.g, qp.A, qp.l, qp.u, device="cpu", **kw)

