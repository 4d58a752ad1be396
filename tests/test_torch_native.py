"""The port's native C++ runtime (``reluqp_tpu_torch.native``) against the
JAX package's (``reluqp_tpu.native``).

The port compiles its own copy of the C++ source with the JAX package's
``native/Makefile`` flags; on one machine the two libraries run the same
code, so the banks and the native solves must be BIT-equal. Then the
builder's wiring: ``ReLU_QP.setup(bank_backend=...)`` and the
heterogeneous host build, each against the JAX package with the same
builder, in fp64 (equal status, iterations, rung; x within 1e-9).
"""
import numpy as np
import pytest

import reluqp_tpu as J
import reluqp_tpu.native as jn
from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.utils.problems import canonical_qp, rand_qp

import reluqp_tpu_torch as T
import reluqp_tpu_torch.native as tn
from reluqp_tpu_torch.core.bank import build_bank_np, equality_mask
from reluqp_tpu_torch.core.ladder import setup_rhos


@pytest.fixture(scope="module")
def both_built():
    if not (tn.available() and jn.available()):
        pytest.skip("no C++ compiler with OpenMP: the native libraries do "
                    "not build")


def _np(a):
    return a.detach().cpu().double().numpy() if hasattr(a, "detach") \
        else np.asarray(a, np.float64)


@pytest.mark.parametrize("cap", [np.inf, 50.0])
def test_native_bank_is_bit_equal_to_jax_native(both_built, cap):
    q = rand_qp(20, 5, 5, seed=3, compute_sol=False)
    eq = equality_mask(q.l, q.u, 1e-6)
    rhos = setup_rhos(0.1, 1e-6, 1e6, True, 5)
    ours = tn.build_bank(q.H, q.A, q.g, eq, rhos, 1e-6, rho_cap=cap)
    ref = jn.build_bank(q.H, q.A, q.g, eq, rhos, 1e-6, rho_cap=cap)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    if np.isfinite(cap):
        # and the numpy builder's capped bank to fp64 rounding (uncapped,
        # the top rungs' KKT matrices are too ill-conditioned for that)
        W, B, _ = build_bank_np(q.H, q.g, q.A, eq, rhos, 1e-6, rho_cap=cap)
        np.testing.assert_allclose(ours[0], W, rtol=0, atol=1e-10)
        np.testing.assert_allclose(ours[1], B, rtol=0, atol=1e-10)


def test_native_solve_canonical_is_bit_equal_to_jax(both_built):
    qp = canonical_qp()
    eq = equality_mask(qp.l, qp.u, 1e-6)
    rhos = setup_rhos(0.1, 1e-6, 1e6, True, 5)
    W, _, b = tn.build_bank(qp.H, qp.A, qp.g, eq, rhos, 1e-6)
    y, info = tn.solve(qp.H, qp.A, qp.g, qp.l, qp.u, W, b, rhos,
                       eps_abs=1e-6)
    yj, infoj = jn.solve(qp.H, qp.A, qp.g, qp.l, qp.u, W, b, rhos,
                         eps_abs=1e-6)
    np.testing.assert_array_equal(y, yj)
    assert (info.iters, info.status, info.rho_ind) == \
        (infoj.iters, infoj.status, infoj.rho_ind)
    assert info.status == 1
    np.testing.assert_allclose(y[:3], qp.x_sol, atol=1e-4)
    with pytest.raises(ValueError):
        tn.solve(qp.H, qp.A, qp.g, qp.l, qp.u, W[:, :2], b, rhos)


@pytest.mark.parametrize("backend", ["auto", "xla"])
def test_solver_native_backend_matches_jax_native(both_built, backend):
    data = rand_qp(30, 8, 8, seed=5, compute_sol=False)[:5]
    kw = dict(eps_abs=1e-7, precision="float64", scaling=True)
    j = J.ReLU_QP()
    j.setup(*data, backend="xla", bank_backend="native", **kw)
    for how in ("native", "auto"):
        t = T.ReLU_QP()
        t.setup(*data, device="cpu", backend=backend, bank_backend=how,
                **kw)
        assert t.setup_breakdown["bank_backend"] == "native"
        d = t.D
        np.testing.assert_array_equal(_np(t.bank.W)[:, :d, :d],
                                      _np(j.bank.W)[:, :d, :d])
        jr, tr = j.solve(), t.solve()
        assert (jr.info.status, jr.info.iter) == (tr.info.status,
                                                  tr.info.iter)
        assert j.rho_ind == t.rho_ind
        np.testing.assert_allclose(_np(jr.x), _np(tr.x), rtol=0, atol=1e-9)
        j.clear_primal_dual()


def test_bank_backend_choice_and_refusals(both_built):
    qp = canonical_qp()
    data = (qp.H, qp.g, qp.A, qp.l, qp.u)
    t = T.ReLU_QP()
    t.setup(*data, device="cpu", alpha=1.6)   # auto: numpy under alpha
    assert t.setup_breakdown["bank_backend"] == "numpy"
    assert t.solve().info.status == "solved"
    t.setup(*data, device="cpu", bank_backend="numpy")
    assert t.setup_breakdown["bank_backend"] == "numpy"
    with pytest.raises(ValueError, match="alpha"):
        T.ReLU_QP().setup(*data, device="cpu", bank_backend="native",
                          alpha=1.6)
    with pytest.raises(ValueError, match="bank_backend"):
        T.ReLU_QP().setup(*data, device="cpu", bank_backend="cuda")


def test_hetero_host_build_takes_native_as_jax(both_built):
    """With both native builders on, the hetero host build of each package
    takes it (alpha = 1): equal banks bit for bit, equal solves."""
    insts = [rand_qp(nx=12, n_eq=3, n_ineq=3, seed=s, compute_sol=False)
             for s in range(6)]
    data = tuple(np.stack([getattr(i, k) for i in insts])
                 for k in ("H", "g", "A", "l", "u"))
    kw = dict(eps_abs=1e-6, precision="float64")
    j = JB()
    j.setup(*data, backend="xla", **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, backend="xla", device="cpu", **kw)
    np.testing.assert_array_equal(_np(t.Wt_bank), np.asarray(j.Wt_bank))
    W1 = tn.build_bank(t._H_np[0], t._A_np[0], np.zeros(12),
                       equality_mask(t._l_np[0], t._u_np[0], 1e-6),
                       t.rhos_np, 1e-6, rho_cap=t.rho_cap[0])[0]
    np.testing.assert_array_equal(_np(t.Wt_bank)[0],
                                  np.swapaxes(W1, 1, 2))
    jr, tr = j.solve(), t.solve()
    np.testing.assert_array_equal(jr.info.iter, tr.info.iter)
    np.testing.assert_array_equal(np.asarray(j.rho_ind), _np(t.rho_ind))
    np.testing.assert_allclose(np.asarray(jr.x), _np(tr.x), rtol=0,
                               atol=1e-9)


def test_build_without_openmp_gives_the_same_bits(monkeypatch, tmp_path,
                                                 both_built):
    """A compiler without OpenMP builds the serial library, which gives the
    OpenMP build's bits (its parallel loop runs over independent rungs)."""
    q = rand_qp(20, 5, 5, seed=3, compute_sol=False)
    eq = equality_mask(q.l, q.u, 1e-6)
    rhos = setup_rhos(0.1, 1e-6, 1e6, True, 5)
    ref = tn.build_bank(q.H, q.A, q.g, eq, rhos, 1e-6, rho_cap=50.0)
    assert tn.uses_openmp()
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tn, "_STATE", {})
    # a g++ that refuses -fopenmp, as one without libgomp.spec does
    fake = tmp_path / "gxx"
    fake.write_text("#!/bin/sh\nfor a in \"$@\"; do [ \"$a\" = -fopenmp ] "
                    "&& { echo 'no libgomp.spec' >&2; exit 1; }; done\n"
                    "exec g++ \"$@\"\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    ours = tn.build_bank(q.H, q.A, q.g, eq, rhos, 1e-6, rho_cap=50.0)
    assert not tn.uses_openmp()
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_unavailable_compiler_raises_and_auto_falls_back(monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(tn, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tn, "_STATE", {})
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert not tn.available()
    with pytest.raises(tn.NativeUnavailable):
        tn.build_bank(np.eye(2), np.eye(2), np.zeros(2), np.zeros(2, bool),
                      np.ones(1), 1e-6)
    qp = canonical_qp()
    t = T.ReLU_QP()
    t.setup(qp.H, qp.g, qp.A, qp.l, qp.u, device="cpu")
    assert t.setup_breakdown["bank_backend"] == "numpy"
