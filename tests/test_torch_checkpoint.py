"""Checkpoints of the PyTorch port (``reluqp_tpu_torch.utils.checkpoint``)
against the JAX package's (``reluqp_tpu.utils.checkpoint``).

The two packages write the same ``.npz`` keys. Each case sets a solver up,
solves it (so the file carries a warm state), saves it, loads the file into
the port (from a port file and from a JAX file) and into JAX (from a port
file), then solves the original and the loaded solver on: a port file
loaded into the port solves BIT-equal to the original (same bank, bias,
state, arithmetic); across packages, in fp64, equal status, iterations
and rung, x within 1e-9 (the sums run in other orders). The JAX file's CPU
layout (D and B unpadded) is re-padded to the port's on load.
"""
import json

import numpy as np
import pytest
import torch

import reluqp_tpu as J
import reluqp_tpu.native
from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.utils import checkpoint as jc
from reluqp_tpu.utils.problems import rand_qp, update_qp

import reluqp_tpu_torch as T
import reluqp_tpu_torch.native
from reluqp_tpu_torch.utils import checkpoint as tc

KW = dict(eps_abs=1e-7, precision="float64")


@pytest.fixture(autouse=True)
def _numpy_builders(monkeypatch):
    """Both packages' host builds on their numpy builders (the C++ one is
    held to the JAX package's in tests/test_torch_native.py)."""
    monkeypatch.setattr(reluqp_tpu.native, "available", lambda: False)
    monkeypatch.setattr(reluqp_tpu_torch.native, "available", lambda: False)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _qp(seed=3):
    return rand_qp(24, 6, 6, seed=seed, compute_sol=False)[:5]


def _same_solve(a, b, tol=0.0):
    ra, rb = a.solve(), b.solve()
    assert (ra.info.status, ra.info.iter) == (rb.info.status, rb.info.iter)
    assert a.rho_ind == b.rho_ind
    for u, v in ((ra.x, rb.x), (ra.z, rb.z), (ra.lam, rb.lam)):
        np.testing.assert_allclose(_np(u), _np(v), rtol=0, atol=tol)
    return ra


@pytest.mark.parametrize("backend,kw", [
    ("auto", {}), ("xla", {}), ("auto", dict(alpha=1.6)),
    ("fused", dict(precision="float32", eps_abs=1e-3)),
    ("auto", dict(scaling=True)),
    ("auto", dict(precision="float32", iter_precision="bf16", eps_abs=1e-3)),
])
def test_solver_round_trip_is_bit_equal(tmp_path, backend, kw):
    kw = dict(KW, **kw)
    data = _qp()
    t = T.ReLU_QP()
    t.setup(*data, device="cpu", backend=backend, max_iter=50, **kw)
    t.solve()                       # a warm, unconverged state
    t.update_settings(max_iter=4000)
    p = str(tmp_path / "qp.npz")
    tc.save_solver(t, p)
    if kw.get("iter_precision") == "bf16":
        # a bf16 bank is saved as its fp32 refine copy
        with np.load(p) as z:
            assert z["bank_W"].dtype == np.float32
            np.testing.assert_array_equal(z["bank_W"], _np(t._W_hi))
    t2 = tc.load_solver(p, device="cpu")
    assert (t2.Dp, t2.rho_ind, t2._fused) == (t.Dp, t.rho_ind, t._fused)
    np.testing.assert_array_equal(_np(t2.bank.W), _np(t.bank.W))
    np.testing.assert_array_equal(_np(t2.y), _np(t.y))
    r = _same_solve(t, t2)
    assert r.info.status == "solved"
    # the lifecycle goes on on the loaded solver
    g2 = data[1] * 1.01
    t.update(g=g2)
    t2.update(g=g2)
    _same_solve(t, t2)


@pytest.mark.parametrize("kw", [{}, dict(alpha=1.6), dict(scaling=True)])
def test_solver_files_cross_between_packages(tmp_path, kw):
    kw = dict(KW, **kw)
    data = _qp(seed=4)
    j = J.ReLU_QP()   # "auto": on the CPU, the XLA runner, unpadded
    j.setup(*data, bank_backend="numpy", max_iter=50, **kw)
    j.solve()
    j.update_settings(max_iter=4000)
    jc.save_solver(j, str(tmp_path / "j.npz"))
    t = tc.load_solver(str(tmp_path / "j.npz"), device="cpu")
    assert t.Dp == 128 and j.Dp == j.D       # re-padded on load
    _same_solve(j, t, tol=1e-9)
    t = T.ReLU_QP()
    t.setup(*data, device="cpu", max_iter=50, **kw)
    t.solve()
    t.update_settings(max_iter=4000)
    tc.save_solver(t, str(tmp_path / "t.npz"))
    j = jc.load_solver(str(tmp_path / "t.npz"))
    _same_solve(j, t, tol=1e-9)


def _shared(B=12, seed0=0):
    base = rand_qp(16, 4, 4, seed=seed0, compute_sol=False)
    insts = [update_qp(base.H, base.A, 4, 4, seed=seed0 + i,
                       compute_sol=False) for i in range(B)]
    return (base.H, np.stack([i.g for i in insts]), base.A,
            np.stack([i.l for i in insts]), np.stack([i.u for i in insts]))


def _hetero(B=6):
    insts = [rand_qp(12, 3, 3, seed=s, compute_sol=False) for s in range(B)]
    return tuple(np.stack([getattr(i, k) for i in insts])
                 for k in ("H", "g", "A", "l", "u"))


def _same_batch(a, b, tol=0.0):
    ra, rb = a.solve(), b.solve()
    np.testing.assert_array_equal(ra.info.iter, rb.info.iter)
    np.testing.assert_array_equal(ra.info.status_code, rb.info.status_code)
    np.testing.assert_array_equal(_np(a.rho_ind).reshape(-1)[:a.B_n]
                                  if _np(a.rho_ind).ndim else _np(a.rho_ind),
                                  _np(b.rho_ind).reshape(-1)[:a.B_n]
                                  if _np(b.rho_ind).ndim else _np(b.rho_ind))
    for u, v in ((ra.x, rb.x), (ra.z, rb.z), (ra.lam, rb.lam)):
        np.testing.assert_allclose(_np(u), _np(v), rtol=0, atol=tol)


CASES = [
    ("shared", {}), ("shared", dict(rho_mode="per_problem")),
    ("shared", dict(alpha=1.6, scaling=True)),
    ("hetero", {}), ("hetero", dict(alpha=1.6, scaling=True)),
    ("hetero", dict(bank_build="device")),
]


@pytest.mark.parametrize("regime,kw", CASES)
def test_batched_round_trip_and_cross(tmp_path, regime, kw):
    data = _shared() if regime == "shared" else _hetero()
    kw = dict(KW, **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", max_iter=50, **kw)
    t.solve()
    t.update_settings(max_iter=4000)
    p = str(tmp_path / "t.npz")
    tc.save_batched_solver(t, p)
    t2 = tc.load_batched_solver(p, device="cpu")
    assert t2._bank_build == t._bank_build
    assert (t2._B_dev is None) == (t._B_dev is None)
    _same_batch(t, t2)
    g2 = data[1] * 1.02
    t.update(g=g2)
    t2.update(g=g2)
    _same_batch(t, t2)
    # port file → JAX, JAX file → port
    t.update(g=data[1])
    tc.save_batched_solver(t, p)
    _same_batch(jc.load_batched_solver(p), t, tol=1e-9)
    j = JB()          # "auto": on the CPU, the XLA loop, unpadded
    j.setup(*data, max_iter=50, **kw)
    j.solve()
    j.update_settings(max_iter=4000)
    jc.save_batched_solver(j, str(tmp_path / "j.npz"))
    t3 = tc.load_batched_solver(str(tmp_path / "j.npz"), device="cpu")
    # re-padded on load to the layout a port setup takes
    assert j.Dp == j.D and t3.Dp == t.Dp
    assert t3.B_pad == t.B_pad
    _same_batch(j, t3, tol=1e-9)


def test_jax_fp32_file_rebuilds_the_fp64_master(tmp_path):
    """A JAX fp32 hetero file stores B in fp32 with its cast residual
    B_lo; the port's fp64 master is their sum, within fp64 rounding of the
    fp64 build, and update(g) then solves as JAX's."""
    data = _hetero()
    kw = dict(eps_abs=1e-4, precision="float32")
    j = JB()
    j.setup(*data, backend="xla", **kw)
    jc.save_batched_solver(j, str(tmp_path / "j.npz"))
    t = tc.load_batched_solver(str(tmp_path / "j.npz"), device="cpu")
    ref = T.BatchedReLU_QP()
    ref.setup(*data, device="cpu", backend="xla", **kw)
    np.testing.assert_allclose(t._B_np, ref._B_np, rtol=1e-14, atol=1e-15)
    g2 = data[1] * 1.05
    j.update(g=g2)
    t.update(g=g2)
    jr, tr = j.solve(), t.solve()
    np.testing.assert_array_equal(jr.info.status_code, tr.info.status_code)
    assert np.abs(jr.info.iter.astype(int) - tr.info.iter).max() <= 25


def test_file_without_masters_loads_and_solves(tmp_path):
    data = _hetero()
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", **KW)
    p = str(tmp_path / "t.npz")
    tc.save_batched_solver(t, p)
    with np.load(p, allow_pickle=False) as z:
        old = {k: z[k] for k in z.files
               if k not in ("H_np", "A_np", "g_np", "rho_mode_req",
                            "bank_build")}
    np.savez(str(tmp_path / "old.npz"), **old)
    for load in (lambda q: tc.load_batched_solver(q, device="cpu"),
                 jc.load_batched_solver):
        m = load(str(tmp_path / "old.npz"))
        assert m._H_np is None
        assert m.solve().info.status.all()
        with pytest.raises(ValueError, match="master"):
            m.update_matrices(A=data[2])


def test_checkpoint_refusals(tmp_path):
    with pytest.raises(RuntimeError, match="set up"):
        tc.save_solver(T.ReLU_QP(), str(tmp_path / "x.npz"))
    with pytest.raises(RuntimeError, match="set up"):
        tc.save_batched_solver(T.BatchedReLU_QP(), str(tmp_path / "x.npz"))
    t = T.ReLU_QP()
    t.setup(*_qp(), device="cpu", **KW)
    tc.save_solver(t, str(tmp_path / "q"))       # np.savez adds .npz
    m = T.BatchedReLU_QP()
    m.setup(*_shared(), device="cpu", **KW)
    tc.save_batched_solver(m, str(tmp_path / "b.npz"))
    # as the JAX package: no file and no shard set under the name
    with pytest.raises(FileNotFoundError, match="shard files"):
        tc.load_batched_solver(str(tmp_path / "missing"), device="cpu")
    if not torch.cuda.is_available():
        # the loads default to cuda, and raise without one
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.load_solver(str(tmp_path / "q"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.load_batched_solver(str(tmp_path / "b.npz"))
    assert tc.load_solver(str(tmp_path / "q"), device="cpu").solve()\
        .info.status == "solved"
    stng = json.loads(str(np.load(str(tmp_path / "b.npz"))["settings"]))
    assert stng["precision"] == "float64" and "device" not in stng
