"""The heterogeneous batched solver of the PyTorch port against the JAX package.

``BatchedReLU_QP`` with per-problem H and/or A (one bank per problem, every
problem walking its own ladder index) on the same batches in both packages.
Both packages' hetero host builds take their C++ bank builders where the
library loads; these tests hold both to their numpy builders
(``tests/test_torch_native.py`` holds the C++ ones to each other), so that
both packages factorize with the same arithmetic. ``bank_build="device"``
is held against JAX's device build (fp64, within the banks' rounding). Then, in fp64, the
port on both of its layouts (``"xla"`` unpadded through ``_chunk_hetero``,
``"auto"`` lane-padded through K5's plain version on the CPU) runs what JAX's
XLA hetero path runs: per-problem iterations, status and final rung EQUAL,
x, z, λ within 1e-9 (the sums run in other orders, so not always bit-equal).
K5's plain version is held against JAX's ``fused_chunk_hetero`` in interpret
mode; the CUDA kernel itself against its plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import reluqp_tpu.native
import reluqp_tpu_torch.native
from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.batch import _hetero_eps_floor as j_eps_floor
from reluqp_tpu.core import bank as jbank
from reluqp_tpu.models.mpc import gen_sparse_mpc_qp as j_gen_sparse
from reluqp_tpu.ops.fused_step import fused_chunk_hetero as j_chunk_hetero
from reluqp_tpu.ops.fused_step import \
    pallas_hetero_chunk_runner as j_hetero_runner
from reluqp_tpu.utils.problems import rand_qp, update_qp
from reluqp_tpu.utils.scaling import ruiz_equilibrate_batch as j_ruiz_batch

import reluqp_tpu_torch as T
from reluqp_tpu_torch.batch import _hetero_eps_floor
from reluqp_tpu_torch.convert import batched_from_arrays
from reluqp_tpu_torch.core import bank as tbank
from reluqp_tpu_torch.models.mpc import gen_sparse_mpc_qp
from reluqp_tpu_torch.ops.fused_step import (fused_chunk_hetero,
                                             fused_chunk_hetero_ref,
                                             pallas_hetero_chunk_runner)
from reluqp_tpu_torch.utils.scaling import (ruiz_equilibrate,
                                            ruiz_equilibrate_batch)

ATOL64 = 1e-9


@pytest.fixture(autouse=True)
def _jax_numpy_builder(monkeypatch):
    """Both packages' hetero host builds on their numpy bank builders."""
    monkeypatch.setattr(reluqp_tpu.native, "available", lambda: False)
    monkeypatch.setattr(reluqp_tpu_torch.native, "available", lambda: False)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _hetero(B=8, nx=12, n_eq=3, n_ineq=3, seed0=0):
    """B distinct rand_qp instances, stacked (H, g, A, l, u)."""
    insts = [rand_qp(nx=nx, n_eq=n_eq, n_ineq=n_ineq, seed=seed0 + s,
                     compute_sol=False) for s in range(B)]
    return tuple(np.stack([getattr(i, k) for i in insts])
                 for k in ("H", "g", "A", "l", "u"))


def _shared(B=4, nx=12, n_eq=3, n_ineq=3, seed0=0):
    """A batch sharing (H, A) with per-problem g, l, u."""
    base = rand_qp(nx=nx, n_eq=n_eq, n_ineq=n_ineq, seed=seed0,
                   compute_sol=False)
    insts = [update_qp(base.H, base.A, n_eq, n_ineq, seed=seed0 + i,
                       compute_sol=False) for i in range(B)]
    return (base.H, np.stack([i.g for i in insts]), base.A,
            np.stack([i.l for i in insts]), np.stack([i.u for i in insts]))


def _pair(data, backend="xla", **kw):
    kw = dict(dict(eps_abs=1e-6, precision="float64"), **kw)
    j = JB()
    j.setup(*data, backend="xla", **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, backend=backend, device="cpu", **kw)
    return j, t


def _agree(j, t, jr, tr, tol=ATOL64):
    np.testing.assert_array_equal(jr.info.iter, tr.info.iter)
    np.testing.assert_array_equal(jr.info.status_code, tr.info.status_code)
    assert jr.info.n_iter_total == tr.info.n_iter_total
    np.testing.assert_array_equal(np.asarray(j.rho_ind), _np(t.rho_ind))
    for a, b in ((jr.x, tr.x), (jr.z, tr.z), (jr.lam, tr.lam)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


# --------------------------------------------------------------------- #
# host helpers                                                          #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("with_g", [True, False])
def test_ruiz_equilibrate_batch_matches_jax(with_g):
    H, g, A, _, _ = _hetero(B=5)
    if not with_g:
        g = np.zeros_like(g)
    ours, ref = ruiz_equilibrate_batch(H, A, g), j_ruiz_batch(H, A, g)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    # per problem, the scalar routine
    for i in range(H.shape[0]):
        one = ruiz_equilibrate(H[i], A[i], g[i])
        np.testing.assert_allclose(ours.D[i], one.D, rtol=1e-12)
        np.testing.assert_allclose(ours.E[i], one.E, rtol=1e-12)
        np.testing.assert_allclose(ours.c[i], one.c, rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bank_batch_helpers_match_jax(dtype):
    _, _, A, l, u = _hetero(B=6)
    A = A.copy()
    A[2] = 0.0                         # a degenerate spectrum: an inf cap
    np.testing.assert_allclose(tbank.sigma_max_sq_batch(A),
                               jbank.sigma_max_sq_batch(A), rtol=1e-12)
    caps = tbank.auto_rho_cap_batch(A, 1e-4, getattr(torch, dtype), 12)
    caps_j = jbank.auto_rho_cap_batch(A, 1e-4, np.dtype(dtype), 12)
    np.testing.assert_allclose(caps, caps_j, rtol=1e-12)
    assert np.isinf(caps[2]) and (np.isfinite(caps).sum() == 5) == \
        (dtype == "float32")
    eq = tbank.equality_mask(l, u, 1e-6)
    np.testing.assert_allclose(
        tbank.effective_rho_ladder_batch(np.geomspace(1e-3, 1e3, 7), eq,
                                         caps),
        jbank.effective_rho_ladder_batch(np.geomspace(1e-3, 1e3, 7), eq,
                                         caps_j), rtol=1e-12)
    with np.errstate(invalid="ignore"):   # JAX's forms inf * 0 at A[2]
        floor_j = j_eps_floor(caps_j, A, np.dtype(dtype), 12)
    assert _hetero_eps_floor(caps, A, getattr(torch, dtype), 12) == \
        pytest.approx(floor_j, rel=1e-12)


@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_stacked_bank_build_equals_per_problem_builds(alpha, monkeypatch):
    """``build_banks_np_batch`` (what the hetero setup runs, in chunks,
    here of 3 problems against one chunk of all 7) gives every problem the
    bank its own ``build_bank_np`` gives, bit for bit."""
    import reluqp_tpu_torch.batch as tbatch
    data = _hetero(B=7)
    H, G, A, L, U = data
    eq = tbank.equality_mask(L, U, 1e-6)
    caps = tbank.auto_rho_cap_batch(A, 1e-4, torch.float32, 12)
    rhos = np.geomspace(1e-3, 1e3, 5)
    W, Bm = tbank.build_banks_np_batch(H, A, eq, rhos, 1e-6, alpha, caps)
    for i in range(7):
        Wi, Bi, _ = tbank.build_bank_np(H[i], np.zeros(12), A[i], eq[i],
                                        rhos, 1e-6, alpha=alpha,
                                        rho_cap=caps[i])
        assert np.array_equal(W[i], Wi) and np.array_equal(Bm[i], Bi)
    one = T.BatchedReLU_QP()
    one.setup(*data, backend="xla", device="cpu", precision="float64",
              alpha=alpha)
    monkeypatch.setattr(tbatch, "_BUILD_CHUNK", 3)
    t = T.BatchedReLU_QP()
    t.setup(*data, backend="xla", device="cpu", precision="float64",
            alpha=alpha)
    assert torch.equal(t.Wt_bank, one.Wt_bank)
    assert np.array_equal(t._B_np, one._B_np)


# --------------------------------------------------------------------- #
# bank_build="device"                                                   #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_device_bank_build_matches_jax_device_build(alpha):
    """``build_bank_torch`` (one pass over every (problem, rung) pair)
    against JAX's ``build_bank_jnp`` per problem, in fp64, with finite
    caps and equality rows: W and B within 1e-10."""
    H, G, A, L, U = _hetero(B=5)
    eq = tbank.equality_mask(L, U, 1e-6)
    assert eq.any()
    caps = tbank.auto_rho_cap_batch(A, 1e-4, torch.float32, 12)
    assert np.isfinite(caps).all()
    rhos = np.geomspace(1e-3, 1e3, 7)
    W, Bm = tbank.build_bank_torch(H, A, eq, rhos, 1e-6, alpha=alpha,
                                   rho_caps=caps, device="cpu")
    assert W.dtype == Bm.dtype == torch.float64
    for i in range(5):
        ref = jbank.build_bank_jnp(jnp.asarray(H[i]), jnp.zeros(12),
                                   jnp.asarray(A[i]), jnp.asarray(eq[i]),
                                   rhos, 1e-6, alpha=alpha,
                                   rho_cap=float(caps[i]))
        np.testing.assert_allclose(_np(W[i]), np.asarray(ref.W), rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(_np(Bm[i]), np.asarray(ref.B), rtol=0,
                                   atol=1e-10)
    # and the host builder's banks (which the default setup uses)
    Wn, Bn = tbank.build_banks_np_batch(H, A, eq, rhos, 1e-6, alpha, caps)
    np.testing.assert_allclose(_np(W), Wn, rtol=0, atol=1e-10)
    np.testing.assert_allclose(_np(Bm), Bn, rtol=0, atol=1e-10)


@pytest.mark.parametrize("backend", ["xla", "auto"])
@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_device_build_batch_matches_jax_device_build(backend, alpha):
    """A ``bank_build="device"`` batch against JAX's, fp64: equal status,
    iterations and final rungs, cold, after ``update(g)`` (the bias formed
    on the device from the fp64 B master) and after ``update_matrices``
    (rebuilt on the device); x, z, λ within 1e-7 (the port factorizes by
    Cholesky, JAX by LU: the banks differ by fp64 rounding times the KKT
    matrices' condition)."""
    data = _hetero(B=6)
    kw = dict(eps_abs=1e-6, precision="float64", alpha=alpha,
              bank_build="device")
    j = JB()
    j.setup(*data, backend="xla", **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, backend=backend, device="cpu", **kw)
    assert t._B_np is None and t._B_dev.dtype == torch.float64
    assert t._B_dev.shape == (6, len(t.rhos_np), t.Dp, 12)
    assert not _np(t.Wt_bank)[:, :, t.D:].any()       # padding exactly 0
    _agree(j, t, j.solve(), t.solve(), tol=1e-7)
    g2 = data[1] * 1.1
    j.update(g=g2)
    t.update(g=g2)
    _agree(j, t, j.solve(), t.solve(), tol=1e-7)
    A2 = data[2] * 1.05
    j.update_matrices(A=A2)
    t.update_matrices(A=A2)
    assert t._bank_build == "device" and t._B_dev is not None
    _agree(j, t, j.solve(), t.solve(), tol=1e-7)


def test_device_build_counts_its_b_master(monkeypatch):
    """The fp64 B master a device build keeps is counted against the bank
    cap: a cap between the two footprints takes the host build and
    refuses the device build."""
    data = _hetero(B=4)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu")
    N, Dp = len(t.rhos_np), t.Dp
    host = 4 * N * (Dp * Dp * 4 + Dp * 4)
    monkeypatch.setenv("RELUQP_MAX_BANK_BYTES", str(host + 1))
    T.BatchedReLU_QP().setup(*data, device="cpu")
    with pytest.raises(ValueError, match="RELUQP_MAX_BANK_BYTES"):
        T.BatchedReLU_QP().setup(*data, device="cpu", bank_build="device")


# --------------------------------------------------------------------- #
# K5's plain version against the JAX kernel                             #
# --------------------------------------------------------------------- #

N_RHO, STEPS, DP = 3, 10, 128
# as for K1 and K4: "highest" differs by fp32 summation order, "high" is
# fp32-grade, and JAX interprets "default" as a plain fp32 dot on the CPU
# where the port rounds to bf16
K5_TOL = {"highest": 1e-6, "high": 1e-4, "default": 1e-2, "bf16": 1e-2}


def _k5_arrays(B, seed):
    rng = np.random.default_rng(seed)
    bank = rng.standard_normal((B, N_RHO, DP, DP)) * (0.7 / np.sqrt(DP))
    bias = 0.1 * rng.standard_normal((B, N_RHO, DP))
    rho = rng.integers(0, N_RHO, B).astype(np.int32)
    lo = np.full((B, DP), -0.8)
    hi = np.full((B, DP), 0.8)
    y = 0.5 * rng.standard_normal((B, DP))
    return bank, bias, rho, lo, hi, y


@pytest.mark.parametrize("tier", ["highest", "high", "default", "bf16"])
def test_plain_k5_matches_jax_kernel(tier):
    """The port's bank-plus-rung-vector call against JAX's kernel on the
    gathered rungs, B=16, Dp=128, 10 steps, fp32."""
    B = 16
    bank, bias, rho, lo, hi, y = _k5_arrays(B, seed=3)
    rows = np.arange(B)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_chunk_hetero(
            f32(bank[rows, rho]), f32(bias[rows, rho]), f32(lo), f32(hi),
            f32(y), STEPS, 8, tier))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    out = fused_chunk_hetero_ref(t(bank), t(bias[rows, rho]), t(lo), t(hi),
                                 t(y), torch.as_tensor(rho), STEPS, tier)
    assert out.shape == (B, DP) and out.dtype == torch.float32
    assert float(np.max(np.abs(out.numpy() - ref))) <= K5_TOL[tier]


def test_hetero_runner_matches_jax_runner():
    """The runners, random per-problem rungs, fp32 "highest"."""
    B = 8
    bank, bias, rho, lo, hi, y = _k5_arrays(B, seed=4)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_hetero_runner(
            f32(bank), f32(bias), jnp.asarray(rho), f32(lo), f32(hi), f32(y),
            STEPS, "highest"))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    out = pallas_hetero_chunk_runner(t(bank), t(bias), torch.as_tensor(rho),
                                     t(lo), t(hi), t(y), STEPS, "highest")
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_k5_cpu_wrapper_runs_the_plain_version():
    """On CPU tensors the wrapper runs the plain version (no launch is
    counted), row i against its own rung; inert lanes stay 0; an index
    off the ladder is clamped, as the kernel clamps it."""
    bank, bias, rho, lo, hi, y = _k5_arrays(4, seed=5)
    bank[..., 100:, :] = bank[..., :, 100:] = 0.0
    lo[:, 100:], hi[:, 100:], y[:, 100:] = -np.inf, np.inf, 0.0
    bias[..., 100:] = 0.0
    t = torch.as_tensor
    rho_t = t(rho)
    b = t(bias)[torch.arange(4), rho_t.long()]
    before = fused_chunk_hetero.launches
    out = fused_chunk_hetero(t(bank), b, t(lo), t(hi), t(y), rho_t, 7)
    assert fused_chunk_hetero.launches == before
    for i in range(4):
        one = fused_chunk_hetero_ref(t(bank[i:i + 1]), b[i:i + 1],
                                     t(lo[i:i + 1]), t(hi[i:i + 1]),
                                     t(y[i:i + 1]), rho_t[i:i + 1], 7)
        torch.testing.assert_close(out[i:i + 1], one, rtol=0, atol=1e-15)
    assert not out[:, 100:].any()
    high = fused_chunk_hetero_ref(t(bank), b, t(lo), t(hi), t(y),
                                  torch.full((4,), 99, dtype=torch.int32), 3)
    top = fused_chunk_hetero_ref(t(bank), b, t(lo), t(hi), t(y),
                                 torch.full((4,), N_RHO - 1,
                                            dtype=torch.int32), 3)
    torch.testing.assert_close(high, top, rtol=0, atol=0)
    with pytest.raises(ValueError):
        fused_chunk_hetero_ref(t(bank[0]), b, t(lo), t(hi), t(y), rho_t, 3)


# --------------------------------------------------------------------- #
# BatchedReLU_QP, heterogeneous regime                                  #
# --------------------------------------------------------------------- #

def _infeasible_batch():
    """The test batch with problem 3 made primal infeasible: its last
    inequality row asks A₃x ≤ d₃ − 1 beside A₃x ≥ d₃."""
    H, G, A, L, U = (a.copy() for a in _hetero(B=6))
    A[3, 5] = -A[3, 3]
    L[3, 5] = -L[3, 3] + 1.0
    U[3, 5] = np.inf
    return H, G, A, L, U


@pytest.mark.parametrize("backend", ["xla", "auto"])
@pytest.mark.parametrize("name,kw", [
    ("default", {}),
    ("ruiz", dict(scaling=True)),
    ("alpha", dict(alpha=1.6)),
    ("certificates", dict(check_infeasibility=True)),
    ("bf16_refine", dict(iter_precision="bf16", refine=True)),
])
def test_hetero_fp64_matches_jax(name, kw, backend):
    data = _infeasible_batch() if name == "certificates" else _hetero()
    j, t = _pair(data, backend, **kw)
    assert t.hetero and t.rho_mode == "per_problem"
    if backend == "xla":
        assert t.Dp == t.D and not t._hetero_pallas
    else:
        assert t.Dp == 128 and t._hetero_pallas and t.B_pad == t.B_n
    jr, tr = j.solve(), t.solve()
    _agree(j, t, jr, tr)
    if name == "certificates":
        np.testing.assert_array_equal(tr.info.status_code, [1, 1, 1, 2, 1, 1])
    else:
        assert tr.info.status.all()
    np.testing.assert_allclose(j.objective(), t.objective(), rtol=0,
                               atol=1e-8)
    if backend == "auto":
        assert not t.Y[:, t.D:].any()   # padded lanes stay exactly 0


def test_hetero_auto_matches_jax_pallas_fp32(monkeypatch):
    """The port's padded layout (K5's plain version) against JAX's hetero
    Pallas kernel in interpret mode, fp32: status equal, iterations within
    one check window, x within 1e-3 (the two sum in other orders)."""
    import reluqp_tpu.solver as jsolver
    monkeypatch.setattr(jsolver, "_is_tpu", lambda d: True)
    data = _hetero()
    kw = dict(eps_abs=1e-4)
    j = JB()
    j.setup(*data, **kw)
    assert j._hetero_pallas and j.Dp == 128
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", **kw)
    with pltpu.force_tpu_interpret_mode():
        jr = j.solve()
    tr = t.solve()
    assert jr.info.status.all() and tr.info.status.all()
    ci = t.settings.check_interval
    assert np.abs(jr.info.iter - tr.info.iter).max() <= ci
    np.testing.assert_allclose(_np(jr.x), _np(tr.x), rtol=0, atol=1e-3)


def test_hetero_update_matches_jax():
    data = _hetero(B=5)
    j, t = _pair(data, "auto")
    j.solve()
    t.solve()
    H, G, A, L, U = data
    for kw in (dict(g=G * 1.05), dict(l=L - 0.1, u=U - 0.1), dict(g=G)):
        j.update(**kw)
        t.update(**kw)
        _agree(j, t, j.solve(), t.solve())
    # a bound update may not change any problem's equality-row pattern
    U2 = U.copy()
    U2[2, 0] += 7.0                    # row 0 is an equality row
    with pytest.raises(ValueError, match="equality-row pattern"):
        t.update(u=U2)
    with pytest.raises(ValueError, match="equality-row pattern"):
        j.update(u=U2)


@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_hetero_warm_start_objective_and_clear_match_jax(alpha):
    data = _hetero(B=5)
    j, t = _pair(data, "auto", alpha=alpha, scaling=True)
    jr, tr = j.solve(), t.solve()
    x, z, lam = _np(tr.x) * 0.9, _np(tr.z), _np(tr.lam) * 1.1
    j.warm_start(x=x, z=z, lam=lam)
    t.warm_start(x=x, z=z, lam=lam)
    np.testing.assert_allclose(np.asarray(j.Y), _np(t.Y)[:, :t.D], rtol=0,
                               atol=ATOL64)
    np.testing.assert_allclose(j.objective(), t.objective(), rtol=0,
                               atol=1e-8)
    _agree(j, t, j.solve(), t.solve())
    j.clear_primal_dual()
    t.clear_primal_dual()
    assert not t.Y.any()
    np.testing.assert_array_equal(np.asarray(j.rho_ind), _np(t.rho_ind))
    _agree(j, t, j.solve(), t.solve())


@pytest.mark.parametrize("scaling", [False, True])
def test_hetero_update_matrices_matches_jax(scaling):
    H, G, A, L, U = _shared(B=4)
    Hs = np.stack([H + 0.05 * (i + 1) * np.eye(H.shape[0]) for i in range(4)])
    j, t = _pair((Hs, G, A, L, U), scaling=scaling)
    j.solve()
    t.solve()
    j.update_matrices(H=Hs + 0.3 * np.eye(H.shape[0]))
    t.update_matrices(H=Hs + 0.3 * np.eye(H.shape[0]))
    np.testing.assert_array_equal(np.asarray(j.rho_ind), _np(t.rho_ind))
    np.testing.assert_allclose(np.asarray(j.Y), _np(t.Y), rtol=0,
                               atol=ATOL64)
    _agree(j, t, j.solve(), t.solve())


@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_switch_shared_to_hetero_matches_jax(alpha):
    """A batched H promotes a shared batch to the heterogeneous regime:
    every problem resumes at the old shared ladder index, the warm state
    carries in unscaled units, and the next solve is JAX's."""
    H, G, A, L, U = _shared(B=4)
    j, t = _pair((H, G, A, L, U), alpha=alpha)
    j.solve()
    t.solve()
    assert not t.hetero
    shared_ind = int(t.rho_ind)
    Hs = np.stack([H + 0.1 * (i + 1) * np.eye(H.shape[0]) for i in range(4)])
    j.update_matrices(H=Hs)
    t.update_matrices(H=Hs)
    assert t.hetero and t.rho_mode == "per_problem"
    np.testing.assert_array_equal(_np(t.rho_ind), np.full(4, shared_ind))
    np.testing.assert_allclose(np.asarray(j.Y), _np(t.Y), rtol=0,
                               atol=ATOL64)
    _agree(j, t, j.solve(), t.solve())


def test_masters_stay_pre_promotion_and_match_jax():
    """A shared matrix in a heterogeneous setup is not repeated B times in
    the fp64 masters, and a later update of it rebuilds what JAX
    rebuilds."""
    H, G, A, L, U = _shared(B=4)
    As = np.stack([A * (1 + 0.01 * i) for i in range(4)])
    j, t = _pair((H, G, As, L, U), "auto")
    assert t.hetero and t._H_np.ndim == 2 and t._A_np.ndim == 3
    j.solve()
    t.solve()
    H2 = H + 0.2 * np.eye(H.shape[0])
    j.update_matrices(H=H2)
    t.update_matrices(H=H2)
    assert t._H_np.ndim == 2
    _agree(j, t, j.solve(), t.solve())


def test_load_state_from_jax_hetero_arrays():
    """Both packages from one per-problem bank and state
    (``convert.batched_from_arrays`` with a (B, N, Dp, Dp) bank and a (B,)
    rung vector): after a JAX solve, the port continues as JAX does."""
    data = _hetero(B=5)
    j, t = _pair(data, max_iter=100, eps_abs=1e-9)
    j.solve()
    conv = batched_from_arrays(np.asarray(j.Wt_bank), np.asarray(j.B_bank),
                               j.rhos_np, np.asarray(j.Y),
                               np.asarray(j.rho_ind), dtype=torch.float64)
    assert conv.Wt_bank.shape == (5, len(j.rhos_np), t.D, t.D)
    np.testing.assert_allclose(conv.B_np, t._B_np, rtol=0, atol=1e-15)
    t.Wt_bank = conv.Wt_bank
    t.load_state(conv.Y, conv.rho_ind)
    np.testing.assert_array_equal(_np(t.rho_ind), np.asarray(j.rho_ind))
    j.update_settings(max_iter=4000, eps_abs=1e-6)
    t.update_settings(max_iter=4000, eps_abs=1e-6)
    _agree(j, t, j.solve(), t.solve())
    with pytest.raises(ValueError):
        batched_from_arrays(np.zeros((2, 3, 4, 4)), np.zeros((3, 3, 4, 1)),
                            np.zeros(3), np.zeros((2, 4)), np.zeros(2))


def test_hetero_setup_checks_and_bank_cap(monkeypatch):
    H, G, A, L, U = _hetero(B=3)
    with pytest.raises(ValueError, match="H must be"):
        T.BatchedReLU_QP().setup(H[:2], G, A, L, U, device="cpu")
    with pytest.raises(ValueError, match="whole-solve"):
        T.BatchedReLU_QP().setup(H, G, A, L, U, device="cpu",
                                 backend="fused")
    # hetero always walks per problem, so "pallas" with the default
    # rho_mode is K5's layout, not an error
    m = T.BatchedReLU_QP()
    m.setup(H, G, A, L, U, device="cpu", backend="pallas")
    assert m._hetero_pallas and m.rho_mode == "per_problem"
    # "native" is no bank_build value (the JAX package would read it as
    # "device"), and repack refuses per-problem banks, as JAX does
    for kw, err in ((dict(bank_build="native"), "bank_build"),
                    (dict(tail_policy="repack"), "shared-\\(H,A\\)")):
        with pytest.raises(ValueError, match=err):
            T.BatchedReLU_QP().setup(H, G, A, L, U, device="cpu", **kw)
    with pytest.raises(ValueError, match="shared-\\(H,A\\)"):
        JB().setup(H, G, A, L, U, tail_policy="repack")
    monkeypatch.setenv("RELUQP_MAX_BANK_BYTES", "1e5")
    with pytest.raises(ValueError, match="RELUQP_MAX_BANK_BYTES"):
        T.BatchedReLU_QP().setup(H, G, A, L, U, device="cpu")
    monkeypatch.delenv("RELUQP_MAX_BANK_BYTES")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.BatchedReLU_QP().setup(H, G, A, L, U)


def test_hetero_update_settings_eps_floor_matches_jax():
    """The update_settings guard warns past the largest per-problem floor
    of the frozen fp32 caps, at JAX's floor."""
    data = _hetero(B=3)
    j = JB()
    j.setup(*data, eps_abs=1e-4)
    t = T.BatchedReLU_QP()
    t.setup(*data, eps_abs=1e-4, device="cpu")
    assert t._eps_floor == pytest.approx(j._eps_floor, rel=1e-12)
    assert t._eps_floor > 0.0
    with pytest.warns(RuntimeWarning, match="certifiable"):
        t.update_settings(eps_abs=t._eps_floor * 0.5)
    t.update_settings(max_iter=50, check_interval=10)
    assert t.solve().info.n_iter_total <= 50


# --------------------------------------------------------------------- #
# examples/ltv_mpc.py's LTV ensemble                                    #
# --------------------------------------------------------------------- #

_DT, _HZ = 0.1, 8
_AD = np.array([[1.0, _DT], [0.0, 1.0]])
_BD0 = np.array([[0.5 * _DT * _DT], [_DT]])


def _ltv_loop(cls, gen, B, n_steps, relin_every, **kw):
    """examples/ltv_mpc.py's loop for a solver class and an MPC QP
    generator: per-step states and per-step iterations."""
    def plant_qp(mass):
        sel_u = np.zeros((_HZ, _HZ * 3))
        sel_u[np.arange(_HZ), 3 * np.arange(_HZ)] = 1.0
        box = np.full(_HZ, 2.0)
        return gen(_AD, _BD0 / mass, np.diag([10.0, 1.0]), np.array([[0.1]]),
                   np.diag([50.0, 5.0]), _HZ, A_add=sel_u, l_add=-box,
                   u_add=box)

    rng = np.random.RandomState(0)
    masses = 1.0 + 0.5 * rng.rand(B)
    decay = 0.97 + 0.02 * rng.rand(B)
    X = np.column_stack([2.0 + rng.randn(B), np.zeros(B)])
    qps = [plant_qp(m_i) for m_i in masses]
    H = qps[0][0]
    As = np.stack([q[2] for q in qps])
    L, U = np.stack([q[3] for q in qps]), np.stack([q[4] for q in qps])
    L[:, :2] = U[:, :2] = -(X @ _AD.T)
    m = cls()
    m.setup(H, np.zeros((B, H.shape[0])), As, L, U, eps_abs=1e-4, **kw)
    xs, its = [X], []
    for k in range(n_steps):
        mass_k = masses * decay ** k
        if k and k % relin_every == 0:
            m.update_matrices(A=np.stack([plant_qp(m_i)[2]
                                          for m_i in mass_k]))
        L[:, :2] = U[:, :2] = -(X @ _AD.T)
        m.update(l=L, u=U)
        res = m.solve()
        assert res.info.status.all()
        u0 = _np(res.x)[:, :1]
        X = X @ _AD.T + (u0 / mass_k[:, None]) @ _BD0.T
        xs.append(X)
        its.append(np.asarray(res.info.iter))
    return np.stack(xs), np.stack(its)


# B=16 is the LTV ensemble's batch in examples/ltv_mpc.py (and on the card),
# the batch K5's plan spreads over clusters of blocks
@pytest.mark.parametrize("backend,B,n_steps", [
    pytest.param("xla", 4, 12, id="xla"),
    pytest.param("auto", 4, 12, id="auto"),
    pytest.param("xla", 16, 8, id="xla-B16"),
    pytest.param("auto", 16, 8, id="auto-B16")])
def test_ltv_ensemble_matches_jax(backend, B, n_steps):
    """B plants, n_steps steps, every bank re-factorized at step 6, in
    fp64: per-step states within 1e-8 and equal per-step iterations."""
    kw = dict(precision="float64")
    xs_j, it_j = _ltv_loop(JB, j_gen_sparse, B, n_steps, 6, backend="xla",
                           **kw)
    xs_t, it_t = _ltv_loop(T.BatchedReLU_QP, gen_sparse_mpc_qp, B, n_steps,
                           6, backend=backend, device="cpu", **kw)
    np.testing.assert_array_equal(it_j, it_t)
    np.testing.assert_allclose(xs_t, xs_j, rtol=0, atol=1e-8)
