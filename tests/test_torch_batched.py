"""The batched solver of the PyTorch port against the JAX package.

``BatchedReLU_QP`` (shared H, A) on the same batches in both packages.
With ``backend="xla"`` in fp64 the two run the same arithmetic up to the
order of fp64 sums: per-problem iterations, status and the final rung are
EQUAL and x agrees to 1e-9. The port's ``"auto"`` backend (the padded
layout through the plain version of kernel K4 on the CPU) is held against
JAX ``backend="pallas"`` under interpret mode in fp32, where the two round
their sums (and the bias: fp64 on the host here, a double-fp32
contraction there) differently: status equal, iterations within one check
window, x within 1e-3. K4's plain version is held against the JAX kernel
``fused_chunk_batched`` in interpret mode; the CUDA kernel itself against
its plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.ops.fused_step import fused_chunk_batched as j_chunk_batched
from reluqp_tpu.utils.problems import rand_qp, update_qp

import reluqp_tpu_torch as T
from reluqp_tpu_torch.convert import batched_from_arrays
from reluqp_tpu_torch.ops.fused_step import (fused_chunk_batched,
                                             fused_chunk_batched_ref,
                                             pallas_batched_chunk_runner)

ATOL64 = 1e-9


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


# --------------------------------------------------------------------- #
# K4's plain version against the JAX kernel                             #
# --------------------------------------------------------------------- #

N_RHO, STEPS = 3, 10
# as for K1 (tests/test_torch_fused_step.py): "highest" differs by fp32
# summation order, "high" is fp32-grade, and JAX interprets "default" as a
# plain fp32 dot on the CPU where the port rounds to bf16.
K4_TOL = {"highest": 1e-6, "high": 1e-4, "default": 1e-2, "bf16": 1e-2}


@pytest.mark.parametrize("tier", ["highest", "high", "default", "bf16"])
@pytest.mark.parametrize("dp", [128, 256])
@pytest.mark.parametrize("rows", [8, 24])
def test_plain_k4_matches_jax_kernel(rows, dp, tier):
    rng = np.random.default_rng(rows + dp)
    wt = rng.standard_normal((N_RHO, dp, dp)) * (0.7 / np.sqrt(dp))
    b = 0.1 * rng.standard_normal((rows, dp))
    lo = np.full((rows, dp), -0.8)
    hi = np.full((rows, dp), 0.8)
    y = 0.5 * rng.standard_normal((rows, dp))
    arrs = (wt, b, lo, hi, y)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(j_chunk_batched(
            *(jnp.asarray(a, jnp.float32) for a in arrs), 1, STEPS,
            rows_tile=8, iter_precision=tier))
    out = fused_chunk_batched_ref(
        *(torch.as_tensor(a, dtype=torch.float32) for a in arrs),
        torch.tensor(1, dtype=torch.int32), STEPS, tier)
    assert out.shape == (rows, dp) and out.dtype == torch.float32
    assert float(np.max(np.abs(out.numpy() - ref))) <= K4_TOL[tier]


def test_k4_cpu_wrapper_and_runner_run_the_plain_version():
    """On CPU tensors the wrapper runs the plain version (no launch is
    counted); the runner reads the rung's bias row; inert rows stay 0."""
    rng = np.random.default_rng(0)
    dp, rows = 128, 8
    wt = torch.as_tensor(rng.standard_normal((N_RHO, dp, dp)) * 0.05)
    bias = torch.as_tensor(rng.standard_normal((N_RHO, rows, dp)) * 0.1)
    bias[:, -2:] = 0.0
    lo = torch.full((rows, dp), -float("inf"), dtype=torch.float64)
    hi = -lo
    y = torch.as_tensor(rng.standard_normal((rows, dp)))
    y[-2:] = 0.0
    rho = torch.tensor(2, dtype=torch.int32)
    before = fused_chunk_batched.launches
    out = pallas_batched_chunk_runner(wt, bias, rho, lo, hi, y, 7)
    assert fused_chunk_batched.launches == before
    ref = fused_chunk_batched_ref(wt, bias[2], lo, hi, y, rho, 7)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert not out[-2:].any()
    with pytest.raises(ValueError):
        fused_chunk_batched_ref(wt, bias[2, 0], lo[0], hi[0], y[0], rho, 7)


# --------------------------------------------------------------------- #
# BatchedReLU_QP                                                        #
# --------------------------------------------------------------------- #

def _batch(B=5, nx=12, n_eq=3, n_ineq=3, seed0=0):
    """A batch sharing (H, A) with per-problem g, l, u (JAX's test batch)."""
    base = rand_qp(nx=nx, n_eq=n_eq, n_ineq=n_ineq, seed=seed0,
                   compute_sol=False)
    G, L, U = [], [], []
    for i in range(B):
        inst = update_qp(base.H, base.A, n_eq, n_ineq, seed=seed0 + i,
                         compute_sol=False)
        G.append(inst.g)
        L.append(inst.l)
        U.append(inst.u)
    return base.H, np.stack(G), base.A, np.stack(L), np.stack(U)


def _pair(data, rho_mode="shared", **kw):
    kw = dict(dict(eps_abs=1e-6, precision="float64"), **kw)
    j = JB()
    j.setup(*data, rho_mode=rho_mode, backend="xla", **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, rho_mode=rho_mode, backend="xla", device="cpu", **kw)
    return j, t


def _agree(j, t, jr, tr, tol=ATOL64):
    np.testing.assert_array_equal(jr.info.iter, tr.info.iter)
    np.testing.assert_array_equal(jr.info.status_code, tr.info.status_code)
    assert jr.info.n_iter_total == tr.info.n_iter_total
    np.testing.assert_array_equal(np.asarray(j.rho_ind), _np(t.rho_ind))
    for a, b in ((jr.x, tr.x), (jr.z, tr.z), (jr.lam, tr.lam)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


@pytest.mark.parametrize("name,rho_mode,kw", [
    ("default", "shared", {}),
    ("per_problem", "per_problem", {}),
    ("per_problem_large", "per_problem", dict(B=40)),
    ("ruiz", "shared", dict(scaling=True)),
    ("alpha", "shared", dict(alpha=1.6)),
    ("alpha_per_problem", "per_problem", dict(alpha=1.6)),
    ("rho_jump", "shared", dict(rho_jump=True)),
    ("stride", "shared", dict(adaptive_rho_interval=60)),
    ("certificates", "shared", dict(check_infeasibility=True)),
    ("tail", "shared", dict(max_iter=60, eps_abs=1e-12)),
])
def test_batched_xla_fp64_matches_jax(name, rho_mode, kw):
    kw = dict(kw)
    data = _batch(B=kw.pop("B", 5))
    j, t = _pair(data, rho_mode, **kw)
    jr, tr = j.solve(), t.solve()
    _agree(j, t, jr, tr)
    assert t.B_pad == t.B_n and t.Dp == t.D   # the unpadded layout
    if name == "tail":
        assert tr.info.n_iter_total == 60 and not tr.info.status.any()
    else:
        assert tr.info.status.all()
    np.testing.assert_allclose(j.objective(), t.objective(), rtol=0,
                               atol=1e-8)


def test_batched_auto_matches_jax_pallas_fp32():
    data = _batch(B=5)
    kw = dict(eps_abs=1e-4, precision="float32")
    j = JB()
    j.setup(*data, backend="pallas", **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", **kw)
    assert t._use_pallas and t.Dp == 128 and t.B_pad == 8 == j.B_pad
    with pltpu.force_tpu_interpret_mode():
        jr = j.solve()
    tr = t.solve()
    assert tr.info.status.all() and jr.info.status.all()
    ci = t.settings.check_interval
    assert np.abs(jr.info.iter - tr.info.iter).max() <= ci
    np.testing.assert_allclose(_np(jr.x), _np(tr.x), rtol=0, atol=1e-3)
    # the padded rows stay exactly 0
    assert not t.Y[t.B_n:].any() and not t.Y[:, t.D:].any()


def test_batched_auto_matches_xla_fp64():
    """The padded layout (K4's plain version, inert rows that start done)
    solves what the unpadded one solves."""
    data = _batch(B=5)
    kw = dict(eps_abs=1e-6, precision="float64", device="cpu")
    a = T.BatchedReLU_QP()
    a.setup(*data, **kw)
    x = T.BatchedReLU_QP()
    x.setup(*data, backend="xla", **kw)
    ra, rx = a.solve(), x.solve()
    np.testing.assert_array_equal(ra.info.iter, rx.info.iter)
    assert ra.info.status.all() and int(a.rho_ind) == int(x.rho_ind)
    np.testing.assert_allclose(_np(ra.x), _np(rx.x), rtol=0, atol=ATOL64)


def test_bias_precision_fixed_point_shared():
    """The counterpart of JAX's ``test_bias_precision_fixed_point_shared``:
    rand_qp(nx=50, seed=500) stalls above eps when the bias is a plain fp32
    product. The port forms every bias in fp64 on the host, at setup and
    at update(g), so the stored fp32 bias is the fp64 product to within
    one rounding and the marginal batch solves."""
    base = rand_qp(nx=50, n_eq=12, n_ineq=12, seed=500, compute_sol=False)
    G = np.stack([base.g, base.g * 1.01])
    L = np.stack([base.l, base.l])
    U = np.stack([base.u, base.u])
    m = T.BatchedReLU_QP()
    m.setup(base.H, G, base.A, L, U, eps_abs=1e-4, device="cpu")
    assert m.settings.precision_dtype == torch.float32
    res = m.solve()
    assert res.info.status.all(), (res.info.status, res.info.dua_res)

    def bias_err():
        # against the fp64 product of the fp64 g master (the stored fp32 G
        # is itself rounded)
        sc = m.scal
        g_s = np.zeros((m.B_pad, m.nx))
        g_s[:m.B_n] = sc.c * (m._g_np * sc.D[None, :])
        want = np.einsum("ndx,bx->nbd", m._B_np, g_s)
        tol = 3e-7 * np.max(np.abs(want))    # ~2 fp32 ulp
        return np.max(np.abs(_np(m.bias_all) - want)), tol

    err, tol = bias_err()
    assert err < tol, (err, tol)
    m.update(g=G)
    err, tol = bias_err()
    assert err < tol, (err, tol)
    assert m.solve().info.status.all()


def test_update_matches_jax():
    data = _batch(B=4)
    j, t = _pair(data)
    j.solve()
    t.solve()
    H, G, A, L, U = data
    for kw in (dict(g=G * 1.05), dict(l=L - 0.1, u=U - 0.1)):
        j.update(**kw)
        t.update(**kw)
        _agree(j, t, j.solve(), t.solve())
    with pytest.raises(ValueError, match="equality-row pattern"):
        U2 = U.copy()
        eq = np.where(np.abs(U[0] - L[0]) < 1e-6)[0][0]
        U2[0, eq] += 7.0
        t.update(u=U2)


@pytest.mark.parametrize("scaling", [False, True])
def test_update_matrices_matches_jax(scaling):
    data = _batch(B=4)
    j, t = _pair(data, scaling=scaling)
    j.solve()
    t.solve()
    H2 = data[0] + 0.5 * np.eye(data[0].shape[0])
    j.update_matrices(H=H2)
    t.update_matrices(H=H2)
    np.testing.assert_array_equal(np.asarray(j.rho_ind), _np(t.rho_ind))
    np.testing.assert_allclose(np.asarray(j.Y), _np(t.Y), rtol=0,
                               atol=ATOL64)
    _agree(j, t, j.solve(), t.solve())


@pytest.mark.parametrize("alpha", [1.0, 1.6])
def test_warm_start_and_clear_match_jax(alpha):
    data = _batch(B=4)
    j, t = _pair(data, alpha=alpha)
    jr, tr = j.solve(), t.solve()
    x, z, lam = _np(tr.x) * 0.9, _np(tr.z), _np(tr.lam) * 1.1
    j.warm_start(x=x, z=z, lam=lam)
    t.warm_start(x=x, z=z, lam=lam)
    np.testing.assert_allclose(np.asarray(j.Y), _np(t.Y), rtol=0,
                               atol=ATOL64)
    _agree(j, t, j.solve(), t.solve())
    j.clear_primal_dual()
    t.clear_primal_dual()
    assert not t.Y.any() and int(t.rho_ind) == int(j.rho_ind)
    _agree(j, t, j.solve(), t.solve())


def test_update_settings_and_eps_floor_warning():
    data = _batch(B=3)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", eps_abs=1e-4)
    t.update_settings(max_iter=50, check_interval=10)
    assert t.solve().info.n_iter_total <= 50
    for key in ("rho", "sigma", "alpha"):
        with pytest.raises(ValueError, match="Cannot change"):
            t.update_settings(**{key: 0.5})
    with pytest.raises(ValueError, match="Invalid setting"):
        t.update_settings(bogus=1)
    with pytest.warns(RuntimeWarning, match="certifiable"):
        t.update_settings(eps_abs=1e-30)


def test_load_state_from_jax_arrays():
    """Both packages from one bank and state (``convert.batched_from_arrays``
    and ``load_state``): after a JAX solve, the port continues from JAX's
    bank, states and rung exactly as JAX does."""
    data = _batch(B=5)
    j, t = _pair(data, max_iter=100)
    j.solve()
    conv = batched_from_arrays(np.asarray(j.Wt_bank), np.asarray(j.B_bank),
                               j.rhos_np, np.asarray(j.Y),
                               np.asarray(j.rho_ind), dtype=torch.float64)
    np.testing.assert_allclose(conv.B_np, t._B_np, rtol=0, atol=1e-15)
    t.Wt_bank = conv.Wt_bank
    t.load_state(conv.Y, conv.rho_ind)
    j.update_settings(max_iter=4000)
    t.update_settings(max_iter=4000)
    _agree(j, t, j.solve(), t.solve())
    with pytest.raises(ValueError):
        t.load_state(np.zeros((5, 3)), 0)
    with pytest.raises(ValueError):
        t.load_state(conv.Y, 99)
    with pytest.raises(ValueError):
        batched_from_arrays(np.zeros((2, 4, 4)), np.zeros((3, 4, 1)),
                            np.zeros(2), np.zeros((1, 4)), 0)


@pytest.mark.parametrize("kw,err", [
    # the JAX package's refusals of the multi-device setups, raised before
    # the mesh is read (so a stand-in object serves); the mesh'd solves
    # themselves run in tests/test_torch_sharded.py
    (dict(process_local=True), "requires a mesh"),
    (dict(hetero=True, process_local=True), "requires a mesh"),
    (dict(mesh=object(), tail_policy="repack"), "per-chip"),
    (dict(mesh=object(), process_local=True, tail_policy="repack"),
     "per-chip"),
    (dict(hetero=True, mesh=object(), tail_policy="repack"),
     "shared-\\(H,A\\) batches only"),
])
def test_unported_paths_raise(kw, err):
    H, G, A, L, U = _batch(B=3)
    if kw.pop("hetero", False):
        H = np.stack([H] * 3)
    with pytest.raises(ValueError, match=err):
        T.BatchedReLU_QP().setup(H, G, A, L, U, device="cpu", **kw)
    # the JAX package refuses the same setups with the same error
    with pytest.raises(ValueError, match=err):
        JB().setup(H, G, A, L, U, **kw)


def test_setup_checks():
    H, G, A, L, U = _batch(B=3)
    U2 = U.copy()
    eq = np.where(np.abs(U[0] - L[0]) < 1e-6)[0][0]
    U2[1, eq] += 5.0
    with pytest.raises(ValueError, match="equality-row pattern"):
        T.BatchedReLU_QP().setup(H, G, A, L, U2, device="cpu")
    with pytest.raises(ValueError, match="rho_mode"):
        T.BatchedReLU_QP().setup(H, G, A, L, U, device="cpu",
                                 rho_mode="per_problem", backend="pallas")
    with pytest.raises(ValueError, match="whole-solve"):
        T.BatchedReLU_QP().setup(H, G, A, L, U, device="cpu",
                                 backend="fused")
    if not torch.cuda.is_available():
        # no GPU and no device: raise, never fall back to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.BatchedReLU_QP().setup(H, G, A, L, U)
