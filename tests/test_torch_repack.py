"""``tail_policy="repack"`` of the PyTorch port against the JAX package.

The port's ``core.batched.solve_batched_shared_repack`` and the JAX
package's run the same schedule of shrinking row buffers on the same fp64
batches (the cases of ``tests/test_repack.py``): per-row iterations and
status EQUAL, the shared ladder index equal, x within 1e-9 of JAX's repack
(the sums run in other orders) — on the port's unpadded layout
(``backend="xla"``) and its lane-padded one (``"auto"``, K4's plain version
on the CPU). Against the port's own dense loop: equal iterations and
status, x within 1e-4 at eps 1e-6 (a converged row left in the dense loop
keeps iterating around its fixed point; repack drops it).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.core.batched import \
    solve_batched_shared_repack as j_repack
from reluqp_tpu.core.ladder import initial_rho_index
from reluqp_tpu.utils.checkpoint import save_batched_solver as j_save
from reluqp_tpu.utils.problems import rand_qp, update_qp

import reluqp_tpu_torch as T
from reluqp_tpu_torch.core.batched import solve_batched_shared_repack
from reluqp_tpu_torch.utils.checkpoint import (load_batched_solver,
                                               save_batched_solver)

KW = dict(eps_abs=1e-6, precision="float64")


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _batch(B=96, nx=16, n_eq=4, n_ineq=4, seed0=0):
    base = rand_qp(nx=nx, n_eq=n_eq, n_ineq=n_ineq, seed=seed0,
                   compute_sol=False)
    insts = [update_qp(base.H, base.A, n_eq, n_ineq, seed=seed0 + i,
                       compute_sol=False) for i in range(B)]
    return (base.H, np.stack([i.g for i in insts]), base.A,
            np.stack([i.l for i in insts]), np.stack([i.u for i in insts]))


def _jax_repack(j, schedule, **over):
    """JAX's repack driver from a cold state on j's setup."""
    kw = j._solve_kw()
    kw.pop("refine")
    r0 = initial_rho_index(j.rhos_np, j.settings.rho)
    rho_ind0 = (jnp.asarray(r0, jnp.int32) if j.rho_mode == "shared"
                else jnp.full((j.B_pad,), r0, jnp.int32))
    Y0 = jnp.zeros((j.B_pad, j.Dp), dtype=j.settings.precision_dtype)
    args = dict(G=j.G, lo=j.lo, hi=j.hi, bias=j.bias_all, done0=None,
                Y0=Y0)
    args.update(over)
    return j_repack(j.Wt_bank, args["bias"], j.rhos, j.H_dev, j.A_dev,
                    args["G"], args["lo"], args["hi"], args["Y0"], rho_ind0,
                    args["done0"], j._rho_eff, j._w_pri, j._w_dua,
                    schedule=schedule, rho_mode=j.rho_mode, **kw)


def _pair(data, schedule, backend="xla", **kw):
    """JAX's dense setup + its repack driver, the port's repack solver
    (schedule forced) and its dense solver, on one batch."""
    kw = dict(KW, **kw)
    j = JB()
    j.setup(*data, backend="xla", **kw)
    jr = _jax_repack(j, schedule)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", backend=backend, tail_policy="repack", **kw)
    t._repack_sched = schedule
    d = T.BatchedReLU_QP()
    d.setup(*data, device="cpu", backend=backend, **kw)
    return j, jr, t, t.solve(), d.solve()


def _agree(j, jr, t, tr, dr, x_tol=1e-9, dense_tol=1e-4):
    B = t.B_n
    np.testing.assert_array_equal(np.asarray(jr.iters)[:B], tr.info.iter)
    np.testing.assert_array_equal(np.asarray(jr.status)[:B],
                                  tr.info.status_code)
    np.testing.assert_array_equal(np.asarray(jr.rho_ind).reshape(-1)[:1],
                                  _np(t.rho_ind).reshape(-1)[:1])
    x_j = np.asarray(jr.Y)[:B, :t.nx] * np.asarray(j._unx)
    np.testing.assert_allclose(x_j, _np(tr.x), rtol=0, atol=x_tol)
    # the port's own dense loop
    np.testing.assert_array_equal(tr.info.iter, dr.info.iter)
    np.testing.assert_array_equal(tr.info.status_code, dr.info.status_code)
    np.testing.assert_allclose(_np(tr.x), _np(dr.x), rtol=0, atol=dense_tol)


@pytest.mark.parametrize("backend", ["xla", "auto"])
@pytest.mark.parametrize("rho_mode", ["shared", "per_problem"])
def test_repack_matches_jax_and_dense(rho_mode, backend):
    if rho_mode == "per_problem" and backend == "auto":
        backend = "xla"   # the per-problem walk runs the plain runners
    j, jr, t, tr, dr = _pair(_batch(), (96, 48, 24), backend,
                             rho_mode=rho_mode)
    assert tr.info.status.all()
    _agree(j, jr, t, tr, dr)
    assert tr.info.n_iter_total == int(jr.n_iter_total)


def test_repack_with_infeasibility_and_alpha():
    j, jr, t, tr, dr = _pair(_batch(), (96, 48), "auto",
                             check_infeasibility=True, alpha=1.6)
    assert tr.info.status.all()
    _agree(j, jr, t, tr, dr)
    # λ decodes at each row's final rung, as the dense loop's
    np.testing.assert_allclose(_np(tr.lam), _np(dr.lam), rtol=0, atol=1e-3)


def test_repack_detects_infeasible_rows():
    """An infeasible row certifies with the dense loop's code and
    iteration, and JAX's repack's. In fp32 at eps 1e-4, as the JAX test: in
    fp64 a rounding-level δλ of either sign on a row with an infinite bound
    makes the support function +inf, and which window certifies then
    depends on the summation order (ROADMAP §C)."""
    H, G, A, L, U = _batch(B=16)
    A2 = A.copy()
    A2[-2] = A2[-1]
    L2, U2 = L.copy(), U.copy()
    L2[:, -2], U2[:, -2] = -np.inf, np.inf
    L2[3, -1], U2[3, -1] = 5.0, np.inf
    L2[3, -2], U2[3, -2] = -np.inf, -5.0
    j, jr, t, tr, dr = _pair((H, G, A2, L2, U2), (16, 8), "auto",
                             check_infeasibility=True, eps_abs=1e-4,
                             precision="float32")
    assert tr.info.status_code[3] == 2   # primal infeasible
    _agree(j, jr, t, tr, dr, x_tol=1e-4)


def test_repack_with_padding_rows():
    """done0 padding rows stay inert through compaction, in both drivers."""
    H, G, A, L, U = _batch(B=80)
    j = JB()
    j.setup(H, G, A, L, U, backend="xla", **KW)
    t = T.BatchedReLU_QP()
    t.setup(H, G, A, L, U, device="cpu", backend="xla", **KW)
    pad = 16
    z = lambda m, w: np.concatenate([_np(m), np.zeros((pad, w))])
    inf = lambda m, v: np.concatenate([_np(m), np.full((pad, t.Dp), v)])
    Gp, lop, hip = z(t.G, t.nx), inf(t.lo, -np.inf), inf(t.hi, np.inf)
    bias = np.concatenate([_np(t.bias_all),
                           np.zeros((t.bias_all.shape[0], pad, t.Dp))], 1)
    done0 = np.arange(96) >= 80
    jr = _jax_repack(j, (96, 48), G=jnp.asarray(Gp), lo=jnp.asarray(lop),
                     hi=jnp.asarray(hip), bias=jnp.asarray(bias),
                     done0=jnp.asarray(done0),
                     Y0=jnp.zeros((96, t.Dp), jnp.float64))
    kw = t._solve_kw()
    kw.pop("refine")
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)
    tr = solve_batched_shared_repack(
        t.Wt_bank, f(bias), t.rhos, t.H_dev, t.A_dev, f(Gp), f(lop),
        f(hip), torch.zeros((96, t.Dp), dtype=torch.float64),
        torch.tensor(int(_np(t.rho_ind)), dtype=torch.int32),
        torch.as_tensor(done0), t._rho_eff, t._w_pri, t._w_dua,
        schedule=(96, 48), rho_mode="shared", **kw)
    assert bool(tr.converged.all())
    assert (_np(tr.iters)[80:] == 0).all()
    np.testing.assert_array_equal(_np(tr.iters), np.asarray(jr.iters))
    np.testing.assert_array_equal(_np(tr.iters)[:80], t.solve().info.iter)


def test_repack_api_end_to_end_and_warm():
    """The lifecycle under repack: a cold solve, then update(g) and a warm
    re-solve, each equal to the dense solver and to JAX's repack API."""
    data = _batch(B=64)
    kw = dict(KW, tail_policy="repack")
    j = JB()
    j.setup(*data, backend="xla", **kw)
    j._repack_sched = (64, 32)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", **kw)
    t._repack_sched = (64, 32)
    d = T.BatchedReLU_QP()
    d.setup(*data, device="cpu", **KW)
    for step in range(2):
        if step:
            for m in (j, t, d):
                m.update(g=data[1] * 1.01)
        jr, tr, dr = j.solve(), t.solve(), d.solve()
        assert tr.info.status.all()
        np.testing.assert_array_equal(tr.info.iter, jr.info.iter)
        np.testing.assert_array_equal(tr.info.iter, dr.info.iter)
        np.testing.assert_allclose(_np(tr.x), np.asarray(jr.x), rtol=0,
                                   atol=1e-9)
        assert int(_np(t.rho_ind)) == int(j.rho_ind)


@pytest.mark.parametrize("B", [64, 1200])
def test_repack_schedule_matches_jax(B):
    """Halving to the 512-row floor in multiples of 8 on the CPU (B=64 is
    below the floor: a one-entry schedule, the dense loop)."""
    data = _batch(B=B, nx=4, n_eq=1, n_ineq=1)
    j = JB()
    j.setup(*data, backend="xla", tail_policy="repack")
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", backend="xla", tail_policy="repack")
    assert t._repack_sched == j._repack_sched
    assert t._repack_sched == ((64,) if B == 64 else (1200, 600, 512))


@pytest.mark.parametrize("b_pad,align", [
    (64, 8), (1200, 8), (10000, 8), (1200, 128), (10000, 128),
    (10000, 80), (10000, 76), (2000, 80), (600, 80)])
def test_repack_schedule_function(b_pad, align):
    """The port's halving as a plain function of (B_pad, align): JAX's
    schedule at JAX's alignments (8 on its XLA path, 128 under Pallas), and
    at a K4 row tile that is no power of two (80, 76) capacities that are
    multiples of it, strictly halving down to the 512-row floor in at most 4
    stages."""
    from types import SimpleNamespace
    from reluqp_tpu_torch.batch import repack_schedule
    sched = repack_schedule(b_pad, align)
    if align in (8, 128):
        stub = SimpleNamespace(B_pad=b_pad, _use_pallas=align == 128)
        assert sched == JB._make_repack_schedule(stub)
    if (b_pad, align) == (1200, 8):
        assert sched == (1200, 600, 512)
    floor = max(512, align)
    assert sched[0] == b_pad and 1 <= len(sched) <= 4
    assert all(c % align == 0 for c in sched[1:])
    assert all(b < a for a, b in zip(sched, sched[1:]))
    for a, b in zip(sched, sched[1:]):
        assert b == -(-max(a // 2, floor) // align) * align
    if b_pad == 10000 and align == 80:
        assert sched == (10000, 5040, 2560, 1280)
    if b_pad <= floor:
        assert sched == (b_pad,)


def test_repack_with_a_tile_aligned_schedule():
    """A schedule aligned to an 80-row tile, forced on a batch below the
    512-row floor, on the lane-padded layout through K4's plain version:
    every row's status, iterations and x as the dense loop and JAX's repack
    driver on the same schedule."""
    sched = (240, 160, 80)
    j, jr, t, tr, dr = _pair(_batch(B=240), sched, "auto")
    assert t.B_pad == 240 and tr.info.status.all()
    _agree(j, jr, t, tr, dr)
    assert tr.info.n_iter_total == int(jr.n_iter_total)


def test_repack_refusals_match_jax():
    H, G, A, L, U = _batch(B=8)
    Hb = np.repeat(H[None], 8, axis=0)
    cases = [
        (dict(tail_policy="bogus"), "tail_policy"),
        (dict(tail_policy="repack", iter_precision="default", refine=True),
         "refine"),
        (dict(tail_policy="repack", max_iter=110), "multiple"),
        (dict(tail_policy="repack", H=Hb), "shared"),
        (dict(tail_policy="repack", mesh=object()), "per-chip"),
    ]
    for kw, err in cases:
        args = [kw.pop("H", H), G, A, L, U]
        with pytest.raises(ValueError, match=err):
            T.BatchedReLU_QP().setup(*args, device="cpu", **kw)
        if "mesh" not in kw:
            with pytest.raises(ValueError, match=err):
                JB().setup(*args, **kw)
    m = T.BatchedReLU_QP()
    m.setup(H, G, A, L, U, device="cpu", tail_policy="repack",
            iter_precision="default", refine=False)
    assert m.tail_policy == "repack"
    with pytest.raises(ValueError, match="decreasing"):
        solve_batched_shared_repack(
            m.Wt_bank, m.bias_all, m.rhos, m.H_dev, m.A_dev, m.G, m.lo,
            m.hi, m.Y, m.rho_ind, schedule=(8, 8), **dict(
                (k, v) for k, v in m._solve_kw().items() if k != "refine"))


def test_repack_survives_checkpoint(tmp_path):
    """tail_policy and its schedule carry through a save/load, from either
    package's file; a file without tail_policy loads dense, and a repack
    file restored into a two-phase refine runs dense (watch item F-w6, as
    the JAX package does)."""
    data = _batch(B=64)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", tail_policy="repack", **KW)
    j = JB()
    j.setup(*data, backend="xla", tail_policy="repack", **KW)
    for i, save in enumerate((lambda p: save_batched_solver(t, p),
                              lambda p: j_save(j, p))):
        p = str(tmp_path / f"repack{i}.npz")
        save(p)
        m2 = load_batched_solver(p, device="cpu")
        assert m2.tail_policy == "repack"
        assert m2._repack_sched == t._repack_sched
        assert m2.solve().info.status.all()
    with np.load(p, allow_pickle=False) as z:
        legacy = {k: z[k] for k in z.files if k != "tail_policy"}
        stng = json.loads(str(z["settings"]))
    np.savez(str(tmp_path / "legacy.npz"), **legacy)
    m3 = load_batched_solver(str(tmp_path / "legacy.npz"), device="cpu")
    assert m3.tail_policy == "dense" and m3._repack_sched is None
    assert m3.solve().info.status.all()
    stng.update(iter_precision="default", refine=True)
    legacy.update(settings=json.dumps(stng), tail_policy="repack")
    np.savez(str(tmp_path / "two_phase.npz"), **legacy)
    m4 = load_batched_solver(str(tmp_path / "two_phase.npz"), device="cpu")
    assert m4.tail_policy == "dense"


@pytest.mark.parametrize("eps,max_iter,schedule", [
    (1e-9, 50, (32, 16)),      # nothing certifies: one stage runs it out
    (3e-4, 75, (32, 24)),      # 12 certify by k=50: a stage exit, then out
])
def test_repack_budget_exhaustion(eps, max_iter, schedule):
    """Rows that never converge report max_iter like the dense loop and
    JAX's repack (watch item F-w5): max_iter a multiple of the window."""
    j, jr, t, tr, dr = _pair(_batch(B=32), schedule, "auto", eps_abs=eps,
                             max_iter=max_iter)
    assert 0 <= tr.info.status.sum() < 32
    assert tr.info.n_iter_total == max_iter
    # the post-convergence drift of a row the dense loop keeps is O(eps)
    _agree(j, jr, t, tr, dr, dense_tol=max(1e-4, 10 * eps))
