"""The port's tensor-parallel single-QP solve (``ReLU_QP.setup(mesh=)``,
``parallel/tensor.py``) over ``torch.distributed`` (gloo, one process per
rank) against the JAX package's ``solve_loop_tp`` on its CPU mesh.

Worker processes (``tests/_torch_dist_worker.py``) run the port on 2 and on
4 ranks; this process runs JAX's tensor-parallel solve on a mesh of as
many of its virtual CPU devices, and the port's single-device ``"xla"``
solve. ``rand_qp(20, 5, 5)`` in fp64 (the bf16 bank in fp32):

- cold, and warm after ``update(g)`` + ``warm_start``, and with
  ``alpha`` = 1.6: equal iterations and final rung to JAX's TP solve and
  to the port's single-device solve (lockstep, as the JAX package's
  tests hold its TP solve), x within 1e-9 (JAX) and 1e-10 (the port);
- the bf16 bank with the two-phase refine: solved, equal iterations to
  the port's single-device solve, x within 1e-5 of it;
- each rank's bank block is (N_rho, Dp, Dp/W), and a solve gathers once
  per iteration, Dp/W numbers from each rank, never a bank block;
- ``tp_pad_dim`` equals JAX's over a grid of (d, n, align).
"""
import numpy as np
import pytest

from reluqp_tpu import ReLU_QP as JR
from reluqp_tpu.parallel import make_mesh as j_make_mesh
from reluqp_tpu.parallel import tp_pad_dim as j_tp_pad_dim

import _torch_dist_worker as W
import reluqp_tpu_torch as T
from reluqp_tpu_torch.parallel import tp_pad_dim

X_TOL_JAX = 1e-9     # fp64, the two packages' summation orders
X_TOL_PORT = 1e-10   # fp64, the port's column blocks against its full W


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    # both rank counts start together; each waits on its own
    return {n: W.spawn(n, ("tp",), tmp_path_factory.mktemp(f"tp{n}"))
            for n in (2, 4)}


@pytest.fixture(scope="module")
def results(ranks):
    return {n: wait()["tp"] for n, wait in ranks.items()}


RUNS = {name: (seed, kw) for name, seed, kw in W.TP_RUNS}


def _solve(solver_cls, name, **extra):
    """Cold solve (and, for "warm", the warm re-solve) of one run."""
    seed, kw = RUNS[name]
    qp = W.tp_problem(seed=seed)
    m = solver_cls()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, **kw, **extra)
    r = m.solve()
    cold = r.info.iter
    if name == "warm":
        m.update(g=qp.g * 1.002)
        m.warm_start(x=np.asarray(r.x), z=np.asarray(r.z),
                     lam=np.asarray(r.lam))
        r = m.solve()
    return m, r, cold


def _same_ranks(per_rank):
    for r in per_rank[1:]:
        for k, v in r.items():
            np.testing.assert_array_equal(v, per_rank[0][k])
    return per_rank[0]


@pytest.mark.parametrize("d,n,align", [
    (d, n, a) for d in (1, 7, 48, 100, 1000, 4000) for n in (1, 2, 4, 8)
    for a in (8, 32, 128) if not (d == 1 and n == 8)])
def test_tp_pad_dim_matches_jax(d, n, align):
    dp = tp_pad_dim(d, n, align)
    assert dp == j_tp_pad_dim(d, n, align)
    assert dp >= d and dp % n == 0 and (dp // n) % align == 0


@pytest.mark.parametrize("n_ranks", [2, 4])
@pytest.mark.parametrize("name", ["plain", "warm", "alpha"])
def test_tp_matches_jax_and_single_device(results, n_ranks, name):
    out = _same_ranks(results[n_ranks])
    j, jr, jcold = _solve(JR, name, mesh=j_make_mesh(n_ranks,
                                                     axis_name="tp"))
    t, tr, tcold = _solve(T.ReLU_QP, name, device="cpu", backend="xla")
    assert jr.info.status == tr.info.status == "solved"
    assert bool(out[f"{name}_status"])
    assert int(out[f"{name}_iter"]) == jr.info.iter == tr.info.iter
    assert int(out[f"{name}_rho_ind"]) == int(j.rho_ind) == t.rho_ind
    assert int(out[f"{name}_dp"]) == j.Dp
    np.testing.assert_allclose(out[f"{name}_x"], np.asarray(jr.x), rtol=0,
                               atol=X_TOL_JAX)
    np.testing.assert_allclose(out[f"{name}_lam"], np.asarray(jr.lam),
                               rtol=0, atol=X_TOL_JAX)
    np.testing.assert_allclose(out[f"{name}_x"], tr.x.numpy(), rtol=0,
                               atol=X_TOL_PORT)
    if name == "warm":
        assert int(out["warm_cold_iter"]) == jcold == tcold
        assert int(out["warm_iter"]) < int(out["warm_cold_iter"])
    if name == "plain":
        # parallel.solve_loop_tp called on the solver's operands: its solve
        assert int(out["loop_tp_iter"]) == int(out["plain_iter"])
        assert int(out["loop_tp_status"]) == 1


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_tp_bf16_refine(results, n_ranks):
    out = _same_ranks(results[n_ranks])
    t, tr, _ = _solve(T.ReLU_QP, "bf16", device="cpu", backend="xla")
    assert tr.info.status == "solved" and bool(out["bf16_status"])
    assert int(out["bf16_iter"]) == tr.info.iter
    np.testing.assert_allclose(out["bf16_x"], tr.x.double().numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_tp_blocks_and_gathers(results, n_ranks):
    """The ranks asserted their (N_rho, Dp, Dp/W) blocks; here: one
    all-gather per iteration, each of Dp/W numbers, and no reduction."""
    for r in results[n_ranks]:
        for name in RUNS:
            dp = int(r[f"{name}_dp"])
            # the counted solve is the cold one
            iters = int(r["warm_cold_iter" if name == "warm"
                          else f"{name}_iter"])
            assert int(r[f"{name}_gathers"]) == iters
            assert int(r[f"{name}_reduces"]) == 0
            assert (r[f"{name}_sizes"] == dp // n_ranks).all()
