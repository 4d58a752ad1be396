"""The port's batch-sharded solves over ``torch.distributed`` (gloo, one
process per rank) against the JAX package on its CPU mesh.

Worker processes (``tests/_torch_dist_worker.py``, which imports neither
``jax`` nor ``reluqp_tpu``) run the port on 2 ranks, and on 4 for one case;
this process runs the JAX package's references on as many of its 8 virtual
CPU devices, and the port's unsharded solves. Sizes are small (nx 16,
B 8) and everything runs in fp64:

- ``BatchedReLU_QP(mesh=)`` with ``backend="xla"`` (shared batch in both ρ
  modes, heterogeneous batch) against JAX's ``BatchedReLU_QP(mesh=
  make_mesh(W))``: equal status, iterations and final rungs, x within 1e-10;
- ``"auto"`` (K4's and K5's plain twins on the padded layout, each rank
  padding its own rows) against the port's unsharded solve, and
  ``parallel.solve_sharded_shared`` (with the bf16 bank, the two-phase
  refine and inert padding rows) against the unsharded loop;
- the refusals (a batch that does not divide, ``"scan"`` on a mesh);
- the collectives of one solve (a guard, as the JAX package's lowered-HLO
  count): per check window two all-reduces walking one shared rung, one
  per problem, and one all-gather after the loop;
- the scenario loop rollout on a mesh against JAX's mesh'd rollout and the
  port's unsharded one, and its status lane (F-w2) the min over every
  rank's scenarios;
- the placement helpers (``shard_batch``, ``local_axis``,
  ``process_local_batch``, ``replicate``, ``host_replicated``), asserted in
  the ranks.

Each spawn has its own timeout; the ranks' rendezvous and collectives time
out after 60 s, so a hung rank fails its test rather than the suite.
"""
import numpy as np
import pytest
import torch

import reluqp_tpu.models.mpc as JM
from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.parallel import make_mesh as j_make_mesh

import _torch_dist_worker as W
import reluqp_tpu_torch as T
import reluqp_tpu_torch.models.mpc as TM

X_TOL = 1e-10      # fp64, summation order only
STATE_TOL = 1e-9   # fp64 rollouts, as tests/test_torch_scenario.py
CASES2 = ("batched", "sharded_shared", "refusals", "guard", "scenario",
          "scenario_fw2")


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return W.spawn(2, CASES2, tmp_path_factory.mktemp("ranks2"))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return W.spawn(4, ("batched",), tmp_path_factory.mktemp("ranks4"))


@pytest.fixture(scope="module")
def results2(ranks2):
    return ranks2()


@pytest.fixture(scope="module")
def results4(ranks4):
    return ranks4()


def _data(name):
    return W.hetero_batch() if name == "hetero" else W.shared_batch()


def _jax_mesh_solve(name, n_ranks):
    H, G, A, L, U = _data(name)
    kw = {} if name == "hetero" else dict(rho_mode=name)
    j = JB()
    j.setup(H, G, A, L, U, mesh=j_make_mesh(n_ranks), backend="xla", **kw,
            **W.F64)
    res = j.solve()
    return res, np.asarray(j.rho_ind)


def _same_ranks(per_rank):
    """Every rank holds the same global results."""
    for r in per_rank[1:]:
        for k, v in r.items():
            np.testing.assert_array_equal(v, per_rank[0][k])
    return per_rank[0]


def _agree_with_jax(out, prefix, jres, jrho):
    np.testing.assert_array_equal(out[f"{prefix}_status"],
                                  np.asarray(jres.info.status_code))
    np.testing.assert_array_equal(out[f"{prefix}_iter"],
                                  np.asarray(jres.info.iter))
    np.testing.assert_array_equal(out[f"{prefix}_rho_ind"],
                                  np.broadcast_to(jrho, (W.B_SHARED,)))
    assert (out[f"{prefix}_status"] == 1).all()
    for k in ("x", "z", "lam"):
        np.testing.assert_allclose(out[f"{prefix}_{k}"],
                                   np.asarray(getattr(jres, k), np.float64),
                                   rtol=0, atol=X_TOL)


@pytest.mark.parametrize("name", ["shared", "per_problem", "hetero"])
def test_mesh_batch_matches_jax_on_two_ranks(results2, name):
    jres, jrho = _jax_mesh_solve(name, 2)
    out = _same_ranks(results2["batched"])
    _agree_with_jax(out, f"xla_{name}", jres, jrho)


def test_mesh_batch_matches_jax_on_four_ranks(results4):
    jres, jrho = _jax_mesh_solve("shared", 4)
    out = _same_ranks(results4["batched"])
    _agree_with_jax(out, "xla_shared", jres, jrho)
    jres, jrho = _jax_mesh_solve("hetero", 4)
    _agree_with_jax(out, "xla_hetero", jres, jrho)


@pytest.mark.parametrize("name", ["shared", "hetero"])
def test_mesh_auto_matches_unsharded(results2, name):
    """K4's (K5's) plain twin on the padded layout: every rank pads its own
    rows; the port's unsharded solve pads the batch once."""
    kw = {} if name == "hetero" else dict(rho_mode="shared")
    m = T.BatchedReLU_QP()
    m.setup(*_data(name), device="cpu", backend="auto", **kw, **W.F64)
    ref = W._result(m.solve())
    out = _same_ranks(results2["batched"])
    for k in ("status", "iter", "rho_ind", "n_iter"):
        np.testing.assert_array_equal(out[f"auto_{name}_{k}"], ref[k])
    for k in ("x", "z", "lam"):
        np.testing.assert_allclose(out[f"auto_{name}_{k}"], ref[k], rtol=0,
                                   atol=X_TOL)


@pytest.mark.parametrize("rho_mode", ["shared", "per_problem"])
def test_solve_sharded_shared_matches_unsharded(results2, rho_mode):
    m = T.BatchedReLU_QP()
    m.setup(*W.shared_batch(), rho_mode=rho_mode, device="cpu",
            backend="xla", **W.F64)
    res = T.core.batched.solve_batched_shared(
        m.Wt_bank, m.bias_all, m.rhos, m.H_dev, m.A_dev, m.G, m.lo, m.hi,
        m.Y, m.rho_ind, rho_mode=rho_mode, **m._solve_kw())
    Y = np.concatenate([r[f"{rho_mode}_Y"]
                        for r in results2["sharded_shared"]])
    for k in ("iters", "status"):
        got = np.concatenate([r[f"{rho_mode}_{k}"]
                              for r in results2["sharded_shared"]])
        np.testing.assert_array_equal(got, getattr(res, k).numpy())
    rho = [r[f"{rho_mode}_rho_ind"] for r in results2["sharded_shared"]]
    np.testing.assert_array_equal(np.concatenate([np.atleast_1d(r)
                                                  for r in rho])
                                  if rho_mode != "shared" else rho[0],
                                  res.rho_ind.numpy())
    assert (res.status.numpy() == 1).all()
    np.testing.assert_allclose(Y, res.Y.numpy(), rtol=0, atol=X_TOL)


def test_solve_sharded_shared_bf16_refine_with_done0(results2):
    """The bf16 bank reaches eps through the fp32 polish copy, padding rows
    start done: as the unsharded loop on the same padded batch (fp32, so
    the two-phase switch is held to rounding: equal status, x within
    1e-4)."""
    H, G, A, L, U = W.shared_batch(B=6)
    m = T.BatchedReLU_QP()
    m.setup(H, G, A, L, U, device="cpu", backend="xla", eps_abs=1e-4,
            iter_precision="bf16")
    inf = float("inf")
    pad = lambda a, fill: torch.cat(
        [a, torch.full((2,) + tuple(a.shape[1:]), fill, dtype=a.dtype)])
    bias = torch.cat([m.bias_all, torch.zeros((m.bias_all.shape[0], 2,
                                               m.Dp))], dim=1)
    res = T.core.batched.solve_batched_shared(
        m.Wt_bank, bias, m.rhos, m.H_dev, m.A_dev, pad(m.G, 0.0),
        pad(m.lo, -inf), pad(m.hi, inf), torch.zeros((8, m.Dp)), m.rho_ind,
        torch.arange(8) >= 6, m._Wt_hi, **m._solve_kw())
    ranks = results2["sharded_shared"]
    status = np.concatenate([r["bf16_status"] for r in ranks])
    Y = np.concatenate([r["bf16_Y"] for r in ranks])
    assert (status == 1).all()
    np.testing.assert_array_equal(status, res.status.numpy())
    np.testing.assert_allclose(Y[:6, :m.nx], res.Y.numpy()[:6, :m.nx],
                               rtol=0, atol=1e-4)
    assert not Y[6:].any()   # the inert rows stay exactly 0


def test_refusals_on_a_mesh(results2):
    """A batch that does not divide by the mesh (setup, ``shard_batch``,
    unequal rows handed to ``solve_sharded_shared``), a mesh whose size is
    not the world's, ``"scan"`` on a mesh'd scenario batch and a
    tensor-parallel ``"pallas"``/``"fused"`` solver raise on every rank
    (the asserts ran in the ranks)."""
    assert all(r["ok"].all() for r in results2["refusals"])


@pytest.mark.parametrize("rho_mode,reduces_per_window",
                         [("shared", 2), ("per_problem", 1)])
def test_collectives_guard(results2, rho_mode, reduces_per_window):
    """Shared ρ: the rung statistics and the exit bundle per window (at
    most 3, the JAX package's count); per problem: the exit bundle only;
    the results' one all-gather comes after the loop, and no reduction is
    larger than the two-scalar bundle."""
    for r in results2["guard"]:
        windows = int(r[f"{rho_mode}_windows"])
        assert windows > 1
        assert int(r[f"{rho_mode}_reduce"]) == reduces_per_window * windows
        assert reduces_per_window <= 3
        assert int(r[f"{rho_mode}_gather"]) == 1
        assert bool(r[f"{rho_mode}_last"])
        sizes = r[f"{rho_mode}_sizes"]
        assert (sizes[:-1] <= 2).all()


def test_scenario_loop_over_mesh(results2):
    """Each rank steps its own plants; the whole ensemble against JAX's
    mesh'd loop rollout and the port's unsharded ones (xla and the padded
    K4 layout): equal per-step iterations and status lane, states within
    1e-9."""
    X0, Wn = W.scenario_inputs()
    B, T_ = W.SCEN_B, W.SCEN_T
    jp = W.scenario_problem(JM)
    j = JB()
    j.setup(jp.H, np.tile(jp.g0, (B, 1)), jp.A, np.tile(jp.l0, (B, 1)),
            np.tile(jp.u0, (B, 1)), mesh=j_make_mesh(2), backend="xla",
            **W.F64)
    jx, ju, jit, jst = JM.scenario_rollout_scan(j, jp, X0, T_, noise=Wn,
                                                return_stats=True)
    out = _same_ranks(results2["scenario"])
    tp = W.scenario_problem(TM)
    for backend in ("xla", "auto"):
        np.testing.assert_array_equal(out[f"{backend}_its"], np.asarray(jit))
        np.testing.assert_array_equal(out[f"{backend}_status"],
                                      np.asarray(jst))
        np.testing.assert_allclose(out[f"{backend}_xs"], np.asarray(jx),
                                   rtol=0, atol=STATE_TOL)
        np.testing.assert_allclose(out[f"{backend}_us"], np.asarray(ju),
                                   rtol=0, atol=STATE_TOL)
        m = W._scenario_solver(T, tp, B, backend=backend)
        xs, us, its, st = TM.scenario_rollout_scan(m, tp, X0, T_, noise=Wn,
                                                   return_stats=True)
        np.testing.assert_array_equal(out[f"{backend}_its"], its.numpy())
        np.testing.assert_array_equal(out[f"{backend}_status"], st.numpy())
        np.testing.assert_allclose(out[f"{backend}_xs"], xs.numpy(), rtol=0,
                                   atol=STATE_TOL)
        assert (out[f"{backend}_status"] == 1).all()


def test_scenario_status_lane_over_mesh(results2):
    """F-w2 keeps JAX's meaning across ranks: rank 1 holds only scenarios
    certified primal infeasible, yet the status lane is the min over every
    rank's scenarios, as JAX's mesh'd rollout reports it (equal per-step
    iterations and lane); the batched solve shows the infeasible ones."""
    B, T_ = W.FW2_X0.shape[0], W.FW2_T
    jp = W.scenario_problem(JM, state_row=True)
    j = JB()
    j.setup(jp.H, np.tile(jp.g0, (B, 1)), jp.A, np.tile(jp.l0, (B, 1)),
            np.tile(jp.u0, (B, 1)), mesh=j_make_mesh(2), backend="xla",
            **W.FW2_KW, **W.F64)
    X0 = W.FW2_X0
    j.update(g=jp.g0[None] + X0 @ jp.g_x0.T, l=jp.l0[None] + X0 @ jp.lu_x0.T,
             u=jp.u0[None] + X0 @ jp.lu_x0.T)
    jr = j.solve()
    j.clear_primal_dual()
    jx, _, jit, jst = JM.scenario_rollout_scan(j, jp, X0, T_,
                                               return_stats=True)
    out = _same_ranks(results2["scenario_fw2"])
    np.testing.assert_array_equal(out["solve_status"], [1, 1, 2, 2])
    np.testing.assert_array_equal(out["solve_status"],
                                  np.asarray(jr.info.status_code))
    np.testing.assert_array_equal(out["solve_iter"], np.asarray(jr.info.iter))
    np.testing.assert_array_equal(out["its"], np.asarray(jit))
    np.testing.assert_array_equal(out["status"], np.asarray(jst))
    assert (out["status"] == 1).all()   # the min hides rank 1's lane of 2
    np.testing.assert_allclose(out["xs"], np.asarray(jx), rtol=0,
                               atol=STATE_TOL)
