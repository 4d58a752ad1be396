"""The check windows' graph path on the CPU, through a stand-in capture.

On ``cuda`` every check window of the solve loops runs as one replay of a
CUDA graph (``reluqp_tpu_torch/core/graphs.py``). A CPU has no graphs, so
these tests hand the solvers' window caches a stand-in capture: at
"capture" it records the window callable and every tensor the callable
closes over (the static buffers and the solver's operands); at "replay" it
checks that those tensors still live where they did and calls the same
callable on them. That is a graph's binding: a window that closed over one
solve's vector instead of its staged copy replays on stale data here as it
would on the card.

Held: every covered path (the single QP, the loop MPC, the shared dense,
repack, per-problem and heterogeneous batches, the scenario loop) equals
the eager CPU path bit for bit in fp64 and fp32; ``update``,
``warm_start`` and a new control step change the result as they do
eagerly, without a new capture; a new bank or a new ``eps_abs`` captures
anew; the tail window and both refine phases have keys of their own; and
the graphed batched solve against the JAX package.
"""
import numpy as np
import pytest
import torch

from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.utils.problems import rand_qp, update_qp

import reluqp_tpu_torch as T
import reluqp_tpu_torch.models.mpc as TM
from reluqp_tpu_torch.core.graphs import WindowGraphs


def _closure_tensors(obj, seen, out):
    """Every tensor a callable reaches through its closure, tuples and
    named tuples included."""
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            _closure_tensors(o, seen, out)
    elif callable(obj) and getattr(obj, "__closure__", None):
        for cell in obj.__closure__:
            _closure_tensors(cell.cell_contents, seen, out)


class StandIn:
    """A graph's binding on the CPU: "capture" records the window and the
    tensors it reads and writes, "replay" runs that same window on those
    same tensors, which must not have moved."""

    def __init__(self, fn, stream, pool):
        assert stream is None and pool is None
        self.fn = fn
        found = []
        _closure_tensors(fn, set(), found)
        self.bound = [(t, t.data_ptr()) for t in found]
        assert self.bound

    def replay(self):
        for t, ptr in self.bound:
            assert t.data_ptr() == ptr, "a bound tensor moved"
        self.fn()


def _graphed(solver):
    solver._window_graphs = WindowGraphs(capture=StandIn)
    return solver._window_graphs


def _same(a, b):
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        elif isinstance(u, np.ndarray):
            np.testing.assert_array_equal(u, v)
        else:
            assert u == v or (u != u and v != v), (u, v)


def _qp_out(r):
    i = r.info
    return (r.x, r.z, r.lam, i.iter, i.status, i.pri_res, i.dua_res,
            i.rho_estimate)


def _batch_out(r):
    i = r.info
    return (r.x, r.z, r.lam, i.iter, i.status_code, i.pri_res, i.dua_res,
            i.rho_estimate, i.rho_ind, i.n_iter_total, i.n_iter_fast)


def _shared_batch(B=6, nx=12, n_eq=3, n_ineq=3, seed0=0):
    base = rand_qp(nx=nx, n_eq=n_eq, n_ineq=n_ineq, seed=seed0,
                   compute_sol=False)
    insts = [update_qp(base.H, base.A, n_eq, n_ineq, seed=seed0 + i,
                       compute_sol=False) for i in range(B)]
    return (base.H, np.stack([i.g for i in insts]), base.A,
            np.stack([i.l for i in insts]), np.stack([i.u for i in insts]))


def _hetero_batch(B=5, nx=10, seed0=0):
    insts = [rand_qp(nx=nx, n_eq=2, n_ineq=3, seed=seed0 + s,
                     compute_sol=False) for s in range(B)]
    return tuple(np.stack([getattr(i, k) for i in insts])
                 for k in ("H", "g", "A", "l", "u"))


def _widened(l, u):
    """New bounds with every inequality row widened (the equality rows,
    which shape the bank, kept)."""
    ineq = ~np.isclose(l, u)
    return dict(l=np.where(ineq, l - 0.05, l), u=np.where(ineq, u + 0.05, u))


def _eps(precision):
    return 1e-6 if precision == "float64" else 1e-3


# --------------------------------------------------------------------- #
# the single QP                                                         #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("backend,kw", [
    ("auto", {}), ("xla", {}),
    ("auto", dict(check_infeasibility=True, alpha=1.6)),
    ("auto", dict(adaptive_rho_interval=12, scaling=True))])
def test_single_qp_graphed_equals_eager(precision, backend, kw):
    """A cold solve, then ``update(g)``, ``update(l, u)``, ``warm_start``
    and ``clear_primal_dual``, each followed by a solve: bit-equal to
    eager, and after the second solve no new capture (the first captures
    the window, used twice in it; the second the pieces a solve runs once:
    its start and its result)."""
    inst = rand_qp(16, 4, 4, seed=3, compute_sol=False)
    rng = np.random.default_rng(0)
    g2 = inst.g + 0.1 * rng.standard_normal(inst.g.shape)
    outs, caches = [], []
    for graphed in (False, True):
        m = T.ReLU_QP()
        m.setup(*inst[:5], device="cpu", precision=precision,
                backend=backend, eps_abs=_eps(precision), check_interval=5,
                max_iter=200, **kw)
        cache = _graphed(m) if graphed else None
        seq = [_qp_out(m.solve())]
        m.update(g=g2)
        seq.append(_qp_out(m.solve()))
        n_cap = cache.captures if graphed else None
        m.update(**_widened(inst.l, inst.u))
        seq.append(_qp_out(m.solve()))
        m.warm_start(x=np.zeros(16), lam=np.zeros(8))
        seq.append(_qp_out(m.solve()))
        m.clear_primal_dual()
        seq.append(_qp_out(m.solve()))
        outs.append(seq)
        if graphed:
            assert cache.captures == n_cap >= 1 and cache.replays > 0
    for a, b in zip(*outs):
        _same(a, b)


def test_new_bank_or_eps_captures_anew():
    """``update_matrices`` (a new bank) and ``update_settings(eps_abs)``
    (a tolerance baked into the window) make new windows; a solve with
    neither replays."""
    inst = rand_qp(20, 5, 5, seed=1, compute_sol=False)
    m = T.ReLU_QP()
    m.setup(*inst[:5], device="cpu", precision="float64", eps_abs=1e-7,
            check_interval=5)
    cache = _graphed(m)
    m.solve()
    m.clear_primal_dual()
    m.solve()
    n = cache.captures
    m.clear_primal_dual()
    m.solve()
    assert cache.captures == n
    keys = set(cache.keys())
    m.update_matrices(H=inst.H + np.eye(20))
    m.clear_primal_dual()
    m.solve()
    m.clear_primal_dual()
    r = m.solve()
    assert cache.captures > n and not keys & set(cache.keys())
    n = cache.captures
    m.update_settings(eps_abs=1e-6)
    m.clear_primal_dual()
    m.solve()
    m.clear_primal_dual()
    r2 = m.solve()
    assert cache.captures > n
    assert r.info.status == r2.info.status == "solved"


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_tail_and_refine_phases_have_keys_of_their_own(precision):
    """A two-phase refine ("high" windows, then "highest" ones) that runs
    to a budget with a partial last window: three window kinds, each its
    own key, and the result bit-equal to eager."""
    inst = rand_qp(20, 5, 5, seed=2, compute_sol=False)
    kw = dict(device="cpu", precision=precision, eps_abs=1e-14,
              check_interval=5, max_iter=33, iter_precision="high",
              refine=True)
    outs = []
    for graphed in (False, True):
        m = T.ReLU_QP()
        m.setup(*inst[:5], **kw)
        cache = _graphed(m) if graphed else None
        outs.append([_qp_out(m.solve()) for _ in range(2)])
    for a, b in zip(*outs):
        _same(a, b)
    assert outs[1][0][4] == "max_iters_reached"
    kinds = {k[:3] for k in cache.keys() if k[0] in ("window", "tail")}
    assert kinds == {("window", 5, "high"), ("window", 5, "highest"),
                     ("tail", 3, "highest")}, kinds
    # and the solve's start and result pieces, one key each
    assert sorted(k[0] for k in cache.keys()
                  if k[0] not in ("window", "tail")) == ["finish", "start"]


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_loop_mpc_graphed_equals_eager(precision):
    """20 control steps of the loop path, each with new g, bounds and bias
    state: bit-equal, at most 4 captures, the rest replays."""
    Ad, Bd = TM.random_linear_system(6, 2, seed=0)
    x0 = 0.5 * np.random.RandomState(0).randn(6)
    noise = 0.01 * np.random.RandomState(1).randn(20, 6)
    outs = []
    for graphed in (False, True):
        ctrl = TM.MPC(Ad, Bd, np.eye(6), 0.1 * np.eye(2), horizon=5,
                      u_min=-1.0, u_max=1.0, eps_abs=_eps(precision),
                      precision=precision, device="cpu")
        cache = _graphed(ctrl.solver) if graphed else None
        outs.append(TM.mpc_rollout_scan(
            ctrl.solver, ctrl.prob, x0, 20, kernel="loop", noise=noise,
            check_interval=5, return_stats=True, return_state=True))
    _same(outs[0], outs[1])
    assert 1 <= cache.captures <= 4 and cache.replays >= 20


# --------------------------------------------------------------------- #
# the batched loops                                                     #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("case", ["shared", "shared_xla", "per_problem",
                                  "repack", "hetero"])
def test_batched_graphed_equals_eager(case, precision):
    """Two cold solves, ``update(g)``, ``update(l, u)`` and ``warm_start``:
    bit-equal to eager, no capture after the first two solves."""
    hetero = case == "hetero"
    data = _hetero_batch() if hetero else _shared_batch(B=8)
    kw = dict(device="cpu", precision=precision, eps_abs=_eps(precision),
              check_interval=5, max_iter=200,
              backend="xla" if case in ("shared_xla", "repack") else "auto",
              rho_mode="per_problem" if case == "per_problem" else "shared",
              tail_policy="repack" if case == "repack" else "dense")
    rng = np.random.default_rng(1)
    G2 = data[1] + 0.1 * rng.standard_normal(data[1].shape)
    outs = []
    for graphed in (False, True):
        m = T.BatchedReLU_QP()
        m.setup(*data, **kw)
        if case == "repack":
            m._repack_sched = (8, 4, 2)
        cache = _graphed(m) if graphed else None
        seq = [_batch_out(m.solve())]
        m.clear_primal_dual()
        seq.append(_batch_out(m.solve()))
        n_cap = cache.captures if graphed else None
        m.update(g=G2)
        seq.append(_batch_out(m.solve()))
        m.update(**_widened(data[3], data[4]))
        m.clear_primal_dual()
        seq.append(_batch_out(m.solve()))
        m.warm_start(x=np.zeros_like(data[1]))
        seq.append(_batch_out(m.solve()))
        outs.append(seq)
        if graphed:
            assert cache.captures == n_cap >= 1 and cache.replays > 0
            if case == "repack":
                # the rows of each window's state (its key's Y signature)
                rows = {k[5][1][0][2][0] for k in cache.keys()
                        if k[0] == "window"}
                assert rows == {8, 4, 2}, rows
    for a, b in zip(*outs):
        _same(a, b)


def test_batched_refine_and_tail_keys():
    """The batched loop's two refine phases and its tail window (the same
    step at the remainder's length) are keys of their own."""
    data = _shared_batch(B=4)
    m = T.BatchedReLU_QP()
    m.setup(*data, device="cpu", precision="float32", eps_abs=1e-12,
            check_interval=5, max_iter=33, iter_precision="high",
            refine=True)
    cache = _graphed(m)
    e = T.BatchedReLU_QP()
    e.setup(*data, device="cpu", precision="float32", eps_abs=1e-12,
            check_interval=5, max_iter=33, iter_precision="high",
            refine=True)
    for _ in range(2):
        m.clear_primal_dual()
        e.clear_primal_dual()
        _same(_batch_out(m.solve()), _batch_out(e.solve()))
    kinds = {k[1:3] for k in cache.keys() if k[0] == "window"}
    assert kinds == {(5, "high"), (5, "highest"), (3, "highest")}, kinds
    # the cold start state is built by a graphed window of its own
    assert sum(k[0] == "start" for k in cache.keys()) == 1


def test_scenario_loop_graphed_equals_eager():
    """The scenario loop path (K4's plain version on the padded layout,
    the state-affine bias of every step's plant states): bit-equal."""
    Ad, Bd = TM.double_integrator(dt=0.1)
    ctrl = TM.MPC(Ad, Bd, np.diag([10.0, 1.0]), np.array([[0.1]]),
                  horizon=6, u_min=-1.0, u_max=1.0, device="cpu",
                  precision="float64")
    prob = ctrl.prob
    B = 5
    X0 = np.array([[1.0, 0.0]]) + 0.2 * np.random.RandomState(3).randn(B, 2)
    noise = 0.02 * np.random.RandomState(7).randn(8, B, 2)
    outs = []
    for graphed in (False, True):
        m = T.BatchedReLU_QP()
        m.setup(prob.H, np.tile(prob.g0, (B, 1)), prob.A,
                np.tile(prob.l0, (B, 1)), np.tile(prob.u0, (B, 1)),
                device="cpu", precision="float64", eps_abs=1e-7)
        cache = _graphed(m) if graphed else None
        outs.append(TM.scenario_rollout_scan(
            m, prob, X0, 8, kernel="loop", noise=noise, check_interval=5,
            return_stats=True, return_state=True))
    _same(outs[0], outs[1])
    assert cache.captures >= 1 and cache.replays >= 8


@pytest.mark.parametrize("rho_mode", ["shared", "per_problem"])
def test_graphed_batched_matches_jax(rho_mode):
    """The graphed windows (device-side iteration counter, staged
    vectors) against the JAX package's batched solve, fp64 ``"xla"``:
    equal iterations, status and rungs, x within 1e-9, two solves."""
    data = _shared_batch(B=5)
    kw = dict(eps_abs=1e-6, precision="float64", backend="xla",
              rho_mode=rho_mode, check_interval=5)
    j = JB()
    j.setup(*data, **kw)
    t = T.BatchedReLU_QP()
    t.setup(*data, device="cpu", **kw)
    cache = _graphed(t)
    for _ in range(2):
        jr, tr = j.solve(), t.solve()
        np.testing.assert_array_equal(jr.info.iter, tr.info.iter)
        np.testing.assert_array_equal(jr.info.status_code,
                                      tr.info.status_code)
        np.testing.assert_array_equal(np.asarray(j.rho_ind),
                                      t.rho_ind.numpy())
        np.testing.assert_allclose(np.asarray(jr.x), tr.x.numpy(), rtol=0,
                                   atol=1e-9)
        j.clear_primal_dual()
        t.clear_primal_dual()
    assert cache.replays > 0


def test_eager_when_asked_and_on_the_cpu_by_default():
    """``_window_graphs = False`` and the default cache on the CPU run every
    window eagerly; ``on_launch`` hooks recorded in a capture run once per
    replay and not at the capture."""
    from reluqp_tpu_torch.core import graphs as G
    inst = rand_qp(10, 3, 3, seed=0, compute_sol=False)
    m = T.ReLU_QP()
    m.setup(*inst[:5], device="cpu")
    assert not m._window_graphs.enabled("cpu")
    assert m._window_graphs.enabled("cuda")
    m.solve()
    assert m._window_graphs.captures == m._window_graphs.replays == 0
    m._window_graphs = False
    assert m.solve().info.status == "solved"

    class Record:
        # a capture runs the window's Python (the hooks are recorded, not
        # run); a replay runs no Python
        def __init__(self, fn, stream, pool):
            fn()

        def replay(self):
            pass

    hits = []
    cache = WindowGraphs(capture=Record)
    fn = lambda: G.on_launch(lambda: hits.append(1))
    for _ in range(4):
        cache.run("k", fn, "cpu")
    # first use eager (1), second captured (0 at capture) and replayed (1)
    assert len(hits) == 4 and cache.captures == 1 and cache.replays == 3


def test_cache_bound_and_clear():
    """The cache keeps the 64 most recently used windows; ``clear`` drops
    every graph and buffer, and a cleared key runs eagerly again."""
    from reluqp_tpu_torch.core import graphs as G
    runs = []
    cache = WindowGraphs(capture=StandIn)
    buf = cache.buffer("b", (2,), torch.float64, "cpu")
    for key in range(70):
        for _ in range(2):
            cache.run(key, lambda: runs.append(buf.sum()), "cpu")
    assert len(cache.keys()) == G._MAX_WINDOWS and cache.keys()[0] == 6
    assert cache.captures == 70 and cache.replays == 70
    cache.clear()
    assert cache.keys() == [] and cache.buffer("b", (2,), torch.float64,
                                               "cpu") is not buf
    cache.run(69, lambda: runs.append(0), "cpu")
    assert cache.captures == 70 and len(runs) == 141
