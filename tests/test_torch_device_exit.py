"""A solve as one device program, on the CPU through stand-ins.

On ``cuda`` a solve of the port is one launch of a CUDA graph whose
conditional WHILE nodes run the check windows until a flag the windows
write on the card stops them (``reluqp_tpu_torch/core/graphs.py``,
``csrc/graph_loop.cu``), and a loop-path control step is one launch too. A
CPU has no graphs, so these tests hand the solvers' caches two stand-ins:
``StandIn`` (a piece's capture: it records the callable and the tensors it
reaches, and replays that callable on those tensors, which must not have
moved) and ``StandInLoop`` (the built program: it walks the captured
pieces, running a loop's body while its flag tensor reads non-zero and an
IF's once, and adds one to the loop's body count as the card's flag kernel
does). The host then reads the result bundle once, as it does on the card.

Held, for the canonical QP, two ``rand_qp(30, 8, 8)`` seeds, the two-phase
refine (``iter_precision="bf16"``: the stall test on the device),
``adaptive_rho_interval`` 2 and 3 (the ρ stride on the device), a
``max_iter % check_interval`` tail, an infeasible instance under
``check_infeasibility``, a 20-step loop MPC, a dense B=8 and a
heterogeneous B=6 batch:

- the device-exit path equals the per-window path (each window a replay,
  its flag read by the host) bit for bit: x, z, λ, status, iterations,
  rungs, residuals and the reduced-precision iterations;
- both agree with the JAX package: fp64 equal status, iterations and rung,
  x within 1e-8 (1e-9 for the batches); the bf16 refine in fp32 equal
  status, iterations within one check window, x within 1e-3;
- the chunk runner's launch hook runs once per window run, counted from
  the program's body counts where the card ran the loop;
- a solve makes one host read; the per-window path reads its control
  vector once per full window and the result once, deciding every loop
  entry, phase switch and tail from those reads or from the values its
  start piece sets; so do ``verbose`` (its print from the same read) and
  repack (a stage boundary adds no read, and its iterations come from the
  last read), no more than the dense batch walked window by window.
"""
import numpy as np
import pytest
import torch

import reluqp_tpu as J
import reluqp_tpu.models.mpc as JM
from reluqp_tpu.batch import BatchedReLU_QP as JB
from reluqp_tpu.utils.problems import canonical_qp, rand_qp

import reluqp_tpu_torch as T
import reluqp_tpu_torch.core.batched as TCB
import reluqp_tpu_torch.models.mpc as TM
import reluqp_tpu_torch.solver as TS
from reluqp_tpu_torch.core.graphs import (Loop, Piece, Program, WindowGraphs,
                                          on_launch)
from test_torch_window_graph import (StandIn, _batch_out, _hetero_batch,
                                     _qp_out, _same, _shared_batch)


class StandInLoop:
    """A built device program on the CPU: ``nodes`` as ``GraphProgram``
    takes them (``("graph", capture)``, ``("loop" | "cond", flag, slot,
    body)``), walked at every launch; each body run adds one to its slot
    of ``counts``, as the flag kernel does on the card."""

    def __init__(self, nodes, counts):
        self.nodes, self.counts = nodes, counts
        self.launches = 0

    def launch(self, stream):
        assert stream is None
        self.launches += 1
        self._run(self.nodes)

    def _run(self, nodes):
        for node in nodes:
            if node[0] == "graph":
                node[1].replay()
                continue
            kind, flag, slot, body = node
            assert flag.dtype == torch.int32 and flag.dim() == 0
            while bool(flag):
                self._run(body)
                self.counts[slot] += 1
                if kind == "cond":
                    break


def _device(solver):
    solver._window_graphs = WindowGraphs(capture=StandIn, build=StandInLoop)
    return solver._window_graphs


def _per_window(solver):
    solver._window_graphs = WindowGraphs(capture=StandIn)
    solver._window_graphs.device_exit = False
    return solver._window_graphs


class _Reads:
    """Counts a cache's host reads (``WindowGraphs.read`` calls)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = WindowGraphs.read

        def read(cache, *ts, **kw):
            self.n += 1
            return real(cache, *ts, **kw)

        monkeypatch.setattr(WindowGraphs, "read", read)


def _counting(runner, hits):
    """``runner`` with a launch hook: once per window run, replayed or
    settled from the body counts like a kernel's counter."""
    def run(*args, **kw):
        on_launch(lambda: hits.append(1))
        return runner(*args, **kw)
    return run


def _windows(iters, ci):
    return -(-int(iters) // ci)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


# --------------------------------------------------------------------- #
# the single QP                                                         #
# --------------------------------------------------------------------- #

_PINF = (np.eye(2), np.zeros(2), np.array([[1.0, 0.0], [1.0, 0.0],
                                           [0.0, 1.0]]),
         np.array([1.0, -np.inf, -1.0]), np.array([np.inf, -1.0, 1.0]))
_F64 = dict(precision="float64", eps_abs=1e-6, check_interval=5)


def _canonical():
    qp = canonical_qp()
    return qp.H, qp.g, qp.A, qp.l, qp.u


QP_CASES = {
    "canonical": (_canonical, _F64),
    "rand seed 0": (lambda: rand_qp(30, 8, 8, seed=0, compute_sol=False)[:5],
                    _F64),
    "rand seed 1": (lambda: rand_qp(30, 8, 8, seed=1, compute_sol=False)[:5],
                    _F64),
    "refine bf16": (lambda: rand_qp(30, 8, 8, seed=2,
                                    compute_sol=False)[:5],
                    dict(precision="float32", eps_abs=1e-4,
                         iter_precision="bf16", check_interval=5)),
    "rho interval 2": (lambda: rand_qp(30, 8, 8, seed=3,
                                       compute_sol=False)[:5],
                       dict(_F64, check_interval=1, adaptive_rho_interval=2)),
    "rho interval 3": (lambda: rand_qp(30, 8, 8, seed=3,
                                       compute_sol=False)[:5],
                       dict(_F64, check_interval=1, adaptive_rho_interval=3)),
    "tail": (lambda: rand_qp(30, 8, 8, seed=4, compute_sol=False)[:5],
             dict(_F64, eps_abs=1e-12, max_iter=33)),
    "infeasible": (lambda: _PINF, dict(_F64, check_infeasibility=True)),
}


@pytest.mark.parametrize("case", list(QP_CASES))
def test_single_qp_device_exit(case, monkeypatch):
    """Three cold solves (the program walked, then captured and built,
    then launched) through the device exit against the same through the
    per-window path: bit-equal, the same reduced-precision iterations,
    one window hook per window, one host read per solve; and against the
    JAX package."""
    data_fn, kw = QP_CASES[case]
    data = data_fn()
    results = []
    monkeypatch.setattr(TS, "solve_loop", _recorded(TS.solve_loop, results))
    reads = _Reads(monkeypatch)
    runs, hits, n_reads = {}, {}, {}
    for path in ("windows", "device"):
        m = T.ReLU_QP()
        m.setup(*data, device="cpu", bank_backend="numpy", **kw)
        cache = _per_window(m) if path == "windows" else _device(m)
        hits[path] = []
        m._chunk_runner = _counting(m._chunk_runner, hits[path])
        runs[path], n_reads[path] = [], []
        for _ in range(3):
            m.clear_primal_dual()
            r0 = reads.n
            runs[path].append(_qp_out(m.solve()) + (m.rho_ind,
                                                    results[-1].k_fast))
            n_reads[path].append(reads.n - r0)
        if path == "device":
            assert cache.programs == 1 and cache.replays == 2
    for a, b in zip(runs["windows"], runs["device"]):
        _same(a, b)
    ci = kw["check_interval"]
    iters = runs["device"][0][3]
    assert len(hits["device"]) == len(hits["windows"]) \
        == 3 * _windows(iters, ci)
    # the device exit: one read per solve (its first use walks the
    # program on the host); per window: one per full window and the result
    assert n_reads["device"][1:] == [1, 1], n_reads
    assert n_reads["windows"] == [iters // ci + 1] * 3, n_reads
    if case == "refine bf16":
        k_fast = runs["device"][0][-1]
        assert 0 < k_fast < iters, (k_fast, iters)

    j = J.ReLU_QP()
    j.setup(*data, backend="xla", bank_backend="numpy", **kw)
    jr = j.solve()
    tr = runs["device"][0]
    assert jr.info.status == tr[4]
    if kw["precision"] == "float64":
        assert jr.info.iter == tr[3] and j.rho_ind == tr[8]
        np.testing.assert_allclose(_np(jr.x), _np(tr[0]), rtol=0, atol=1e-8)
    else:
        assert abs(jr.info.iter - tr[3]) <= ci
        np.testing.assert_allclose(_np(jr.x), _np(tr[0]), rtol=0, atol=1e-3)


def _recorded(solve_loop, out):
    def run(*args, **kw):
        res = solve_loop(*args, **kw)
        out.append(res)
        return res
    return run


def test_a_solvers_graphs_go_with_it():
    """A solver's cache (its captured pieces and built programs) is freed
    by reference counting when the solver goes (a single QP, verbose or
    not, and a batch): a reference
    cycle would leave the graphs to the cyclic collector, which may run in
    the middle of another solver's capture, where destroying a graph
    invalidates the capture."""
    import gc
    import weakref
    inst = rand_qp(10, 3, 3, seed=0, compute_sol=False)
    refs = []
    collecting = gc.isenabled()
    gc.disable()
    try:
        for verbose in (False, True, None):
            if verbose is None:
                m = T.BatchedReLU_QP()
                m.setup(*_shared_batch(B=4), device="cpu")
            else:
                m = T.ReLU_QP()
                m.setup(*inst[:5], device="cpu", verbose=verbose)
            refs.append(weakref.ref(_device(m)))
            for _ in range(3):
                m.clear_primal_dual()
                m.solve()
            del m
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


def test_failed_build_raises():
    """A program whose build fails raises; nothing runs the solve another
    way in its place."""
    class Broken:
        def __init__(self, nodes, counts):
            raise RuntimeError("device program build failed")

    inst = rand_qp(10, 3, 3, seed=0, compute_sol=False)
    m = T.ReLU_QP()
    m.setup(*inst[:5], device="cpu")
    m._window_graphs = WindowGraphs(capture=StandIn, build=Broken)
    m.solve()       # the first use walks the program on the host
    m.clear_primal_dual()
    with pytest.raises(RuntimeError, match="build failed"):
        m.solve()


# --------------------------------------------------------------------- #
# the loop MPC                                                          #
# --------------------------------------------------------------------- #

def test_loop_mpc_device_exit(monkeypatch):
    """20 control steps of the loop path, each one program (refresh,
    solve, plant step): bit-equal to the per-window path, one host read per
    segment, window hooks equal to the windows run, and the JAX package's
    loop rollout to 1e-8 with equal iterations."""
    Ad, Bd = TM.random_linear_system(6, 2, seed=0)
    x0 = 0.5 * np.random.RandomState(0).randn(6)
    noise = 0.01 * np.random.RandomState(1).randn(20, 6)
    kw = dict(horizon=5, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
              precision="float64")
    reads = _Reads(monkeypatch)
    outs, hits, n_reads = {}, {}, {}
    for path in ("windows", "device"):
        ctrl = TM.MPC(Ad, Bd, np.eye(6), 0.1 * np.eye(2), device="cpu",
                      bank_backend="numpy", **kw)
        cache = (_per_window if path == "windows" else _device)(ctrl.solver)
        hits[path] = []
        ctrl.solver._chunk_runner = _counting(ctrl.solver._chunk_runner,
                                              hits[path])
        r0 = reads.n
        outs[path] = TM.mpc_rollout_scan(
            ctrl.solver, ctrl.prob, x0, 20, kernel="loop", noise=noise,
            check_interval=5, return_stats=True, return_state=True)
        n_reads[path] = reads.n - r0
        hits[path] = len(hits[path])
        if path == "device":
            # step 1 walks the program, steps 2..20 launch it
            assert cache.programs == 1 and cache.replays == 19
            # a second segment: one read
            r0 = reads.n
            TM.mpc_rollout_scan(ctrl.solver, ctrl.prob, x0, 20,
                                kernel="loop", noise=noise, check_interval=5)
            assert reads.n - r0 == 1
    _same(outs["windows"], outs["device"])
    its = outs["device"][2]
    assert hits["device"] == hits["windows"] \
        == sum(_windows(i, 5) for i in its.tolist())
    assert n_reads["windows"] > n_reads["device"]

    j = JM.MPC(Ad, Bd, np.eye(6), 0.1 * np.eye(2), bank_backend="numpy",
               **kw)
    xs_j, us_j, it_j = JM.mpc_rollout_scan(j.solver, j.prob, x0, 20,
                                           kernel="loop", noise=noise,
                                           check_interval=5)
    np.testing.assert_array_equal(np.asarray(it_j), its.numpy())
    np.testing.assert_allclose(np.asarray(xs_j), _np(outs["device"][0]),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(us_j), _np(outs["device"][1]),
                               rtol=0, atol=1e-8)


# --------------------------------------------------------------------- #
# the batched loops                                                     #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["dense B=8", "hetero B=6"])
def test_batched_device_exit(case, monkeypatch):
    """Three cold solves of a dense shared B=8 and a heterogeneous B=6
    batch, fp64 ``"xla"``: the device exit bit-equal to the per-window
    path, window hooks equal to the windows run, one host read per solve
    (the per-problem stats come with the result bundle); against the JAX
    package equal iterations, status and rungs, x within 1e-9."""
    hetero = case.startswith("hetero")
    data = _hetero_batch(B=6) if hetero else _shared_batch(B=8)
    kw = dict(eps_abs=1e-6, precision="float64", backend="xla",
              check_interval=5)
    name = "_chunk_hetero" if hetero else "_chunk_shared_rho"
    runner = getattr(TCB, name)
    reads = _Reads(monkeypatch)
    runs, hits, n_reads = {}, {}, {}
    for path in ("windows", "device"):
        hits[path] = []
        monkeypatch.setattr(TCB, name, _counting(runner, hits[path]))
        m = T.BatchedReLU_QP()
        m.setup(*data, device="cpu", **kw)
        cache = (_per_window if path == "windows" else _device)(m)
        runs[path], n_reads[path] = [], []
        for _ in range(3):
            m.clear_primal_dual()
            r0 = reads.n
            runs[path].append(_batch_out(m.solve()))
            n_reads[path].append(reads.n - r0)
        if path == "device":
            assert cache.programs == 1 and cache.replays == 2
    for a, b in zip(runs["windows"], runs["device"]):
        _same(a, b)
    total = runs["device"][0][9]
    assert len(hits["device"]) == len(hits["windows"]) \
        == 3 * _windows(total, 5)
    assert n_reads["device"][1:] == [1, 1], n_reads
    assert n_reads["windows"] == [total // 5 + 1] * 3, n_reads

    j = JB()
    j.setup(*data, **kw)
    jr, tr = j.solve(), runs["device"][0]
    np.testing.assert_array_equal(jr.info.iter, tr[3])
    np.testing.assert_array_equal(jr.info.status_code, tr[4])
    np.testing.assert_array_equal(
        np.broadcast_to(np.asarray(j.rho_ind), tr[8].shape), tr[8])
    np.testing.assert_allclose(np.asarray(jr.x), _np(tr[0]), rtol=0,
                               atol=1e-9)


# --------------------------------------------------------------------- #
# the host walk's reads                                                 #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("case", ["verbose", "repack"])
def test_host_walk_reads(case, monkeypatch, capsys):
    """``verbose`` prints each window from the read that decides the loop
    (one per full window and the result's, one line per window); repack
    reads once per window over all its stages (the next stage starts from
    the open count and iterations of that read), fewer than the dense
    batch walked window by window, with equal iterations and status."""
    reads = _Reads(monkeypatch)
    if case == "verbose":
        data = rand_qp(30, 8, 8, seed=0, compute_sol=False)[:5]
        m = T.ReLU_QP()
        m.setup(*data, device="cpu", bank_backend="numpy", verbose=True,
                **_F64)
        capsys.readouterr()
        r0 = reads.n
        res = m.solve()
        lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("Iter: ")]
        windows = res.info.iter // _F64["check_interval"]
        assert reads.n - r0 == windows + 1
        assert len(lines) == windows and lines[-1].startswith(
            f"Iter: {res.info.iter},")
        return
    from test_torch_repack import _batch
    data, n, res = _batch(), {}, {}
    for policy in ("dense", "repack"):
        t = T.BatchedReLU_QP()
        t.setup(*data, device="cpu", tail_policy=policy, **_F64)
        if policy == "repack":
            t._repack_sched = (96, 48, 24)
        r0 = reads.n
        res[policy] = t.solve()
        n[policy] = reads.n - r0
    windows = res["repack"].info.n_iter_total // _F64["check_interval"]
    np.testing.assert_array_equal(res["repack"].info.iter,
                                  res["dense"].info.iter)
    np.testing.assert_array_equal(res["repack"].info.status_code,
                                  res["dense"].info.status_code)
    assert n == {"dense": windows + 1, "repack": windows}, (n, windows)


def test_host_known_start_is_walked_only(monkeypatch):
    """A program whose start flags only the host holds (a carried repack
    stage) is decided from them without a read, and is refused as a
    device program."""
    reads = _Reads(monkeypatch)
    ctl = torch.ones((2,), dtype=torch.int32)
    ran = []
    prog = Program([Loop(ctl[0], (Piece(("p",), lambda: ran.append(1)),))],
                   ctl)
    cache = WindowGraphs(capture=StandIn, build=StandInLoop)
    cache.program(prog, "cpu", per_window=True, known=((ctl[0], 0),))
    assert reads.n == 0 and not ran and prog.value(ctl[0]) == 0
    with pytest.raises(ValueError, match="must be walked"):
        cache.program(prog, "cpu", known=((ctl[0], 0),))
