"""One rank of the port's multi-process CPU tests (``torch.distributed`` over
gloo, one process per rank).

Usage::

    python tests/_torch_dist_worker.py OUTDIR RANK WORLD PORT CASE [CASE ...]

The ranks join one gloo group on localhost, build a 1-D mesh and run the
named cases in order; each case writes ``OUTDIR/<case>.rank<k>.npz`` (what
the parent test compares with the JAX package and the port's unsharded
solves) and prints ``CASE_OK <case> <rank>``. A failed assertion ends the
process with a non-zero code. The worker imports neither ``jax`` nor
``reluqp_tpu``; the problem builders below are shared with the parent
tests, which run the JAX references in their own process.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the solves' settings (fp64 unless a case says otherwise)
F64 = dict(eps_abs=1e-6, precision="float64")
B_SHARED, NX, NC_EQ, NC_IN = 8, 16, 4, 4
B_LOCAL = 4        # rows per rank of the process-local cases
SCEN_B, SCEN_T = 4, 12
TP_NX = 20


# --------------------------------------------------------------------- #
# problems (numpy only; the parent builds the same ones)                #
# --------------------------------------------------------------------- #

def shared_batch(B=B_SHARED, nx=NX, seed0=0, problems=None):
    """B right-hand sides (g, l, u) around one ``rand_qp`` (H, A)."""
    P = problems or _problems()
    base = P.rand_qp(nx=nx, n_eq=NC_EQ, n_ineq=NC_IN, seed=seed0,
                     compute_sol=False)
    G, L, U = [], [], []
    for i in range(B):
        inst = P.update_qp(base.H, base.A, NC_EQ, NC_IN, seed=seed0 + i,
                           compute_sol=False)
        G.append(inst.g)
        L.append(inst.l)
        U.append(inst.u)
    return base.H, np.stack(G), base.A, np.stack(L), np.stack(U)


def hetero_batch(B=B_SHARED, nx=NX, seed0=0, problems=None):
    """B distinct ``rand_qp`` problems."""
    P = problems or _problems()
    insts = [P.rand_qp(nx=nx, n_eq=NC_EQ, n_ineq=NC_IN, seed=seed0 + i,
                       compute_sol=False) for i in range(B)]
    return tuple(np.stack([getattr(q, k) for q in insts])
                 for k in ("H", "g", "A", "l", "u"))


def local_problems(mode, rank, updated=False, problems=None):
    """Rank ``rank``'s B_LOCAL rows of the process-local cases (the JAX
    package's multi-process worker's problems): with ``updated``, the data
    after ``update(g)`` and ``update_matrices(H)``."""
    P = problems or _problems()
    off = rank * B_LOCAL
    if mode == "shared":
        base = P.rand_qp(nx=NX, n_eq=NC_EQ, n_ineq=NC_IN, seed=0,
                         compute_sol=False)
        rows = [P.update_qp(base.H, base.A, NC_EQ, NC_IN, seed=off + i,
                            compute_sol=False) for i in range(B_LOCAL)]
        H, A = base.H, base.A
    else:
        rows = [P.rand_qp(nx=NX, n_eq=NC_EQ, n_ineq=NC_IN, seed=off + i,
                          compute_sol=False) for i in range(B_LOCAL)]
        H = np.stack([q.H for q in rows])
        A = np.stack([q.A for q in rows])
    G, L, U = (np.stack([getattr(q, k) for q in rows]) for k in "glu")
    if updated:
        G = 1.05 * G
        if mode == "shared":
            H = H + 0.5 * np.eye(NX)
        else:
            bump = 0.1 * (1.0 + np.arange(B_LOCAL))[:, None, None]
            H = H + bump * np.eye(NX)
    return H, G, A, L, U


def tp_problem(nx=TP_NX, seed=3, problems=None):
    P = problems or _problems()
    return P.rand_qp(nx=nx, n_eq=nx // 4, n_ineq=nx // 4, seed=seed,
                     compute_sol=False)


def scenario_problem(M, state_row=False):
    """The condensed double-integrator QP of the scenario tests (horizon 8,
    u in [-1, 1]), from a models.mpc module ``M`` of either package;
    ``state_row`` adds |x_1[0]| <= 0.5, which a plant far from the origin
    cannot meet (primal infeasible)."""
    Ad, Bd = M.double_integrator(dt=0.1)
    Q, R = np.diag([10.0, 1.0]), np.array([[0.1]])
    K, Qf = M.ihlqr(Ad, Bd, Q, R)
    N, ns = 8, 3
    rows, lo, hi = [], list(-np.ones(N)), list(np.ones(N))
    for k in range(N):
        r = np.zeros((1, N * ns))
        r[0, k * ns] = 1.0
        rows.append(r)
    if state_row:
        r = np.zeros((1, N * ns))
        r[0, 1] = 1.0
        rows.append(r)
        lo.append(-0.5)
        hi.append(0.5)
    return M.gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, N, np.vstack(rows),
                                  np.array(lo), np.array(hi), K=K)


# F-w2 across ranks: the last rank's plants are all far out (certified
# primal infeasible), the others' near the origin
FW2_X0 = np.array([[0.2, 0.0], [-0.3, 0.1], [5.0, 0.0], [6.0, 0.0]])
FW2_T = 3
FW2_KW = dict(check_infeasibility=True)


def scenario_inputs(B=SCEN_B, T=SCEN_T):
    rng = np.random.RandomState(3)
    return (np.array([[1.0, 0.0]]) + 0.2 * rng.randn(B, 2),
            0.02 * rng.randn(T, B, 2))


def _problems():
    from reluqp_tpu_torch.utils import problems
    return problems


# --------------------------------------------------------------------- #
# helpers                                                               #
# --------------------------------------------------------------------- #

def _np(a):
    import torch
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def _result(res):
    """A solve's results as arrays."""
    i = res.info
    return dict(x=_np(res.x), z=_np(res.z), lam=_np(res.lam),
                iter=np.asarray(i.iter), status=np.asarray(i.status_code),
                rho_ind=np.asarray(i.rho_ind),
                n_iter=np.asarray(i.n_iter_total))


class Counter:
    """Counts (and orders) the collectives the package calls, by wrapping
    ``torch.distributed``'s functions."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor")

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.calls, self.orig = dist, [], {}

    def __enter__(self):
        for name in self.NAMES:
            fn = self.orig[name] = getattr(self.dist, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t = a[1] if _name != "all_reduce" else a[0]
                self.calls.append((_name, int(t.numel())))
                return _fn(*a, **kw)
            setattr(self.dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)

    def count(self, kind):
        return sum(1 for n, _ in self.calls
                   if (n == "all_reduce") == (kind == "reduce"))


# --------------------------------------------------------------------- #
# cases                                                                 #
# --------------------------------------------------------------------- #

def case_batched(ctx):
    """BatchedReLU_QP(mesh=) in fp64 ``"xla"``: shared batch in both ρ
    modes, hetero; then ``"auto"`` (K4's and K5's twins on the padded
    layout), fp64."""
    import reluqp_tpu_torch as T
    H, G, A, L, U = shared_batch()
    Hh, Gh, Ah, Lh, Uh = hetero_batch()
    out = {}
    runs = [("shared", (H, G, A, L, U), dict(rho_mode="shared")),
            ("per_problem", (H, G, A, L, U), dict(rho_mode="per_problem")),
            ("hetero", (Hh, Gh, Ah, Lh, Uh), {})]
    for backend in ("xla", "auto"):
        for name, data, kw in runs:
            if backend == "auto" and name == "per_problem":
                continue
            m = T.BatchedReLU_QP()
            m.setup(*data, mesh=ctx.mesh, device="cpu", backend=backend,
                    **kw, **F64)
            assert m.B_n == B_SHARED and m.B_local == B_SHARED // ctx.world
            r = _result(m.solve())
            assert r["x"].shape == (B_SHARED, NX)
            out.update({f"{backend}_{name}_{k}": v for k, v in r.items()})
            if backend == "auto":
                # K4 pads each rank's rows to 8; K5 takes them as they are
                pad = m.B_local if name == "hetero" else 8
                assert m.B_pad == pad and m.Dp == 128
            loc = m.local_rows(r["x"])
            per = B_SHARED // ctx.world
            np.testing.assert_array_equal(
                loc, r["x"][ctx.rank * per:(ctx.rank + 1) * per])
    return out


def case_sharded_shared(ctx):
    """``parallel.solve_sharded_shared`` on this rank's rows of an
    unsharded setup's arrays: the plain runner in fp64, and the bf16 bank
    with the two-phase refine and inert padding rows (``done0``)."""
    import torch
    import reluqp_tpu_torch as T
    from reluqp_tpu_torch.parallel import (replicate, shard_batch,
                                           solve_sharded_shared)
    out = {}
    H, G, A, L, U = shared_batch()
    for rho_mode in ("shared", "per_problem"):
        m = T.BatchedReLU_QP()
        m.setup(H, G, A, L, U, rho_mode=rho_mode, device="cpu",
                backend="xla", **F64)
        rho0 = m.rho_ind if rho_mode == "shared" else shard_batch(
            m.rho_ind, ctx.mesh)
        res = solve_sharded_shared(
            ctx.mesh, replicate(m.Wt_bank, ctx.mesh),
            _rows(m.bias_all, ctx, axis=1), m.rhos, m.H_dev, m.A_dev,
            shard_batch(m.G, ctx.mesh), shard_batch(m.lo, ctx.mesh),
            shard_batch(m.hi, ctx.mesh), shard_batch(m.Y, ctx.mesh), rho0,
            rho_mode=rho_mode, **m._solve_kw())
        out[f"{rho_mode}_Y"] = _np(res.Y)
        out[f"{rho_mode}_iters"] = _np(res.iters)
        out[f"{rho_mode}_status"] = _np(res.status)
        out[f"{rho_mode}_rho_ind"] = _np(res.rho_ind)
    # bf16 + refine + done0: 6 real rows padded to 8
    H, G, A, L, U = shared_batch(B=6)
    m = T.BatchedReLU_QP()
    m.setup(H, G, A, L, U, device="cpu", backend="xla", eps_abs=1e-4,
            iter_precision="bf16")
    assert m._Wt_hi is not None
    pad = lambda a, fill: torch.cat(
        [a, torch.full((2,) + tuple(a.shape[1:]), fill, dtype=a.dtype)])
    bias = torch.cat([m.bias_all, torch.zeros((m.bias_all.shape[0], 2,
                                               m.Dp))], dim=1)
    done0 = torch.arange(8) >= 6
    res = solve_sharded_shared(
        ctx.mesh, m.Wt_bank, _rows(bias, ctx, axis=1), m.rhos, m.H_dev,
        m.A_dev, shard_batch(pad(m.G, 0.0), ctx.mesh),
        shard_batch(pad(m.lo, -float("inf")), ctx.mesh),
        shard_batch(pad(m.hi, float("inf")), ctx.mesh),
        shard_batch(torch.zeros((8, m.Dp)), ctx.mesh), m.rho_ind,
        done0=shard_batch(done0, ctx.mesh), Wt_bank_hi=m._Wt_hi,
        **m._solve_kw())
    out["bf16_Y"] = _np(res.Y)
    out["bf16_status"] = _np(res.status)
    out["bf16_iters"] = _np(res.iters)
    # the placement helpers: this rank's rows of a global array and back
    from reluqp_tpu_torch.parallel import (host_replicated, local_axis,
                                           process_local_batch)
    glob = torch.arange(8 * 3, dtype=torch.float64).reshape(8, 3)
    mine = local_axis(glob, ctx.mesh)
    np.testing.assert_array_equal(mine, shard_batch(glob, ctx.mesh).numpy())
    np.testing.assert_array_equal(
        process_local_batch((8, 3), ctx.mesh, mine).numpy(), glob.numpy())
    np.testing.assert_array_equal(local_axis(glob.T, ctx.mesh, axis=1),
                                  mine.T)
    np.testing.assert_array_equal(host_replicated(replicate(glob, ctx.mesh)),
                                  glob.numpy())
    return out


def _rows(t, ctx, axis=0):
    per = t.shape[axis] // ctx.world
    return t.narrow(axis, ctx.rank * per, per).contiguous()


def case_refusals(ctx):
    """The errors of the multi-device paths, raised on every rank alike."""
    import pytest
    import torch
    import reluqp_tpu_torch as T
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    from reluqp_tpu_torch.parallel import (make_mesh, shard_batch,
                                           solve_sharded_shared)
    import reluqp_tpu_torch.models.mpc as TM
    n = ctx.world + 1
    H, G, A, L, U = shared_batch(B=n)
    with pytest.raises(ValueError, match="not divisible"):
        T.BatchedReLU_QP().setup(H, G, A, L, U, mesh=ctx.mesh, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(torch.zeros((n, 3)), ctx.mesh)
    m = T.BatchedReLU_QP()
    m.setup(H, G, A, L, U, device="cpu", backend="xla", **F64)
    rows = 2 if ctx.rank == 0 else 1   # unequal shards
    with pytest.raises(ValueError, match="not divisible"):
        solve_sharded_shared(ctx.mesh, m.Wt_bank, m.bias_all[:, :rows],
                             m.rhos, m.H_dev, m.A_dev, m.G[:rows],
                             m.lo[:rows], m.hi[:rows], m.Y[:rows],
                             m.rho_ind, **m._solve_kw())
    with pytest.raises(ValueError, match="one device per process"):
        make_mesh(ctx.world + 1, device="cpu")
    prob = scenario_problem(TM)
    X0, _ = scenario_inputs(B=ctx.world)
    m = _scenario_solver(T, prob, ctx.world, mesh=ctx.mesh)
    with pytest.raises(ValueError, match="no mesh"):
        scenario_rollout_scan(m, prob, X0, 2, kernel="scan")
    for backend in ("pallas", "fused"):
        qp = tp_problem()
        with pytest.raises(ValueError, match="'auto'/'xla' only"):
            T.ReLU_QP().setup(qp.H, qp.g, qp.A, qp.l, qp.u, device="cpu",
                              mesh=ctx.tp_mesh, backend=backend)
    return {"ok": np.ones(1)}


def case_guard(ctx):
    """The collectives of one solve: per check window two all-reduces in
    the shared ρ mode, one per problem; one all-gather (the results), after
    the loop; none in the loop."""
    import reluqp_tpu_torch as T
    H, G, A, L, U = shared_batch()
    out = {}
    for rho_mode in ("shared", "per_problem"):
        m = T.BatchedReLU_QP()
        m.setup(H, G, A, L, U, rho_mode=rho_mode, mesh=ctx.mesh,
                device="cpu", backend="xla", **F64)
        with Counter() as c:
            res = m.solve()
        windows = -(-res.info.n_iter_total // m.settings.check_interval)
        out[f"{rho_mode}_reduce"] = np.asarray(c.count("reduce"))
        out[f"{rho_mode}_gather"] = np.asarray(c.count("gather"))
        out[f"{rho_mode}_windows"] = np.asarray(windows)
        out[f"{rho_mode}_last"] = np.asarray(c.calls[-1][0] != "all_reduce")
        out[f"{rho_mode}_sizes"] = np.asarray([s for _, s in c.calls])
    return out


def _scenario_solver(T, prob, B, **kw):
    m = T.BatchedReLU_QP()
    m.setup(prob.H, np.tile(prob.g0, (B, 1)), prob.A,
            np.tile(prob.l0, (B, 1)), np.tile(prob.u0, (B, 1)),
            device="cpu", **dict(dict(backend="xla", **F64), **kw))
    return m


def case_scenario(ctx):
    """The scenario loop rollout on a mesh'd batch solver ("xla" and the
    padded "auto" layout, fp64), the whole ensemble gathered."""
    import reluqp_tpu_torch as T
    import reluqp_tpu_torch.models.mpc as TM
    prob = scenario_problem(TM)
    X0, W = scenario_inputs()
    out = {}
    for backend in ("xla", "auto"):
        m = _scenario_solver(T, prob, SCEN_B, mesh=ctx.mesh, backend=backend)
        xs, us, its, st, Y, r = TM.scenario_rollout_scan(
            m, prob, X0, SCEN_T, noise=W, kernel="auto", return_stats=True,
            return_state=True)
        assert xs.shape == (SCEN_T + 1, SCEN_B, 2) and Y.shape[0] == m.B_pad
        out.update({f"{backend}_xs": _np(xs), f"{backend}_us": _np(us),
                    f"{backend}_its": its.numpy(),
                    f"{backend}_status": st.numpy(),
                    f"{backend}_rho": np.asarray(r)})
    return out


def case_scenario_fw2(ctx):
    """The status lane over a mesh (F-w2): rank 1's scenarios are all
    primal infeasible (its own min reads 2), the lane is the min over
    every rank's (1), on every rank."""
    import reluqp_tpu_torch as T
    import reluqp_tpu_torch.models.mpc as TM
    prob = scenario_problem(TM, state_row=True)
    B = FW2_X0.shape[0]
    m = _scenario_solver(T, prob, B, mesh=ctx.mesh, **FW2_KW)
    m.update(g=prob.g0[None] + FW2_X0 @ prob.g_x0.T,
             l=prob.l0[None] + FW2_X0 @ prob.lu_x0.T,
             u=prob.u0[None] + FW2_X0 @ prob.lu_x0.T)
    r = m.solve()
    m.clear_primal_dual()
    xs, us, its, st = TM.scenario_rollout_scan(m, prob, FW2_X0, FW2_T,
                                               return_stats=True)
    return dict(solve_status=r.info.status_code, solve_iter=r.info.iter,
                its=its.numpy(), status=st.numpy(), xs=_np(xs))


# the tensor-parallel runs: name, rand_qp seed, settings (fp64 but the bf16
# bank, whose state is fp32)
TP_RUNS = (("plain", 3, dict(eps_abs=1e-5, precision="float64")),
           ("warm", 11, dict(eps_abs=1e-4, precision="float64")),
           ("alpha", 11, dict(alpha=1.6, eps_abs=1e-4, precision="float64")),
           ("bf16", 5, dict(iter_precision="bf16", refine=True,
                            eps_abs=1e-4)))


def case_tp(ctx):
    """``ReLU_QP.setup(mesh=)``: the tensor-parallel solve cold, after
    ``update(g)`` + warm start, with ``alpha`` = 1.6 and with the bf16 bank
    + refine; its block shapes and the gathers of one solve."""
    import torch
    import reluqp_tpu_torch as T
    from reluqp_tpu_torch.parallel import tp_pad_dim
    out = {}
    for name, seed, kw in TP_RUNS:
        qp = tp_problem(seed=seed)
        m = T.ReLU_QP()
        m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, mesh=ctx.tp_mesh,
                device="cpu", backend="xla", **kw)
        n_rho = len(m.rhos_np)
        assert m.Dp == tp_pad_dim(m.D, ctx.world, 8)
        assert tuple(m.bank.W.shape) == (n_rho, m.Dp, m.Dp // ctx.world)
        if name == "bf16":
            assert m.bank.W.dtype == torch.bfloat16
            assert tuple(m._W_hi.shape) == (n_rho, m.Dp, m.Dp // ctx.world)
        with Counter() as c:
            r = m.solve()
        if name == "plain":
            # parallel.solve_loop_tp on the solver's operands: the same solve
            from reluqp_tpu_torch.core.ladder import initial_rho_index
            from reluqp_tpu_torch.parallel import solve_loop_tp
            stng = m.settings
            r0 = initial_rho_index(m.rhos_np, stng.rho)
            res = solve_loop_tp(
                m.bank, m.qp_dev, torch.zeros_like(m.y), r0,
                float(m.rhos_np[r0]), group=m._tp_group, nx=m.nx,
                nc=m.nc, max_iter=stng.max_iter,
                check_interval=stng.check_interval, adaptive_rho=True,
                adaptive_rho_tolerance=float(stng.adaptive_rho_tolerance),
                eps_abs=float(stng.eps_abs), rho_min=float(stng.rho_min),
                rho_max=float(stng.rho_max))
            out["loop_tp_iter"] = np.asarray(res.iters)
            out["loop_tp_status"] = np.asarray(res.status_code)
        out[f"{name}_gathers"] = np.asarray(c.count("gather"))
        out[f"{name}_reduces"] = np.asarray(c.count("reduce"))
        out[f"{name}_sizes"] = np.asarray([s for _, s in c.calls])
        out[f"{name}_dp"] = np.asarray(m.Dp)
        if name == "warm":
            out["warm_cold_iter"] = np.asarray(r.info.iter)
            m.update(g=qp.g * 1.002)
            m.warm_start(x=_np(r.x), z=_np(r.z), lam=_np(r.lam))
            r = m.solve()
        out[f"{name}_x"] = _np(r.x)
        out[f"{name}_lam"] = _np(r.lam)
        out[f"{name}_iter"] = np.asarray(r.info.iter)
        out[f"{name}_status"] = np.asarray(r.info.status == "solved")
        out[f"{name}_rho_ind"] = np.asarray(m.rho_ind)
    return out


def case_process_local(ctx, mode):
    """``setup(process_local=True)``: this rank's rows of a global batch;
    the solve against the fp64 oracle, ``objective``, ``update(g)``,
    ``update_matrices(H)``, a shard-file checkpoint and its restore onto
    the same layout."""
    import reluqp_tpu_torch as T
    from reluqp_tpu_torch.utils.checkpoint import (load_batched_solver,
                                                   save_batched_solver)
    from reluqp_tpu_torch.utils.problems import solve_qp_oracle
    P = _problems()
    rank, world = ctx.rank, ctx.world
    Hs, G, As, L, U = local_problems(mode, rank, problems=P)
    hetero = mode != "shared"
    H_of = (lambda H, i: H[i]) if hetero else (lambda H, i: H)
    A_of = (lambda i: As[i]) if hetero else (lambda i: As)
    m = T.BatchedReLU_QP()
    m.setup(Hs, G, As, L, U, mesh=ctx.mesh, process_local=True,
            device="cpu", backend="auto", eps_abs=1e-6, scaling=True,
            scaled_termination=True, precision="float64")
    B_g = B_LOCAL * world
    assert m.B_n == B_g and m.B_local == B_LOCAL
    res = m.solve()
    assert res.info.status.shape == (B_g,) and res.info.status.all()

    def check(x_loc, H, Gv, tol=2e-4):
        for i in range(B_LOCAL):
            x_star = solve_qp_oracle(H_of(H, i), Gv[i], A_of(i), L[i], U[i])
            err = float(np.max(np.abs(x_loc[i] - x_star)))
            assert err < tol, (mode, rank, i, err)

    x_loc = m.local_rows(res.x)
    check(x_loc, Hs, G)
    obj = m.objective()
    assert obj.shape == (B_g,)
    for i in range(B_LOCAL):
        direct = 0.5 * x_loc[i] @ H_of(Hs, i) @ x_loc[i] + G[i] @ x_loc[i]
        assert abs(obj[rank * B_LOCAL + i] - direct) < \
            1e-5 * max(1.0, abs(direct)), (i, obj[rank * B_LOCAL + i], direct)
    H2, G2, _, _, _ = local_problems(mode, rank, updated=True, problems=P)
    m.update(g=G2)
    r2 = m.solve()
    assert r2.info.status.all()
    check(m.local_rows(r2.x), Hs, G2)
    m.update_matrices(H=H2)
    r3 = m.solve()
    assert r3.info.status.all()
    check(m.local_rows(r3.x), H2, G2)
    ckpt = os.path.join(ctx.outdir, f"ckpt_{mode}")
    save_batched_solver(m, ckpt)
    assert os.path.exists(f"{ckpt}.proc{rank}of{world}.npz")
    m4 = load_batched_solver(ckpt, mesh=ctx.mesh, device="cpu")
    assert m4.B_n == B_g and m4._process_local
    r4, r5 = m4.solve(), m.solve()
    check(m4.local_rows(r4.x), H2, G2)
    # the restored solver and the original, from the same state: the same
    # solve
    np.testing.assert_array_equal(_np(r4.x), _np(r5.x))
    np.testing.assert_array_equal(r4.info.iter, r5.info.iter)
    return {"x": _np(r3.x), "status": r3.info.status_code,
            "obj": obj, "x4": _np(r4.x), "iter4": r4.info.iter}


def case_process_local_shared(ctx):
    return case_process_local(ctx, "shared")


def case_process_local_hetero(ctx):
    return case_process_local(ctx, "hetero")


def spawn(world, cases, outdir, timeout=180):
    """Start ``world`` worker ranks running ``cases``; returns a callable
    that waits for them (killing every rank after ``timeout`` seconds),
    checks each rank's exit code and CASE_OK lines, and returns
    ``{case: [rank 0's arrays, rank 1's, ...]}``."""
    import socket
    import subprocess
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(outdir), str(r),
         str(world), str(port), *cases], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]

    def wait():
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{out}"
            for case in cases:
                assert f"CASE_OK {case} {r}" in out, out
        res = {}
        for case in cases:
            res[case] = []
            for r in range(world):
                with np.load(os.path.join(str(outdir),
                                          f"{case}.rank{r}.npz")) as z:
                    res[case].append({k: z[k] for k in z.files})
        return res
    return wait


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_") and name != "case_process_local"}


class Ctx:
    def __init__(self, outdir, rank, world):
        from reluqp_tpu_torch.parallel import make_mesh
        self.outdir, self.rank, self.world = outdir, rank, world
        self.mesh = make_mesh(world, axis_name="qp", device="cpu")
        self.tp_mesh = make_mesh(world, axis_name="tp", device="cpu")


def main(argv):
    outdir, rank, world, port = argv[0], int(argv[1]), int(argv[2]), argv[3]
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(1)
    from reluqp_tpu_torch.parallel import init_distributed
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    ctx = Ctx(outdir, rank, world)
    for case in argv[4:]:
        out = CASES[case](ctx)
        np.savez(os.path.join(outdir, f"{case}.rank{rank}.npz"), **out)
        print(f"CASE_OK {case} {rank}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
