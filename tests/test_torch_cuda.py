"""Tests of the PyTorch port that need an NVIDIA GPU.

Kernels K1 to K6, C1 and C2 are CUDA code with no CPU mode, so these
skip without a GPU. On the GPU machine (which has no JAX) run them without the
JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package.
"""
import numpy as np
import pytest
import torch

import reluqp_tpu_torch as rqt
import reluqp_tpu_torch.ops.solve_kernel as TSK
from reluqp_tpu_torch.models import mpc
from reluqp_tpu_torch.ops.fused_step import (fused_chunk,
                                             fused_chunk_batched,
                                             fused_chunk_batched_ref,
                                             fused_chunk_hetero,
                                             fused_chunk_hetero_ref,
                                             fused_chunk_ref, hetero_plan,
                                             kernel_plan, pad_dim,
                                             pallas_chunk_runner)
from reluqp_tpu_torch.ops.solve_kernel import (full_rollout,
                                               full_rollout_batched,
                                               full_rollout_batched_ref,
                                               full_rollout_ref, full_solve,
                                               full_solve_ref,
                                               k2_stage_split,
                                               k6_stage_split, k6_steps,
                                               rollout_batched_plan,
                                               rollout_plan, solve_plan)
from reluqp_tpu_torch.utils.problems import canonical_qp, rand_qp, update_qp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 to K6 are CUDA kernels with "
                    "no CPU mode")
    return torch.device("cuda")


def _inputs(dp, dev, rows=1, n_rho=4, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    wt = rn(n_rho, dp, dp) * (0.7 / dp ** 0.5)
    lo = torch.full((rows, dp), -0.8, device=dev)
    return wt, 0.1 * rn(rows, dp), lo, -lo, 0.5 * rn(rows, dp)


# Kernel and plain version sum in different orders (fp32 rounding only);
# the bf16 tier re-rounds y every step, so one flipped rounding moves a
# lane by a bf16 ulp that later steps carry on.
@pytest.mark.parametrize("dp", [128, 640, 896])
def test_k1_matches_plain_version(dev, dp):
    wt, b, lo, hi, y = _inputs(dp, dev)
    rho = torch.tensor([3], dtype=torch.int32, device=dev)
    for tier, tol in (("highest", 1e-5), ("high", 1e-5), ("bf16", 3e-2)):
        before = fused_chunk.launches
        out = fused_chunk(wt, b, lo, hi, y, rho, 25, tier)
        assert fused_chunk.launches == before + 1
        ref = fused_chunk_ref(wt, b, lo, hi, y, rho, 25, tier)
        assert out.data_ptr() not in (y.data_ptr(), ref.data_ptr())
        assert float((out - ref).abs().max()) <= tol, tier


# R rows on one rung, a split slab (Dp=1024: shared memory and registers)
# and Dp=4096 (its rows after the registers' read from L2), in windows of
# 25 iterations and of one (K1's own one-step kernel)
@pytest.mark.parametrize("rows,dp", [(3, 1024), (1, 4096)])
def test_k1_rows_and_wide_slabs_match_plain_version(dev, rows, dp):
    wt, b, lo, hi, y = _inputs(dp, dev, rows=rows, seed=dp)
    rho = torch.tensor([2], dtype=torch.int32, device=dev)
    for n in (25, 1):
        out = fused_chunk(wt, b, lo, hi, y, rho, n, "highest")
        ref = fused_chunk_ref(wt, b, lo, hi, y, rho, n, "highest")
        assert float((out - ref).abs().max()) <= 1e-5, (rows, dp, n)


def test_k1_plan_by_shape(dev):
    """One cluster per row for the window, no grid barrier; the slab in
    registers (Dp=128), split between shared memory and registers
    (Dp=640, 1024) and with the rest from L2 (Dp=4096); a one-iteration
    window on independent blocks."""
    small, mid, big, wide = (kernel_plan(1, dp) for dp in (128, 640, 1024,
                                                          4096))
    assert small["slab"] == "registers" and small["smem_rows"] == 0
    for p in (mid, big):
        assert p["slab"] == "smem+registers" and p["cluster"] == 16
        assert p["smem_rows"] + p["regs_rows"] * p["stretches"] >= \
            p["cols_per_block"] * p["cluster"]
    assert wide["slab"] == "smem+registers+L2"
    for p in (small, mid, big, wide):
        assert p["grid_barriers_per_window"] == 0 and not p["direct"]
        assert p["blocks"] == p["cluster"] and p["cluster"] <= 16
    three = kernel_plan(3, 1024)
    assert three["blocks"] == 3 * three["cluster"]
    one = kernel_plan(1, 640, n_steps=1)
    assert one["direct"] and one["slab"] == "L2"
    assert one["blocks"] * one["cols_per_block"] == 640


def test_k1_wrapper_rejects_what_the_kernel_does_not_take(dev):
    wt, b, lo, hi, y = _inputs(128, dev, rows=2)
    rho = torch.tensor([0], dtype=torch.int32, device=dev)
    bad = [
        (wt, b, lo, hi, y[:, :64], rho),                  # strided view
        (wt, b, lo, hi, y.t().contiguous().t(), rho),     # column-major
        (wt, b, lo, hi, y, rho.long()),                   # index dtype
        (wt, b.double(), lo, hi, y, rho),                 # mixed dtypes
        (wt.cpu(), b, lo, hi, y, rho),                    # mixed devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fused_chunk(*args, 5)


def test_solver_on_cuda_runs_k1(dev):
    qp = canonical_qp()
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4)
    assert m.settings.device.type == "cuda"
    assert m._chunk_runner is pallas_chunk_runner
    before = fused_chunk.launches
    res = m.solve()
    assert fused_chunk.launches > before
    assert res.info.status == "solved" and res.x.is_cuda
    np.testing.assert_allclose(res.x.cpu().double().numpy(), qp.x_sol,
                               atol=1e-3)
    # the plain runner on the card gives the same answer without K1
    x = rqt.ReLU_QP()
    x.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4, backend="xla")
    before = fused_chunk.launches
    rx = x.solve()
    assert fused_chunk.launches == before
    assert rx.info.iter == res.info.iter
    torch.testing.assert_close(rx.x, res.x, rtol=0, atol=1e-5)


def test_mpc_rollout_on_cuda_matches_cpu(dev):
    Ad, Bd = mpc.double_integrator(dt=0.1)
    kw = dict(horizon=5, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
              precision="float64")
    Q, R = np.diag([10.0, 1.0]), np.array([[0.1]])
    g = mpc.MPC(Ad, Bd, Q, R, **kw)
    c = mpc.MPC(Ad, Bd, Q, R, device="cpu", **kw)
    x0 = np.array([1.0, -0.5])
    before = fused_chunk.launches
    xg, ug, ig = mpc.mpc_rollout_scan(g.solver, g.prob, x0, 15,
                                      check_interval="auto")
    assert fused_chunk.launches > before and xg.is_cuda
    xc, uc, ic = mpc.mpc_rollout_scan(c.solver, c.prob, x0, 15,
                                      check_interval="auto")
    np.testing.assert_array_equal(ig.numpy(), ic.numpy())
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=1e-8)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=1e-8)


def _di_mpc(dev, precision, **kw):
    Ad, Bd = mpc.double_integrator(dt=0.1)
    base = dict(horizon=8, u_min=-1.0, u_max=1.0, eps_abs=1e-6,
                precision=precision)
    base.update(kw)
    return mpc.MPC(Ad, Bd, np.diag([10.0, 1.0]), np.array([[0.1]]),
                   device=dev, **base)


def _k2_args(ctrl, T, noise_scale, seed=0):
    """K2's call for a controller as the scan path makes it: a cold start
    from x0 = [1, 0], numpy noise, a window of 5."""
    s = ctrl.solver
    noise = noise_scale * np.random.RandomState(seed).randn(T, 2)
    return mpc._scan_call(s, ctrl.prob, [1.0, 0.0], T, ci=5,
                          y0=torch.zeros_like(s.y), noise=noise)


# fp64: kernel and plain version round the same fp64 sums to fp32 and
# differ only in the order of those sums.
def test_k2_matches_plain_version_fp64(dev):
    ctrl = _di_mpc(dev, "float64", eps_abs=1e-5)
    args, kw = _k2_args(ctrl, 20, 0.3)
    before = full_rollout.launches
    out = full_rollout(*args, **kw)
    assert full_rollout.launches == before + 1
    ref = full_rollout_ref(*args, **kw)
    for lane in (0, 4, 5):
        assert torch.equal(out[2][:, lane], ref[2][:, lane]), lane
    assert len(set(out[2][:, 4].tolist())) > 1, "the rung never moved"
    for a, b in zip(out[:2], ref[:2]):
        assert float((a - b).abs().max()) <= 1e-9
    assert float(out[3][ctrl.solver.D:].abs().max()) == 0.0


# Each iteration tier in fp32 on the 100-state h10 configuration (Dp=640)
# from a cold disturbed start: kernel and plain version take the same
# iterations, status and rung, and agree to a few times their fp32 summation
# order difference — far below what a tier run at another precision (one
# bf16 pass for "high", unrounded y for "bf16") would move. bf16 iterates
# do not reach eps, so that tier runs 3 budget-bound steps.
def _plant_k2_args(T, horizon=10, max_iter=None, precision="float32"):
    """K2's call for bench.py's 100-state plant at ``horizon`` (Dp=640 at
    10, 1280 at 20) from a cold start under a 0.3·randn disturbance, a
    window of 5; returns the controller too."""
    Ad, Bd = mpc.random_linear_system(100, 20, seed=0, spectral_radius=0.99)
    ctrl = mpc.MPC(Ad, Bd, np.eye(100), 0.1 * np.eye(20), horizon=horizon,
                   u_min=-1.0, u_max=1.0, prestabilize=True, eps_abs=1e-3,
                   max_iter=2000, precision=precision)
    s = ctrl.solver
    noise = 0.3 * np.random.RandomState(3).randn(T, 100)
    x0 = 0.05 * np.random.RandomState(0).randn(100)
    args, kw = mpc._scan_call(s, ctrl.prob, x0, T, ci=5, budget=max_iter,
                              y0=torch.zeros_like(s.y), noise=noise)
    return ctrl, args, kw


def _k2_agrees(args, kw, tol, D):
    """K2 against its plain version: equal per-step iterations, rung and
    status, trajectories within ``tol``, padded y lanes exactly 0."""
    out = full_rollout(*args, **kw)
    ref = full_rollout_ref(*args, **kw)
    for lane in (0, 4, 5):
        assert torch.equal(out[2][:, lane], ref[2][:, lane]), lane
    for a, b in zip(out[:2], ref[:2]):
        assert float((a - b).abs().max()) <= tol
    assert float(out[3][D:].abs().max()) == 0.0
    return out


@pytest.mark.parametrize("tier,T,max_iter,tol", [
    ("highest", 20, None, 1e-5), ("high", 20, None, 2e-5),
    ("bf16", 3, 25, 1e-5)])
def test_k2_tier_matches_plain_version_fp32(dev, tier, T, max_iter, tol):
    ctrl, args, kw = _plant_k2_args(T, max_iter=max_iter)
    if tier == "bf16":
        args[0] = args[0].to(torch.bfloat16)
    kw["iter_precision"] = tier
    _k2_agrees(args, kw, tol, ctrl.solver.D)


# Dp=1280 (horizon 20), fp64: the operand slabs no longer fit shared
# memory beside the state and are read from L2; K2 still takes its plain
# version's iterations, rungs and status, within the fp32 ulps of its
# fp32-rounded products (as in fp64 at Dp=640, chip_smoke.py's K2_TOL64)
def test_k2_matches_plain_version_streamed(dev):
    ctrl, args, kw = _plant_k2_args(8, horizon=20, precision="float64")
    plan = rollout_plan(args[0].shape[1], kw["nxp"], kw["ncp"], kw["nup"],
                        kw["nplp"], args[0].shape[0], torch.float64)
    assert not plan["resident"]
    _k2_agrees(args, kw, 1e-6, ctrl.solver.D)


# K2's exchanges are tagged words in two slots a kind (y; the checks'
# partials with u; x+), with no grid barrier inside a step. What moves
# them, each against the plain twin as above: rung changes inside one
# launch (Dp=640, fp32: y and the partials on the rounds path); steps of
# three windows that end at MAX_ITER; T >= 6 steps, so the tags of every
# slot wrap (x+ takes tags 1, 1, 2, 2, 1, 1, ...); Dp=256, where y and x+
# are polled one value a thread; fp64, two words a value.
@pytest.mark.parametrize("case,T,kw,tol", [
    ("rung changes, Dp=640", 20, {}, 1e-5),
    ("MAX_ITER windows, Dp=640", 8, dict(max_iter=15), 1e-5),
    ("one value a thread, Dp=256", 8, dict(horizon=3), 1e-5),
    ("fp64, Dp=640", 8, dict(precision="float64"), 1e-6)])
def test_k2_exchange_matches_plain_version(dev, case, T, kw, tol):
    ctrl, args, call = _plant_k2_args(T, **kw)
    out = _k2_agrees(args, call, tol, ctrl.solver.D)
    st = out[2].cpu().numpy()
    assert st.shape[0] == T >= 6
    assert len(set(st[:, 4].tolist())) > 1, "the rung never moved"
    if "max_iter" in kw:
        hit = st[:, 5] == 0
        assert hit.any() and (st[hit, 0] == 15).all()
    assert ctrl.solver.Dp == (256 if "horizon" in kw else 640)


def test_k2_plan_reports_the_tagged_exchange(dev):
    for dtype, n_w in ((torch.float32, 1), (torch.float64, 2)):
        p = rollout_plan(640, 256, 256, 128, 128, 18, dtype)
        words = 2 * (640 + p["blocks"] * 8 + 128 + 128) * n_w
        assert p["exchange"] == "tagged words"
        assert p["words_per_value"] == n_w and p["scratch_bytes"] == 8 * words


# One grid barrier per launch (before its first exchange) and none in a
# step, as the kernel's stamps count block 0's barriers; the stamps change
# no output.
def test_k2_takes_one_grid_barrier_per_launch(dev):
    ctrl, args, kw = _plant_k2_args(6)
    ref = full_rollout(*args, **kw)
    got = {}

    def run():
        got["out"] = full_rollout(*args, **kw)

    split = k2_stage_split(run, reps=2)
    assert split["steps"] == 6
    assert split["barriers_per_launch"] == 1
    assert split["barriers_per_warm_step"] == 0
    assert full_rollout.stamps is None
    for a, b in zip(ref, got["out"]):
        assert torch.equal(a, b)


def test_k2_wrapper_rejects_what_the_kernel_does_not_take(dev):
    ctrl = _di_mpc(dev, "float32", eps_abs=1e-4)
    args, kw = _k2_args(ctrl, 3, 0.0)
    for i, bad in ((11, args[11].double()),           # state dtype mix
                   (12, args[12].cpu()),              # device mix
                   (9, args[9].t().contiguous().t())):  # column-major
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            full_rollout(*broken, **kw)
    with pytest.raises(ValueError):
        full_rollout(*args, **dict(kw, max_iter=2001))


def test_mpc_scan_rollout_on_cuda_runs_k2(dev):
    g = _di_mpc(dev, "float64")
    c = _di_mpc("cpu", "float64")
    x0 = np.array([1.0, -0.5])
    k1, k2 = fused_chunk.launches, full_rollout.launches
    xg, ug, ig = mpc.mpc_rollout_scan(g.solver, g.prob, x0, 15,
                                      kernel="auto", check_interval="auto")
    assert full_rollout.launches == k2 + 2 and fused_chunk.launches == k1
    xc, uc, ic = mpc.mpc_rollout_scan(c.solver, c.prob, x0, 15,
                                      kernel="scan", check_interval="auto")
    np.testing.assert_array_equal(ig.numpy(), ic.numpy())
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=1e-9)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=1e-9)


PINF = (np.eye(2), np.zeros(2), np.array([[1.0, 0.0], [1.0, 0.0],
                                          [0.0, 1.0]]),
        np.array([1.0, -np.inf, -1.0]), np.array([np.inf, -1.0, 1.0]))


# K3 and its plain version on one cold solve of a set-up fused solver:
# the same iterations, rung, status and reduced-phase count, and y within
# a few fp32 roundings of the summation order (relative to |y|inf; fp64
# rounds the same fp64 sums to fp32, so 1e-6 there too).
# (The solver's bf16 tier polishes on its bf16 bank, as the JAX package's
# fused backend does, and need not certify: no status is asked of the tiers.)
@pytest.mark.parametrize("name,data,kw,status", [
    ("highest", "rand", dict(precision="float32"), None),
    ("high", "rand", dict(precision="float32", iter_precision="high"), None),
    ("default", "rand", dict(precision="float32", iter_precision="default"),
     None),
    ("bf16", "rand", dict(precision="float32", iter_precision="bf16"), None),
    ("alpha", "rand", dict(precision="float64", alpha=1.6, eps_abs=1e-5), 1),
    ("certificates", "pinf", dict(precision="float64",
                                  check_infeasibility=True), 2),
])
def test_k3_matches_plain_version(dev, name, data, kw, status):
    data = PINF if data == "pinf" else \
        rand_qp(60, 15, 15, seed=2, compute_sol=False)[:5]
    m = rqt.ReLU_QP()
    m.setup(*data, backend="fused", **dict(dict(eps_abs=1e-4), **kw))
    op, call = m._fused_call()
    y0 = torch.zeros_like(m.y)
    before = full_solve.launches
    out = full_solve(op, y0, m.rho_ind, **call)
    assert full_solve.launches == before + 1
    ref = full_solve_ref(op, y0, m.rho_ind, **call)
    so, sr = out[1].cpu(), ref[1].cpu()
    for lane in (0, 4, 5, 6):
        assert so[lane] == sr[lane], (lane, so, sr)
    assert status is None or so[5] == status
    tol = 1e-4 if m.settings.precision == "float32" else 1e-6
    scale = max(1.0, float(ref[0].abs().max()))
    assert float((out[0] - ref[0]).abs().max()) <= tol * scale
    assert float(out[0][m.D:].abs().max()) == 0.0


def test_k3_plan_by_shape(dev):
    """One persistent block per SM on the cooperative grid; every slab in
    shared memory at the protocol's nx=100 shape, staged with cp.async;
    the exchange in tagged words, one a value in fp32 and two in fp64; a
    bf16 bank's slab staged through registers; fp64 slabs at Dp=1280 read
    from L2 (nothing staged)."""
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = solve_plan(256, 128, 128)
    assert plan["blocks"] == n_sm and plan["resident"]
    assert plan["cols_per_block"] * plan["blocks"] >= 256
    assert plan["staging"] == "cp.async", plan
    assert plan["exchange"] == "tagged words" and plan["words_per_value"] == 1
    assert solve_plan(256, 128, 128, torch.float64)["words_per_value"] == 2
    assert solve_plan(256, 128, 128,
                      w_dtype=torch.bfloat16)["staging"] == "loads"
    wide = solve_plan(1280, 640, 256, torch.float64)
    assert not wide["resident"] and wide["staging"] == "none", wide


# Every branch of K3's plan against its plain version, bit for bit: fp32
# (one word a value), fp64 (two), a bf16 bank (its slab through registers)
# and fp64 at Dp=1280 (the slabs read from L2).
@pytest.mark.parametrize("name,nx,kw", [
    ("fp32", 60, dict(precision="float32")),
    ("fp64", 60, dict(precision="float64")),
    ("bf16 bank", 60, dict(precision="float32", iter_precision="bf16")),
    ("fp64 from L2", 640, dict(precision="float64", scaling=True)),
])
def test_k3_plan_branches_are_bit_equal_to_plain(dev, name, nx, kw):
    data = rand_qp(nx, nx // 4, nx // 4, seed=1, compute_sol=False)[:5]
    m = rqt.ReLU_QP()
    m.setup(*data, backend="fused", eps_abs=1e-4, **kw)
    op, call = m._fused_call()
    plan = solve_plan(m.Dp, m._nxp, m._ncp, m.settings.precision_dtype,
                      w_dtype=op.Wt_bank.dtype)
    want = {"fp32": "cp.async", "fp64": "cp.async", "bf16 bank": "loads",
            "fp64 from L2": "none"}[name]
    assert plan["staging"] == want, plan
    y0 = torch.zeros_like(m.y)
    out = full_solve(op, y0, m.rho_ind, **call)
    ref = full_solve_ref(op, y0, m.rho_ind, **call)
    assert torch.equal(out[1].cpu(), ref[1].cpu()), (out[1], ref[1])
    assert torch.equal(out[0], ref[0])


def test_k3_is_bit_equal_across_a_rung_change_at_dp1024(dev):
    """The reference protocol's nx=500 instance (Dp=1024, fp32), cold: the
    solve walks the ladder away from its start rung, and the kernel's
    outputs equal its plain version's bit for bit."""
    data = rand_qp(500, 125, 125, seed=0, compute_sol=False)[:5]
    m = rqt.ReLU_QP()
    m.setup(*data, backend="fused", precision="float32", eps_abs=1e-4,
            scaling=True)
    assert m.Dp == 1024
    op, call = m._fused_call()
    y0 = torch.zeros_like(m.y)
    rho0 = int(m.rho_ind)
    out = full_solve(op, y0, rho0, **call)
    ref = full_solve_ref(op, y0, rho0, **call)
    assert int(out[1][4]) != rho0, "the solve kept its start rung"
    assert torch.equal(out[1].cpu(), ref[1].cpu())
    assert torch.equal(out[0], ref[0])


def test_fused_backend_on_cuda_is_one_k3_launch(dev):
    qp = canonical_qp()
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4, backend="fused")
    k1, k3 = fused_chunk.launches, full_solve.launches
    res = m.solve()
    assert full_solve.launches == k3 + 1 and fused_chunk.launches == k1
    assert res.info.status == "solved" and res.x.is_cuda
    np.testing.assert_allclose(res.x.cpu().double().numpy(), qp.x_sol,
                               atol=1e-3)


def test_mpc_fused_rollout_on_cuda_matches_cpu(dev):
    g = _di_mpc(dev, "float64")
    c = _di_mpc("cpu", "float64")
    x0 = np.array([1.0, -0.5])
    k3 = full_solve.launches
    xg, ug, ig = mpc.mpc_rollout_scan(g.solver, g.prob, x0, 15,
                                      kernel="fused", check_interval=5)
    assert full_solve.launches == k3 + 15
    xc, uc, ic = mpc.mpc_rollout_scan(c.solver, c.prob, x0, 15,
                                      kernel="fused", check_interval=5)
    np.testing.assert_array_equal(ig.numpy(), ic.numpy())
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=1e-6)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=1e-6)


# K4 and its plain version sum each row in different orders (fp32 rounding
# only); the last 3 rows are inert (b = 0, +-inf bounds, y = 0) and stay 0.
@pytest.mark.parametrize("dp,rows", [(128, 8), (640, 64), (128, 10000),
                                     (128, 1003)])
def test_k4_matches_plain_version(dev, dp, rows):
    wt, b, lo, hi, y = _inputs(dp, dev, rows=rows)
    b[-3:], lo[-3:], hi[-3:], y[-3:] = 0.0, -float("inf"), float("inf"), 0.0
    rho = torch.tensor([2], dtype=torch.int32, device=dev)
    for tier, tol in (("highest", 1e-5), ("high", 1e-5), ("bf16", 3e-2)):
        bank = wt.to(torch.bfloat16) if tier == "bf16" else wt
        before = fused_chunk_batched.launches
        out = fused_chunk_batched(bank, b, lo, hi, y, rho, 25, tier)
        assert fused_chunk_batched.launches == before + 1
        ref = fused_chunk_batched_ref(bank, b, lo, hi, y, rho, 25, tier)
        assert out.data_ptr() not in (y.data_ptr(), ref.data_ptr())
        assert float((out - ref).abs().max()) <= tol, tier
        assert not out[-3:].any()


# Each output's sum runs over the inputs in an order fixed by Dp and the
# tier alone, so the rows of a smaller launch are bit-equal to the same
# rows of a larger one, whatever row tile they fall in.
@pytest.mark.parametrize("dp", [128, 640])
def test_k4_rows_are_independent_of_the_batch(dev, dp):
    wt, b, lo, hi, y = _inputs(dp, dev, rows=5000)
    rho = torch.tensor([1], dtype=torch.int32, device=dev)
    for tier in ("highest", "high"):
        full = fused_chunk_batched(wt, b, lo, hi, y, rho, 25, tier)
        for r in (1, 37, 1003):
            part = fused_chunk_batched(
                wt, *(t[:r].contiguous() for t in (b, lo, hi, y)), rho, 25,
                tier)
            assert torch.equal(part, full[:r]), (tier, r)


def _shared_batch(B=6, nx=30, seed=0):
    base = rand_qp(nx, nx // 4, nx // 4, seed=seed, compute_sol=False)
    insts = [update_qp(base.H, base.A, nx // 4, nx // 4, seed=seed + i,
                       compute_sol=False) for i in range(B)]
    return (base.H, np.stack([i.g for i in insts]), base.A,
            np.stack([i.l for i in insts]), np.stack([i.u for i in insts]))


def test_batched_solver_on_cuda_runs_k4(dev):
    data = _shared_batch()
    m = rqt.BatchedReLU_QP()
    m.setup(*data, eps_abs=1e-4)
    assert m.settings.device.type == "cuda" and m._use_pallas
    before = fused_chunk_batched.launches
    res = m.solve()
    assert fused_chunk_batched.launches > before
    assert res.info.status.all() and res.x.is_cuda
    c = rqt.BatchedReLU_QP()
    c.setup(*data, eps_abs=1e-6, precision="float64", device="cpu",
            backend="xla")
    rc = c.solve()
    np.testing.assert_allclose(res.x.cpu().double().numpy(), rc.x.numpy(),
                               atol=1e-3)
    assert not m.Y[m.B_n:].any() and not m.Y[:, m.D:].any()


def _scenario(system, device, precision, B):
    """A scenario batch solver on a condensed MPC QP, u in [-1, 1] per
    stage, and seeded initial states."""
    if system == "double_integrator":
        Ad, Bd = mpc.double_integrator(dt=0.1)
        Q, R, N = np.diag([10.0, 1.0]), np.array([[0.1]]), 8
    elif system == "random100":
        # the scenario cell's plant: Dp = 640
        Ad, Bd = mpc.random_linear_system(100, 20, seed=0,
                                          spectral_radius=0.99)
        Q, R, N = np.eye(100), 0.1 * np.eye(20), 10
    else:
        Ad, Bd = mpc.random_linear_system(20, 4, seed=0, spectral_radius=0.99)
        Q, R, N = np.eye(20), 0.1 * np.eye(4), 10
    nx, nu = Bd.shape
    K, Qf = mpc.ihlqr(Ad, Bd, Q, R)
    rows = np.zeros((N * nu, N * (nx + nu)))
    for k in range(N):
        rows[k * nu:(k + 1) * nu, k * (nx + nu):k * (nx + nu) + nu] = \
            np.eye(nu)
    prob = mpc.gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, N, rows,
                                    -np.ones(N * nu), np.ones(N * nu), K=K)
    m = rqt.BatchedReLU_QP()
    m.setup(prob.H, np.tile(prob.g0, (B, 1)), prob.A,
            np.tile(prob.l0, (B, 1)), np.tile(prob.u0, (B, 1)),
            eps_abs=1e-5, precision=precision, device=device)
    rng = np.random.RandomState(3)
    x0 = np.zeros(nx)
    x0[0] = 1.0
    return m, prob, x0[None] + 0.2 * rng.randn(B, nx), rng


# K6 and its plain version round every product to fp32 and sum it in fp64
# in different orders: equal iterations, rung, status and unsolved rows
# per step, trajectories within a few fp32 ulps.
@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("system,B", [("double_integrator", 5),
                                      ("random", 24), ("random", 70)])
def test_k6_matches_plain_version(dev, system, B, precision):
    m, prob, X0, rng = _scenario(system, dev, precision, B)
    T = 12
    noise = 0.3 * rng.randn(T, B, X0.shape[1])
    args, kw = mpc._scenario_scan_call(m, prob, X0, T, ci=5,
                                       Y0=torch.zeros_like(m.Y), noise=noise)
    before = full_rollout_batched.launches
    out = full_rollout_batched(*args, **kw)
    assert full_rollout_batched.launches == before + 1
    ref = full_rollout_batched_ref(*args, **kw)
    for lane in (0, 3, 4, 5, 6):
        assert torch.equal(out[2][:, lane], ref[2][:, lane]), lane
    assert (out[2][:, 5] == 1).all()
    for a, b in zip(out[:2], ref[:2]):
        assert float((a - b).abs().max()) <= 1e-5
    assert not out[3][B:].any() and not out[3][:, m.D:].any()


# K6's stage stamps change no output; block 0 takes one grid barrier per
# check window, and its per-step stages add up to about its step.
def test_k6_stamps_change_no_output(dev):
    m, prob, X0, rng = _scenario("random", dev, "float32", 24)
    T = 6
    noise = 0.3 * rng.randn(T, 24, X0.shape[1])
    args, kw = mpc._scenario_scan_call(m, prob, X0, T, ci=5,
                                       Y0=torch.zeros_like(m.Y), noise=noise)
    ref = full_rollout_batched(*args, **kw)
    got = {}

    def run():
        got["out"] = full_rollout_batched(*args, **kw)

    split = k6_stage_split(run, reps=2)
    assert full_rollout_batched.stamps is None
    for a, b in zip(ref, got["out"]):
        assert torch.equal(a, b)
    windows = float(ref[2][:, 0].sum()) / 5
    assert split["steps"] == T and split["barriers_per_launch"] == windows
    per_step = sum(v for k, v in split.items() if k in (
        "refresh", "bias", "iteration", "exchange", "check", "reduced",
        "plant", "x exchange"))
    assert abs(per_step / split["step"] - 1.0) < 0.25


def _dense_steps(args):
    """K6Steps that give every column of ``_scenario_scan_call``'s operands
    all its inputs: the dense chains."""
    return k6_steps(*(torch.ones_like(args[i]) for i in (6, 2, 4, 9, 10)))


# K6 runs each once-a-step product's chain over the steps that hold its
# columns' nonzeros (k6_steps): the same bits as over every input, with the
# rung's slab in shared memory (B=24, Dp=128) and from L2 (B=256, Dp=640).
# A plant state of NaN changes only the products' padding lanes (NaN over
# every input, 0 over none) of its own row.
@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("system,B,in_smem", [("random", 24, True),
                                              ("random100", 256, False)])
def test_k6_steps_match_full_steps(dev, monkeypatch, system, B, in_smem,
                                   precision):
    m, prob, X0, rng = _scenario(system, dev, precision, B)
    T = 6
    noise = 0.3 * rng.randn(T, B, X0.shape[1])
    X1 = X0.copy()
    X1[1, 0] = np.nan
    runs = []
    for X in (X0, X1):
        args, kw = mpc._scenario_scan_call(m, prob, X, T, ci=5,
                                           Y0=torch.zeros_like(m.Y),
                                           noise=noise)
        built = full_rollout_batched(*args, **kw)
        chains = full_rollout_batched.chain_steps
        with monkeypatch.context() as mp:
            mp.setattr(TSK, "_made_steps", lambda ops: _dense_steps(args))
            full = full_rollout_batched(*args, **kw)
            full_chains = full_rollout_batched.chain_steps
        runs.append((built, full))
    Yk = args[11]
    plan = rollout_batched_plan(Yk.shape[0], Yk.shape[1], kw["nxp"],
                                kw["ncp"], kw["nup"], kw["nplp"], Yk.dtype)
    assert plan["slab_in_smem"] == in_smem, plan
    built, full = runs[0]
    for a, b in zip(built, full):
        assert torch.equal(a, b)
    dp = Yk.shape[1]
    for v in full_chains.values():
        assert v["longest"] == v["dense"] and v["kept"] == v["dense_sum"]
    assert chains["check"]["dense"] == dp // 8
    assert 0 < chains["check"]["longest"] < dp // 8
    # u = y @ S_u: one diagonal entry a column
    assert chains["u"]["longest"] == 1
    # one plant state NaN: the same stats, the other rows' outputs, and the
    # row's real lanes of x and u
    built, full = runs[1]
    assert int(full[2][:, 6].max()) >= 1
    exact = dict(rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(built[2], full[2], **exact)
    rows = [r for r in range(B) if r != 1]
    assert torch.equal(built[3][rows], full[3][rows])
    for a, b, n in zip(built[:2], full[:2], (X0.shape[1], prob.K.shape[0])):
        assert torch.equal(a[:, rows], b[:, rows])
        torch.testing.assert_close(a[:, 1, :n], b[:, 1, :n], **exact)


def test_k6_chain_counter_at_the_scenario_cell_shape(dev, monkeypatch):
    """``full_rollout_batched.chain_steps`` at the scenario cell's shape
    (100 states, 20 inputs, horizon 10, B=64, fp32: Dp 640, nxp = ncp =
    256, nup = nplp = 128; 16-block clusters of 40 columns, 10 rows a
    tile): the residual products' longest tile runs 25 of 80 steps, u 1 of
    80, x+ 3 of 16, the bias and the refresh 13 of 16; operands with no
    zero keep every chain whole."""
    m, prob, X0, _ = _scenario("random100", dev, "float32", 64)
    args, kw = mpc._scenario_scan_call(m, prob, X0, 2, ci=5,
                                       Y0=torch.zeros_like(m.Y))
    Yk = args[11]
    dims = (Yk.shape[1], kw["nxp"], kw["ncp"], kw["nup"], kw["nplp"])
    assert dims == (640, 256, 256, 128, 128)
    plan = rollout_batched_plan(64, *dims, Yk.dtype)
    assert (plan["cluster"], plan["column_width"],
            plan["rows_per_tile"]) == (16, 40, 10), plan
    full_rollout_batched(*args, **kw)
    chains = full_rollout_batched.chain_steps
    got = {k: (v["longest"], v["dense"]) for k, v in chains.items()}
    assert got == {"refresh": (13, 16), "bias": (13, 16), "check": (25, 80),
                   "u": (1, 80), "x": (3, 16)}
    # 7 row tiles (64 rows in tiles of 10) of one 16-row tile each, 16
    # blocks of 8 column tiles
    assert chains["check"]["dense_sum"] == 7 * 16 * 8 * 80
    assert chains["check"]["kept"] < chains["check"]["dense_sum"] / 3
    monkeypatch.setattr(TSK, "_made_steps", lambda ops: _dense_steps(args))
    full_rollout_batched(*args, **kw)
    for v in full_rollout_batched.chain_steps.values():
        assert v["longest"] == v["dense"] and v["kept"] == v["dense_sum"]


def test_k6_plan_puts_every_tile_in_one_wave(dev):
    """At the scenario main path's shape (B=64, Dp=640, fp32) K6 runs on
    16-block clusters with the rung's column slab in shared memory, every
    tile's cluster in one wave."""
    plan = rollout_batched_plan(64, 640, 256, 256, 128, 128)
    assert plan["cluster"] == 16 and plan["slab_in_smem"], plan
    assert plan["tiles"] * plan["rows_per_tile"] >= 64, plan
    assert plan["tiles"] <= plan["max_clusters"], plan
    assert plan["blocks"] == plan["cluster"] * plan["tiles"], plan


def test_scenario_rollout_on_cuda_runs_k4_and_k6(dev):
    g, prob, X0, _ = _scenario("double_integrator", dev, "float64", 5)
    c, _, _, _ = _scenario("double_integrator", "cpu", "float64", 5)
    k4, k6 = fused_chunk_batched.launches, full_rollout_batched.launches
    xg, ug, ig = mpc.scenario_rollout_scan(g, prob, X0, 15, kernel="auto",
                                           check_interval="auto")
    assert full_rollout_batched.launches == k6 + 2
    assert fused_chunk_batched.launches == k4
    xc, uc, ic = mpc.scenario_rollout_scan(c, prob, X0, 15, kernel="scan",
                                           check_interval="auto")
    np.testing.assert_array_equal(ig.numpy(), ic.numpy())
    np.testing.assert_allclose(xg.cpu().numpy(), xc.numpy(), atol=1e-6)
    np.testing.assert_allclose(ug.cpu().numpy(), uc.numpy(), atol=1e-6)
    xl, _, _ = mpc.scenario_rollout_scan(g, prob, X0, 15, kernel="loop")
    assert fused_chunk_batched.launches > k4
    np.testing.assert_allclose(xl.cpu().numpy(), xc.numpy(), atol=1e-4)


def _hetero_inputs(B, dp, dev, dtype, n_rho=4, seed=0):
    """A (B, n_rho, Dp, Dp) bank of inner width d = Dp - 29 (inert lanes
    beyond it), per-problem rows and random per-problem rungs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                     dtype=dtype)
    d = dp - 29
    wt = torch.zeros((B, n_rho, dp, dp), dtype=dtype, device=dev)
    wt[..., :d, :d] = rnd(B, n_rho, d, d) * (0.7 / d ** 0.5)
    b, y = torch.zeros((2, B, dp), dtype=dtype, device=dev)
    b[:, :d], y[:, :d] = 0.1 * rnd(B, d), 0.5 * rnd(B, d)
    lo = torch.full((B, dp), -float("inf"), dtype=dtype, device=dev)
    hi = -lo
    lo[:, 10:40], hi[:, 10:40] = -0.8, 0.8
    rho = torch.randint(0, n_rho, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    return wt, b, lo, hi, y, rho, d


# K5 and its plain version sum each row in different orders (state-dtype
# rounding only, as K4); Dp=256 spreads each problem's rung over a cluster
# (B=16 is the LTV ensemble's batch, spread over clusters of 8)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dp,B", [(128, 9), (256, 5), (128, 16)])
def test_k5_matches_plain_version(dev, dp, B, dtype):
    wt, b, lo, hi, y, rho, d = _hetero_inputs(B, dp, dev, dtype, seed=dp)
    tiers = ((("highest", 1e-5), ("high", 1e-5), ("bf16", 3e-2))
             if dtype == torch.float32
             else (("highest", 1e-12), ("high", 1e-5)))
    # a batch that fills the card keeps the smallest cluster whose slabs fit
    assert (hetero_plan(dp, 1024, dtype)["cluster"] > 1) == (dp == 256)
    for tier, tol in tiers:
        bank = wt.to(torch.bfloat16) if tier == "bf16" else wt
        before = fused_chunk_hetero.launches
        out = fused_chunk_hetero(bank, b, lo, hi, y, rho, 25, tier)
        assert fused_chunk_hetero.launches == before + 1
        ref = fused_chunk_hetero_ref(bank, b, lo, hi, y, rho, 25, tier)
        assert out.data_ptr() not in (y.data_ptr(), ref.data_ptr())
        assert float((out - ref).abs().max()) <= tol, tier
        assert not out[:, d:].any()


# the plan knows B: 1024 problems fill the card at one block each; 16
# leave it idle, so each is spread over a larger cluster (16 x 8 = 128
# blocks on the H100's 132 SMs)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k5_plan_spreads_a_small_batch(dev, dtype):
    big, small = hetero_plan(128, 1024, dtype), hetero_plan(128, 16, dtype)
    assert big["cluster"] == 1
    assert small["cluster"] > big["cluster"]
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert 16 * small["cluster"] <= n_sm < 16 * 2 * small["cluster"]
    assert small["cols_per_block"] * small["cluster"] == 128
    # each lane holds its few rows of the slab in registers (4 at B=16; 16
    # at B=1024 in fp32, where fp64's 32 rows stay in shared memory)
    assert small["regs_rows"] == 4 and not small["w_in_smem"]
    assert big["regs_rows"] == (16 if dtype == torch.float32 else 0)


def test_k5_wrapper_rejects_what_the_kernel_does_not_take(dev):
    wt, b, lo, hi, y, rho, _ = _hetero_inputs(3, 128, dev, torch.float32)
    bad = [(wt, b, lo, hi, y, rho.long()),            # rung vector dtype
           (wt[:2], b, lo, hi, y, rho),               # bank of another B
           (wt, b, lo, hi, y.t().contiguous().t(), rho),   # not contiguous
           (wt.double(), b, lo, hi, y, rho)]          # bank dtype
    for args in bad:
        with pytest.raises(ValueError):
            fused_chunk_hetero(*args, 5)


def _hetero_batch(B=6, nx=30, seed0=0):
    insts = [rand_qp(nx, nx // 4, nx // 4, seed=seed0 + i, compute_sol=False)
             for i in range(B)]
    return tuple(np.stack([getattr(i, k) for i in insts])
                 for k in ("H", "g", "A", "l", "u"))


def test_hetero_solver_on_cuda_runs_k5(dev):
    data = _hetero_batch()
    m = rqt.BatchedReLU_QP()
    m.setup(*data, eps_abs=1e-4)
    assert m.settings.device.type == "cuda" and m._hetero_pallas
    k1, k4, k5 = (fused_chunk.launches, fused_chunk_batched.launches,
                  fused_chunk_hetero.launches)
    res = m.solve()
    assert fused_chunk_hetero.launches > k5
    assert (fused_chunk.launches, fused_chunk_batched.launches) == (k1, k4)
    assert res.info.status.all() and res.x.is_cuda
    c = rqt.BatchedReLU_QP()
    c.setup(*data, eps_abs=1e-6, precision="float64", device="cpu",
            backend="xla")
    rc = c.solve()
    np.testing.assert_allclose(res.x.cpu().double().numpy(), rc.x.numpy(),
                               atol=1e-3)
    assert not m.Y[:, m.D:].any()


def test_repack_on_cuda_runs_k4_at_every_stage(dev):
    """tail_policy="repack" at a few hundred rows, its schedule forced to
    three stages: K4 only, and per-row iterations and status equal to the
    dense solve on the card."""
    data = _shared_batch(B=300, nx=20)
    d = rqt.BatchedReLU_QP()
    d.setup(*data, eps_abs=1e-4)
    m = rqt.BatchedReLU_QP()
    m.setup(*data, eps_abs=1e-4, tail_policy="repack")
    assert m._repack_sched == (m.B_pad,)          # below the 512-row floor
    m._repack_sched = (m.B_pad, 160, 80)
    k4, k5 = fused_chunk_batched.launches, fused_chunk_hetero.launches
    rd = d.solve()
    n_dense = fused_chunk_batched.launches - k4
    res = m.solve()
    assert fused_chunk_batched.launches - k4 > n_dense
    assert fused_chunk_hetero.launches == k5
    assert res.info.status.all()
    np.testing.assert_array_equal(res.info.iter, rd.info.iter)
    np.testing.assert_array_equal(res.info.status_code, rd.info.status_code)
    np.testing.assert_allclose(res.x.cpu().numpy(), rd.x.cpu().numpy(),
                               atol=1e-3)


def test_device_bank_build_on_cuda_matches_the_cpu_build(dev):
    """bank_build="device" on the card against the host build on the CPU,
    fp64 with a finite ρ cap (uncapped, the top rungs' KKT matrices are too
    ill-conditioned for a bound): banks and B masters within 1e-10, equal
    solves."""
    data = _hetero_batch(B=8, nx=20)
    kw = dict(eps_abs=1e-6, precision="float64", rho_cap=1e3)
    m = rqt.BatchedReLU_QP()
    m.setup(*data, bank_build="device", **kw)
    assert m._B_dev.is_cuda and m.Wt_bank.is_cuda
    c = rqt.BatchedReLU_QP()
    c.setup(*data, device="cpu", **kw)
    np.testing.assert_allclose(m.Wt_bank.cpu().numpy(), c.Wt_bank.numpy(),
                               rtol=0, atol=1e-10)
    D = m.D
    np.testing.assert_allclose(m._B_dev[:, :, :D].cpu().numpy(), c._B_np,
                               rtol=0, atol=1e-10)
    k5 = fused_chunk_hetero.launches
    res, rc = m.solve(), c.solve()
    assert fused_chunk_hetero.launches > k5
    np.testing.assert_array_equal(res.info.iter, rc.info.iter)
    np.testing.assert_allclose(res.x.cpu().numpy(), rc.x.numpy(), atol=1e-6)


# --------------------------------------------------------------------- #
# the device guard and the multi-device path                            #
# --------------------------------------------------------------------- #

def test_k4_k5_launch_on_their_operands_card(dev):
    """K4 and K5 on cuda:1 from a process whose current card is 0: each
    wrapper plans and launches on its operands' card (a stream or a plan of
    card 0 would fail the launch or give another card's shape)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two GPUs")
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    wt, b, lo, hi, y = _inputs(640, d1, rows=16)
    rho = torch.tensor([2], dtype=torch.int32, device=d1)
    out = fused_chunk_batched(wt, b, lo, hi, y, rho, 25, "highest")
    ref = fused_chunk_batched_ref(wt, b, lo, hi, y, rho, 25, "highest")
    assert out.device == d1 and torch.cuda.current_device() == 0
    assert float((out - ref).abs().max()) <= 1e-5
    wt, b, lo, hi, y, rho, _ = _hetero_inputs(9, 256, d1, torch.float32)
    out = fused_chunk_hetero(wt, b, lo, hi, y, rho, 25, "highest")
    ref = fused_chunk_hetero_ref(wt, b, lo, hi, y, rho, 25, "highest")
    assert out.device == d1 and torch.cuda.current_device() == 0
    assert float((out - ref).abs().max()) <= 1e-5
    # a whole solve through K4 on card 1
    m = rqt.BatchedReLU_QP()
    m.setup(*_shared_batch(), eps_abs=1e-4, device=d1)
    before = fused_chunk_batched.launches
    res = m.solve()
    assert fused_chunk_batched.launches > before and res.x.device == d1
    assert res.info.status.all()


def test_one_rank_nccl_mesh_is_bit_equal_to_unsharded(dev):
    """A world-size-1 NCCL group: the mesh'd batch solve (K4, its exit
    all-reduced) gives the unsharded solve's bits."""
    import socket
    import torch.distributed as dist
    from reluqp_tpu_torch.parallel import init_distributed, make_mesh
    if dist.is_initialized():
        pytest.skip("a process group already exists in this process")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert init_distributed(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh(1)
        data = _shared_batch(B=12)
        ref = rqt.BatchedReLU_QP()
        ref.setup(*data, eps_abs=1e-4)
        r0 = ref.solve()
        m = rqt.BatchedReLU_QP()
        m.setup(*data, eps_abs=1e-4, mesh=mesh)
        before = fused_chunk_batched.launches
        r1 = m.solve()
        assert fused_chunk_batched.launches > before
        assert torch.equal(r1.x, r0.x)
        np.testing.assert_array_equal(r1.info.iter, r0.info.iter)
        np.testing.assert_array_equal(r1.info.rho_ind, r0.info.rho_ind)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# the check windows as CUDA graphs (core.graphs) against eager windows  #
# --------------------------------------------------------------------- #

def _same_bits(a, b):
    for u, v in zip(a, b):
        if isinstance(u, torch.Tensor):
            assert u.dtype == v.dtype and torch.equal(u, v)
        else:
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _qp_bits(r):
    return (r.x, r.z, r.lam, r.info.iter, r.info.status, r.info.pri_res,
            r.info.dua_res)


def _batch_bits(r):
    i = r.info
    return (r.x, r.z, r.lam, i.iter, i.status_code, i.rho_ind, i.pri_res,
            i.dua_res, i.n_iter_total)


def test_graphed_canonical_qp_equals_eager_and_counts_replays(dev):
    """The canonical QP through K1, every window eager against graphed:
    bit-equal over three cold solves, and K1's counter counts the replays
    (the same launches as eager)."""
    qp = canonical_qp()
    runs, launches = {}, {}
    for graphed in (False, True):
        m = rqt.ReLU_QP()
        m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-6,
                check_interval=5)
        if not graphed:
            m._window_graphs = False
        before = fused_chunk.launches
        runs[graphed] = []
        for _ in range(3):
            m.clear_primal_dual()
            runs[graphed].append(_qp_bits(m.solve()))
        launches[graphed] = fused_chunk.launches - before
        cache = m._window_graphs
    assert cache.captures >= 1 and cache.replays > 0
    assert launches[True] == launches[False] > 3
    for a, b in zip(runs[False], runs[True]):
        _same_bits(a, b)


def test_graphed_loop_mpc_equals_eager(dev):
    """A 30-step loop-MPC rollout (new g, bounds and bias state every
    step): bit-equal, at most 4 captures, K1 launches equal."""
    Ad, Bd = mpc.random_linear_system(6, 2, seed=0)
    x0 = 0.5 * np.random.RandomState(0).randn(6)
    outs, launches = {}, {}
    for graphed in (False, True):
        ctrl = mpc.MPC(Ad, Bd, np.eye(6), 0.1 * np.eye(2), horizon=5,
                       u_min=-1.0, u_max=1.0, eps_abs=1e-4)
        if not graphed:
            ctrl.solver._window_graphs = False
        before = fused_chunk.launches
        outs[graphed] = mpc.mpc_rollout_scan(
            ctrl.solver, ctrl.prob, x0, 30, kernel="loop", check_interval=5,
            return_stats=True, return_state=True)
        launches[graphed] = fused_chunk.launches - before
        cache = ctrl.solver._window_graphs
    _same_bits(outs[False], outs[True])
    # a control step is one device program: step 1 walks it, steps 2..30
    # launch it
    assert 1 <= cache.captures <= 4 and cache.replays == 29
    assert launches[True] == launches[False]


def test_graphed_shared_batch_with_update_equals_eager(dev):
    """A shared B=37 batch through K4: a solve, ``update(g)``, a warm
    solve; bit-equal to eager and no capture after the update."""
    data = _shared_batch(B=37)
    G2 = data[1] + 0.05 * np.random.RandomState(2).randn(*data[1].shape)
    runs, launches = {}, {}
    for graphed in (False, True):
        m = rqt.BatchedReLU_QP()
        m.setup(*data, eps_abs=1e-4, check_interval=5)
        if not graphed:
            m._window_graphs = False
        before = fused_chunk_batched.launches
        runs[graphed] = [_batch_bits(m.solve())]
        m.clear_primal_dual()
        runs[graphed].append(_batch_bits(m.solve()))
        n_cap = m._window_graphs.captures if graphed else None
        m.update(g=G2)
        runs[graphed].append(_batch_bits(m.solve()))
        launches[graphed] = fused_chunk_batched.launches - before
        cache = m._window_graphs
    assert cache.captures == n_cap >= 1 and cache.replays > 0
    assert launches[True] == launches[False]
    for a, b in zip(runs[False], runs[True]):
        _same_bits(a, b)


def test_graphed_hetero_batch_equals_eager(dev):
    """A heterogeneous B=7 batch through K5: two cold solves bit-equal to
    eager, K5 launches equal."""
    data = _hetero_batch(B=7)
    runs, launches = {}, {}
    for graphed in (False, True):
        m = rqt.BatchedReLU_QP()
        m.setup(*data, eps_abs=1e-4, check_interval=5)
        if not graphed:
            m._window_graphs = False
        before = fused_chunk_hetero.launches
        runs[graphed] = []
        for _ in range(2):
            m.clear_primal_dual()
            runs[graphed].append(_batch_bits(m.solve()))
        launches[graphed] = fused_chunk_hetero.launches - before
        cache = m._window_graphs
    assert cache.replays > 0
    assert launches[True] == launches[False]
    for a, b in zip(runs[False], runs[True]):
        _same_bits(a, b)


# --------------------------------------------------------------------- #
# a solve as one device program (the WHILE nodes of csrc/graph_loop.cu)  #
# --------------------------------------------------------------------- #

def test_device_exit_canonical_qp_equals_per_window(dev):
    """The canonical QP through K1: three cold solves as one device program
    each (the first walked, the second built, the third launched) against
    the same solves walked window by window: bit-equal, K1 launches equal
    (counted from the program's body counts), one program built."""
    qp = canonical_qp()
    runs, launches = {}, {}
    for device_exit in (False, True):
        m = rqt.ReLU_QP()
        m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-6,
                check_interval=5)
        m._window_graphs.device_exit = device_exit
        before = fused_chunk.launches
        runs[device_exit] = []
        for _ in range(3):
            m.clear_primal_dual()
            runs[device_exit].append(_qp_bits(m.solve()))
        launches[device_exit] = fused_chunk.launches - before
        cache = m._window_graphs
    assert cache.programs == 1 and cache.replays == 2
    assert launches[True] == launches[False] > 3
    for a, b in zip(runs[False], runs[True]):
        _same_bits(a, b)


def test_device_exit_loop_mpc_equals_per_window(dev):
    """20 loop-MPC control steps, each one device program (refresh, solve,
    plant step) against the same steps walked window by window:
    bit-equal, K1 launches equal."""
    Ad, Bd = mpc.random_linear_system(6, 2, seed=0)
    x0 = 0.5 * np.random.RandomState(0).randn(6)
    outs, launches = {}, {}
    for device_exit in (False, True):
        ctrl = mpc.MPC(Ad, Bd, np.eye(6), 0.1 * np.eye(2), horizon=5,
                       u_min=-1.0, u_max=1.0, eps_abs=1e-4)
        ctrl.solver._window_graphs.device_exit = device_exit
        before = fused_chunk.launches
        outs[device_exit] = mpc.mpc_rollout_scan(
            ctrl.solver, ctrl.prob, x0, 20, kernel="loop", check_interval=5,
            return_stats=True, return_state=True)
        launches[device_exit] = fused_chunk.launches - before
        cache = ctrl.solver._window_graphs
    _same_bits(outs[False], outs[True])
    assert cache.programs == 1 and cache.replays == 19
    assert launches[True] == launches[False]


def test_device_program_build_failure_raises(dev):
    """A device program the card refuses to build raises (here a child
    graph node on no graph); nothing runs the solve another way."""
    from reluqp_tpu_torch.core.graphs import GraphProgram

    class NoGraph:
        def raw(self):
            return 0

    counts = torch.zeros(1, dtype=torch.float64, device=dev)
    with pytest.raises(RuntimeError, match="device program"):
        GraphProgram([("graph", NoGraph())], counts)


# --------------------------------------------------------------------- #
# C1 and C2: the check window                                           #
# --------------------------------------------------------------------- #

def _recorded_checks(solver, monkeypatch):
    """Solve eagerly, recording every check's inputs (the state cloned
    before it, the operands, the settings, the runner's output)."""
    from reluqp_tpu_torch.core import batched as tb
    from reluqp_tpu_torch.core import iteration as ti
    recs = []
    clone = lambda nt: nt._replace(**{
        f: v.clone() for f, v in nt._asdict().items()
        if isinstance(v, torch.Tensor)})

    def wrap(kind, real):
        def check(st, op, cfg, y, n, phase):
            recs.append((kind, clone(st), op, cfg, y.clone(), n, phase))
            return real(st, op, cfg, y, n, phase)
        return check

    monkeypatch.setattr(ti, "check_window", wrap("C1", ti.check_window))
    monkeypatch.setattr(tb, "batched_check", wrap("C2", tb.batched_check))
    solver._window_graphs = False
    solver.solve()
    return recs, clone


def _check_scale(op, y):
    """The magnitude of the sums behind a check's residuals: max |y| times
    the largest absolute row or column sum of its operands, plus max |g|."""
    ms = [op.M_res] if getattr(op, "M_res", None) is not None else [op.H,
                                                                     op.A]
    sums = [m.abs().sum(dim=-1).max() for m in ms] + [
        m.abs().sum(dim=-2).max() for m in ms]
    g = op.g_row if getattr(op, "M_res", None) is not None else (
        op.g if hasattr(op, "g") else op.G)
    return float(max(sums) * y.abs().max() + g.abs().max())


def _kernel_against_plain(recs, clone):
    """fp64: the residuals within 1e-12 of the magnitude of their sums
    (the products' rounding), the ρ estimate within what follows from
    that, every decision and the state's vectors equal."""
    from reluqp_tpu_torch.ops.check_window import (batched_check,
                                                   batched_check_ref,
                                                   check_window,
                                                   check_window_ref)
    assert recs
    for kind, st, op, cfg, y, n, phase in recs:
        c1 = kind == "C1"
        ref = (check_window_ref if c1 else batched_check_ref)(
            clone(st), op, cfg, y, n, phase)
        got = clone(st)
        counter = check_window if c1 else batched_check
        before = counter.launches
        (check_window if c1 else batched_check)(got, op, cfg, y, n, phase)
        torch.cuda.synchronize()
        assert counter.launches > before
        tol = 1e-12 * _check_scale(op, y)
        for f in ("pri", "dua"):
            assert float((getattr(got, f) - getattr(ref, f)).abs().max()) \
                <= tol, (kind, phase, f)
        res = torch.minimum(ref.pri, ref.dua).clamp_min(1e-300)
        drho = (got.rho - ref.rho).abs() / ref.rho.abs()
        assert bool((drho <= tol / res + 1e-13).all()), (kind, phase, "rho")
        for f, a in got._asdict().items():
            b = getattr(ref, f)
            if f in ("pri", "dua", "rho", "ctl", "tick", "best_p", "best_d",
                     "best_m") or a is None or b is None:
                continue
            assert torch.equal(a, b.to(a.dtype)), (kind, phase, f)


@pytest.mark.parametrize("kw", [
    dict(), dict(alpha=1.6, check_infeasibility=True),
    dict(iter_precision="high", rho_jump=True, adaptive_rho_interval=75),
    dict(max_iter=60, eps_abs=1e-12)])
def test_c1_matches_plain_version(dev, monkeypatch, kw):
    qp = rand_qp(30, 8, 8, seed=1, compute_sol=False)
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, precision="float64",
            **dict(dict(eps_abs=1e-6), **kw))
    recs, clone = _recorded_checks(m, monkeypatch)
    _kernel_against_plain(recs, clone)


@pytest.mark.parametrize("kw", [
    dict(), dict(rho_mode="per_problem", check_infeasibility=True),
    dict(alpha=1.6, iter_precision="high"), "hetero"])
def test_c2_matches_plain_version(dev, monkeypatch, kw):
    rng = np.random.RandomState(0)
    qp = rand_qp(20, 5, 5, seed=2, compute_sol=False)
    B = 40
    G = qp.g[None] + 0.3 * rng.randn(B, 20)
    H, A = qp.H, qp.A
    if kw == "hetero":
        H = np.stack([qp.H + 0.1 * i * np.eye(20) for i in range(B)])
        kw = {}
    m = rqt.BatchedReLU_QP()
    m.setup(H, G, A, np.tile(qp.l, (B, 1)), np.tile(qp.u, (B, 1)),
            precision="float64", eps_abs=1e-6, **kw)
    recs, clone = _recorded_checks(m, monkeypatch)
    _kernel_against_plain(recs, clone)


# The redesigned C1 (one cluster) and C2 (three regimes) at the main
# paths' shapes and at the edges of C2's regimes, fp64: every decision
# equal to the plain version's, residuals within its rounding.

def _shared_qp_batch(B, nx, seed=0):
    """B right-hand sides around one rand_qp(nx, nx/4, nx/4)."""
    rng = np.random.RandomState(seed)
    qp = rand_qp(nx, nx // 4, nx // 4, seed=seed, compute_sol=False)
    G = qp.g[None] + 0.3 * rng.randn(B, nx)
    return qp.H, G, qp.A, np.tile(qp.l, (B, 1)), np.tile(qp.u, (B, 1))


def _c2_plan_of(m, monkeypatch):
    """The C2 plan of ``m``'s first recorded window, and the records."""
    from reluqp_tpu_torch.ops.check_window import batched_check_plan
    recs, clone = _recorded_checks(m, monkeypatch)
    kind, st, op, cfg, y, n, phase = recs[0]
    return batched_check_plan(st, op, cfg, y, n, phase), recs, clone


@pytest.mark.parametrize("case,regime", [
    ("shared B=1", "smem"), ("shared B=31", "smem"),
    ("shared B=33", "smem"), ("shared B=10000", "smem"),
    ("scenario B=64", "tiles"), ("hetero B=1024", "stream"),
    ("hetero B=16 certificates", "stream")])
def test_c2_matches_plain_at_regime_edges(dev, monkeypatch, case, regime):
    kw = dict(precision="float64", eps_abs=1e-6, max_iter=150)
    if case.startswith("shared"):
        data = _shared_qp_batch(int(case.split("=")[1]), 50)
    elif case.startswith("scenario"):
        data = _shared_qp_batch(64, 200)       # nx = nc = 200, Dp = 640
    else:
        B = int(case.split()[1].split("=")[1])
        data = _hetero_batch(B, nx=50)
        kw.update(bank_build="device")
        if "certificates" in case:
            kw.update(check_infeasibility=True, alpha=1.6)
    m = rqt.BatchedReLU_QP()
    m.setup(*data, **kw)
    plan, recs, clone = _c2_plan_of(m, monkeypatch)
    assert plan["regime"] == regime, plan
    _kernel_against_plain(recs, clone)


_ROW_STATE = ("Y", "rho", "pri", "dua", "done", "iters", "status",
              "X_prev", "Lam_prev")


def _rows_of(rec, idx):
    """A recorded batched window restricted to the rows ``idx``, in that
    order, with a fresh ticket buffer."""
    kind, st, op, cfg, y, n, phase = rec
    take = lambda t: None if t is None else t.index_select(0, idx) \
        .contiguous()
    d = {f: take(getattr(st, f)) for f in _ROW_STATE}
    if st.rho_ind.dim() == 1:
        d["rho_ind"] = take(st.rho_ind)
    for f in ("k", "n_open", "open", "tail", "open_a", "best_m", "best_open",
              "n_stall", "k_fast"):
        v = getattr(st, f)
        d[f] = None if v is None else v.clone()
    d["tick"] = torch.zeros(idx.numel() + 2, dtype=torch.int32,
                            device=y.device)
    o = {f: take(getattr(op, f)) for f in ("lo", "hi")}
    for f, nd in (("H", 3), ("A", 3), ("rho_eff", 3), ("G", 2),
                  ("w_pri", 2), ("w_dua", 2)):
        t = getattr(op, f)
        if t is not None and t.dim() == nd:
            o[f] = take(t)
    return (kind, st._replace(ctl=None, **d), op._replace(**o), cfg,
            take(y), n, phase)


@pytest.mark.parametrize("regime", ["smem", "stream", "tiles"])
def test_c2_rows_do_not_depend_on_the_batch(dev, monkeypatch, regime):
    """Each row's results are the same bits in the batch, in the batch
    reversed and in its first half: a row's sums depend on nx, nc, the
    dtype and the regime only."""
    from reluqp_tpu_torch.ops.check_window import batched_check
    B = 40
    kw = dict(precision="float64", eps_abs=1e-6, max_iter=100,
              check_infeasibility=True)
    if regime == "stream":
        data = _hetero_batch(B, nx=50)
        kw.update(rho_mode="per_problem")
    else:   # fp64 [A; H] of nx = 100 outgrows a block's shared memory
        data = _shared_qp_batch(B, 50 if regime == "smem" else 100)
    m = rqt.BatchedReLU_QP()
    m.setup(*data, **kw)
    plan, recs, clone = _c2_plan_of(m, monkeypatch)
    assert plan["regime"] == regime, plan
    rec = next(r for r in recs if r[6] != "tail")
    results = []
    for idx in (torch.arange(B), torch.arange(B - 1, -1, -1),
                torch.arange(B // 2)):
        kind, st, op, cfg, y, n, phase = _rows_of(rec, idx.to(dev))
        batched_check(st, op, cfg, y, n, phase)
        torch.cuda.synchronize()
        results.append((idx, st))
    full = results[0][1]
    fields = _ROW_STATE + (("rho_ind",) if full.rho_ind.dim() else ())
    for idx, st in results[1:]:
        for f in fields:
            a = getattr(full, f).index_select(0, idx.to(dev))
            assert torch.equal(a, getattr(st, f)), (regime, f)


@pytest.mark.parametrize("nx,dp", [(60, 128), (300, 640), (500, 1024)])
def test_c1_matches_plain_at_dp(dev, monkeypatch, nx, dp):
    qp = rand_qp(nx, nx // 4, nx // 4, seed=1, compute_sol=False)
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, precision="float64",
            eps_abs=1e-6, max_iter=200, scaling=True)
    assert m.Dp == dp
    recs, clone = _recorded_checks(m, monkeypatch)
    assert recs[0][4].shape[0] == dp
    _kernel_against_plain(recs, clone)


def test_c1_certificates_with_the_residual_operator(dev, monkeypatch):
    # alpha = 1: y @ M_res for the residuals, H, A for the certificates
    qp = rand_qp(300, 75, 75, seed=2, compute_sol=False)
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, precision="float64",
            eps_abs=1e-6, max_iter=200, check_infeasibility=True)
    recs, clone = _recorded_checks(m, monkeypatch)
    assert all(r[2].M_res is not None for r in recs)
    _kernel_against_plain(recs, clone)


@pytest.mark.parametrize("regime,B,n_small,key", [
    ("smem", 4224, 40, "rows"), ("tiles", 40, 8, "rows"),
    ("stream", 1024, 40, "buffers")])
def test_c2_rows_do_not_depend_on_the_tile_shape(dev, monkeypatch, regime,
                                                 B, n_small, key):
    """The plan's B-dependent shape (rows a tile in "smem" and "tiles",
    operand buffers a warp in "stream") differs between the batch and its
    first ``n_small`` rows, and each row's results are the same bits."""
    from reluqp_tpu_torch.ops.check_window import (batched_check,
                                                   batched_check_plan)
    kw = dict(precision="float64", eps_abs=1e-6, max_iter=50,
              check_infeasibility=True)
    if regime == "stream":
        data = _hetero_batch(B, nx=50)
        kw.update(rho_mode="per_problem", bank_build="device")
    else:
        data = _shared_qp_batch(B, 50 if regime == "smem" else 100)
    m = rqt.BatchedReLU_QP()
    m.setup(*data, **kw)
    _, recs, _ = _c2_plan_of(m, monkeypatch)
    rec = next(r for r in recs if r[6] != "tail")
    outs = []
    for idx in (torch.arange(B), torch.arange(n_small)):
        win = _rows_of(rec, idx.to(dev))
        plan = batched_check_plan(*win[1:])
        assert plan["regime"] == regime, plan
        kind, st, op, cfg, y, n, phase = win
        batched_check(st, op, cfg, y, n, phase)
        torch.cuda.synchronize()
        outs.append((plan, st))
    (p_big, full), (p_small, part) = outs
    assert p_big[key] != p_small[key], (p_big, p_small)
    fields = _ROW_STATE + (("rho_ind",) if full.rho_ind.dim() else ())
    for f in fields:
        assert torch.equal(getattr(full, f)[:n_small], getattr(part, f)), \
            (regime, f)


def _widened(rec, nx, nc, B=None, seed=0):
    """A recorded window (C1's, or C2's with ``B`` rows) with its operands
    and its state's vectors drawn anew at ``nx``, ``nc`` from a seed, in
    the solver's own shapes; its settings and scalars kept. C1's residual
    operator, where the window has one, is built from the new H and A in
    ``build_residual_operator``'s layout."""
    kind, st, op, cfg, y, n, phase = rec
    dev, dt = y.device, y.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev, dtype=dt)
    pos = lambda *s: 0.5 + torch.rand(*s, generator=gen, device=dev,
                                      dtype=dt)
    lead = () if B is None else (B,)
    dp = pad_dim(nx + 2 * nc)
    H, A = rnd(nx, nx) / nx ** 0.5, rnd(nc, nx) / nx ** 0.5
    lo, hi = -pos(*lead, dp), pos(*lead, dp)
    lo[..., nx::5] = -float("inf")
    hi[..., nx + 1::7] = float("inf")
    y_new = torch.zeros(*lead, dp, device=dev, dtype=dt)
    y_new[..., :nx + 2 * nc] = rnd(*lead, nx + 2 * nc)
    like = lambda t, *s: None if t is None else pos(
        *(lead if t.dim() > 1 else ()), *s)
    reff = None if op.rho_eff is None else pos(
        *((B,) if op.rho_eff.dim() == 3 else ()), op.rhos.shape[0], nc)
    o = dict(H=H, A=A, lo=lo, hi=hi, rho_eff=reff,
             w_pri=like(op.w_pri, nc), w_dua=like(op.w_dua, nx))
    if B is None:
        o["g"] = rnd(nx)
        if op.M_res is not None:
            nxp, ncp = pad_dim(nx), pad_dim(nc)
            M = torch.zeros(dp, 2 * ncp + 2 * nxp, device=dev, dtype=dt)
            M[:nx, :nc] = A.T
            M[:nx, 2 * ncp:2 * ncp + nx] = H
            M[nx:nx + nc, ncp:ncp + nc] = torch.eye(nc, device=dev, dtype=dt)
            M[nx + nc:nx + 2 * nc, 2 * ncp + nxp:2 * ncp + nxp + nx] = A
            g_row = torch.zeros(1, nxp, device=dev, dtype=dt)
            g_row[0, :nx] = o["g"]
            o.update(M_res=M, g_row=g_row, w_pri=None, w_dua=None)
        s = dict(y=torch.zeros(dp, device=dev, dtype=dt),
                 x_prev=None if st.x_prev is None else rnd(nx),
                 lam_prev=None if st.lam_prev is None else rnd(nc))
    else:
        o["G"] = rnd(B, nx)
        i32 = torch.int32
        s = {f: torch.zeros(B, device=dev, dtype=t) for f, t in (
            ("done", torch.bool), ("iters", i32))}
        s.update(Y=torch.zeros(B, dp, device=dev, dtype=dt),
                 rho=0.1 * pos(B), pri=pos(B), dua=pos(B),
                 status=torch.full((B,), -1, device=dev, dtype=i32),
                 rho_ind=(st.rho_ind.clone() if st.rho_ind.dim() == 0 else
                          st.rho_ind[:1].repeat(B)),
                 X_prev=None if st.X_prev is None else rnd(B, nx),
                 Lam_prev=None if st.Lam_prev is None else rnd(B, nc),
                 tick=torch.zeros(B + 2, device=dev, dtype=i32), ctl=None)
        for f in ("k", "n_open", "open", "tail", "open_a", "best_m",
                  "best_open", "n_stall", "k_fast"):
            v = getattr(st, f)
            s[f] = None if v is None else v.clone()
    return (kind, st._replace(**s), op._replace(**o),
            cfg._replace(nx=nx, nc=nc), y_new, n, phase)


@pytest.mark.parametrize("operand", ["H, A", "M_res"])
def test_c1_matches_plain_past_its_shared_memory(dev, monkeypatch, operand):
    """fp64 with the certificates at nx = 7000, nc = 3500 (Dp = 14080),
    about the largest QP whose vectors fit one block's shared memory:
    C1 takes its global variant and matches the plain check."""
    from reluqp_tpu_torch.ops.check_window import check_window_plan
    qp = rand_qp(60, 15, 15, seed=3, compute_sol=False)
    m = rqt.ReLU_QP()
    m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, precision="float64",
            eps_abs=1e-6, max_iter=100, check_infeasibility=True,
            **(dict(alpha=1.6) if operand == "H, A" else {}))
    recs, clone = _recorded_checks(m, monkeypatch)
    rec = next(r for r in recs if r[6] != "tail")
    assert (rec[2].M_res is not None) == (operand == "M_res")
    win = _widened(rec, 7000, 3500)
    assert win[4].shape[0] == 14080
    plan = check_window_plan(*win[1:])
    assert plan["variant"] == "global" and plan["scratch"] > 0, plan
    _kernel_against_plain([win], clone)


def test_c2_matches_plain_at_its_largest_row_tile(dev, monkeypatch):
    """fp64 with the certificates, B = 2 at nx = 3300, nc = 1650: about
    the largest shared operand whose row's vectors and products fit one
    block's shared memory ("tiles", a row a tile)."""
    from reluqp_tpu_torch.ops.check_window import batched_check_plan
    m = rqt.BatchedReLU_QP()
    m.setup(*_shared_qp_batch(4, 20), precision="float64", eps_abs=1e-6,
            max_iter=100, check_infeasibility=True)
    recs, clone = _recorded_checks(m, monkeypatch)
    rec = next(r for r in recs if r[6] != "tail")
    win = _widened(rec, 3300, 1650, B=2)
    plan = batched_check_plan(*win[1:])
    assert plan["regime"] == "tiles" and plan["rows"] == 1, plan
    _kernel_against_plain([win], clone)


@pytest.mark.parametrize("operand", ["shared", "per problem"])
def test_c2_matches_plain_past_its_shared_memory(dev, monkeypatch, operand):
    """fp64 with the certificates, B = 2 at nx = 3600, nc = 1800: even a
    one-row "tiles" tile's vectors and products outgrow a block's shared
    memory, so C2 takes its global variant (a shared H and A, two rows a
    tile; or a per-problem A, a row a tile) and matches the plain check."""
    from reluqp_tpu_torch.ops.check_window import batched_check_plan
    m = rqt.BatchedReLU_QP()
    m.setup(*_shared_qp_batch(4, 20), precision="float64", eps_abs=1e-6,
            max_iter=100, check_infeasibility=True)
    recs, clone = _recorded_checks(m, monkeypatch)
    rec = next(r for r in recs if r[6] != "tail")
    win = _widened(rec, 3600, 1800, B=2)
    if operand == "per problem":
        kind, st, op, cfg, y, n, phase = win
        A = torch.stack([op.A, op.A.flip(0)]).contiguous()
        win = (kind, st, op._replace(A=A), cfg, y, n, phase)
    plan = batched_check_plan(*win[1:])
    assert plan["regime"] == "tiles" and plan["variant"] == "global", plan
    assert plan["rows"] == (2 if operand == "shared" else 1), plan
    assert plan["scratch"] > 0, plan
    _kernel_against_plain([win], clone)
