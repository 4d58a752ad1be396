#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``reluqp_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build the CUDA kernels from ``reluqp_tpu_torch/csrc`` and
   print the build time;
2. hold kernel K1 against its plain torch version on the card: 18 rungs,
   25 steps, Dp in {128, 256, 640, 768, 896, 1024, 4096}, all four
   precision tiers, the rung index on the device at rungs 0 and 17, and
   padded lanes exactly 0;
3. time K1 per 25-step window at Dp=640 and 1024 with CUDA events, beside
   the plain version, one ``torch.addmm`` + clamp loop (timed only) and
   the bound;
4. solve the canonical QP on the card through K1;
5. the reference ``rand_qp`` protocol at nx in {100, 323, 500} in fp32 on
   the card, against the port on the CPU in fp64;
6. the 100-state, horizon-10 warm MPC rollout (200 steps, loop path,
   check_interval="auto") on the card, its first 20 steps against the same
   rollout on the CPU in fp64.

Kernel launch counters are set to 0 just before each main-path phase (4,
5, 6) and read just after; a main-path phase that launched K1 no time
fails. The second-to-last line is the ``{"kernels": [...]}`` record, the
last line ``{"ok": true, "device": {...}}``. Without a GPU, or without the
package beside it, the script exits non-zero before printing a result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

N_RHO, N_STEPS = 18, 25
SMOKE_DPS = (128, 256, 640, 768, 896, 1024, 4096)
TIMED_DPS = (640, 1024)
# Kernel vs plain version on the card, both in fp32 after 25 steps of a
# contractive map with |y| <= 1. The two sum the Dp products in different
# orders (a shuffle tree against cuBLAS), so "highest" and "high" differ by
# rounding only (~1e-7 per step). The bf16 tiers re-round y to bf16 every
# step: an fp32 difference that flips one rounding moves that lane by one
# bf16 ulp (2^-8 relative), which the next steps carry on, hence the coarse
# bound there.
TOL = {"highest": 1e-5, "high": 1e-5, "default": 3e-2, "bf16": 3e-2}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def kernel_inputs(dp, rows, dtype, gen, device):
    """Random K1 inputs with an inner width D < Dp and inert padding."""
    import torch
    d = dp - 37 if dp > 128 else 91
    wt = torch.zeros((N_RHO, dp, dp), dtype=dtype, device=device)
    wt[:, :d, :d] = torch.randn((N_RHO, d, d), generator=gen, device=device,
                                dtype=dtype) * (0.7 / d ** 0.5)
    b = torch.zeros((rows, dp), dtype=dtype, device=device)
    b[:, :d] = 0.1 * torch.randn((rows, d), generator=gen, device=device,
                                 dtype=dtype)
    inf = float("inf")
    lo = torch.full((rows, dp), -inf, dtype=dtype, device=device)
    hi = torch.full((rows, dp), inf, dtype=dtype, device=device)
    lo[:, d // 3:2 * d // 3] = -0.8     # a clamped segment, as the z rows
    hi[:, d // 3:2 * d // 3] = 0.8
    y = torch.zeros((rows, dp), dtype=dtype, device=device)
    y[:, :d] = 0.5 * torch.randn((rows, d), generator=gen, device=device,
                                 dtype=dtype)
    return wt, b, lo, hi, y, d


def phase_build():
    import torch
    from reluqp_tpu_torch.ops import cuda_build
    log("card:", card_line())
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
        f"  count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    secs = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        log(f"built {name}.cu in {info['seconds']:.2f} s -> "
            f"{info['path'].name}")
        for ln in ptxas:
            log("  ptxas:", ln)
    log(f"phase 1 OK: kernels built in {secs:.2f} s")
    return secs


def phase_kernel_check():
    """K1 against fused_chunk_ref on the card; returns the max errors."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import (fused_chunk,
                                                 fused_chunk_ref,
                                                 kernel_plan)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    errs = {}
    for dp in SMOKE_DPS:
        wt, b, lo, hi, y, d = kernel_inputs(dp, 1, torch.float32, gen, dev)
        plan = kernel_plan(1, dp)
        banks = {"highest": wt, "high": wt, "default": wt,
                 "bf16": wt.to(torch.bfloat16)}
        for tier, bank in banks.items():
            for rung in (0, N_RHO - 1):
                rho = torch.tensor([rung], dtype=torch.int32, device=dev)
                out = fused_chunk(bank, b, lo, hi, y, rho, N_STEPS, tier)
                ref = fused_chunk_ref(bank, b, lo, hi, y, rho, N_STEPS,
                                      tier)
                torch.cuda.synchronize()
                assert torch.isfinite(out).all(), (dp, tier, rung)
                err = float((out - ref).abs().max())
                pad = float(out[:, d:].abs().max())
                assert pad == 0.0, f"padding not inert: Dp={dp} {tier} {pad}"
                assert err <= TOL[tier], \
                    f"K1 disagrees: Dp={dp} {tier} rung {rung}: {err:.3e}"
                errs[(dp, tier, rung)] = err
                if tier == "highest":
                    # and against an fp64 evaluation on the host, which
                    # shares no code path with cuBLAS
                    ref64 = fused_chunk_ref(
                        *(t.cpu().double() for t in (bank, b, lo, hi, y)),
                        rung, N_STEPS)
                    err64 = float((out.cpu().double() - ref64).abs().max())
                    assert err64 <= TOL[tier], (dp, rung, err64)
                    errs[(dp, "fp64 host", rung)] = err64
        worst = {t: max(v for (p, tt, _), v in errs.items()
                        if p == dp and tt == t)
                 for t in (*banks, "fp64 host")}
        log(f"K1 Dp={dp}: plan {plan}  max|kernel-plain| "
            + "  ".join(f"{t} {e:.2e}" for t, e in worst.items()))
    # rows > 1 (the batched reuse), fp64 state
    for rows, dtype in ((16, torch.float32), (1, torch.float64)):
        wt, b, lo, hi, y, d = kernel_inputs(640, rows, dtype, gen, dev)
        rho = torch.tensor([5], dtype=torch.int32, device=dev)
        out = fused_chunk(wt, b, lo, hi, y, rho, N_STEPS, "highest")
        ref = fused_chunk_ref(wt, b, lo, hi, y, rho, N_STEPS, "highest")
        err = float((out - ref).abs().max())
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert err <= tol, (rows, dtype, err)
        log(f"K1 Dp=640 rows={rows} {dtype}: max|kernel-plain| {err:.2e}")
    log("phase 2 OK: K1 matches its plain version on every shape and tier")
    return errs


def _time_ms(fn, reps):
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_timing():
    """Per-window K1 time beside the plain version, addmm and the bound."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import fused_chunk, fused_chunk_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = {}
    for dp in TIMED_DPS:
        wt, b, lo, hi, y, _ = kernel_inputs(dp, 1, torch.float32, gen, dev)
        rho = torch.tensor([N_RHO // 2], dtype=torch.int32, device=dev)
        w_k = wt[N_RHO // 2]

        def library():
            yy = y
            for _ in range(N_STEPS):
                yy = torch.addmm(b, yy, w_k).clamp_(min=lo, max=hi)
            return yy

        ms = _time_ms(lambda: fused_chunk(wt, b, lo, hi, y, rho, N_STEPS,
                                          "highest"), 200)
        plain_ms = _time_ms(lambda: fused_chunk_ref(
            wt, b, lo, hi, y, rho, N_STEPS, "highest"), 50)
        library_ms = _time_ms(library, 50)
        # least time for the same work: read one rung + b, lo, hi, y once,
        # write y once; 2·Dp² flops per step in fp32 outside tensor cores
        nbytes = 4 * (dp * dp + 5 * dp) + 4
        flops = 2.0 * N_STEPS * dp * dp
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        bound_ms = max(t_bytes, t_ops)
        rows[dp] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                        bound_ms=bound_ms,
                        bound_by="bytes" if t_bytes >= t_ops
                        else "operations")
        log(f"K1 timing Dp={dp} (25 steps, fp32 highest): kernel {ms:.5f} ms"
            f"  plain {plain_ms:.5f} ms  addmm+clamp {library_ms:.5f} ms  "
            f"bound {bound_ms:.5f} ms ({rows[dp]['bound_by']}: "
            f"{t_bytes:.5f} ms bytes, {t_ops:.5f} ms flops)")
    log("phase 3 OK")
    return rows


def _counted(run):
    """Run one main-path phase with K1's launch counter set to 0 first;
    fail when the phase launched K1 no time."""
    from reluqp_tpu_torch.ops.fused_step import fused_chunk
    fused_chunk.launches = 0
    out = run()
    n = fused_chunk.launches
    assert n > 0, "the main path did not launch K1"
    return out, n


def phase_canonical():
    import torch
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.ops.fused_step import pallas_chunk_runner
    from reluqp_tpu_torch.utils.problems import canonical_qp

    qp = canonical_qp()

    def run():
        m = ReLU_QP()
        m.setup(qp.H, qp.g, qp.A, qp.l, qp.u, eps_abs=1e-4)
        return m, m.solve()

    (m, res), n = _counted(run)
    assert m.settings.device.type == "cuda"
    assert m._chunk_runner is pallas_chunk_runner
    x = res.x.detach().cpu().double().numpy()
    assert res.info.status == "solved", res.info.status
    assert np.allclose(x, qp.x_sol, atol=1e-3), x
    assert res.x.device.type == "cuda" and torch.isfinite(res.x).all()
    log(f"phase 4 OK: canonical QP x={x} iters={res.info.iter} "
        f"K1 launches {n}")
    return n


def phase_protocol():
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.utils.problems import rand_qp

    # reference protocol tolerance; fp32 needs Ruiz scaling at nx >~ 300
    kw = dict(eps_abs=1e-4, scaling=True)
    insts = {nx: rand_qp(nx, nx // 4, nx // 4, seed=0, compute_sol=False)
             for nx in (100, 323, 500)}

    def run():
        out = {}
        for nx, inst in insts.items():
            m = ReLU_QP()
            m.setup(*inst[:5], precision="float32", **kw)
            t0 = time.perf_counter()
            r = m.solve()
            out[nx] = (r, time.perf_counter() - t0, m.Dp)
        return out

    gpu, n = _counted(run)
    for nx, inst in insts.items():
        r, secs, dp = gpu[nx]
        m = ReLU_QP()
        m.setup(*inst[:5], precision="float64", device="cpu", **kw)
        rc = m.solve()
        x_gpu = r.x.detach().cpu().double().numpy()
        x_cpu = rc.x.numpy()
        err = float(np.max(np.abs(x_gpu - x_cpu)))
        assert r.info.status == "solved", (nx, r.info.status)
        assert rc.info.status == "solved", (nx, rc.info.status)
        assert np.all(np.isfinite(x_gpu)) and x_gpu.shape == (nx,)
        assert err < 5e-3, (nx, err)
        log(f"phase 5 nx={nx} (Dp={dp}): gpu fp32 {r.info.status} "
            f"{r.info.iter} it in {secs * 1e3:.1f} ms; cpu fp64 "
            f"{rc.info.iter} it; |x_gpu-x_cpu|inf {err:.2e}")
    log(f"phase 5 OK: reference protocol solved, K1 launches {n}")
    return n


def phase_mpc(card):
    import torch
    from reluqp_tpu_torch.models.mpc import (MPC, mpc_rollout_scan,
                                             random_linear_system)

    NX, NU, HORIZON, T, T_CMP = 100, 20, 10, 200, 20
    Ad, Bd = random_linear_system(NX, NU, seed=0, spectral_radius=0.99)
    Q, R = np.eye(NX), 0.1 * np.eye(NU)
    x0 = 0.05 * np.random.RandomState(0).randn(NX)
    kw = dict(horizon=HORIZON, u_min=-1.0, u_max=1.0, prestabilize=True,
              eps_abs=1e-3, max_iter=2000)

    def run():
        ctrl = MPC(Ad, Bd, Q, R, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_rollout_scan(ctrl.solver, ctrl.prob, x0, T, kernel="loop",
                               check_interval="auto", return_stats=True,
                               return_state=True)
        torch.cuda.synchronize()
        return (ctrl, *out, time.perf_counter() - t0)

    (ctrl, xs, us, its, status, y_f, rho_f, secs), n = _counted(run)
    assert (status.numpy() == 1).all(), "a control step was not solved"
    sol = ctrl.solver
    assert sol.settings.device.type == "cuda" and sol.Dp == 640, sol.Dp
    xs_g = xs.detach().cpu().double().numpy()
    us_g = us.detach().cpu().double().numpy()
    its = its.numpy()
    assert xs_g.shape == (T + 1, NX) and us_g.shape == (T, NU)
    assert np.all(np.isfinite(xs_g)) and np.all(np.isfinite(us_g))
    assert int(its.max()) < kw["max_iter"], its.max()

    ref = MPC(Ad, Bd, Q, R, device="cpu", precision="float64", **kw)
    xs_c, us_c, its_c = mpc_rollout_scan(ref.solver, ref.prob, x0, T_CMP,
                                         kernel="loop",
                                         check_interval="auto")
    # fp32 on the card against fp64 on the host. While both certify at the
    # same checks they differ by fp32 rounding only (~1e-7 here on the
    # CPU in fp32); a step certified one check apart differs by up to the
    # solve tolerance, so the bound is eps_abs.
    dx = float(np.max(np.abs(xs_g[:T_CMP + 1] - xs_c.numpy())))
    du = float(np.max(np.abs(us_g[:T_CMP] - us_c.numpy())))
    assert dx < kw["eps_abs"] and du < kw["eps_abs"], (dx, du)
    log(f"phase 6: 200-step rollout (Dp={sol.Dp}) iters/step "
        f"max {its.max()} mean {its.mean():.2f}; first 20 steps vs cpu "
        f"fp64: |dx|inf {dx:.2e} |du|inf {du:.2e}")
    log(f"phase 6 OK: {T / secs:.1f} steps/s over {T} steps ({secs:.3f} s "
        f"incl. the ci=1 calibration) on {card}; K1 launches {n}")
    ctrl.solver.y, ctrl.solver.rho_ind = y_f, rho_f
    profile_steps(ctrl, xs[-1], mpc_rollout_scan)
    return n


def profile_steps(ctrl, x_start, rollout, steps=50):
    """Where a warm loop-path MPC step's time goes: torch.profiler over
    ``steps`` steps continuing the rollout (one iteration per step, as
    the tuned window runs them). Device time counts the device-side
    events only (kernels and copies); the per-call operator uploads are
    spread over the steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rollout(ctrl.solver, ctrl.prob, x_start, steps, kernel="loop",
                check_interval=1)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    ev = prof.key_averages()
    dev = lambda e: float(getattr(e, "self_device_time_total", 0.0))
    on_dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(dev(e) for e in on_dev) / steps
    per = lambda pat: [e for e in ev if pat in e.key]
    k1_us = sum(dev(e) for e in per("k1_kernel")) / steps
    h2d = sum(e.count for e in per("Memcpy HtoD")) / steps
    syncs = sum(e.count for e in per("cudaStreamSynchronize")) / steps
    launches = sum(e.count for e in per("cudaLaunch")) / steps
    top = sorted(on_dev, key=dev, reverse=True)[:6]
    if busy <= 0.0:
        # instrumentation only: the checks above already passed
        log("phase 6 profile: device time not measured (the profiler "
            "recorded no device events)")
        return
    log(f"phase 6 profile ({steps} warm steps, profiler on): host wall "
        f"{wall_us:.1f} us/step, device busy {busy:.1f} us/step "
        f"({100 * busy / wall_us:.1f}%), K1 {k1_us:.1f} us/step, "
        f"{launches:.1f} launches, {h2d:.1f} H2D copies, {syncs:.1f} "
        f"stream syncs per step")
    log("  top device ops (us/step): " + "; ".join(
        f"{e.key[:48]} x{e.count / steps:.1f} {dev(e) / steps:.2f}"
        for e in top))


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import reluqp_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    phase_build()
    errs = phase_kernel_check()
    timing = phase_timing()
    launches = phase_canonical() + phase_protocol() + phase_mpc(card)
    t = timing[640]
    kernels = [{
        "name": "K1 fused_chunk (Dp=640, R=1, 25 steps, fp32 highest)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/fused_step.cu",
        "replaces": "reluqp_tpu/ops/fused_step.py:121",
        "launches": launches,
        "max_abs_err": max(errs[(640, "highest", r)] for r in (0, N_RHO - 1)),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }]
    log("card:", card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
