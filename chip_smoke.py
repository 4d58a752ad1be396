#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``reluqp_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU (H100):

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught):

1. print the card (``nvidia-smi`` name and power limit) and the torch/CUDA
   versions; build the CUDA kernels from ``reluqp_tpu_torch/csrc`` and
   print the build time;
2. hold kernel K1 against its plain torch version on the card: 18 rungs,
   25-step and 1-iteration windows, Dp in {128, 256, 640, 768, 896, 1024,
   4096}, all four precision tiers, the rung index on the device at rungs
   0 and 17, 16 and 3 rows, fp64, and padded lanes exactly 0; each shape's
   plan logged, and every slab branch reached (registers; shared memory
   and registers; and with the rest read from L2);
3. time K1 per 25-step window at Dp=640 and 1024 with CUDA events, beside
   the plain version, one ``torch.addmm`` + clamp loop (timed only) and
   the bound (with ``--parent``, the parent's K1 before and after, by CUDA
   events and in a CUDA graph of 20, and the 1-iteration window at Dp=640
   in a CUDA graph of 20);
4. solve the canonical QP on the card through K1;
5. the reference ``rand_qp`` protocol at nx in {100, 323, 500} in fp32 on
   the card, against the port on the CPU in fp64;
6. the 100-state, horizon-10 warm MPC rollout (200 steps, loop path,
   check_interval="auto") on the card, its first 20 steps against the same
   rollout on the CPU in fp64;
7. hold kernel K2 (the whole-rollout kernel) against its plain torch
   version on the card, 20 cold steps under a 0.3·randn disturbance, at
   Dp 640 (100 states, h10), 128 (double integrator, h8), 896 (100
   states, h14) and 1280 (100 states, h20: operands streamed from L2 in
   fp64): equal iterations, status and rung per step, in fp64 with
   trajectories within a few fp32 ulps, in fp32 with every step solved and
   trajectories within 1e-5; padded lanes exactly 0; the rung moves; the
   "high" and "bf16" iteration tiers once each, held the same way; each
   case's launch shape is logged, and one case streams its operands from
   L2;
8. the main path of this slice: the same 200-step rollout as phase 6
   through ``kernel="scan"`` and then ``kernel="auto"``, each in exactly
   two K2 launches (calibration segment + continuation) and no K1 launch,
   its first 20 steps against the CPU fp64 loop rollout of phase 6;
9. K2 timing: control steps per second by the two-point protocol of the
   root ``bench.py`` (T=100 and T=4000, min of 5, a fresh x0 each time),
   the kernel's time per step by CUDA events beside the plain version and
   the bound (with ``--parent``, beside the parent's K2 before and after,
   and whether the two give the same bits), its stage split
   (``ops.solve_kernel.k2_stage_split``: the 1000-step launch in a CUDA
   graph behind a stamp kernel, mean of 20, µs per launch and per step;
   with ``--parent``, the parent's too where it has the stamps) and the
   grid barriers block 0 takes (asserted: 1 per launch, 0 per warm step),
   the launch plan with its exchange, and a ``torch.profiler`` pass over a
   1000-step rollout;
10. hold kernel K3 (the whole-solve kernel) against its plain torch
    version on the card, cold solves: ``rand_qp`` at Dp 128, 256, 640,
    768, 896, 1024 and 1280 (slabs read from L2 in fp64) in fp64 and fp32,
    then each option on its own (ρ
    jump, stride 3, alpha 1.6, a primal- and a dual-infeasible instance
    and a feasible one with certificates on, two-phase refine in "high",
    "bf16" and "default", a tail window, a budget below one window, the
    state-affine bias of the 100-state h10 rollout step, and the verbose
    lines printed by the kernel): equal iterations, status, rung and
    reduced-phase count, y within K3_TOL, padded lanes exactly 0;
11. the main path of this slice: ``backend="fused"`` on the canonical QP
    and on the reference protocol (nx 100/323/500, fp32, against phase 5's
    CPU fp64 solutions), one K3 launch per solve, and the 200-step rollout
    of phase 6 through ``kernel="fused"`` in exactly 200 K3 launches, no K1
    or K2 launch, its first 20 steps against phase 6's CPU fp64 rollout;
12. K3 timing: per solve at the protocol's sizes by CUDA events, beside
    the loop path's ``solve()`` on the same instance, the plain version
    and the bound (with ``--parent``, beside the parent's K3 before and
    after, the outputs bit-equal to the parent's); the fused rollout's own
    warm solve (ci=1) per launch in a CUDA graph of 20 (with ``--parent``,
    beside the parent's, bit-equal); the fused rollout's steps/s by the
    two-point protocol beside the scan and loop paths; a profiler pass
    over 200 fused steps;
13. hold kernel K4 (the batched chunk kernel) against its plain torch
    version at B in {1, 8, 64, 256} x Dp in {128, 640, 896} and at the
    shared batch's B = 10000 and a ragged B = 1003 at Dp = 128, every tier,
    fp32 and fp64, with padded lanes and padded rows exactly 0, each plan
    logged with its regime (tile or cluster); then the first 1, 37 and 5000
    rows launched alone, bit-equal to the same rows of a B = 10000 launch,
    at Dp = 128 and 640;
14. the main path of this slice through K4: the scenario-MPC configuration
    of ``benchmarks/scenario_mpc.py`` (100 states, 20 inputs, horizon 10,
    B = 64, seeded X0 and 0.01·randn process noise): ``BatchedReLU_QP``
    set up on the card, one ``solve()`` of the 64 scenarios' first QPs
    against the CPU fp64 batch, and the 200-step ``scenario_rollout_scan
    (kernel="loop")``, its first 20 steps against the CPU fp64 loop
    rollout; K4 launches only;
15. hold kernel K6 (the batched whole-rollout kernel) against its plain
    torch version at Dp 128/640/896/1280 and B in {5, 64, 256}, fp64 and
    fp32: equal iterations, rung, status and unsolved rows per step,
    trajectories within K6_TOL, padded lanes and rows exactly 0; each
    case's launch shape is logged (cluster size, rows per tile, tiles, the
    rung's slab in shared memory or read from L2), every shape branch is
    reached (16-block clusters with the slab in shared memory, a partial
    last tile, the slab from L2) and a rung change reloads the slab; the
    "high" tier and a bf16 bank once each, held the same way;
16. the same rollout as phase 14 through ``kernel="scan"`` (one K6 launch)
    and ``kernel="auto"`` with ``check_interval="auto"`` (two), no other
    kernel, held against phase 14 and the CPU fp64 rollout;
17. K4 per 25-step window at B = 64, Dp = 640 by CUDA events beside its
    plain version, 25 ``torch.addmm`` + clamp and the bound (with
    ``--parent``, beside the parent's K4 before and after, bit-equal), the three
    again as device time read by the profiler, K4 on one row tile (one
    cluster) of 1 and of 8 rows and in the "high" and "bf16" tiers; K6 per
    warm step at B = 16, 64 and 256 beside its plain version and the bound;
    two-point steps/s of the loop and scan paths; a profiler pass
    over each, and the loop path's synchronizing calls by source line;
18. hold kernel K5 (the heterogeneous chunk kernel) against its plain
    torch version at B in {1, 7, 64} x Dp in {128, 256, 640, 896}, and
    B = 1024 and B = 16 (the LTV ensemble's) at Dp = 128, per-problem
    rungs drawn at random over 18, every tier, fp32 and fp64, padded lanes
    exactly 0, each shape's launch plan logged;
19. the main path of slice 5 through K5: ``BatchedReLU_QP`` set up on the
    card for ``benchmarks/batched_qps.py --hetero``'s batch (B = 1024
    distinct ``rand_qp(50, 12, 12, seed=i)``, fp32, eps 1e-3), one
    ``solve()`` with every problem solved, the first 64 against the CPU
    fp64 solve, a timed second solve; then ``examples/ltv_mpc.py``'s LTV
    ensemble (B = 16, 40 steps, ``update_matrices`` every 6) in fp64
    (within 1e-4 of the CPU fp64 loop) and in fp32; K5 launches only;
20. K5 per 25-step window at B = 1024, Dp = 128 and B = 256, Dp = 256 by
    CUDA events and device time beside its plain version, 25
    ``torch.baddbmm`` + clamp and the bound, K5 on the main path's bank,
    K5 on the LTV ensemble's own windows (phase 19's banks, rungs and
    states, B = 16, Dp = 128, fp32 and fp64: least of 20 launches, and 20
    launches in one CUDA graph, whose replay holds no host time) beside
    the bound and 25 ``torch.baddbmm`` + clamp on the gathered rungs in a
    CUDA graph (with ``--parent``, the parent's K5 before and after at
    B = 1024 and on the LTV windows), solves/s by a two-point fit, and a
    profiler pass over one solve and its synchronizing calls;
21. ``bank_build="device"`` on phase 19's B = 1024 batch: the setup's fp64
    B masters, and the card's fp64 build of the first 64 problems' W,
    against the host's fp64 build (within BANK_TOL, finite fp32 caps); one
    ``solve()`` through K5 with every problem solved; ``update(g)`` (the
    bias formed on the card from the fp64 master) against a host-built
    batch, both solved cold: equal status; the setup seconds of the
    device, native-host and numpy-host builds (``utils.timing.Timer``);
22. ``tail_policy="repack"`` against ``"dense"`` on
    ``benchmarks/batched_qps.py``'s shared batch (B = 10000, nx = 50,
    n_eq = n_ineq = 12, fp32, "highest", eps 1e-3): the schedule (K4's
    row tile as its alignment), equal per-row status and first-convergence
    iterations, x within REPACK_X_TOL, K4 launches by row capacity (K4
    only), syncs per solve (the dense solve exits on the device: one;
    repack, walked window by window, no more than the dense solve walked
    so); K4 alone on the
    dense batch's bank, bias, bounds and state (one 25-step window by CUDA
    events and device time beside its plain version, 25 ``torch.addmm`` +
    clamp, the bound and the plan; with ``--parent``, beside the parent's
    K4 before and after) and one dense solve's device time by kernel; each
    solve's least time of REPACK_REPS by CUDA events
    (``utils.timing.time_fn_events``; with ``--parent``, the parent's
    repack solve before and after, and whether its x, iterations and
    status are the same bits), and the budget-exhaustion case (eps
    1e-4, max_iter 50): equal status and iterations;
23. checkpoints on the card: the protocol QP (nx = 100) with
    ``backend="fused"``, phase 19's B = 1024 batch (warm) and
    phase 22's repack batch, each saved, loaded (onto ``cuda`` by default)
    and solved beside the original: equal status and iterations and x
    bit-equal, K3 / K5 / K4 launched; load seconds beside setup seconds;
24. the native bank builder on the MPC configuration's condensed QP
    (D = 600): native and numpy builds timed, the fp64 B masters within
    1e-9 and the fp32 W within one fp32 rounding, a solve through K1 with
    each: equal status and iterations;
25.-28. the multi-device paths, one process per visible card over NCCL
    (``torch.cuda.device_count()`` ranks, started once for the four phases;
    each rank loads the kernels phase 1 built): 25, ``BatchedReLU_QP
    (mesh=)`` on ``benchmarks/batched_qps.py``'s shared batch at B = 10000
    per card through K4 with the collective exit: per row status,
    iterations and rung equal to the unsharded dense solve of the same
    rows (x bit-equal on one card), every window's rung equal on every
    rank, two all-reduces per window and one all-gather per solve, syncs
    per window no more than the unsharded rows walked window by window
    (the mesh is walked so), the solve's CUDA-event time beside
    one card's rows unsharded (weak-scaling efficiency); 26, the --hetero
    B = 1024 batch split over the ranks with ``process_local=True`` and
    ``bank_build="device"`` through K5: held against the unsharded
    device-built solve (bit-equal on one card), ``objective()``,
    ``update(g)`` and a warm re-solve, a shard-file checkpoint restored
    onto the same layout (bit-equal) and merged into this process; 27, the
    tensor-parallel single QP (``ReLU_QP.setup(mesh=)``) at ``rand_qp
    (500, 125, 125)`` and nx = 400, fp32, eps 1e-4, Ruiz: iterations and
    status equal to the single-card ``backend="xla"`` solve on one card
    and wherever that solve certifies (its fp64 twin logged beside), x
    within TP_X_TOL, each rank's (18, Dp, Dp/W) block, one all-gather of Dp/W
    numbers per iteration, time per iteration beside K1's window on the
    same QP; 28, phase 14's scenario MPC with the batch solver over the
    mesh, ``kernel="auto"`` (the loop path): K4 only, bit-equal to phase
    14 on one card, steps/s. Phase 25 also times the solve with every
    window eager against graphed (the all-reduces captured), by turns,
    and holds the two bit-equal;
29. the check windows as CUDA graphs (``reluqp_tpu_torch/core/graphs.py``),
    each solve walked window by window from the host (``WindowGraphs.
    device_exit = False``), against the same solves with every window
    eager (``solver._window_graphs = False``): the canonical and protocol
    QPs,
    phase 6's 200-step loop MPC (at most GRAPH_MPC_CAPTURES captures),
    phase 14's 200-step scenario loop, phase 19's B = 1024 hetero solve
    and phase 22's B = 10000 dense and repack solves, each bit-equal (x,
    z, λ, status, iterations, rungs) with equal kernel launches; the
    captures and their host ms; by turns (eager, graphed, graphed,
    eager) the solve times by CUDA events, the rollouts' steps/s; the
    profiler per window or step; the host launches between two host reads
    (after a solve's first window at most GRAPH_WINDOW_LAUNCHES, a repack
    stage's first excepted); syncs per window (graphed no more than
    eager, and at least one);
30. a solve as one device program (``core/graphs.py``, the conditional
    WHILE and IF nodes built by ``csrc/graph_loop.cu``) against phase 29's
    per-window graphs and eager, by turns, on the canonical and protocol
    QPs, phase 6's loop MPC, phase 14's scenario loop, phase 19's B = 1024
    hetero solve and phase 22's B = 10000 dense solve: bit-equal in the
    three modes with equal kernel launches (the program's body counts
    settle the counters); one host read and one sync per solve and per
    rollout segment (EXIT_SEG_T steps) with the device exit; host launches
    per solve or step; CUDA-event solve times and steps/s, and by turns
    the device exit with the plain torch check in place of kernels C1 and
    C2 (``WindowGraphs.check_kernels = False``, the "plain" mode);
31. the check window as kernels C1 and C2 (``csrc/check_window.cu``):
    windows recorded from eager solves on the card (``record_checks``:
    the state before the check, the operands, the settings and the chunk
    runner's output) held kernel against plain version: the single QP at
    Dp 128/256/640/896/1024 in fp32 and fp64, y @ M_res and H/A (alpha 1.6),
    the certificates on a feasible and on a primal- and a dual-infeasible
    instance, a phase-A window, a tail, the jump with a ρ stride of 3; the
    batches shared (B 1, 64, 10000; alpha 1.6 with its second launch),
    per problem and heterogeneous (B 16, 1024). Residuals within
    CHECK_RTOL of their scale, the ρ estimate within the tolerance that
    follows, rungs, status, iterations and flags equal except where the
    plain version's value lies within the tolerance of its threshold
    (each such tie logged, with what was decided otherwise), the state's
    vectors bit-equal; the kernel nodes of one captured window of each
    covered path (the single QP with K1 and with the "xla" runner, dense,
    per-problem, hetero, shared alpha, repack, the scenario loop and the
    loop MPC): after the chunk kernel only the check's launches (at most
    1 for C1, 2 for C2); the kernel and the plain check replayed in a CUDA
    graph (CHECK_REPS launches each) per covered shape, beside the bound,
    with the kernel's stage split (``ops.check_window.stage_split``: the
    µs from the earliest block's start to the latest block's pass of each
    stage boundary, mean of 20 launches alone) and the kernel's plan
    (C1: cluster and variant; C2: regime, rows, blocks).

``python3 chip_smoke.py --parent DIR`` runs the same phases and also times
the K1, K2, K3, K4, K5, C1 and C2 of another checkout at DIR (the parent
commit, unpacked by
``git archive`` into a directory that ``.gitignore`` lists) on the same
inputs, built from DIR's own sources into DIR's own build directory.

Every kernel launch counter (C1's and C2's too) is set to 0 just before
each main-path phase
(4, 5, 6, 8, 11, 14, 16, 19, 21, 22, 23, 24, 29, 30, and 25, 26 and 28
in every rank) and read just after; a main-path phase that launched its
kernel no time fails. A kernel, collective or row count captured in a
check window's graph counts once per replay, and in a device program
once per execution of its piece, from the body counts the program reads
back with the solve's result (``core.graphs.on_launch``);
host launches count kernels, graph launches, copies and memsets. The
ranks' K4 and K5 launches add to the record's. A phase that ran K1 must
have run C1, one that ran K4 or K5 C2, except in the ranks of 25, 26 and
28, whose batched windows under a process group keep the plain check; the
unsharded references those are held to bit for bit run the plain check
too (``WindowGraphs.check_kernels = False``). The second-to-last line is
the ``{"kernels": [...]}`` record, the last line ``{"ok": true, "device": {...}}``. Without a GPU, or
without the package beside it, the script exits non-zero before printing a
result.
"""
import contextlib
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


# ``--parent DIR``: the root of another checkout (an unpacked ``git
# archive`` of the parent commit, say) whose K1, K2, K3, K4, K5, C1 and C2
# phases 3, 9, 12, 17, 22, 20 and 31 time beside this checkout's, in turns,
# on the same inputs. Its package is
# imported under PARENT_PKG and builds its kernels into its own _build/.
PARENT_PKG = "_parent_reluqp_tpu_torch"
PARENT_KERNELS = ("fused_step", "solve_kernel", "full_solve",
                  "fused_step_batched", "fused_step_hetero", "check_window")


def parent_module(parent, name):
    """Module ``name`` (e.g. ``"ops.solve_kernel"``) of the package of the
    checkout at ``parent``."""
    import importlib
    import importlib.util
    if PARENT_PKG not in sys.modules:
        root = os.path.join(parent, "reluqp_tpu_torch")
        spec = importlib.util.spec_from_file_location(
            PARENT_PKG, os.path.join(root, "__init__.py"),
            submodule_search_locations=[root])
        pkg = importlib.util.module_from_spec(spec)
        sys.modules[PARENT_PKG] = pkg
        spec.loader.exec_module(pkg)
    return importlib.import_module(f"{PARENT_PKG}.{name}")


def phase_build(parent=None):
    import threading
    import torch
    from reluqp_tpu_torch.ops import cuda_build
    log("card:", card_line())
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  device {torch.cuda.get_device_name(0)}"
        f"  count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    parent_build = None
    if parent:
        parent_build = threading.Thread(target=parent_module(
            parent, "ops.cuda_build").build_all, args=(PARENT_KERNELS,))
        parent_build.start()
    built = cuda_build.build_all()
    if parent_build:
        parent_build.join()
        log(f"built the parent's {', '.join(PARENT_KERNELS)} from {parent}")
    secs = time.perf_counter() - t0
    for name, info in built.items():
        ptxas = [ln.strip() for ln in info["log"].splitlines()
                 if "registers" in ln or "spill" in ln or (
                     name == "check_window" and "entry function" in ln)]
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
    errs, slabs = {}, set()
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
            # the one-iteration window (the loop MPC's ci=1), its own kernel
            rho = torch.tensor([N_RHO - 1], dtype=torch.int32, device=dev)
            out = fused_chunk(bank, b, lo, hi, y, rho, 1, tier)
            ref = fused_chunk_ref(bank, b, lo, hi, y, rho, 1, tier)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            assert float(out[:, d:].abs().max()) == 0.0, (dp, tier, "1 step")
            assert err <= TOL[tier], f"K1 disagrees: Dp={dp} {tier} 1 step: {err:.3e}"
            errs[(dp, tier, "1 step")] = err
        worst = {t: max(v for (p, tt, _), v in errs.items()
                        if p == dp and tt == t)
                 for t in (*banks, "fp64 host")}
        slabs.add(plan["slab"])
        log(f"K1 Dp={dp}: plan {plan}  max|kernel-plain| "
            + "  ".join(f"{t} {e:.2e}" for t, e in worst.items()))
    log(f"K1 1-iteration window at Dp=640: plan {kernel_plan(1, 640, n_steps=1)}")
    # rows > 1 (the batched reuse), fp64 state; R=3 rows at Dp=1024 (a
    # split slab) and fp64 at Dp=896 (a split slab in fp64)
    for rows, dtype, dp in ((16, torch.float32, 640), (1, torch.float64, 640),
                            (3, torch.float32, 1024), (1, torch.float64, 896)):
        wt, b, lo, hi, y, d = kernel_inputs(dp, rows, dtype, gen, dev)
        rho = torch.tensor([5], dtype=torch.int32, device=dev)
        for n in (N_STEPS, 1):
            out = fused_chunk(wt, b, lo, hi, y, rho, n, "highest")
            ref = fused_chunk_ref(wt, b, lo, hi, y, rho, n, "highest")
            err = float((out - ref).abs().max())
            tol = 1e-5 if dtype == torch.float32 else 1e-12
            assert err <= tol, (rows, dtype, n, err)
            assert float(out[:, d:].abs().max()) == 0.0, (rows, dtype, dp, n)
        slabs.add(kernel_plan(rows, dp, dtype)["slab"])
        log(f"K1 Dp={dp} rows={rows} {dtype}: plan "
            f"{kernel_plan(rows, dp, dtype)}  max|kernel-plain| {err:.2e}")
    assert slabs >= {"registers", "smem+registers", "smem+registers+L2"}, \
        slabs
    log("phase 2 OK: K1 matches its plain version on every shape and tier, "
        f"25-step and 1-iteration windows; slab branches reached: "
        f"{sorted(slabs)}")
    return errs


def least_ms(fn, reps):
    """The least time of one ``fn()`` over ``reps`` calls, each between its
    own pair of CUDA events, after one warm-up call."""
    import torch
    fn()
    best = float("inf")
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def graph_ms(fn, reps):
    """The time of one ``fn()`` in ms with no host time between launches:
    ``reps`` calls captured in one CUDA graph, replayed between CUDA events,
    least of three replays, after a warm-up call outside the capture."""
    import torch
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    best = float("inf")
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


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


def phase_timing(card, parent=None):
    """Per-window K1 time beside the plain version, addmm and the bound;
    with ``parent``, the parent's K1 before and after on the same inputs:
    25-step windows by CUDA events and in a CUDA graph, and the
    1-iteration window at Dp=640 in a CUDA graph of 20."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import (fused_chunk, fused_chunk_ref,
                                                 kernel_plan)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    old = parent_module(parent, "ops.fused_step").fused_chunk if parent \
        else None
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

        window = lambda fn, n=N_STEPS: (
            lambda: fn(wt, b, lo, hi, y, rho, n, "highest"))
        if old:
            before = _time_ms(window(old), 200)
        ms = _time_ms(window(fused_chunk), 200)
        if old:
            after = _time_ms(window(old), 200)
            g = [graph_ms(window(f), 20) for f in (old, fused_chunk, old)]
            log(f"phase 3 K1 A/B Dp={dp} ({N_STEPS} steps, fp32 highest): "
                f"parent {before:.5f} ms, this tree {ms:.5f} ms, parent again "
                f"{after:.5f} ms by CUDA events; in a CUDA graph of 20 "
                f"{g[0]:.5f}, {g[1]:.5f}, {g[2]:.5f} ms, on {card}")
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
                        else "operations", plan=kernel_plan(1, dp))
        log(f"K1 timing Dp={dp} (25 steps, fp32 highest): kernel {ms:.5f} ms"
            f"  plain {plain_ms:.5f} ms  addmm+clamp {library_ms:.5f} ms  "
            f"bound {bound_ms:.5f} ms ({rows[dp]['bound_by']}: "
            f"{t_bytes:.5f} ms bytes, {t_ops:.5f} ms flops); plan "
            f"{rows[dp]['plan']}")
        if dp == 640:
            # the loop MPC's 1-iteration window, launch after launch
            one = [graph_ms(window(f, 1), 20)
                   for f in ((old, fused_chunk, old) if old else
                             (fused_chunk,))]
            rows["one_step_ms"] = one[len(one) // 2]
            log(f"phase 3 K1 1-iteration window Dp=640 in a CUDA graph of 20: "
                + (f"parent {one[0]:.5f} ms, this tree {one[1]:.5f} ms, "
                   f"parent again {one[2]:.5f} ms" if old else
                   f"{one[0]:.5f} ms") + f", on {card}")
    log("phase 3 OK")
    return rows


def _counters():
    from reluqp_tpu_torch.ops.fused_step import (fused_chunk,
                                                 fused_chunk_batched,
                                                 fused_chunk_hetero)
    from reluqp_tpu_torch.ops.solve_kernel import (full_rollout,
                                                   full_rollout_batched,
                                                   full_solve)
    return {"K1": fused_chunk, "K2": full_rollout, "K3": full_solve,
            "K4": fused_chunk_batched, "K5": fused_chunk_hetero,
            "K6": full_rollout_batched}


def _check_counters():
    from reluqp_tpu_torch.ops.check_window import batched_check, check_window
    return {"C1": check_window, "C2": batched_check}


# C1's and C2's launches over every main-path phase of this process
CHECK_LAUNCHES = {"C1": 0, "C2": 0}
# the same by phase (`by_phase`)
CHECK_BY_PHASE = {}


def by_phase(phase, *args):
    """``phase(*args)``, its C1 and C2 launches on the main path (the
    change it makes to CHECK_LAUNCHES) logged under its name."""
    before = dict(CHECK_LAUNCHES)
    out = phase(*args)
    d = {k: CHECK_LAUNCHES[k] - before[k] for k in before}
    if any(d.values()):
        CHECK_BY_PHASE[phase.__name__] = d
    return out


def _counted(run, kernel="K1", checks=True):
    """Run one main-path phase with every kernel launch counter set to 0
    first; fail when the phase launched ``kernel`` no time, or (``checks``)
    ran K1 without C1 or K4 or K5 without C2. Returns the phase's result
    and the chunk and solve kernels' launches (C1's and C2's are added to
    CHECK_LAUNCHES: a process group's batched windows keep the plain check,
    so its ranks pass ``checks=False``)."""
    counters = _counters()
    checkers = _check_counters()
    for fn in list(counters.values()) + list(checkers.values()):
        fn.launches = 0
    out = run()
    n = {name: fn.launches for name, fn in counters.items()}
    c = {name: fn.launches for name, fn in checkers.items()}
    assert n[kernel] > 0, f"the main path did not launch {kernel}"
    if checks:
        assert not n["K1"] or c["C1"], "K1 ran without C1"
        assert not (n["K4"] or n["K5"]) or c["C2"], "K4/K5 ran without C2"
    for name, v in c.items():
        CHECK_LAUNCHES[name] += v
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

    (m, res), counts = _counted(run)
    n = counts["K1"]
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

    gpu, counts = _counted(run)
    n = counts["K1"]
    x_cpu = {}
    for nx, inst in insts.items():
        r, secs, dp = gpu[nx]
        m = ReLU_QP()
        m.setup(*inst[:5], precision="float64", device="cpu", **kw)
        rc = m.solve()
        x_gpu = r.x.detach().cpu().double().numpy()
        x_cpu[nx] = rc.x.numpy()
        err = float(np.max(np.abs(x_gpu - x_cpu[nx])))
        assert r.info.status == "solved", (nx, r.info.status)
        assert rc.info.status == "solved", (nx, rc.info.status)
        assert np.all(np.isfinite(x_gpu)) and x_gpu.shape == (nx,)
        assert err < 5e-3, (nx, err)
        log(f"phase 5 nx={nx} (Dp={dp}): gpu fp32 {r.info.status} "
            f"{r.info.iter} it in {secs * 1e3:.1f} ms; cpu fp64 "
            f"{rc.info.iter} it; |x_gpu-x_cpu|inf {err:.2e}")
    log(f"phase 5 OK: reference protocol solved, K1 launches {n}")
    return n, insts, x_cpu


# Smoke configurations: the root bench.py's 100-state MPC (cut in depth
# only), and the double integrator of the JAX package's rollout tests.
MPC_NX, MPC_NU, MPC_H, MPC_T, MPC_T_CMP = 100, 20, 10, 200, 20
MPC_KW = dict(u_min=-1.0, u_max=1.0, prestabilize=True, eps_abs=1e-3,
              max_iter=2000)
# bench.py's two rollout lengths (its two-point fit) and the steps of the
# kernel-alone timing
TWO_POINT_T = (100, 4000)
K2_TIMED_T = 1000
# the fused rollout's two lengths (one K3 launch and the host refresh per
# step make a step slower than the scan path's)
FUSED_TWO_POINT_T = (50, 1000)


def mpc_config(nx=MPC_NX, nu=MPC_NU):
    """``(Ad, Bd, Q, R, x0)`` of a smoke plant."""
    from reluqp_tpu_torch.models.mpc import (double_integrator,
                                             random_linear_system)
    if nx == 2:
        Ad, Bd = double_integrator(dt=0.1)
        return Ad, Bd, np.diag([10.0, 1.0]), np.array([[0.1]]), \
            np.array([1.0, 0.0])
    Ad, Bd = random_linear_system(nx, nu, seed=0, spectral_radius=0.99)
    return Ad, Bd, np.eye(nx), 0.1 * np.eye(nu), \
        0.05 * np.random.RandomState(0).randn(nx)


def check_rollout(tag, xs, us, its, status, ref, max_iter):
    """A 200-step rollout on the card: every step solved, finite, under
    the budget, and its first steps against the CPU fp64 loop rollout
    ``ref``. fp32 on the card against fp64 on the host: while both certify
    at the same checks they differ by fp32 rounding only; a step certified
    one check apart differs by up to the solve tolerance, so the bound is
    eps_abs."""
    assert (status.numpy() == 1).all(), f"{tag}: a control step was not solved"
    xs_g = xs.detach().cpu().double().numpy()
    us_g = us.detach().cpu().double().numpy()
    its = its.numpy()
    assert xs_g.shape == (MPC_T + 1, MPC_NX) and us_g.shape == (MPC_T, MPC_NU)
    assert np.all(np.isfinite(xs_g)) and np.all(np.isfinite(us_g)), tag
    assert int(its.max()) < max_iter, (tag, its.max())
    xs_c, us_c = ref
    dx = float(np.max(np.abs(xs_g[:MPC_T_CMP + 1] - xs_c.numpy())))
    du = float(np.max(np.abs(us_g[:MPC_T_CMP] - us_c.numpy())))
    assert dx < MPC_KW["eps_abs"] and du < MPC_KW["eps_abs"], (tag, dx, du)
    log(f"{tag}: {MPC_T}-step rollout iters/step max {its.max()} mean "
        f"{its.mean():.2f}; first {MPC_T_CMP} steps vs cpu fp64: |dx|inf "
        f"{dx:.2e} |du|inf {du:.2e}")


def phase_mpc(card):
    import torch
    from reluqp_tpu_torch.models.mpc import MPC, mpc_rollout_scan

    Ad, Bd, Q, R, x0 = mpc_config()
    kw = dict(horizon=MPC_H, **MPC_KW)

    def run():
        ctrl = MPC(Ad, Bd, Q, R, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_rollout_scan(ctrl.solver, ctrl.prob, x0, MPC_T,
                               kernel="loop", check_interval="auto",
                               return_stats=True, return_state=True)
        torch.cuda.synchronize()
        return (ctrl, *out, time.perf_counter() - t0)

    (ctrl, xs, us, its, status, y_f, rho_f, secs), counts = _counted(run)
    sol = ctrl.solver
    assert sol.settings.device.type == "cuda" and sol.Dp == 640, sol.Dp
    assert counts["K2"] == 0, counts
    cpu = MPC(Ad, Bd, Q, R, device="cpu", precision="float64", **kw)
    xs_c, us_c, _ = mpc_rollout_scan(cpu.solver, cpu.prob, x0, MPC_T_CMP,
                                     kernel="loop", check_interval="auto")
    ref = (xs_c, us_c)
    check_rollout("phase 6 (loop)", xs, us, its, status, ref,
                  kw["max_iter"])
    rate = MPC_T / secs
    log(f"phase 6 OK: {rate:.1f} steps/s over {MPC_T} steps ({secs:.3f} s "
        f"incl. the ci=1 calibration) on {card}; launches {counts}")
    ctrl.solver.y, ctrl.solver.rho_ind = y_f, rho_f
    profile_steps("phase 6", ctrl, xs[-1], 50, kernel="loop", ci=1)
    return {"launches": counts["K1"], "rate": rate, "ref": ref, "ctrl": ctrl}


def profile_steps(tag, ctrl, x_start, steps, kernel, ci):
    """``profile_run`` over ``steps`` warm MPC steps continuing the
    rollout at window ``ci``."""
    from reluqp_tpu_torch.models.mpc import mpc_rollout_scan
    return profile_run(tag, lambda: mpc_rollout_scan(
        ctrl.solver, ctrl.prob, x_start, steps, kernel=kernel,
        check_interval=ci), steps, f"kernel={kernel}, ci={ci}")


def device_by_kernel(fn, reps):
    """Device time of one ``fn()`` in ms by event name (kernels and
    copies), the largest first; empty when the profiler recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.key_averages():
        t = float(getattr(e, "self_device_time_total", 0.0))
        if e.device_type == DeviceType.CUDA and t > 0.0:
            ms[e.key] = ms.get(e.key, 0.0) + t / 1e3 / reps
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))


def device_ms(fn, reps):
    """Device time of one ``fn()`` in ms: the device-side events (kernels
    and copies) that torch.profiler records over ``reps`` calls, summed;
    the host's launch gaps between them are left out. None when the
    profiler recorded no device event."""
    return sum(device_by_kernel(fn, reps).values()) or None


def device_split(fn, reps):
    """Where one ``fn()`` of a rank's solve goes, in ms: the host wall
    (with the profiler on), the device time of every event and of NCCL's
    kernels alone (a collective's kernel runs until every rank reached it,
    so its time includes the wait on the slowest rank)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    us = lambda evs: sum(float(getattr(e, "self_device_time_total", 0.0))
                         for e in evs)
    return dict(wall=wall * 1e3 / reps, device=us(dev) / 1e3 / reps,
                nccl=us(e for e in dev if "nccl" in e.key.lower()) / 1e3
                / reps)


def launches_between_reads(run):
    """The host's launches (LAUNCH_CALLS) between consecutive host reads
    (``cudaStreamSynchronize``) over one ``run()``, in order: one count
    per read (the launches since the read before it), then the count after
    the last read. torch.profiler's host-side runtime events, by start
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type != DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    segs, n = [], 0
    for e in evs:
        if e.name == "cudaStreamSynchronize":
            segs.append(n)
            n = 0
        elif any(p in e.name for p in LAUNCH_CALLS):
            n += 1
    return segs + [n]


def sync_sites(tag, run, steps, root=None):
    """Where ``run()`` (``steps`` steps) makes the host wait for the card:
    every synchronizing CUDA call under torch's sync debug mode, counted by
    the Python line that made it (and, where that line is torch's, the
    package line that called into torch). A sync whose stack holds no line
    of the package (this checkout's, or the one at ``root``) was not made
    by the solver (``run`` is this script's call into it): it is logged
    with its stack and not counted."""
    import collections
    import traceback
    import warnings
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    name = lambda f: (os.path.relpath(f, here) if f.startswith(here)
                      else "torch/" + f.split("/torch/", 1)[-1])
    pkg = os.path.join(os.path.abspath(root or here), "reluqp_tpu_torch")
    caught, outside = [], []

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        site = f"{name(filename)}:{lineno}"
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack
                if os.path.abspath(f.filename).startswith(pkg)]
        if not ours:
            outside.append(site + " <- " + " <- ".join(
                f"{name(f.filename)}:{f.lineno}" for f in stack[::-1][:6]))
            return
        if not filename.startswith(here):
            site += f" (from {name(ours[-1].filename)}:{ours[-1].lineno})"
        caught.append(site)

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(caught)
    for o in outside:
        log(f"{tag}: a sync outside the package, not counted: {o}")
    log(f"{tag} syncs ({steps} warm steps): {sum(sites.values())} in all, "
        f"{sum(sites.values()) / steps:.2f} per step; by line: "
        + ("; ".join(f"{k} x{v}" for k, v in sites.most_common(8))
           or "none"))
    return sum(sites.values())


# the host's launches onto the card: kernels (cudaLaunchKernel and its Ex
# and cooperative forms), CUDA graphs, copies and memsets
LAUNCH_CALLS = ("cudaLaunch", "cudaGraphLaunch", "cudaMemcpy", "cudaMemset")


def profile_run(tag, run, steps, what):
    """Where a warm control step's time goes: torch.profiler over
    ``run()``, which runs ``steps`` steps. Device time counts the
    device-side events only (kernels and copies); per-call operator
    uploads are spread over the steps. Host launches count every call of
    LAUNCH_CALLS (a graph's replay is one). Returns the per-step numbers
    (None when the profiler recorded no kernel of the path)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    ev = prof.key_averages()
    dev = lambda e: float(getattr(e, "self_device_time_total", 0.0))
    on_dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    busy = sum(dev(e) for e in on_dev) / steps
    per = lambda pat: [e for e in ev if pat in e.key]
    # K4's kernels are k4_kernel (cluster regime) and k4_tile_kernel
    k_us = {k: sum(dev(e) for e in on_dev if e.key.startswith(prefix)
                   or f" {prefix}" in e.key or f"::{prefix}" in e.key
                   or f"){prefix}" in e.key) / steps
            for k, prefix in (("K1", "k1_"), ("K2", "k2_"), ("K3", "k3_"),
                              ("K4", "k4_"), ("K5", "k5_"), ("K6", "k6_"))}
    h2d = sum(e.count for e in per("Memcpy HtoD")) / steps
    syncs = sum(e.count for e in per("cudaStreamSynchronize")) / steps
    calls = {name: sum(e.count for e in ev if e.device_type != DeviceType.CUDA
                       and name in e.key) / steps for name in LAUNCH_CALLS}
    launches = sum(calls.values())
    top = sorted(on_dev, key=dev, reverse=True)[:6]
    if busy <= 0.0 or not any(k_us.values()):
        # instrumentation only: the checks of the phase already passed
        log(f"{tag} profile: device time not measured (the profiler "
            "recorded no kernel of the path)")
        return None
    log(f"{tag} profile ({steps} warm steps, {what}, profiler on): host "
        f"wall {wall_us:.3f} us/step, device busy {busy:.3f} us/step "
        f"({100 * busy / wall_us:.1f}%), "
        + ", ".join(f"{k} {v:.3f} us/step" for k, v in k_us.items() if v)
        + f", {launches:.4f} host launches ("
        + ", ".join(f"{k} {v:.4f}" for k, v in calls.items())
        + f"), {h2d:.4f} H2D copies, {syncs:.4f} stream syncs per step")
    log("  top device ops (us/step): " + "; ".join(
        f"{e.key[:48]} x{e.count / steps:.4f} {dev(e) / steps:.3f}"
        for e in top))
    return dict(wall_us=wall_us, busy_us=busy, launches=launches,
                kernel_launches=calls["cudaLaunch"], syncs=syncs, calls=calls)


# ---------------------------------------------------------------------- #
# K2, the whole-rollout kernel                                            #
# ---------------------------------------------------------------------- #

# name, plant states, inputs, horizon: Dp 640, 128, 896 (the F-w1 edge)
# and 1280, where the fp64 slabs no longer fit shared memory and K2 reads
# its operand columns from L2
K2_CASES = (("100-state h10", 100, 20, 10), ("double integrator h8", 2, 1, 8),
            ("100-state h14", 100, 20, 14), ("100-state h20", 100, 20, 20))
K2_T, K2_CI, K2_NOISE = 20, 5, 0.3
# fp64: kernel and plain version round every fp64 product to fp32, as the
# TPU kernel does, and differ only in the order of the fp64 sums. Where the
# two orders round a product to neighbouring fp32 values, that lane moves
# by one fp32 ulp (6e-8 relative) and the closed loop carries it on, so
# the bound is a few fp32 ulps of the O(1) states, not fp64 rounding.
# Iterations, status and rung must still agree exactly.
K2_TOL64 = 1e-6
# fp32, per tier: the same iterations, status and rung, and trajectories
# within a few times the largest kernel-plain difference read on the H100
# (highest 3.6e-7..2.9e-6, high 6.7e-6, bf16 1.8e-7 over 3 budget-bound
# steps); a tier run at another precision moves them by 1e-3 or more.
K2_TOL32 = {"highest": 1e-5, "high": 2e-5, "bf16": 1e-5}


def k2_call(ctrl, x0, noise, ci, y0=None, rho0=None):
    """K2's call for a controller on the card as the scan path makes it
    (``_scan_call``): ``(args, kw)``, from a cold start unless ``y0`` is
    given."""
    import torch
    from reluqp_tpu_torch.models.mpc import _scan_call
    s = ctrl.solver
    return _scan_call(s, ctrl.prob, x0, noise.shape[0], ci=ci,
                      y0=torch.zeros_like(s.y) if y0 is None else y0,
                      rho_ind0=rho0, noise=noise)


def k2_compare(tag, args, kw, tol, solved):
    """K2 and its plain version on one call: equal per-step iterations,
    rung and status, trajectories within ``tol``, padded y lanes exactly 0,
    and (``solved``) every step solved. Returns the kernel's stats and the
    max difference."""
    import torch
    from reluqp_tpu_torch.ops.solve_kernel import (full_rollout,
                                                   full_rollout_ref)
    out = full_rollout(*args, **kw)
    ref = full_rollout_ref(*args, **kw)
    torch.cuda.synchronize()
    so, sr = out[2].cpu().numpy(), ref[2].cpu().numpy()
    err = max(float((a - b).abs().max()) for a, b in zip(out[:2], ref[:2]))
    n_diff = int((so[:, 0] != sr[:, 0]).sum())
    log(f"{tag}: {kw['n_steps']} steps, iters {int(so[:, 0].sum())} (plain "
        f"{int(sr[:, 0].sum())}), {n_diff} steps differ in iterations, "
        f"rungs {sorted(set(so[:, 4].astype(int).tolist()))}; "
        f"max|kernel-plain| {err:.3e} (bound {tol:g})")
    assert all(bool(torch.isfinite(o).all()) for o in out), tag
    d = kw["nx"] + 2 * kw["nc"]
    assert float(out[3][d:].abs().max()) == 0.0, f"{tag}: padding not inert"
    for lane in (0, 4, 5):   # iterations, rung, status
        assert (so[:, lane] == sr[:, lane]).all(), (tag, lane)
    if solved:
        assert (so[:, 5] == 1).all(), f"{tag}: a step was not solved"
    assert err <= tol, (tag, err)
    return so, err


def phase_k2_check():
    """K2 against full_rollout_ref on the card; returns the max errors."""
    from reluqp_tpu_torch.models.mpc import MPC
    from reluqp_tpu_torch.ops.solve_kernel import rollout_plan
    errs, moved, streamed = {}, {}, False
    for name, nx, nu, horizon in K2_CASES:
        Ad, Bd, Q, R, x0 = mpc_config(nx, nu)
        noise = K2_NOISE * np.random.RandomState(3).randn(K2_T, nx)
        for precision in ("float64", "float32"):
            ctrl = MPC(Ad, Bd, Q, R, horizon=horizon, precision=precision,
                       **MPC_KW)
            args, kw = k2_call(ctrl, x0, noise, K2_CI)
            dp = ctrl.solver.Dp
            plan = rollout_plan(dp, kw["nxp"], kw["ncp"], kw["nup"],
                                kw["nplp"], args[0].shape[0],
                                ctrl.solver.settings.precision_dtype)
            streamed |= not plan["resident"]
            log(f"K2 {name} Dp={dp} {precision}: plan {plan}")
            fp64 = precision == "float64"
            so, err = k2_compare(
                f"K2 {name} Dp={dp} {precision} highest", args, kw,
                K2_TOL64 if fp64 else K2_TOL32["highest"], solved=not fp64)
            moved[name] = moved.get(name, False) or \
                len(set(so[:, 4].tolist())) > 1
            errs[(dp, precision)] = err
            if dp == 640 and not fp64:
                check_k2_tiers(ctrl, x0, noise)
    assert all(moved.values()), f"the rung never moved: {moved}"
    assert streamed, "no case ran K2 with its operands streamed from L2"
    log("phase 7 OK: K2 matches its plain version at every Dp, fp64 and "
        "fp32 in every tier, and every case moved the rung")
    return errs


def check_k2_tiers(ctrl, x0, noise):
    """The reduced iteration tiers once each (fp32, Dp=640): "high" to
    eps over the cold disturbed run, "bf16" over 3 budget-bound steps
    (bf16 iterates do not reach eps 1e-3)."""
    import torch
    for tier, T, mi in (("high", K2_T, None), ("bf16", 3, 25)):
        args, kw = k2_call(ctrl, x0, noise[:T], K2_CI)
        if tier == "bf16":
            args[0] = args[0].to(torch.bfloat16)
        kw["iter_precision"] = tier
        if mi:
            kw["max_iter"] = mi
        k2_compare(f"K2 Dp=640 fp32 tier {tier}", args, kw, K2_TOL32[tier],
                   solved=tier == "high")


def phase_scan(card, mpc):
    """The main path of this slice: the phase-6 rollout through K2."""
    import torch
    from reluqp_tpu_torch.models.mpc import MPC, mpc_rollout_scan

    Ad, Bd, Q, R, x0 = mpc_config()
    kw = dict(horizon=MPC_H, **MPC_KW)
    ctrl = MPC(Ad, Bd, Q, R, **kw)
    total = 0
    for kernel in ("scan", "auto"):
        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mpc_rollout_scan(ctrl.solver, ctrl.prob, x0, MPC_T,
                                   kernel=kernel, check_interval="auto",
                                   return_stats=True, return_state=True)
            torch.cuda.synchronize()
            return (*out, time.perf_counter() - t0)

        (xs, us, its, status, y_f, rho_f, secs), counts = _counted(run, "K2")
        assert counts == {"K1": 0, "K2": 2, "K3": 0, "K4": 0, "K5": 0,
                          "K6": 0}, \
            (kernel, counts)
        check_rollout(f"phase 8 (kernel={kernel})", xs, us, its, status,
                      mpc["ref"], kw["max_iter"])
        log(f"phase 8 kernel={kernel}: {MPC_T / secs:.1f} steps/s over "
            f"{MPC_T} steps ({secs:.3f} s incl. the first call's operand "
            f"build and the ci=1 calibration); launches {counts}")
        total += counts["K2"]
    log(f"phase 8 OK on {card}: K2 launches {total}, K1 launches 0")
    return {"launches": total, "ctrl": ctrl, "its": its, "xs": xs,
            "y_f": y_f, "rho_f": rho_f}


def k2_bound_ms(ctrl, args, kw, stats):
    """Least time per control step of this run's work, in ms, and what
    bounds it. Each product counts only the multiply-adds its operand's
    nonzero entries need, so the padding, the zero blocks of M_res and
    GL, and the zero rows and columns of the bank count nothing; S_u
    selects and scales nu lanes (nu multiplies). Operations per step: the
    refresh x@GL, the bias x@M_aff[k] (once: a rung change inside a step
    needs another), y@S_u and u@Bdw; per window the residuals y@M_res;
    per iteration y@W[k]. W and M_aff count at the fewest nonzeros among
    the rungs the steps ended on. (The TPU kernel's own cost estimate omits
    the refresh and the plant products.) Bytes: the nonzeros of every
    operand (each rung the steps ended on) read once and amortised over
    the steps, the real bounds, y in and out, g, x0 and the ladder, plus
    each step's noise, x, u and stats rows at their real widths."""
    import torch
    Wt, bias_c, M_aff, rhos, M_res, _, GL, _, _, S_u, Bdw = args[:11]
    nnz = lambda a: int(torch.count_nonzero(a))
    nu, npl = ctrl.prob.K.shape
    nx, nc = kw["nx"], kw["nc"]
    d = nx + 2 * nc
    rungs = sorted(set(stats[:, 4].astype(int).tolist()))
    n_w = min(nnz(Wt[k]) for k in rungs)
    n_aff = min(nnz(M_aff[k]) for k in rungs)
    T = stats.shape[0]
    iters = float(stats[:, 0].sum())
    windows = iters / kw["check_interval"]
    flops = (T * (2 * nnz(GL) + 2 * n_aff + nnz(S_u) + 2 * nnz(Bdw))
             + windows * 2 * nnz(M_res) + iters * 2 * n_w)
    # rungs (W, M_aff, bias_c row), M_res, GL, S_u, Bdw, lo0/hi0 over the
    # nc constraint lanes, y0 in and y_f out, g0w, x0, rhos
    fill = (sum(nnz(Wt[k]) + nnz(M_aff[k]) + nnz(bias_c[k]) for k in rungs)
            + nnz(M_res) + nnz(GL) + nnz(S_u) + nnz(Bdw) + 2 * nc + 2 * d
            + nx + npl + rhos.numel()) * Wt.element_size()
    rows = (2 * npl + nu) * Wt.element_size() + 8 * 4
    t_bytes = (fill / T + rows) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / T / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops, flops / T


def phase_scan_timing(card, scan, loop_rate, parent=None):
    """K2 on the main path's configuration: steps/s by bench.py's
    two-point protocol, kernel time per step by CUDA events, the plain
    version and the bound, and a profiler pass."""
    import torch
    from reluqp_tpu_torch.models.mpc import auto_check_interval, \
        mpc_rollout_scan
    from reluqp_tpu_torch.ops.solve_kernel import (full_rollout,
                                                   full_rollout_ref,
                                                   rollout_plan)
    ctrl = scan["ctrl"]
    _, _, _, _, x0 = mpc_config()
    rng = np.random.RandomState(7)

    def rollout_s(T):
        x = x0 + 5e-5 * rng.randn(MPC_NX)   # fresh inputs every call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, _, _ = mpc_rollout_scan(ctrl.solver, ctrl.prob, x, T,
                                    kernel="scan", check_interval="auto")
        float(xs[-1].sum())
        return time.perf_counter() - t0

    lo, hi = TWO_POINT_T
    t_lo = min(rollout_s(lo) for _ in range(5))
    t_hi = min(rollout_s(hi) for _ in range(5))
    step_s = (t_hi - t_lo) / (hi - lo)
    log(f"phase 9 two-point (T={lo}: {t_lo * 1e3:.3f} ms, T={hi}: "
        f"{t_hi * 1e3:.3f} ms, min of 5): {step_s * 1e6:.3f} us/step = "
        f"{1 / step_s:.1f} steps/s through kernel='scan' against "
        f"{loop_rate:.1f} steps/s on the loop path (phase 6), on {card}")

    # the kernel alone: one 1000-step launch continuing the rollout at the
    # tuned window, timed with CUDA events
    st = ctrl.solver.settings
    ci = auto_check_interval(scan["its"][:8].numpy(), st.check_interval,
                             st.max_iter)
    T = K2_TIMED_T
    xl = scan["xs"][-1].cpu().double().numpy()
    args, kw = k2_call(ctrl, xl, np.zeros((T, MPC_NX)), ci, y0=scan["y_f"],
                       rho0=scan["rho_f"])

    def per_step_ms(rollout):
        rollout(*args, **kw)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = rollout(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / T, out

    if parent:
        old = parent_module(parent, "ops.solve_kernel").full_rollout
        before, ref = per_step_ms(old)
    ms, out = per_step_ms(full_rollout)
    if parent:
        after, _ = per_step_ms(old)
        same = all(bool(torch.equal(a, b)) for a, b in zip(out, ref))
        log(f"phase 9 K2 A/B ({T} warm steps, ci={ci}): parent "
            f"{before * 1e3:.3f} us/step, this tree {ms * 1e3:.3f} us/step, "
            f"parent again {after * 1e3:.3f} us/step; outputs bit-equal to "
            f"the parent's: {same}, on {card}")
    stats = out[2].cpu().numpy()
    assert (stats[:, 5] == 1).all(), "a timed step was not solved"
    T_p = 50
    args_p, kw_p = k2_call(ctrl, xl, np.zeros((T_p, MPC_NX)), ci,
                           y0=scan["y_f"], rho0=scan["rho_f"])
    t0 = time.perf_counter()
    full_rollout_ref(*args_p, **kw_p)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / T_p
    bound, by, t_b, t_o, flops = k2_bound_ms(ctrl, args, kw, stats)
    log(f"phase 9 K2 alone ({T} warm steps, ci={ci}, iters/step "
        f"{stats[:, 0].mean():.3f}): {ms * 1e3:.3f} us/step by CUDA events; "
        f"plain version {plain_ms:.3f} ms/step; bound {bound * 1e3:.4f} "
        f"us/step ({by}: {t_b * 1e3:.4f} us bytes, {t_o * 1e3:.4f} us "
        f"operations, {flops:.0f} flop/step at the operands' nonzeros; the "
        f"TPU kernel's cost estimate omits the refresh and plant products), "
        f"{ms / bound:.0f}x the bound, on {card}")
    split = k2_split(card, lambda fn: (lambda: fn(*args, **kw)), parent)
    sp = split["this tree"]
    assert sp["barriers_per_launch"] == 1 and \
        sp["barriers_per_warm_step"] == 0, ("K2's grid barriers", sp)
    ctrl.solver.y, ctrl.solver.rho_ind = scan["y_f"], scan["rho_f"]
    profile_steps("phase 9", ctrl, scan["xs"][-1], T, kernel="scan", ci=ci)
    plan = rollout_plan(args[0].shape[1], kw["nxp"], kw["ncp"], kw["nup"],
                        kw["nplp"], args[0].shape[0], args[0].dtype)
    log(f"phase 9 K2 plan: {plan}")
    log("phase 9 OK")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                ci=ci, step_s=step_s, plan=plan, split=split)


def k2_split(card, fn_of, parent=None):
    """The stage split of one K2 launch, ``fn_of(full_rollout)`` run alone
    in a CUDA graph (``ops.solve_kernel.k2_stage_split``), for this tree
    and, where ``parent`` has the stamps, the parent's kernel; logged with
    the grid barriers block 0 took, returned by tree."""
    from reluqp_tpu_torch.ops.solve_kernel import (full_rollout,
                                                   k2_stage_split)
    out = {"this tree": k2_stage_split(fn_of(full_rollout))}
    if parent:
        pm = parent_module(parent, "ops.solve_kernel")
        if hasattr(pm, "k2_stage_split"):
            out["parent"] = pm.k2_stage_split(fn_of(pm.full_rollout))
        else:
            log("phase 9 K2 split: the parent has no stage stamps")
    for who, sp in out.items():
        log(f"phase 9 K2 split ({who}), mean of 20 launches of "
            f"{sp['steps']:.0f} steps: launch {sp['launch']:.2f} us, staged "
            f"{sp['staged']:.2f} us per launch; per step, us: "
            + ", ".join(f"{k} {sp[k]:.3f}" for k in (
                "refresh", "bias", "iteration", "exchange", "check",
                "reduced", "plant", "x exchange", "step"))
            + f"; total {sp['total']:.2f} us; grid barriers "
            f"{sp['barriers_per_launch']:.0f} per launch, "
            f"{sp['barriers_per_warm_step']:.3f} per warm step; on {card}")
    return out


# ---------------------------------------------------------------------- #
# K3, the whole-solve kernel                                              #
# ---------------------------------------------------------------------- #

# (Dp, nx): rand_qp(nx, nx/4, nx/4) has D = 2·nx, padded to Dp; 896 is the
# F-w1 edge (no multiple of 256), 768 and 1024 the protocol's nx 323, 500,
# and at 1280 the fp64 slabs no longer fit shared memory (read from L2)
K3_SIZES = ((128, 60), (256, 100), (640, 300), (768, 323), (896, 400),
            (1024, 500), (1280, 640))
# Kernel against plain version, relative to max(1, |y|inf). The plain
# version sums every product in the kernel's order and rounding, so the two
# agree bit for bit (read: 0 in every case on the H100); the bound only
# leaves room for the device's logf against torch.log on a rho jump (a
# nearest rung at an exact tie) and for bf16 conversions of an fp64 state.
# Iterations, status, rung and the reduced-phase count must agree exactly.
K3_TOL = {"float64": 1e-6, "float32": 1e-4}
# the two infeasible instances of the certificate tests
PINF = (np.eye(2), np.zeros(2), np.array([[1.0, 0.0], [1.0, 0.0],
                                          [0.0, 1.0]]),
        np.array([1.0, -np.inf, -1.0]), np.array([np.inf, -1.0, 1.0]))
DINF = (np.diag([1.0, 0.0]), np.array([0.0, 1.0]), np.array([[1.0, 0.0]]),
        np.array([-1.0]), np.array([1.0]))


def fused_solver(data, **kw):
    from reluqp_tpu_torch import ReLU_QP
    m = ReLU_QP()
    m.setup(*data, backend="fused", **kw)
    return m


def k3_compare(tag, op, kw, y0, rho0, tol, bias=None, expect=None,
               exact=False):
    """K3 and its plain version on one call: equal iterations, rung,
    status and reduced-phase count, y within ``tol`` relative to
    max(1, |y|inf) (``exact``: y and the stats bit-equal), padded lanes
    exactly 0. Returns the kernel's stats and the absolute and relative
    differences."""
    import torch
    from reluqp_tpu_torch.ops.solve_kernel import full_solve, full_solve_ref
    out = full_solve(op, y0, rho0, bias, **kw)
    ref = full_solve_ref(op, y0, rho0, bias, **kw)
    torch.cuda.synchronize()
    so, sr = out[1].cpu().numpy(), ref[1].cpu().numpy()
    err = float((out[0] - ref[0]).abs().max())
    rel = err / max(1.0, float(ref[0].abs().max()))
    log(f"{tag}: iters {int(so[0])} (plain {int(sr[0])}), rung "
        f"{int(so[4])}, status {int(so[5])}, reduced-phase iters "
        f"{int(so[6])}; max|kernel-plain| {err:.3e} ({rel:.3e} relative, "
        f"bound {tol:g})")
    d = kw["nx"] + 2 * kw["nc"]
    assert bool(torch.isfinite(out[0]).all()), tag
    assert bool((out[0][d:] == 0).all()), f"{tag}: padding not inert"
    for lane in (0, 4, 5, 6):   # iterations, rung, status, reduced phase
        assert so[lane] == sr[lane], (tag, lane, so, sr)
    if expect is not None:
        assert so[5] == expect, (tag, so)
    assert rel <= tol, (tag, rel)
    if exact:
        assert torch.equal(out[0], ref[0]) and (so == sr).all(), \
            f"{tag}: not bit-equal to the plain version"
    return so, err, rel


def k3_solver_compare(tag, m, tol, expect=None, exact=False):
    """``k3_compare`` on a set-up solver's own call, from a cold start."""
    import torch
    op, kw = m._fused_call()
    return k3_compare(tag, op, kw, torch.zeros_like(m.y), m.rho_ind, tol,
                      expect=expect, exact=exact)


def capture_stdout(fn):
    """Run ``fn`` with the process's file descriptor 1 sent to a file (the
    kernel's printf writes there at the next synchronisation); returns
    ``(fn(), text)``."""
    import ctypes
    import tempfile
    import torch
    libc = ctypes.CDLL(None)
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile() as tmp:
        os.dup2(tmp.fileno(), 1)
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            sys.stdout.flush()
            libc.fflush(None)
            os.dup2(saved, 1)
            os.close(saved)
        tmp.seek(0)
        return out, tmp.read().decode()


def phase_k3_check():
    """K3 against full_solve_ref on the card; returns the errors."""
    import contextlib
    import io
    import torch
    from reluqp_tpu_torch.models import mpc as M
    from reluqp_tpu_torch.ops.solve_kernel import (full_solve,
                                                   full_solve_ref,
                                                   solve_plan)
    from reluqp_tpu_torch.utils.problems import canonical_qp, rand_qp
    # every branch of the plan (staging by cp.async, through registers for
    # a bf16 bank, none where the slabs are read from L2; one or two tagged
    # words a value) bit-equal to the plain version
    errs, branches = {}, set()
    for dp, nx in K3_SIZES:
        data = rand_qp(nx, nx // 4, nx // 4, seed=1, compute_sol=False)[:5]
        for precision in ("float64", "float32"):
            m = fused_solver(data, precision=precision, eps_abs=1e-4,
                             scaling=True)
            assert m.Dp == dp, (m.Dp, dp)
            plan = solve_plan(dp, m._nxp, m._ncp,
                              dtype=m.settings.precision_dtype)
            branches.add((plan["staging"], plan["words_per_value"]))
            log(f"K3 Dp={dp} {precision}: plan {plan}")
            _, err, rel = k3_solver_compare(f"K3 Dp={dp} {precision}", m,
                                            K3_TOL[precision], exact=True)
            errs[(dp, precision)] = err

    # the options, each on its own, in fp64 unless a tier asks for fp32
    small = rand_qp(60, 15, 15, seed=2, compute_sol=False)[:5]
    f64 = dict(precision="float64", eps_abs=1e-5)
    f32 = dict(precision="float32", eps_abs=1e-4, scaling=True)
    cases = (
        ("rho_jump", small, dict(f64, rho_jump=True), 1),
        ("stride 3", small, dict(f64, adaptive_rho_interval=60), 1),
        ("alpha 1.6", small, dict(f64, alpha=1.6), 1),
        ("alpha 1.6 fp32", small, dict(f32, alpha=1.6), 1),
        ("primal infeasible", PINF, dict(f64, check_infeasibility=True), 2),
        ("dual infeasible", DINF, dict(f64, check_infeasibility=True), 3),
        ("feasible, certificates on", small,
         dict(f64, check_infeasibility=True), 1),
        ("refine high fp32", small, dict(f32, iter_precision="high"), 1),
        # the solver stores a bf16 bank and, as the JAX package does, the
        # polish runs on it: this solve stops at max_iter (ROADMAP §C)
        ("refine bf16 fp32, bf16 bank", small,
         dict(f32, iter_precision="bf16"), 0),
        ("refine default fp32", small, dict(f32, iter_precision="default"),
         1),
        ("tail window (max_iter 110)", small,
         dict(f64, max_iter=110, eps_abs=1e-12), 0),
        ("budget below one window", small, dict(f64, max_iter=10), 0),
    )
    for name, data, kw, expect in cases:
        m = fused_solver(data, **kw)
        tol = K3_TOL[m.settings.precision]
        bank = m._fused_call()[0].Wt_bank.dtype
        if bank == torch.bfloat16:
            plan = solve_plan(m.Dp, m._nxp, m._ncp,
                              dtype=m.settings.precision_dtype, w_dtype=bank)
            branches.add((plan["staging"], plan["words_per_value"]))
            log(f"K3 {name}: plan {plan}")
        so, err, _ = k3_solver_compare(f"K3 {name} (Dp={m.Dp})", m, tol,
                                       expect=expect,
                                       exact=bank == torch.bfloat16)
        if "refine" in name:
            assert 0 < so[6] <= so[0], (name, so)
        errs[name] = err
    # the bf16 tier on the fp32 bank (the solver's polish copy): the fast
    # phase casts it in the kernel and the polish certifies eps
    m = fused_solver(small, iter_precision="bf16", **f32)
    op, kw = m._fused_call()
    so, err, _ = k3_compare("K3 refine bf16 fp32, fp32 bank (Dp=128)",
                            op._replace(Wt_bank=m._W_hi), kw,
                            torch.zeros_like(m.y), m.rho_ind, K3_TOL["float32"],
                            expect=1)
    assert 0 < so[6] < so[0], so
    errs["refine bf16, fp32 bank"] = err

    # the state-affine bias at the main path's shape: the fused rollout's
    # first step of the 100-state h10 controller, cold
    Ad, Bd, Q, R, x0 = mpc_config()
    for precision in ("float64", "float32"):
        ctrl = M.MPC(Ad, Bd, Q, R, horizon=MPC_H, precision=precision,
                     **MPC_KW)
        s = ctrl.solver
        ops = M._fused_operands(s, ctrl.prob)
        x = torch.as_tensor(x0, dtype=s.settings.precision_dtype,
                            device="cuda")
        op, bias = M._fused_step(s, ops, x)
        _, err, _ = k3_compare(
            f"K3 affine bias, 100-state h10 step (Dp={s.Dp}) {precision}",
            op, M._fused_kw(s, ops), torch.zeros_like(s.y), s.rho_ind,
            K3_TOL[precision], bias=bias, expect=1)
        errs[("affine", precision)] = err

    # verbose: the kernel's printf lines equal the plain version's
    m = fused_solver(canonical_qp()[:5], verbose=True, **f64)
    op, kw = m._fused_call()
    y0 = torch.zeros_like(m.y)
    (_, st), text_k = capture_stdout(lambda: full_solve(op, y0, m.rho_ind,
                                                        **kw))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        full_solve_ref(op, y0, m.rho_ind, **kw)
    lines_k = [ln for ln in text_k.splitlines() if ln.startswith("Iter:")]
    lines_p = [ln for ln in buf.getvalue().splitlines()
               if ln.startswith("Iter:")]
    assert lines_k and lines_k == lines_p, (lines_k, lines_p)
    log(f"K3 verbose: {len(lines_k)} lines printed by the kernel equal the "
        f"plain version's, the last {lines_k[-1]!r}")
    want = {("cp.async", 1), ("cp.async", 2), ("none", 2), ("loads", 1)}
    assert want <= branches, f"plan branches run: {branches}"
    log("phase 10 OK: K3 matches its plain version at every Dp, fp64 and "
        "fp32, and in every option, bit for bit on every plan branch "
        f"{sorted(branches)}; max|kernel-plain| {max(errs.values()):.3e}")
    return errs


def phase_fused_main(card, mpc, protocol):
    """The main path of this slice: ``backend="fused"`` on the canonical QP
    and the reference protocol, and the 200-step MPC rollout through
    ``kernel="fused"``; one K3 launch per solve, no K1 or K2 launch."""
    import torch
    from reluqp_tpu_torch.models.mpc import MPC, mpc_rollout_scan
    from reluqp_tpu_torch.utils.problems import canonical_qp
    qp = canonical_qp()
    res, counts = _counted(
        lambda: fused_solver(qp[:5], eps_abs=1e-4).solve(), "K3")
    assert counts == {"K1": 0, "K2": 0, "K3": 1, "K4": 0, "K5": 0,
                      "K6": 0}, counts
    x = res.x.detach().cpu().double().numpy()
    assert res.info.status == "solved" and np.allclose(x, qp.x_sol,
                                                       atol=1e-3), x
    log(f"phase 11 canonical QP (backend='fused'): x={x} iters "
        f"{res.info.iter}, launches {counts}")
    total = 1
    _, insts, x_cpu = protocol
    for nx, inst in insts.items():
        m = fused_solver(inst[:5], precision="float32", eps_abs=1e-4,
                         scaling=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r, counts = _counted(m.solve, "K3")
        secs = time.perf_counter() - t0
        assert counts == {"K1": 0, "K2": 0, "K3": 1, "K4": 0, "K5": 0,
                          "K6": 0}, \
            (nx, counts)
        xg = r.x.detach().cpu().double().numpy()
        err = float(np.max(np.abs(xg - x_cpu[nx])))
        assert r.info.status == "solved", (nx, r.info.status)
        assert np.all(np.isfinite(xg)) and xg.shape == (nx,)
        assert err < 5e-3, (nx, err)
        log(f"phase 11 protocol nx={nx} (Dp={m.Dp}, backend='fused', fp32): "
            f"{r.info.iter} it in {secs * 1e3:.3f} ms (first solve); "
            f"|x-x_cpu_fp64|inf {err:.2e}; launches {counts}")
        total += 1
    Ad, Bd, Q, R, x0 = mpc_config()
    ctrl = MPC(Ad, Bd, Q, R, horizon=MPC_H, **MPC_KW)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mpc_rollout_scan(ctrl.solver, ctrl.prob, x0, MPC_T,
                               kernel="fused", check_interval="auto",
                               return_stats=True, return_state=True)
        torch.cuda.synchronize()
        return (*out, time.perf_counter() - t0)

    (xs, us, its, status, y_f, rho_f, secs), counts = _counted(run, "K3")
    assert counts == {"K1": 0, "K2": 0, "K3": MPC_T, "K4": 0, "K5": 0,
                      "K6": 0}, \
        counts
    check_rollout("phase 11 (kernel=fused)", xs, us, its, status,
                  mpc["ref"], MPC_KW["max_iter"])
    log(f"phase 11 kernel=fused: {MPC_T / secs:.1f} steps/s over {MPC_T} "
        f"steps ({secs:.3f} s incl. the operand build and the ci=1 "
        f"calibration); launches {counts}")
    total += counts["K3"]
    log(f"phase 11 OK on {card}: K3 launches {total}, K1 and K2 launches 0")
    return {"launches": total, "ctrl": ctrl, "its": its, "xs": xs,
            "y_f": y_f, "rho_f": rho_f}


def k3_bound_ms(op, kw, stats, bias=None):
    """Least time of one solve's work, in ms, and what bounds it. Each
    product counts only the multiply-adds its operand's nonzero entries
    need: per iteration y@W[k], per check (the tail is one) y@M_res, and
    with a state-affine ``bias`` (M_aff, x_row) per window x@M_aff[k]. W
    counts at the rung the solve ended on (the stats name no other).
    Bytes: the nonzeros of that rung, of M_res, of the rung's bias row and
    of M_aff[k] read once, the real bounds (2·nc), the g row (nx), x, y in
    and out (2·D), the ladder and the stats row."""
    import torch
    nnz = lambda a: int(torch.count_nonzero(a))
    nx, nc, ci = kw["nx"], kw["nc"], kw["check_interval"]
    iters, k = float(stats[0]), int(stats[4])
    checks = -(-iters // ci)
    n_w = nnz(op.Wt_bank[k])
    flops = iters * 2 * n_w + checks * 2 * nnz(op.M_res)
    size = op.Wt_bank.element_size()
    n_aff = 0
    if bias is not None:
        n_aff = nnz(bias[0][k]) + bias[1].numel()
        flops += checks * 2 * nnz(bias[0][k])
    nbytes = ((n_w + nnz(op.M_res) + nnz(op.b_bank[k]) + n_aff + 2 * nc + nx
               + 2 * (nx + 2 * nc)) * size + op.rhos.numel() * 4 + 8 * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops, flops


def k3_split(tag, card, fn_of, parent=None):
    """The stage split of one K3 launch, ``fn_of(full_solve)`` run alone
    in a CUDA graph (``ops.solve_kernel.k3_stage_split``), for this tree
    and, where ``parent`` has the stamps, the parent's kernel; logged,
    returned by tree."""
    from reluqp_tpu_torch.ops.solve_kernel import full_solve, k3_stage_split
    out = {"this tree": k3_stage_split(fn_of(full_solve))}
    if parent:
        pm = parent_module(parent, "ops.solve_kernel")
        if hasattr(pm, "k3_stage_split"):
            out["parent"] = pm.k3_stage_split(fn_of(pm.full_solve))
        else:
            log(f"phase 12 K3 split {tag}: the parent has no stage stamps")
    for who, sp in out.items():
        log(f"phase 12 K3 split {tag} ({who}), us, mean of 20: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sp.items())
            + f"; on {card}")
    return out


def k3_warm_operands(ctrl, x, y, rho):
    """The fused rollout's warm solve after state ``x`` from ``y``, ``rho``
    (ci=1): ``(fn_of, (op, bias, kw))``, ``fn_of(full_solve)`` a call of
    that solve."""
    import torch
    from reluqp_tpu_torch.models import mpc as M
    sv = ctrl.solver
    ops = M._fused_operands(sv, ctrl.prob)
    x = torch.as_tensor(x).to(device=sv.y.device,
                              dtype=sv.settings.precision_dtype)
    op_w, bias_w = M._fused_step(sv, ops, x)
    kw_w = M._fused_kw(sv, ops, ci=1)
    return (lambda fn: (lambda: fn(op_w, y, rho, bias_w, **kw_w))), (
        op_w, bias_w, kw_w)


def k3_protocol_operands(nx):
    """The protocol's cold solve at ``nx`` (fp32, Ruiz, eps 1e-4):
    ``(fn_of, solver, instance)``, ``fn_of(full_solve)`` a call of it."""
    import torch
    from reluqp_tpu_torch.utils.problems import rand_qp
    inst = rand_qp(nx, nx // 4, nx // 4, seed=0, compute_sol=False)[:5]
    m = fused_solver(inst, precision="float32", eps_abs=1e-4, scaling=True)
    op, kw = m._fused_call()
    y0 = torch.zeros_like(m.y)
    rho0 = m.rho_ind
    return (lambda fn: (lambda: fn(op, y0, rho0, **kw))), m, inst


def k3_ab(card, cases, parent=None):
    """Each K3 case (tag -> ``fn_of``, a solve that must certify) timed by
    CUDA events, the "warm" one per launch in a CUDA graph of 20 (a
    launch's host time exceeds the solve's), with ``parent`` by turns
    (parent, this tree, parent) and its outputs asserted bit-equal to this
    tree's; then its stage split (``k3_split``). Returns tag -> dict(ms,
    turns, stats, split)."""
    import torch
    from reluqp_tpu_torch.ops.solve_kernel import full_solve
    old = parent_module(parent, "ops.solve_kernel").full_solve \
        if parent else None
    out = {}
    for tag, fn_of in cases.items():
        y, st = fn_of(full_solve)()
        torch.cuda.synchronize()
        assert bool(torch.isfinite(y).all()) and float(st[5]) == 1.0, st
        time_of = (lambda f: graph_ms(f, 20)) if tag == "warm" else \
            (lambda f: _time_ms(f, 20))
        if old:
            yo, so = fn_of(old)()
            assert torch.equal(y, yo) and torch.equal(st, so), \
                f"K3 differs from the parent's ({tag})"
            g = [time_of(fn_of(f)) for f in (old, full_solve, old)]
            log(f"phase 12 K3 A/B {tag} ({int(st[0])} it): parent "
                f"{g[0]:.5f} ms, this tree {g[1]:.5f} ms, parent again "
                f"{g[2]:.5f} ms; bit-equal, on {card}")
            ms = g[1]
        else:
            g = [time_of(fn_of(full_solve))]
            ms = g[0]
            log(f"phase 12 K3 {tag} ({int(st[0])} it): {ms:.5f} ms, on "
                f"{card}")
        out[tag] = dict(ms=ms, turns=g, stats=st.cpu().numpy(),
                        split=k3_split(tag, card, fn_of, parent))
    return out


def phase_k3_split(card, parent=None, steps=20):
    """K3 alone (a short chip call after a K3 change): ``k3_ab`` on the
    protocol's cold solves and on the fused rollout's warm solve after a
    ``steps``-step rollout."""
    from reluqp_tpu_torch.models.mpc import MPC, mpc_rollout_scan
    cases = {f"nx={nx}": k3_protocol_operands(nx)[0]
             for nx in (100, 323, 500)}
    Ad, Bd, Q, R, x0 = mpc_config()
    ctrl = MPC(Ad, Bd, Q, R, horizon=MPC_H, **MPC_KW)
    xs, _, _, _, y_f, rho_f = mpc_rollout_scan(
        ctrl.solver, ctrl.prob, x0, steps, kernel="fused",
        check_interval="auto", return_stats=True, return_state=True)
    cases["warm"] = k3_warm_operands(ctrl, xs[-1], y_f, rho_f)[0]
    return k3_ab(card, cases, parent)


def phase_k3_timing(card, fused, loop_rate, scan_step_s, parent=None):
    """K3 per solve at the protocol's sizes by CUDA events, beside the loop
    path's solve() on the same instance, the plain version and the bound,
    and on the fused rollout's own warm solve (200 of K3's launches on the
    main path: the operands of the step after phase 11's rollout, from its
    final state and rung, ci=1), each with its stage split and, with
    ``parent``, the parent's by turns (``k3_ab``); the fused MPC rollout's
    steps/s by bench.py's two-point protocol."""
    import torch
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.models.mpc import mpc_rollout_scan
    from reluqp_tpu_torch.ops.solve_kernel import full_solve_ref
    kw_p = dict(precision="float32", eps_abs=1e-4, scaling=True)
    prot = {nx: k3_protocol_operands(nx) for nx in (100, 323, 500)}
    ctrl = fused["ctrl"]
    sv = ctrl.solver
    warm, (op_w, bias_w, kw_w) = k3_warm_operands(
        ctrl, fused["xs"][-1], fused["y_f"], fused["rho_f"])
    cases = {f"nx={nx}": p[0] for nx, p in prot.items()}
    ab = k3_ab(card, dict(cases, warm=warm), parent)
    rows = {}
    for nx, (_, m, inst) in prot.items():
        op, kw = m._fused_call()
        y0 = torch.zeros_like(m.y)
        stats, ms = ab[f"nx={nx}"]["stats"], ab[f"nx={nx}"]["ms"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full_solve_ref(op, y0, m.rho_ind, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        loop = ReLU_QP()
        loop.setup(*inst, **kw_p)
        loop_s = []
        for _ in range(3):
            loop.clear_primal_dual()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = loop.solve()
            loop_s.append(time.perf_counter() - t0)
            assert r.info.status == "solved"
        bound, by, t_b, t_o, flops = k3_bound_ms(op, kw, stats)
        rows[nx] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                        bound_by=by, loop_ms=min(loop_s) * 1e3,
                        iters=int(stats[0]), dp=m.Dp,
                        split=ab[f"nx={nx}"]["split"])
        log(f"phase 12 K3 nx={nx} (Dp={m.Dp}, fp32, cold, {int(stats[0])} "
            f"it, rung {int(stats[4])}): {ms:.5f} ms per solve by CUDA "
            f"events ({ms * 1e3 / stats[0]:.3f} us/iteration); loop path "
            f"solve() {min(loop_s) * 1e3:.3f} ms (min of 3, {r.info.iter} "
            f"it); plain version {plain_ms:.3f} ms; bound {bound:.6f} ms "
            f"({by}: {t_b:.6f} ms bytes, {t_o:.6f} ms operations, "
            f"{flops:.0f} flop at the operands' nonzeros), "
            f"{ms / bound:.0f}x the bound, on {card}")
    warm_ms, st_w = ab["warm"]["ms"], ab["warm"]["stats"]
    wb, wby, wt_b, wt_o, _ = k3_bound_ms(op_w, kw_w, st_w, bias_w)
    log(f"phase 12 K3 on the fused rollout's warm solve (Dp={sv.Dp}, fp32, "
        f"ci=1, {int(st_w[0])} iteration(s)): {warm_ms:.5f} ms per solve in "
        f"a CUDA graph of 20; bound {wb:.6f} ms ({wby}: {wt_b:.6f} ms "
        f"bytes, {wt_o:.6f} ms operations), {warm_ms / wb:.1f}x the bound, "
        f"on {card}")
    _, _, _, _, x0 = mpc_config()
    rng = np.random.RandomState(8)

    def rollout_s(T):
        x = x0 + 5e-5 * rng.randn(MPC_NX)   # fresh inputs every call
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, _, _ = mpc_rollout_scan(ctrl.solver, ctrl.prob, x, T,
                                    kernel="fused", check_interval="auto")
        float(xs[-1].sum())
        return time.perf_counter() - t0

    lo, hi = FUSED_TWO_POINT_T
    t_lo = min(rollout_s(lo) for _ in range(5))
    t_hi = min(rollout_s(hi) for _ in range(5))
    step_s = (t_hi - t_lo) / (hi - lo)
    log(f"phase 12 two-point (T={lo}: {t_lo * 1e3:.3f} ms, T={hi}: "
        f"{t_hi * 1e3:.3f} ms, min of 5): {step_s * 1e6:.3f} us/step = "
        f"{1 / step_s:.1f} steps/s through kernel='fused', against "
        f"{1 / scan_step_s:.1f} steps/s through kernel='scan' (phase 9) and "
        f"{loop_rate:.1f} on the loop path (phase 6), on {card}")
    st = ctrl.solver.settings
    from reluqp_tpu_torch.models.mpc import auto_check_interval
    ci = auto_check_interval(fused["its"][:8].numpy(), st.check_interval,
                             st.max_iter)
    ctrl.solver.y, ctrl.solver.rho_ind = fused["y_f"], fused["rho_f"]
    profile_steps("phase 12", ctrl, fused["xs"][-1], 200, kernel="fused",
                  ci=ci)
    log("phase 12 OK")
    from reluqp_tpu_torch.ops.solve_kernel import solve_plan
    m100 = rows[100]
    plan = solve_plan(m100["dp"], 128, 128)
    log(f"phase 12 K3 plan at the protocol's nx=100: {plan}")
    return dict(rows=rows, step_s=step_s, warm_ms=warm_ms,
                warm_split=ab["warm"]["split"], warm_iters=int(st_w[0]),
                plan=plan, warm_bound_ms=wb)


# ---------------------------------------------------------------------- #
# K4, the batched chunk kernel, and K6, the batched whole-rollout kernel  #
# ---------------------------------------------------------------------- #

K4_BATCHES = (1, 8, 64, 256)
K4_DPS = (128, 640, 896)
# the shared north-star batch's width and rows (phase 22), and a ragged B
# that is no multiple of any row tile (its last K4_PAD_ROWS rows inert)
K4_WIDE = ((128, 10000), (128, 1003))
# rows r of a B=K4_SUBSET_B launch run alone must give the full launch's
# bits: each output's sum runs in an order fixed by Dp and the tier alone
K4_SUBSET_B, K4_SUBSET_ROWS, K4_SUBSET_DPS = 10000, (1, 37, 5000), (128, 640)
# Kernel against plain version after 25 steps, as TOL for K1 (fp32): the
# kernel sums each row's products in its own order, cuBLAS in another. In
# fp64 "highest" differs by fp64 rounding only; "high" splits the fp32
# rounding of y (the kernel) or y itself (the plain version) into bf16
# parts, which agree but at ties; the bf16 tiers re-round y every step.
K4_TOL = {"float32": {"highest": 1e-5, "high": 1e-5, "default": 3e-2,
                      "bf16": 3e-2},
          "float64": {"highest": 1e-12, "high": 1e-5, "default": 3e-2}}
# padded rows at the end of a batch of 8 or more
K4_PAD_ROWS = 3


def k4_inputs(dp, rows, dtype, gen, device):
    """Random K4 inputs: K1's (inner width D < Dp, inert lanes) with the
    last rows of a batch of 8 or more inert (b = 0, ±inf bounds, y = 0)."""
    wt, b, lo, hi, y, d = kernel_inputs(dp, rows, dtype, gen, device)
    n_pad = K4_PAD_ROWS if rows >= 8 else 0
    if n_pad:
        b[-n_pad:] = 0.0
        lo[-n_pad:] = -float("inf")
        hi[-n_pad:] = float("inf")
        y[-n_pad:] = 0.0
    return wt, b, lo, hi, y, d, n_pad


def phase_k4_check():
    """K4 against fused_chunk_batched_ref on the card, every tier, fp32
    and fp64, at K4_BATCHES x K4_DPS and the K4_WIDE shapes; padded lanes
    and rows exactly 0; each shape's plan logged with its regime; then the
    rows of a subset launch bit-equal to the same rows of the full batch.
    Returns the max errors."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import (batched_plan,
                                                 fused_chunk_batched,
                                                 fused_chunk_batched_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    errs = {}
    shapes = [(dp, rows) for dp in K4_DPS for rows in K4_BATCHES]
    regimes = set()
    for dtype in (torch.float32, torch.float64):
        tols = K4_TOL[str(dtype).split(".")[1]]
        for dp, rows in shapes + list(K4_WIDE):
            wt, b, lo, hi, y, d, n_pad = k4_inputs(dp, rows, dtype, gen, dev)
            worst = {}
            for tier in tols:
                bank = wt.to(torch.bfloat16) if tier == "bf16" else wt
                plan = batched_plan(rows, dp, dtype, bank.dtype, tier)
                regimes.add(plan["regime"])
                rho = torch.tensor([N_RHO - 1 if tier == "high" else 4],
                                   dtype=torch.int32, device=dev)
                out = fused_chunk_batched(bank, b, lo, hi, y, rho, N_STEPS,
                                          tier)
                ref = fused_chunk_batched_ref(bank, b, lo, hi, y, rho,
                                              N_STEPS, tier)
                torch.cuda.synchronize()
                tag = (dtype, dp, rows, tier)
                assert torch.isfinite(out).all(), tag
                assert float(out[:, d:].abs().max()) == 0.0, \
                    f"K4 padded lanes not inert: {tag}"
                if n_pad:
                    assert float(out[-n_pad:].abs().max()) == 0.0, \
                        f"K4 padded rows not inert: {tag}"
                err = float((out - ref).abs().max())
                assert err <= tols[tier], f"K4 disagrees: {tag} {err:.3e}"
                errs[tag] = worst[tier] = err
                log(f"K4 {str(dtype)[6:]} Dp={dp} B={rows} {tier}: plan "
                    f"{plan}  max|kernel-plain| {err:.2e}")
    # a row's result depends on neither B nor the tile it falls in
    for dp in K4_SUBSET_DPS:
        wt, b, lo, hi, y, _, _ = k4_inputs(dp, K4_SUBSET_B, torch.float32,
                                           gen, dev)
        rho = torch.tensor([4], dtype=torch.int32, device=dev)
        full = fused_chunk_batched(wt, b, lo, hi, y, rho, N_STEPS)
        for r in K4_SUBSET_ROWS:
            part = fused_chunk_batched(
                wt, *(t[:r].contiguous() for t in (b, lo, hi, y)), rho,
                N_STEPS)
            assert torch.equal(part, full[:r]), \
                f"K4 rows differ between B={r} and B={K4_SUBSET_B}: Dp={dp}"
            log(f"K4 Dp={dp}: the first {r} rows alone (plan "
                f"{batched_plan(r, dp)}) bit-equal to them in the B="
                f"{K4_SUBSET_B} launch (plan {batched_plan(K4_SUBSET_B, dp)})")
    log(f"phase 13 OK: K4 matches its plain version at every B, Dp, tier "
        f"and dtype (regimes {sorted(regimes)}); padded lanes and rows stay "
        f"0; rows bit-equal across B at Dp {K4_SUBSET_DPS}")
    return errs


# The scenario configuration: benchmarks/scenario_mpc.py's (the root
# bench.py plant, u in [-1, 1] through the per-stage control rows), B = 64,
# X0 = 0.05·randn and then the per-scenario process noise 0.01·randn(T, B,
# nx) from one seeded generator.
SCEN_B, SCEN_T, SCEN_T_CMP = 64, 200, 20
SCEN_KW = dict(eps_abs=1e-3, check_interval=25)
SCEN_NOISE = 0.01
# the two rollout lengths of each path's two-point fit (the loop path is
# host-bound, a few ms per step)
SCEN_LOOP_T, SCEN_SCAN_T = (5, 30), (20, 200)
K6_TIMED_T = 200
# the ensemble sizes K6 is timed at (benchmarks/scenario_mpc.py's), and
# the steps that warm a fresh solver first
K6_TIMED_B, K6_WARM_T = (16, 64, 256), 20


def scenario_problem(nx=MPC_NX, nu=MPC_NU, horizon=MPC_H):
    """The condensed scenario-MPC QP of benchmarks/scenario_mpc.py (the
    double integrator at nx=2)."""
    from reluqp_tpu_torch.models.mpc import gen_condensed_mpc_qp, ihlqr
    Ad, Bd, Q, R, _ = mpc_config(nx, nu)
    K, Qf = ihlqr(Ad, Bd, Q, R)
    ns = nu + nx
    rows = []
    for k in range(horizon):
        r = np.zeros((nu, horizon * ns))
        r[:, k * ns:k * ns + nu] = np.eye(nu)
        rows.append(r)
    return gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, horizon, np.vstack(rows),
                                -np.ones(horizon * nu),
                                np.ones(horizon * nu), K=K)


def scenario_solver(prob, B, **kw):
    from reluqp_tpu_torch import BatchedReLU_QP
    m = BatchedReLU_QP()
    m.setup(prob.H, np.tile(prob.g0, (B, 1)), prob.A,
            np.tile(prob.l0, (B, 1)), np.tile(prob.u0, (B, 1)),
            **dict(SCEN_KW, **kw))
    return m


def scenario_inputs(B, T=0, nx=MPC_NX, seed=0):
    """Seeded initial plant states and per-scenario process noise from one
    generator: 0.05·randn(B, nx), then SCEN_NOISE·randn(T, B, nx), as
    benchmarks/scenario_mpc.py draws them for the 100-state plant; [1, 0] +
    0.2·randn for the double integrator, as the JAX package's scenario tests
    do (a state near 0 leaves residuals at the fp32 rounding of 0)."""
    rng = np.random.RandomState(seed)
    if nx == 2:
        X0 = np.array([[1.0, 0.0]]) + 0.2 * rng.randn(B, 2)
    else:
        X0 = 0.05 * rng.randn(B, nx)
    return X0, SCEN_NOISE * rng.randn(T, B, nx)


def scenario_vectors(prob, X):
    """The (g, l, u) rows of the scenarios' QPs at plant states X (B, nx)."""
    shift = X @ prob.lu_x0.T
    return (prob.g0[None] + X @ prob.g_x0.T, prob.l0[None] + shift,
            prob.u0[None] + shift)


# name, plant states, inputs, horizon: Dp 128, 640, 896, 1280 (as K2's
# phase 7 cases)
K6_CASES = (("double integrator h8", 2, 1, 8), ("100-state h10", 100, 20, 10),
            ("100-state h14", 100, 20, 14), ("100-state h20", 100, 20, 20))
K6_BATCHES = (5, 64, 256)
K6_T, K6_CI, K6_NOISE = 10, 5, 0.3
# Kernel against plain version: both round every product to fp32 and sum
# it in fp64, in different orders (the kernel per thread, the plain version
# through cuBLAS), so they differ by an fp32 ulp where a product lies within
# fp64 rounding of an fp32 tie, and the closed loop carries that on: a few
# fp32 ulps of the O(1) states (read on the H100: at most 1.8e-7 in fp64,
# 2.4e-7 in fp32). The iterations, rung and status lanes must agree exactly.
K6_TOL = {"float64": 1e-6, "float32": 1e-5}


def k6_call(m, prob, B, noise, ci):
    """K6's call for the first B scenarios of a batch solver set up for
    more, from a cold start (``_scenario_scan_call`` with ``rows=B``)."""
    import torch
    from reluqp_tpu_torch.models.mpc import _scenario_scan_call
    npl = prob.K.shape[1]
    return _scenario_scan_call(m, prob, scenario_inputs(B, nx=npl)[0],
                               noise.shape[0], ci=ci,
                               Y0=torch.zeros_like(m.Y), noise=noise[:, :B],
                               rows=B)


def k6_compare(tag, args, kw, B, tol, solved=True):
    """K6 and its plain version on one call of B scenarios: equal per-step
    iterations, rung and status, trajectories within ``tol``, padded y
    lanes and rows exactly 0, and (``solved``) every step solved. Returns
    the kernel's stats, the max difference and the kernel's slab loads (its
    first block's)."""
    import torch
    from reluqp_tpu_torch.ops.solve_kernel import (full_rollout_batched,
                                                   full_rollout_batched_ref)
    out = full_rollout_batched(*args, **kw)
    loads = int(full_rollout_batched.slab_loads)
    ref = full_rollout_batched_ref(*args, **kw)
    torch.cuda.synchronize()
    so, sr = out[2].cpu().numpy(), ref[2].cpu().numpy()
    err = max(float((a - b).abs().max()) for a, b in zip(out[:2], ref[:2]))
    log(f"{tag}: {kw['n_steps']} steps, iters {int(so[:, 0].sum())} (plain "
        f"{int(sr[:, 0].sum())}), rungs "
        f"{sorted(set(so[:, 4].astype(int).tolist()))}, unsolved "
        f"{int(so[:, 6].sum())}, slab loads {loads}; max|kernel-plain| "
        f"{err:.3e} (bound {tol:g})")
    assert all(bool(torch.isfinite(o).all()) for o in out), tag
    d = kw["nx"] + 2 * kw["nc"]
    assert float(out[3][:, d:].abs().max()) == 0.0, f"{tag}: lanes not inert"
    n_pad = out[3].shape[0] - B
    if n_pad:
        assert float(out[3][-n_pad:].abs().max()) == 0.0, \
            f"{tag}: padded rows not inert"
    for lane in (0, 4, 5, 6):   # iterations, rung, status, unsolved rows
        assert (so[:, lane] == sr[:, lane]).all(), (tag, lane, so[:, lane],
                                                    sr[:, lane])
    assert not solved or (so[:, 5] == 1).all(), f"{tag}: a step was not solved"
    assert err <= tol, (tag, err)
    return so, err, loads


def phase_k6_check():
    """K6 against full_rollout_batched_ref on the card, logging the plan
    each case takes; every branch of the plan is reached (a 16-block
    cluster with the slab in shared memory, a partial last row tile, the
    slab read from L2) and a rung change reloads the slab. Returns the max
    errors."""
    from reluqp_tpu_torch.ops.solve_kernel import rollout_batched_plan
    errs, moved, plans = {}, {}, []
    reloaded = False
    for name, nx, nu, horizon in K6_CASES:
        prob = scenario_problem(nx, nu, horizon)
        noise = K6_NOISE * np.random.RandomState(5).randn(
            K6_T, max(K6_BATCHES), nx)
        for precision in ("float64", "float32"):
            m = scenario_solver(prob, max(K6_BATCHES), precision=precision)
            for B in K6_BATCHES:
                args, kw = k6_call(m, prob, B, noise, K6_CI)
                bp = args[11].shape[0]
                plan = rollout_batched_plan(
                    bp, m.Dp, kw["nxp"], kw["ncp"], kw["nup"], kw["nplp"],
                    m.settings.precision_dtype)
                so, err, loads = k6_compare(
                    f"K6 {name} Dp={m.Dp} B={B} (Bp={bp}) {precision} (plan "
                    f"{plan})", args, kw, B, K6_TOL[precision])
                rungs = [int(args[15])] + so[:, 4].astype(int).tolist()
                changes = sum(a != b for a, b in zip(rungs, rungs[1:]))
                if plan["slab_in_smem"]:
                    # one load at the start, and one more at least for
                    # every rung change between steps
                    assert loads >= 1 + changes, (name, B, loads, changes)
                    reloaded = reloaded or loads > 1
                else:
                    assert loads == 0, (name, B, loads)
                plans.append(dict(plan, bp=bp))
                moved[name] = moved.get(name, False) or len(set(rungs)) > 1
                errs[(m.Dp, B, precision)] = err
    assert all(moved.values()), f"the rung never moved: {moved}"
    # the reduced iteration tiers once each: "high" on the fp32 bank, "bf16"
    # on a bf16 bank (without refinement a bf16 iteration may stop short of
    # eps, so its steps need not be solved: the lanes must still agree)
    name, nx, nu, horizon = K6_CASES[0]
    prob = scenario_problem(nx, nu, horizon)
    noise = K6_NOISE * np.random.RandomState(5).randn(K6_T, K6_BATCHES[0],
                                                       nx)
    for tier in ("high", "bf16"):
        m = scenario_solver(prob, K6_BATCHES[0], precision="float32",
                            iter_precision=tier, refine=False)
        args, kw = k6_call(m, prob, K6_BATCHES[0], noise, K6_CI)
        errs[(m.Dp, K6_BATCHES[0], tier)] = k6_compare(
            f"K6 {name} Dp={m.Dp} B={K6_BATCHES[0]} float32 {tier} tier "
            f"({args[0].dtype} bank)", args, kw, K6_BATCHES[0],
            K6_TOL["float32"], solved=tier != "bf16")[1]
    branches = {
        "16-block clusters, slab in shared memory": any(
            p["cluster"] == 16 and p["slab_in_smem"] for p in plans),
        "a partial last row tile": any(
            p["bp"] % p["rows_per_tile"] for p in plans),
        "slab read from L2": any(not p["slab_in_smem"] for p in plans),
        "a slab reload on a rung change": reloaded}
    log("phase 15 plan branches reached: " + "; ".join(
        f"{k}: {v}" for k, v in branches.items()))
    assert all(branches.values()), branches
    log("phase 15 OK: K6 matches its plain version at every Dp and B, fp64 "
        "and fp32")
    return errs


def check_scenario(tag, out, ref, max_iter):
    """A 200-step B=64 scenario rollout on the card: every step solved (the
    status lane is the min over the scenarios, so every scenario solved;
    none can be infeasible here), finite, under the budget, and its first
    steps against the CPU fp64 loop rollout ``ref`` within eps_abs (see
    ``check_rollout``)."""
    xs, us, its, status = out[:4]
    assert (status.numpy() == 1).all(), f"{tag}: a step was not solved"
    xs_g = xs.detach().cpu().double().numpy()
    us_g = us.detach().cpu().double().numpy()
    its = its.numpy()
    assert xs_g.shape == (SCEN_T + 1, SCEN_B, MPC_NX), xs_g.shape
    assert us_g.shape == (SCEN_T, SCEN_B, MPC_NU), us_g.shape
    assert np.all(np.isfinite(xs_g)) and np.all(np.isfinite(us_g)), tag
    assert int(its.max()) < max_iter, (tag, its.max())
    xs_c, us_c = ref
    dx = float(np.max(np.abs(xs_g[:SCEN_T_CMP + 1] - xs_c)))
    du = float(np.max(np.abs(us_g[:SCEN_T_CMP] - us_c)))
    assert dx < SCEN_KW["eps_abs"] and du < SCEN_KW["eps_abs"], (tag, dx, du)
    log(f"{tag}: {SCEN_T}-step B={SCEN_B} rollout, collective iters/step "
        f"max {its.max()} mean {its.mean():.2f}; first {SCEN_T_CMP} steps "
        f"vs cpu fp64: |dx|inf {dx:.2e} |du|inf {du:.2e}")
    return xs_g, us_g


def profile_scenario(tag, m, prob, x_start, steps, kernel, ci):
    """``profile_run`` over ``steps`` warm scenario steps continuing from
    the solver's state."""
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    return profile_run(tag, lambda: scenario_rollout_scan(
        m, prob, x_start, steps, kernel=kernel, check_interval=ci), steps,
        f"kernel={kernel}, ci={ci}, B={m.B_n}")


def phase_scenario_loop(card):
    """The main path of this slice through K4: ``BatchedReLU_QP.setup`` on
    the card, one ``solve()`` of the 64 scenarios' first QPs, and the
    200-step scenario loop rollout; K4 launches only; against the CPU fp64
    batch solve and loop rollout."""
    import torch
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    prob = scenario_problem()
    X0, noise = scenario_inputs(SCEN_B, SCEN_T)
    g, l, u = scenario_vectors(prob, X0)

    def solve():
        m = scenario_solver(prob, SCEN_B)
        m.update(g=g, l=l, u=u)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.solve()
        return m, res, time.perf_counter() - t0

    (m, res, secs), counts = _counted(solve, "K4")
    assert all(n == 0 for k, n in counts.items() if k != "K4"), counts
    assert m.settings.device.type == "cuda" and m._use_pallas
    assert (m.Dp, m.B_pad, len(m.rhos_np)) == (640, SCEN_B, 18), \
        (m.Dp, m.B_pad, len(m.rhos_np))
    cpu = scenario_solver(prob, SCEN_B, precision="float64", device="cpu",
                          backend="xla")
    cpu.update(g=g, l=l, u=u)
    rc = cpu.solve()
    x_g = res.x.detach().cpu().double().numpy()
    err = float(np.max(np.abs(x_g - rc.x.numpy())))
    info = res.info
    assert info.status.all() and rc.info.status.all()
    assert x_g.shape == (SCEN_B, m.nx) and np.all(np.isfinite(x_g))
    assert err < 5e-3, err
    log(f"phase 14 solve(): {SCEN_B} QPs (nx={m.nx}, nc={m.nc}, Dp={m.Dp}) "
        f"all solved in {info.n_iter_total} collective iterations "
        f"(per problem {info.iter.min()}..{info.iter.max()}), "
        f"{secs * 1e3:.3f} ms; cpu fp64 {rc.info.n_iter_total} iterations; "
        f"|x-x_cpu|inf {err:.2e}; launches {counts}")
    n_k4 = counts["K4"]

    def rollout():
        m.clear_primal_dual()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scenario_rollout_scan(m, prob, X0, SCEN_T, kernel="loop",
                                    noise=noise, return_stats=True,
                                    return_state=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (out, secs), counts = _counted(rollout, "K4")
    assert all(n == 0 for k, n in counts.items() if k != "K4"), counts
    cpu.clear_primal_dual()
    xs_c, us_c, _ = scenario_rollout_scan(cpu, prob, X0, SCEN_T_CMP,
                                          kernel="loop",
                                          noise=noise[:SCEN_T_CMP])
    ref = (xs_c.numpy(), us_c.numpy())
    xs, us = check_scenario("phase 14 (kernel=loop)", out, ref,
                            m.settings.max_iter)
    log(f"phase 14 kernel=loop: {SCEN_T / secs:.1f} steps/s "
        f"({SCEN_B * SCEN_T / secs:.0f} scenario solves/s) over {SCEN_T} "
        f"steps on {card}; launches {counts}")
    n_k4 += counts["K4"]
    log(f"phase 14 OK: K4 launches {n_k4}, no other kernel")
    return {"launches": n_k4, "prob": prob, "m": m, "ref": ref, "xs": xs,
            "us": us, "out": out, "its": out[2]}


def phase_scenario_scan(card, loop):
    """The main path through K6: the phase-14 rollout through
    ``kernel="scan"`` (one segment, one K6 launch) and ``kernel="auto"``
    with ``check_interval="auto"`` (calibration + continuation, two K6
    launches), no other kernel; held against phase 14's loop rollout and
    the CPU fp64 one."""
    import torch
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    prob = loop["prob"]
    X0, noise = scenario_inputs(SCEN_B, SCEN_T)
    total, res = 0, {}
    for kernel, ci, want in (("scan", None, 1), ("auto", "auto", 2)):
        m = scenario_solver(prob, SCEN_B)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = scenario_rollout_scan(m, prob, X0, SCEN_T, kernel=kernel,
                                        check_interval=ci, noise=noise,
                                        return_stats=True, return_state=True)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        (out, secs), counts = _counted(run, "K6")
        assert counts == {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
                          "K6": want}, \
            (kernel, counts)
        tag = f"phase 16 (kernel={kernel}, check_interval={ci})"
        xs, us = check_scenario(tag, out, loop["ref"], m.settings.max_iter)
        # against phase 14's loop rollout on the card, all 200 steps: both
        # certify every step at eps_abs, so they differ by up to eps_abs
        dx = float(np.max(np.abs(xs - loop["xs"])))
        du = float(np.max(np.abs(us - loop["us"])))
        assert dx < SCEN_KW["eps_abs"] and du < SCEN_KW["eps_abs"], \
            (tag, dx, du)
        log(f"{tag}: {SCEN_T / secs:.1f} steps/s over {SCEN_T} steps "
            f"({secs:.3f} s incl. the operand build); vs phase 14's loop "
            f"rollout |dx|inf {dx:.2e} |du|inf {du:.2e}; launches {counts}")
        total += counts["K6"]
        res[kernel] = (m, out)
    log(f"phase 16 OK on {card}: K6 launches {total}, no other kernel")
    m, out = res["scan"]
    return {"launches": total, "m": m, "xs": out[0], "y_f": out[4],
            "rho_f": out[5]}


def k4_bound_ms(W, B, d, steps):
    """Least time of one K4 window on this run's data, in ms: the rung's
    nonzeros times the real rows, 2 flops per multiply-add per step (fp32
    outside tensor cores); bytes: the rung's nonzeros read once, and b, lo,
    hi, Y in and Y out at the real rows and width."""
    import torch
    nnz = int(torch.count_nonzero(W))
    flops = 2.0 * steps * B * nnz
    nbytes = (nnz + 5 * B * d) * W.element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def k6_bound_ms(m, prob, kw, stats):
    """Least time per control step of a K6 run, in ms: ``k2_bound_ms``'s
    count (each operand at its nonzeros) for each of the real scenario
    rows, whose per-step products run once per row; the operands
    (``_scenario_scan_operands``) are read once for the whole ensemble."""
    import torch
    from reluqp_tpu_torch.models.mpc import _scenario_scan_operands
    from reluqp_tpu_torch.ops.fused_step import pad_dim
    ops = _scenario_scan_operands(m, prob, pad_dim(m.D))
    Wt, bias_c, M_aff, M_res = ops["Wt"], ops["bias_c"], ops["M_aff"], \
        ops["M_res"]
    GL, S_u, Bdw, rhos = ops["GL"], ops["S_u"], ops["Bdw"], m.rhos
    nnz = lambda a: int(torch.count_nonzero(a))
    nu, npl = prob.K.shape
    nx, nc, B = kw["nx"], kw["nc"], m.B_n
    d = nx + 2 * nc
    rungs = sorted(set(stats[:, 4].astype(int).tolist()))
    n_w = min(nnz(Wt[k]) for k in rungs)
    n_aff = min(nnz(M_aff[k]) for k in rungs)
    T = stats.shape[0]
    iters = float(stats[:, 0].sum())
    windows = iters / kw["check_interval"]
    flops = B * (T * (2 * nnz(GL) + 2 * n_aff + nnz(S_u) + 2 * nnz(Bdw))
                 + windows * 2 * nnz(M_res) + iters * 2 * n_w)
    fill = (sum(nnz(Wt[k]) + nnz(M_aff[k]) + nnz(bias_c[k]) for k in rungs)
            + nnz(M_res) + nnz(GL) + nnz(S_u) + nnz(Bdw) + 2 * nc + nx
            + rhos.numel() + B * (2 * d + npl)) * Wt.element_size()
    rows = B * (2 * npl + nu) * Wt.element_size() + 8 * 4
    t_bytes = (fill / T + rows) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / T / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops, flops / T


def k6_warm_timing(card, prob, B, m=None, x_start=None, y0=None,
                   rho0=None):
    """K6 alone per warm ensemble step at B scenarios of the scenario
    configuration (Dp=640, fp32): launches of K6_TIMED_T undisturbed warm
    steps from one warm state -- the given solver's (plant states
    ``x_start``, solver states ``y0``, rung ``rho0``), else a fresh
    solver's after a K6_WARM_T-step scan rollout under process noise --
    timed by CUDA events (three launches after one to warm up; the least
    is the row's time), beside the plain version (10 steps, host clock)
    and the bound. Returns ``(row, the last launch's output, solver)``."""
    import torch
    from reluqp_tpu_torch.models.mpc import (_scenario_scan_call,
                                             scenario_rollout_scan)
    from reluqp_tpu_torch.ops.solve_kernel import (full_rollout_batched,
                                                   full_rollout_batched_ref,
                                                   rollout_batched_plan)
    if m is None:
        m = scenario_solver(prob, B)
        X0, noise = scenario_inputs(B, K6_WARM_T)
        xs, _, _, _, y0, rho0 = scenario_rollout_scan(
            m, prob, X0, K6_WARM_T, kernel="scan", noise=noise,
            return_stats=True, return_state=True)
        x_start = xs[-1]
    if isinstance(x_start, torch.Tensor):
        x_start = x_start.cpu().double().numpy()
    T = K6_TIMED_T
    args, kw = _scenario_scan_call(m, prob, x_start, T, Y0=y0,
                                   rho_ind0=rho0)
    Yk = args[11]
    plan = rollout_batched_plan(Yk.shape[0], Yk.shape[1], kw["nxp"],
                                kw["ncp"], kw["nup"], kw["nplp"], Yk.dtype)
    full_rollout_batched(*args, **kw)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = full_rollout_batched(*args, **kw)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / T)
    stats = out[2].cpu().numpy()
    assert (stats[:, 5] == 1).all(), f"B={B}: a timed step was not solved"
    T_p = 10
    args_p, kw_p = _scenario_scan_call(m, prob, x_start, T_p, Y0=y0,
                                       rho_ind0=rho0)
    full_rollout_batched_ref(*args_p, **kw_p)   # warm up (cuBLAS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full_rollout_batched_ref(*args_p, **kw_p)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3 / T_p
    bound, by, t_b, t_o, flops = k6_bound_ms(m, prob, kw, stats)
    ms = min(times)
    row = dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by, plan=plan,
               launch_ms=ms * T)
    log(f"phase 17 K6 alone B={B} ({T} warm steps per launch, ci="
        f"{kw['check_interval']}, collective iters/step "
        f"{stats[:, 0].mean():.3f}, rungs "
        f"{sorted(set(stats[:, 4].astype(int).tolist()))}, plan {plan}): "
        f"{ms * 1e3:.3f} us/step by CUDA events (launches: "
        + ", ".join(f"{t * 1e3:.3f}" for t in times)
        + f" us/step; {ms * T:.3f} ms per launch); plain version "
        f"{plain:.3f} ms/step; bound {bound * 1e3:.4f} us/step ({by}: "
        f"{t_b * 1e3:.4f} us bytes, {t_o * 1e3:.4f} us operations, "
        f"{flops:.0f} flop/step at the operands' nonzeros), "
        f"{ms / bound:.0f}x the bound, on {card}")
    return row, out, m


def phase_scenario_timing(card, loop, scan, parent=None):
    """K4 per 25-step window on the main path's bank and state (CUDA
    events, then device time) beside its plain version, 25 ``torch.addmm``
    + clamp and the bound (with ``parent``, beside the parent's K4 before
    and after), and on one row tile of 1 and of 8 rows; K6 per warm
    step at B = 16, 64 and 256 beside its plain version and the bound
    (``k6_warm_timing``); two-point steps/s of the loop and scan paths; a
    profiler pass over each; the loop path's synchronizing calls."""
    import torch
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    from reluqp_tpu_torch.ops.fused_step import (batched_plan,
                                                 fused_chunk_batched)
    m, prob = loop["m"], loop["prob"]
    k4 = k4_window_timing(card, 17, m, parent, reps=100)
    # the cluster regime is the parent's code: the same bits
    assert not parent or k4["same_as_parent"], "K4 differs from the parent's"
    W, b, lo, hi, Y, rho = k4.pop("operands")
    # one row tile (one cluster) at 1 and at 8 rows: whether the rows'
    # multiply-adds or the per-iteration exchange and barrier set its time
    for rows in (1, 8):
        t = _time_ms(lambda: fused_chunk_batched(
            W, b[:rows].contiguous(), lo[:rows].contiguous(),
            hi[:rows].contiguous(), Y[:rows].contiguous(), rho, N_STEPS), 50)
        log(f"phase 17 K4 one row tile of {rows} row(s) "
            f"({batched_plan(rows, m.Dp)}): {t:.5f} ms per window")
    # the reduced tiers on the same window
    for tier, bank in (("high", W), ("bf16", W.to(torch.bfloat16))):
        t = _time_ms(lambda: fused_chunk_batched(bank, b, lo, hi, Y, rho,
                                                 N_STEPS, tier), 30)
        plan = batched_plan(m.B_pad, m.Dp, w_dtype=bank.dtype,
                            iter_precision=tier)
        log(f"phase 17 K4 {tier} tier ({plan}): {t:.5f} ms per window")

    # K6 alone per warm step at B = 16, 64 and 256; at B = 64 continuing the
    # scan rollout of phase 16
    k6_rows = {}
    for B in K6_TIMED_B:
        if B == SCEN_B:
            k6_rows[B], out, s = k6_warm_timing(
                card, prob, B, scan["m"], scan["xs"][-1], scan["y_f"],
                scan["rho_f"])
        else:
            k6_rows[B] = k6_warm_timing(card, prob, B)[0]
    k6 = k6_rows[SCEN_B]
    stats = out[2].cpu().numpy()
    T = K6_TIMED_T

    # two-point steps/s, a fresh X0 every call
    X0 = scenario_inputs(SCEN_B)[0]
    rng = np.random.RandomState(11)
    rates = {}
    for kernel, (t_lo, t_hi) in (("loop", SCEN_LOOP_T),
                                 ("scan", SCEN_SCAN_T)):
        def rollout_s(T_):
            x = X0 + 5e-5 * rng.randn(*X0.shape)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs, _, _ = scenario_rollout_scan(m, prob, x, T_, kernel=kernel)
            float(xs[-1].sum())
            return time.perf_counter() - t0

        s_lo = min(rollout_s(t_lo) for _ in range(3))
        s_hi = min(rollout_s(t_hi) for _ in range(3))
        step_s = (s_hi - s_lo) / (t_hi - t_lo)
        rates[kernel] = 1.0 / step_s
        log(f"phase 17 two-point kernel={kernel} (T={t_lo}: "
            f"{s_lo * 1e3:.3f} ms, T={t_hi}: {s_hi * 1e3:.3f} ms, min of 3):"
            f" {step_s * 1e6:.3f} us/step = {1 / step_s:.1f} steps/s = "
            f"{SCEN_B / step_s:.0f} scenario solves/s, on {card}")
    ci = m.settings.check_interval
    m.Y = loop["out"][4]
    m.rho_ind = torch.tensor(int(loop["out"][5]), dtype=torch.int32,
                             device="cuda")
    profile_scenario("phase 17 loop", m, prob, loop["xs"][-1], 20, "loop",
                     ci)
    sync_sites("phase 17 loop", lambda: scenario_rollout_scan(
        m, prob, loop["xs"][-1], 10, kernel="loop", check_interval=ci), 10)
    s.Y, s.rho_ind = out[3][:SCEN_B].clone(), torch.tensor(
        int(stats[-1, 4]), dtype=torch.int32, device="cuda")
    profile_scenario("phase 17 scan", s, prob,
                     out[0][-1, :SCEN_B, :MPC_NX].cpu().double().numpy(),
                     T, "scan", ci)
    log("phase 17 OK")
    return dict(k4=k4, k6=k6, k6_rows=k6_rows, rates=rates)


# ---------------------------------------------------------------------- #
# K5, the heterogeneous chunk kernel, and the heterogeneous batch         #
# ---------------------------------------------------------------------- #

K5_BATCHES = (1, 7, 64)
K5_DPS = (128, 256, 640, 896)
K5_BIG_B = 1024
# K5 runs K4's arithmetic per row (state-dtype sums, its own order against
# cuBLAS's), so K4's bounds hold
K5_TOL = K4_TOL
# benchmarks/batched_qps.py --hetero at its default width: B distinct
# rand_qp(50, 12, 12) instances (D=98, Dp=128, 18 rungs), fp32, eps 1e-3;
# the first HET_CMP problems against the port's CPU fp64 solve
HET_NX, HET_B, HET_CMP = 50, 1024, 64
HET_KW = dict(eps_abs=1e-3)
# examples/ltv_mpc.py: B double integrators with per-plant mass schedules,
# horizon 8, u in [-2, 2], 40 steps, every bank re-factorized every 6
LTV_B, LTV_T, LTV_RELIN, LTV_DT, LTV_H = 16, 40, 6, 0.1, 8
# the fp32 loop certifies at eps_abs=1e-4 and so may take a step's answer a
# window apart from fp64 (1.3e-3 apart on the CPU at these settings)
LTV_TOL64, LTV_TOL32 = 1e-4, 1e-2
# the two solve counts of the two-point solves/s fit
HET_TWO_POINT = (1, 3)
# K5 launches timed on each LTV ensemble's windows (phase 20)
LTV_REPS = 20


def k5_inputs(B, dp, dtype, gen, device, dense=False):
    """Random K5 inputs: a (B, 18, Dp, Dp) bank, inner width d < Dp with
    inert padded lanes (all of Dp when ``dense``), per-problem b, a clamped
    segment in lo/hi, y, and per-problem rungs drawn at random over 18."""
    import torch
    d = dp if dense else (dp - 37 if dp > 128 else 91)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=device,
                                       dtype=dtype)
    wt = torch.zeros((B, N_RHO, dp, dp), dtype=dtype, device=device)
    wt[:, :, :d, :d] = randn(B, N_RHO, d, d) * (0.7 / d ** 0.5)
    b = torch.zeros((B, dp), dtype=dtype, device=device)
    b[:, :d] = 0.1 * randn(B, d)
    lo = torch.full((B, dp), -float("inf"), dtype=dtype, device=device)
    hi = torch.full((B, dp), float("inf"), dtype=dtype, device=device)
    lo[:, d // 3:2 * d // 3] = -0.8     # a clamped segment, as the z rows
    hi[:, d // 3:2 * d // 3] = 0.8
    y = torch.zeros((B, dp), dtype=dtype, device=device)
    y[:, :d] = 0.5 * randn(B, d)
    rho = torch.randint(0, N_RHO, (B,), generator=gen, device=device,
                        dtype=torch.int32)
    return wt, b, lo, hi, y, rho, d


def phase_k5_check():
    """K5 against fused_chunk_hetero_ref on the card, B x Dp x every tier,
    fp32 and fp64, per-problem rungs; padded lanes exactly 0. Returns the
    max errors."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import (fused_chunk_hetero,
                                                 fused_chunk_hetero_ref,
                                                 hetero_plan)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    errs = {}
    # and the LTV ensemble's width, where the plan spreads each problem
    # over a larger cluster to fill the card
    shapes = [(dp, B) for dp in K5_DPS for B in K5_BATCHES] + \
        [(128, K5_BIG_B), (128, LTV_B)]
    for dtype in (torch.float32, torch.float64):
        tols = K5_TOL[str(dtype).split(".")[1]]
        for dp, B in shapes:
            wt, b, lo, hi, y, rho, d = k5_inputs(B, dp, dtype, gen, dev)
            worst, plans = {}, {}
            for tier in tols:
                bank = wt.to(torch.bfloat16) if tier == "bf16" else wt
                n0 = fused_chunk_hetero.launches
                out = fused_chunk_hetero(bank, b, lo, hi, y, rho, N_STEPS,
                                         tier)
                assert fused_chunk_hetero.launches == n0 + 1
                ref = fused_chunk_hetero_ref(bank, b, lo, hi, y, rho,
                                             N_STEPS, tier)
                torch.cuda.synchronize()
                tag = (dtype, dp, B, tier)
                assert torch.isfinite(out).all(), tag
                assert float(out[:, d:].abs().max()) == 0.0, \
                    f"K5 padded lanes not inert: {tag}"
                err = float((out - ref).abs().max())
                assert err <= tols[tier], f"K5 disagrees: {tag} {err:.3e}"
                errs[tag] = worst[tier] = err
                plans[tier] = hetero_plan(dp, B, dtype, bank.dtype, tier)
                del bank
            del wt
            p = plans["highest"]
            where = ("slab in smem" if p["w_in_smem"] else
                     f"slab in registers, {p['regs_rows']} rows per lane"
                     if p["regs_rows"] else "slab from L2")
            log(f"K5 {str(dtype)[6:]} Dp={dp} B={B}: cluster {p['cluster']}"
                f" ({where}, "
                f"{p['cols_per_block']} columns and {p['threads']} threads "
                f"per block, {p['stretches']} stretches, {p['smem_bytes']} B,"
                f" {p['max_clusters']} problems at once)"
                f"  max|kernel-plain| " + "  ".join(
                    f"{t} {e:.2e}" for t, e in worst.items()))
        torch.cuda.empty_cache()
    log("phase 18 OK: K5 matches its plain version at every B, Dp, tier "
        "and dtype, per-problem rungs; padded lanes stay 0")
    return errs


def hetero_batch(B, nx=HET_NX, seed0=0):
    """benchmarks/batched_qps.py's ``_make_hetero_batch``: B distinct
    ``rand_qp(nx, nx/4, nx/4, seed=seed0 + i)``, stacked (H, g, A, l, u)."""
    from reluqp_tpu_torch.utils.problems import rand_qp
    n = max(nx // 4, 1)
    insts = [rand_qp(nx, n, n, seed=seed0 + i, compute_sol=False)
             for i in range(B)]
    stack = lambda k: np.stack([getattr(i, k) for i in insts])
    return stack("H"), stack("g"), stack("A"), stack("l"), stack("u")


_LTV_AD = np.array([[1.0, LTV_DT], [0.0, 1.0]])
_LTV_BD0 = np.array([[0.5 * LTV_DT * LTV_DT], [LTV_DT]])


def ltv_plant_qp(mass):
    """examples/ltv_mpc.py's sparse MPC QP for one plant at its current
    mass (Bd = Bd0 / m), built with the port's generator."""
    from reluqp_tpu_torch.models.mpc import gen_sparse_mpc_qp
    sel_u = np.zeros((LTV_H, LTV_H * 3))
    for k in range(LTV_H):
        sel_u[k, k * 3] = 1.0
    box = np.full(LTV_H, 2.0)
    return gen_sparse_mpc_qp(_LTV_AD, _LTV_BD0 / mass, np.diag([10.0, 1.0]),
                             np.array([[0.1]]), np.diag([50.0, 5.0]), LTV_H,
                             A_add=sel_u, l_add=-box, u_add=box)


def ltv_rollout(**kw):
    """examples/ltv_mpc.py's loop on the port (its seeds, masses, burn rates
    and start states): ``update(l, u)`` and a warm ``solve()`` every step,
    ``update_matrices(A=...)`` every LTV_RELIN steps. Returns the states
    (T+1, B, 2), the per-step iterations (T, B) and the solver after the
    last step; every step solved."""
    from reluqp_tpu_torch import BatchedReLU_QP
    rng = np.random.RandomState(0)
    masses = 1.0 + 0.5 * rng.rand(LTV_B)
    decay = 0.97 + 0.02 * rng.rand(LTV_B)
    X = np.column_stack([2.0 + rng.randn(LTV_B), np.zeros(LTV_B)])
    qps = [ltv_plant_qp(m_i) for m_i in masses]
    H = qps[0][0]
    As = np.stack([q[2] for q in qps])
    L, U = np.stack([q[3] for q in qps]), np.stack([q[4] for q in qps])

    def x0_bounds(X):
        L[:, :2] = U[:, :2] = -(X @ _LTV_AD.T)

    x0_bounds(X)
    m = BatchedReLU_QP()
    m.setup(H, np.zeros((LTV_B, H.shape[0])), As, L, U, eps_abs=1e-4, **kw)
    xs, its = [X], []
    for k in range(LTV_T):
        mass_k = masses * decay ** k
        if k and k % LTV_RELIN == 0:
            m.update_matrices(A=np.stack([ltv_plant_qp(m_i)[2]
                                          for m_i in mass_k]))
        x0_bounds(X)
        m.update(l=L, u=U)
        res = m.solve()
        assert res.info.status.all(), (k, res.info.status_strings())
        u0 = res.x.detach().cpu().double().numpy()[:, :1]
        X = X @ _LTV_AD.T + (u0 / mass_k[:, None]) @ _LTV_BD0.T
        xs.append(X)
        its.append(res.info.iter)
    return np.stack(xs), np.stack(its), m


def phase_hetero_main(card):
    """The main path of this slice through K5: ``BatchedReLU_QP`` on the
    card for benchmarks/batched_qps.py --hetero's B=1024 batch (setup, one
    solve, a timed second solve from a cleared state), every problem
    solved, the first 64 against the port's CPU fp64 solve; then
    examples/ltv_mpc.py's LTV ensemble in fp64 and fp32. K5 launches only."""
    import torch
    from reluqp_tpu_torch import BatchedReLU_QP
    data = hetero_batch(HET_B)

    def run():
        m = BatchedReLU_QP()
        m.setup(*data, **HET_KW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.solve()
        return m, res, time.perf_counter() - t0

    (m, res, secs), counts = _counted(run, "K5")
    assert all(n == 0 for k, n in counts.items() if k != "K5"), counts
    n_k5 = counts["K5"]
    assert m.settings.device.type == "cuda" and m.hetero and m._hetero_pallas
    assert (m.Dp, m.B_pad, len(m.rhos_np)) == (128, HET_B, 18), \
        (m.Dp, m.B_pad, len(m.rhos_np))
    info = res.info
    assert info.status.all(), f"{info.status.sum()}/{HET_B} solved"
    x_g = res.x.detach().cpu().double().numpy()
    assert x_g.shape == (HET_B, HET_NX) and np.all(np.isfinite(x_g))
    cpu = BatchedReLU_QP()
    cpu.setup(*(a[:HET_CMP] for a in data), precision="float64",
              device="cpu", backend="xla", **HET_KW)
    rc = cpu.solve()
    err = float(np.max(np.abs(x_g[:HET_CMP] - rc.x.numpy())))
    assert (info.status_code[:HET_CMP] == rc.info.status_code).all()
    assert err < 5e-3, err
    setup_s = m.info.setup_time
    log(f"phase 19 setup: {HET_B} heterogeneous QPs (nx={m.nx}, nc={m.nc}, "
        f"D={m.D}, Dp={m.Dp}, {len(m.rhos_np)} rungs, fp32 bank "
        f"{m.Wt_bank.numel() * 4 / 1e9:.3f} GB) in {setup_s:.3f} s "
        f"({os.cpu_count()} host cores)")
    log(f"phase 19 solve(): all {HET_B} solved in {info.n_iter_total} "
        f"iterations (per problem {info.iter.min()}..{info.iter.max()}, "
        f"rungs {sorted(set(m.rho_ind.cpu().tolist()))}), {secs * 1e3:.3f} "
        f"ms; first {HET_CMP} vs cpu fp64 |x|inf {err:.2e}, equal status; "
        f"launches {counts}")

    def second():
        m.clear_primal_dual()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = m.solve()
        return r, time.perf_counter() - t0

    (res2, secs2), counts = _counted(second, "K5")
    assert all(n == 0 for k, n in counts.items() if k != "K5"), counts
    assert res2.info.status.all()
    n_k5 += counts["K5"]
    log(f"phase 19 second solve (cleared state): {secs2 * 1e3:.3f} ms, "
        f"{HET_B / secs2:.0f} QP/s on {card}; launches {counts}")

    cpu_xs, cpu_its, _ = ltv_rollout(precision="float64", device="cpu",
                                     backend="xla")
    ltv = {}
    for precision, tol in (("float64", LTV_TOL64), ("float32", LTV_TOL32)):
        def ltv_run():
            t0 = time.perf_counter()
            out = ltv_rollout(precision=precision)
            return out, time.perf_counter() - t0

        ((xs, its, m_ltv), t_ltv), counts = _counted(ltv_run, "K5")
        assert all(n == 0 for k, n in counts.items() if k != "K5"), counts
        n_k5 += counts["K5"]
        dx = float(np.max(np.abs(xs - cpu_xs)))
        final = float(np.max(np.abs(xs[-1])))
        assert np.all(np.isfinite(xs)) and dx < tol, (precision, dx)
        assert final < 0.2, ("ensemble did not converge to origin", final)
        ltv[precision] = dict(dx=dx, final=final, m=m_ltv,
                              launches=counts["K5"])
        log(f"phase 19 LTV ensemble {precision} (B={LTV_B}, {LTV_T} steps, "
            f"update_matrices every {LTV_RELIN}): every step solved, "
            f"{t_ltv:.3f} s, mean iters/step {its.mean():.2f} (cpu fp64 "
            f"{cpu_its.mean():.2f}); vs cpu fp64 |x|inf {dx:.2e} (bound "
            f"{tol:g}); final max|x| {final:.4f}; launches {counts}")
    log(f"phase 19 OK on {card}: K5 launches {n_k5}, no other kernel")
    return {"launches": n_k5, "m": m, "setup_s": setup_s, "solve_s": secs2,
            "ltv": ltv}


def k5_bound_ms(nnz_w, B, dp, steps, elt=4):
    """Least time of one K5 window, in ms: bytes, each problem's rung read
    once (``nnz_w`` entries over the batch: its nonzeros, or B·Dp² for a
    dense bank), b, lo, hi and Y in and Y out at width Dp, and the rung
    vector; operations, 2 flops per multiply-add per step at those entries
    (fp32 outside the tensor cores)."""
    nbytes = (nnz_w + 5 * B * dp) * elt + 4 * B
    flops = 2.0 * steps * nnz_w
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), t_bytes, t_ops


def phase_hetero_timing(card, het, parent=None):
    """K5 per 25-step window at B=1024, Dp=128 (one block per problem) and
    B=256, Dp=256 (a cluster of two per problem), dense random banks, fp32
    highest, by CUDA events and by device time, beside its plain version,
    25 ``torch.baddbmm`` + clamp on the gathered rungs and the bound; K5 on
    the main path's own bank and state; solves/s of the B=1024 batch by a
    two-point fit; a profiler pass over one solve."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import (fused_chunk_hetero,
                                                 fused_chunk_hetero_ref,
                                                 hetero_plan)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(20)
    rows = {}
    for B, dp in ((K5_BIG_B, 128), (256, 256)):
        W, b, lo, hi, Y, rho, _ = k5_inputs(B, dp, torch.float32, gen, dev,
                                            dense=True)
        Wg = W[torch.arange(B, device=dev), rho.long()]
        b3, lo3, hi3 = b[:, None, :], lo[:, None, :], hi[:, None, :]

        def library():
            yy = Y[:, None, :]
            for _ in range(N_STEPS):
                yy = torch.baddbmm(b3, yy, Wg).clamp_(min=lo3, max=hi3)
            return yy

        kernel = lambda: fused_chunk_hetero(W, b, lo, hi, Y, rho, N_STEPS)
        plain = lambda: fused_chunk_hetero_ref(W, b, lo, hi, Y, rho, N_STEPS)
        if parent:
            k5_old = parent_module(parent, "ops.fused_step").fused_chunk_hetero
            old = lambda: k5_old(W, b, lo, hi, Y, rho, N_STEPS)
            before = _time_ms(old, 100)
        ms = _time_ms(kernel, 100)
        if parent:
            after = _time_ms(old, 100)
            log(f"phase 20 K5 A/B (B={B}, Dp={dp}): parent {before:.5f} ms, "
                f"this tree {ms:.5f} ms, parent again {after:.5f} ms per "
                f"window, on {card}")
        plain_ms = _time_ms(plain, 20)
        library_ms = _time_ms(library, 20)
        devt = {name: device_ms(fn, 10) for name, fn in
                (("K5", kernel), ("plain", plain), ("baddbmm+clamp", library))}
        bound, by, t_b, t_o = k5_bound_ms(B * dp * dp, B, dp, N_STEPS)
        plan = hetero_plan(dp, B)
        rows[(B, dp)] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound, bound_by=by, dev=devt, plan=plan)
        log(f"phase 20 K5 (B={B}, Dp={dp}, dense, per-problem rungs, "
            f"{N_STEPS} steps, fp32 highest, plan {plan}): {ms:.5f} ms per "
            f"window by CUDA events; plain {plain_ms:.5f} ms; baddbmm+clamp "
            f"{library_ms:.5f} ms; bound {bound:.5f} ms ({by}: {t_b:.5f} ms "
            f"bytes, {t_o:.5f} ms operations), {ms / bound:.1f}x the bound, "
            f"on {card}")
        log(f"phase 20 device time per window (profiler, device-side "
            f"events): " + "; ".join(
                f"{n} " + ("not measured" if t is None else f"{t:.5f} ms")
                for n, t in devt.items()))
        del W, Wg
        torch.cuda.empty_cache()

    # K5 on the main path's bank and state (rungs where the solve left them)
    m = het["m"]
    rho = m.rho_ind.contiguous()
    b = m.bias_all[torch.arange(m.B_n, device=dev), rho.long()].contiguous()
    Wm, lo, hi, Y = m.Wt_bank, m.lo, m.hi, m.Y.contiguous()
    ms = _time_ms(lambda: fused_chunk_hetero(Wm, b, lo, hi, Y, rho, N_STEPS),
                  100)
    nnz = int(torch.count_nonzero(Wm[torch.arange(m.B_n, device=dev),
                                     rho.long()]))
    bound, by, t_b, t_o = k5_bound_ms(nnz, m.B_n, m.D, N_STEPS)
    log(f"phase 20 K5 on the main path's bank (B={m.B_n}, D={m.D}, "
        f"Dp={m.Dp}): {ms:.5f} ms per window; bound at the rungs' nonzeros "
        f"{bound:.5f} ms ({by}), {ms / bound:.1f}x")

    # K5 alone on the LTV ensemble's windows (phase 19's solvers after their
    # last step: their banks, rungs and states), least of LTV_REPS launches
    for precision, ltv in het["ltv"].items():
        ml = ltv["m"]
        rho = ml.rho_ind.contiguous()
        rows_l = torch.arange(ml.B_n, device=dev)
        b = ml.bias_all[rows_l, rho.long()].contiguous()
        args = (ml.Wt_bank, b, ml.lo, ml.hi, ml.Y.contiguous(), rho, N_STEPS)
        ab = ""
        if parent:
            k5_old = parent_module(parent, "ops.fused_step").fused_chunk_hetero
            before = least_ms(lambda: k5_old(*args), LTV_REPS)
        ms = least_ms(lambda: fused_chunk_hetero(*args), LTV_REPS)
        dev_ms = graph_ms(lambda: fused_chunk_hetero(*args), LTV_REPS)
        if parent:
            after = least_ms(lambda: k5_old(*args), LTV_REPS)
            dev_p = graph_ms(lambda: k5_old(*args), LTV_REPS)
            ab = (f"; parent {before:.5f} ms before, {after:.5f} ms after "
                  f"({dev_p:.5f} ms in a graph)")
        # one PyTorch call per step on the same work: 25 torch.baddbmm +
        # clamp on the gathered rungs, in a CUDA graph as K5 is
        Wg = ml.Wt_bank[rows_l, rho.long()].to(ml.Y.dtype)
        b3, lo3, hi3 = (t[:, None, :] for t in (b, ml.lo, ml.hi))
        Y3 = ml.Y.contiguous()[:, None, :]

        def library():
            yy = Y3
            for _ in range(N_STEPS):
                yy = torch.baddbmm(b3, yy, Wg).clamp_(min=lo3, max=hi3)
            return yy

        lib_ms = graph_ms(library, LTV_REPS)
        nnz = int(torch.count_nonzero(ml.Wt_bank[rows_l, rho.long()]))
        elt = ml.Wt_bank.element_size()
        bound, by, _, _ = k5_bound_ms(nnz, ml.B_n, ml.D, N_STEPS, elt)
        plan = hetero_plan(ml.Dp, ml.B_n, ml.Wt_bank.dtype)
        rows[("ltv", precision)] = dict(ms=ms, dev_ms=dev_ms, bound_ms=bound,
                                        bound_by=by, plan=plan,
                                        library_ms=lib_ms,
                                        launches=ltv["launches"])
        log(f"phase 20 K5 on the LTV windows ({precision}, B={ml.B_n}, "
            f"D={ml.D}, Dp={ml.Dp}, {N_STEPS} steps, plan {plan}): "
            f"{ms:.5f} ms per window (least of {LTV_REPS} by CUDA events, "
            f"the host's launch included), {dev_ms:.5f} ms per launch in a "
            f"CUDA graph of {LTV_REPS} (no host time between launches)"
            f"{ab}; bound at the rungs' nonzeros {bound:.5f} ms ({by}), "
            f"{dev_ms / bound:.1f}x (in the graph); 25 torch.baddbmm + clamp "
            f"on the gathered rungs {lib_ms:.5f} ms in a CUDA graph of "
            f"{LTV_REPS}; {ltv['launches']} launches in phase 19, on {card}")

    # solves/s: a chain of n solves, each from a cleared state, at two n
    def chain(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            m.clear_primal_dual()
            r = m.solve()
        assert r.info.status.all()
        return time.perf_counter() - t0

    n_lo, n_hi = HET_TWO_POINT
    s_lo = min(chain(n_lo) for _ in range(3))
    s_hi = min(chain(n_hi) for _ in range(3))
    per = (s_hi - s_lo) / (n_hi - n_lo)
    log(f"phase 20 two-point solves (n={n_lo}: {s_lo * 1e3:.3f} ms, "
        f"n={n_hi}: {s_hi * 1e3:.3f} ms, min of 3): {per * 1e3:.3f} ms per "
        f"solve of {m.B_n} QPs = {m.B_n / per:.0f} QP/s, on {card}")
    m.clear_primal_dual()
    windows = max(m.solve().info.n_iter_total // m.settings.check_interval,
                  1)

    def one_solve():
        m.clear_primal_dual()
        m.solve()

    profile_run("phase 20 hetero solve", one_solve, windows,
                f"per check window, B={m.B_n}, {windows} windows")
    sync_sites("phase 20 hetero solve", one_solve, windows)

    log("phase 20 OK")
    return dict(rows=rows, qps=m.B_n / per)


# Phases 21-24: the batched solver's remaining single-device options.
# phase 22: benchmarks/batched_qps.py's shared batch (its north-star width)
REPACK_B, REPACK_NX = 10000, 50
REPACK_KW = dict(eps_abs=1e-3, precision="float32", iter_precision="highest")
# repack drops converged rows that the dense loop keeps iterating around
# their fixed points: x agrees to that drift, not to rounding
REPACK_X_TOL = 1e-2
# parent / this tree pairs of phase 22's repack A/B (with --parent)
REPACK_AB_PAIRS = 10
REPACK_REPS = 3
# the budget-exhaustion case: max_iter 50 (2 windows) at eps 1e-4, where
# about a tenth of the batch certifies (a stage exit before the budget ends
# is held in tests/test_torch_repack.py)
REPACK_BUDGET_EPS = (1e-4,)
# phase 21: device build against the host build, fp64 on both sides, finite
# fp32 caps (uncapped top rungs are too ill-conditioned for a bound)
BANK_TOL = 1e-9


def shared_batch(B, nx=REPACK_NX, seed0=0):
    """benchmarks/batched_qps.py's ``_make_batch``: one ``rand_qp(nx, nx/4,
    nx/4)`` (H, A) and B right-hand sides drawn around it in bulk."""
    from reluqp_tpu_torch.utils.problems import rand_qp
    n_eq = n_ineq = nx // 4
    base = rand_qp(nx=nx, n_eq=n_eq, n_ineq=n_ineq, seed=seed0,
                   compute_sol=False)
    rng = np.random.RandomState(seed0)
    A_eq, C = base.A[:n_eq], base.A[n_eq:]
    act = rng.randn(B, n_ineq) > 0.5
    mu = rng.randn(B, n_eq)
    lam = rng.randn(B, n_ineq) * act
    x = rng.randn(B, nx)
    b = x @ A_eq.T
    d = x @ C.T - rng.randn(B, n_ineq) * (~act)
    G = -(x @ base.H.T) - mu @ A_eq - lam @ C
    L = np.concatenate([b, d], axis=1)
    U = np.concatenate([b, np.full((B, n_ineq), np.inf)], axis=1)
    return base.H, G, base.A, L, U


def phase_device_build(card):
    """Slice 9: ``bank_build="device"`` on phase 19's B=1024 batch. The
    setup's fp64 B masters (and a device build of the first 64 problems'
    W) against the host build in fp64; a solve through K5 with every
    problem solved; ``update(g)`` (the bias formed on the card from the
    fp64 master) against the host-built batch; the setup seconds of the
    device, numpy-host and native-host builds."""
    import torch
    from reluqp_tpu_torch import BatchedReLU_QP, native
    from reluqp_tpu_torch.core.bank import (auto_rho_cap_batch,
                                            build_bank_torch,
                                            build_banks_np_batch,
                                            equality_mask)
    from reluqp_tpu_torch.utils.timing import Timer
    data = hetero_batch(HET_B)
    timer = Timer()

    def run():
        m = BatchedReLU_QP()
        with timer.section("device"):
            m.setup(*data, bank_build="device", **HET_KW)
        return m, m.solve()

    (m, res), counts = _counted(run, "K5")
    assert all(n == 0 for k, n in counts.items() if k != "K5"), counts
    n_k5 = counts["K5"]
    assert res.info.status.all(), f"{res.info.status.sum()}/{HET_B} solved"
    assert m._B_dev.is_cuda and m._B_np is None
    assert not m.Wt_bank[:, :, m.D:].any() and not m.Wt_bank[..., m.D:].any()

    # the first 64 problems' banks, built on the card and on the host in
    # fp64 (HET_KW does not scale: the scaled data are the data)
    H, _, A, l, u = (a[:HET_CMP] for a in data)
    eq = equality_mask(l, u, m.settings.eq_tol)
    caps = auto_rho_cap_batch(A, HET_KW["eps_abs"], torch.float32, HET_NX)
    assert np.allclose(caps, m.rho_cap[:HET_CMP])
    Wd, Bd = build_bank_torch(H, A, eq, m.rhos_np, m.settings.sigma,
                              rho_caps=caps, device="cuda")
    Wh, Bh = build_banks_np_batch(H, A, eq, m.rhos_np, m.settings.sigma,
                                  1.0, caps)
    D = m.D
    err_w = float(np.max(np.abs(Wd.cpu().numpy() - Wh)))
    err_b = float(np.max(np.abs(m._B_dev[:HET_CMP, :, :D].cpu().numpy()
                                - Bh)))
    assert err_w < BANK_TOL and err_b < BANK_TOL, (err_w, err_b)
    w32 = Wd.transpose(-1, -2).float()
    err_w32 = float((m.Wt_bank[:HET_CMP, :, :D, :D] - w32).abs().max())
    log(f"phase 21 device build vs host fp64 build, first {HET_CMP} "
        f"problems: |W|inf {err_w:.2e}, |B master|inf {err_b:.2e} (bound "
        f"{BANK_TOL:g}); the setup's fp32 W vs this build's {err_w32:.2e}")
    del Wd, Bd

    hosts = {}
    for name, avail in (("native", native.available),
                        ("numpy", lambda: False)):
        orig = native.available
        native.available = avail
        try:
            h = BatchedReLU_QP()
            with timer.section(name):
                h.setup(*data, **HET_KW)
        finally:
            native.available = orig
        hosts[name] = h
    have_native = native.available()
    g2 = data[1] * 1.05
    h = hosts["native"]
    for mm in (m, h):
        mm.update(g=g2)
        mm.clear_primal_dual()      # both solve cold
    err_bias = float((m.bias_all - h.bias_all).abs().max())
    scale = float(h.bias_all.abs().max())
    assert err_bias <= 1e-5 * scale, (err_bias, scale)
    r_d, counts = _counted(m.solve, "K5")
    n_k5 += counts["K5"]
    r_h = h.solve()
    assert r_d.info.status.all() and r_h.info.status.all()
    assert (r_d.info.status_code == r_h.info.status_code).all()
    dx = float((r_d.x - r_h.x).abs().max())
    n_it = int(np.sum(r_d.info.iter != r_h.info.iter))
    assert dx < 5e-3, dx
    secs = {k: v["total"] for k, v in timer.summary().items()}
    log(f"phase 21 update(g): device-formed bias vs the host build's "
        f"|b|inf {err_bias:.2e} (|b| up to {scale:.2e}); solve: all "
        f"{HET_B} solved, |x|inf {dx:.2e}, {n_it} problems certified at "
        f"another window; launches {counts}")
    log(f"phase 21 setup at B={HET_B} (nx={HET_NX}, fp32) on {card}: "
        f"device build {secs['device']:.3f} s, native host build "
        f"{secs['native']:.3f} s"
        + ((" (OpenMP)" if native.uses_openmp() else " (serial: the "
            "compiler has no OpenMP)") if have_native else
           " (the native library did not build: numpy)")
        + f", numpy host build {secs['numpy']:.3f} s")
    log("phase 21 OK")
    return dict(m=m, setup_s=secs, launches=n_k5)


def repack_solve(m):
    """One cold solve."""
    m.clear_primal_dual()
    return m.solve()


def k4_window_timing(card, phase, m, parent=None, reps=50):
    """K4 alone on a solved batch's bank, bias, bounds and state (``m``),
    one 25-step window at fp32 highest: CUDA events and device time beside
    its plain version, 25 ``torch.addmm`` + clamp (event span and device
    time), the bound and the plan; with ``parent``, beside the parent's K4
    before and after, and whether the two give the same bits. Returns the
    numbers and the window's operands."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import (batched_plan,
                                                 fused_chunk_batched,
                                                 fused_chunk_batched_ref)
    rho = m.rho_ind.reshape(1).contiguous()
    k = int(rho)
    W, b = m.Wt_bank, m.bias_all[k].contiguous()
    lo, hi, Y = m.lo, m.hi, m.Y.contiguous()
    w_k = W[k]

    def library():
        yy = Y
        for _ in range(N_STEPS):
            yy = torch.addmm(b, yy, w_k).clamp_(min=lo, max=hi)
        return yy

    kernel = lambda: fused_chunk_batched(W, b, lo, hi, Y, rho, N_STEPS)
    plain = lambda: fused_chunk_batched_ref(W, b, lo, hi, Y, rho, N_STEPS)
    out = {}
    if parent:
        k4_old = parent_module(parent, "ops.fused_step").fused_chunk_batched
        old = lambda: k4_old(W, b, lo, hi, Y, rho, N_STEPS)
        before = _time_ms(old, reps)
    ms = _time_ms(kernel, reps)
    if parent:
        after = _time_ms(old, reps)
        out["same_as_parent"] = torch.equal(old(), kernel())
        log(f"phase {phase} K4 A/B (B={m.B_pad}, Dp={m.Dp}): parent "
            f"{before:.5f} ms, this tree {ms:.5f} ms, parent again "
            f"{after:.5f} ms per window (parent / this tree "
            f"{min(before, after) / ms:.2f}), outputs "
            + ("bit-equal" if out["same_as_parent"] else "not bit-equal")
            + f" to the parent's, on {card}")
    plain_ms = _time_ms(plain, 10)
    library_ms = _time_ms(library, 10)
    # the two comparison loops are 25-100 launches each, so their event
    # spans carry the host's launch gaps; their device time does not
    dev = {name: device_ms(fn, 5) for name, fn in
           (("K4", kernel), ("plain", plain), ("addmm+clamp", library))}
    bound, by, t_b, t_o = k4_bound_ms(w_k, m.B_n, m.D, N_STEPS)
    plan = batched_plan(m.B_pad, m.Dp, m.settings.precision_dtype)
    fmt = lambda t: "not measured" if t is None else f"{t:.5f} ms"
    log(f"phase {phase} K4 (B={m.B_pad}, Dp={m.Dp}, rung {k}, {N_STEPS} "
        f"steps, fp32 highest, plan {plan}): {ms:.5f} ms per window by CUDA "
        f"events, {fmt(dev['K4'])} device time; plain {plain_ms:.5f} ms "
        f"event span, {fmt(dev['plain'])} device time; addmm+clamp "
        f"{library_ms:.5f} ms event span, {fmt(dev['addmm+clamp'])} device "
        f"time; bound {bound:.5f} ms ({by}: {t_b:.5f} ms bytes, {t_o:.5f} ms"
        f" operations at the rung's nonzeros), {ms / bound:.1f}x the bound, "
        f"on {card}")
    out.update(ms=ms, dev_ms=dev["K4"], plain_ms=plain_ms,
               library_ms=library_ms, library_dev_ms=dev["addmm+clamp"],
               bound_ms=bound, bound_by=by, plan=plan,
               operands=(W, b, lo, hi, Y, rho))
    return out


def k4_shared_timing(card, m, windows, parent=None):
    """K4 alone on the shared batch's window (``k4_window_timing``), then
    one dense solve's device time by kernel."""
    k4 = k4_window_timing(card, 22, m, parent, reps=20)
    k4.pop("operands")
    # walked window by window: torch.profiler names the kernels of a
    # device program's conditional bodies wrongly (seen on an H100: K4's
    # time under another kernel's name)
    with per_window(m):
        split = device_by_kernel(lambda: repack_solve(m), 3)
    total = sum(split.values())
    k4_dev = sum(t for name, t in split.items()
                 if "k4_kernel" in name or "k4_tile_kernel" in name)
    log(f"phase 22 dense solve device time by kernel ({windows} windows, "
        f"profiler): {total:.3f} ms in all, K4 {k4_dev:.3f} ms, the rest "
        f"{total - k4_dev:.3f} ms; the largest: " + "; ".join(
            f"{name[:60]} {t:.3f}" for name, t in list(split.items())[:8]))
    return dict(k4, solve_dev_ms=total, solve_k4_ms=k4_dev)


def phase_repack(card, parent=None):
    """Slice 9: ``tail_policy="repack"`` against ``"dense"`` on
    benchmarks/batched_qps.py's shared batch at B=10000 through K4: equal
    per-row status and first-convergence iterations, x within the
    post-convergence drift; K4 launches by stage capacity; syncs per
    window; each solve's least time of REPACK_REPS by CUDA events (with
    ``parent``, the parent's repack solve before and after); then the
    budget-exhaustion case."""
    import collections
    import torch
    import reluqp_tpu_torch.batch as tbatch
    from reluqp_tpu_torch import BatchedReLU_QP
    from reluqp_tpu_torch.ops.fused_step import batched_plan
    from reluqp_tpu_torch.utils.timing import time_fn_events
    data = shared_batch(REPACK_B)
    ms = {}
    for policy in ("dense", "repack"):
        ms[policy] = BatchedReLU_QP()
        ms[policy].setup(*data, tail_policy=policy, **REPACK_KW)
    md, mr = ms["dense"], ms["repack"]
    assert mr._use_pallas and mr.settings.device.type == "cuda"
    sched = mr._repack_sched
    plan = batched_plan(mr.B_pad, mr.Dp, mr.settings.precision_dtype)
    assert len(sched) > 1 and all(c % plan["rows_per_tile"] == 0
                                  for c in sched[1:]), (sched, plan)

    from reluqp_tpu_torch.core.graphs import on_launch
    rows = collections.Counter()
    runner = tbatch.pallas_batched_chunk_runner

    def by_rows(Wt, bias, rho, lo, hi, Y, n, prec="highest"):
        # once per replay where a window's graph captured the launch
        on_launch(lambda r=Y.shape[0]: rows.update([r]))
        return runner(Wt, bias, rho, lo, hi, Y, n, prec)

    res = {}
    for policy, m in ms.items():
        rows.clear()
        tbatch.pallas_batched_chunk_runner = by_rows
        try:
            res[policy], counts = _counted(lambda: repack_solve(m), "K4")
        finally:
            tbatch.pallas_batched_chunk_runner = runner
        assert all(n == 0 for k, n in counts.items() if k != "K4"), counts
        res[policy] = (res[policy], dict(rows), counts["K4"])
    (rd, rows_d, n_d), (rr, rows_r, n_r) = res["dense"], res["repack"]
    # every stage the solve reached ran K4 at its capacity
    assert set(rows_r) <= set(sched) and len(rows_r) > 1, (rows_r, sched)
    assert set(rows_d) == {md.B_pad}
    assert rd.info.status.all() and rr.info.status.all()
    assert (rd.info.status_code == rr.info.status_code).all()
    n_diff = int(np.sum(rd.info.iter != rr.info.iter))
    assert n_diff == 0, f"{n_diff} rows certified at another iteration"
    assert rd.info.n_iter_total == rr.info.n_iter_total
    dx = float((rd.x - rr.x).abs().max())
    assert dx < REPACK_X_TOL, dx
    windows = rr.info.n_iter_total // mr.settings.check_interval
    log(f"phase 22 B={REPACK_B} (nx={md.nx}, nc={md.nc}, Dp={md.Dp}, fp32 "
        f"highest): schedule {sched} (K4 row tile {plan['rows_per_tile']}); "
        f"{windows} windows, iterations per row {rr.info.iter.min()}.."
        f"{rr.info.iter.max()}, equal to dense on every row; |x|inf "
        f"{dx:.2e}; K4 launches by rows: dense {rows_d}, repack "
        f"{dict(sorted(rows_r.items(), reverse=True))}")
    # (sync_sites reports per "step": here a check window). The dense
    # solve exits on the device: one read; repack walks its stages window
    # by window, no more reads than the dense solve walked so (a stage
    # boundary adds none: the next stage starts from the last read)
    for m in ms.values():
        # the runner patched above made programs of its own: the first
        # solve with the real one walks its program, the second builds it
        repack_solve(m)
        repack_solve(m)
    syncs = {p: sync_sites(f"phase 22 {p}", lambda m=m: repack_solve(m),
                           windows) for p, m in ms.items()}
    with per_window(md):
        syncs_w = sync_sites("phase 22 dense per-window",
                             lambda: repack_solve(md), windows)
    assert syncs["dense"] == 1, syncs
    assert syncs["repack"] <= syncs_w, (syncs, syncs_w)
    k4 = k4_shared_timing(card, md, windows, parent)
    t = {p: time_fn_events(repack_solve, m, reps=REPACK_REPS)["best"]
         for p, m in ms.items()}
    log(f"phase 22 solve time (least of {REPACK_REPS}, CUDA events) on "
        f"{card}: dense {t['dense'] * 1e3:.3f} ms, repack "
        f"{t['repack'] * 1e3:.3f} ms (ratio {t['repack'] / t['dense']:.3f});"
        f" syncs per window: dense {syncs['dense'] / windows:.2f}, repack "
        f"{syncs['repack'] / windows:.2f}")
    if parent:
        # the parent's repack solve on the same batch: REPACK_AB_PAIRS
        # pairs, the side that runs first alternating
        mp = parent_module(parent, "batch").BatchedReLU_QP()
        mp.setup(*data, tail_policy="repack", **REPACK_KW)
        rp = repack_solve(mp)
        same = (bool(torch.equal(rp.x, rr.x))
                and bool((rp.info.iter == rr.info.iter).all())
                and bool((rp.info.status_code == rr.info.status_code).all()))
        syncs_p = sync_sites("phase 22 parent repack",
                             lambda: repack_solve(mp), windows, parent)
        ab = {"parent": [], "this tree": []}
        for i in range(REPACK_AB_PAIRS):
            order = ("parent", "this tree")[::1 - 2 * (i % 2)]
            for side in order:
                ab[side].append(time_fn_events(
                    repack_solve, mp if side == "parent" else mr,
                    reps=REPACK_REPS)["best"] * 1e3)
        wins = sum(a < b for a, b in zip(ab["this tree"], ab["parent"]))
        q = {k: np.percentile(v, [25, 50, 75]) for k, v in ab.items()}
        log(f"phase 22 repack A/B on {card}: {REPACK_AB_PAIRS} pairs "
            f"(each side the least of {REPACK_REPS} solves by CUDA events, "
            f"the side run first alternating): "
            + "; ".join(f"{k} median {q[k][1]:.3f} ms (quartiles "
                        f"{q[k][0]:.3f}..{q[k][2]:.3f}; all "
                        f"{', '.join(f'{x:.3f}' for x in v)})"
                        for k, v in ab.items())
            + f"; this tree faster in {wins} of {REPACK_AB_PAIRS} pairs; "
            f"syncs per solve: parent {syncs_p}, this tree "
            f"{syncs['repack']}; x, iterations and status bit-equal to the "
            f"parent's: {same}")

    for eps in REPACK_BUDGET_EPS:
        out = {}
        for policy in ("dense", "repack"):
            m = BatchedReLU_QP()
            m.setup(*data, tail_policy=policy,
                    **dict(REPACK_KW, eps_abs=eps, max_iter=50))
            rows.clear()
            tbatch.pallas_batched_chunk_runner = by_rows
            try:
                out[policy] = (m.solve(), dict(rows))
            finally:
                tbatch.pallas_batched_chunk_runner = runner
        (bd, _), (br, rows_b) = out["dense"], out["repack"]
        assert not bd.info.status.all()
        assert (bd.info.status_code == br.info.status_code).all()
        assert (bd.info.iter == br.info.iter).all()
        assert bd.info.n_iter_total == br.info.n_iter_total == 50
        log(f"phase 22 budget exhaustion (eps {eps:g}, max_iter 50): "
            f"{int(bd.info.status.sum())}/{REPACK_B} solved in both, status "
            f"and iterations equal; repack K4 launches by rows {rows_b}")
    log("phase 22 OK")
    return dict(m=mr, md=md, t=t, launches=n_d + n_r, sched=sched, k4=k4)


def _round_trip(save, load, m, path, tag):
    from reluqp_tpu_torch.utils.timing import Timer
    timer = Timer()
    with timer.section("save"):
        save(m, path)
    with timer.section("load"):
        m2 = load(path)
    secs = {k: v["total"] for k, v in timer.summary().items()}
    size = os.path.getsize(path) / 1e9
    log(f"phase 23 {tag}: saved {size:.3f} GB in {secs['save']:.3f} s, "
        f"loaded in {secs['load']:.3f} s (setup {m.info.setup_time:.3f} s)")
    assert m2.settings.device.type == "cuda"
    return m2


def phase_checkpoint(card, protocol, het, repack):
    """Slice 9: checkpoints on the card. The protocol QP (nx=100) with
    backend="fused", phase 19's heterogeneous batch and phase 22's repack
    batch, each saved, loaded (onto cuda by default) and solved beside
    the original: equal status and iterations."""
    import shutil
    import tempfile
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.utils import checkpoint as ck
    tmp = tempfile.mkdtemp(prefix="reluqp_ckpt_")
    try:
        inst = protocol[1][100]
        m = ReLU_QP()
        m.setup(*inst[:5], backend="fused", precision="float32",
                eps_abs=1e-4, scaling=True)
        m2 = _round_trip(ck.save_solver, ck.load_solver, m,
                         os.path.join(tmp, "qp.npz"), "protocol nx=100 fused")
        assert m2._fused
        r2, counts = _counted(m2.solve, "K3")
        r1 = m.solve()
        assert (r1.info.status, r1.info.iter) == (r2.info.status,
                                                  r2.info.iter), \
            (r1.info, r2.info)
        assert r1.info.status == "solved"
        dx = float((r1.x - r2.x).abs().max())
        assert dx == 0.0, dx
        log(f"phase 23 fused QP: {r2.info.status} in {r2.info.iter} "
            f"iterations, as the original, x bit-equal; launches {counts}")
        n_k3 = counts["K3"]

        launches = {"K3": n_k3}
        for tag, mb, kernel in ((f"hetero B={het['m'].B_n}", het["m"], "K5"),
                                (f"repack B={repack['m'].B_n}", repack["m"],
                                 "K4")):
            mb2 = _round_trip(ck.save_batched_solver, ck.load_batched_solver,
                              mb, os.path.join(tmp, "batch.npz"), tag)
            assert mb2.tail_policy == mb.tail_policy
            assert mb2._repack_sched == mb._repack_sched
            rb2, counts = _counted(mb2.solve, kernel)
            rb1 = mb.solve()
            assert rb1.info.status.all() and rb2.info.status.all()
            assert (rb1.info.iter == rb2.info.iter).all()
            dx = float((rb1.x - rb2.x).abs().max())
            assert dx == 0.0, dx
            log(f"phase 23 {tag}: warm solve after the load equal to the "
                f"original's (iterations, status, x bit-equal); launches "
                f"{counts}")
            launches[kernel] = counts[kernel]
            os.remove(os.path.join(tmp, "batch.npz"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase 23 OK on {card}")
    return launches


def phase_native(card):
    """Slice 9: the native bank builder on the MPC configuration's
    condensed QP (D=600): native and numpy builds timed, the banks within
    fp64 rounding, and a solve through K1 with each: equal status and
    iterations."""
    from reluqp_tpu_torch import ReLU_QP, native
    from reluqp_tpu_torch.models.mpc import MPC
    from reluqp_tpu_torch.utils.timing import Timer
    if not native.available():
        native.ensure_built()       # raises with the compiler's message
    openmp = native.uses_openmp()
    Ad, Bd, Q, R, x0 = mpc_config()
    prob = MPC(Ad, Bd, Q, R, horizon=MPC_H, device="cpu", backend="xla",
               **MPC_KW).prob
    g = prob.g0 + prob.g_x0 @ x0
    shift = prob.lu_x0 @ x0
    data = (prob.H, g, prob.A, prob.l0 + shift, prob.u0 + shift)
    kw = dict(eps_abs=MPC_KW["eps_abs"], max_iter=MPC_KW["max_iter"])
    timer = Timer()
    ms, res, n_k1 = {}, {}, 0
    for how in ("native", "numpy"):
        m = ReLU_QP()
        with timer.section(how):
            m.setup(*data, bank_backend=how, **kw)
        assert m.setup_breakdown["bank_backend"] == how
        ms[how] = m
        res[how], counts = _counted(m.solve, "K1")
        assert all(n == 0 for k, n in counts.items() if k != "K1"), counts
        n_k1 += counts["K1"]
    a, b = ms["native"], ms["numpy"]
    assert a.D == 600, a.D
    errW = float((a.bank.W.double() - b.bank.W.double()).abs().max())
    errB = float(np.max(np.abs(a._B_np - b._B_np)))
    scale = float(b.bank.W.double().abs().max())
    # the iteration dtype's copies of two fp64 banks that differ by fp64
    # rounding: equal, or one fp32 rounding apart
    assert errW <= 2.0 ** -23 * scale and errB < 1e-9, (errW, errB)
    ra, rb = res["native"], res["numpy"]
    assert ra.info.status == rb.info.status == "solved"
    assert ra.info.iter == rb.info.iter, (ra.info.iter, rb.info.iter)
    dx = float((ra.x - rb.x).abs().max())
    br = {k: ms[k].setup_breakdown["bank_build_s"] for k in ms}
    log(f"phase 24 MPC condensed QP (D={a.D}, Dp={a.Dp}, "
        f"{len(a.rhos_np)} rungs) on {card}: bank build native ("
        + ("OpenMP" if openmp else "serial: the compiler has no OpenMP")
        + f") "
        f"{br['native']:.4f} s, numpy {br['numpy']:.4f} s (setups "
        f"{timer.summary()['native']['total']:.3f} / "
        f"{timer.summary()['numpy']['total']:.3f} s); fp64 B masters "
        f"|dB|inf {errB:.2e}, device W |dW|inf {errW:.2e}; K1 solves "
        f"{ra.info.status} in {ra.info.iter} iterations each, |dx|inf "
        f"{dx:.2e}")
    log("phase 24 OK")
    return dict(build_s=br, launches=n_k1)


# --------------------------------------------------------------------- #
# phase 29: the check windows as CUDA graphs against eager windows       #
# --------------------------------------------------------------------- #

# the 200-step loop-MPC rollout may capture this many pieces per window
# (its ci=1 calibration and its continuation, each a control step's start,
# window, tail and result piece)
GRAPH_MPC_CAPTURES = 8
# a replayed window's host launches between two host reads: the graph's
# launch, the bundle's copy and at most one more
GRAPH_WINDOW_LAUNCHES = 3
GRAPH_REPS = 3
# steps of the per-step profiles and sync counts
GRAPH_PROFILE_T, GRAPH_SYNC_T = 50, 20


@contextlib.contextmanager
def per_window(solver):
    """``solver``'s solves walked window by window from the host inside
    the ``with`` (each window one replay of its graph, its exit flag read
    after it): ``WindowGraphs.device_exit = False``, the A/B of the device
    exit."""
    cache = solver._window_graphs
    keep = cache.device_exit
    cache.device_exit = False
    try:
        yield
    finally:
        cache.device_exit = keep


@contextlib.contextmanager
def eager_windows(solver):
    """Every check window of ``solver`` eager inside the ``with``: the
    private ``_window_graphs = False`` the loops take for the A/B of the
    graphed path."""
    keep = solver._window_graphs
    solver._window_graphs = False
    try:
        yield
    finally:
        solver._window_graphs = keep


def fresh_graphs(solver, device_exit=False):
    """A new, empty cache for ``solver`` (to count its captures), walked
    window by window unless ``device_exit``."""
    from reluqp_tpu_torch.core.graphs import WindowGraphs
    solver._window_graphs = WindowGraphs()
    solver._window_graphs.device_exit = device_exit
    return solver._window_graphs


def in_mode(solver, mode):
    """Phase 29's A/B: "eager" (every piece eager) or "graphed" (each
    window one replay, walked from the host)."""
    return (eager_windows(solver) if mode == "eager"
            else per_window(solver))


def same_fields(tag, pairs, bad, phase="phase 29",
                what="graphed differs from eager"):
    """Bit-equality of the (eager, graphed) pairs of result fields
    (tensors, arrays, numbers). Logs every field that differs with its
    largest difference and adds ``tag`` to ``bad``: the phase fails at its
    end, after every path has been compared."""
    diffs = []
    for name, (u, v) in pairs.items():
        u, v = (np.asarray(a.detach().cpu().numpy()
                           if hasattr(a, "detach") else a) for a in (u, v))
        eq = u.shape == v.shape and np.array_equal(
            u, v, equal_nan=u.dtype.kind == "f")
        if not eq:
            d = (float(np.nanmax(np.abs(u.astype(np.float64)
                                        - v.astype(np.float64))))
                 if u.shape == v.shape and u.dtype.kind in "fiub" else None)
            diffs.append(f"{name} (largest difference {d})")
    if diffs:
        bad.append(tag)
        log(f"{phase} {tag}: {what} in " + ", ".join(diffs))


def qp_pairs(a, b):
    """``(result, rung)`` of two single-QP solves as field pairs."""
    (ra, ia), (rb, ib) = a, b
    return {"x": (ra.x, rb.x), "z": (ra.z, rb.z), "lam": (ra.lam, rb.lam),
            "iter": (ra.info.iter, rb.info.iter),
            "status": (ra.info.status, rb.info.status),
            "pri": (ra.info.pri_res, rb.info.pri_res),
            "dua": (ra.info.dua_res, rb.info.dua_res),
            "rho_estimate": (ra.info.rho_estimate, rb.info.rho_estimate),
            "rung": (ia, ib)}


def batch_pairs(a, b):
    i, j = a.info, b.info
    return {"x": (a.x, b.x), "z": (a.z, b.z), "lam": (a.lam, b.lam),
            "iter": (i.iter, j.iter), "status": (i.status_code, j.status_code),
            "pri": (i.pri_res, j.pri_res), "dua": (i.dua_res, j.dua_res),
            "rho_estimate": (i.rho_estimate, j.rho_estimate),
            "rung": (i.rho_ind, j.rho_ind),
            "n_iter_total": (i.n_iter_total, j.n_iter_total)}


def rollout_pairs(a, b):
    names = ("states", "controls", "iters", "status", "y_final", "rung_final")
    return {n: (u, v) for n, u, v in zip(names, a, b)}


def graphs_batch(tag, card, m, kernel, bad, stages=1):
    """One batch solver's A/B: a cold solve eager, the same solve three
    times through a fresh cache (its first use of each window eager, the
    second captured, then replays), bit-equal; the kernel's launches
    equal; then
    by turns (eager, graphed, graphed, eager) the solve's least time of
    GRAPH_REPS by CUDA events, the profiler per window, the host launches
    between two host reads and the syncs per window. After the first
    window of a solve (of a repack stage: ``stages``) a replayed window
    makes at most GRAPH_WINDOW_LAUNCHES host launches."""
    from reluqp_tpu_torch.utils.timing import time_fn_events

    def one():
        m.clear_primal_dual()
        return m.solve()

    with eager_windows(m):
        r_e, c_e = _counted(one, kernel)
    cache = fresh_graphs(m)
    t0 = time.perf_counter()
    r_g, c_g = _counted(one, kernel)
    first_s = time.perf_counter() - t0
    # a window used once in a solve (a repack stage's) is captured at the
    # second solve: the third replays only
    caps1 = cache.captures
    r_g2, c_g2 = _counted(one, kernel)
    caps, cap_s = cache.captures, cache.capture_seconds
    r_g3, c_g3 = _counted(one, kernel)
    assert cache.captures == caps, "a third solve captured again"
    for name, r in (("first", r_g), ("second", r_g2), ("third", r_g3)):
        same_fields(f"{tag} {name} graphed solve", batch_pairs(r_e, r), bad)
    assert c_e[kernel] == c_g[kernel] == c_g2[kernel] == c_g3[kernel], \
        (c_e, c_g, c_g2, c_g3)
    ci = m.settings.check_interval
    windows = max(r_e.info.n_iter_total // ci, 1)
    t = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        with in_mode(m, mode):
            t[mode].append(time_fn_events(one, reps=GRAPH_REPS)["best"])
    prof, segs, syncs = {}, {}, {}
    for mode in ("eager", "graphed"):
        with in_mode(m, mode):
            prof[mode] = profile_run(f"phase 29 {tag} {mode}", one, windows,
                                     f"per check window, {windows} windows")
            segs[mode] = launches_between_reads(one)
            syncs[mode] = sync_sites(f"phase 29 {tag} {mode}", one,
                                     windows) / windows
    win = segs["graphed"][:windows]
    heavy = [n for n in win[1:] if n > GRAPH_WINDOW_LAUNCHES]
    assert len(heavy) <= stages - 1, (tag, segs["graphed"])
    assert 1 <= syncs["graphed"] <= syncs["eager"], syncs
    log(f"phase 29 {tag}: {windows} windows, {c_g[kernel]} {kernel} "
        f"launches (eager {c_e[kernel]}); first graphed solve "
        f"{first_s * 1e3:.3f} ms with {caps1} captures, {caps} after the "
        f"second solve, taking {cap_s * 1e3:.3f} ms in all; solve by CUDA "
        f"events (least of {GRAPH_REPS}, in turns) eager {t['eager'][0] * 1e3:.3f} / "
        f"{t['eager'][1] * 1e3:.3f} ms, graphed "
        f"{t['graphed'][0] * 1e3:.3f} / {t['graphed'][1] * 1e3:.3f} ms; host "
        f"launches between host reads: eager {segs['eager']}, graphed "
        f"{segs['graphed']}; syncs per window eager {syncs['eager']:.2f}, "
        f"graphed {syncs['graphed']:.2f}; on {card}")
    return dict(windows=windows, captures=caps, capture_s=cap_s,
                first_s=first_s, t=t, prof=prof, segs=segs, syncs=syncs)


def phase_graphs(card, protocol, mpc, scen_loop, het, repack):
    """Phase 29: the check windows of both solve loops as CUDA graph
    replays against the same solves with every window eager
    (``_window_graphs = False``), in this call: the canonical and protocol
    QPs (two cold solves each), phase 6's 200-step loop MPC, phase 14's
    200-step scenario loop, phase 19's B=1024 hetero solve and phase 22's
    B=10000 dense and repack solves. Each graphed result bit-equal to the
    eager one (x, z, λ, status, iterations, rungs), the kernels' counters
    equal (they count replays), the captures and their host seconds, the
    host launches between two host reads, syncs per window or step, and
    the times eager against graphed by turns."""
    import torch
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.models.mpc import (mpc_rollout_scan,
                                             scenario_rollout_scan)
    from reluqp_tpu_torch.utils.problems import canonical_qp
    bad, out = [], {}

    # the single QP: the canonical QP (phase 4) and the protocol (phase 5)
    qp = canonical_qp()
    cases = [("canonical", (qp.H, qp.g, qp.A, qp.l, qp.u),
              dict(eps_abs=1e-4))]
    cases += [(f"protocol nx={nx}", inst[:5],
               dict(eps_abs=1e-4, scaling=True, precision="float32"))
              for nx, inst in protocol[1].items()]
    for tag, data, kw in cases:
        res = {}
        for mode in ("eager", "graphed"):
            m = ReLU_QP()
            m.setup(*data, **kw)
            runs = []

            def two(m=m, runs=runs):
                for _ in range(2):
                    m.clear_primal_dual()
                    runs.append((m.solve(), m.rho_ind))

            with in_mode(m, mode):
                _, counts = _counted(two)
            res[mode] = (runs, counts["K1"], m._window_graphs)
        for i, (a, b) in enumerate(zip(res["eager"][0], res["graphed"][0])):
            same_fields(f"{tag} solve {i + 1}", qp_pairs(a, b), bad)
        cache = res["graphed"][2]
        assert cache.replays > 0 and res["eager"][1] == res["graphed"][1]
        log(f"phase 29 {tag}: two cold solves, {res['graphed'][1]} K1 "
            f"launches (eager {res['eager'][1]}), {cache.captures} captures "
            f"in {cache.capture_seconds * 1e3:.3f} ms, {cache.replays} "
            f"replays, {res['graphed'][0][0][0].info.iter} iterations")

    # phase 6's 200-step loop MPC (check_interval="auto")
    ctrl = mpc["ctrl"]
    sol = ctrl.solver
    x0 = mpc_config()[4]

    def rollout():
        sol.clear_primal_dual()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = mpc_rollout_scan(sol, ctrl.prob, x0, MPC_T, kernel="loop",
                             check_interval="auto", return_stats=True,
                             return_state=True)
        torch.cuda.synchronize()
        return o, time.perf_counter() - t0

    with eager_windows(sol):
        (o_e, _), c_e = _counted(rollout)
    cache = fresh_graphs(sol)
    (o_g, first_s), c_g = _counted(rollout)
    caps, cap_s = cache.captures, cache.capture_seconds
    same_fields(f"loop MPC {MPC_T} steps", rollout_pairs(o_e, o_g), bad)
    assert 1 <= caps <= GRAPH_MPC_CAPTURES, caps
    assert c_e["K1"] == c_g["K1"], (c_e, c_g)
    secs = {"eager": [], "graphed": []}
    for mode in ("eager", "graphed", "graphed", "eager"):
        with in_mode(sol, mode):
            secs[mode].append(rollout()[1])
    assert cache.captures <= GRAPH_MPC_CAPTURES, cache.captures
    sol.y, sol.rho_ind = o_g[4], o_g[5]
    prof, syncs = {}, {}
    for mode in ("eager", "graphed"):
        with in_mode(sol, mode):
            prof[mode] = profile_steps(f"phase 29 loop MPC {mode}", ctrl,
                                       o_g[0][-1], GRAPH_PROFILE_T, "loop",
                                       1)
            syncs[mode] = sync_sites(
                f"phase 29 loop MPC {mode}", lambda: mpc_rollout_scan(
                    sol, ctrl.prob, o_g[0][-1], GRAPH_SYNC_T, kernel="loop",
                    check_interval=1), GRAPH_SYNC_T) / GRAPH_SYNC_T
    assert syncs["graphed"] <= syncs["eager"], syncs
    rate = lambda s: MPC_T / min(s)
    log(f"phase 29 loop MPC: {MPC_T} steps, {c_g['K1']} K1 launches (eager "
        f"{c_e['K1']}), {caps} captures in {cap_s * 1e3:.3f} ms (the first "
        f"graphed rollout {first_s:.3f} s); {MPC_T}-step rollouts by turns: "
        f"eager {secs['eager'][0]:.3f} / {secs['eager'][1]:.3f} s, graphed "
        f"{secs['graphed'][0]:.3f} / {secs['graphed'][1]:.3f} s: "
        f"{rate(secs['eager']):.1f} against {rate(secs['graphed']):.1f} "
        f"steps/s; syncs per step eager {syncs['eager']:.2f}, graphed "
        f"{syncs['graphed']:.2f}; on {card}")
    out["mpc"] = dict(captures=caps, capture_s=cap_s, secs=secs, prof=prof,
                      syncs=syncs)

    # phase 14's 200-step scenario loop (B=64, K4)
    m, prob = scen_loop["m"], scen_loop["prob"]
    X0, noise = scenario_inputs(SCEN_B, SCEN_T)

    def srollout():
        m.clear_primal_dual()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = scenario_rollout_scan(m, prob, X0, SCEN_T, kernel="loop",
                                  noise=noise, return_stats=True,
                                  return_state=True)
        torch.cuda.synchronize()
        return o, time.perf_counter() - t0

    with eager_windows(m):
        (s_e, _), c_e = _counted(srollout, "K4")
    cache = fresh_graphs(m)
    (s_g, first_s), c_g = _counted(srollout, "K4")
    caps, cap_s = cache.captures, cache.capture_seconds
    same_fields(f"scenario loop {SCEN_T} steps", rollout_pairs(s_e, s_g), bad)
    assert c_e["K4"] == c_g["K4"], (c_e, c_g)
    rng = np.random.RandomState(29)
    t_lo, t_hi = SCEN_LOOP_T
    rates = {}
    for mode in ("eager", "graphed", "graphed", "eager"):
        def rollout_s(T_):
            x = X0 + 5e-5 * rng.randn(*X0.shape)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xs, _, _ = scenario_rollout_scan(m, prob, x, T_, kernel="loop")
            float(xs[-1].sum())
            return time.perf_counter() - t0

        with in_mode(m, mode):
            s_lo = min(rollout_s(t_lo) for _ in range(3))
            s_hi = min(rollout_s(t_hi) for _ in range(3))
        rates.setdefault(mode, []).append((t_hi - t_lo) / (s_hi - s_lo))
    ci = m.settings.check_interval
    m.Y, m.rho_ind = s_g[4], torch.tensor(int(s_g[5]), dtype=torch.int32,
                                          device=m.settings.device)
    sprof, ssyncs = {}, {}
    for mode in ("eager", "graphed"):
        with in_mode(m, mode):
            sprof[mode] = profile_scenario(f"phase 29 scenario loop {mode}",
                                           m, prob, s_g[0][-1], 20, "loop",
                                           ci)
            ssyncs[mode] = sync_sites(
                f"phase 29 scenario loop {mode}",
                lambda: scenario_rollout_scan(m, prob, s_g[0][-1], 10,
                                              kernel="loop",
                                              check_interval=ci), 10) / 10
    assert ssyncs["graphed"] <= ssyncs["eager"], ssyncs
    log(f"phase 29 scenario loop: {SCEN_T} steps at B={SCEN_B}, "
        f"{c_g['K4']} K4 launches (eager {c_e['K4']}), {caps} captures in "
        f"{cap_s * 1e3:.3f} ms (the first graphed rollout {first_s:.3f} s); "
        f"two-point steps/s (T={t_lo}/{t_hi}, min of 3) by turns: eager "
        f"{rates['eager'][0]:.1f} / {rates['eager'][1]:.1f}, graphed "
        f"{rates['graphed'][0]:.1f} / {rates['graphed'][1]:.1f}; syncs per "
        f"step eager {ssyncs['eager']:.2f}, graphed {ssyncs['graphed']:.2f}; "
        f"on {card}")
    out["scenario"] = dict(captures=caps, capture_s=cap_s, rates=rates,
                           prof=sprof, syncs=ssyncs)

    # phase 19's hetero batch and phase 22's shared batch, dense and repack
    out["hetero"] = graphs_batch(f"hetero B={het['m'].B_n}", card, het["m"],
                                 "K5", bad)
    out["dense"] = graphs_batch(f"dense B={REPACK_B}", card, repack["md"],
                                "K4", bad)
    out["repack"] = graphs_batch(f"repack B={REPACK_B}", card, repack["m"],
                                 "K4", bad, stages=len(repack["sched"]))
    assert not bad, f"graphed differs from eager: {bad}"
    log("phase 29 OK: every covered path's graphed windows equal its eager "
        "ones bit for bit")
    return out


# --------------------------------------------------------------------- #
# phase 30: a solve as one device program against per-window and eager  #
# --------------------------------------------------------------------- #

# the three ways a solve runs: every piece eager, each window one replay
# walked from the host (phase 29's graphed path), one device program
EXIT_MODES = ("eager", "windows", "device")
# A/B order of the timings; "plain": the device exit with the plain torch
# check in place of kernels C1 and C2 (WindowGraphs.check_kernels off)
EXIT_TURNS = ("eager", "windows", "device", "plain", "plain", "device",
              "windows", "eager")
EXIT_REPS = 5
# steps of the one-segment rollouts whose host reads and launches are
# counted
EXIT_SEG_T = 50


@contextlib.contextmanager
def exit_mode(solver, mode, caches):
    """``solver``'s solves in ``mode`` inside the ``with``, each mode
    through a cache of its own kept in ``caches`` (captures counted apart)
    : "eager" (``_window_graphs = False``), "windows" (``device_exit =
    False``), "device" (the default: one device program) or "plain" (one
    device program checking each window with the plain torch check,
    ``check_kernels = False``)."""
    from reluqp_tpu_torch.core.graphs import WindowGraphs
    keep = solver._window_graphs
    if mode == "eager":
        solver._window_graphs = False
    else:
        if mode not in caches:
            caches[mode] = WindowGraphs()
            caches[mode].device_exit = mode in ("device", "plain")
            caches[mode].check_kernels = mode != "plain"
        solver._window_graphs = caches[mode]
    try:
        yield
    finally:
        solver._window_graphs = keep


class count_reads:
    """The host reads of the solve loops (``WindowGraphs.read`` calls: one
    copy set and one synchronisation each) inside the ``with``, and where
    the host's time goes: ``read_s`` waiting in the reads (the card still
    working), ``program_s`` in ``WindowGraphs.program`` (building the
    launch, or walking the windows with their reads), ``wall_s`` in all."""

    def __enter__(self):
        from reluqp_tpu_torch.core import graphs
        cls = self._cls = graphs.WindowGraphs
        self._real = (cls.read, cls.program)
        self.n, self.read_s, self.program_s = 0, 0.0, 0.0
        real_read, real_program = self._real

        def read(cache, *ts, **kw):
            self.n += 1
            t0 = time.perf_counter()
            try:
                return real_read(cache, *ts, **kw)
            finally:
                self.read_s += time.perf_counter() - t0

        def program(cache, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real_program(cache, *a, **kw)
            finally:
                self.program_s += time.perf_counter() - t0

        cls.read, cls.program = read, program
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.wall_s = time.perf_counter() - self._t0
        self._cls.read, self._cls.program = self._real


def exit_solver(tag, card, solvers, one, kernel, pairs, bad):
    """One solve path's A/B over EXIT_MODES: ``solvers`` maps each mode to
    its solver (or one solver for all), ``one(m)`` runs a cold solve. Three
    solves per mode (walked, captured and built, launched), bit-equal
    across the modes, the kernel's launches equal; in the device mode one
    host read and one sync per solve; the host launches per solve; the
    solve's CUDA-event time by turns; the host wall of a device-exit
    solve split into making the launch, waiting on the card in the read
    and the rest."""
    import torch
    from reluqp_tpu_torch.utils.timing import time_fn_events
    caches, runs, counts = {}, {}, {}
    for mode in EXIT_MODES:
        m = solvers[mode]
        with exit_mode(m, mode, caches):
            runs[mode], counts[mode] = _counted(
                lambda m=m: [one(m) for _ in range(3)], kernel)
    for mode in ("windows", "device"):
        for i, (a, b) in enumerate(zip(runs["eager"], runs[mode])):
            same_fields(f"{tag} solve {i + 1} {mode}", pairs(a, b), bad,
                        phase="phase 30", what=f"{mode} differs from eager")
    assert counts["eager"][kernel] == counts["windows"][kernel] \
        == counts["device"][kernel], (tag, counts)
    m = solvers["device"]
    with exit_mode(m, "device", caches):
        with count_reads() as reads:
            one(m)
        split = []
        for _ in range(EXIT_REPS):
            torch.cuda.synchronize()
            with count_reads() as r:
                one(m)
            split.append((r.wall_s, r.program_s, r.read_s))
        syncs = sync_sites(f"phase 30 {tag} device", lambda: one(m), 1)
        segs = launches_between_reads(lambda: one(m))
    with exit_mode(solvers["windows"], "windows", caches):
        with count_reads() as reads_w:
            one(solvers["windows"])
        segs_w = launches_between_reads(lambda: one(solvers["windows"]))
    assert reads.n == 1 and syncs == 1, (tag, reads.n, syncs)
    assert caches["device"].programs >= 1
    # the plain-check A/B: its program walked, built and launched first
    with exit_mode(m, "plain", caches):
        plain = [one(m) for _ in range(3)]
    host = lambda a: np.asarray(a.detach().cpu().numpy()
                                if hasattr(a, "detach") else a)
    same_plain = all(np.array_equal(host(u), host(v)) for k, (u, v) in pairs(
        runs["device"][-1], plain[-1]).items() if k in ("iter", "status",
                                                          "rung"))
    t = {mode: [] for mode in EXIT_MODES + ("plain",)}
    for mode in EXIT_TURNS:
        mm = solvers.get(mode, m)
        with exit_mode(mm, mode, caches):
            t[mode].append(time_fn_events(one, mm, reps=EXIT_REPS)["best"])
    ms = lambda mode: " / ".join(f"{x * 1e3:.3f}" for x in t[mode])
    wall, prog, wait = min(split)
    log(f"phase 30 {tag}: a device-exit solve's host wall (least of "
        f"{EXIT_REPS}) {wall * 1e3:.3f} ms: {prog * 1e3:.3f} ms making the "
        f"launch, {wait * 1e3:.3f} ms waiting in the read while the card "
        f"runs, {(wall - prog - wait) * 1e3:.3f} ms of the solve's own host "
        f"work before and after")
    log(f"phase 30 {tag}: {counts['device'][kernel]} {kernel} launches in "
        f"three solves in every mode; device exit: {reads.n} host read, "
        f"{syncs} sync, {sum(segs)} host launches per solve "
        f"(between reads {segs}); per window: {reads_w.n} reads, "
        f"{sum(segs_w)} host launches; solve by CUDA events (least of "
        f"{EXIT_REPS}, by turns) eager {ms('eager')} ms, per-window "
        f"{ms('windows')} ms, device exit {ms('device')} ms, device exit "
        f"with the plain check {ms('plain')} ms (its iterations, status and "
        f"rungs {'equal to' if same_plain else 'differ from'} C1's/C2's); "
        f"on {card}")
    return dict(reads=reads.n, reads_w=reads_w.n, launches=sum(segs),
                launches_w=sum(segs_w), t=t, split=(wall, prog, wait),
                same_plain=same_plain)


def exit_rollout(tag, card, m, run, seg, kernel, pairs, bad, steps):
    """A loop rollout's A/B over EXIT_MODES on one solver: ``run()`` the
    checked rollout (its state reset inside), bit-equal across the modes
    with equal kernel launches; ``seg()`` a one-segment rollout of
    ``steps`` steps from device-resident inputs: in the device mode one
    host read and one sync per segment, host launches per step; two-point
    steps/s by turns."""
    import torch
    caches, outs, counts = {}, {}, {}
    for mode in EXIT_MODES:
        with exit_mode(m, mode, caches):
            outs[mode], counts[mode] = _counted(run, kernel)
    for mode in ("windows", "device"):
        same_fields(f"{tag} {mode}", pairs(outs["eager"], outs[mode]), bad,
                    phase="phase 30", what=f"{mode} differs from eager")
    assert counts["eager"][kernel] == counts["windows"][kernel] \
        == counts["device"][kernel], (tag, counts)
    with exit_mode(m, "device", caches):
        seg()
        with count_reads() as reads:
            seg()
        syncs = sync_sites(f"phase 30 {tag} device", seg, 1)
        segs = launches_between_reads(seg)
    with exit_mode(m, "windows", caches):
        seg()
        with count_reads() as reads_w:
            seg()
        segs_w = launches_between_reads(seg)
    assert reads.n == 1 and syncs == 1, (tag, reads.n, syncs)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with exit_mode(m, "plain", caches):
        seg()
        seg()
    rate = {mode: [] for mode in EXIT_MODES + ("plain",)}
    for mode in EXIT_TURNS:
        with exit_mode(m, mode, caches):
            seg()
            rate[mode].append(steps / min(timed() for _ in range(3)))
    r = lambda mode: " / ".join(f"{x:.1f}" for x in rate[mode])
    log(f"phase 30 {tag}: {counts['device'][kernel]} {kernel} launches in "
        f"every mode; a {steps}-step segment: device exit {reads.n} host "
        f"read, {syncs} sync, {sum(segs) / steps:.3f} host launches per step; "
        f"per window {reads_w.n} reads, {sum(segs_w) / steps:.3f} host "
        f"launches per step; steps/s (least of 3 segments, by turns) eager "
        f"{r('eager')}, per-window {r('windows')}, device exit "
        f"{r('device')}, device exit with the plain check {r('plain')}; on "
        f"{card}")
    return dict(reads=reads.n, reads_w=reads_w.n,
                launches=sum(segs) / steps, launches_w=sum(segs_w) / steps,
                rate=rate)


def phase_device_exit(card, protocol, mpc, scen_loop, het, repack):
    """Phase 30: a solve as one device program (``core.graphs``, the
    conditional WHILE nodes of ``csrc/graph_loop.cu``) against the same
    solves walked window by window (phase 29's graphed path) and eager, in
    this call: the canonical and protocol QPs (nx 100/323/500), phase 6's
    loop MPC, phase 14's scenario loop (B=64), phase 19's B=1024 hetero
    solve and phase 22's B=10000 dense solve. Each bit-equal across the
    three modes (x, z, λ, status, iterations, rungs, residuals) with equal
    kernel launches (the device program's body counts settle the hooks);
    in the device mode one host read and one sync per solve and per
    rollout segment; host launches per solve or step; CUDA-event solve
    times and steps/s by turns."""
    import torch
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.models.mpc import (mpc_rollout_scan,
                                             scenario_rollout_scan)
    from reluqp_tpu_torch.utils.problems import canonical_qp
    bad, out = [], {}
    # canonical (phase 4) and protocol (phase 5) QPs: a solver per mode
    qp = canonical_qp()
    cases = [("canonical", (qp.H, qp.g, qp.A, qp.l, qp.u),
              dict(eps_abs=1e-4))]
    cases += [(f"protocol nx={nx}", inst[:5],
               dict(eps_abs=1e-4, scaling=True, precision="float32"))
              for nx, inst in protocol[1].items()]

    def one_qp(m):
        m.clear_primal_dual()
        return m.solve(), m.rho_ind

    for tag, data, kw in cases:
        solvers = {}
        for mode in EXIT_MODES:
            solvers[mode] = ReLU_QP()
            solvers[mode].setup(*data, **kw)
        out[tag] = exit_solver(tag, card, solvers, one_qp, "K1", qp_pairs,
                               bad)

    # phase 6's loop MPC: 200 steps (check_interval="auto": two segments)
    ctrl = mpc["ctrl"]
    sol = ctrl.solver
    x0 = mpc_config()[4]
    x_dev = torch.as_tensor(x0, dtype=sol.settings.precision_dtype,
                            device="cuda")

    def rollout():
        sol.clear_primal_dual()
        return mpc_rollout_scan(sol, ctrl.prob, x0, MPC_T, kernel="loop",
                                check_interval="auto", return_stats=True,
                                return_state=True)

    ci = {}

    def seg():
        return mpc_rollout_scan(sol, ctrl.prob, x_dev, EXIT_SEG_T,
                                kernel="loop", check_interval=ci["ci"])

    ci["ci"] = _auto_ci(sol, ctrl.prob, x0)
    out["mpc"] = exit_rollout("loop MPC", card, sol, rollout, seg, "K1",
                              rollout_pairs, bad, EXIT_SEG_T)
    out["mpc"]["ci"] = ci["ci"]

    # phase 14's scenario loop (B=64, K4)
    m, prob = scen_loop["m"], scen_loop["prob"]
    X0, noise = scenario_inputs(SCEN_B, SCEN_T)
    X_dev = torch.as_tensor(X0, dtype=m.settings.precision_dtype,
                            device="cuda")

    def srollout():
        m.clear_primal_dual()
        return scenario_rollout_scan(m, prob, X0, SCEN_T, kernel="loop",
                                     noise=noise, return_stats=True,
                                     return_state=True)

    def sseg():
        return scenario_rollout_scan(m, prob, X_dev, EXIT_SEG_T,
                                     kernel="loop")

    out["scenario"] = exit_rollout(f"scenario loop B={SCEN_B}", card, m,
                                   srollout, sseg, "K4", rollout_pairs, bad,
                                   EXIT_SEG_T)

    # phase 19's hetero batch and phase 22's dense batch: one solver each
    for tag, mm, kernel in ((f"hetero B={het['m'].B_n}", het["m"], "K5"),
                            (f"dense B={REPACK_B}", repack["md"], "K4")):
        out[tag] = exit_solver(tag, card, {k: mm for k in EXIT_MODES},
                               repack_solve, kernel, batch_pairs, bad)
    assert not bad, f"the device exit differs: {bad}"
    log("phase 30 OK: every covered path with the device exit equals its "
        "per-window and eager solves bit for bit, one host read per solve "
        "and per rollout segment")
    return out


def _auto_ci(sol, prob, x0):
    """The window ``check_interval="auto"`` picks for this rollout (its
    ci=1 calibration segment, then ``auto_check_interval``)."""
    from reluqp_tpu_torch.models.mpc import (auto_check_interval,
                                             mpc_rollout_scan)
    sol.clear_primal_dual()
    _, _, its = mpc_rollout_scan(sol, prob, x0, 8, kernel="loop",
                                 check_interval=1)
    stng = sol.settings
    return auto_check_interval(its.numpy(), stng.check_interval,
                               stng.max_iter)


# --------------------------------------------------------------------- #
# phase 31: the check window as kernels C1 and C2                       #
# --------------------------------------------------------------------- #

# Kernel against plain version on recorded windows. A residual is the max
# of |a - b| over sums of products that both sides form from the same
# inputs: the kernels in a fixed order (C1 in chains of at most 32 terms in
# the state type, their sums in fp64; C2 in the state type), the plain
# version in the state type in cuBLAS's order. They therefore differ by the
# state type's rounding of sums as large as the residual's scale (max |Ax|,
# |z| for pri; |Hx|, |Aᵀλ|, |g| for dua), and pri and dua are held within
# CHECK_RTOL of that scale. The ρ estimate
# ρ·sqrt((pri/scale_p)/(dua/scale_d)) carries half of each residual's
# relative error and a few roundings of its own (CHECK_RHO_ULPS).
CHECK_RTOL = {"float32": 1e-5, "float64": 1e-12}
CHECK_RHO_ULPS = 8
# recorded full windows per solve (its tail window is recorded too)
CHECK_WINDOWS = 3
# launches per timing (in one CUDA graph)
CHECK_REPS = 50
# Published H100 SXM fp64 vector peak (data sheet), for the operations
# bound of a check in fp64.
FP64_FLOPS = 34e12
CHUNK_KERNELS = ("k1_kernel", "k4_kernel", "k4_tile_kernel", "k5_kernel")
CHECK_KERNELS = ("c1_kernel", "c2_kernel", "c2_reencode")
# the recorded C1 case the kernels line reports (the protocol's nx=100)
CHECK_MAIN_C1 = "nx=100 Dp=256 fp32"


def _clone_nt(nt):
    """A named tuple with every tensor field cloned."""
    import torch
    return nt._replace(**{f: v.clone() for f, v in nt._asdict().items()
                          if isinstance(v, torch.Tensor)})


class record_checks:
    """The checks the solve loops make inside the ``with`` (solves run
    eagerly): each one's inputs cloned before it runs, as ``(kind, state,
    operands, settings, runner output, n_steps, phase)``, the first
    ``limit`` full windows and every tail window."""

    def __init__(self, limit=CHECK_WINDOWS):
        self.limit, self.recs = limit, []

    def _wrap(self, kind, real):
        def check(st, op, cfg, y, n_steps, phase):
            full = sum(r[6] != "tail" for r in self.recs)
            if phase == "tail" or full < self.limit:
                self.recs.append((kind, _clone_nt(st),
                                  _clone_nt(op._replace(bias=None)), cfg,
                                  y.clone(), n_steps, phase))
            return real(st, op, cfg, y, n_steps, phase)
        return check

    def __enter__(self):
        from reluqp_tpu_torch.core import batched as tb
        from reluqp_tpu_torch.core import iteration as ti
        self._real = (ti.check_window, tb.batched_check)
        ti.check_window = self._wrap("C1", self._real[0])
        tb.batched_check = self._wrap("C2", self._real[1])
        return self

    def __exit__(self, *exc):
        from reluqp_tpu_torch.core import batched as tb
        from reluqp_tpu_torch.core import iteration as ti
        ti.check_window, tb.batched_check = self._real


def check_terms(rec):
    """What a recorded check compares, recomputed in fp64 from its inputs:
    per row (a (B,) tensor; one row for C1) the residuals, their scales,
    the ρ estimate and, with the certificates, each test's value, its
    threshold and the magnitude of the sums behind it."""
    import torch
    from reluqp_tpu_torch.ops.check_window import _mv, batched_lam_of, lam_of
    from reluqp_tpu_torch.ops.fused_step import pad_dim
    kind, st, op, cfg, y, n, phase = rec
    d = lambda t: None if t is None else t.double()
    nx, nc = cfg.nx, cfg.nc
    amax = lambda v: v.abs().amax(dim=-1)
    if kind == "C1":
        Y = d(y)[None]
        opd = op._replace(rho_eff=d(op.rho_eff))
        lam = lam_of(d(y), st.rho_ind, opd, cfg)[None]
        H, A, G = d(op.H), d(op.A), d(op.g)[None]
        lo, hi = d(op.lo)[None], d(op.hi)[None]
        rho, done = d(st.rho)[None], torch.zeros(1, dtype=torch.bool,
                                                 device=y.device)
        xp = d(st.x_prev)[None] if st.x_prev is not None else None
        lp = d(st.lam_prev)[None] if st.lam_prev is not None else None
    else:
        Y = d(y)
        lam = batched_lam_of(Y, st.rho_ind, nx, nc, cfg.alpha,
                             d(op.rho_eff))
        H, A, G, lo, hi = d(op.H), d(op.A), d(op.G), d(op.lo), d(op.hi)
        G = torch.broadcast_to(G, (Y.shape[0], nx))
        rho, done = d(st.rho), st.done
        xp, lp = d(st.X_prev), d(st.Lam_prev)
    X, Z = Y[:, :nx], Y[:, nx:nx + nc]
    if kind == "C1" and op.M_res is not None:
        r = Y @ d(op.M_res)
        ncp, nxp = pad_dim(nc), pad_dim(nx)
        ax, z = r[:, :ncp], r[:, ncp:2 * ncp]
        hx, atl = r[:, 2 * ncp:2 * ncp + nxp], r[:, 2 * ncp + nxp:]
        g = d(op.g_row)[None]
    else:
        ax, hx, atl, z, g = _mv(A, X), _mv(H, X), _mv(A.transpose(-1, -2),
                                                     lam), Z, G
        wp, wd = d(op.w_pri), d(op.w_dua)
        if wp is not None:
            ax, z = wp * ax, wp * z
        if wd is not None:
            hx, atl, g = wd * hx, wd * atl, wd * g
    t = dict(pri=amax(ax - z), dua=amax(hx + atl + g),
             sp=torch.maximum(amax(ax), amax(z)),
             sd=torch.maximum(torch.maximum(amax(hx), amax(atl)), amax(g)))
    tiny = 1e-30
    ratio = torch.sqrt((t["pri"] / t["sp"].clamp_min(tiny))
                       / (t["dua"] / t["sd"].clamp_min(tiny)).clamp_min(tiny))
    t["est"] = torch.clamp(rho * ratio, cfg.rho_min, cfg.rho_max)
    t["done"] = done
    if cfg.check_infeasibility and phase != "tail":
        dx, dl = X - xp, lam - lp
        ndl, ndx = amax(dl), amax(dx)
        eps_p, eps_d = cfg.eps_prim_inf * ndl, cfg.eps_dual_inf * ndx
        absmv = lambda M, v: _mv(M.abs(), v.abs())
        u, l = hi[:, nx:nx + nc], lo[:, nx:nx + nc]
        terms = torch.where(dl > 0, u * dl, torch.where(dl < 0, l * dl, 0.0))
        adx = _mv(A, dx)
        ray = torch.minimum(
            torch.where(torch.isfinite(u), eps_d[:, None] - adx, torch.inf),
            torch.where(torch.isfinite(l), adx + eps_d[:, None], torch.inf))
        # (value - threshold, magnitude of the sum): a test ties where
        # |value - threshold| <= 2 rtol magnitude
        t["cert"] = [
            (amax(_mv(A.transpose(-1, -2), dl)) - eps_p,
             amax(absmv(A.transpose(-1, -2), dl))),
            (terms.sum(-1) + eps_p, terms.abs().sum(-1)),
            (amax(_mv(H, dx)) - eps_d, amax(absmv(H, dx))),
            ((G * dx).sum(-1) + eps_d, (G * dx).abs().sum(-1)),
            (ray.amin(-1), amax(absmv(A, dx)))]
    return t


def _rho_tol(t, rtol, eps):
    """Relative tolerance of each row's ρ estimate (CHECK_RTOL's note)."""
    import torch
    p = t["pri"].clamp_min(1e-300)
    q = t["dua"].clamp_min(1e-300)
    return 0.5 * rtol * (t["sp"] / p + t["sd"] / q + 2) + CHECK_RHO_ULPS * eps


def _near(v, bounds, rel):
    """Rows where ``v`` lies within ``rel`` (relative) of any of
    ``bounds`` (values or (B,) tensors)."""
    import torch
    out = torch.zeros_like(v, dtype=torch.bool)
    for b in bounds:
        out |= (v - b).abs() <= rel * torch.as_tensor(b).abs()
    return out


def check_ties(rec, t, rtol):
    """Rows whose decisions the plain version takes within the tolerance
    of a threshold (fp64 values of ``check_terms``), and what they are."""
    import torch
    kind, st, op, cfg, y, n, phase = rec
    why = {}
    rt = 2 * _rho_tol(t, rtol, torch.finfo(y.dtype).eps)
    why["solved"] = ((t["pri"] - cfg.eps_pri).abs() <= 2 * rtol * t["sp"]) \
        | ((t["dua"] - cfg.eps_dua).abs() <= 2 * rtol * t["sd"])
    rhos = op.rhos.double()
    mids = [torch.sqrt(rhos[i] * rhos[i + 1])
            for i in range(rhos.shape[0] - 1)] if cfg.rho_jump else []
    band = [r * cfg.tol for r in rhos] + [r / cfg.tol for r in rhos] + mids
    walks = cfg.adaptive_rho and not (kind == "C1" and phase == "tail")
    if walks and (kind == "C1" or not cfg.shared):
        why["walk"] = _near(t["est"], band, rt)
    if "cert" in t:
        tie = torch.zeros_like(t["pri"], dtype=torch.bool)
        for val, mag in t["cert"]:
            tie |= val.abs() <= 2 * rtol * mag
        why["certificate"] = tie
    if phase == "A" and kind == "C1":
        s = cfg.stall
        why["stall"] = ((t["pri"] - s * st.best_p.double()).abs()
                        <= 2 * rtol * t["sp"]) | (
            (t["dua"] - s * st.best_d.double()).abs() <= 2 * rtol * t["sd"])
    rows = torch.zeros_like(t["pri"], dtype=torch.bool)
    for v in why.values():
        rows |= v
    rows &= ~t["done"]
    why = {k: n for k, v in why.items()
           if (n := int((v & ~t["done"]).sum()))}
    if kind == "C2" and cfg.shared and walks:
        # the geometric mean of the live rows' estimates against the band
        live = ~t["done"]
        if live.any():
            le = torch.log(t["est"][live])
            gm = torch.exp(le.mean())
            tol = rt[live].mean() + 8 * torch.finfo(y.dtype).eps * float(
                le.abs().max())
            if bool(_near(gm[None], band, 2 * tol).any()):
                why["shared walk"] = 1
    return rows, why


def check_compare(tag, rec, ties):
    """One recorded check through its kernel and its plain version on the
    same inputs. Residuals within CHECK_RTOL of their scale, the ρ
    estimate within its propagated tolerance, rungs, status, iterations,
    flags equal and the state's vectors bit-equal, except where a decision
    of the plain version ties (``check_ties``: every record with a
    decision within the tolerance of its threshold goes into ``ties``, with
    what it decided otherwise). Returns the largest residual error relative
    to its scale, the number of decisions taken otherwise (rows and
    flags) and the largest absolute residual difference."""
    import torch
    from reluqp_tpu_torch.ops.check_window import (batched_check,
                                                   batched_check_ref,
                                                   check_window,
                                                   check_window_ref)
    kind, st, op, cfg, y, n, phase = rec
    c1 = kind == "C1"
    ref = (check_window_ref if c1 else batched_check_ref)(
        _clone_nt(st), op, cfg, y, n, phase)
    got = _clone_nt(st)
    (check_window if c1 else batched_check)(got, op, cfg, y, n, phase)
    torch.cuda.synchronize()
    rtol = CHECK_RTOL[str(y.dtype).split(".")[-1]]
    eps = torch.finfo(y.dtype).eps
    t = check_terms(rec)
    row = lambda v: torch.as_tensor(v).double().reshape(-1)
    err = max(float(((row(got.pri) - row(ref.pri)).abs()
                     / t["sp"].clamp_min(1e-30)).max()),
              float(((row(got.dua) - row(ref.dua)).abs()
                     / t["sd"].clamp_min(1e-30)).max()))
    assert err <= rtol, (tag, "residuals", err)
    err_abs = max(float((row(got.pri) - row(ref.pri)).abs().max()),
                  float((row(got.dua) - row(ref.dua)).abs().max()))
    live = ~t["done"]
    drho = ((row(got.rho) - row(ref.rho)).abs()
            / row(ref.rho).abs().clamp_min(1e-300))
    assert bool((drho[live] <= _rho_tol(t, rtol, eps)[live]).all()), \
        (tag, "rho", float(drho.max()))
    assert torch.equal(row(got.rho)[~live], row(ref.rho)[~live]), (tag, "rho")
    tie_rows, why = check_ties(rec, t, rtol)
    n_tie = int(tie_rows.sum()) + len([k for k in why if k in (
        "shared walk",)])
    same = lambda a, b: torch.equal(torch.as_tensor(a).long(),
                                    torch.as_tensor(b).long())
    if c1:
        decided = ["rho_ind", "status", "k"] + (
            [] if phase == "tail" else ["open", "tail"]) + (
            ["open_a", "n_stall", "k_fast"] if phase == "A" else [])
        diff = [f for f in decided if not same(getattr(got, f),
                                               getattr(ref, f))]
        if diff:
            assert n_tie, (tag, "decisions differ", diff)
            ties.append((tag, phase, why, diff))
            return err, 1, err_abs
        assert torch.equal(got.y, ref.y), (tag, "y")
        if cfg.check_infeasibility and phase != "tail":
            assert torch.equal(got.x_prev, ref.x_prev), (tag, "x_prev")
            assert torch.equal(got.lam_prev, ref.lam_prev), (tag, "lam_prev")
        if n_tie:
            ties.append((tag, phase, why, []))
        return err, 0, err_abs
    # rows that decided otherwise must be rows whose decision ties
    flags = ["k", "n_open", "open", "tail"] + (
        ["rho_ind"] if cfg.shared else []) + (
        ["best_open", "n_stall", "k_fast", "open_a"] if phase == "A" else [])
    diff = [f for f in flags if not same(getattr(got, f), getattr(ref, f))]
    if diff and phase == "A" and "rho_ind" not in diff:
        # phase A's metric: the mean log residual of the open rows
        open_ = ~ref.done
        lr = torch.log((t["pri"] + t["dua"]).clamp_min(1e-30))[open_]
        tol = float((rtol * (t["sp"] + t["sd"])
                     / (t["pri"] + t["dua"]).clamp_min(1e-30))[open_].max()) \
            + 8 * float(eps) * float(lr.abs().max())
        if abs(float(lr.mean()) - (float(st.best_m) - cfg.stall)) <= 2 * tol:
            why["stall"] = 1
            n_tie += 1
    assert not diff or n_tie, (tag, "flags differ", diff, why)
    rung_same = not cfg.shared or same(got.rho_ind, ref.rho_ind)
    bad = torch.zeros_like(tie_rows)
    for f in ("done", "iters", "status") + (() if cfg.shared
                                            else ("rho_ind",)):
        bad |= torch.as_tensor(getattr(got, f)).long() \
            != torch.as_tensor(getattr(ref, f)).long()
    if rung_same:
        bad |= (got.Y != ref.Y).any(dim=1)
    assert not bool((bad & ~tie_rows).any()), \
        (tag, "rows decided otherwise", int((bad & ~tie_rows).sum()))
    if phase == "A" and not diff:
        assert float((got.best_m.double() - ref.best_m.double()).abs()) \
            <= rtol * float((t["sp"] / t["pri"].clamp_min(1e-30)
                             + t["sd"] / t["dua"].clamp_min(1e-30)).max()
                            + 1), (tag, "best_m")
    if cfg.check_infeasibility:
        assert torch.equal(got.X_prev, ref.X_prev), (tag, "X_prev")
        assert torch.equal(got.Lam_prev, ref.Lam_prev), (tag, "Lam_prev")
    n_bad = int(bad.sum()) + len(diff)
    if n_tie:
        ties.append((tag, phase, why, diff + ([f"{int(bad.sum())} rows"]
                                              if bad.any() else [])))
    return err, n_bad, err_abs


def check_bytes_ops(rec):
    """The bytes a check must move (each input read once, each output
    written once) and the multiply-adds of its products, from the shapes."""
    kind, st, op, cfg, y, n, phase = rec
    e = y.element_size()
    nx, nc = cfg.nx, cfg.nc
    nb = lambda t: 0 if t is None else t.numel() * t.element_size()
    certs = cfg.check_infeasibility and phase != "tail"
    if kind == "C1":
        dp = y.shape[0]
        if op.M_res is not None:
            ins = nb(op.M_res) + nb(op.g_row)
            macs = op.M_res.numel()
        else:
            ins = nb(op.H) + nb(op.A) + nb(op.g) + nb(op.w_pri) + nb(op.w_dua)
            macs = nx * nx + 2 * nc * nx
        if certs:
            ins += (0 if op.M_res is None else nb(op.H) + nb(op.A) + nb(op.g))
            ins += (nx + 3 * nc) * e      # x_prev, lam_prev, l and u
            macs += nx * nx + 2 * nc * nx
        ins += dp * e + 16 * 4           # y and the state's scalars
        out = dp * e + (nx + nc) * e * certs + 16 * 4
        if cfg.alpha != 1.0:
            ins += 2 * nc * e             # ρ⃗ at the old and new rungs
        return ins + out, 2 * macs
    B, dp = y.shape
    per_row = 3 * e + 1 + 8 + (0 if cfg.shared else 4)
    ins = nb(y) + nb(op.H) + nb(op.A) + nb(op.G) + nb(op.w_pri) \
        + nb(op.w_dua) + B * per_row
    out = nb(y) + B * per_row
    if certs:
        ins += B * (nx + 3 * nc) * e
        out += B * (nx + nc) * e
    if cfg.alpha != 1.0:
        ins += (2 if cfg.shared else 2 * B) * nc * e
    macs = B * (nx * nx + 2 * nc * nx) * (2 if certs else 1)
    return ins + out, 2 * macs


def _parent_state(st):
    """A recorded state as the parent's C1 and C2 read it: by attribute,
    with the ticket buffer its C1 took (the state has none since C1 runs in
    one cluster)."""
    import types
    import torch
    d = st._asdict()
    if d.get("tick") is None:
        d["tick"] = torch.zeros(2, dtype=torch.int32, device=st.rho.device)
    return types.SimpleNamespace(**d)


def check_timing(tag, rec, card, parent=None):
    """One recorded check: the kernel and the plain check, each
    CHECK_REPS launches replayed in one CUDA graph (the plain one's ~50
    ops each a kernel node), the bound and the kernel's stage split
    (``ops.check_window.stage_split``); with ``parent``, the parent's
    kernel on the same inputs by turns (parent, this tree twice, parent)."""
    import torch
    from reluqp_tpu_torch.ops.check_window import (assign, batched_check,
                                                   batched_check_plan,
                                                   batched_check_ref,
                                                   check_window,
                                                   check_window_plan,
                                                   check_window_ref,
                                                   stage_split)
    kind, st, op, cfg, y, n, phase = rec
    ker = check_window if kind == "C1" else batched_check
    ref = check_window_ref if kind == "C1" else batched_check_ref
    sk, sp = _clone_nt(st), _clone_nt(st)
    mine = lambda: ker(sk, op, cfg, y, n, phase)
    out = {}
    if parent:
        pm = parent_module(parent, "ops.check_window")
        pker = pm.check_window if kind == "C1" else pm.batched_check
        so = _parent_state(_clone_nt(st))
        theirs = lambda: pker(so, op, cfg, y, n, phase)
        before = graph_ms(theirs, CHECK_REPS)
        ms = graph_ms(mine, CHECK_REPS)
        again = graph_ms(mine, CHECK_REPS)
        after = graph_ms(theirs, CHECK_REPS)
        out.update(parent_ms=(before, after), ms_again=again)
    else:
        ms = graph_ms(mine, CHECK_REPS)
    plain = graph_ms(lambda: assign(sp, ref(sp, op, cfg, y, n, phase)),
                     CHECK_REPS)
    ss = _clone_nt(st)
    split = stage_split(lambda: ker(ss, op, cfg, y, n, phase), ker)
    out["plan"] = (check_window_plan if kind == "C1" else batched_check_plan)(
        st, op, cfg, y, n, phase)
    nbytes, ops = check_bytes_ops(rec)
    peak = FP64_FLOPS if y.dtype == torch.float64 else FP32_FLOPS
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    bound, by = (t_b, "bytes") if t_b >= t_o else (t_o, "operations")
    ab = ""
    if parent:
        ab = (f" (parent {out['parent_ms'][0]:.5f} ms, this tree {ms:.5f} "
              f"and {out['ms_again']:.5f} ms, parent again "
              f"{out['parent_ms'][1]:.5f} ms, by turns)")
    log(f"phase 31 {tag}: {kind} {ms:.5f} ms per launch{ab}, plain check "
        f"{plain:.5f} ms (both in a CUDA graph of {CHECK_REPS}); bound "
        f"{bound:.6f} ms ({by}: {nbytes} bytes, {ops} flop); on {card}")
    log(f"phase 31 {tag}: {kind} stage split, µs from the earliest block's "
        f"start to the latest block's pass (mean of 20 launches alone): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; plan {out['plan']}")
    out.update(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
               split=split)
    return out


def window_nodes(tag, solver, kind, chunk_kernel=True):
    """The nodes of one captured check window of ``solver`` (its cache
    walked window by window): after the chunk kernel (K1, K4 or K5 where
    ``chunk_kernel``, else a plain runner's last op) only the check's
    launches, at most 1 for C1 and 2 for C2. Returns the chunk's node."""
    from reluqp_tpu_torch.ops.check_window import graph_kernels
    cache = solver._window_graphs
    keys = [k for k in cache.keys() if k[0] == "window"
            and cache._windows[k].graph is not None]
    assert keys, f"{tag}: no captured window"
    names = graph_kernels(cache._windows[keys[0]].graph.raw())
    kernels = [s for s in names if s not in ("memcpy", "memset", "empty")]
    first = min(i for i, s in enumerate(kernels)
                if any(c in s for c in CHECK_KERNELS))
    after = kernels[first:]
    limit = 1 if kind == "C1" else 2
    assert len(after) <= limit and all(
        any(c in s for c in CHECK_KERNELS) for s in after), (tag, kernels)
    chunk = kernels[first - 1] if first else None
    assert not chunk_kernel or any(c in (chunk or "")
                                   for c in CHUNK_KERNELS), (tag, kernels)
    log(f"phase 31 {tag}: a captured window's kernel nodes end "
        f"{[_short(s) for s in kernels[max(0, first - 1):]]} "
        f"({len(kernels)} kernel nodes, {len(names)} nodes)")
    return chunk


def body_nodes(tag, solver, run, kind):
    """The nodes of one WHILE body of ``solver``'s device program (its
    cache made anew, ``run()`` three times: walked, built, launched): the
    window's nodes, then only the check's launches after the chunk
    kernel, then the body counter (``graph_loop.cu``'s flag kernel)."""
    from reluqp_tpu_torch.core.graphs import Program, WindowGraphs
    from reluqp_tpu_torch.ops.check_window import graph_kernels
    solver._window_graphs = cache = WindowGraphs()
    for _ in range(3):
        run()
    made = [v for _, v in cache._made.values()]
    progs = [p for v in made for p in (v if isinstance(v, tuple) else (v,))
             if isinstance(p, Program) and p.exec is not None]
    assert progs and progs[0].exec.bodies, f"{tag}: no device program"
    names = [s for s in graph_kernels(progs[0].exec.bodies[0])
             if s not in ("memcpy", "memset", "empty")]
    first = min(i for i, s in enumerate(names)
                if any(c in s for c in CHECK_KERNELS))
    after = names[first:]
    limit = 1 if kind == "C1" else 2
    assert "gl_flag_kernel" in after[-1] and len(after) - 1 <= limit and all(
        any(c in s for c in CHECK_KERNELS) for s in after[:-1]), (tag, names)
    assert any(c in names[first - 1] for c in CHUNK_KERNELS), (tag, names)
    log(f"phase 31 {tag}: a device program's WHILE body ends "
        f"{[_short(s) for s in names[first - 1:]]}")
    return names


def _short(name):
    for c in CHECK_KERNELS + CHUNK_KERNELS + ("gl_flag_kernel",):
        if c in name:
            return c
    return name[:40]


def widened(rec, nx, nc, B=None, seed=0, per_problem_a=False):
    """A recorded window (C1's, or C2's with ``B`` rows) with its operands
    and its state's vectors drawn anew at ``nx``, ``nc`` from a seed, in
    the solver's own shapes, its settings and scalars kept: past the size
    where C1's and C2's vectors fit a block's shared memory. C1 takes H and
    A (no residual operator); C2 a shared H and A, or with
    ``per_problem_a`` a (B, nc, nx) A."""
    import torch
    from reluqp_tpu_torch.ops.fused_step import pad_dim
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
        o.update(g=rnd(nx), M_res=None, g_row=None)
        s = dict(y=torch.zeros(dp, device=dev, dtype=dt),
                 x_prev=None if st.x_prev is None else rnd(nx),
                 lam_prev=None if st.lam_prev is None else rnd(nc))
    else:
        if per_problem_a:
            o["A"] = torch.stack([A + 0.01 * i for i in range(B)])
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


# phase 31's windows past a block's shared memory, fp64 with the
# certificates: C1 at nx = 7000 (its global variant, owed since PR 15) and
# C2 at nx = 3600, B = 2 (the global "tiles" variant; a shared operand and a
# per-problem A)
GLOBAL_C1 = (7000, 3500)
GLOBAL_C2 = (3600, 1800, 2)


def phase_check_kernels(card, parent=None):
    """Phase 31: kernels C1 and C2 (``csrc/check_window.cu``) against their
    plain versions on windows recorded from eager solves on the card, the
    captured windows' kernel nodes, and the kernels' and the plain check's
    times beside the bound, with each kernel's stage split (and, with
    ``parent``, the parent's C1 and C2 by turns on the same windows)."""
    import torch
    from reluqp_tpu_torch import BatchedReLU_QP, ReLU_QP
    from reluqp_tpu_torch.models.mpc import MPC, mpc_rollout_scan
    from reluqp_tpu_torch.utils.problems import canonical_qp, rand_qp
    t0 = time.perf_counter()
    q100 = rand_qp(100, 25, 25, seed=0, compute_sol=False)[:5]
    q400 = rand_qp(400, 100, 100, seed=0, compute_sol=False)[:5]
    q500 = rand_qp(500, 125, 125, seed=0, compute_sol=False)[:5]
    cq = canonical_qp()
    canon = (cq.H, cq.g, cq.A, cq.l, cq.u)
    prob = scenario_problem()
    mpc_qp = (prob.H, prob.g0, prob.A, prob.l0, prob.u0)
    f32, f64 = dict(precision="float32"), dict(precision="float64")
    ruiz = dict(eps_abs=1e-4, scaling=True)
    single = [
        ("canonical Dp=128 fp32", canon, dict(eps_abs=1e-4, **f32)),
        ("nx=100 Dp=256 fp32", q100, dict(ruiz, **f32)),
        ("nx=100 Dp=256 fp64", q100, dict(ruiz, **f64)),
        ("MPC QP Dp=640 fp32", mpc_qp, dict(eps_abs=1e-3, **f32)),
        ("nx=400 Dp=896 fp32", q400, dict(ruiz, **f32)),
        ("nx=500 Dp=1024 fp32", q500, dict(ruiz, **f32)),
        ("nx=100 alpha=1.6 fp32", q100, dict(ruiz, alpha=1.6, **f32)),
        ("nx=100 alpha=1.6 fp64", q100, dict(ruiz, alpha=1.6, **f64)),
        ("nx=100 certificates fp64", q100,
         dict(ruiz, check_infeasibility=True, **f64)),
        ("primal-infeasible fp64", PINF, dict(check_infeasibility=True,
                                               **f64)),
        ("dual-infeasible alpha=1.6 fp32", DINF,
         dict(check_infeasibility=True, alpha=1.6, **f32)),
        ("nx=100 phase A (high) fp32", q100,
         dict(ruiz, iter_precision="high", **f32)),
        ("nx=100 jump, stride 3 fp64", q100,
         dict(ruiz, rho_jump=True, adaptive_rho_interval=75, **f64)),
        ("nx=100 tail fp32", q100,
         dict(eps_abs=1e-9, max_iter=110, **f32)),
    ]
    h, g, a, l, u = shared_batch(REPACK_B)
    h1, g1, a1, l1, u1 = (np.asarray(v) for v in q100)
    batches = [
        (f"shared B={REPACK_B} Dp=128 fp32", (h, g, a, l, u), REPACK_KW),
        ("shared B=64 Dp=128 fp64 certificates", (h, g[:64], a, l[:64],
                                                   u[:64]),
         dict(REPACK_KW, precision="float64", check_infeasibility=True)),
        ("shared B=1 Dp=256 fp64 jump, stride 2", (h1, g1[None], a1,
                                                    l1[None], u1[None]),
         dict(ruiz, rho_jump=True, adaptive_rho_interval=50, **f64)),
        ("shared B=64 Dp=640 (scenario) fp32", None, {}),
        ("shared B=64 alpha=1.6 phase A fp32", (h, g[:64], a, l[:64],
                                                u[:64]),
         dict(REPACK_KW, alpha=1.6, iter_precision="high")),
        ("per-problem B=64 fp32", (h, g[:64], a, l[:64], u[:64]),
         dict(REPACK_KW, rho_mode="per_problem")),
        ("per-problem B=64 alpha=1.6 fp64 certificates",
         (h, g[:64], a, l[:64], u[:64]),
         dict(REPACK_KW, rho_mode="per_problem", alpha=1.6,
              precision="float64", check_infeasibility=True)),
        (f"hetero B={HET_B} Dp=128 fp32", hetero_batch(HET_B),
         dict(HET_KW, bank_build="device")),
        ("hetero B=16 alpha=1.6 phase A fp64 certificates",
         hetero_batch(16), dict(HET_KW, alpha=1.6, iter_precision="high",
                                precision="float64",
                                check_infeasibility=True)),
        ("shared B=1 Dp=896 fp32", tuple(np.asarray(v)[None] if i in (1, 3, 4)
                                         else np.asarray(v)
                                         for i, v in enumerate(q400)),
         dict(ruiz, **f32)),
    ]
    recs, ties, errs, solvers = [], [], {}, {}
    for tag, data, kw in single:
        m = ReLU_QP()
        m.setup(*data, **kw)
        with eager_windows(m), record_checks() as r:
            m.solve()
        assert r.recs, tag
        recs += [(tag, x) for x in r.recs]
        solvers[tag] = m
    for tag, data, kw in batches:
        if data is None:
            m = scenario_solver(prob, SCEN_B)
            m.update(*scenario_vectors(prob, scenario_inputs(SCEN_B)[0]))
        else:
            m = BatchedReLU_QP()
            m.setup(*data, **kw)
        with eager_windows(m), record_checks() as r:
            m.solve()
        assert r.recs, tag
        recs += [(tag, x) for x in r.recs]
        solvers[tag] = m
    phases = {x[6] for _, x in recs}
    assert {"A", "tail"} <= phases, phases
    differ, abs_errs = 0, {}
    for tag, rec in recs:
        key = (rec[0], str(rec[4].dtype).split(".")[-1])
        e, n_bad, e_abs = check_compare(f"{tag} {rec[6] or 'window'}", rec,
                                        ties)
        errs[key] = max(errs.get(key, 0.0), e)
        abs_errs[key] = max(abs_errs.get(key, 0.0), e_abs)
        differ += n_bad
    assert any(r[3].alpha != 1.0 and r[0] == "C2" and r[3].shared
               for _, r in recs), "no shared alpha window"
    for tag, phase, why, diff in ties:
        log(f"phase 31 tie {tag} ({phase or 'window'}): decisions within "
            f"the tolerance of their threshold {why}; decided otherwise: "
            f"{diff or 'none'}")
    log(f"phase 31: {len(recs)} recorded windows held, kernel against plain "
        f"version (max residual error / scale {errs}); {len(ties)} windows "
        f"with ties, {differ} decisions taken otherwise (all at ties)")
    # the captured windows of each covered path
    nodes = {}

    def captured(tag, m, run, kind, chunk_kernel=True):
        from reluqp_tpu_torch.core.graphs import WindowGraphs
        m._window_graphs = WindowGraphs()
        m._window_graphs.device_exit = False
        run()
        run()
        nodes[tag] = window_nodes(tag, m, kind, chunk_kernel)

    cold = lambda m: (m.clear_primal_dual(), m.solve())
    captured("single QP, K1", solvers["nx=100 Dp=256 fp32"],
             lambda: cold(solvers["nx=100 Dp=256 fp32"]), "C1")
    mx = ReLU_QP()
    mx.setup(*q100, backend="xla", **dict(ruiz, **f32))
    captured("single QP, xla runner", mx, lambda: cold(mx), "C1", False)
    for tag in (f"shared B={REPACK_B} Dp=128 fp32", "per-problem B=64 fp32",
                f"hetero B={HET_B} Dp=128 fp32",
                "shared B=64 alpha=1.6 phase A fp32"):
        m = solvers[tag]
        captured(tag, m, lambda m=m: cold(m), "C2",
                 not tag.startswith("per-problem"))
    mr = BatchedReLU_QP()
    mr.setup(h, g, a, l, u, tail_policy="repack", **REPACK_KW)
    captured("repack", mr, lambda: cold(mr), "C2")
    ms = solvers["shared B=64 Dp=640 (scenario) fp32"]
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    X0, _ = scenario_inputs(SCEN_B)
    captured("scenario loop", ms, lambda: scenario_rollout_scan(
        ms, prob, X0, 4, kernel="loop"), "C2")
    Ad, Bd, Q, R, x0 = mpc_config()
    ctrl = MPC(Ad, Bd, Q, R, horizon=MPC_H, **MPC_KW)
    captured("loop MPC", ctrl.solver, lambda: mpc_rollout_scan(
        ctrl.solver, ctrl.prob, x0, 4, kernel="loop", check_interval=1),
        "C1")
    # a device program's WHILE body: the window, then the body counter
    body_nodes("device exit, single QP", solvers["nx=100 Dp=256 fp32"],
               lambda: cold(solvers["nx=100 Dp=256 fp32"]), "C1")
    for tag in (f"shared B={REPACK_B} Dp=128 fp32",
                f"hetero B={HET_B} Dp=128 fp32",
                "shared B=64 alpha=1.6 phase A fp32"):
        m = solvers[tag]
        body_nodes(f"device exit, {tag}", m, lambda m=m: cold(m), "C2")
    # times per covered shape: the first recorded window of each
    timing = {}
    for tag in [t for t, _, _ in single] + [t for t, _, _ in batches]:
        rec = next(x for t, x in recs if t == tag and x[6] != "tail")
        timing[tag] = check_timing(tag, rec, card, parent)
    # the global variants past a block's shared memory: plan, agreement
    # with the plain check, times (C2's parent raises there: no A/B)
    from reluqp_tpu_torch.ops.check_window import (batched_check_plan,
                                                   check_window_plan)
    nx, nc = GLOBAL_C1
    base = next(x for t, x in recs
                if t == "nx=100 certificates fp64" and x[6] != "tail")
    wide = [(f"C1 global nx={nx} fp64 certificates", widened(base, nx, nc),
             parent)]
    nx, nc, B = GLOBAL_C2
    base = next(x for t, x in recs
                if t == "shared B=64 Dp=128 fp64 certificates"
                and x[6] != "tail")
    wide += [(f"C2 global nx={nx} B={B} fp64 certificates{extra}",
              widened(base, nx, nc, B=B, per_problem_a=bool(extra)), None)
             for extra in ("", ", per-problem A")]
    for tag, rec, par in wide:
        plan = (check_window_plan if rec[0] == "C1" else batched_check_plan)(
            *rec[1:])
        assert plan["variant"] == "global", (tag, plan)
        e, _, _ = check_compare(tag, rec, ties)
        timing[tag] = check_timing(tag, rec, card, par)
        log(f"phase 31 {tag}: plan {plan}; residual error / scale {e:.3e}")
    log(f"phase 31 OK: C1 and C2 agree with their plain versions on every "
        f"recorded window; {time.perf_counter() - t0:.1f} s")
    return dict(errs=errs, abs_errs=abs_errs, ties=ties, differ=differ,
                timing=timing, nodes=nodes)


# --------------------------------------------------------------------- #
# phases 25-28: the multi-device paths, one process per card over NCCL  #
# --------------------------------------------------------------------- #

# phase 25: rows per card of benchmarks/batched_qps.py's north-star batch
MESH_B = 10000
# phase 27: the reference protocol's largest rand_qp and
# examples/large_qp_tp.py's default (last: it must certify), fp32, eps 1e-4,
# Ruiz
TP_SIZES = (500, 400)
TP_KW = dict(eps_abs=1e-4, scaling=True, precision="float32")
TP_X_TOL = 1e-4
TP_REPS = 20
# the ranks' whole run, and how long one collective may wait on a rank
# still busy in rank 0's reference work
MESH_TIMEOUT_S = 900
MESH_COLLECTIVE_S = 300


class count_collectives:
    """Counts (in order) the collectives the package runs, by wrapping
    ``torch.distributed``'s functions for the span of a ``with``: a
    collective captured in a check window's graph counts once per replay
    (``core.graphs.on_launch``)."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor")

    def __enter__(self):
        import torch.distributed as dist
        from reluqp_tpu_torch.core.graphs import on_launch
        self.dist, self.calls, self.orig = dist, [], {}
        for name in self.NAMES:
            fn = self.orig[name] = getattr(dist, name)

            def wrapped(*a, _fn=fn, _name=name, **kw):
                t = a[0] if _name == "all_reduce" else a[1]
                # once per replay where a check window's graph captured it
                on_launch(lambda n=(_name, int(t.numel())):
                          self.calls.append(n))
                return _fn(*a, **kw)
            setattr(dist, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dist, name, fn)

    def count(self, kind):
        return sum(1 for n, _ in self.calls
                   if (n == "all_reduce") == (kind == "reduce"))


def allreduce_us(group, graphed, n=200):
    """One all-reduce of the window's two numbers, in µs, over ``n`` back
    to back with no host read between them (so the ranks' host skew
    enters once, not per call): eager launches, or one CUDA graph of
    ``n`` captured all-reduces, CUDA events, after a barrier."""
    import torch
    import torch.distributed as dist
    red = torch.zeros(2, device="cuda")

    def run():
        for _ in range(n):
            dist.all_reduce(red, group=group)

    run()
    fn = run
    if graphed:
        graph, cur = torch.cuda.CUDAGraph(), torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            graph.capture_begin()
            run()
            graph.capture_end()
        cur.wait_stream(side)
        fn = graph.replay
        fn()
    torch.cuda.synchronize()
    dist.barrier(group=group)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) * 1e3 / n


def _same_across_ranks(t, group, what):
    """Assert every rank holds ``t``: one all-gather, outside the timed
    runs."""
    from reluqp_tpu_torch.parallel import gather_rows
    allr = gather_rows(t[None].contiguous(), group)
    assert bool((allr == t[None]).all()), f"{what} differs across ranks"


def _recording(runner, rungs):
    """``runner`` that keeps each window's rung (a device scalar: no sync),
    once per replay where a window's graph captured it."""
    import torch
    from reluqp_tpu_torch.core.graphs import on_launch

    def run(W, b, rho, lo, hi, y, n, prec="highest"):
        t = rho.reshape(()).to(torch.int32).clone()
        on_launch(lambda: rungs.append(t.clone()))
        return runner(W, b, rho, lo, hi, y, n, prec)
    return run


def mesh_phase_shared(rank, world, mesh, outdir):
    """Phase 25 on one rank: this card's MESH_B rows of the shared batch of
    MESH_B x world (K4, the exit all-reduced): the collectives and syncs
    per window, every window's rung the same on every rank, and the solve's
    CUDA-event time beside the same rows solved unsharded on this card."""
    import torch
    import reluqp_tpu_torch.batch as tbatch
    from reluqp_tpu_torch import BatchedReLU_QP
    from reluqp_tpu_torch.utils.timing import time_fn_events
    H, G, A, L, U = shared_batch(MESH_B * world)
    m = BatchedReLU_QP()
    m.setup(H, G, A, L, U, mesh=mesh, **REPACK_KW)
    assert m.B_local == MESH_B and m.B_n == MESH_B * world and m._use_pallas
    assert m.settings.device.type != "cuda" or m.settings.device.index == rank
    runner, rungs = tbatch.pallas_batched_chunk_runner, []
    tbatch.pallas_batched_chunk_runner = _recording(runner, rungs)
    try:
        with count_collectives() as cc:
            res, counts = _counted(lambda: repack_solve(m), "K4",
                                   checks=False)
    finally:
        tbatch.pallas_batched_chunk_runner = runner
    assert all(n == 0 for k, n in counts.items() if k != "K4"), counts
    windows = len(rungs)
    _same_across_ranks(torch.stack(rungs), m._group, "a window's rung")
    # the results' one gather, after the loop (none in a group of one)
    red, gat = cc.count("reduce"), cc.count("gather")
    assert red == 2 * windows and gat == (world > 1), (red, gat, windows)
    assert world == 1 or cc.calls[-1][0] != "all_reduce"
    syncs = sync_sites(f"phase 25 rank {rank} mesh",
                       lambda: repack_solve(m), windows) / windows
    one = BatchedReLU_QP()
    rows = slice(rank * MESH_B, (rank + 1) * MESH_B)
    one.setup(H, G[rows], A, L[rows], U[rows], **REPACK_KW)
    r_one = repack_solve(one)
    w_one = r_one.info.n_iter_total // one.settings.check_interval
    # the mesh walks its windows from the host: held against the same rows
    # unsharded, walked so too
    with per_window(one):
        syncs_one = sync_sites(f"phase 25 rank {rank} unsharded",
                               lambda: repack_solve(one), w_one) / w_one
    assert syncs <= syncs_one, (syncs, syncs_one)
    # the mesh window, all-reduces included, runs as graph replays; the A/B
    # against every window eager, by turns, on both solvers
    assert m._window_graphs.replays > 0, "the mesh windows were not graphed"
    t_mesh, t_one = {}, {}
    for mode in ("eager", "graphed", "graphed", "eager"):
        with in_mode(m, mode), in_mode(one, mode):
            t_mesh.setdefault(mode, []).append(time_fn_events(
                repack_solve, m, reps=REPACK_REPS)["best"])
            t_one.setdefault(mode, []).append(time_fn_events(
                repack_solve, one, reps=REPACK_REPS)["best"])
    with eager_windows(m):
        r_e = repack_solve(m)
    r_g = repack_solve(m)
    assert np.array_equal(r_e.x.cpu().numpy(), r_g.x.cpu().numpy()) and (
        r_e.info.iter == r_g.info.iter).all() and (
        r_e.info.rho_ind == r_g.info.rho_ind).all(), \
        "the graphed mesh solve differs from the eager one"
    split, split_one = {}, {}
    for mode in ("eager", "graphed"):
        with in_mode(m, mode), in_mode(one, mode):
            split[mode] = device_split(lambda: repack_solve(m), REPACK_REPS)
            split_one[mode] = device_split(lambda: repack_solve(one),
                                           REPACK_REPS)
    ar = {mode: allreduce_us(m._group, mode == "graphed")
          for mode in ("eager", "graphed")}
    log(f"phase 25 rank {rank}: a 2-number all-reduce alone, 200 back to "
        f"back: eager {ar['eager']:.2f} us, in one CUDA graph "
        f"{ar['graphed']:.2f} us each")
    for mode in ("eager", "graphed"):
        s, s1 = split[mode], split_one[mode]
        log(f"phase 25 rank {rank} {mode} windows, profile per solve (ms): "
            f"mesh wall {s['wall']:.3f}, device {s['device']:.3f} of which "
            f"NCCL {s['nccl']:.3f}; unsharded wall {s1['wall']:.3f}, device "
            f"{s1['device']:.3f}; solve by CUDA events (least of "
            f"{REPACK_REPS}, by turns) mesh "
            + " / ".join(f"{t * 1e3:.3f}" for t in t_mesh[mode])
            + " ms, unsharded "
            + " / ".join(f"{t * 1e3:.3f}" for t in t_one[mode]) + " ms")
    log(f"phase 25 rank {rank}/{world}: {MESH_B} of {m.B_n} rows, "
        f"{windows} windows, per window {red / windows:.2f} all-reduces, "
        f"{syncs:.2f} syncs (unsharded {syncs_one:.2f}); {gat} all-gather "
        f"after the loop; graphed solve {min(t_mesh['graphed']) * 1e3:.3f} ms "
        f"(CUDA events, least of {REPACK_REPS}); these rows unsharded "
        f"{min(t_one['graphed']) * 1e3:.3f} ms; K4 launches {counts['K4']}")
    if rank == 0:
        np.savez(os.path.join(outdir, "shared.npz"),
                 x=res.x.cpu().numpy(), iter=res.info.iter,
                 status=res.info.status_code, rho_ind=res.info.rho_ind)
    return dict(K4=counts["K4"], windows=windows, reduces=red, gathers=gat,
                syncs=syncs, syncs_one=syncs_one, t_mesh=t_mesh,
                t_one=t_one, split=split, split_one=split_one, allreduce=ar)


def mesh_phase_hetero(rank, world, mesh, outdir):
    """Phase 26 on one rank: its rows of the --hetero B=1024 batch handed
    to it alone (``process_local=True``, ``bank_build="device"``) through
    K5; ``objective()``, ``update(g)`` and a warm re-solve; a shard-file
    checkpoint restored onto the same layout and re-solved bit-equal."""
    import torch
    from reluqp_tpu_torch import BatchedReLU_QP
    from reluqp_tpu_torch.utils.checkpoint import (load_batched_solver,
                                                   save_batched_solver)
    per = HET_B // world
    local = tuple(a[rank * per:(rank + 1) * per] for a in hetero_batch(HET_B))

    def run():
        m = BatchedReLU_QP()
        m.setup(*local, mesh=mesh, process_local=True, bank_build="device",
                **HET_KW)
        return m, m.solve()

    (m, res), counts = _counted(run, "K5", checks=False)
    assert all(n == 0 for k, n in counts.items() if k != "K5"), counts
    assert m.B_n == HET_B and m.B_local == per and m._hetero_pallas
    assert res.info.status.shape == (HET_B,)
    obj = m.objective()
    assert obj.shape == (HET_B,) and np.all(np.isfinite(obj))
    m.update(g=local[1] * 1.05)
    r2, c2 = _counted(m.solve, "K5", checks=False)
    assert r2.info.status.all()
    prefix = os.path.join(outdir, "het_ckpt")
    save_batched_solver(m, prefix)
    m4 = load_batched_solver(prefix, mesh=mesh)
    assert m4.B_n == HET_B and m4.settings.device == m.settings.device
    r4, c4 = _counted(m4.solve, "K5", checks=False)
    r5 = m.solve()
    assert torch.equal(r4.x, r5.x) and (r4.info.iter == r5.info.iter).all()
    n_k5 = counts["K5"] + c2["K5"] + c4["K5"]
    log(f"phase 26 rank {rank}/{world}: {per} of {HET_B} problems built "
        f"on the card ({m.info.setup_time:.3f} s setup), "
        f"{int(res.info.status.sum())}/{HET_B} solved in "
        f"{res.info.n_iter_total} iterations; objective finite; update(g) + "
        f"warm re-solve all solved; shard checkpoint restored on this layout "
        f"and re-solved bit-equal; K5 launches {n_k5}")
    if rank == 0:
        np.savez(os.path.join(outdir, "hetero.npz"),
                 x=res.x.cpu().numpy(), iter=res.info.iter,
                 status=res.info.status_code, x5=r5.x.cpu().numpy(),
                 iter5=r5.info.iter, status5=r5.info.status_code)
    return dict(K5=n_k5, setup_s=m.info.setup_time)


def mesh_phase_tp(rank, world, tp_mesh):
    """Phase 27 on one rank: the tensor-parallel single QP at nx in
    TP_SIZES: this rank's (18, Dp, Dp/W) block, one all-gather of y per
    iteration, the rungs the same on every rank, time per iteration; rank
    0 holds it against the single-card ``backend="xla"`` solve and times
    K1's 25-step window on the same QP."""
    import torch
    from reluqp_tpu_torch import ReLU_QP
    from reluqp_tpu_torch.ops.fused_step import pallas_chunk_runner
    from reluqp_tpu_torch.parallel.sharded import gather_into
    from reluqp_tpu_torch.utils.problems import rand_qp
    from reluqp_tpu_torch.utils.timing import time_fn_events
    out = {}
    for nx in TP_SIZES:
        inst = rand_qp(nx=nx, n_eq=nx // 4, n_ineq=nx // 4, seed=0,
                       compute_sol=False)
        qp = (inst.H, inst.g, inst.A, inst.l, inst.u)
        m = ReLU_QP()
        m.setup(*qp, mesh=tp_mesh, **TP_KW)
        n_rho, dp = len(m.rhos_np), m.Dp
        assert tuple(m.bank.W.shape) == (n_rho, dp, dp // world)
        runner, rungs = m._chunk_runner, []
        m._chunk_runner = _recording(runner, rungs)
        with count_collectives() as cc:
            r = m.solve()
        m._chunk_runner = runner
        it = r.info.iter
        assert cc.count("gather") == it and cc.count("reduce") == 0
        assert all(n == dp // world for _, n in cc.calls), cc.calls[:3]
        _same_across_ranks(torch.stack(rungs), m._tp_group, "a window's rung")
        _same_across_ranks(r.x, m._tp_group, "x")
        rho = torch.tensor(m.rho_ind, dtype=torch.int32, device=m.y.device)
        lo, hi, b = m.qp_dev.lo, m.qp_dev.hi, m.bank.b
        tp_ms = time_fn_events(
            lambda: runner(m.bank.W, b, rho, lo, hi, m.y, N_STEPS),
            reps=TP_REPS)["best"] * 1e3
        # where a TP iteration's time goes: the block's product alone, and
        # the gather alone, 25 of each
        w_blk, y = m.bank.W[m.rho_ind], m.y
        part = torch.empty((dp // world,), dtype=y.dtype, device=y.device)
        full = torch.empty_like(y)

        def products():
            for _ in range(N_STEPS):
                y @ w_blk

        def gathers():
            for _ in range(N_STEPS):
                gather_into(full, part, m._tp_group)

        mm_ms = time_fn_events(products, reps=TP_REPS)["best"] * 1e3
        ga_ms = time_fn_events(gathers, reps=TP_REPS)["best"] * 1e3
        row = dict(dp=dp, iter=it, status=r.info.status, tp_ms=tp_ms,
                   mm_ms=mm_ms, gather_ms=ga_ms, block=list(m.bank.W.shape))
        if rank == 0:
            ref = ReLU_QP()
            ref.setup(*qp, backend="xla", **TP_KW)
            rr = ref.solve()
            dx = float((rr.x - r.x).abs().max())
            # a witness for where the plain fp32 solve stops: the same
            # solve with fp64 products
            ref64 = ReLU_QP()
            ref64.setup(*qp, backend="xla",
                        **dict(TP_KW, precision="float64"))
            r64 = ref64.solve()
            k1 = ReLU_QP()
            k1.setup(*qp, **TP_KW)
            rk = k1.solve()
            y = torch.zeros_like(k1.y)
            k1_ms = time_fn_events(
                lambda: pallas_chunk_runner(k1.bank.W, k1.bank.b, rho,
                                            k1.qp_dev.lo, k1.qp_dev.hi, y,
                                            N_STEPS), reps=TP_REPS)["best"] * 1e3
            row.update(ref_iter=rr.info.iter, ref_status=rr.info.status,
                       dx=dx, k1_ms=k1_ms, k1_dp=k1.Dp, k1_iter=rk.info.iter,
                       k1_status=rk.info.status, f64_iter=r64.info.iter,
                       f64_status=r64.info.status)
            log(f"phase 27 nx={nx} (D={m.D}, Dp={dp}) over {world} cards: "
                f"block {tuple(m.bank.W.shape)} per rank, {it} iterations "
                f"({r.info.status}, dual residual {r.info.dua_res:.2e}), "
                f"single-card K1 {rk.info.iter} ({rk.info.status}), "
                f"single-card xla {rr.info.iter} "
                f"({rr.info.status}, dual residual {rr.info.dua_res:.2e}), "
                f"single-card xla fp64 {r64.info.iter} ({r64.info.status}, "
                f"dual residual {r64.info.dua_res:.2e}), "
                f"|x|inf {dx:.2e}; {it} all-gathers of "
                f"{dp // world} numbers; per iteration {tp_ms / N_STEPS:.5f} "
                f"ms (25-step TP window {tp_ms:.5f} ms; 25 block products "
                f"alone {mm_ms:.5f} ms, 25 gathers alone {ga_ms:.5f} ms) "
                f"against K1's "
                f"{k1_ms / N_STEPS:.5f} ms (window {k1_ms:.5f} ms at "
                f"Dp={k1.Dp}), CUDA events, least of {TP_REPS}")
        out[nx] = row
        del m
    return out


def mesh_phase_scenario(rank, world, mesh, outdir):
    """Phase 28 on one rank: phase 14's scenario MPC (B=64, 200 steps)
    with the batch solver over the mesh, ``kernel="auto"`` (the loop path
    under a mesh): this rank's plants through K4, no K6; steps/s."""
    import torch
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    prob = scenario_problem()
    X0, noise = scenario_inputs(SCEN_B, SCEN_T)
    m = scenario_solver(prob, SCEN_B, mesh=mesh)
    assert m.B_local == SCEN_B // world and m._use_pallas

    def rollout():
        m.clear_primal_dual()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = scenario_rollout_scan(m, prob, X0, SCEN_T, kernel="auto",
                                    noise=noise, return_stats=True,
                                    return_state=True)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (out, secs), counts = _counted(rollout, "K4", checks=False)
    assert all(n == 0 for k, n in counts.items() if k != "K4"), counts
    (out2, secs2), _ = _counted(rollout, "K4", checks=False)
    assert torch.equal(out[0], out2[0])
    log(f"phase 28 rank {rank}/{world}: {m.B_local} of {SCEN_B} scenarios, "
        f"{SCEN_T} steps through K4 only ({counts['K4']} launches), "
        f"{SCEN_T / secs2:.1f} steps/s ({SCEN_B * SCEN_T / secs2:.0f} "
        f"scenario solves/s; first run {SCEN_T / secs:.1f} steps/s)")
    if rank == 0:
        np.savez(os.path.join(outdir, "scenario.npz"),
                 **{k: v.cpu().numpy() for k, v in zip(
                     ("xs", "us", "its", "status"), out[:4])})
    return dict(K4=counts["K4"], steps_s=SCEN_T / secs2)


def mesh_rank_main(argv):
    """One rank of phases 25-28: ``chip_smoke.py --mesh-rank RANK WORLD
    PORT OUTDIR`` (started by ``phase_mesh``). Writes its results to
    OUTDIR/rank<k>.json."""
    from datetime import timedelta
    import torch
    from reluqp_tpu_torch.parallel import init_distributed, make_mesh
    rank, world, port, outdir = (int(argv[0]), int(argv[1]), argv[2],
                                 argv[3])
    init_distributed(f"127.0.0.1:{port}", world, rank,
                     timeout=timedelta(seconds=MESH_COLLECTIVE_S))
    try:
        mesh = make_mesh(world)
        tp_mesh = make_mesh(world, axis_name="tp")
        out = {"25": mesh_phase_shared(rank, world, mesh, outdir),
               "26": mesh_phase_hetero(rank, world, mesh, outdir),
               "27": mesh_phase_tp(rank, world, tp_mesh),
               "28": mesh_phase_scenario(rank, world, mesh, outdir)}
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


def phase_mesh(card, scen_loop):
    """Phases 25-28: one process per visible card (NCCL), started once for
    the four phases; the parent's unsharded references first, on card 0:
    the dense solve of phase 25's MESH_B x W rows and the device-built
    solve of phase 19's batch. Then the ranks' results against them and
    against phase 14's rollout (bit-equal at one card); the hetero shard
    set merged into this process and re-solved."""
    import shutil
    import socket
    import tempfile
    import torch
    from reluqp_tpu_torch import BatchedReLU_QP
    from reluqp_tpu_torch.utils.checkpoint import load_batched_solver
    from reluqp_tpu_torch.core.graphs import WindowGraphs
    from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
    world = torch.cuda.device_count()
    # A process group's batched windows keep the plain check (its
    # all-reduces sit inside it), so the unsharded references that the
    # mesh is held to bit for bit run the plain check too (the A/B switch
    # WindowGraphs.check_kernels): C2 rounds the residual products
    # otherwise, and a decision at a tie would part them.
    ref = BatchedReLU_QP()
    ref.setup(*shared_batch(MESH_B * world), **REPACK_KW)
    ref._window_graphs.check_kernels = False
    r25 = repack_solve(ref)
    ref25 = dict(x=r25.x.cpu().numpy(), iter=r25.info.iter,
                 status=r25.info.status_code, rho_ind=r25.info.rho_ind)
    ref = BatchedReLU_QP()
    ref.setup(*hetero_batch(HET_B), bank_build="device", **HET_KW)
    ref._window_graphs.check_kernels = False
    r26 = ref.solve()
    ref26 = dict(x=r26.x.cpu().numpy(), iter=r26.info.iter,
                 status=r26.info.status_code)
    # phase 14's rollout with the plain check (phase 28's reference)
    m14, keep = scen_loop["m"], scen_loop["m"]._window_graphs
    m14._window_graphs = WindowGraphs()
    m14._window_graphs.check_kernels = False
    try:
        m14.clear_primal_dual()
        X0, noise = scenario_inputs(SCEN_B, SCEN_T)
        ref28 = scenario_rollout_scan(m14, scen_loop["prob"], X0, SCEN_T,
                                      kernel="loop", noise=noise,
                                      return_stats=True)
    finally:
        m14._window_graphs = keep
    same14 = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        ref28[:3], scen_loop["out"][:3]))
    log(f"phases 25-28 references: phase 14's rollout with the plain check "
        f"{'bit-equal to' if same14 else 'differs from'} the same rollout "
        f"through C2")
    del ref, r25, r26
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="reluqp_mesh_")
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-u", os.path.abspath(__file__), "--mesh-rank",
             str(r), str(world), str(port), tmp], stdout=logs[r],
            stderr=subprocess.STDOUT) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=max(1.0, MESH_TIMEOUT_S
                                   - (time.perf_counter() - t0)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                for line in f:
                    if r == 0 or "phase" in line or "Error" in line:
                        log(f"[rank {r}] {line.rstrip()}")
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        assert not bad, f"ranks {bad} of {world} failed (logs above)"
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        log(f"phases 25-28: {world} ranks over NCCL, "
            f"{time.perf_counter() - t0:.1f} s from spawn to exit")

        # phase 25: every row as the unsharded dense solve
        got = dict(np.load(os.path.join(tmp, "shared.npz")))
        for k in ("status", "iter", "rho_ind"):
            n = int(np.sum(got[k] != ref25[k]))
            assert n == 0, f"phase 25: {n} rows' {k} differ from unsharded"
        dx = float(np.max(np.abs(got["x"] - ref25["x"])))
        if world == 1:
            assert dx == 0.0, dx
        assert (got["status"] == 1).all()
        p25 = [r["25"] for r in ranks]
        log(f"phase 25 on {card} x{world}: B={MESH_B} per card, "
            f"{p25[0]['windows']} windows, per row status, iterations and "
            f"rung equal to the unsharded dense solve of the {MESH_B * world} "
            f"rows, |x|inf {dx:.2e}; per window {p25[0]['reduces'] / p25[0]['windows']:.2f} "
            f"all-reduces and {p25[0]['syncs']:.2f} syncs (unsharded "
            f"{p25[0]['syncs_one']:.2f}), {p25[0]['gathers']} all-gather per "
            "solve; the windows graphed (all-reduces captured), the same "
            "solve with eager windows bit-equal; a 2-number all-reduce "
            "alone (200 back to back, µs, eager / graphed, by rank): "
            + "; ".join(f"{p['allreduce']['eager']:.2f} / "
                        f"{p['allreduce']['graphed']:.2f}" for p in p25))
        for mode in ("eager", "graphed"):
            # each rank's least time (by turns), the slowest rank's
            t_mesh = max(min(p["t_mesh"][mode]) for p in p25)
            t_one = max(min(p["t_one"][mode]) for p in p25)
            log(f"phase 25 {mode} windows on {card} x{world}: solve "
                f"{t_mesh * 1e3:.3f} ms over {world} cards (slowest rank), "
                f"one card's {MESH_B} rows {t_one * 1e3:.3f} ms: "
                f"weak-scaling efficiency {t_one / t_mesh:.4f}; per rank, "
                f"profiler on, ms per solve (wall / device / NCCL; unsharded "
                f"wall / device): " + "; ".join(
                    f"{p['split'][mode]['wall']:.3f} / "
                    f"{p['split'][mode]['device']:.3f} / "
                    f"{p['split'][mode]['nccl']:.3f}; "
                    f"{p['split_one'][mode]['wall']:.3f} / "
                    f"{p['split_one'][mode]['device']:.3f}" for p in p25))
        log("phase 25 OK")

        # phase 26: against the unsharded device-built solve; the shard set
        # merged into this process
        got = dict(np.load(os.path.join(tmp, "hetero.npz")))
        assert (got["status"] == ref26["status"]).all()
        n_it = int(np.sum(got["iter"] != ref26["iter"]))
        dx = float(np.max(np.abs(got["x"] - ref26["x"])))
        if world == 1:
            assert n_it == 0 and dx == 0.0, (n_it, dx)
        assert dx < 5e-3, dx
        merged = load_batched_solver(os.path.join(tmp, "het_ckpt"))
        assert merged.B_n == HET_B and merged.mesh is None
        # held bit for bit against the ranks' plain-check solve
        merged._window_graphs.check_kernels = False
        rm, counts = _counted(merged.solve, "K5", checks=False)
        assert (rm.info.status_code == got["status5"]).all()
        dxm = float(np.max(np.abs(rm.x.cpu().numpy() - got["x5"])))
        if world == 1:
            assert dxm == 0.0 and (rm.info.iter == got["iter5"]).all()
        n_k5 = sum(r["26"]["K5"] for r in ranks) + counts["K5"]
        log(f"phase 26 on {card} x{world}: {HET_B} problems, status equal "
            f"to the unsharded device-built solve, {n_it} problems at "
            f"another iteration, |x|inf {dx:.2e}; setup "
            f"{max(r['26']['setup_s'] for r in ranks):.3f} s (slowest "
            f"rank); the shard set merged into one process and re-solved: "
            f"status equal, |x|inf {dxm:.2e}")
        log("phase 26 OK")

        # phase 27: rank 0 held it against the single-card solve
        for nx, row in ranks[0]["27"].items():
            assert row["dx"] < TP_X_TOL and row["block"][2] * world == row["dp"]
            # lockstep on one card (the same products) and wherever the
            # single-card solve certifies; across cards the column blocks
            # sum in another order, and where the single-card fp32 solve
            # stops at max_iter x is held to TP_X_TOL only (the fp64 solve
            # beside it in the log says where that solve should end)
            if world == 1 or row["ref_status"] == "solved":
                assert (row["iter"], row["status"]) == (
                    row["ref_iter"], row["ref_status"]), (nx, row)
        # examples/large_qp_tp.py's QP certifies
        assert ranks[0]["27"][str(TP_SIZES[-1])]["status"] == "solved"
        log(f"phase 27 on {card} x{world}: " + "; ".join(
            f"nx={nx}: {r['status']} in {r['iter']} iterations (one card's "
            f"xla {r['ref_status']} in {r['ref_iter']}, fp64 "
            f"{r['f64_status']} in {r['f64_iter']}), per iteration "
            f"{r['tp_ms'] / N_STEPS:.5f} ms vs K1 {r['k1_ms'] / N_STEPS:.5f} "
            f"ms" for nx, r in ranks[0]["27"].items()))
        log("phase 27 OK")

        # phase 28: phase 14's rollout, bit-equal on one card
        got = dict(np.load(os.path.join(tmp, "scenario.npz")))
        out = tuple(torch.from_numpy(got[k])
                    for k in ("xs", "us", "its", "status"))
        check_scenario(f"phase 28 (mesh of {world}, kernel=auto)", out,
                       scen_loop["ref"], SCEN_KW.get("max_iter", 4000))
        ref14 = ref28
        dx = float(np.max(np.abs(got["xs"] - ref14[0].cpu().numpy())))
        n_it = int(np.sum(got["its"] != ref14[2].numpy()))
        if world == 1:
            assert dx == 0.0 and n_it == 0, (dx, n_it)
        steps = min(r["28"]["steps_s"] for r in ranks)
        log(f"phase 28 on {card} x{world}: against phase 14 |x|inf {dx:.2e},"
            f" {n_it} steps at another iteration count; {steps:.1f} steps/s "
            f"({SCEN_B * steps:.0f} scenario solves/s, slowest rank)")
        log("phase 28 OK")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(K4_shared=sum(r["25"]["K4"] for r in ranks),
                K4_scenario=sum(r["28"]["K4"] for r in ranks), K5=n_k5,
                world=world)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import reluqp_tpu_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank_main(sys.argv[2:])
    parent = None
    if sys.argv[1:2] == ["--parent"]:
        parent = os.path.abspath(sys.argv[2])
        if not os.path.isdir(os.path.join(parent, "reluqp_tpu_torch")):
            raise SystemExit(f"--parent {parent}: no reluqp_tpu_torch there")

    card = card_line()
    phase_build(parent)
    errs = phase_kernel_check()
    timing = phase_timing(card, parent)
    launches = by_phase(phase_canonical)
    protocol = by_phase(phase_protocol)
    launches += protocol[0]
    mpc = by_phase(phase_mpc, card)
    launches += mpc["launches"]
    k2_errs = by_phase(phase_k2_check)
    scan = by_phase(phase_scan, card, mpc)
    k2 = by_phase(phase_scan_timing, card, scan, mpc["rate"], parent)
    k3_errs = by_phase(phase_k3_check)
    fused = by_phase(phase_fused_main, card, mpc, protocol)
    k3 = by_phase(phase_k3_timing, card, fused, mpc["rate"], k2["step_s"],
                  parent)
    k4_errs = by_phase(phase_k4_check)
    scen_loop = by_phase(phase_scenario_loop, card)
    k6_errs = by_phase(phase_k6_check)
    scen_scan = by_phase(phase_scenario_scan, card, scen_loop)
    scen = by_phase(phase_scenario_timing, card, scen_loop, scen_scan,
                    parent)
    k5_errs = by_phase(phase_k5_check)
    het = by_phase(phase_hetero_main, card)
    k5_rows = by_phase(phase_hetero_timing, card, het, parent)["rows"]
    dev_build = by_phase(phase_device_build, card)
    repack = by_phase(phase_repack, card, parent)
    ckpt = by_phase(phase_checkpoint, card, protocol, het, repack)
    nat = by_phase(phase_native, card)
    mesh = by_phase(phase_mesh, card, scen_loop)
    by_phase(phase_graphs, card, protocol, mpc, scen_loop, het, repack)
    by_phase(phase_device_exit, card, protocol, mpc, scen_loop, het, repack)
    chk = phase_check_kernels(card, parent)
    k5, k5_ltv = k5_rows[(K5_BIG_B, 128)], k5_rows[("ltv", "float32")]
    t = timing[640]
    k3_row = k3["rows"][100]
    k4, k4s, k6 = scen["k4"], repack["k4"], scen["k6"]
    k6_plan = k6["plan"]
    kernels = [{
        "name": f"K1 fused_chunk (Dp=640, R=1, 25 steps, fp32 highest; a "
                f"cluster of {t['plan']['cluster']} blocks, slab in "
                f"{t['plan']['slab']}; the 1-iteration window "
                f"{timing['one_step_ms']:.5f} ms in a CUDA graph)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/fused_step.cu",
        "replaces": "reluqp_tpu/ops/fused_step.py:121",
        "launches": launches + nat["launches"],
        "max_abs_err": max(errs[(640, "highest", r)] for r in (0, N_RHO - 1)),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
    }, {
        # per control step; no single PyTorch call computes a rollout
        "name": f"K2 full_rollout (100-state h10, Dp=640, fp32, per warm "
                f"control step at ci={k2['ci']}; a cooperative grid of "
                f"{k2['plan']['blocks']} blocks, operands "
                + ("in shared memory" if k2['plan']['resident'] else "from L2")
                + f", exchange {k2['plan']['exchange']} (grid barriers: "
                f"{k2['split']['this tree']['barriers_per_launch']:.0f} per "
                f"launch, {k2['split']['this tree']['barriers_per_warm_step']:.0f}"
                " per warm step))",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/solve_kernel.cu",
        "replaces": "reluqp_tpu/ops/solve_kernel.py:918",
        "launches": scan["launches"],
        "max_abs_err": k2_errs[(640, "float32")],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None,
    }, {
        # per cold solve; no single PyTorch call computes a whole solve
        "name": f"K3 full_solve (protocol nx=100, Dp={k3_row['dp']}, fp32, "
                f"one cold solve of {k3_row['iters']} iterations; plan: "
                f"{k3['plan']['blocks']} blocks, staging "
                f"{k3['plan']['staging']}, exchange {k3['plan']['exchange']}; "
                f"the fused rollout's warm solve {k3['warm_ms']:.5f} ms in a "
                f"CUDA graph)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/full_solve.cu",
        "replaces": "reluqp_tpu/ops/solve_kernel.py:336",
        "launches": fused["launches"] + ckpt["K3"],
        "max_abs_err": k3_errs[(256, "float32")],
        "ms": k3_row["ms"], "plain_ms": k3_row["plain_ms"],
        "bound_ms": k3_row["bound_ms"], "bound_by": k3_row["bound_by"],
        "library_ms": None,
    }, {
        "name": f"K4 fused_chunk_batched (scenario bank, B={SCEN_B}, Dp=640, "
                "25 steps, fp32 highest; cluster regime; launches: phases 14 "
                "and 28)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/fused_step_batched.cu",
        "replaces": "reluqp_tpu/ops/fused_step.py:232",
        "launches": scen_loop["launches"] + mesh["K4_scenario"],
        "max_abs_err": k4_errs[(torch.float32, 640, 64, "highest")],
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": k4["library_ms"],
    }, {
        "name": f"K4 fused_chunk_batched (shared batch, B={REPACK_B}, Dp=128, "
                f"25 steps, fp32 highest; {k4s['plan']['regime']} regime, "
                f"{k4s['plan']['blocks']} blocks of "
                f"{k4s['plan']['rows_per_tile']} rows; launches: phases 22, "
                "23 and 25)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/fused_step_batched.cu",
        "replaces": "reluqp_tpu/ops/fused_step.py:232",
        "launches": repack["launches"] + ckpt["K4"] + mesh["K4_shared"],
        "max_abs_err": k4_errs[(torch.float32, 128, REPACK_B, "highest")],
        "ms": k4s["ms"], "plain_ms": k4s["plain_ms"],
        "bound_ms": k4s["bound_ms"], "bound_by": k4s["bound_by"],
        "library_ms": k4s["library_ms"],
    }, {
        # per control step of the ensemble; no single PyTorch call computes
        # a rollout
        "name": f"K6 full_rollout_batched (scenario MPC, B={SCEN_B}, 100-state "
                f"h10, Dp=640, fp32, per warm control step at "
                f"ci={SCEN_KW['check_interval']}; {k6_plan['tiles']} clusters "
                f"of {k6_plan['cluster']} blocks, {k6_plan['rows_per_tile']}-row "
                f"tiles, slab in "
                + ("shared memory" if k6_plan["slab_in_smem"] else "L2") + ")",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/rollout_batched.cu",
        "replaces": "reluqp_tpu/ops/solve_kernel.py:1265",
        "launches": scen_scan["launches"],
        "max_abs_err": k6_errs[(640, 64, "float32")],
        "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": None,
    }, {
        "name": f"K5 fused_chunk_hetero (B={K5_BIG_B}, Dp=128, dense banks, "
                f"per-problem rungs, 25 steps, fp32 highest; clusters of "
                f"{k5['plan']['cluster']}, {k5['plan']['threads']} threads "
                f"per block; LTV windows B={LTV_B}: clusters of "
                f"{k5_ltv['plan']['cluster']}, {k5_ltv['dev_ms']:.5f} ms per "
                f"launch in a CUDA graph)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/fused_step_hetero.cu",
        "replaces": "reluqp_tpu/ops/fused_step.py:356",
        "launches": (het["launches"] + dev_build["launches"] + ckpt["K5"]
                     + mesh["K5"]),
        "max_abs_err": k5_errs[(torch.float32, 128, K5_BIG_B, "highest")],
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
    }]
    c1, c2 = (chk["timing"][tag] for tag in (
        CHECK_MAIN_C1, f"shared B={REPACK_B} Dp=128 fp32"))
    g1 = chk["timing"][f"C1 global nx={GLOBAL_C1[0]} fp64 certificates"]
    g2 = chk["timing"][f"C2 global nx={GLOBAL_C2[0]} B={GLOBAL_C2[2]} fp64 "
                       "certificates"]
    kernels += [{
        # per window; XLA's fused check has no single PyTorch call
        "name": f"C1 check_window ({CHECK_MAIN_C1}, y @ M_res, per window; "
                f"{len(chk['ties'])} recorded windows with ties, "
                f"{chk['differ']} decisions taken otherwise; the global "
                f"variant at nx={GLOBAL_C1[0]} fp64 with certificates "
                f"{g1['ms']:.5f} ms, bound {g1['bound_ms']:.5f} ms)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/check_window.cu",
        "replaces": "reluqp_tpu/core/iteration.py:455",
        "launches": CHECK_LAUNCHES["C1"],
        "max_abs_err": chk["abs_errs"][("C1", "float32")],
        "ms": c1["ms"], "plain_ms": c1["plain_ms"],
        "bound_ms": c1["bound_ms"], "bound_by": c1["bound_by"],
        "library_ms": None,
    }, {
        "name": f"C2 batched_check (shared batch, B={REPACK_B}, Dp=128, "
                f"fp32, per window, regime {c2['plan']['regime']}; the "
                f"'tiles' global variant at nx={GLOBAL_C2[0]}, "
                f"B={GLOBAL_C2[2]}, fp64 with certificates {g2['ms']:.5f} "
                f"ms, bound {g2['bound_ms']:.5f} ms)",
        "route": "cuda",
        "source": "reluqp_tpu_torch/csrc/check_window.cu",
        "replaces": "reluqp_tpu/core/batched.py:369",
        "launches": CHECK_LAUNCHES["C2"],
        "max_abs_err": chk["abs_errs"][("C2", "float32")],
        "ms": c2["ms"], "plain_ms": c2["plain_ms"],
        "bound_ms": c2["bound_ms"], "bound_by": c2["bound_by"],
        "library_ms": None,
    }]
    log(f"C1 and C2 launches on the main path by phase: {CHECK_BY_PHASE}")
    log("card:", card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
