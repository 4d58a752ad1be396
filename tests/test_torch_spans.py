"""The port's spans (``reluqp_tpu_torch.utils.timing.span``) and
``portbench.spans``, which reads them over a cell's traffic.

Without a profiler a span is one shared no-op context; under one it is an
operator range, which the profiler does not mirror onto the card's
timeline. Under ``torch.profiler`` on the CPU, a scan rollout (K2's and
K6's plain versions) records one ``reluqp::rollout`` with each segment's
stage, launch, read and finish nested inside it. ``portbench.spans``
splits the card's idle time by the innermost span open over it, names
each long gap after it, builds one request's kernel launch for the stage
split and sums the split's stages. The card's side (the kernels on the
timeline, K6's stamps) runs in ``chip_smoke.py`` and
``tests/test_torch_cuda.py``.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import reluqp_tpu_torch as T
from portbench import mixes, run
from portbench import spans as pspans
from portbench.trace import _union
from reluqp_tpu_torch.models import mpc
from reluqp_tpu_torch.ops import solve_kernel
from reluqp_tpu_torch.utils.timing import span

STAGES = ("rollout.stage", "rollout.launch", "rollout.read",
          "rollout.finish")


def test_span_without_a_profiler_is_one_shared_no_op():
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = span("rollout"), span("rollout.read")
    assert a is b
    assert not isinstance(a, torch.profiler.record_function)
    with a:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        inside = span("rollout")
        with inside:
            pass
    assert inside is not a
    assert [e.name for e in prof.events()].count("reluqp::rollout") == 1


def test_span_is_no_user_annotation():
    # a record_function annotation is mirrored onto the card's timeline
    # (gpu_user_annotation), where the benchmark's device_summary would
    # count it as device work; the span is an operator range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("rollout"):
            pass
        with torch.profiler.record_function("reluqp::annotation"):
            pass
    kinds = {e.name: e.is_user_annotation for e in prof.events()}
    assert kinds == {"reluqp::rollout": False, "reluqp::annotation": True}


def _di():
    Ad, Bd = mpc.double_integrator(dt=0.1)
    return Ad, Bd, np.diag([10.0, 1.0]), np.array([[0.1]])


def _scan_rollout(ci):
    Ad, Bd, Q, R = _di()
    ctrl = mpc.MPC(Ad, Bd, Q, R, horizon=6, u_min=-1.0, u_max=1.0,
                   eps_abs=1e-5, precision="float64", device="cpu")
    return lambda: mpc.mpc_rollout_scan(
        ctrl.solver, ctrl.prob, np.array([1.0, 0.0]), 12, kernel="scan",
        check_interval=ci, calib_steps=4)


def _scenario_rollout(ci):
    Ad, Bd, Q, R = _di()
    K, Qf = mpc.ihlqr(Ad, Bd, Q, R)
    N, B = 6, 3
    rows = np.zeros((N, 3 * N))
    for k in range(N):
        rows[k, 3 * k] = 1.0
    prob = mpc.gen_condensed_mpc_qp(Ad, Bd, Q, R, Qf, N, rows,
                                    -np.ones(N), np.ones(N), K=K)
    m = T.BatchedReLU_QP()
    m.setup(prob.H, np.tile(prob.g0, (B, 1)), prob.A,
            np.tile(prob.l0, (B, 1)), np.tile(prob.u0, (B, 1)),
            eps_abs=1e-5, precision="float64", backend="xla", device="cpu")
    X0 = np.array([[1.0, 0.0]]) + 0.1 * np.random.RandomState(0).randn(B, 2)
    noise = 0.01 * np.random.RandomState(1).randn(12, B, 2)
    return lambda: mpc.scenario_rollout_scan(
        m, prob, X0, 12, noise=noise, kernel="scan", check_interval=ci,
        calib_steps=4)


@pytest.mark.parametrize("ci", [2, "auto"])
@pytest.mark.parametrize("path", ["mpc", "scenario"])
def test_scan_rollout_records_its_stages_inside_one_rollout(path, ci):
    call = (_scan_rollout if path == "mpc" else _scenario_rollout)(ci)
    call()      # the solver's set-up work and caches stay out of the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        states = call()[0]
    assert torch.isfinite(states).all()
    spans = {}
    for e in prof.events():
        if e.name.startswith(pspans.SPAN):
            spans.setdefault(e.name[len(pspans.SPAN):], []).append(
                (e.time_range.start, e.time_range.end))
    (r0, r1), = spans.pop("rollout")
    segments = 2 if ci == "auto" else 1
    assert sorted(spans) == sorted(STAGES)
    for name in STAGES:
        assert len(spans[name]) == segments, (name, spans[name])
        assert all(r0 <= s <= e <= r1 for s, e in spans[name])
    # each segment's stages run in order and apart
    order = sorted((s, e, name) for name in STAGES for s, e in spans[name])
    assert [n for _, _, n in order] == list(STAGES) * segments
    assert all(a[1] <= b[0] for a, b in zip(order, order[1:]))


def _prof(device, spans, host=(), annotations=()):
    """A stand-in profiler run: device intervals, program spans (names
    without the prefix), other host events and the profiler's mirror of
    host ranges on the card, all in µs."""
    ev = lambda s, e, name, kind, mirror=False: SimpleNamespace(
        time_range=SimpleNamespace(start=s, end=e), name=name,
        device_type=kind, is_user_annotation=mirror)
    events = [ev(s, e, "k2_kernel", DeviceType.CUDA) for s, e in device]
    events += [ev(s, e, pspans.SPAN + n, DeviceType.CPU)
               for s, e, n in spans]
    events += [ev(s, e, n, DeviceType.CPU) for s, e, n in host]
    events += [ev(s, e, pspans.SPAN + n, DeviceType.CUDA, True)
               for s, e, n in annotations]
    return SimpleNamespace(events=lambda: events)


# two requests: device work 0-100 and 140-240; rollout spans 95-235 (the
# second request's call) nested with its stage, launch, read and finish
REQUEST = [(95, 235, "rollout"), (96, 120, "rollout.stage"),
           (120, 138, "rollout.launch"), (138, 230, "rollout.read"),
           (230, 235, "rollout.finish")]


@pytest.mark.parametrize("device,spans", [
    ([(0, 100), (140, 240)], REQUEST),
    ([(0, 10), (20, 30), (50, 55), (56, 300)], REQUEST),
    ([(0, 100), (400, 500)], REQUEST + [(300, 380, "rollout"),
                                        (310, 320, "rollout.stage")]),
])
def test_idle_split_adds_up_to_the_idle_time(device, spans):
    # the profiler's mirror of the spans on the card is not device work
    out = pspans.program_spans(_prof(device, spans, annotations=spans))
    _, gaps = _union(device)
    total = sum(b - a for a, b in gaps) * 1e-6
    assert out["idle_total_s"] == pytest.approx(total)
    assert sum(out["idle_s"].values()) == pytest.approx(total, rel=1e-12)
    assert out["span_n"]["rollout"] == sum(n == "rollout"
                                           for *_, n in spans)


def test_idle_split_takes_the_innermost_span():
    out = pspans.program_spans(_prof([(0, 100), (140, 240)], REQUEST))
    idle = {k: round(v * 1e6, 9) for k, v in out["idle_s"].items()}
    # gap 100-140: launch's 120-138 inside the rollout from 95; stage
    # 100-120; read 138-140
    assert idle == {"outside": 0.0, "rollout.stage": 20.0,
                    "rollout.launch": 18.0, "rollout.read": 2.0}
    assert out["span_s"]["rollout"] == pytest.approx(140e-6)


def test_no_rollout_span_gives_nothing():
    assert pspans.program_spans(_prof([(0, 10), (20, 30)], [])) is None


def test_gap_labels_take_the_innermost_span_or_outside():
    device = [(0, 10), (30, 40), (100, 110), (200, 210)]
    spans = [(5, 105, "rollout"), (12, 28, "rollout.read")]
    host = [(60, 80, "aten::copy_")]
    gaps = pspans.idle_gaps(_prof(device, spans, host))
    names = dict((round(s * 1e6), n) for n, s in gaps)
    assert names == {20: "reluqp::rollout.read/host idle",
                     60: "reluqp::rollout/aten::copy_",
                     90: "outside/host idle"}


# a stage split: 1 µs a step in each once-a-step stage, 9.5 in the
# iterations, 40 µs of staging over 200 steps
SPLIT = dict(dict.fromkeys(("refresh", "bias", "check", "reduced", "plant",
                            "x exchange"), 1.0),
             iteration=7.0, exchange=2.5, staged=40.0, steps=200.0)
# each cell at a tiny size on the CPU, and its kernel's stage split
TINY = {"mpc100_h10.scan": ({"steps": 30, "pool": 1}, "k2_stage_split"),
        "mpc100_h10.scenario64": ({"steps": 30, "scenarios": 3, "pool": 1},
                                  "k6_stage_split")}


def _tiny_mix(workload):
    _, cfg, traffic, _ = run.cell_files(
        run.load_json(run.ROOT / "BENCHMARK.json"), workload)
    mix = mixes.make(dict(cfg, nx=8, nu=3, horizon=4),
                     dict(traffic, **TINY[workload][0]), "cpu")
    mix.build()
    mix.inputs(2 ** 31 + 7)
    return mix


@pytest.mark.parametrize("workload", sorted(TINY))
def test_kernel_call_is_request_zeros_launch(workload):
    mix = _tiny_mix(workload)
    name, (args, kw) = pspans.kernel_call(mix)
    xs, us = getattr(solve_kernel, name)(*args, **kw)[:2]
    want_xs, want_us = mix._run(0)[:2]
    # the kernel's outputs are padded: steps 1..T of x, and u, by plant
    cut = lambda a, b: a[(slice(None),) + tuple(slice(0, d)
                                                for d in b.shape[1:])]
    assert torch.equal(cut(xs, want_xs), want_xs[1:])
    assert torch.equal(cut(us, want_us), want_us)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_stage_split_sums_the_iterations_and_the_once_a_step_work(
        workload, monkeypatch):
    mix = _tiny_mix(workload)
    launched = []

    def split(run, reps):
        launched.append(run()[0].shape)
        return dict(SPLIT)

    monkeypatch.setattr(solve_kernel, TINY[workload][1], split,
                        raising=False)
    out = pspans.stage_split(mix)
    assert len(launched) == 1
    assert out["iter_us"] == pytest.approx(9.5)
    assert out["fixed_us"] == pytest.approx(6.2)
    # a program without the split gives nothing
    monkeypatch.delattr(solve_kernel, TINY[workload][1])
    assert pspans.stage_split(mix) is None
