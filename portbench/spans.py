"""The port's spans and its rollout kernels' stage stamps over one cell's
own traffic.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

from the root of a checkout on a machine with a card. It sets the cell up
as ``portbench.run`` does, serves its requests back to back for
``--seconds`` under ``torch.profiler`` and, once the window has closed,
replays one request's kernel launch with the stage stamps on. It logs on
standard error, and prints as one JSON object on the last line of its
standard output:

- ``span_ms``: each ``reluqp::`` span's host ms per request, with its
  count (``reluqp_tpu_torch.utils.timing.span``);
- ``idle_ms``: the card's idle ms per request between its first and last
  activity, split by the innermost span open over it, ``outside`` where
  none is (the harness's own work between calls);
- ``idle_gaps``: the longest gaps, named ``<span>/<host event>``;
- ``device_allocs``: the caching allocator's ``cudaMalloc`` calls
  (``num_device_alloc``) in the window;
- ``stage_split``: block 0's split of one request's launch
  (``ops.solve_kernel.k2_stage_split`` or ``k6_stage_split``), with
  ``iter_us`` (the iterations' µs a step) and ``fixed_us`` (the
  once-a-step stages' µs a step, plus the staging over the steps) beside
  the profiler's ``path_us`` (the cell's kernel, µs a step).

It judges nothing and prints no metric of ``BENCHMARK.json``: it is the
operator's look inside a request, not a benchmark run. A program without
spans or stamps gives ``null`` for them.
"""
from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import time

from .run import ROOT, cell_files, load_json, warm, window

SPAN = "reluqp::"
# block 0's stages of K2 and K6 (``ops.solve_kernel.K2_STAGES``): the
# iterations' products and their exchange of y; the stages each control
# step runs once
ITERATION = ("iteration", "exchange")
ONCE = ("refresh", "bias", "check", "reduced", "plant", "x exchange")


def _events(prof) -> tuple:
    """``(device, host, spans)`` of a profiler run, each a list of
    ``(start, end, name)`` in µs: the card's kernels, copies and sets (not
    the profiler's mirror of a host range on the card); the host's events
    other than the program's spans; the spans (``SPAN`` dropped from their
    names)."""
    from torch.autograd import DeviceType
    dev, host, spans = [], [], []
    for ev in prof.events():
        tr = ev.time_range
        item = (tr.start, tr.end, ev.name)
        if ev.device_type == DeviceType.CUDA:
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith(SPAN)):
                dev.append(item)
        elif ev.device_type == DeviceType.CPU:
            if ev.name.startswith(SPAN):
                spans.append((tr.start, tr.end, ev.name[len(SPAN):]))
            else:
                host.append(item)
    return dev, host, spans


def _innermost(spans: list) -> list:
    """The spans' union cut into ``(start, end, name)`` pieces, in order,
    each named by the innermost span open over it (the latest started)."""
    bounds = sorted({t for s, e, _ in spans for t in (s, e)})
    order = sorted(spans)
    pieces, active, i = [], [], 0
    for t0, t1 in zip(bounds, bounds[1:]):
        while i < len(order) and order[i][0] <= t0:
            active.append(order[i])
            i += 1
        active = [sp for sp in active if sp[1] > t0]
        if active:
            pieces.append((t0, t1, max(active,
                                       key=lambda sp: (sp[0], -sp[1]))[2]))
    return pieces


def _label(pieces: list, starts: list, t: float):
    """The innermost span open at ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and pieces[i][1] > t else None


def _split(gaps: list, pieces: list) -> dict:
    """Seconds of the ``gaps`` (sorted, apart) by the innermost span over
    them, ``outside`` where none is open."""
    out = {"outside": 0.0}
    j = 0
    for a, b in gaps:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < b:
            over = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if over > 0:
                name = pieces[k][2]
                out[name] = out.get(name, 0.0) + over * 1e-6
                covered += over
            k += 1
        out["outside"] += (b - a - covered) * 1e-6
    return out


def program_spans(prof, events: tuple = None) -> dict:
    """The program's spans over a profiler run (``events``: its
    ``_events``, where already made): ``span_s`` (each span's host seconds,
    summed), ``span_n`` (its count), ``idle_s`` (the card's idle seconds
    between its first and last activity, by the innermost span open over
    them; ``outside`` where none is open) and ``idle_total_s``. None where
    the run holds no ``reluqp::rollout`` span."""
    from .trace import _union
    dev, _, spans = events or _events(prof)
    if not any(name == "rollout" for _, _, name in spans):
        return None
    span_s, span_n = {}, {}
    for s, e, name in spans:
        span_s[name] = span_s.get(name, 0.0) + (e - s) * 1e-6
        span_n[name] = span_n.get(name, 0) + 1
    _, gaps = _union([(s, e) for s, e, _ in dev])
    return {"span_s": span_s, "span_n": span_n,
            "idle_s": _split(gaps, _innermost(spans)),
            "idle_total_s": sum(b - a for a, b in gaps) * 1e-6}


def idle_gaps(prof, top: int = 10, events: tuple = None) -> list:
    """The ``top`` longest idle gaps on the card as ``[label, seconds]``,
    each labelled ``<span>/<host event>`` by the program's innermost span
    and the host's shortest event over the gap's middle
    (``reluqp::rollout.read/aten::copy_``, ``outside/host idle``)."""
    from .trace import _union
    dev, host, spans = events or _events(prof)
    _, gaps = _union([(s, e) for s, e, _ in dev])
    pieces = _innermost(spans)
    starts = [p[0] for p in pieces]
    host = sorted(host)
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        best = None
        for s, e, name in host:
            if s > mid:
                break
            if e >= mid and (best is None or e - s < best[1] - best[0]):
                best = (s, e, name)
        inner = _label(pieces, starts, mid)
        where = SPAN + inner if inner else "outside"
        named.append([f"{where}/{best[2] if best else 'host idle'}",
                      (b - a) * 1e-6])
    return named


def kernel_call(mix) -> tuple:
    """The wrapper's name and the ``(args, kw)`` of request 0's one kernel
    launch (pool draw 0 with its load), from the solver's state as every
    request starts."""
    from reluqp_tpu_torch.models import mpc

    from .mixes import Scenario
    t = mix.traffic
    T = int(t["steps"])
    if isinstance(mix, Scenario):
        return "full_rollout_batched", mpc._scenario_scan_call(
            mix.m, mix.prob, mix.X0_dev[0], T, t["check_interval"],
            noise=mix.W_dev[0].expand(T, -1, -1))
    return "full_rollout", mpc._scan_call(
        mix.ctrl.solver, mix.ctrl.prob, mix.X0_dev[0], T,
        t["check_interval"], noise=mix.W_dev[0].expand(T, -1))


def stage_split(mix, reps: int = 20):
    """Block 0's stage split of request 0's launch, stamped and replayed
    alone, with ``iter_us`` and ``fixed_us`` per control step; None where
    the program has no such split."""
    from reluqp_tpu_torch.ops import solve_kernel
    wrapper, (args, kw) = kernel_call(mix)
    split = getattr(solve_kernel, {"full_rollout": "k2_stage_split",
                                   "full_rollout_batched":
                                   "k6_stage_split"}[wrapper], None)
    if split is None:
        return None
    fn = getattr(solve_kernel, wrapper)
    out = split(lambda: fn(*args, **kw), reps)
    out["iter_us"] = sum(out[k] for k in ITERATION)
    out["fixed_us"] = sum(out[k] for k in ONCE) + out["staged"] / out["steps"]
    return out


def measure(workload: str, seed: int, seconds: float,
            device: str = "cuda:0", log=print) -> dict:
    """The cell's set-up and a traced window, then the stamped launch;
    returns the printed object."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from reluqp_tpu_torch.ops.cuda_build import build_all

    from . import mixes
    from .trace import device_summary

    _, cfg, traffic, _ = cell_files(load_json(ROOT / "BENCHMARK.json"),
                                    workload)
    build_all(traffic["kernels"])
    mix = mixes.make(cfg, traffic, device)
    mix.build()
    mix.inputs(seed)
    warm(mix, int(traffic["warm"]))
    mix.reset()
    mix.sync()
    allocs = lambda: torch.cuda.memory_stats().get("num_device_alloc", 0)
    a0 = allocs()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rec = window(mix, seconds)
    n_alloc = allocs() - a0
    counts = mix.finish()
    n = counts["requests"]
    t0 = time.perf_counter()
    split = stage_split(mix)
    log(f"stage split in {time.perf_counter() - t0:.2f} s")
    mix.free()
    events = _events(prof)
    summary = device_summary(prof, traffic["profile_kernels"])
    sp = program_spans(prof, events)
    steps = int(traffic["steps"])
    out = {"workload": workload, "seed": seed, "requests": n,
           "window_s": rec["window_s"],
           "qp_per_s_traced": counts["solved"] / rec["window_s"],
           "busy_s": summary["busy_s"],
           "path_us": 1e6 * summary["path_s"] / (n * steps),
           "device_allocs": n_alloc, "span_ms": None, "idle_ms": None,
           "idle_total_ms": None, "idle_gaps": idle_gaps(prof, 10, events),
           "stage_split": split}
    if sp:
        out["span_ms"] = {k: [1e3 * v / n, sp["span_n"][k]]
                          for k, v in sorted(sp["span_s"].items())}
        out["idle_ms"] = {k: 1e3 * v / n
                          for k, v in sorted(sp["idle_s"].items())}
        out["idle_total_ms"] = 1e3 * sp["idle_total_s"] / n
    log(f"{workload}: {n} requests in {rec['window_s']:.6f} s; device busy "
        f"{summary['busy_s']:.6f} s; path kernels {out['path_us']:.3f} us "
        f"a step; device allocations in the window {n_alloc}")
    if sp:
        log("spans, host ms per request (count): " + ", ".join(
            f"{k} {v:.4f} ({c})" for k, (v, c) in out["span_ms"].items()))
        log(f"device idle {out['idle_total_ms']:.4f} ms per request, by "
            "the innermost span: " + ", ".join(
                f"{k} {v:.4f}" for k, v in out["idle_ms"].items()))
    else:
        log("spans: none in the trace")
    for name, s in out["idle_gaps"]:
        log(f"gap {1e3 * s:.4f} ms {name}")
    if split:
        log("stage split (block 0; us a step, staged and launch us a "
            "launch): " + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    print(json.dumps(measure(args.workload, args.seed, args.seconds,
                             log=log)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
