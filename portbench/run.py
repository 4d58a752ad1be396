"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks for.
It finds the cell in ``BENCHMARK.json``, its configuration in
``portbench/configs/<config>.json``, its traffic mix in
``portbench/traffic/<traffic>.json``, its limits in
``portbench/limits/<cell>.json`` and each metric's reader in
``portbench/metrics/<metric>.py``. It builds only the kernels the mix
names (into the package's ``_build/`` inside the checkout: only a
checkout's first run compiles), sets the program up, draws the seed's
inputs, warms the cell's shapes, then serves requests in a closed loop
with one client for ``--seconds`` (the window runs on to the end of the
request under way), judges the kept answers against the plain reference
and prints one JSON line as the last line of its standard output. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read over a window traced by
``torch.profiler`` and sampled by ``nvidia-smi``.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; with JAX or the JAX package loaded after the
window, it exits with 3.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reluqp_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(bench: dict, workload: str) -> tuple:
    """``(cell, config, traffic, limits)`` of a workload by its name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    return (cell,) + data_files(cell["config"], cell["traffic"], workload)


def data_files(config: str, traffic: str, workload: str) -> tuple:
    """``(config, traffic, limits)`` by their names."""
    return (load_json(HERE / "configs" / f"{config}.json"),
            load_json(HERE / "traffic" / f"{traffic}.json"),
            load_json(HERE / "limits" / f"{workload}.json"))


def metrics_of(bench: dict, workload: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end without a trace, per-layer
    with one; an entry with ``workloads`` only where it lists the cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or workload in m["workloads"]]


def reader_path(name: str) -> Path:
    """``metrics/<name>.py``, or, for a metric split by cells
    (``<base>.<cells>``) that has no reader of its own, its base's."""
    path = HERE / "metrics" / f"{name}.py"
    return path if path.is_file() else HERE / "metrics" / \
        f"{name.split('.')[0]}.py"


def read_metric(name: str, rec: dict):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(rec)


def warm(mix, n_min: int, n_max: int = 12) -> int:
    """Serve requests until ``n_min`` have run and the last one captured
    no CUDA graph and built no device program; returns the count."""
    n = 0
    while True:
        before = mix.captures()
        mix.request(n)
        n += 1
        if n >= n_min and (mix.captures() == before or n >= n_max):
            return n


def window(mix, seconds: float) -> dict:
    """The closed loop: requests back to back from the start until the
    first one that ends at or after ``seconds``."""
    durations = []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    now = t_start
    while now < t_end:
        t0 = time.perf_counter()
        mix.request(i)
        now = time.perf_counter()
        durations.append(now - t0)
        i += 1
    return {"durations": durations, "window_s": now - t_start,
            "t_start": t_start, "t_end": now}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict | None = None,
             cell_data: tuple | None = None, log=print) -> dict:
    """Everything but the checks for a card and for JAX: returns the
    result object and the compared numbers with their limits."""
    import torch

    from . import mixes, roofline
    from .trace import Smi, device_summary

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits = cell_data or cell_files(bench, workload)
    on_card = torch.device(device).type == "cuda"
    build_s = 0.0
    if on_card:
        from reluqp_tpu_torch.ops.cuda_build import build_all
        t0 = time.perf_counter()
        built = build_all(traffic["kernels"])
        build_s = time.perf_counter() - t0
        log(f"kernels {sorted(built)} ready in {build_s:.3f} s "
            f"({sum(b['seconds'] > 0 for b in built.values())} built)")
        torch.cuda.reset_peak_memory_stats()
    mix = mixes.make(cfg, traffic, device)
    marks = [("start", T_START), ("kernels", time.perf_counter())]
    mix.build()
    marks.append(("program set-up", time.perf_counter()))
    mix.inputs(seed)
    marks.append(("inputs", time.perf_counter()))
    n_warm = warm(mix, int(traffic["warm"]))
    marks.append(("warm-up", time.perf_counter()))
    log("set-up by stage (s): " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
    k2 = None
    if trace and traffic.get("roofline") == "k2":
        k2 = {"costs": mix.k2_costs()}
    mix.reset()
    mix.sync()
    setup_s = time.perf_counter() - T_START
    caps0 = mix.captures()
    launches0 = mix.launches()
    rec = {"setup_s": setup_s, "trace": None}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        with Smi() as smi, profile(activities=[ProfilerActivity.CPU,
                                               ProfilerActivity.CUDA]) as prof:
            rec.update(window(mix, seconds))
        summary = device_summary(prof, traffic["profile_kernels"])
        summary["smi"] = smi.samples(rec["t_start"], rec["t_end"])
        rec["trace"] = summary
    else:
        rec.update(window(mix, seconds))
    caps = mix.captures() - caps0
    launches = mix.launches() - launches0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    rec["counts"] = mix.finish()
    if k2 is not None:
        per = launches / max(1, rec["counts"]["requests"])
        steps, costs = int(traffic["steps"]), k2["costs"]
        bounds = [roofline.k2_bound_s(costs, steps, it, per)
                  for it in mix.req_iters]
        k2["bound_s"] = sum(b[0] for b in bounds)
        k2["bound_kind"] = bounds[0][1]
        k2["ops"] = sum(steps * costs["ops_per_step"]
                        + it * costs["ops_per_iteration"]
                        for it in mix.req_iters)
        rec["k2"] = k2
    d = rec["durations"]
    third = max(1, len(d) // 3)
    log(f"request s: mean {sum(d) / len(d):.6f}, first third "
        f"{sum(d[:third]) / third:.6f}, last third "
        f"{sum(d[-third:]) / third:.6f}, max {max(d):.6f}")
    log(f"setup_s {setup_s:.3f}; warm-up {n_warm} requests; window "
        f"{rec['window_s']:.3f} s, {rec['counts']['requests']} requests, "
        f"counts {rec['counts']}; "
        f"kernel launches {launches}; graph captures and programs built in "
        f"the window {caps}")
    # the program's state goes before the reference runs (on the host)
    mix.free()
    t0 = time.perf_counter()
    verdict = mix.judge()
    log(f"judge ({time.perf_counter() - t0:.2f} s): " + ", ".join(
        f"{k} {v!r}" for k, v in verdict.items() if k != "numbers")
        + " (u_gap_transient is reported, not compared)")
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in verdict["numbers"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = read_metric(m["name"], rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    c = rec["counts"]
    out = {"correct": bool(correct), "attempted": c["attempted"],
           "failed": c["failed"], "metrics": metrics}
    if trace:
        tr = rec["trace"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
        if k2 is not None:
            log(f"K2 roofline: bound {k2['bound_s']:.6e} s by "
                f"{k2['bound_kind']} ({roofline.PEAKS_SOURCE}), K2 device "
                f"time {tr['path_s']:.6e} s")
        smi = tr["smi"]
        log(f"profiler: device busy {tr['busy_s']:.6f} s of "
            f"{rec['window_s']:.6f} s "
            f"({100.0 * tr['busy_s'] / rec['window_s']:.3f}%); path kernels "
            f"{tr['path_s']:.6f} s; nvidia-smi: {len(smi)} readings, mean "
            f"{sum(smi) / max(1, len(smi)):.3f}%")
    log(f"build_s {build_s:.3f}")
    device = {"memory_peak_bytes": peak}
    if trace:
        device.update(busy_s=rec["trace"]["busy_s"],
                      window_s=rec["window_s"])
    out["device"] = device
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell_data = cell_files(bench, args.workload)
    chips = int(cell_data[0]["chips"])
    # one host thread for the BLAS and OpenMP pools, set before numpy and
    # torch load: load from one process with few threads
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no result: the benchmark never runs on the CPU)",
              file=sys.stderr)
        return 2
    from .trace import card
    log = lambda *a: print(*a, file=sys.stderr, flush=True)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", bench, cell_data, log)
    found = sorted({name.split(".")[0] for name in list(sys.modules)}
                   & set(FORBIDDEN))
    if found:
        print(f"portbench: {found} loaded in the measuring process (no "
              "result)", file=sys.stderr)
        return 3
    checks = out.pop("checks")
    result = dict(out, device=dict(card(chips), **out["device"]))
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
