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

A cell on n > 1 cards runs one process a card. The process started as
above is rank 0: it starts ranks 1 to n-1 as fresh processes of ``python3
-m portbench.run`` (the same arguments and ``--rank``, ``--store``,
``--device``, which only rank 0 passes), each with the environment
``torchrun`` would give it, and prints the one result. The ranks agree
over a gloo group of the harness's own, on the host: the warm-up goes on
while any rank still captures, and rank 0's clock opens and closes the
window before each request. Its counts are summed over the ranks
(``requests`` is rank 0's), each compared number is the largest over the
ranks, the memory peak is the fullest card's; a traced run profiles rank
0's card and samples every card's utilisation.

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits with 2; with JAX or the JAX package loaded after the
window, in any rank, it exits with 3. A rank that ends before its result
is in, or that misses an agreement, ends the run with no result and a code
other than 0; no rank outlives rank 0.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from datetime import timedelta  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "reluqp_tpu")
# how long a rank waits for the others at the rendezvous and at every
# agreement before the run fails: under the 120 s in which a rank that
# hangs must end the run
TEAM_TIMEOUT = timedelta(seconds=100)


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


def forbidden_loaded() -> list:
    """The forbidden top-level modules this process holds."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def warm(mix, n_min: int, n_max: int = 12, team=None) -> int:
    """Serve requests until ``n_min`` have run and the last one captured
    no CUDA graph and built no device program (on every rank of a
    ``team``); returns the count."""
    n = 0
    while True:
        before = mix.captures()
        mix.request(n)
        n += 1
        done = n >= n_min and (mix.captures() == before or n >= n_max)
        if team is not None:
            done = team.all(done)
        if done:
            return n


def window(mix, seconds: float, team=None) -> dict:
    """The closed loop: requests back to back from the start until the
    first one that ends at or after ``seconds`` (by rank 0's clock, on
    every rank of a ``team``)."""
    durations = []
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    now = t_start
    while now < t_end if team is None else team.go(now < t_end):
        t0 = time.perf_counter()
        mix.request(i)
        now = time.perf_counter()
        durations.append(now - t0)
        i += 1
    return {"durations": durations, "window_s": now - t_start,
            "t_start": t_start, "t_end": now}


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", bench: dict | None = None,
             cell_data: tuple | None = None, log=print, team=None):
    """Everything but the checks for a card and for JAX: returns the
    result object and the compared numbers with their limits. On a rank
    of a ``team`` (a cell on several cards) it hands rank 0 its part
    instead, where rank 0 puts the result together; ranks 1… return
    None."""
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
    n_warm = warm(mix, int(traffic["warm"]), team=team)
    marks.append(("warm-up", time.perf_counter()))
    log("set-up by stage (s): " + ", ".join(
        f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
    k2 = None
    if trace and traffic.get("roofline") == "k2":
        k2 = {"costs": mix.k2_costs()}
    mix.reset()
    mix.sync()
    if team is not None:
        team.all(True)   # every rank has warmed up
    setup_s = time.perf_counter() - T_START
    caps0 = mix.captures()
    launches0 = mix.launches()
    rec = {"setup_s": setup_s, "trace": None}
    if trace:
        from torch.profiler import ProfilerActivity, profile
        with Smi(int(cell["chips"])) as smi, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            rec.update(window(mix, seconds, team))
        summary = device_summary(prof, traffic["profile_kernels"])
        summary["smi"] = smi.samples(rec["t_start"], rec["t_end"])
        rec["trace"] = summary
    else:
        rec.update(window(mix, seconds, team))
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
    elif trace and traffic.get("roofline"):
        rec["roofline"] = mix.roofline(launches)
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
        + (" (u_gap_transient is reported, not compared)"
           if "u_gap_transient" in verdict else ""))
    numbers = verdict["numbers"]
    if team is not None:
        card_id = None
        if on_card:
            i = torch.cuda.current_device()
            card_id = [i, getattr(torch.cuda.get_device_properties(i),
                                  "pci_bus_id", None)]
        parts = team.gather({
            "device": device, "card": card_id, "counts": rec["counts"],
            "numbers": numbers,
            "peak": peak, "found": forbidden_loaded(),
            "agreement_us": team.go_us()})
        if parts is None:
            return None
        for r, part in enumerate(parts):
            log(f"rank {r}: " + json.dumps(part))
        rec["counts"], numbers, peaks, found = merge(parts)
        peak = max(peaks)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
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
    if team is not None:
        device["memory_peak_bytes_by_card"] = peaks
        out["found"] = found
    if trace:
        device.update(busy_s=rec["trace"]["busy_s"],
                      window_s=rec["window_s"])
    out["device"] = device
    out["checks"] = checks
    return out


def merge(parts: list) -> tuple:
    """Rank 0's view of the ranks' parts (``run_cell``'s, in rank order):
    ``(counts, numbers, peaks, found)``: each count summed over the ranks
    but ``requests`` (rank 0's), each compared number the largest over the
    ranks (a NaN wins), each card's memory peak, and the forbidden modules
    any rank held."""
    counts = {k: sum(p["counts"][k] for p in parts)
              for k in parts[0]["counts"]}
    counts["requests"] = parts[0]["counts"]["requests"]
    numbers = {}
    for k in parts[0]["numbers"]:
        values = [p["numbers"][k] for p in parts]
        numbers[k] = next((v for v in values if v != v), max(values))
    return (counts, numbers, [p["peak"] for p in parts],
            sorted(set().union(*(p["found"] for p in parts))))


def _plain(value):
    """A NumPy scalar as the Python number JSON takes."""
    return value.item()


class Team:
    """The ranks of a cell on several cards, as the harness's agreements
    see them: a gloo group of its own over ``store`` (a ``TCPStore`` that
    rank 0 hosts), on the host and apart from the program's process
    group."""

    def __init__(self, rank: int, size: int, store):
        import torch
        import torch.distributed as dist
        self.rank, self.size, self.store = rank, size, store
        opts = dist.ProcessGroupGloo._Options()
        opts._devices = [dist.ProcessGroupGloo.create_device(
            hostname="127.0.0.1")]
        opts._timeout = TEAM_TIMEOUT
        self.pg = dist.ProcessGroupGloo(dist.PrefixStore("portbench", store),
                                        rank, size, opts)
        self.flag = torch.zeros(1, dtype=torch.int32)
        self.go_s, self.go_n = 0.0, 0

    def all(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        import torch.distributed as dist
        self.flag[0] = int(flag)
        opts = dist.AllreduceOptions()
        opts.reduceOp = dist.ReduceOp.MIN
        self.pg.allreduce([self.flag], opts).wait()
        return bool(self.flag[0])

    def go(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank: whether the next request of
        the window runs."""
        import torch.distributed as dist
        t0 = time.perf_counter()
        self.flag[0] = int(flag)
        self.pg.broadcast([self.flag], dist.BroadcastOptions()).wait()
        self.go_s += time.perf_counter() - t0
        self.go_n += 1
        return bool(self.flag[0])

    def go_us(self) -> float:
        """Mean µs of this rank's ``go`` calls."""
        return 1e6 * self.go_s / max(1, self.go_n)

    def gather(self, part: dict):
        """On rank 0 every rank's ``part``, in rank order, each as JSON
        gives it back; on ranks 1… hand rank 0 this rank's and return
        None."""
        if self.rank:
            self.store.set(f"part{self.rank}", json.dumps(part,
                                                          default=_plain))
            return None
        keys = [f"part{r}" for r in range(1, self.size)]
        self.store.wait(keys, TEAM_TIMEOUT)
        return [json.loads(json.dumps(part, default=_plain))] + \
            [json.loads(self.store.get(k)) for k in keys]


def _own_children() -> list:
    """The pids of this process's children, from ``/proc``."""
    me, kids = str(os.getpid()), []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
        except (OSError, IndexError):
            continue
        if ppid == me:
            kids.append(int(entry))
    return kids


class Ranks:
    """Rank 0's side of a cell on ``chips`` cards: ranks 1… started as
    fresh processes of this module, each in a session of its own (so that
    what a rank starts ends with it), with ``torchrun``'s environment, and
    watched: one that ends with a code other than 0 before ``join`` ends
    the run at once, with no result, taking every process of the cell with
    it."""

    def __init__(self, argv: list, chips: int, device: str, log):
        from torch.distributed import TCPStore
        self.log = log
        self.store = TCPStore("127.0.0.1", 0, chips, True,
                              timeout=TEAM_TIMEOUT, wait_for_workers=False)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                          WORLD_SIZE=str(chips), RANK="0", LOCAL_RANK="0")
        self.procs = []
        self.done = threading.Event()
        try:
            for r in range(1, chips):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "portbench.run", *argv, "--rank",
                     str(r), "--store", str(self.store.port), "--device",
                     device],
                    cwd=ROOT, env=dict(os.environ, RANK=str(r),
                                       LOCAL_RANK=str(r)),
                    stdin=subprocess.DEVNULL, stdout=sys.stderr,
                    start_new_session=True))
                log(f"rank {r}: pid {self.procs[-1].pid}")
        except BaseException:
            self.stop()
            raise
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self) -> None:
        while not self.done.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is not None and code != 0:
                    self.log(f"portbench: rank {r} ended with code {code} "
                             "(no result)")
                    self.stop()
                    for pid in _own_children():
                        try:
                            os.kill(pid, signal.SIGKILL)
                            os.waitpid(pid, 0)
                        except (ProcessLookupError, ChildProcessError):
                            pass
                    sys.stderr.flush()
                    os._exit(1)

    def join(self) -> None:
        """Wait for ranks 1… to end; raise unless each ended with 0."""
        self.done.set()
        deadline = time.monotonic() + TEAM_TIMEOUT.total_seconds()
        for r, p in enumerate(self.procs, 1):
            code = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            if code != 0:
                raise RuntimeError(f"rank {r} ended with code {code}")

    def stop(self) -> None:
        """End every rank and what it started; wait for each."""
        self.done.set()
        for p in self.procs:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()


def stderr_log(prefix: str = ""):
    """A ``log`` that writes each line whole, in one write, so that the
    lines of a cell's ranks, which share standard error, do not mix."""
    def log(*a):
        sys.stderr.write(prefix + " ".join(map(str, a)) + "\n")
        sys.stderr.flush()
    return log


def lead(args, bench: dict, cell_data: tuple, device: str, log) -> dict:
    """Rank 0 of a cell on several cards: start the others, run its own
    share, put the result together and see every rank end with 0."""
    chips = int(cell_data[0]["chips"])
    ranks = Ranks(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", repr(args.seconds), "--trace",
                   str(args.trace)], chips, device, log)
    try:
        team = Team(0, chips, ranks.store)
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda:0" if device == "cuda"
                       else "cpu", bench, cell_data, log, team)
        log(f"go/stop agreement: {team.go_n} calls, "
            f"{team.go_us():.3f} us each on rank 0")
        ranks.join()
    finally:
        ranks.stop()
    return out


def follow(args, bench: dict, cell_data: tuple, device: str, log) -> int:
    """Rank ``args.rank`` of a cell on several cards, started by rank 0:
    it runs its share on its own card and hands rank 0 its part."""
    if sys.platform.startswith("linux"):
        import ctypes
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    import torch
    from torch.distributed import TCPStore
    chips = int(cell_data[0]["chips"])
    if device == "cuda":
        torch.cuda.set_device(args.rank)
    store = TCPStore("127.0.0.1", args.store, chips, False,
                     timeout=TEAM_TIMEOUT)
    team = Team(args.rank, chips, store)
    run_cell(args.workload, args.seed, args.seconds, False,
             f"cuda:{args.rank}" if device == "cuda" else "cpu", bench,
             cell_data, log, team)
    return 0


def main(argv=None, device: str = "cuda") -> int:
    """The command line; ``device`` ``"cpu"`` runs rank 0 on the CPU (the
    tests' only)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # ranks 1… of a cell on several cards: given by rank 0 alone
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", type=int, help=argparse.SUPPRESS)
    p.add_argument("--device", choices=("cuda", "cpu"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if bool(args.rank) != (args.store is not None) \
            or bool(args.rank) != (args.device is not None):
        p.error("--rank, --store and --device come together, from rank 0")
    device = args.device or device
    bench = load_json(ROOT / "BENCHMARK.json")
    cell_data = cell_files(bench, args.workload)
    chips = int(cell_data[0]["chips"])
    # one host thread for the BLAS and OpenMP pools, set before numpy and
    # torch load: load from one process with few threads
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < chips):
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (no result: the benchmark never runs on the CPU)",
              file=sys.stderr)
        return 2
    if args.rank:
        return follow(args, bench, cell_data, device,
                      stderr_log(f"[rank {args.rank}] "))
    log = stderr_log()
    if chips == 1:
        out = run_cell(args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda:0" if device == "cuda"
                       else "cpu", bench, cell_data, log)
        found = forbidden_loaded()
    else:
        out = lead(args, bench, cell_data, device, log)
        found = sorted(set(forbidden_loaded()) | set(out.pop("found")))
    if found:
        print(f"portbench: {found} loaded in a process of the cell (no "
              "result)", file=sys.stderr)
        return 3
    from .trace import card
    checks = out.pop("checks")
    rec = card(chips) if device == "cuda" else \
        {"platform": "cpu", "kind": "cpu", "count": chips}
    result = dict(out, device=dict(rec, **out["device"]))
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
