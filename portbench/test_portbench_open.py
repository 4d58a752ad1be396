"""The harness's doors for cells that bring their own files: a traffic kind
from ``portbench/kinds/<kind>.py``, a kind's own roofline, and a cell on
several cards (rank 0 starts the others, which agree over a gloo group on
the host). Driven on the CPU with a toy kind that these tests write to a
temporary directory: a batch of tiny QPs a request through the port's
``BatchedReLU_QP``, judged by the reference's float64 solve.

``toy_checkout`` also writes a checkout with a toy cell on any number of
cards, for a run of ``python3 -m portbench.run`` on the cards themselves.

Run from the repository root: ``python -m pytest portbench -q``.
"""
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench import control, mixes, run, trace
from portbench.test_portbench_cpu import tiny

SEED = 2 ** 31 + 4242

TOY_KIND = '''"""A toy kind: per request one batch of tiny random QPs through
``BatchedReLU_QP`` (``update(g)``, ``clear_primal_dual``, ``solve``), under a
mesh where the launcher started several ranks, judged by the reference's
float64 solve. Its own traffic keys: ``batch`` (a rank's QPs a request),
``pool``, ``keep``, ``g_scale``, ``skew`` (added to each rank's answers),
``exit_after`` (``[rank, request]``: that rank exits at that request of
the window)."""
import os

import numpy as np
import torch

from ..reference import problems as P
from ..reference import qp


class Mix:
    def __init__(self, cfg, traffic, device):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)

    def build(self):
        from reluqp_tpu_torch import BatchedReLU_QP
        from reluqp_tpu_torch.parallel.sharded import (init_distributed,
                                                       make_mesh)
        mesh = (make_mesh(device=self.device.type) if init_distributed()
                else None)
        self.rank = int(os.environ.get("RANK", 0))
        n, m = self.cfg["nx"], self.cfg["nc"]
        B = int(self.traffic["batch"])
        rng = P.seed_words(self.cfg["problem_seed"])
        M = rng.randn(n, n)
        self.H = M @ M.T / n + np.eye(n)
        self.A = rng.randn(m, n)
        self.l, self.u = -np.ones((B, m)), np.ones((B, m))
        self.m = BatchedReLU_QP()
        self.m.setup(self.H, np.zeros((B, n)), self.A, self.l, self.u,
                     mesh=mesh, process_local=mesh is not None,
                     device=self.device, **self.cfg["settings"])

    def inputs(self, seed):
        self.seed = int(seed)
        t = self.traffic
        rng = P.seed_words(seed, self.rank)
        self.G = t["g_scale"] * rng.randn(int(t["pool"]), int(t["batch"]),
                                          self.cfg["nx"])
        self.reset()

    def reset(self):
        self.kept = {}
        self.keep_rng = P.seed_words(self.seed, self.rank, 1)
        self.counts = dict(requests=0, attempted=0, failed=0, solved=0,
                           iters=0, iter_qps=0)

    def request(self, i):
        t, c = self.traffic, self.counts
        if t.get("exit_after") == [self.rank, c["requests"]]:
            os._exit(7)
        j = i % len(self.G)
        self.m.update(g=self.G[j])
        self.m.clear_primal_dual()
        res = self.m.solve()
        x = self.m.local_rows(res.x) + t["skew"][self.rank]
        ok = self.m.local_rows(res.info.status) & np.isfinite(x).all(1)
        c["requests"] += 1
        c["attempted"] += len(x)
        c["failed"] += int((~ok).sum())
        c["solved"] = c["attempted"] - c["failed"]
        c["iters"] += int(self.m.local_rows(res.info.iter).sum())
        c["iter_qps"] += len(x)
        keep = int(t["keep"])
        slot = i if i < keep else int(self.keep_rng.randint(i + 1))
        if slot < keep:
            self.kept[slot] = (j, x)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def captures(self):
        wg = getattr(self.m, "_window_graphs", None)
        return int(getattr(wg, "captures", 0)) + int(getattr(wg, "programs",
                                                             0))

    def launches(self):
        return 0

    def finish(self):
        return dict(self.counts)

    def roofline(self, launches):
        return {"kernel": "toy", "bound_s": 1e-9 * self.counts["attempted"],
                "bound_kind": "operations", "ops": self.counts["attempted"]}

    def free(self):
        self.m = None
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()

    def judge(self):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64)
        gaps = [np.zeros(1)]
        for j, x in self.kept.values():
            x_ref = qp.solve_exact(t(self.H), t(self.G[j]), t(self.A),
                                   t(self.l), t(self.u))[0].numpy()
            gaps.append(np.abs(x - x_ref).ravel())
        return {"numbers": {"x_gap": float(np.max(np.concatenate(gaps)))},
                "judged": len(self.kept)}
'''

TOY_CONFIG = {"problem": "toy", "nx": 6, "nc": 4, "problem_seed": 7}
SETTINGS = {"cpu": {"eps_abs": 1e-7, "max_iter": 4000, "precision": "float64"},
            "cuda": {"eps_abs": 1e-4, "max_iter": 4000,
                     "precision": "float32"}}
TOY_TRAFFIC = {"kind": "toy", "batch": 8, "pool": 4, "keep": 2,
               "g_scale": 1.0, "warm": 2,
               "kernels": ["fused_step_batched", "graph_loop", "check_window"],
               "profile_kernels": ["k4_"], "roofline": "toy"}
LIMITS = {"x_gap": 0.05}
METRICS = [("qp_per_s", "QP/s", "higher"), ("request_ms_p95", "ms", "lower"),
           ("setup_s", "s", "lower"), ("iters_per_qp", "iter/QP", "lower")]


def toy_bench(workload: str, chips: int) -> dict:
    """A benchmark file of one toy cell: every metric end to end, so that
    an untraced run reads them all."""
    return {"command": ["python3", "-m", "portbench.run"],
            "paths": ["portbench"], "run_seconds": 10,
            "configs": [{"name": "toy", "source": "a test's toy",
                         "file": "portbench/configs/toy.json", "reduced": [],
                         "why": "a test's toy"}],
            "workloads": [{"name": workload, "config": "toy",
                           "traffic": workload, "chips": chips,
                           "why": "a test's toy"}],
            "end_to_end": [{"name": n, "unit": u, "better": b, "bound": 0.25,
                            "source": "host_clock"} for n, u, b in METRICS],
            "per_layer": [{"name": "iters_per_qp", "unit": "iter/QP",
                           "better": "lower", "source": "program_counter",
                           "layer": "toy", "moves": "qp_per_s"},
                          {"name": "device_idle_pct", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "toy", "moves": "qp_per_s"}]}


def toy_files(device: str, **traffic) -> tuple:
    return (dict(TOY_CONFIG, settings=SETTINGS[device]),
            dict(dict(TOY_TRAFFIC, skew=[0.0] * 8), **traffic), LIMITS)


def toy_checkout(dest, chips: int, device: str = "cuda", **traffic) -> str:
    """Write a checkout at ``dest``: a copy of the harness, the toy kind
    and one toy cell on ``chips`` cards; returns the cell's name. Run it
    from ``dest`` with the port on ``PYTHONPATH``."""
    dest = Path(dest)
    workload = f"toy.x{chips}"
    shutil.copytree(run.HERE, dest / "portbench", dirs_exist_ok=True,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "portbench" / "kinds" / "toy.py").write_text(TOY_KIND)
    cfg, tr, limits = toy_files(device, **traffic)
    for sub, name, data in (("configs", "toy", cfg), ("traffic", workload, tr),
                            ("limits", workload, limits)):
        (dest / "portbench" / sub / f"{name}.json").write_text(
            json.dumps(data))
    (dest / "BENCHMARK.json").write_text(json.dumps(toy_bench(workload,
                                                              chips)))
    return workload


@pytest.fixture
def toy_dir(tmp_path, monkeypatch):
    (tmp_path / "toy.py").write_text(TOY_KIND)
    monkeypatch.setattr(mixes, "KINDS_DIR", tmp_path)
    return tmp_path


def run_toy(trace_on=False, **traffic):
    cfg, tr, limits = toy_files("cpu", **traffic)
    cell = {"name": "toy.x1", "config": "toy", "traffic": "toy.x1",
            "chips": 1}
    return run.run_cell("toy.x1", SEED, 0.3, trace_on, "cpu",
                        toy_bench("toy.x1", 1), (cell, cfg, tr, limits),
                        log=lambda *a: None)


def test_make_finds_a_kind_from_a_file(toy_dir):
    cfg, tr, _ = toy_files("cpu")
    mix = mixes.make(cfg, tr, "cpu")
    assert type(mix).__name__ == "Mix"
    assert type(mix).__module__ == "portbench.kinds.toy"
    for kind in ("no_such_kind", "../toy"):
        with pytest.raises(ValueError):
            mixes.make(cfg, dict(tr, kind=kind), "cpu")


@pytest.mark.parametrize("workload,cls", [("mpc100_h10.scan", "Rollout"),
                                          ("mpc100_h10.scenario64",
                                           "Scenario")])
def test_make_keeps_the_two_kinds(workload, cls):
    _, cfg, traffic, _ = tiny(workload)
    assert type(mixes.make(cfg, traffic, "cpu")) is getattr(mixes, cls)


def test_kind_from_a_file_runs_correct(toy_dir):
    out = run_toy()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {n for n, _, _ in METRICS}
    assert out["checks"]["x_gap"]["value"] < 1e-4


def test_fault_in_a_kind_from_a_file_reads_incorrect(toy_dir, monkeypatch):
    from reluqp_tpu_torch import BatchedReLU_QP
    solve = BatchedReLU_QP.solve

    def altered(self):
        res = solve(self)
        res.x = res.x.clone()
        res.x[0, 0] += 1.0
        return res
    monkeypatch.setattr(BatchedReLU_QP, "solve", altered)
    out = run_toy()
    assert not out["correct"], out["checks"]


def test_control_reaches_a_kind_from_a_file(toy_dir):
    """``portbench.control`` runs a kind from a file from its configuration
    as it stands, and takes its ``Mix.control()`` readings where it has
    them."""
    cfg, tr, _ = toy_files("cpu")
    mix = mixes.make(cfg, tr, "cpu")
    mix.build()
    got = control.readings(mix, SEED, 0.3, True)
    assert got["numbers"]["x_gap"] < 1e-4 and got["requests"] > 0
    assert got["control_readings"] is None
    mix.control = lambda: {"numbers": {"x_gap": 1.0}}
    got = control.readings(mix, SEED + 1, 0.3, True)
    assert got["control_readings"] == {"numbers": {"x_gap": 1.0}}


class FakeSmi:
    """``trace.Smi`` on a machine with no ``nvidia-smi``: no readings."""

    def __init__(self, count=1):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def samples(self, t0, t1):
        return []


def _recs(monkeypatch) -> list:
    """The ``rec`` every metric reader of the next run is handed."""
    recs, read = [], run.read_metric

    def keep(name, rec):
        recs.append(rec)
        return read(name, rec)
    monkeypatch.setattr(run, "read_metric", keep)
    return recs


def test_a_kinds_roofline_lands_in_rec(toy_dir, monkeypatch):
    monkeypatch.setattr(trace, "Smi", FakeSmi)
    recs = _recs(monkeypatch)
    out = run_toy(trace_on=True)
    assert out["correct"], out["checks"]
    rec = recs[0]
    assert "k2" not in rec
    n = rec["counts"]["attempted"]
    assert rec["roofline"] == {"kernel": "toy", "bound_s": 1e-9 * n,
                               "bound_kind": "operations", "ops": n}


@pytest.mark.parametrize("trace_on", [False, True])
def test_scan_cell_keeps_its_result_and_rec(trace_on, monkeypatch):
    """The tiny scan cell's result and ``rec`` hold the keys they held
    before kinds could come from files."""
    monkeypatch.setattr(trace, "Smi", FakeSmi)
    recs = _recs(monkeypatch)
    out = run.run_cell("mpc100_h10.scan", SEED, 0.3, trace_on, "cpu",
                       run.load_json(run.ROOT / "BENCHMARK.json"),
                       tiny("mpc100_h10.scan"), log=lambda *a: None)
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics"] + (
        ["breakdown"] if trace_on else []) + ["device", "checks"]
    assert list(out["device"]) == ["memory_peak_bytes"] + (
        ["busy_s", "window_s"] if trace_on else [])
    assert set(recs[0]) == {"setup_s", "trace", "durations", "window_s",
                            "t_start", "t_end", "counts"} | (
        {"k2"} if trace_on else set())
    assert set(out["metrics"]) <= {
        "qp_per_s", "request_ms_p95", "setup_s", "iters_per_qp",
        "device_idle_pct", "k2_roofline", "mfu.scan"}


def test_merge_sums_counts_and_takes_the_worst_rank():
    part = lambda req, att, gap, peak, found: {
        "counts": {"requests": req, "attempted": att, "failed": 1,
                   "iters": 2.5},
        "numbers": {"x_gap": gap, "y_gap": 1.0}, "peak": peak,
        "found": found}
    counts, numbers, peaks, found = run.merge([
        part(10, 80, 1e-3, 100, []), part(11, 88, 2e-3, 300, ["jax"]),
        part(10, 80, float("nan"), 200, [])])
    assert counts == {"requests": 10, "attempted": 248, "failed": 3,
                      "iters": 7.5}
    assert numbers["x_gap"] != numbers["x_gap"] and numbers["y_gap"] == 1.0
    assert peaks == [100, 300, 200] and found == ["jax"]


def _rank0(dest, workload, seconds=0.5):
    """Rank 0 of the checkout's cell on the CPU, in a process of its own:
    ``(code, stdout, stderr, seconds)``."""
    env = dict(os.environ, PYTHONPATH=str(run.ROOT))
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-c", "import sys; from portbench import run; "
         "sys.exit(run.main(sys.argv[1:], device='cpu'))",
         "--workload", workload, "--seed", str(SEED), "--seconds",
         str(seconds), "--trace", "0"],
        cwd=dest, env=env, capture_output=True, text=True, timeout=240)
    return p.returncode, p.stdout, p.stderr, time.perf_counter() - t0


def test_two_ranks_put_one_result_together(tmp_path):
    skew = [0.0, 2e-3] + [0.0] * 6
    workload = toy_checkout(tmp_path, 2, "cpu", skew=skew)
    code, stdout, stderr, _ = _rank0(tmp_path, workload)
    assert code == 0, stderr[-4000:]
    out = json.loads(stdout.strip().splitlines()[-1])
    parts = [json.loads(m) for m in re.findall(r"^rank \d: (\{.*\})$",
                                               stderr, re.M)]
    assert len(parts) == 2 and parts[0]["device"] == parts[1]["device"]
    assert out["correct"], out["checks"]
    assert out["attempted"] == sum(p["counts"]["attempted"] for p in parts)
    assert parts[0]["counts"]["requests"] == parts[1]["counts"]["requests"]
    gap = out["checks"]["x_gap"]["value"]
    assert gap == max(p["numbers"]["x_gap"] for p in parts) >= 2e-3
    dev = out["device"]
    assert dev["count"] == 2 and len(dev["memory_peak_bytes_by_card"]) == 2
    assert dev["memory_peak_bytes"] == max(dev["memory_peak_bytes_by_card"])


def test_a_rank_that_exits_ends_the_run(tmp_path):
    workload = toy_checkout(tmp_path, 2, "cpu", exit_after=[1, 3])
    code, stdout, stderr, seconds = _rank0(tmp_path, workload, seconds=30)
    assert code != 0
    assert not any(line.startswith("{") for line in stdout.splitlines())
    assert seconds < 30, seconds   # the window alone would last 30 s
    pid = int(re.search(r"^rank 1: pid (\d+)$", stderr, re.M).group(1))
    assert not Path(f"/proc/{pid}").exists()
