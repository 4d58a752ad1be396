"""The benchmark's cells driven on the CPU at a tiny size with the port's
plain runners: set-up, requests and the judge; each fault a cell can have,
planted underneath the timed path, makes the run incorrect; the controls
(the program with its TF32 path switched on, the reference's TF32 solve
and plant step) read three times above the program; every name in
``BENCHMARK.json`` has its files.

Run from the repository root: ``python -m pytest portbench -q``.
"""
import importlib

import pytest

from portbench import control, mixes, run

# cell: (config, traffic, configuration's changes, traffic's changes); at
# this size an ensemble under loads of scale 1.0 holds fully saturated
# plants that never settle (PERF.md), so the tiny ensemble takes 0.8, and
# a pool of one draw makes the kept answer the same whichever request of
# the short window the reservoir keeps
TINY = {
    "mpc100_h10.scan": ("mpc100_h10", "scan", {"nx": 8, "nu": 3, "horizon": 4},
                        {"steps": 1200, "pool": 1}),
    "mpc100_h10.scenario64": ("mpc100_h10", "scenario64",
                              {"nx": 8, "nu": 3, "horizon": 4},
                              {"steps": 1200, "scenarios": 6, "pool": 1,
                               "load_scale": 0.8}),
}
TINY_JUDGE = {"settled_from": 1000, "steps_settled": 8, "steps_transient": 4,
              "plants_per_step": 6}
FAULTS = {
    "rollout": ("state_unchanged", "answer_altered", "solve_broken"),
    "scenario": ("state_unchanged", "answer_altered", "half_left_out",
                 "solve_broken"),
}
# the kernel each kind's timed path launches (its plain version here)
KERNEL = {"rollout": "full_rollout", "scenario": "full_rollout_batched"}
BENCH = run.load_json(run.ROOT / "BENCHMARK.json")


def tiny(workload):
    config, mix, c, t = TINY[workload]
    cfg, traffic, limits = run.data_files(config, mix, workload)
    cell = {"name": workload, "config": config, "traffic": mix, "chips": 1}
    judge = dict(traffic["judge"], **TINY_JUDGE)
    return (cell, dict(cfg, **c),
            dict(traffic, keep=1, warm=2, judge=judge, **t), limits)


def kind(workload):
    return tiny(workload)[2]["kind"]


def run_tiny(workload, seed=2 ** 31 + 12345):
    return run.run_cell(workload, seed, 0.3, False, "cpu", BENCH,
                        tiny(workload), log=lambda *a: None)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_cell_runs_correct_on_the_cpu(workload):
    out = run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    if workload in {w["name"] for w in BENCH["workloads"]}:
        assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert list(out)[-1] == "checks"


def _broken_rollout(fault, orig):
    def broken(*a, **k):
        xs, us, iters, status = orig(*a, **k)
        xs, us = xs.clone(), us.clone()
        if fault == "state_unchanged":
            xs[1:] = xs[:1]
        elif fault == "answer_altered":
            us[3] += 0.01
        else:
            h = xs.shape[1] // 2
            xs[1:, h:] = xs[:1, h:]
        return xs, us, iters, status
    return broken


def _scaled_bank(orig):
    """The kernel with its iteration's bank W scaled by 1.05: a solve
    whose fixed point is off."""
    def broken(Wt_bank, *a, **k):
        return orig(Wt_bank * 1.05, *a, **k)
    return broken


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in sorted(TINY)
    for f in FAULTS[kind(w)]])
def test_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    mpc = importlib.import_module("reluqp_tpu_torch.models.mpc")
    if fault == "solve_broken":
        name = KERNEL[kind(workload)]
        monkeypatch.setattr(mpc, name, _scaled_bank(getattr(mpc, name)))
    else:
        name = ("mpc_rollout_scan" if kind(workload) == "rollout"
                else "scenario_rollout_scan")
        monkeypatch.setattr(mpc, name,
                            _broken_rollout(fault, getattr(mpc, name)))
    out = run_tiny(workload)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_reads_above_the_program(workload):
    """The control of the solve (the program with its TF32 path switched
    on) reads the settled control gap, and the plant step's control (TF32
    operands) the plant gap, at three times the program's or more, on the
    same seed, with bounds active in the sample."""
    cell, cfg, traffic, limits = tiny(workload)
    got = {}
    for name, c in (("program", cfg),
                    ("control", control.control_config(cfg))):
        mix = mixes.make(c, traffic, "cpu")
        mix.build()
        got[name] = control.readings(mix, 2 ** 31 + 777, 0.3, True)
    prog = got["program"]["numbers"]
    assert got["program"]["active"] > 0
    assert got["control"]["numbers"]["u_gap"] >= 3 * prog["u_gap"], got
    assert got["program"]["plant_control"] >= 3 * prog["plant_gap"], got
    assert got["program"]["u_gap_reference"] >= 3 * prog["u_gap"], got


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_name_has_its_files(workload):
    cell, cfg, traffic, limits = run.cell_files(BENCH, workload)
    assert traffic["kind"] in mixes.KINDS
    assert limits
    for trace in (False, True):
        for m in run.metrics_of(BENCH, workload, trace):
            assert run.reader_path(m["name"]).is_file()
