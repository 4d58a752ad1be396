"""Readings that set a cell's limits: the program's over many seeds and the
control's.

    python3 -m portbench.control --workload <cell> --seeds 1 2 3 \
        --seconds 3 [--control]

For each seed, in one process that sets the program up once: the compared
numbers of a short window of the cell's own traffic, judged as
``portbench.run`` judges them. With ``--control`` the program runs as the
control of the solve: its own path one precision below the
configuration's float32 switched on (``CONTROL``: the iteration's
products in TF32 on the tensor cores, the residual checks in float32, no
two-phase refine), on the same traffic and judged by the same judge.
Beside it, the reference in the program's place in TF32, following the
program's own kept states as the judge does: ``u_gap_reference``, the
reference's solve (``reference.qp.solve``, every product with TF32
operands, at the configuration's tolerance and budget) at each judged
state, and ``plant_control``, the plant step with TF32 operands from each
kept state and control (the program's TF32 path leaves the plant step in
float32). Prints one JSON line per seed.

A kind from a file (``portbench/kinds/<kind>.py``, found as
``portbench.run`` finds it) runs from the configuration as it stands; its
line holds its judge's numbers, and with ``--control`` its ``Mix.control()``
readings, or ``null`` where the kind has none.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import mixes, run
from .reference import judge, qp
from .reference import problems as P

CONTROL = {"iter_precision": "high", "refine": False}


def control_config(cfg: dict) -> dict:
    """The configuration with the program's TF32 path switched on."""
    return dict(cfg, settings=dict(cfg.get("settings", {}), **CONTROL))


def to_tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, to nearest)."""
    b = a.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A float32 product of TF32-rounded operands."""
    return to_tf32(a) @ to_tf32(b)


def reference_control(mix) -> float:
    """``u_gap`` with the reference's TF32 solve in the program's place at
    every judged state of the kept requests."""
    cfg = mix.cfg
    s = cfg.get("settings", {})
    c = P.condense(mix.Ad, mix.Bd, mix.Q, mix.R, cfg["horizon"],
                   cfg["u_min"], cfg["u_max"], cfg["prestabilize"])
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=mix.device)
    H, A = t(c.H), t(c.A)
    op = qp.operator(H, A)

    def u_at(X):
        x = t(X)
        sh = tf32_mm(x, t(c.lu_x).T)
        v = qp.solve(H, t(c.g0) + tf32_mm(x, t(c.g_x).T), A, t(c.l0) + sh,
                     t(c.u0) + sh, eps=float(s["eps_abs"]),
                     max_iter=int(s["max_iter"]), mm=tf32_mm, op=op)[0]
        u = -tf32_mm(x, t(c.K).T) + v[:, :cfg["nu"]]
        return u.double().cpu().numpy()
    v = judge.rollouts(cfg, mix.traffic, mix.seed, mix.runs(), u_at)
    return v["numbers"]["u_gap"]


def plant_control(mix) -> float:
    """The plant gap with every kept step x+ = Ad x + Bd u + w computed
    from TF32 operands (float32 sums) on the card, from the program's own
    states and controls."""
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=mix.device)
    Ad, Bd = t(mix.Ad).T, t(mix.Bd).T
    runs = []
    for X0, W, xs, us, its in mix.runs():
        nxt = tf32_mm(t(xs[:-1]), Ad) + tf32_mm(t(us), Bd) + t(W)[None]
        runs.append((X0, W, np.concatenate([xs[:1], nxt.double().cpu()
                                            .numpy()]), us, its))
    return judge.plant_gap(mix.Ad, mix.Bd, runs)


def readings(mix, seed: int, seconds: float, control: bool = False) -> dict:
    """One seed's window on a built mix and its judge's numbers."""
    mix.inputs(seed)
    run.warm(mix, int(mix.traffic["warm"]))
    mix.reset()
    w = run.window(mix, seconds)
    v = mix.judge()
    if mix.traffic["kind"] not in mixes.KINDS:
        out = dict(v, counts=mix.finish(), requests=len(w["durations"]))
        if control:
            own = getattr(mix, "control", None)
            out["control_readings"] = own() if own else None
        return out
    out = {"numbers": v["numbers"], "judged": v["judged"],
           "active": v["judged_active"],
           "u_gap_transient": v["u_gap_transient"],
           "u_gap_mean_p50_p90": v["u_gap_mean_p50_p90"],
           "counts": mix.finish(), "requests": len(w["durations"])}
    if control:
        out["u_gap_reference"] = reference_control(mix)
        out["plant_control"] = plant_control(mix)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    bench = run.load_json(run.ROOT / "BENCHMARK.json")
    cell, cfg, traffic, limits = run.cell_files(bench, args.workload)
    if not torch.cuda.is_available():
        print("portbench.control needs a CUDA device", file=sys.stderr)
        return 2
    from reluqp_tpu_torch.ops.cuda_build import build_all
    build_all(traffic["kernels"])
    own_kind = traffic["kind"] in mixes.KINDS
    if args.control and not own_kind and not hasattr(
            mixes.kind_class(traffic["kind"]), "control"):
        print(f"portbench.control: kind {traffic['kind']!r} has no control "
              "readings", file=sys.stderr)
    mix = mixes.make(control_config(cfg) if args.control and own_kind
                     else cfg, traffic, "cuda:0")
    mix.build()
    for seed in args.seeds:
        out = {"workload": args.workload, "seed": seed,
               "control": args.control}
        out.update(readings(mix, seed, args.seconds, args.control))
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
