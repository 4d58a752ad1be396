"""The comparison that decides ``correct``.

The judge takes the program's answers as numbers and the benchmark's own
raw inputs, works every reference answer out again in float64 with the
plain solver (``reference.qp``), and returns the numbers compared, each to
be held to its limit (``portbench/limits/<workload>.json``):

- ``plant_gap``: the largest ‖x_{t+1} − Ad x_t − Bd u_t − w‖∞ over every
  kept step (the start state against the drawn one included), w the
  drawn load's disturbance: it holds the plant step and the records;
- ``u_gap``: the largest ‖u_t − u*(x_t)‖∞ over a sample of the settled
  steps (from ``settled_from`` on) drawn from the seed, where u*(x) is the
  first control of the exact solution of the condensed QP at the
  program's own state x_t, condensed here from (Ad, Bd, Q, R). Under the
  traffic's loads these QPs have active bounds, and the program's warm
  start has converged to its iteration's fixed point, which is the exact
  solution: the gap holds the solve (its iteration, its ρ rung, its
  check) to its precision, not to the tolerance at which a transient
  step stops.

The reference follows the program step by step from its own states: a
drift of the trajectory is held by the plant gap, the solve by the control
gap. ``u_gap_transient``, the same gap over a sample of the steps before
``settled_from``, where a step stops at the configuration's tolerance, is
reported beside them and not compared: the control meets it as closely as
the program (``PERF.md``).
"""
from __future__ import annotations

import numpy as np
import torch

from . import problems as P
from . import qp


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def _u_gap(c: P.Condensed, nu: int, X: np.ndarray, U: np.ndarray) -> tuple:
    """``(per-row gaps, reference residual, active rows)`` at states
    ``X``."""
    if not len(X):
        return np.zeros(1), 0.0, 0
    g, l, u = P.mpc_qp_at(c, X)
    v, z, y, pri, dua = qp.solve_exact(_t(c.H), _t(g), _t(c.A), _t(l),
                                       _t(u))
    u_ref = -X @ c.K.T + v.numpy()[:, :nu]
    return (np.abs(U - u_ref).max(1),
            float(max(pri.max(), dua.max())),
            int((y.abs().amax(1) > 1e-9).sum()))


def plant_gap(Ad, Bd, runs: list) -> float:
    """The largest plant-step and start-state gap over ``runs``."""
    gap = 0.0
    for X0, W, xs, us, _ in runs:
        gap = max(gap, float(np.abs(xs[0] - X0).max()))
        step = xs[1:] - (xs[:-1] @ Ad.T + us @ Bd.T + W[None])
        gap = max(gap, float(np.abs(step).max()))
    return gap


def rollouts(cfg: dict, traffic: dict, seed: int, runs: list,
             u_at=None) -> dict:
    """``runs``: ``(X0 (B, nx), W (B, nx), xs (T+1, B, nx), us (T, B,
    nu), iters (T,))`` per kept request, as float64 host arrays.
    ``u_at(X)``, where given, answers the sampled states ``X`` in the
    program's place (a control that follows the program's states)."""
    Ad, Bd = P.random_linear_system(cfg["nx"], cfg["nu"], cfg["system_seed"],
                                    cfg["spectral_radius"])
    Q = cfg["q"] * np.eye(cfg["nx"])
    R = cfg["r"] * np.eye(cfg["nu"])
    c = P.condense(Ad, Bd, Q, R, cfg["horizon"], cfg["u_min"], cfg["u_max"],
                   cfg["prestabilize"])
    jd = traffic["judge"]
    rng = P.seed_words(seed, 4)
    settled = int(jd["settled_from"])
    picked = {"settled": ([], []), "transient": ([], [])}
    for X0, W, xs, us, iters in runs:
        T, B = us.shape[0], us.shape[1]
        for name, lo, hi, n in (("settled", settled, T, jd["steps_settled"]),
                                ("transient", 0, settled,
                                 jd["steps_transient"])):
            steps = set(rng.randint(lo, hi, int(n)).tolist())
            if name == "settled":
                steps.add(lo + int(np.argmax(iters[lo:])))
            X, U = picked[name]
            for t in sorted(steps):
                for b in rng.choice(B, min(B, int(jd["plants_per_step"])),
                                    replace=False):
                    X.append(xs[t, b])
                    U.append(us[t, b])
    nu = cfg["nu"]
    if u_at is not None:
        picked = {k: (X, u_at(np.array(X))) for k, (X, _) in picked.items()}
    gaps, res, active = _u_gap(c, nu, *map(np.array, picked["settled"]))
    gaps_tr, res_tr, _ = _u_gap(c, nu, *map(np.array, picked["transient"]))
    return {"numbers": {"u_gap": float(gaps.max()),
                        "plant_gap": plant_gap(Ad, Bd, runs)},
            "judged": len(picked["settled"][0]), "judged_active": active,
            "u_gap_mean_p50_p90": [float(gaps.mean()),
                                   float(np.quantile(gaps, 0.5)),
                                   float(np.quantile(gaps, 0.9))],
            "u_gap_transient": float(gaps_tr.max()),
            "reference_residual": max(res, res_tr)}
