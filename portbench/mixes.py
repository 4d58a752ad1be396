"""The general traffic generator and its request loops.

A traffic mix is a JSON file under ``portbench/traffic/``; its ``kind``
picks one of the classes below and the rest of the file gives its
parameters. A mix is built once from a configuration (the problem the
program is set up on, which no run's seed changes), is handed a seed's
inputs, then serves requests one at a time (a closed loop with one
client) and, once the window has closed, hands the answers it kept to the
judge (``portbench.reference.judge``).

Kinds:

- ``rollout``: one warm closed-loop MPC rollout per request through
  ``models.mpc.mpc_rollout_scan``, from a plant state drawn from the seed,
  under a constant load on the inputs drawn from the seed;
- ``scenario``: one ensemble rollout per request through
  ``models.mpc.scenario_rollout_scan``: B plant states and B loads.

A load is an input disturbance d ~ N(0, ``load_scale``² I) held for the
whole rollout: the plant steps x+ = Ad x + Bd (u + d), handed to the
program as the process disturbance Bd d. Where |d_i| > 1 the controller
cannot cancel it and input i stays at its bound, so the QP of every step
past the transient has active bounds.

Inputs come from a pool of ``pool`` draws made from the seed at set-up,
served in turn. The program gets only these raw inputs. The answers kept
for the judge are ``keep`` requests drawn from the seed evenly over the
whole window (a reservoir sample: request i replaces a kept one with
probability keep / (i + 1)).
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from .reference import judge
from .reference import problems as P

SOLVED = 1   # the program's status code for a certified solve


def _settings(cfg: dict, device) -> dict:
    return dict(cfg.get("settings", {}), device=device)


def _mpc_plant(cfg: dict):
    if cfg["problem"] != "mpc":
        raise ValueError(f"traffic needs an 'mpc' configuration, got "
                         f"{cfg['problem']!r}")
    Ad, Bd = P.random_linear_system(cfg["nx"], cfg["nu"], cfg["system_seed"],
                                    cfg["spectral_radius"])
    Q = cfg["q"] * np.eye(cfg["nx"])
    R = cfg["r"] * np.eye(cfg["nu"])
    return Ad, Bd, Q, R


class Rollout:
    """``mpc_rollout_scan`` from a fresh plant state and load per
    request."""

    def __init__(self, cfg: dict, traffic: dict, device):
        self.cfg, self.traffic = cfg, traffic
        self.device = torch.device(device)

    # ------------------------------------------------------------- set-up

    def build(self) -> None:
        from reluqp_tpu_torch.models.mpc import MPC
        cfg = self.cfg
        self.Ad, self.Bd, self.Q, self.R = _mpc_plant(cfg)
        self.ctrl = MPC(self.Ad, self.Bd, self.Q, self.R,
                        horizon=cfg["horizon"], u_min=cfg["u_min"],
                        u_max=cfg["u_max"],
                        prestabilize=cfg["prestabilize"],
                        **_settings(cfg, self.device))

    def solver(self):
        return self.ctrl.solver

    def dtype(self):
        return self.solver().settings.precision_dtype

    def plants(self) -> tuple:
        """The plant dimensions of one request's draw: () or (B,)."""
        return ()

    def inputs(self, seed: int) -> None:
        """Draw the pool: start states and loads (as the disturbance Bd d
        per plant), on the host in float64 and on the device."""
        self.seed = int(seed)
        t = self.traffic
        rng = P.seed_words(seed, 1)
        shape = (int(t["pool"]),) + self.plants()
        self.X0 = t["x0_scale"] * rng.randn(*shape, self.cfg["nx"])
        self.W = (t["load_scale"] * rng.randn(*shape, self.cfg["nu"])) \
            @ self.Bd.T
        dev = lambda a: torch.as_tensor(a, dtype=self.dtype(),
                                        device=self.device)
        self.X0_dev, self.W_dev = dev(self.X0), dev(self.W)
        self.reset()

    def k2_costs(self) -> dict:
        """The nonzeros of K2's operands as the program hands them to it
        (``portbench.roofline.k2_costs``)."""
        from reluqp_tpu_torch.models.mpc import _scan_call
        from .roofline import k2_costs
        args, kw = _scan_call(self.ctrl.solver, self.ctrl.prob,
                              self.X0_dev[0], int(self.traffic["steps"]))
        nu, npl = self.ctrl.prob.K.shape
        return k2_costs(args, kw, nu, npl)

    # ------------------------------------------------------------ window

    def reset(self) -> None:
        """Forget the warm-up: counts and kept answers start anew, and
        the reservoir's draws restart from the seed."""
        self.kept = {}
        self.keep_rng = P.seed_words(self.seed, 0)
        self.counts = dict(attempted=0, unsolved=0, iters=0.0, iter_qps=0,
                           requests=0)
        self._nonfinite = torch.zeros((), dtype=torch.int64,
                                      device=self.device)
        self.req_iters = []

    def _run(self, j: int):
        from reluqp_tpu_torch.models.mpc import mpc_rollout_scan
        t = self.traffic
        T = int(t["steps"])
        return mpc_rollout_scan(self.ctrl.solver, self.ctrl.prob,
                                self.X0_dev[j], T, kernel=t["kernel"],
                                check_interval=t["check_interval"],
                                noise=self.W_dev[j].expand(T, -1),
                                return_stats=True)

    def request(self, i: int) -> None:
        j = i % len(self.X0)
        xs, us, iters, status = self._run(j)
        self.sync()
        self.account(i, j, xs, us, iters, status)

    def account(self, i, j, xs, us, iters, status):
        """Count the request's QPs (a step of B plants is B QPs; the
        status lane is the ensemble's worst, so a step it marks unsolved
        counts each plant's QP as failed) and keep it where the reservoir
        draws it."""
        T = int(self.traffic["steps"])
        rows = int(np.prod(self.plants(), dtype=int))
        c = self.counts
        c["requests"] += 1
        c["attempted"] += T * rows
        c["unsolved"] += rows * int((status != SOLVED).sum())
        c["iters"] += float(iters.sum()) * rows
        self.req_iters.append(float(iters.sum()))
        c["iter_qps"] += T * rows
        bad = ~torch.isfinite(us).reshape(T, -1).all(1)
        self._nonfinite += bad.sum() * rows
        keep = int(self.traffic["keep"])
        slot = i if i < keep else int(self.keep_rng.randint(i + 1))
        if slot < keep:
            self.kept[slot] = (j, xs.clone(), us.clone(), iters.clone())

    def finish(self) -> dict:
        """The window's counts, read once after it has closed."""
        c = dict(self.counts)
        c["nonfinite"] = int(self._nonfinite)
        c["failed"] = min(c["attempted"], c["unsolved"] + c["nonfinite"])
        c["solved"] = c["attempted"] - c["failed"]
        return c

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def captures(self) -> int:
        """CUDA graphs captured and device programs built so far by the
        program's solver (its ``WindowGraphs`` cache)."""
        wg = getattr(self.solver(), "_window_graphs", None)
        return int(getattr(wg, "captures", 0)) + int(getattr(wg, "programs",
                                                             0))

    def launches(self) -> int:
        """The kernel launches the program's counters named in the mix's
        ``counters`` (``module:function``) have counted so far."""
        n = 0
        for spec in self.traffic.get("counters", []):
            mod, fn = spec.split(":")
            n += int(getattr(getattr(importlib.import_module(mod), fn),
                             "launches", 0))
        return n

    def free(self) -> None:
        """Drop the program's solver once the window has closed."""
        self.m = None
        self.ctrl = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------- judge

    def runs(self) -> list:
        """The kept requests for the judge: ``(X0 (B, nx), W (B, nx), xs
        (T+1, B, nx), us (T, B, nu), iters (T,))``, float64 on the host."""
        f64 = lambda a: a.double().cpu().numpy()
        nx = self.cfg["nx"]
        T = int(self.traffic["steps"])
        return [(self.X0[j].reshape(-1, nx), self.W[j].reshape(-1, nx),
                 f64(xs).reshape(T + 1, -1, nx),
                 f64(us).reshape(T, -1, self.cfg["nu"]), its.numpy())
                for _, (j, xs, us, its) in sorted(self.kept.items())]

    def judge(self) -> dict:
        return judge.rollouts(self.cfg, self.traffic, self.seed, self.runs())


class Scenario(Rollout):
    """``scenario_rollout_scan``: B plants under one controller."""

    def build(self) -> None:
        from reluqp_tpu_torch.batch import BatchedReLU_QP
        from reluqp_tpu_torch.models.mpc import gen_condensed_mpc_qp, ihlqr
        cfg, t = self.cfg, self.traffic
        self.Ad, self.Bd, self.Q, self.R = _mpc_plant(cfg)
        nx, nu, N = cfg["nx"], cfg["nu"], cfg["horizon"]
        K, Qf = ihlqr(self.Ad, self.Bd, self.Q, self.R)
        if not cfg["prestabilize"]:
            K = np.zeros_like(K)
        ns = nu + nx
        rows = np.zeros((N * nu, N * ns))
        for k in range(N):
            rows[k * nu:(k + 1) * nu, k * ns:k * ns + nu] = np.eye(nu)
        self.prob = gen_condensed_mpc_qp(
            self.Ad, self.Bd, self.Q, self.R, Qf, N, rows,
            np.full(N * nu, cfg["u_min"]), np.full(N * nu, cfg["u_max"]), K=K)
        B = int(t["scenarios"])
        self.m = BatchedReLU_QP()
        p = self.prob
        self.m.setup(p.H, np.tile(p.g0, (B, 1)), p.A, np.tile(p.l0, (B, 1)),
                     np.tile(p.u0, (B, 1)), **_settings(cfg, self.device))

    def solver(self):
        return self.m

    def plants(self) -> tuple:
        return (int(self.traffic["scenarios"]),)

    def _run(self, j: int):
        from reluqp_tpu_torch.models.mpc import scenario_rollout_scan
        t = self.traffic
        T = int(t["steps"])
        return scenario_rollout_scan(self.m, self.prob, self.X0_dev[j], T,
                                     noise=self.W_dev[j].expand(T, -1, -1),
                                     kernel=t["kernel"],
                                     check_interval=t["check_interval"],
                                     return_stats=True)


KINDS = {"rollout": Rollout, "scenario": Scenario}


def make(cfg: dict, traffic: dict, device):
    return KINDS[traffic["kind"]](cfg, traffic, device)
