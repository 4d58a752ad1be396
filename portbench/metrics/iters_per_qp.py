"""Solver iterations per QP from the program's own results: a rollout's
per-step iteration counts (a step of B plants is B QPs of the step's
iterations)."""


def read(rec):
    c = rec["counts"]
    return c["iters"] / c["iter_qps"] if c["iter_qps"] else None
