"""The yardstick for a kernel's share of its roofline.

``PEAKS``: NVIDIA's data sheet for one H100 SXM, dense rates without
sparsity, at the card's full 700 W limit (a card set lower runs slower
under load: the result line carries the card's limit beside the share).

``k2_costs`` and ``k2_bound_s``: the least time the whole-rollout kernel
K2 could take for a rollout, the larger of its operations over the fp32
peak and its bytes over HBM bandwidth. Each product counts only the
multiply-adds its operand's nonzero entries need (the padding, the zero
blocks of the residual operator and the refresh map, the zero rows and
columns of the bank count nothing); per control step the refresh x·GL,
the bias x·M_aff, y·S_u, u·Bdw and one residual check y·M_res; per
iteration y·W at the sparsest rung. Bytes: every operand's nonzeros read
once per launch (one rung: the sparsest), plus each step's x, u, noise
and stats rows. Counting the fewest checks, one rung and the sparsest
rung keeps this a lower bound: the share can only read low, never above
what the card allows.
"""
from __future__ import annotations

PEAKS = {
    "fp32_flops": 67e12,
    "tf32_flops": 495e12,
    "fp64_flops": 34e12,
    "fp64_tensor_flops": 67e12,
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}
PEAKS_SOURCE = ("NVIDIA H100 SXM data sheet, dense, at 700 W")


def k2_costs(args: list, kw: dict, nu: int, npl: int) -> dict:
    """Nonzero counts of one K2 launch's operands (``args``, ``kw`` as the
    program hands them to the kernel)."""
    import torch
    Wt, bias_c, M_aff, rhos, M_res, _, GL, _, _, S_u, Bdw = args[:11]
    nnz = lambda a: int(torch.count_nonzero(a))
    n_rho = Wt.shape[0]
    k = min(range(n_rho), key=lambda r: nnz(Wt[r]))
    nx, nc = kw["nx"], kw["nc"]
    d = nx + 2 * nc
    elt = Wt.element_size()
    per_step = (2 * nnz(GL) + 2 * min(nnz(M_aff[r]) for r in range(n_rho))
                + nnz(S_u) + 2 * nnz(Bdw) + 2 * nnz(M_res))
    fill = (nnz(Wt[k]) + nnz(M_aff[k]) + nnz(bias_c[k]) + nnz(M_res)
            + nnz(GL) + nnz(S_u) + nnz(Bdw) + 2 * nc + 2 * d + nx + npl
            + rhos.numel()) * elt
    return {"ops_per_step": per_step, "ops_per_iteration": 2 * nnz(Wt[k]),
            "fill_bytes": fill, "bytes_per_step": (2 * npl + nu) * elt + 32}


def k2_bound_s(costs: dict, steps: int, iterations: float,
               launches: int) -> tuple:
    """``(seconds, "bytes" or "operations")`` for a rollout of ``steps``
    control steps and ``iterations`` solver iterations in ``launches``
    launches."""
    ops = steps * costs["ops_per_step"] + iterations * \
        costs["ops_per_iteration"]
    nbytes = launches * costs["fill_bytes"] + steps * costs["bytes_per_step"]
    t_ops = ops / PEAKS["fp32_flops"]
    t_bytes = nbytes / PEAKS["hbm_bytes_per_s"]
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")
