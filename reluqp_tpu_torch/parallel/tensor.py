"""Tensor-parallel single-QP solve: the weight bank split by columns over a
mesh, one process per device.

The batch axis (``sharded.py``) scales the number of QPs; this module
scales the size of one QP. Each rank holds a (N_rho, Dp, Dp/n) column
block of the transposed bank Wᵀ (and of the fp32 polish copy under a bf16
bank) and streams only that block per iteration; the iterate ``y`` stays
whole on every rank. One iteration on a rank is its block's product
``y @ W_local``, the bias and clamp on its slice of the lanes, and one
all-gather of the slices into the next ``y`` — the collective moves Dp
numbers, never a bank block.

The residual checks, the ρ walk and the exit run replicated on every
rank from the gathered ``y`` (``core.iteration.solve_loop`` with this
runner): the ranks run the same code on the same values, so they take the
same decisions with no collective. The product is a plain ``torch.matmul``
(the JAX package computes it with XLA outside any Pallas kernel).
"""
from __future__ import annotations

import torch

from ..core.bank import Bank, DeviceQP
from ..core.batched import _tier_product
from ..core.iteration import SolveResult, solve_loop
from .sharded import gather_into

__all__ = ["tp_pad_dim", "tp_chunk_runner", "solve_loop_tp", "tp_align",
           "tp_columns"]

# Column-block width alignment per device type: 8 on the CPU, as the JAX
# package's CPU meshes use; 32 on cuda, a 128-byte line of fp32 per row of
# a block.
_ALIGN = {"cpu": 8, "cuda": 32}


def tp_pad_dim(d: int, n_shards: int, align: int = 128) -> int:
    """Padded stacked dim: every per-device column block is ``align``
    wide (``align=128`` one TPU lane width; the CPU uses 8)."""
    per = -(-d // n_shards)
    per = -(-per // align) * align
    return per * n_shards


def tp_align(device) -> int:
    """The column-block alignment on ``device``'s type."""
    return _ALIGN[torch.device(device).type]


def tp_columns(dp: int, rank: int, size: int) -> slice:
    """Rank ``rank``'s output columns of a Dp-wide bank over ``size``."""
    per = dp // size
    return slice(rank * per, (rank + 1) * per)


def tp_chunk_runner(group):
    """The chunk runner over the column-split bank of ``group``'s ranks.

    The contract of ``core.iteration.xla_chunk_runner`` except that
    ``W_bank`` is this rank's (N, Dp, Dp/n) block; ``b_bank`` (N, Dp),
    ``lo``/``hi`` and ``y`` (Dp,) are whole on every rank. Per iteration:
    one (Dp,)·(Dp, Dp/n) product at the iteration tier, the bias and clamp
    on this rank's lanes, one all-gather of y."""
    import torch.distributed as dist
    rank, size = dist.get_rank(group), dist.get_world_size(group)

    def runner(W_bank, b_bank, rho_ind, lo, hi, y, n_steps: int,
               iter_precision: str = "highest"):
        idx = rho_ind.reshape(1)
        W = W_bank.index_select(0, idx)[0]
        cols = tp_columns(y.shape[0], rank, size)
        b = b_bank.index_select(0, idx)[0, cols]
        lo_l, hi_l = lo[cols], hi[cols]
        mm = lambda v, w: v @ w
        for _ in range(n_steps):
            out = torch.minimum(torch.maximum(
                _tier_product(y, W, iter_precision, mm) + b, lo_l), hi_l)
            y = torch.empty_like(y)
            gather_into(y, out.contiguous(), group)
        return y.clone() if n_steps == 0 else y

    runner.__name__ = f"tp_chunk_runner[{rank}/{size}]"
    return runner


def solve_loop_tp(bank: Bank, qp: DeviceQP, y0, rho_ind0, rho0, W_hi=None,
                  rho_eff=None, M_res=None, *, group,
                  **solve_kw) -> SolveResult:
    """``core.iteration.solve_loop`` with the column-split bank of
    ``group``'s ranks: ``bank.W`` (and ``W_hi`` under a bf16 bank with the
    two-phase refine) is this rank's block, everything else whole.
    ``solve_kw`` are solve_loop's settings (nx, nc, max_iter, ...) but
    ``chunk_runner``, which this supplies. Every rank returns the same
    result."""
    # its windows' all-gathers run window by window from the host
    return solve_loop(bank, qp, y0, rho_ind0, rho0, W_hi, rho_eff, None,
                      M_res, chunk_runner=tp_chunk_runner(group),
                      _per_window=True, **solve_kw)
