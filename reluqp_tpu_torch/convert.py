"""Carry a weight bank across from the JAX package.

``bank_from_arrays`` takes the fields of a ``reluqp_tpu`` ``Bank`` as numpy
arrays, in their runtime layout (Wᵀ per rung, padded), and returns this
package's ``Bank``; ``batched_from_arrays`` does the same for a JAX
``BatchedReLU_QP``'s bank and state. With ``ReLU_QP.load_state`` /
``BatchedReLU_QP.load_state`` a test can run both packages on the same bank
and state, which separates differences in the bank build from differences
in the iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from typing import NamedTuple

from .core.bank import Bank

__all__ = ["bank_from_arrays", "BatchedArrays", "batched_from_arrays"]


def bank_from_arrays(W_t, B, b, rhos, *, dtype=torch.float32,
                     device="cpu") -> Bank:
    """``W_t`` (N, Dp, Dp), ``B`` (N, Dp, nx), ``b`` (N, Dp), ``rhos`` (N,)
    → a ``Bank`` of ``dtype`` tensors on ``device``."""
    W_t = np.asarray(W_t, np.float64)
    B = np.asarray(B, np.float64)
    b = np.asarray(b, np.float64)
    rhos = np.asarray(rhos, np.float64)
    n, dp = W_t.shape[0], W_t.shape[1]
    if W_t.shape != (n, dp, dp) or B.shape[:2] != (n, dp) \
            or b.shape != (n, dp) or rhos.shape != (n,):
        raise ValueError(
            f"inconsistent bank shapes: W_t {W_t.shape}, B {B.shape}, "
            f"b {b.shape}, rhos {rhos.shape}")
    put = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # copies
    return Bank(W=put(W_t, dtype), B=put(B, dtype),
                b=put(b, dtype), rhos=put(rhos, dtype))


class BatchedArrays(NamedTuple):
    """A batched solver's bank and state in this package's layout."""

    Wt_bank: torch.Tensor   # (N, Dp, Dp) transposed padded bank, or
                            # (B, N, Dp, Dp) per-problem banks
    B_np: np.ndarray        # (N, Dp, nx) or (B, N, Dp, nx) fp64 bias
                            # master (b_k = B_k g)
    rhos: torch.Tensor      # (N,)
    Y: torch.Tensor         # (B_pad, Dp) stacked states
    rho_ind: torch.Tensor   # () or (B,) int32 ladder index


def batched_from_arrays(Wt_bank, B_bank, rhos, Y, rho_ind, *,
                        dtype=torch.float32, device="cpu") -> BatchedArrays:
    """A JAX ``BatchedReLU_QP``'s ``Wt_bank`` (N, Dp, Dp) — or, for a
    heterogeneous batch, (B, N, Dp, Dp) per-problem banks —, ``B_bank``
    (N, Dp, nx) or (B, N, Dp, nx) (with its fp32 cast residual added back
    where it has one), ``rhos`` (N,), ``Y`` (B_pad, Dp) and ``rho_ind`` (an
    index, or a (B,) rung vector) as numpy arrays → this package's tensors
    of ``dtype`` on ``device`` (the B master stays fp64 on the host, where
    this package computes every bias)."""
    Wt = np.asarray(Wt_bank, np.float64)
    B = np.asarray(B_bank, np.float64)
    rhos = np.asarray(rhos, np.float64)
    Y = np.asarray(Y, np.float64)
    lead = Wt.shape[:-3]          # () shared, (B,) per problem
    n, dp = (Wt.shape[-3], Wt.shape[-2]) if Wt.ndim >= 3 else (0, 0)
    if Wt.ndim not in (3, 4) or Wt.shape[-3:] != (n, dp, dp) \
            or B.shape[:-1] != lead + (n, dp) or rhos.shape != (n,) \
            or Y.ndim != 2 or Y.shape[1] != dp \
            or (lead and Y.shape[0] != lead[0]):
        raise ValueError(
            f"inconsistent batched shapes: Wt_bank {Wt.shape}, B_bank "
            f"{B.shape}, rhos {rhos.shape}, Y {Y.shape}")
    put = lambda a, dt: torch.tensor(a, dtype=dt, device=device)  # copies
    return BatchedArrays(Wt_bank=put(Wt, dtype), B_np=B.copy(),
                         rhos=put(rhos, dtype), Y=put(Y, dtype),
                         rho_ind=put(np.asarray(rho_ind, np.int32),
                                     torch.int32))
