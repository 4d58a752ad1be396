"""Carry a weight bank across from the JAX package.

``bank_from_arrays`` takes the fields of a ``reluqp_tpu`` ``Bank`` as numpy
arrays, in their runtime layout (Wᵀ per rung, padded), and returns this
package's ``Bank``. With ``ReLU_QP.load_state`` a test can run both
packages on the same bank and state, which separates differences in the
bank build from differences in the iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.bank import Bank

__all__ = ["bank_from_arrays"]


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
