"""Residual operator for the one-matmul residual check.

Only ``build_residual_operator`` is here so far: the whole-solve kernels
(K3 ``full_solve``, K2 ``full_rollout``, K6 ``full_rollout_batched``) are
later slices of the port.

With lane-aligned segment padding,

    y @ M_res = [A x | z | H x | Aᵀ λ]     M_res (Dp, R), R = 2·ncp + 2·nxp

built from rows ``[[Aᵀ,0,H,0],[0,I,0,0],[0,0,0,A]]`` (zero rows in the
padding keep every segment exact).
"""
from __future__ import annotations

import numpy as np
import torch

from .fused_step import pad_dim

__all__ = ["build_residual_operator"]


def build_residual_operator(H, A, g, dp: int, dtype, w_pri=None,
                            w_dua=None, lam_segment: bool = True,
                            device="cpu"):
    """Host fp64 build of ``(M_res, g_row, nxp, ncp)``.

    Segment layout in the result row: [Ax | z | Hx | Aᵀλ] with nc, nc, nx,
    nx entries padded to ncp/ncp/nxp/nxp (multiples of 128). Optional
    ``w_pri`` (nc,) / ``w_dua`` (nx,) fold the residual unscale weights
    into the operator columns and ``g_row``. ``lam_segment=False`` drops
    the Aᵀλ segment (alpha ≠ 1, where the last y slot holds p, not λ).
    ``M_res`` (Dp, R) and ``g_row`` (1, nxp) come back as tensors of
    ``dtype`` on ``device``.
    """
    H = np.asarray(H, dtype=np.float64)
    A = np.asarray(A, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64).reshape(-1)
    nx, nc = H.shape[0], A.shape[0]
    wp = np.ones(nc) if w_pri is None else np.asarray(w_pri, np.float64)
    wd = np.ones(nx) if w_dua is None else np.asarray(w_dua, np.float64)
    nxp, ncp = pad_dim(nx), pad_dim(nc)
    R = 2 * ncp + (2 * nxp if lam_segment else nxp)
    M = np.zeros((dp, R), dtype=np.float64)
    M[:nx, 0:nc] = A.T * wp[None, :]                    # → w_pri ⊙ Ax
    M[:nx, 2 * ncp:2 * ncp + nx] = H * wd[None, :]      # → w_dua ⊙ Hx
    M[nx:nx + nc, ncp:ncp + nc] = np.diag(wp)           # → w_pri ⊙ z
    if lam_segment:
        M[nx + nc:nx + 2 * nc, 2 * ncp + nxp:2 * ncp + nxp + nx] = \
            A * wd[None, :]                             # → w_dua ⊙ Aᵀλ
    g_row = np.zeros((1, nxp), dtype=np.float64)
    g_row[0, :nx] = wd * g
    put = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return put(M), put(g_row), nxp, ncp
