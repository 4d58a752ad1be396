"""Modified Ruiz equilibration (OSQP-style problem scaling), host numpy.

Iterative Ruiz equilibration of the stacked matrix ``[[H, Aᵀ], [A, 0]]``
plus a cost normalization gives diagonal scalings ``D`` (variables), ``E``
(constraints) and a cost scalar ``c`` such that the scaled problem

    H̄ = c·D H D,  ḡ = c·D g,  Ā = E A D,  l̄ = E l,  ū = E u

is better conditioned for ADMM. Solutions map back as ``x = D x̄``,
``z = E⁻¹ z̄``, ``λ = (1/c)·E λ̄``. Termination defaults to UNSCALED
residuals (OSQP's ``scaled_termination=False``): the loop weights the
residual vectors by ``E⁻¹`` / ``(1/c)·D⁻¹`` before the ∞-norms
(``core.bank.DeviceQP`` w_pri/w_dua).

This is the same numpy code as the JAX package's ``utils/scaling.py``, kept
as its own copy so the port imports nothing of that package.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["Scaling", "ruiz_equilibrate", "identity_scaling",
           "residual_unscale_weights"]

_MIN_SCALE = 1e-4
_MAX_SCALE = 1e4


def residual_unscale_weights(scal: "Scaling", settings):
    """The residual unscale weights ``(w_pri, w_dua)``.

    ``(None, None)`` unless ``settings.scaling`` with the default unscaled
    termination — then ``w_pri = 1/E`` and ``w_dua = 1/(c·D)`` in fp64.
    """
    if not (getattr(settings, "scaling", False)
            and not getattr(settings, "scaled_termination", False)):
        return None, None
    c = np.asarray(scal.cinv)
    Dinv = np.asarray(scal.Dinv)
    w_dua = c.reshape(-1, 1) * Dinv if Dinv.ndim == 2 else c * Dinv
    return np.asarray(scal.Einv), w_dua


class Scaling(NamedTuple):
    D: np.ndarray      # (nx,) variable scaling
    E: np.ndarray      # (nc,) constraint-row scaling
    c: float           # cost scaling
    Dinv: np.ndarray
    Einv: np.ndarray
    cinv: float


def identity_scaling(nx: int, nc: int) -> Scaling:
    return Scaling(np.ones(nx), np.ones(nc), 1.0,
                   np.ones(nx), np.ones(nc), 1.0)


def _limit(v):
    return np.clip(v, _MIN_SCALE, _MAX_SCALE)


def ruiz_equilibrate(H, A, g, iters: int = 10) -> Scaling:
    """Iterative modified Ruiz equilibration on [[H, Aᵀ], [A, 0]].

    Each pass rescales every row/column of the stacked symmetric matrix by
    the inverse square root of its ∞-norm, then normalizes the cost so the
    mean column norm of ``c·D H D`` (or ``|c·D g|``) is ~1.
    """
    H = np.abs(np.asarray(H, dtype=np.float64))
    A = np.abs(np.asarray(A, dtype=np.float64))
    g = np.abs(np.asarray(g, dtype=np.float64)).reshape(-1)
    nx, nc = H.shape[0], A.shape[0]
    D = np.ones(nx)
    E = np.ones(nc)
    c = 1.0
    for _ in range(iters):
        Hs = H * D[:, None] * D[None, :] * c
        As = A * E[:, None] * D[None, :]
        # column ∞-norms of the stacked [[H, Aᵀ],[A, 0]]
        col_x = np.maximum(Hs.max(axis=0, initial=0.0),
                           As.max(axis=0, initial=0.0))
        col_z = As.max(axis=1, initial=0.0)
        d = _limit(1.0 / np.sqrt(_limit(col_x)))
        e = _limit(1.0 / np.sqrt(_limit(col_z)))
        D = _limit(D * d)
        E = _limit(E * e)
        # cost normalization: mean column norm of scaled H vs |scaled g|
        Hs = H * D[:, None] * D[None, :] * c
        gs = g * D * c
        norm_H = Hs.max(axis=0, initial=0.0).mean()
        gamma = 1.0 / _limit(max(norm_H, gs.max(initial=0.0)))
        c = float(_limit(c * _limit(gamma)))
    return Scaling(D=D, E=E, c=c, Dinv=1.0 / D, Einv=1.0 / E, cinv=1.0 / c)
