"""ρ-ladder construction (host numpy, computed once at setup).

A geometric ladder around the initial ρ, stepping by
``adaptive_rho_tolerance`` down to ``rho_min`` and up to ``rho_max``,
sorted ascending. Its length is a Python int fixed at setup.
"""
from __future__ import annotations

import numpy as np

__all__ = ["setup_rhos", "initial_rho_index"]


def setup_rhos(rho: float, rho_min: float, rho_max: float,
               adaptive_rho: bool, adaptive_rho_tolerance: float) -> np.ndarray:
    """Return the ascending ρ ladder as a float64 numpy array."""
    rhos = [float(rho)]
    if adaptive_rho:
        t = float(adaptive_rho_tolerance)
        r = rho / t
        while r >= rho_min:
            rhos.append(r)
            r = r / t
        r = rho * t
        while r <= rho_max:
            rhos.append(r)
            r = r * t
        rhos.sort()
    return np.asarray(rhos, dtype=np.float64)


def initial_rho_index(rhos: np.ndarray, rho: float) -> int:
    """Index of the ladder entry closest to ρ."""
    return int(np.argmin(np.abs(np.asarray(rhos) - float(rho))))
