"""Model layers built on the solver (linear MPC)."""
from . import mpc

__all__ = ["mpc"]
