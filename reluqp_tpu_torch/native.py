"""ctypes binding to the port's native C++ runtime.

The source is ``host/reluqp_native.cpp``; the library is an
OpenMP-parallel fp64 weight-bank builder and a complete CPU solve loop.
``ReLU_QP.setup(bank_backend=...)`` and the heterogeneous batch's host
build use its builder; its solve is a second implementation for
cross-checking.

``ensure_built()`` compiles the source with ``g++`` at first use, with the
flags ``_CXXFLAGS`` (those of the JAX package's ``native/Makefile``, so the
two libraries give the same bits), into ``reluqp_tpu_torch/_build/`` (listed
in ``.gitignore``) under a name keyed by a hash of the source and the flags,
and a later process reuses it. A compiler without OpenMP (no
``libgomp.spec``) builds the same source without ``-fopenmp``: the OpenMP
loop runs over independent rungs, so the serial library gives the same
bits, more slowly (``uses_openmp()`` says which was built). Nothing here
runs at import. Every function raises ``NativeUnavailable`` when the
compiler or the library is missing.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .core.ladder import initial_rho_index

__all__ = ["NativeUnavailable", "available", "ensure_built", "build_bank",
           "solve", "uses_openmp", "NativeInfo"]

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "host" / "reluqp_native.cpp"
BUILD_DIR = _PKG / "_build"
_CXXFLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-fopenmp",
             "-Wall", "-Wextra", "-shared")
_SERIAL_FLAGS = tuple(f for f in _CXXFLAGS if f != "-fopenmp")

# the loaded library, or the reason it could not be built, once per process
_STATE: dict = {}


class NativeUnavailable(RuntimeError):
    pass


class NativeInfo(ctypes.Structure):
    _fields_ = [
        ("iters", ctypes.c_int32),
        ("status", ctypes.c_int32),
        ("rho_ind", ctypes.c_int32),
        ("pri_res", ctypes.c_double),
        ("dua_res", ctypes.c_double),
        ("rho_estimate", ctypes.c_double),
        ("obj_val", ctypes.c_double),
    ]


def _lib_path(flags) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"libreluqp_native_{h.hexdigest()[:16]}.so"


def _compile(cxx: str, flags, path: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeUnavailable(f"native build failed: {detail}") from e
    os.replace(tmp, path)   # atomic: a concurrent loader sees all or none


def ensure_built(rebuild: bool = False) -> str:
    """Compile the library unless it is built (with OpenMP where the
    compiler has it, else without); returns its path."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    errors = []
    for flags in (_CXXFLAGS, _SERIAL_FLAGS):
        path = _lib_path(flags)
        if path.exists() and not rebuild:
            return str(path)
        if cxx is None:
            raise NativeUnavailable("native build failed: no g++ found")
        try:
            _compile(cxx, flags, path)
            return str(path)
        except NativeUnavailable as e:
            errors.append(str(e))
    raise NativeUnavailable("; ".join(errors))


def _load():
    lib = _STATE.get("lib")
    if lib is not None:
        return lib
    if "error" in _STATE:
        raise NativeUnavailable(_STATE["error"])
    try:
        path = ensure_built()
        lib = ctypes.CDLL(path)
    except (NativeUnavailable, OSError) as e:
        _STATE["error"] = f"native library unavailable: {e}"
        raise NativeUnavailable(_STATE["error"]) from e
    dp, i, d = (ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                ctypes.c_double)
    lib.rq_version.argtypes = []
    lib.rq_version.restype = i
    lib.rq_build_bank.argtypes = [dp, dp, dp, ctypes.POINTER(ctypes.c_uint8),
                                  dp, i, i, i, d, d, dp, dp, dp]
    lib.rq_build_bank.restype = i
    lib.rq_solve.argtypes = [dp, dp, dp, dp, dp, dp, dp, dp, i, i, i, i, i,
                             d, d, i, d, d, i, dp,
                             ctypes.POINTER(NativeInfo)]
    lib.rq_solve.restype = i
    _STATE["lib"] = lib
    _STATE["openmp"] = path == str(_lib_path(_CXXFLAGS))
    return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        _load()
        return True
    except NativeUnavailable:
        return False


def uses_openmp() -> bool:
    """Whether the loaded library was built with OpenMP (loads it)."""
    _load()
    return _STATE["openmp"]


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def build_bank(H, A, g, eq_mask, rhos, sigma, rho_cap: float = np.inf
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native fp64 bank build, ``alpha = 1`` only; the contract of
    ``core.bank.build_bank_np`` (the equality boost, the ``rho_cap`` on
    the per-row effective ρ): ``(W, B, b)``, (N, D, D), (N, D, nx), (N, D).
    """
    lib = _load()
    H, A, rhos = _f64(H), _f64(A), _f64(rhos)
    g = _f64(g).reshape(-1)
    eq = np.ascontiguousarray(eq_mask, dtype=np.uint8)
    nx, nc = H.shape[0], A.shape[0]
    if H.shape != (nx, nx) or A.shape[1] != nx or g.shape != (nx,) \
            or eq.shape != (nc,) or rhos.ndim != 1:
        raise ValueError("build_bank: H (nx, nx), A (nc, nx), g (nx,), "
                         "eq_mask (nc,) and rhos (N,) expected")
    D, N = nx + 2 * nc, rhos.shape[0]
    W = np.empty((N, D, D))
    B = np.empty((N, D, nx))
    b = np.empty((N, D))
    rc = lib.rq_build_bank(
        _dptr(H), _dptr(A), _dptr(g),
        eq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _dptr(rhos), N,
        nx, nc, float(sigma), float(rho_cap), _dptr(W), _dptr(B), _dptr(b))
    if rc != 0:
        raise RuntimeError("native bank build failed (KKT not SPD)")
    return W, B, b


def solve(H, A, g, l, u, W_bank, b_bank, rhos, *, max_iter=4000,
          check_interval=25, eps_abs=1e-3, adaptive_rho=True,
          adaptive_rho_tolerance=5.0, rho_min=1e-6, rho_max=1e6,
          rho=0.1, rho_ind0: Optional[int] = None, y0=None):
    """Native CPU solve on an (N, D, D) bank ``W_bank`` (not transposed)
    and (N, D) biases; returns ``(y, info)``."""
    lib = _load()
    H, A, W_bank, b_bank, rhos = (_f64(a) for a in (H, A, W_bank, b_bank,
                                                    rhos))
    g, l, u = (_f64(a).reshape(-1) for a in (g, l, u))
    nx, nc = H.shape[0], A.shape[0]
    D, N = nx + 2 * nc, rhos.shape[0]
    if W_bank.shape != (N, D, D) or b_bank.shape != (N, D) \
            or l.shape != (nc,) or u.shape != (nc,) or g.shape != (nx,):
        raise ValueError("solve: W_bank (N, D, D), b_bank (N, D), g (nx,) "
                         "and l, u (nc,) expected")
    if rho_ind0 is None:
        rho_ind0 = initial_rho_index(rhos, rho)
    y = np.zeros(D) if y0 is None else _f64(y0).copy()
    info = NativeInfo()
    rc = lib.rq_solve(
        _dptr(H), _dptr(A), _dptr(g), _dptr(l), _dptr(u), _dptr(W_bank),
        _dptr(b_bank), _dptr(rhos), N, nx, nc, int(max_iter),
        int(check_interval), float(eps_abs), float(adaptive_rho_tolerance),
        1 if adaptive_rho else 0, float(rho_min), float(rho_max),
        int(rho_ind0), _dptr(y), ctypes.byref(info))
    if rc != 0:
        raise RuntimeError(f"native solve failed rc={rc}")
    return y, info
