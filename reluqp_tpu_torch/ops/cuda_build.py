"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc -shared`` for ``sm_90a`` into ``reluqp_tpu_torch/_build/`` (listed in
``.gitignore``) at first use, under a file name keyed by a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags, and loaded with
``ctypes``. A later process reuses the library while none of those
changes. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "nvcc_path", "build_all",
           "load"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every shared header ``csrc/*.cuh`` (any source may include any) and the
    flags: a change to any of them builds anew."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every listed source (default: all of ``csrc/*.cu``) that has
    no library yet, one ``nvcc`` per source, all started together.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0.0 and
    ``log`` empty for a library that was already built. Raises with the
    compiler's output when a build fails.
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, out = {}, {}
    t0 = time.perf_counter()
    for name in names:
        path = _lib_path(name)
        if path.exists():
            out[name] = {"path": path, "seconds": 0.0, "log": ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, path)
    for name, (proc, tmp, path) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
        out[name] = {"path": path, "seconds": time.perf_counter() - t0,
                     "log": log}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]["path"]))
        _LOADED[name] = lib
    return lib
