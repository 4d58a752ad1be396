"""Chunk kernels K1, K4 and K5: ``y ← clip(y Wₖᵀ + b, lo, hi)`` × n_steps.

The hot op of every solve. ``fused_chunk`` launches the hand-written CUDA
kernel K1 ``csrc/fused_step.cu`` for CUDA tensors (see its header for the
design: K5's cluster kernel, ``csrc/chunk_cluster.cuh``, with every row on
the one rung) and runs the plain torch version ``fused_chunk_ref`` for CPU
tensors. ``fused_chunk_batched`` does the same for a (B, Dp) block of
independent rows sharing one rung, through kernel K4
``csrc/fused_step_batched.cu`` and its plain version
``fused_chunk_batched_ref``; ``pallas_batched_chunk_runner`` is the batched
solver's runner over it. ``fused_chunk_hetero`` runs a heterogeneous batch,
every row against the rung of its OWN ladder of a (B, N, Dp, Dp) bank,
through kernel K5 ``csrc/fused_step_hetero.cu`` and its plain version
``fused_chunk_hetero_ref``; ``pallas_hetero_chunk_runner`` is the hetero
solver's runner over it. A CUDA tensor never reaches a plain version: the
kernel runs or the call raises. ``fused_chunk.launches``,
``fused_chunk_batched.launches`` and ``fused_chunk_hetero.launches`` count
kernel launches, through ``core.graphs.on_launch``: a launch captured in a
check window's CUDA graph counts once per replay.

The TPU batched kernels' tile searches (``batch_tile_rows``,
``hetero_tile_rows``, ``aligned_divisor``) and the unroll switch
(``RELUQP_BATCH_UNROLL``) size Mosaic's VMEM tiles and loop lowering; they
have no counterpart here: K4 and K5 pick their own launch shapes
(``batched_plan``, ``hetero_plan``) and run any B and any Dp.

Layout contract (prepared by the solver at setup):
  - the bank stores Wᵀ padded to lane-aligned Dp (multiple of 128), so one
    iteration is a row-vector product ``y(R,Dp) @ Wt(Dp,Dp)``;
  - b/lo/hi/y are (R, Dp) with b=0, lo=−inf, hi=+inf in the padding, which
    keeps padded lanes at exactly 0 through every iteration;
  - the rung index ``rho_ind`` (K1, K4) or the (B,) rung vector
    ``rho_inds`` (K5) is a device int32 tensor (the kernel reads it on the
    device; nothing syncs to learn it, and K5 indexes the bank itself, so
    no gathered (B, Dp, Dp) copy is made).

Precision tiers (``iter_precision``):
  - "highest": plain fp32 products and sums (no TF32);
  - "high": bf16 hi/lo split of W and y, lo·lo term dropped, three sums;
  - "default"/"bf16": bf16-rounded y and W, fp32 accumulation. A bank
    stored in bf16 always runs this tier.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

from ..core.graphs import on_launch

__all__ = ["LANE", "round_up", "pad_dim", "fused_chunk", "fused_chunk_ref",
           "pallas_chunk_runner", "kernel_plan", "fused_chunk_batched",
           "fused_chunk_batched_ref", "pallas_batched_chunk_runner",
           "batched_plan", "fused_chunk_hetero", "fused_chunk_hetero_ref",
           "pallas_hetero_chunk_runner", "hetero_plan"]

LANE = 128

_TIER = {"highest": 0, "high": 1, "default": 2, "bf16": 2}
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(d: int) -> int:
    """Lane-aligned padded stacked dimension."""
    return round_up(max(d, LANE), LANE)


def device_guard(dev: torch.device):
    """Make the card ``dev`` current around a launch on its tensors, so the
    kernel's plan (``cudaGetDevice``) and stream are that card's; no
    device switch where it is current already (the common case: one
    process per card)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _bf16(t: torch.Tensor, dtype) -> torch.Tensor:
    """Round to bf16 and return in ``dtype``."""
    return t.to(torch.bfloat16).to(dtype)


def _rung(wt_bank: torch.Tensor, rho_ind) -> torch.Tensor:
    idx = torch.as_tensor(rho_ind, dtype=torch.int32,
                          device=wt_bank.device).reshape(1)
    return wt_bank.index_select(0, idx)[0]


def fused_chunk_ref(wt_bank, b, lo, hi, y, rho_ind, n_steps: int,
                    iter_precision: str = "highest"):
    """Plain torch version of K1: what the kernel computes.

    ``wt_bank`` (N, Dp, Dp); ``b, lo, hi, y`` (R, Dp) or (Dp,);
    ``rho_ind`` an int or an int tensor. Returns a new tensor.
    """
    if iter_precision not in _TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")
    return _iterate(_rung(wt_bank, rho_ind), b, lo, hi, y, n_steps,
                    iter_precision)


def _iterate(w, b, lo, hi, y, n_steps: int, iter_precision: str):
    """``n_steps`` of ``y ← clip(y @ w + b, lo, hi)`` at the tier; ``w``
    (Dp, Dp), or (B, Dp, Dp) against (B, 1, Dp) rows."""
    dt = y.dtype
    bf16_in = _TIER[iter_precision] == 2 or w.dtype == torch.bfloat16
    high = iter_precision == "high" and not bf16_in
    if bf16_in:
        wq = _bf16(w, dt)
    elif high:
        w = w.to(dt)
        w_h = _bf16(w, dt)
        w_l = _bf16(w - w_h, dt)
    for _ in range(n_steps):
        if bf16_in:
            yw = _bf16(y, dt) @ wq
        elif high:
            y_h = _bf16(y, dt)
            y_l = _bf16(y - y_h, dt)
            yw = (y_h @ w_l + y_l @ w_h) + y_h @ w_h
        else:
            yw = y @ w
        y = torch.minimum(torch.maximum(yw + b, lo), hi)
    return y.clone() if n_steps == 0 else y


def _lib():
    from .cuda_build import load
    lib = load("fused_step")
    if not getattr(lib, "_k1_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k1_fused_chunk.argtypes = [vp, i, i, vp, vp, vp, vp, vp, vp, i,
                                       i, i, i, i, vp]
        lib.k1_fused_chunk.restype = i
        lib.k1_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)] * 10
        lib.k1_plan.restype = i
        lib.k1_error_string.argtypes = [i]
        lib.k1_error_string.restype = ctypes.c_char_p
        lib._k1_typed = True
    return lib


def _raise_cuda(lib, code: int, what: str):
    msg = lib.k1_error_string(code).decode()
    raise RuntimeError(f"K1 {what} failed: CUDA error {code} ({msg})")


def kernel_plan(rows: int, dp: int, dtype=torch.float32, w_dtype=None, *,
                n_steps: int = 25, iter_precision: str = "highest",
                device=None) -> dict:
    """The launch shape of K1 on the current GPU for a window of
    ``n_steps``: one thread-block cluster of ``cluster`` blocks per row
    (``blocks`` in all), output columns and threads per block, dynamic
    shared memory per block, where each block's column slab of the rung
    lives (``slab``: "smem", "registers", "L2" or a split such as
    "smem+registers": ``smem_rows`` rows in shared memory, then
    ``regs_rows`` rows per lane in registers, the rest read from L2 every
    iteration), the contraction's stretches (lanes per column group), how
    many clusters the card holds at once, and the grid barriers a window
    crosses (0). ``direct``: a one-iteration window on independent blocks
    (no cluster, no exchange). ``device``: the GPU to plan for (default
    the current one)."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(10)]
    with torch.cuda.device(device):
        rc = lib.k1_plan(rows, dp, int(n_steps), _DTYPE_CODE[dtype],
                         _DTYPE_CODE[w_dtype or dtype], _TIER[iter_precision],
                         *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _raise_cuda(lib, rc, "plan")
    (cluster, cw, threads, smem, _, smem_rows, rr, ks, direct,
     max_clusters) = (v.value for v in vals)
    l2_rows = max(0, dp - smem_rows - rr * ks)
    slab = "+".join(name for name, n in (("smem", smem_rows),
                                         ("registers", rr), ("L2", l2_rows))
                    if n)
    return {"cluster": cluster, "blocks": rows * cluster,
            "cols_per_block": cw, "threads": threads, "smem_bytes": smem,
            "slab": slab, "smem_rows": smem_rows, "regs_rows": rr,
            "stretches": ks, "direct": bool(direct),
            "max_clusters": max_clusters, "grid_barriers_per_window": 0}


def _check_chunk_args(kname, wt_bank, b, lo, hi, y, rho_ind,
                      iter_precision):
    """What K1 and K4 take: contiguous tensors on y's device, (R, Dp)
    float32/float64 rows, a (N, Dp, Dp) bank of y's dtype (or bf16 under
    fp32), one int32 rung element."""
    dev = y.device
    ts = {"wt_bank": wt_bank, "b": b, "lo": lo, "hi": hi, "y": y,
          "rho_ind": rho_ind}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"{kname}: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kname}: {name} must be contiguous")
    if y.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{kname}: state dtype {y.dtype} is not "
                         "float32/float64")
    for name in ("b", "lo", "hi"):
        if ts[name].dtype != y.dtype or ts[name].shape != y.shape:
            raise ValueError(f"{kname}: {name} must match y's dtype and "
                             "shape")
    if y.dim() != 2 or wt_bank.dim() != 3:
        raise ValueError(f"{kname}: y must be (R, Dp) and wt_bank "
                         "(N, Dp, Dp)")
    dp = y.shape[1]
    if wt_bank.shape[1:] != (dp, dp):
        raise ValueError(f"{kname}: wt_bank {tuple(wt_bank.shape)} does not "
                         f"match Dp={dp}")
    w_ok = wt_bank.dtype == y.dtype or (wt_bank.dtype == torch.bfloat16
                                        and y.dtype == torch.float32)
    if not w_ok:
        raise ValueError(f"{kname}: bank dtype {wt_bank.dtype} with state "
                         f"dtype {y.dtype} is not supported")
    if rho_ind.dtype != torch.int32 or rho_ind.numel() != 1:
        raise ValueError(f"{kname}: rho_ind must be one int32 element")
    if iter_precision not in _TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")


def _fused_chunk_cuda(wt_bank, b, lo, hi, y, rho_ind, n_steps,
                      iter_precision):
    dev = y.device
    _check_chunk_args("K1", wt_bank, b, lo, hi, y, rho_ind, iter_precision)
    rows, dp = y.shape
    if dp % (16 // y.element_size()):
        raise ValueError(f"K1: Dp={dp} is not a whole number of 16-byte "
                         "groups")
    if wt_bank.data_ptr() % 16:
        raise ValueError("K1: wt_bank must start on a 16-byte boundary")
    if n_steps == 0:
        return y.clone()
    if y.data_ptr() % 16:
        y = y.clone()   # the kernel reads y 16 bytes at a time
    lib = _lib()
    out = torch.empty_like(y)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.k1_fused_chunk(
        wt_bank.data_ptr(), _DTYPE_CODE[wt_bank.dtype], wt_bank.shape[0],
        b.data_ptr(), lo.data_ptr(), hi.data_ptr(), y.data_ptr(),
        out.data_ptr(), rho_ind.data_ptr(), rows, dp, int(n_steps),
        _TIER[iter_precision], _DTYPE_CODE[y.dtype], stream)
    if rc != 0:
        _raise_cuda(lib, rc, "launch")
    on_launch(_count_fused_chunk)
    return out


def fused_chunk(wt_bank, b, lo, hi, y, rho_ind, n_steps: int,
                iter_precision: str = "highest"):
    """Run ``n_steps`` iterations against bank rung ``rho_ind``.

    Args:
      wt_bank: (N_rho, Dp, Dp) transposed padded weight bank.
      b, lo, hi, y: (R, Dp) state/clamp rows.
      rho_ind: int32 tensor with one element, on y's device.
    CUDA tensors launch the CUDA kernel (or raise); CPU tensors run
    ``fused_chunk_ref``.
    """
    if y.is_cuda:
        with device_guard(y.device):
            return _fused_chunk_cuda(wt_bank, b, lo, hi, y, rho_ind, n_steps,
                                     iter_precision)
    return fused_chunk_ref(wt_bank, b, lo, hi, y, rho_ind, n_steps,
                           iter_precision)


fused_chunk.launches = 0


def _count_fused_chunk():
    fused_chunk.launches += 1


def pallas_chunk_runner(W_bank, b_bank, rho_ind, lo, hi, y, n_steps: int,
                        iter_precision: str = "highest"):
    """``ChunkRunner`` adapter for ``core.iteration.solve_loop`` (K1).

    ``W_bank`` is the transposed padded bank (N, Dp, Dp) and ``b_bank``
    (N, Dp); ``lo``/``hi``/``y`` are (Dp,); ``rho_ind`` is a 0-d int32
    tensor on the state's device.
    """
    b = b_bank.index_select(0, rho_ind.reshape(1))
    out = fused_chunk(W_bank, b, lo.reshape(1, -1), hi.reshape(1, -1),
                      y.reshape(1, -1), rho_ind, n_steps, iter_precision)
    return out.reshape(-1)


# --------------------------------------------------------------------- #
# K4: the batched chunk, (B, Dp) rows sharing one rung                   #
# --------------------------------------------------------------------- #

def fused_chunk_batched_ref(wt_bank, b, lo, hi, Y, rho_ind, n_steps: int,
                            iter_precision: str = "highest"):
    """Plain torch version of K4: what the kernel computes. Each row of
    ``Y`` (B, Dp) runs K1's arithmetic (``fused_chunk_ref``) against the
    one shared rung ``rho_ind``, with its own ``b``/``lo``/``hi`` row.
    Returns a new tensor."""
    if Y.dim() != 2:
        raise ValueError("K4: Y must be (B, Dp)")
    return fused_chunk_ref(wt_bank, b, lo, hi, Y, rho_ind, n_steps,
                           iter_precision)


def _k4_lib():
    from .cuda_build import load
    lib = load("fused_step_batched")
    if not getattr(lib, "_k4_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k4_fused_chunk_batched.argtypes = [vp, i, i, vp, vp, vp, vp, vp,
                                               vp, i, i, i, i, i, vp]
        lib.k4_fused_chunk_batched.restype = i
        lib.k4_plan.argtypes = [i, i, i, i, i] + [ctypes.POINTER(i)] * 8
        lib.k4_plan.restype = i
        lib.k4_error_string.argtypes = [i]
        lib.k4_error_string.restype = ctypes.c_char_p
        lib._k4_typed = True
    return lib


def _k4_raise(lib, code: int, what: str):
    msg = lib.k4_error_string(code).decode()
    raise RuntimeError(f"K4 {what} failed: CUDA error {code} ({msg})")


def batched_plan(rows: int, dp: int, dtype=torch.float32, w_dtype=None,
                 iter_precision: str = "highest", device=None) -> dict:
    """The launch shape of K4 on the current GPU: its ``regime`` ("tile":
    one block per row tile holding the whole rung, where the rung and the
    smallest tile fit one block's shared memory, decided by Dp, the dtypes
    and the tier alone; else "cluster": a thread-block cluster per row tile,
    one column slab of the rung per block), blocks, threads per block, rows
    per tile (from B in both), dynamic shared memory per block, blocks per
    cluster (1 in the tile regime), whether a block holds its slab in shared
    memory (else it reads it from L2 every iteration), and how many such
    clusters (tile regime: blocks) the card holds at once, on ``device``
    (default the current GPU)."""
    lib = _k4_lib()
    vals = [ctypes.c_int() for _ in range(8)]
    with torch.cuda.device(device):
        rc = lib.k4_plan(rows, dp, _DTYPE_CODE[dtype],
                         _DTYPE_CODE[w_dtype or dtype], _TIER[iter_precision],
                         *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _k4_raise(lib, rc, "plan")
    plan = dict(zip(("blocks", "rows_per_tile", "smem_bytes", "cluster",
                     "w_in_smem", "max_clusters", "threads", "tile"),
                    (v.value for v in vals)))
    plan["regime"] = "tile" if plan.pop("tile") else "cluster"
    return plan


def _fused_chunk_batched_cuda(wt_bank, b, lo, hi, Y, rho_ind, n_steps,
                              iter_precision):
    _check_chunk_args("K4", wt_bank, b, lo, hi, Y, rho_ind, iter_precision)
    if Y.data_ptr() % 16 or wt_bank.data_ptr() % 16:
        raise ValueError("K4: Y and wt_bank must start on a 16-byte boundary")
    if n_steps == 0:
        return Y.clone()
    rows, dp = Y.shape
    lib = _k4_lib()
    out = torch.empty_like(Y)
    stream = torch.cuda.current_stream(Y.device).cuda_stream
    rc = lib.k4_fused_chunk_batched(
        wt_bank.data_ptr(), _DTYPE_CODE[wt_bank.dtype], wt_bank.shape[0],
        b.data_ptr(), lo.data_ptr(), hi.data_ptr(), Y.data_ptr(),
        out.data_ptr(), rho_ind.data_ptr(), rows, dp, int(n_steps),
        _TIER[iter_precision], _DTYPE_CODE[Y.dtype], stream)
    if rc != 0:
        _k4_raise(lib, rc, "launch")
    on_launch(_count_fused_chunk_batched)
    return out


def fused_chunk_batched(wt_bank, b, lo, hi, Y, rho_ind, n_steps: int,
                        iter_precision: str = "highest"):
    """Run ``n_steps`` iterations of every row of ``Y`` against bank rung
    ``rho_ind``.

    Args:
      wt_bank: (N_rho, Dp, Dp) transposed padded weight bank.
      b, lo, hi, Y: (B, Dp) per-row bias, clamp bounds and states.
      rho_ind: int32 tensor with one element, on Y's device.
    CUDA tensors launch kernel K4 (or raise); CPU tensors run
    ``fused_chunk_batched_ref``.
    """
    if Y.is_cuda:
        with device_guard(Y.device):
            return _fused_chunk_batched_cuda(wt_bank, b, lo, hi, Y, rho_ind,
                                             n_steps, iter_precision)
    return fused_chunk_batched_ref(wt_bank, b, lo, hi, Y, rho_ind, n_steps,
                                   iter_precision)


fused_chunk_batched.launches = 0


def _count_fused_chunk_batched():
    fused_chunk_batched.launches += 1


def pallas_batched_chunk_runner(Wt_bank, bias_all, rho_ind, lo, hi, Y,
                                n_steps: int,
                                iter_precision: str = "highest"):
    """Shared-ρ batched ``ChunkRunner`` of ``core.batched`` (K4).

    ``Wt_bank`` (N, Dp, Dp) transposed padded, ``bias_all`` (N, B, Dp) —
    only the current rung's row is read —, ``lo``/``hi``/``Y`` (B, Dp);
    ``rho_ind`` a 0-d int32 tensor on the state's device.
    """
    b = bias_all.index_select(0, rho_ind.reshape(1))[0]
    return fused_chunk_batched(Wt_bank, b, lo, hi, Y, rho_ind, n_steps,
                               iter_precision)


# --------------------------------------------------------------------- #
# K5: the heterogeneous chunk, row i against rung rho_inds[i] of bank[i] #
# --------------------------------------------------------------------- #

def fused_chunk_hetero_ref(wt_bank, b, lo, hi, Y, rho_inds, n_steps: int,
                           iter_precision: str = "highest"):
    """Plain torch version of K5: what the kernel computes. Row i of ``Y``
    (B, Dp) runs K1's arithmetic against ``wt_bank[i, rho_inds[i]]``
    (``wt_bank`` (B, N, Dp, Dp), ``rho_inds`` (B,) ints) with its own
    ``b``/``lo``/``hi`` row. Returns a new tensor."""
    if iter_precision not in _TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")
    if Y.dim() != 2 or wt_bank.dim() != 4:
        raise ValueError("K5: Y must be (B, Dp) and wt_bank (B, N, Dp, Dp)")
    B = Y.shape[0]
    idx = torch.as_tensor(rho_inds, device=wt_bank.device).long()
    idx = idx.clamp(0, wt_bank.shape[1] - 1)   # as the kernel clamps
    w = wt_bank[torch.arange(B, device=wt_bank.device), idx]
    row = lambda t: t[:, None, :]
    return _iterate(w, row(b), row(lo), row(hi), row(Y), n_steps,
                    iter_precision)[:, 0, :]


def _k5_lib():
    from .cuda_build import load
    lib = load("fused_step_hetero")
    if not getattr(lib, "_k5_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.k5_fused_chunk_hetero.argtypes = [vp, i, i, vp, vp, vp, vp, vp,
                                              vp, i, i, i, i, i, vp]
        lib.k5_fused_chunk_hetero.restype = i
        lib.k5_plan.argtypes = [i, i, i, i, i] + [ctypes.POINTER(i)] * 8
        lib.k5_plan.restype = i
        lib.k5_error_string.argtypes = [i]
        lib.k5_error_string.restype = ctypes.c_char_p
        lib._k5_typed = True
    return lib


def _k5_raise(lib, code: int, what: str):
    msg = lib.k5_error_string(code).decode()
    raise RuntimeError(f"K5 {what} failed: CUDA error {code} ({msg})")


def hetero_plan(dp: int, rows: int, dtype=torch.float32, w_dtype=None,
                iter_precision: str = "highest", device=None) -> dict:
    """The launch shape of K5 on the current GPU for ``rows`` problems at
    Dp: blocks per problem (the cluster over which a rung's column slabs
    are spread: the smallest whose slabs fit shared memory, doubled while
    rows × cluster still fit the card's SMs), output columns per block,
    dynamic shared memory per block, whether a block holds its slab in
    shared memory (else in registers, ``regs_rows`` rows per lane, or read
    from L2 every iteration), how many problems the card holds at once, the
    contraction's stretches (the lanes that share a column group) and the
    threads per block. A launch has rows × cluster blocks. ``device``: the
    GPU to plan for (default the current one)."""
    lib = _k5_lib()
    vals = [ctypes.c_int() for _ in range(8)]
    with torch.cuda.device(device):
        rc = lib.k5_plan(dp, rows, _DTYPE_CODE[dtype],
                         _DTYPE_CODE[w_dtype or dtype], _TIER[iter_precision],
                         *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _k5_raise(lib, rc, "plan")
    return dict(zip(("cluster", "cols_per_block", "smem_bytes", "w_in_smem",
                     "max_clusters", "stretches", "threads", "regs_rows"),
                    (v.value for v in vals)))


def _check_hetero_args(wt_bank, b, lo, hi, Y, rho_inds, iter_precision):
    """What K5 takes: contiguous tensors on Y's device starting on 16-byte
    boundaries, (B, Dp) float32/float64 rows, a (B, N, Dp, Dp) bank of Y's
    dtype (or bf16 under fp32), a (B,) int32 rung vector."""
    dev = Y.device
    ts = {"wt_bank": wt_bank, "b": b, "lo": lo, "hi": hi, "Y": Y,
          "rho_inds": rho_inds}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"K5: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"K5: {name} must be contiguous")
    if Y.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K5: state dtype {Y.dtype} is not float32/float64")
    if Y.dim() != 2 or wt_bank.dim() != 4:
        raise ValueError("K5: Y must be (B, Dp) and wt_bank (B, N, Dp, Dp)")
    B, dp = Y.shape
    for name in ("b", "lo", "hi"):
        if ts[name].dtype != Y.dtype or ts[name].shape != Y.shape:
            raise ValueError(f"K5: {name} must match Y's dtype and shape")
    if wt_bank.shape[0] != B or wt_bank.shape[2:] != (dp, dp):
        raise ValueError(f"K5: wt_bank {tuple(wt_bank.shape)} does not match "
                         f"B={B}, Dp={dp}")
    w_ok = wt_bank.dtype == Y.dtype or (wt_bank.dtype == torch.bfloat16
                                        and Y.dtype == torch.float32)
    if not w_ok:
        raise ValueError(f"K5: bank dtype {wt_bank.dtype} with state dtype "
                         f"{Y.dtype} is not supported")
    if rho_inds.dtype != torch.int32 or rho_inds.shape != (B,):
        raise ValueError("K5: rho_inds must be a (B,) int32 tensor")
    if dp % (16 // Y.element_size()):
        raise ValueError(f"K5: Dp={dp} is not a whole number of 16-byte "
                         "groups")
    if any(t.data_ptr() % 16 for t in (wt_bank, Y)):
        raise ValueError("K5: Y and wt_bank must start on a 16-byte boundary")
    if iter_precision not in _TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")


def _fused_chunk_hetero_cuda(wt_bank, b, lo, hi, Y, rho_inds, n_steps,
                             iter_precision):
    _check_hetero_args(wt_bank, b, lo, hi, Y, rho_inds, iter_precision)
    if n_steps == 0 or Y.shape[0] == 0:
        return Y.clone()
    rows, dp = Y.shape
    lib = _k5_lib()
    out = torch.empty_like(Y)
    stream = torch.cuda.current_stream(Y.device).cuda_stream
    rc = lib.k5_fused_chunk_hetero(
        wt_bank.data_ptr(), _DTYPE_CODE[wt_bank.dtype], wt_bank.shape[1],
        rho_inds.data_ptr(), b.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        Y.data_ptr(), out.data_ptr(), rows, dp, int(n_steps),
        _TIER[iter_precision], _DTYPE_CODE[Y.dtype], stream)
    if rc != 0:
        _k5_raise(lib, rc, "launch")
    on_launch(_count_fused_chunk_hetero)
    return out


def fused_chunk_hetero(wt_bank, b, lo, hi, Y, rho_inds, n_steps: int,
                       iter_precision: str = "highest"):
    """Run ``n_steps`` iterations of every row of ``Y``, row i against rung
    ``rho_inds[i]`` of its own ladder ``wt_bank[i]``.

    Args:
      wt_bank: (B, N_rho, Dp, Dp) per-problem transposed padded banks.
      b, lo, hi, Y: (B, Dp) per-row bias (at each row's rung), clamp bounds
        and states.
      rho_inds: (B,) int32 tensor on Y's device.
    CUDA tensors launch kernel K5 (or raise); CPU tensors run
    ``fused_chunk_hetero_ref``.
    """
    if Y.is_cuda:
        with device_guard(Y.device):
            return _fused_chunk_hetero_cuda(wt_bank, b, lo, hi, Y, rho_inds,
                                            n_steps, iter_precision)
    return fused_chunk_hetero_ref(wt_bank, b, lo, hi, Y, rho_inds, n_steps,
                                  iter_precision)


fused_chunk_hetero.launches = 0


def _count_fused_chunk_hetero():
    fused_chunk_hetero.launches += 1


def pallas_hetero_chunk_runner(Wt_bank, bias_bank, rho_inds, lo, hi, Y,
                               n_steps: int,
                               iter_precision: str = "highest"):
    """Hetero ``ChunkRunner`` of ``core.batched.solve_batched_hetero`` (K5).

    ``Wt_bank`` (B, N, Dp, Dp) transposed padded, ``bias_bank`` (B, N, Dp)
    — only each row's current-rung bias is gathered, (B, Dp) —,
    ``lo``/``hi``/``Y`` (B, Dp); ``rho_inds`` (B,) int32 on the state's
    device. The kernel indexes the bank at the rungs itself.
    """
    rows = torch.arange(Y.shape[0], device=Y.device)
    b = bias_bank[rows, rho_inds.long()]
    return fused_chunk_hetero(Wt_bank, b, lo, hi, Y, rho_inds, n_steps,
                              iter_precision)
