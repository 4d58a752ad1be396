"""Chunk kernel K1: ``y ← clip(y Wₖᵀ + b, lo, hi)`` × n_steps.

The hot op of every solve. ``fused_chunk`` launches the hand-written CUDA
kernel ``csrc/fused_step.cu`` for CUDA tensors (see its header for the
design) and runs the plain torch version ``fused_chunk_ref`` for CPU
tensors. A CUDA tensor never reaches the plain version: the kernel runs or
the call raises. ``fused_chunk.launches`` counts kernel launches.

Layout contract (prepared by the solver at setup):
  - the bank stores Wᵀ padded to lane-aligned Dp (multiple of 128), so one
    iteration is a row-vector product ``y(R,Dp) @ Wt(Dp,Dp)``;
  - b/lo/hi/y are (R, Dp) with b=0, lo=−inf, hi=+inf in the padding, which
    keeps padded lanes at exactly 0 through every iteration;
  - the rung index ``rho_ind`` is a device int32 tensor (the kernel reads
    it on the device; nothing syncs to learn it).

Precision tiers (``iter_precision``):
  - "highest": plain fp32 products and sums (no TF32);
  - "high": bf16 hi/lo split of W and y, lo·lo term dropped, three sums;
  - "default"/"bf16": bf16-rounded y and W, fp32 accumulation. A bank
    stored in bf16 always runs this tier.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["LANE", "round_up", "pad_dim", "fused_chunk", "fused_chunk_ref",
           "pallas_chunk_runner", "kernel_plan"]

LANE = 128

_TIER = {"highest": 0, "high": 1, "default": 2, "bf16": 2}
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_dim(d: int) -> int:
    """Lane-aligned padded stacked dimension."""
    return round_up(max(d, LANE), LANE)


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
    dt = y.dtype
    w = _rung(wt_bank, rho_ind)
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
        lib.k1_fused_chunk.argtypes = [vp, i, i, vp, vp, vp, vp, vp, vp, vp,
                                       i, i, i, i, i, vp]
        lib.k1_fused_chunk.restype = i
        lib.k1_plan.argtypes = [i, i, i, i] + [ctypes.POINTER(i)] * 4
        lib.k1_plan.restype = i
        lib.k1_error_string.argtypes = [i]
        lib.k1_error_string.restype = ctypes.c_char_p
        lib._k1_typed = True
    return lib


def _raise_cuda(lib, code: int, what: str):
    msg = lib.k1_error_string(code).decode()
    raise RuntimeError(f"K1 {what} failed: CUDA error {code} ({msg})")


def kernel_plan(rows: int, dp: int, dtype=torch.float32,
                w_dtype=None) -> dict:
    """The launch shape of K1 on the current GPU: blocks, output columns
    per block, dynamic shared memory, and whether the W slab is held in
    shared memory (else streamed from L2 every iteration)."""
    lib = _lib()
    vals = [ctypes.c_int() for _ in range(4)]
    rc = lib.k1_plan(rows, dp, _DTYPE_CODE[dtype],
                     _DTYPE_CODE[w_dtype or dtype],
                     *[ctypes.byref(v) for v in vals])
    if rc != 0:
        _raise_cuda(lib, rc, "plan")
    keys = ("blocks", "cols_per_block", "smem_bytes", "w_in_smem")
    return dict(zip(keys, (v.value for v in vals)))


def _fused_chunk_cuda(wt_bank, b, lo, hi, y, rho_ind, n_steps,
                      iter_precision):
    dev = y.device
    ts = {"wt_bank": wt_bank, "b": b, "lo": lo, "hi": hi, "y": y,
          "rho_ind": rho_ind}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor) or t.device != dev:
            raise ValueError(f"K1: {name} must be a tensor on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"K1: {name} must be contiguous")
    if y.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K1: state dtype {y.dtype} is not float32/float64")
    for name in ("b", "lo", "hi"):
        if ts[name].dtype != y.dtype or ts[name].shape != y.shape:
            raise ValueError(f"K1: {name} must match y's dtype and shape")
    if y.dim() != 2 or wt_bank.dim() != 3:
        raise ValueError("K1: y must be (R, Dp) and wt_bank (N, Dp, Dp)")
    rows, dp = y.shape
    if wt_bank.shape[1:] != (dp, dp):
        raise ValueError(f"K1: wt_bank {tuple(wt_bank.shape)} does not "
                         f"match Dp={dp}")
    w_ok = wt_bank.dtype == y.dtype or (wt_bank.dtype == torch.bfloat16
                                        and y.dtype == torch.float32)
    if not w_ok:
        raise ValueError(f"K1: bank dtype {wt_bank.dtype} with state "
                         f"dtype {y.dtype} is not supported")
    if rho_ind.dtype != torch.int32 or rho_ind.numel() != 1:
        raise ValueError("K1: rho_ind must be one int32 element")
    if iter_precision not in _TIER:
        raise ValueError(f"Invalid iter_precision {iter_precision!r}")
    if n_steps == 0:
        return y.clone()
    lib = _lib()
    out = torch.empty_like(y)
    scratch = torch.empty((2, rows, dp), dtype=y.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.k1_fused_chunk(
        wt_bank.data_ptr(), _DTYPE_CODE[wt_bank.dtype], wt_bank.shape[0],
        b.data_ptr(), lo.data_ptr(), hi.data_ptr(), y.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), rho_ind.data_ptr(), rows, dp,
        int(n_steps), _TIER[iter_precision], _DTYPE_CODE[y.dtype], stream)
    if rc != 0:
        _raise_cuda(lib, rc, "launch")
    fused_chunk.launches += 1
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
        return _fused_chunk_cuda(wt_bank, b, lo, hi, y, rho_ind, n_steps,
                                 iter_precision)
    return fused_chunk_ref(wt_bank, b, lo, hi, y, rho_ind, n_steps,
                           iter_precision)


fused_chunk.launches = 0


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
