"""Batch-sharded solving over ``torch.distributed``: one process per device.

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` over the whole
process group, its one dimension named like the JAX package's mesh axis
(``"qp"`` for the batch, ``"tp"`` for the tensor-parallel bank). Every
process drives one device: its rows of the batch (or its column block of a
bank) live there, and the solve loop runs the per-device kernel on them
(K4 for a shared-(H, A) batch, K5 for a heterogeneous one). The loop's
convergence exit is a collective: the window's open count (and, walking
one shared rung, the ρ statistics) is all-reduced on the device before the
window's one device→host read, so every rank takes the same rung decisions
and leaves the loop together (``core.batched``).

Multi-process start-up: every process calls ``init_distributed`` (a wrapper
over ``torch.distributed.init_process_group``, NCCL on ``cuda`` and gloo on
the CPU, that also selects the process's GPU), then ``make_mesh``. Under
``torchrun`` the rank, world size and address come from its environment.
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.batched import BatchSolveResult, solve_batched_shared

__all__ = [
    "make_mesh",
    "shard_batch",
    "replicate",
    "solve_sharded_shared",
    "init_distributed",
    "process_local_batch",
    "local_axis",
    "host_replicated",
    "gather_rows",
    "mesh_group",
]

# How long a collective (and the rendezvous) may wait before it fails: a
# rank that died or never came leaves the others waiting on it.
DEFAULT_TIMEOUT = timedelta(seconds=60)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: Optional[str] = None,
                     timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join this process to the process group, once, before any mesh.

    ``coordinator_address`` is the rendezvous (``"host:port"`` or a full
    ``tcp://`` URL); ``num_processes`` the world size and ``process_id``
    this process's rank. Left out, they come from ``torchrun``'s
    environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). The backend is NCCL where CUDA is available, else gloo;
    ``timeout`` bounds the rendezvous and every collective. On CUDA the
    process's GPU becomes ``LOCAL_RANK`` where ``torchrun`` sets it, else
    the rank modulo the visible GPUs, so every kernel launch and every NCCL call of
    this process goes to its own card.

    A single process with no rendezvous address is a no-op (returns False),
    as in the JAX package; given an address, one process forms a group of
    one, which a one-device mesh needs. Returns True when a group was
    formed.
    """
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if num_processes is None or (num_processes <= 1
                                 and coordinator_address is None):
        return False
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    return True


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "qp",
              device=None):
    """A 1-D ``DeviceMesh`` over every process of the group, its dimension
    named ``axis_name``: one device per process, on ``cuda`` unless
    ``device`` says ``"cpu"``. Raises when the process group is not
    initialised (``init_distributed``) or when ``n_devices`` is not the
    world size (each process drives exactly one device)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call init_distributed first (one process per "
                           "device)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"a mesh spans one device per process: n_devices="
                         f"{n_devices} but the group has {world} processes")
    dev_type = torch.device("cuda" if device is None else device).type
    return init_device_mesh(dev_type, (world,), mesh_dim_names=(axis_name,))


def mesh_group(mesh, axis_name: str):
    """``(group, rank, size, device)`` of a 1-D mesh along ``axis_name``:
    the process group of its collectives, this process's rank in it, the
    number of ranks and the torch device this process drives."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a torch.distributed DeviceMesh "
                        f"(make_mesh), got {type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if mesh.ndim != 1 or axis_name not in names:
        raise ValueError(f"mesh {names} has no axis {axis_name!r} (a 1-D "
                         "mesh named after it is needed)")
    group = mesh.get_group(axis_name)
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return group, dist.get_rank(group), dist.get_world_size(group), device


def _rows(n: int, size: int, rank: int) -> slice:
    if n % size != 0:
        raise ValueError(f"batch {n} not divisible by mesh axis {size} — "
                         "pad the batch (inert rows: lo=-inf, hi=+inf)")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(arr, mesh, axis_name: str = "qp"):
    """This process's rows of a global batch-led ``arr`` (leading axis
    split evenly over the mesh, in rank order), on its device."""
    _, rank, size, device = mesh_group(mesh, axis_name)
    t = torch.as_tensor(arr)
    return t[_rows(t.shape[0], size, rank)].to(device)


def replicate(arr, mesh, axis_name: Optional[str] = None):
    """The same tensor on this process's device (every rank holds it)."""
    names = mesh.mesh_dim_names or ("qp",)
    _, _, _, device = mesh_group(mesh, axis_name or names[0])
    return torch.as_tensor(arr).to(device)


def gather_rows(local: torch.Tensor, group, axis: int = 0) -> torch.Tensor:
    """Every rank's ``local`` (equal shapes) joined along ``axis`` in rank
    order, on every rank: one all-gather."""
    size = dist.get_world_size(group)
    if size == 1:
        return local
    t = local.movedim(axis, 0).contiguous()
    out = torch.empty((size * t.shape[0],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    gather_into(out, t, group)
    return out.movedim(0, axis)


def gather_into(out: torch.Tensor, t: torch.Tensor, group) -> None:
    """``out`` ← every rank's ``t`` stacked along dim 0 in rank order."""
    dist.all_gather_into_tensor(out, t, group=group)


def process_local_batch(global_shape, mesh, local_np,
                        axis_name: str = "qp") -> torch.Tensor:
    """The global batch from every process's rows (``local_np`` this
    process's, equal sizes, rank order): one all-gather, on this process's
    device. ``global_shape`` is checked against what the ranks hold."""
    group, _, size, device = mesh_group(mesh, axis_name)
    local = torch.as_tensor(np.asarray(local_np)).to(device)
    want = tuple(int(s) for s in global_shape)
    if (size * local.shape[0],) + tuple(local.shape[1:]) != want:
        raise ValueError(f"{size} ranks of {tuple(local.shape)} rows do not "
                         f"make the global shape {want}")
    return gather_rows(local, group)


def local_axis(arr, mesh, axis: int = 0, axis_name: str = "qp"):
    """Host copy of THIS process's part of a global ``arr`` along ``axis``
    (rank order), the inverse of ``process_local_batch``."""
    _, rank, size, _ = mesh_group(mesh, axis_name)
    a = (arr.detach().cpu().numpy() if isinstance(arr, torch.Tensor)
         else np.asarray(arr))
    sl = [slice(None)] * a.ndim
    sl[axis] = _rows(a.shape[axis], size, rank)
    return a[tuple(sl)].copy()


def host_replicated(a) -> np.ndarray:
    """Host copy of a replicated tensor (every rank holds the full value)."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.detach().cpu().numpy()
    return np.asarray(a)


def solve_sharded_shared(mesh, Wt_bank, bias_all, rhos, H, A, G, lo, hi,
                         Y0, rho_ind0, *, done0=None, Wt_bank_hi=None,
                         rho_eff=None, w_pri=None, w_dua=None,
                         axis_name: str = "qp", rho_mode: str = "shared",
                         chunk_runner=None, **solve_kw) -> BatchSolveResult:
    """This process's rows of a shared-(H, A) batch, solved with a
    collective exit.

    The bank, ``rhos``, ``H``, ``A`` (and ``Wt_bank_hi``, ``rho_eff``,
    1-D ``w_pri``/``w_dua``) are replicated: every rank passes the same.
    ``G``, ``lo``, ``hi``, ``Y0`` (and ``done0``, ``rho_ind0`` in
    per-problem mode, 2-D weights) are this rank's rows, ``bias_all``
    (N_rho, rows, Dp) its rows on axis 1; every rank must hold the same
    number of rows (the global batch divides by the mesh), which one
    all-gather of the row counts checks before the loop. ``chunk_runner``
    as ``core.batched.solve_batched_shared`` (K4's runner on the padded
    layout). Returns this rank's rows of the result; every rank ran the
    same windows and, in shared mode, ends on the same rung. The result
    bundle is left unread, for the caller's one read: ``out[:2]`` holds
    the iterations run and those at reduced precision (``n_iter_total``
    and ``n_iter_fast`` are None)."""
    group, _, size, device = mesh_group(mesh, axis_name)
    n = torch.tensor([Y0.shape[0]], dtype=torch.int64, device=device)
    counts = gather_rows(n, group)
    if size > 1 and bool((counts != counts[0]).any()):
        total = int(counts.sum())
        raise ValueError(f"batch {total} not divisible by mesh axis {size}: "
                         f"the ranks hold {counts.tolist()} rows — pad the "
                         "batch (inert rows: lo=-inf, hi=+inf)")
    return solve_batched_shared(
        Wt_bank, bias_all, rhos, H, A, G, lo, hi, Y0, rho_ind0, done0,
        Wt_bank_hi, rho_eff, w_pri, w_dua, rho_mode=rho_mode,
        chunk_runner=chunk_runner, group=group, **solve_kw)
