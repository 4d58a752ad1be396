"""Multi-device solving on ``torch.distributed``, one process per device:
batch-sharded solves with a collective exit (``sharded``) and the
tensor-parallel single QP (``tensor``)."""
from .sharded import (gather_rows, host_replicated, init_distributed,
                      local_axis, make_mesh, mesh_group, process_local_batch,
                      replicate, shard_batch, solve_sharded_shared)
from .tensor import (solve_loop_tp, tp_align, tp_chunk_runner, tp_columns,
                     tp_pad_dim)

__all__ = [
    "make_mesh", "shard_batch", "replicate", "solve_sharded_shared",
    "init_distributed", "process_local_batch", "local_axis",
    "host_replicated", "gather_rows", "mesh_group",
    "solve_loop_tp", "tp_chunk_runner", "tp_pad_dim", "tp_align",
    "tp_columns",
]
