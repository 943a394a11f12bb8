"""Multi-process runtime support (counterpart of
`dclip_tpu/parallel/multihost.py`).

JAX joins processes into one mesh and assembles global arrays from
process-local rows. In the port every process already is one rank that
holds only its own rows, so the seam is thinner:

- `process_data_shard(mesh)` -> (data index, data size) for
  `MultiModalPipeline(shard_index, shard_count)`: the global batch is the
  concatenation of the data ranks' local batches in data order, and the
  ranks of one model group read the same rows; without a mesh, (rank,
  world);
- `allgather_flags(flag)` -> every rank's bool, in rank order (the
  preemption guard's agreement), on the group's collective device.

JAX's `is_primary` is the mesh's (`parallel.mesh.Mesh.is_primary`, global
rank 0 writes checkpoints, metrics and results), and its `local_rows` /
`put_sharded` pair has no counterpart: a rank holds only its own rows.
Without a process group each answer is the one-process one.
"""
from __future__ import annotations

from typing import List

import torch


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def process_data_shard(mesh=None) -> tuple:
    """(shard_index, shard_count) for this process's input pipeline: the
    mesh's data index and size, else the process's rank and the world."""
    import torch.distributed as dist

    if mesh is not None:
        return mesh.rank, mesh.size
    return (dist.get_rank(), dist.get_world_size()) if _initialized() else (0, 1)


def process_count() -> int:
    return process_data_shard()[1]


def allgather_flags(flag: bool) -> List[bool]:
    """Every rank's `flag` in rank order (one [P] gather over the world)."""
    if not _initialized():
        return [bool(flag)]
    from dclip_tpu_torch.parallel.mesh import collective_device, gather_cat, make_mesh

    mesh = make_mesh()
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=collective_device(mesh))
    return [bool(x) for x in gather_cat(t, mesh).cpu().tolist()]
