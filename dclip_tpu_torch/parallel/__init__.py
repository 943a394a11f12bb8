"""The parallel layer: one process per card in a `torch.distributed`
process group in place of the JAX mesh, a (data, model) grid of ranks
(`mesh`), tensor parallelism of the CLIP encoders over its model axis
(`tp`), and the multi-process seams of the pipelines, the trainers and the
CLIs (`multihost`). Serving over ranks waits (ROADMAP Queue 1 item 13)."""
from dclip_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    broadcast_,
    gather_cat,
    gather_rows,
    local_mesh,
    make_mesh,
    make_multislice_mesh,
    multislice_grid,
    pad_batch_to,
    shard_batch,
    sum_across_ranks,
)

__all__ = [
    "Mesh",
    "all_reduce_grads",
    "broadcast_",
    "gather_cat",
    "gather_rows",
    "local_mesh",
    "make_mesh",
    "make_multislice_mesh",
    "multislice_grid",
    "pad_batch_to",
    "shard_batch",
    "sum_across_ranks",
]
