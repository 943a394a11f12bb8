"""The parallel layer: one process per card in a `torch.distributed`
process group in place of the JAX mesh, a (data, model) grid of ranks
(`mesh`), tensor parallelism of the CLIP encoders over its model axis
(`tp`), the multi-process seams of the pipelines, the trainers and the
CLIs (`multihost`), and the request broadcast of serving over ranks
(`mesh.broadcast_request`, used by `serve.fanout`)."""
from dclip_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_grads,
    broadcast_,
    broadcast_request,
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
    "broadcast_request",
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
