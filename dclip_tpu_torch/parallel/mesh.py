"""The data-parallel layer (counterpart of `dclip_tpu/parallel/mesh.py`).

JAX drives every chip from one process through a `Mesh`, and XLA inserts
the collectives. The port runs one process per card in a
`torch.distributed` process group, so a mesh here is this process's place
on the data axis: its rank, the axis size and the group its collectives run
in. The JAX pieces map as follows.

- `make_mesh(MeshConfig)`: the ranks of the default process group;
  `data_parallel=-1` takes every rank, and `dp * mp` above the world size
  raises JAX's ValueError. Without a process group the mesh is the one-rank
  mesh (`local_mesh()`). One process per card means every rank is on the
  data axis: a smaller `data_parallel` raises too. `model_parallel > 1`
  (tensor parallelism) raises NotImplementedError: ROADMAP Queue 1 item 13.
- `batch_sharding` / `shard_batch`: `shard_batch` cuts this rank's rows
  [r n / N, (r + 1) n / N) out of a global batch.
- `replicate_tree`: `broadcast_`, rank 0's tensors to every rank, as DDP
  does at construction: no rank trains from its own initial weights.
- `pad_batch_to`: the same function.
- `shard_map_batchwise`: nothing to write, each rank runs its kernels on
  its own rows.

The collectives follow one rule for gradients: every rank computes the same
global loss and differentiates it with respect to its own inputs only
(`gather_rows` slices its rows out of the cotangent, `sum_across_ranks`
passes the cotangent through), so the gradient of the global loss is the
sum over ranks of the ranks' gradients: `all_reduce_grads` sums them in
f32. A one-rank mesh without a group runs no collective (each is the
identity); a group of one rank (the card machine's NCCL group) runs them,
and they copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

from dclip_tpu_torch.core.config import MeshConfig

TP_WAITS = "ROADMAP Queue 1 item 13"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the data axis. `group` is None for the
    one-rank mesh without a process group (no collective runs)."""

    size: int = 1
    rank: int = 0
    group: Any = None
    data_axis: str = "data"
    model_axis: str = "model"

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data_axis: self.size, self.model_axis: 1}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of n (n a multiple of the size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def local_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The one-rank mesh: no process group, every collective the identity."""
    cfg = cfg or MeshConfig()
    return Mesh(data_axis=cfg.data_axis, model_axis=cfg.model_axis)


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The data axis over the default process group (module docstring)."""
    import torch.distributed as dist

    cfg = cfg or MeshConfig()
    n = _world()
    mp = max(cfg.model_parallel, 1)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp < 1 or dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs {max(dp, 1) * mp} devices, have {n}")
    if mp > 1:
        raise NotImplementedError(
            f"mesh {dp}x{mp}: tensor parallelism (model_parallel > 1) is not ported yet: "
            f"{TP_WAITS}")
    if dp < n:
        raise ValueError(f"mesh {dp}x{mp} uses {dp} of {n} ranks: one process per card, so "
                         "every rank of the process group is on the data axis")
    if not (dist.is_available() and dist.is_initialized()):
        return local_mesh(cfg)
    return Mesh(size=n, rank=dist.get_rank(), group=dist.group.WORLD,
                data_axis=cfg.data_axis, model_axis=cfg.model_axis)


def make_multislice_mesh(cfg: Optional[MeshConfig] = None, *args, **kwargs) -> Mesh:
    """JAX's hybrid ICI / DCN mesh (`mesh.py:57`): waits with tensor
    parallelism."""
    raise NotImplementedError(f"make_multislice_mesh is not ported yet: {TP_WAITS}")


def collective_device(mesh: Mesh) -> torch.device:
    """Where the group's collectives take their tensors: the current card
    under NCCL, else the CPU (gloo)."""
    import torch.distributed as dist

    if mesh.group is not None and dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts, dim)


class _GatherRows(torch.autograd.Function):
    """All-gather along rows; the backward keeps this rank's rows of the
    cotangent (the other ranks differentiate their own)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.lo, ctx.rows = mesh.rank * x.shape[0], x.shape[0]
        return _all_gather(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.lo:ctx.lo + ctx.rows], None


class _SumAcrossRanks(torch.autograd.Function):
    """All-reduce sum; the backward passes the cotangent through to this
    rank's own term."""

    @staticmethod
    def forward(ctx, x, mesh):
        import torch.distributed as dist

        out = x.clone()
        dist.all_reduce(out, group=mesh.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """[B_local, ...] on every rank -> [size * B_local, ...] in rank order,
    differentiable by the rule of the module docstring. Every rank must
    hold the same number of rows."""
    if mesh.group is None:
        return x
    return _GatherRows.apply(x, mesh)


def gather_cat(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """All-gather concatenated along `dim`, in rank order, no gradient."""
    if mesh.group is None:
        return x
    return _all_gather(x, mesh, dim)


def sum_across_ranks(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum over ranks (JAX's psum), differentiable by the module's rule."""
    if mesh.group is None:
        return x
    return _SumAcrossRanks.apply(x, mesh)


@torch.no_grad()
def all_reduce_grads(params: Sequence[torch.nn.Parameter], mesh: Mesh) -> None:
    """Sum the parameters' gradients over ranks in one f32 all-reduce of
    their concatenation (a missing `.grad` counts as zeros: the optimizer
    reads it so too), written back as `.grad`. Every rank ends with the
    same bits."""
    if mesh.group is None or not params:
        return
    import torch.distributed as dist

    flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                      .reshape(-1).float() for p in params])
    dist.all_reduce(flat, group=mesh.group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view(p.shape).to(p.dtype)
        offset += n


@torch.no_grad()
def broadcast_(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Overwrite every rank's tensors with rank 0's, one at a time in the
    given order (JAX's `replicate_tree`)."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)


def shard_batch(batch, mesh: Mesh) -> dict:
    """This rank's rows of every array in a global (dataclass or dict)
    batch; the batch size must divide by the mesh size."""
    d = batch.as_dict() if hasattr(batch, "as_dict") else dict(batch)
    out = {}
    for k, v in d.items():
        if v is None:
            out[k] = v
            continue
        lo, hi = mesh.rows(len(v))
        out[k] = v[lo:hi]
    return out


def pad_batch_to(batch_dict: dict, multiple: int) -> tuple:
    """Pad the leading dim to a multiple of the mesh data size by repeating
    row 0; returns (padded dict, valid count)."""
    import numpy as np

    n = next(iter(batch_dict.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch_dict, n
    return {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
            for k, v in batch_dict.items()}, n
