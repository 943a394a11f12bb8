"""The (data, model) mesh (counterpart of `dclip_tpu/parallel/mesh.py`).

JAX drives every chip from one process through a `Mesh`, and XLA inserts
the collectives. The port runs one process per card in a
`torch.distributed` process group, so a mesh here is this process's place
on a grid of ranks: its index and group on the data axis, its index and
group on the model axis (tensor parallelism, `parallel.tp`), and the whole
grid's group. The JAX pieces map as follows.

- `make_mesh(MeshConfig)`: the ranks of the default process group as a
  `dp x mp` grid in JAX's layout (`np.asarray(ranks).reshape(dp, mp)`):
  rank = data_index * mp + model_index, the model axis the fast one.
  `data_parallel=-1` takes `n // mp`; `dp * mp` above the world size
  raises JAX's ValueError. Without a process group the mesh is the
  one-rank mesh (`local_mesh()`). One process per card means every rank is
  in the grid: a smaller `dp * mp` raises too. Every rank creates every
  data group and every model group, in one order (`dist.new_group` is
  collective); a data-only grid keeps the default group.
- `make_multislice_mesh`: JAX's hybrid grid over slices, a slice being a
  node (torchrun's `LOCAL_WORLD_SIZE`, else the ranks' host names): the
  data axis slice-major, a rank's model partners inside its slice
  (`multislice_grid`, a pure function of the rank list).
- `batch_sharding` / `shard_batch`: `shard_batch` cuts this rank's rows
  [d n / dp, (d + 1) n / dp) out of a global batch by its data index, so
  the ranks of one model group read the same rows.
- `replicate_tree`: `broadcast_`, global rank 0's tensors to every rank of
  the grid, as DDP does at construction: no rank trains from its own
  initial weights.
- `pad_batch_to`: the same function.
- `broadcast_request`: no JAX counterpart. JAX serves every chip from one
  process; here a request reaches rank 0 and the other ranks take it from
  there (`serve.fanout`).
- `shard_map_batchwise`: nothing to write, each rank runs its kernels on
  its own rows.

The data collectives follow one rule for gradients: every rank computes
the same global loss and differentiates it with respect to its own inputs
only (`gather_rows` slices its rows out of the cotangent,
`sum_across_ranks` passes the cotangent through), so the gradient of the
global loss is the sum over the data axis of the ranks' gradients:
`all_reduce_grads` sums them in f32 over the data group. A one-rank mesh
without a group runs no collective (each is the identity); a group of one
rank (the card machine's NCCL group) runs them, and they copy.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dclip_tpu_torch.core.config import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on the grid. `size`, `rank` and `group` are
    the data axis's (its size, this rank's data index, its data group);
    `group` is None for the one-rank mesh without a process group (no
    collective runs). `model_group` is None while `model_size` is 1."""

    size: int = 1
    rank: int = 0
    group: Any = None
    data_axis: str = "data"
    model_axis: str = "model"
    model_size: int = 1
    model_index: int = 0
    model_group: Any = None
    world_group: Any = None
    global_rank: int = 0

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data_axis: self.size, self.model_axis: self.model_size}

    @property
    def distributed(self) -> bool:
        return self.group is not None

    @property
    def is_primary(self) -> bool:
        return self.global_rank == 0

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's rows of n (n a multiple of the data size)."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split evenly over {self.size} ranks")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def local_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The one-rank mesh: no process group, every collective the identity."""
    cfg = cfg or MeshConfig()
    return Mesh(data_axis=cfg.data_axis, model_axis=cfg.model_axis)


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if _initialized() else 1


# Subgroups by their ranks, for the default group they were made in: a
# second mesh over the same grid reuses them (no rank creates more).
_GROUPS: Dict[Tuple[int, ...], Any] = {}
_GROUPS_WORLD = None


def _new_group(ranks) -> Any:
    import torch.distributed as dist

    global _GROUPS_WORLD
    if _GROUPS_WORLD is not dist.group.WORLD:
        _GROUPS.clear()
        _GROUPS_WORLD = dist.group.WORLD
    key = tuple(sorted(int(r) for r in ranks))
    if key not in _GROUPS:
        _GROUPS[key] = dist.new_group(list(key))
    return _GROUPS[key]


def _grid_mesh(cfg: MeshConfig, grid: np.ndarray) -> Mesh:
    """The mesh of this rank on `grid` [dp, mp] of global ranks. Every rank
    creates the data groups (columns), then the model groups (rows)."""
    import torch.distributed as dist

    dp, mp = grid.shape
    me = dist.get_rank()
    (i,), (j,) = np.nonzero(grid == me)
    # A group orders its ranks by global rank: the indices are the
    # positions there (the grid's own on JAX's layout).
    d, m = sorted(grid[:, j].tolist()).index(me), sorted(grid[i, :].tolist()).index(me)
    world = dist.group.WORLD
    if mp == 1 and (grid.ravel() == np.arange(grid.size)).all():
        data_group, model_group = world, None
    else:
        columns = [_new_group(grid[:, c]) for c in range(mp)]
        rows = [_new_group(grid[r, :]) for r in range(dp)]
        data_group, model_group = columns[j], (rows[i] if mp > 1 else None)
    return Mesh(size=dp, rank=int(d), group=data_group, data_axis=cfg.data_axis,
                model_axis=cfg.model_axis, model_size=mp, model_index=int(m),
                model_group=model_group, world_group=world, global_rank=me)


def make_mesh(cfg: Optional[MeshConfig] = None) -> Mesh:
    """The (data, model) grid over the default process group (module
    docstring)."""
    cfg = cfg or MeshConfig()
    n = _world()
    mp = max(cfg.model_parallel, 1)
    dp = cfg.data_parallel if cfg.data_parallel > 0 else n // mp
    if dp < 1 or dp * mp > n:
        raise ValueError(f"mesh {dp}x{mp} needs {max(dp, 1) * mp} devices, have {n}")
    if dp * mp < n:
        raise ValueError(f"mesh {dp}x{mp} uses {dp * mp} of {n} ranks: one process per card, "
                         "so every rank of the process group is in the mesh")
    if not _initialized():
        return local_mesh(cfg)
    return _grid_mesh(cfg, np.arange(n).reshape(dp, mp))


def multislice_grid(cfg: Optional[MeshConfig], ranks: Sequence[int],
                    slice_of: Callable[[int], Any]) -> Optional[np.ndarray]:
    """JAX's hybrid grid (`dclip_tpu/parallel/mesh.py:57-128`, its
    injected-slice branch) over `ranks`: [dp, mp] of ranks, the data axis
    slice-major and each row (a rank's model partners) inside one slice;
    None for one slice. JAX's three refusals raise with its messages."""
    cfg = cfg or MeshConfig()
    ranks = list(ranks)
    slice_ids = sorted({slice_of(r) for r in ranks})
    if len(slice_ids) <= 1:
        return None
    num_slices = len(slice_ids)
    groups = {s: [] for s in slice_ids}
    for r in ranks:
        groups[slice_of(r)].append(r)
    sizes = {s: len(g) for s, g in groups.items()}
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"ragged slices (chips per slice: {sizes}) — a hybrid mesh "
            "needs equal-size slices"
        )
    chips_per_slice = len(ranks) // num_slices
    mp = max(cfg.model_parallel, 1)
    if chips_per_slice % mp != 0:
        raise ValueError(
            f"model_parallel={mp} must divide chips-per-slice {chips_per_slice}"
            " (TP collectives must stay on ICI, never cross DCN)"
        )
    intra_dp = chips_per_slice // mp
    dp = num_slices * intra_dp
    if cfg.data_parallel > 0 and cfg.data_parallel != dp:
        raise ValueError(
            f"data_parallel={cfg.data_parallel} incompatible with topology: "
            f"{num_slices} slices x {chips_per_slice} chips / mp={mp} -> dp={dp}"
        )
    return np.stack([np.asarray(groups[s]).reshape(intra_dp, mp) for s in slice_ids],
                    axis=0).reshape(dp, mp)


def _node_of_rank() -> Callable[[int], Any]:
    """A rank's node: rank // LOCAL_WORLD_SIZE under torchrun, else its
    host name, gathered from every rank."""
    import torch.distributed as dist

    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local:
        return lambda r: r // int(local)
    import socket

    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    return lambda r: names[r]


def make_multislice_mesh(cfg: Optional[MeshConfig] = None,
                         slice_index_fn: Optional[Callable[[int], Any]] = None) -> Mesh:
    """The multi-slice grid over the default process group: model
    parallelism inside a slice, data parallelism within and across slices.
    `slice_index_fn(rank)` overrides the slice of a rank (default: its
    node). One slice (or no process group) is `make_mesh`."""
    cfg = cfg or MeshConfig()
    if not _initialized():
        return make_mesh(cfg)
    grid = multislice_grid(cfg, range(_world()), slice_index_fn or _node_of_rank())
    return make_mesh(cfg) if grid is None else _grid_mesh(cfg, grid)


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
    """Overwrite every rank's tensors with global rank 0's, over the whole
    grid, one at a time in the given order (JAX's `replicate_tree`)."""
    if mesh.group is None:
        return
    import torch.distributed as dist

    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.world_group or mesh.group)


def broadcast_request(head: Any, arrays: Sequence[np.ndarray], mesh: Mesh
                      ) -> Tuple[Any, List[np.ndarray]]:
    """Global rank 0's (`head`, `arrays`) on every rank of the grid: the
    head (a small picklable value: a command, its strings and numbers) with
    each array's dtype and shape by `broadcast_object_list`, then each
    array as one tensor broadcast on the group's collective device. The
    other ranks' arguments are ignored. A one-rank mesh without a group
    returns its own."""
    if mesh.group is None:
        return head, list(arrays)
    import torch.distributed as dist

    group = mesh.world_group or mesh.group
    dev = collective_device(mesh)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    box = [(head, [(a.dtype.str, a.shape) for a in arrays])]
    dist.broadcast_object_list(box, src=0, group=group, device=dev)
    head, specs = box[0]
    out = []
    for i, (dtype, shape) in enumerate(specs):
        if mesh.global_rank == 0:
            t = torch.from_numpy(arrays[i]).to(dev)
        else:
            t = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype, device=dev)
        dist.broadcast(t, src=0, group=group)
        out.append(arrays[i] if mesh.global_rank == 0 else t.cpu().numpy())
    return head, out


def shard_batch(batch, mesh: Mesh) -> dict:
    """This rank's rows of every array in a global (dataclass or dict)
    batch, by its data index; the batch size must divide by the data size."""
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
    n = next(iter(batch_dict.values())).shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return batch_dict, n
    return {k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
            for k, v in batch_dict.items()}, n
