"""Tensor parallelism for the CLIP encoders (counterpart of
`dclip_tpu/parallel/tp.py`).

JAX annotates the parameter tree with PartitionSpecs over the mesh's model
axis and lets GSPMD insert the collectives. The port holds this rank's
slices in the modules and runs the collectives itself, Megatron style,
over the mesh's model group (`parallel.mesh.Mesh.model_group`):

- attention q / k / v   [D, D]  -> shard the output dim (head-parallel)
- attention out_proj    [D, D]  -> shard the input dim (+ all-reduce)
- MLP fc1               [M, D]  -> shard the output dim
- MLP fc2               [D, M]  -> shard the input dim (+ all-reduce)
- embeddings, LayerNorms, projections, the meta-teacher -> replicated

The shapes are torch's (`nn.Linear` weight [out, in], the transpose of a
Flax kernel), so an output-dim shard is weight dim 0 with its bias, an
input-dim shard weight dim 1; the biases of row-sharded layers stay whole
and are added once, after the all-reduce.

A sharded layer reads `copy_to_model(x)` (forward the identity, backward
the all-reduce of the input gradient over the model group) and returns
`reduce_from_model(partial)` (forward the all-reduce in f32, backward the
identity), so every rank of a model group holds the same activations and
the same gradients of every replicated parameter. With `model_size == 1`
both are the identity and launch nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Union

import torch

# Name ending -> the sharded dim of the torch tensor. First match wins.
_RULES = (
    ("self_attn.q_proj.weight", 0),
    ("self_attn.k_proj.weight", 0),
    ("self_attn.v_proj.weight", 0),
    ("self_attn.out_proj.weight", 1),
    ("mlp.fc1.weight", 0),
    ("mlp.fc2.weight", 1),
    # Column-sharded biases follow their weight's output dim.
    ("self_attn.q_proj.bias", 0),
    ("self_attn.k_proj.bias", 0),
    ("self_attn.v_proj.bias", 0),
    ("mlp.fc1.bias", 0),
)


def model_axis(mesh):
    """`mesh` when it has a model axis (model_size > 1), else None: the
    unsharded code paths."""
    return mesh if mesh is not None and mesh.model_size > 1 else None


def param_spec(name: str) -> Optional[int]:
    """The dim of parameter `name` split over the model axis, None when
    replicated."""
    for pattern, dim in _RULES:
        if name.endswith(pattern):
            return dim
    return None


def clip_param_specs(names: Iterable[str]) -> Dict[str, Optional[int]]:
    """{name: sharded dim or None} over CLIP state-dict names."""
    return {name: param_spec(name) for name in names}


def _tensors(module_or_state_dict) -> Mapping[str, torch.Tensor]:
    if isinstance(module_or_state_dict, torch.nn.Module):
        return dict(module_or_state_dict.named_parameters())
    return module_or_state_dict


def shard_clip_params(module_or_state_dict: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
                      mesh) -> Dict[str, torch.Tensor]:
    """This rank's slices of whole CLIP tensors (contiguous copies of the
    sharded ones, the replicated ones as they are)."""
    out = {}
    for name, t in _tensors(module_or_state_dict).items():
        dim = param_spec(name)
        if dim is None or mesh.model_size == 1:
            out[name] = t
            continue
        if t.shape[dim] % mesh.model_size:
            raise ValueError(f"{name}: dim {dim} of {tuple(t.shape)} does not split over "
                             f"model-parallel size {mesh.model_size}")
        out[name] = t.detach().chunk(mesh.model_size, dim)[mesh.model_index].contiguous()
    return out


def gather_clip_params(state_dict: Mapping[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The inverse of `shard_clip_params`: the whole tensors, all-gathered
    over the model group in model order (every rank of it must call)."""
    if mesh.model_size == 1:
        return dict(state_dict)
    import torch.distributed as dist

    out = {}
    for name, t in state_dict.items():
        dim = param_spec(name)
        if dim is None:
            out[name] = t
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(mesh.model_size)]
        dist.all_gather(parts, t, group=mesh.model_group)
        out[name] = torch.cat(parts, dim)
    return out


def head_divisibility_check(num_heads: int, mesh) -> None:
    """Each shard must hold whole heads."""
    size = mesh.model_size
    if num_heads % size != 0:
        raise ValueError(
            f"num_heads={num_heads} not divisible by model-parallel size {size}"
        )


def clip_divisibility_check(cfg, mesh) -> None:
    """Both towers' head counts and MLP widths split evenly: GSPMD pads an
    uneven split, the port cannot split a head (ROADMAP Queue 3)."""
    for tower in (cfg.vision, cfg.text):
        head_divisibility_check(tower.num_heads, mesh)
        if tower.mlp_dim % mesh.model_size:
            raise ValueError(f"mlp_dim={tower.mlp_dim} not divisible by model-parallel size "
                             f"{mesh.model_size}")


def all_reduce_model_(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum `x` over the model group in place, no autograd."""
    if model_axis(mesh) is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=mesh.model_group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_model_(g.to(torch.float32, copy=True), ctx.mesh)
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.dtype = x.dtype
        return all_reduce_model_(x.to(torch.float32, copy=True), mesh)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The input of a column-sharded layer: forward the identity, backward
    the sum of the model ranks' input gradients."""
    if model_axis(mesh) is None:
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The output of a row-sharded layer: forward the f32 sum of the model
    ranks' partial products (f32 out), backward the identity."""
    if model_axis(mesh) is None:
        return x
    return _ReduceFromModel.apply(x, mesh)
