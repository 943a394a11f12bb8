"""Projection MLPs (counterpart of `dclip_tpu/models/projections.py`).

- `TextProjectionModule`: BERT 768 -> 1024 -> ReLU -> CLIP 512.
- `ImageProjectionModule`: concat(CLIP 512, 4 box coordinates) -> 1024 ->
  ReLU -> 1024 -> ReLU -> 512: the position-conditioned branch of the k-NN
  gate (`ops.knn.knn_or_projection`, source 1).

Weights are a plain state dict (`fc1.weight` [out, in], ...). Files are
the port's own format: `torch.save` of that state dict, read with
`torch.load(weights_only=True)` (`train.checkpoint`). The JAX package's
flax-msgpack files are not read; `models.weights.
projection_state_dict_from_jax` carries JAX params across in memory.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

ProjectionFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


class TextProjectionModule(nn.Module):
    def __init__(self, clip_dim: int = 512, hidden_dim: int = 1024, bert_dim: int = 768,
                 device=None):
        super().__init__()
        self.fc1 = nn.Linear(bert_dim, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, clip_dim, device=device)

    def forward(self, bert_embedding: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.fc1(bert_embedding)))


class ImageProjectionModule(nn.Module):
    def __init__(self, clip_dim: int = 512, hidden_dim: int = 1024, device=None):
        super().__init__()
        self.fc1 = nn.Linear(clip_dim + 4, hidden_dim, device=device)
        self.fc2 = nn.Linear(hidden_dim, hidden_dim, device=device)
        self.fc3 = nn.Linear(hidden_dim, clip_dim, device=device)

    def forward(self, context_features: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """context_features [..., clip_dim], positions [..., 4] -> [..., clip_dim]."""
        x = torch.cat([context_features, positions], dim=-1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc3(x)


def init_image_projection(seed: int = 0, clip_dim: int = 512
                          ) -> Tuple[ImageProjectionModule, Dict[str, torch.Tensor]]:
    """(module on the meta device, f32 CPU state dict) of a fresh head:
    weights N(0, 1 / fan_in) from a `torch.Generator` seeded with `seed`,
    biases 0 (flax Dense's scales, not its draws)."""
    module = ImageProjectionModule(clip_dim, device="meta")
    gen = torch.Generator().manual_seed(seed)
    params = {name: (torch.randn(t.shape, generator=gen) * t.shape[1] ** -0.5 if t.dim() == 2
                     else torch.zeros(t.shape))
              for name, t in module.state_dict().items()}
    return module, params


def save_image_projection(path: str, params: Dict[str, torch.Tensor]) -> None:
    """The state dict as a port-format file (`torch.save`, atomic)."""
    from dclip_tpu_torch.train.checkpoint import save_state

    save_state(path, {k: v.detach().cpu() for k, v in params.items()})


def load_image_projection(path: str, clip_dim: int = 512
                          ) -> Tuple[ImageProjectionModule, Dict[str, torch.Tensor]]:
    """(module, state dict) from a port-format file (`save_image_projection`;
    not flax msgpack), checked name by name and shape by shape."""
    from dclip_tpu_torch.train.checkpoint import restore_state

    module, template = init_image_projection(0, clip_dim)
    params = restore_state(path)
    if not isinstance(params, dict) or set(params) != set(template):
        raise ValueError(f"{path}: not an ImageProjectionModule state dict (want "
                         f"{sorted(template)})")
    for name, t in template.items():
        if tuple(params[name].shape) != tuple(t.shape):
            raise ValueError(f"{path}: {name} has shape {tuple(params[name].shape)}, want "
                             f"{tuple(t.shape)}")
    return module, {k: v.float() for k, v in params.items()}


def projection_apply_fn(module: ImageProjectionModule, params: Dict[str, torch.Tensor],
                        device=None) -> ProjectionFn:
    """(queries [Q, D], positions [Q, 4]) -> [Q, D] in f32, without
    gradients: the `projection_fn` of `ops.knn.knn_or_projection` and
    `train.base.apply_knn_gate`. The weights are copied to `device` (default:
    where they are) once, here."""
    weights = {k: v.detach().to(device=device, dtype=torch.float32) for k, v in params.items()}

    def apply(queries: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.func.functional_call(module, weights,
                                              (queries.float(), positions.float()))

    return apply
