"""Batched encode helpers shared by the eval paths (counterpart of
`dclip_tpu/models/encoding.py:33-158`).

PyTorch runs eagerly, so the JAX module's memoized jits become plain
functions of a model that holds its weights, run without gradients on the
model's device. `image_forward` takes `make_image_encoder`'s route rule
(`encoding.py:118-125`), and so the retrieval eval's and the service's
(`dclip_tpu/serve/service.py:96-118`): a bf16 model on the card runs
`kernels.vit_block.fused_image_features` (K1 / K2, bf16 only); every
other case (f32, the CPU) runs the module path, `CLIPModule.image_features`.
The zero-shot eval does not take this rule: like the JAX
`zero_shot_logits_forward` (`encoding.py:65-79`) it always runs the
module path at the model's dtype.

With a `parallel.mesh.Mesh` of several ranks (`sharded_encode`), each rank
encodes its block of the rows ([r m, (r + 1) m), m = ceil(N / size)) in
batches of batch_size / size, and the features are all-gathered in order,
the last block's padding dropped: every rank returns all N rows.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from dclip_tpu_torch.kernels.vit_block import fused_image_features
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.ops.losses import l2_normalize


def model_device(model: CLIPModule) -> torch.device:
    return next(model.parameters()).device


def image_route(device: torch.device, dtype: torch.dtype) -> str:
    """"kernels" (K1 / K2) for a bf16 model on CUDA, else "module"."""
    return "kernels" if device.type == "cuda" and dtype == torch.bfloat16 else "module"


def image_forward(model: CLIPModule) -> Callable[[torch.Tensor], torch.Tensor]:
    """pixels NHWC on the model's device -> image features [B, P] by
    `image_route`; the kernels' weights are packed once, here."""
    if image_route(model_device(model), model.dtype) == "kernels":
        with torch.no_grad():
            weights = model.pack_image_weights()
        return lambda px: fused_image_features(model.cfg, weights, px)
    return model.image_features


def text_forward(model: CLIPModule, ids: np.ndarray, mask: np.ndarray) -> torch.Tensor:
    """[B, T] ids and mask (host) -> text features [B, P] on the device."""
    dev = model_device(model)
    with torch.inference_mode():
        return model.get_text_features(torch.as_tensor(np.asarray(ids), device=dev),
                                       torch.as_tensor(np.asarray(mask), device=dev))


def packed_text_forward(model: CLIPModule, packed: dict) -> torch.Tensor:
    """Text features of a packed batch (`ops.packing.pack_captions`), in
    caption order: the numbers of `text_forward` on the unpacked batch."""
    dev = model_device(model)
    keys = ("packed_ids", "packed_segments", "packed_positions", "packed_eos_rows",
            "packed_eos_cols")
    with torch.inference_mode():
        return model.get_packed_text_features(
            *(torch.as_tensor(np.asarray(packed[k]), device=dev) for k in keys))


def zero_shot_logits(image_fn: Callable[[torch.Tensor], torch.Tensor], pixels: torch.Tensor,
                     text_features: torch.Tensor) -> torch.Tensor:
    """[B, C] = 100 * normalized image features @ text_features.T in f32
    (`encoding.py:65-79`); `image_fn` is `image_forward(model)` or the
    module path `model.image_features`."""
    with torch.inference_mode():
        img = l2_normalize(image_fn(pixels).float())
        return 100.0 * img @ text_features.float().T


def sharded_encode(items: Sequence, encode_rows: Callable[[Sequence], np.ndarray], mesh,
                   dim: int) -> np.ndarray:
    """`encode_rows(items)` -> [N, dim] host f32, with a mesh of several
    ranks run on this rank's block of the items and all-gathered (module
    docstring); without a group, `encode_rows(items)`."""
    if mesh is None or not mesh.distributed:
        return encode_rows(items)
    from dclip_tpu_torch.parallel.mesh import collective_device, gather_cat

    n = len(items)
    per = -(-n // mesh.size)
    lo, hi = min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)
    buf = np.zeros((per, dim), np.float32)
    buf[:hi - lo] = encode_rows(items[lo:hi])
    rows = gather_cat(torch.from_numpy(buf).to(collective_device(mesh)), mesh)
    return rows.cpu().numpy()[:n]


def rank_batch_size(batch_size: int, mesh) -> int:
    """A rank's share of a global batch; the mesh size must divide it."""
    size = 1 if mesh is None else mesh.size
    if batch_size % size:
        raise ValueError(f"the data-axis size ({size}) must divide batch_size {batch_size}")
    return batch_size // size


def make_image_encoder(model: CLIPModule, batch_size: int = 256, mesh=None
                       ) -> Callable[[Sequence[np.ndarray]], np.ndarray]:
    """encode(pixels): a list / array of preprocessed NHWC images -> [N, P]
    f32 features on the host, in batches of `batch_size` (the tail batch
    zero-padded, as the JAX encoder pads to one compiled shape). With a
    `parallel.mesh.Mesh`, each rank encodes its block of the images in
    batches of batch_size / size (`sharded_encode`)."""
    fwd = image_forward(model)
    dev = model_device(model)
    per_batch = rank_batch_size(batch_size, mesh)

    def encode_rows(pixels: Sequence[np.ndarray]) -> np.ndarray:
        out = []
        for start in range(0, len(pixels), per_batch):
            chunk = np.stack(pixels[start:start + per_batch])
            n = chunk.shape[0]
            if n < per_batch:
                chunk = np.concatenate(
                    [chunk, np.zeros((per_batch - n,) + chunk.shape[1:], chunk.dtype)])
            with torch.inference_mode():
                feats = fwd(torch.as_tensor(chunk, device=dev))
            out.append(feats[:n].float().cpu().numpy())
        if not out:
            return np.zeros((0, model.cfg.projection_dim), np.float32)
        return np.concatenate(out, 0)

    return lambda pixels: sharded_encode(pixels, encode_rows, mesh, model.cfg.projection_dim)
