"""Retrieval ranks and metrics on the device (counterpart of
`dclip_tpu/ops/retrieval.py:25-115`).

Rank semantics are `np.argsort(-similarities)`'s, stable ties included:
rank(gt) = #{j : sim[j] > sim[gt]} + #{j < gt : sim[j] == sim[gt]}.
R@k = the share of ranks < k; "MAP" = mean(1 / (rank + 1)) (the
reference's name for its mean reciprocal rank). The similarity is one f32
matmul (torch's default "highest" precision: no TF32), as the JAX package
leaves it to XLA outside any kernel; the ranks are comparisons and stable
sorts on the tensors' device. `stable_topk` is the same order cut to k
(the zero-shot top-5, and K12's plain twin).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch

from dclip_tpu_torch.core.device import resolve_device
from dclip_tpu_torch.ops.losses import l2_normalize

INT_MAX = 2**31 - 1


def similarity_matrix(caption_embeddings: torch.Tensor, image_embeddings: torch.Tensor,
                      normalize: bool = True) -> torch.Tensor:
    """[C, D] x [I, D] -> [C, I] cosine similarity in f32."""
    c, im = caption_embeddings.float(), image_embeddings.float()
    if normalize:
        c, im = l2_normalize(c), l2_normalize(im)
    return c @ im.T


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of each row, descending, ties to the lower
    column (`jax.lax.top_k`'s order): a stable descending sort cut to k.
    Returns (values, int32 indices)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k].contiguous(), idx[..., :k].to(torch.int32).contiguous()


def _stable_rank_of(sims: torch.Tensor, gt_idx: torch.Tensor) -> torch.Tensor:
    """Rank of gt_idx in a stable descending argsort of sims: [..., N] and
    [...] -> [...] int32, by two masked counts (no sort)."""
    gt_idx = gt_idx.long()
    gt_sim = torch.gather(sims, -1, gt_idx[..., None])
    idx = torch.arange(sims.shape[-1], device=sims.device)
    greater = (sims > gt_sim).sum(-1)
    tie_before = ((sims == gt_sim) & (idx < gt_idx[..., None])).sum(-1)
    return (greater + tie_before).to(torch.int32)


def _stable_ranks_all(sims: torch.Tensor) -> torch.Tensor:
    """Rank of every element of each row under the stable descending sort:
    [..., N] -> [..., N] int32 (the double argsort)."""
    order = torch.sort(sims, dim=-1, descending=True, stable=True).indices
    return torch.argsort(order, dim=-1).to(torch.int32)


def t2i_ranks(sim: torch.Tensor, caption_to_image: torch.Tensor) -> torch.Tensor:
    """sim [C, I]; caption_to_image [C], each caption's image -> [C] ranks."""
    return _stable_rank_of(sim, caption_to_image)


def i2t_ranks(sim: torch.Tensor, caption_to_image: torch.Tensor,
              chunk: int = 512, first: int = 0) -> torch.Tensor:
    """Best (lowest) rank over each image's captions: sim [C, I] -> [I].
    For image i, every caption is ranked by sim[:, i] (stable, descending);
    images go in chunks of `chunk`, so the peak is a [chunk, C] rank
    matrix. An image with no caption gets INT_MAX. `first`: the image id
    of sim's first column (a block of the images)."""
    num_images = sim.shape[1]
    c2i = caption_to_image.to(sim.device).long()
    out = []
    for lo in range(0, num_images, chunk):
        rows = sim[:, lo:lo + chunk].T  # [chunk, C]
        ids = torch.arange(first + lo, first + lo + rows.shape[0], device=sim.device)
        ranks_all = _stable_ranks_all(rows)
        is_gt = c2i[None, :] == ids[:, None]
        out.append(torch.where(is_gt, ranks_all, torch.full_like(ranks_all, INT_MAX)).amin(-1))
    if not out:
        return torch.zeros((0,), dtype=torch.int32, device=sim.device)
    return torch.cat(out)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """An f32 mean as XLA takes it: the sum times the f32 reciprocal of the
    count (so 23 hits in 100 give 0.22999999, the JAX package's R@5)."""
    return x.sum() * (1.0 / x.numel()) if x.numel() else x.mean()


def recall_at_k(ranks: torch.Tensor, ks: Sequence[int] = (1, 5, 10)) -> Dict[str, torch.Tensor]:
    out = {f"R@{k}": _mean((ranks < k).float()) for k in ks}
    out["MAP"] = _mean(1.0 / (ranks.float() + 1.0))
    return out


Array = Union[np.ndarray, torch.Tensor, Sequence]


def retrieval_metrics(caption_embeddings: Array, image_embeddings: Array,
                      caption_to_image: Array,
                      device: Union[str, torch.device] = "cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """{"t2i": {R@1, R@5, R@10, MAP}, "i2t": {...}} with every step on
    `device` (CUDA unless the caller names the CPU)."""
    device = resolve_device(device)
    cap = torch.as_tensor(np.asarray(caption_embeddings) if not torch.is_tensor(caption_embeddings)
                          else caption_embeddings, device=device)
    img = torch.as_tensor(np.asarray(image_embeddings) if not torch.is_tensor(image_embeddings)
                          else image_embeddings, device=device)
    c2i = torch.as_tensor(np.asarray(caption_to_image) if not torch.is_tensor(caption_to_image)
                          else caption_to_image, device=device)
    sim = similarity_matrix(cap, img)
    return {"t2i": recall_at_k(t2i_ranks(sim, c2i)), "i2t": recall_at_k(i2t_ranks(sim, c2i))}


def retrieval_metrics_sharded(caption_embeddings: Array, image_embeddings: Array,
                              caption_to_image: Array, mesh, data_axis: str = "data",
                              i2t_chunk: int = 512, device: Union[str, torch.device] = "cuda"
                              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """`retrieval_metrics` with the rank work split over the ranks of a
    `parallel.mesh.Mesh` (`dclip_tpu/ops/retrieval.py:151-211`); every
    rank holds every embedding. t2i: each rank ranks its block of caption
    rows against every image; i2t: its block of image rows against every
    caption, in chunks of `i2t_chunk`. The reduced axis is whole on every
    rank, so each rank is exact; the ranks are all-gathered in order, the
    padding of the last block is dropped, and the means run over all of
    them: the result equals `retrieval_metrics`. Every rank computes the
    whole similarity matrix in the one GEMM `retrieval_metrics` runs: a
    GEMM of a block of rows may round an element otherwise (another
    kernel for another shape), and a tie between duplicated rows would
    then break another way."""
    from dclip_tpu_torch.parallel.mesh import collective_device, gather_cat

    device = resolve_device(device)
    cap, img, c2i = (torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=device)
                     for x in (caption_embeddings, image_embeddings, caption_to_image))

    def block(n):
        per = -(-n // mesh.size)
        return per, min(mesh.rank * per, n), min((mesh.rank + 1) * per, n)

    def gathered(local, per, n):
        pad = torch.zeros((per - local.shape[0],), dtype=torch.int32, device=device)
        full = torch.cat([local.to(torch.int32), pad]).to(collective_device(mesh))
        return gather_cat(full, mesh)[:n].to(device)

    sim = similarity_matrix(cap, img)
    per_c, lo, hi = block(cap.shape[0])
    t2i = gathered(t2i_ranks(sim[lo:hi], c2i[lo:hi]), per_c, cap.shape[0])
    per_i, lo, hi = block(img.shape[0])
    i2t = gathered(i2t_ranks(sim[:, lo:hi], c2i, i2t_chunk, first=lo), per_i, img.shape[0])
    return {"t2i": recall_at_k(t2i), "i2t": recall_at_k(i2t)}
