"""Exact inner-product k-NN and the k-NN gate of the teacher's patch
embeddings (counterpart of `dclip_tpu/ops/knn.py:42-56, 95-140`).

`knn_search` is the XLA einsum + `top_k` of the JAX package, computed
without the [Q, N] score matrix: on CUDA tensors it launches K12
(`kernels.topk.topk_streamed`, the counterpart of the Pallas
`topk_streamed`), on CPU tensors its plain twin. Both break ties as
`jax.lax.top_k` does: the lower store index first. Gate semantics, per
query:
  top-1 score >= threshold -> the stored neighbour's value        (source 0)
  else, with a projection  -> the normalized projection head output (source 1)
  else                     -> the raw normalized query            (source 2)
The projection head (`models.projections.projection_apply_fn`) is plain
f32 PyTorch, as the JAX package leaves it to XLA.

`knn_search_sharded` searches a store whose rows are split over the ranks
of a `parallel.mesh.Mesh` (`dclip_tpu/ops/knn.py:59-93`): each rank takes
the top-k of its shard with K12, all ranks all-gather the candidates, and
a stable sort of the size x k candidates (JAX's second `top_k`) keeps the
global top-k.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from dclip_tpu_torch.kernels.topk import topk_streamed
from dclip_tpu_torch.ops.losses import l2_normalize

SOURCE_KNN = 0
SOURCE_PROJECTION = 1
SOURCE_CLIP = 2


class KNNResult(NamedTuple):
    embeddings: torch.Tensor  # [Q, D] selected embedding per query
    source: torch.Tensor  # [Q] int32 in {0: knn, 1: projection, 2: clip}
    similarity: torch.Tensor  # [Q] top-1 score, 0 where not knn


def knn_search(queries: torch.Tensor, store_keys: torch.Tensor,
               k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], store_keys [N, D] -> (scores [Q, k] f32, indices
    [Q, k] int32), descending, k = min(k, N) — the contract of
    `faiss.IndexFlatIP.search`. CUDA: any k (over 64 in rounds of 64)."""
    return topk_streamed(queries, store_keys, k)


def knn_search_sharded(queries: torch.Tensor, store_shard: torch.Tensor, mesh, k: int = 3,
                       n_valid: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a store sharded on `mesh`'s ranks (shard r holds global
    rows [r n, (r + 1) n)): (scores [Q, k'], global indices [Q, k']) on
    every rank, k' = min(k, size x min(k, n)). Queries are the same on
    every rank. `n_valid` (the global count of real rows, padding at the
    tail, `EmbeddingStore.pad_to_multiple`) gives K12 only the valid prefix
    of the shard; the missing candidates score -inf (indices of the padded
    rows, as JAX's masked top-k), so padded rows never win."""
    from dclip_tpu_torch.ops.retrieval import stable_topk
    from dclip_tpu_torch.parallel.mesh import gather_cat

    n_local = store_shard.shape[0]
    offset = mesh.rank * n_local
    valid = n_local if n_valid is None else max(0, min(int(n_valid) - offset, n_local))
    kk = min(k, n_local)
    found = min(kk, valid)
    scores, idx = [], []
    if found:
        s, i = knn_search(queries, store_shard[:valid], found)
        scores.append(s)
        idx.append(i + offset)
    if found < kk:
        q = queries.shape[0]
        scores.append(torch.full((q, kk - found), float("-inf"), device=queries.device))
        idx.append((offset + valid + torch.arange(kk - found, dtype=torch.int32,
                                                  device=queries.device)).expand(q, -1))
    all_scores = gather_cat(torch.cat(scores, 1), mesh, dim=1)
    all_idx = gather_cat(torch.cat(idx, 1), mesh, dim=1)
    top, pos = stable_topk(all_scores, min(k, all_scores.shape[1]))
    return top, torch.gather(all_idx, 1, pos.long())


def knn_or_projection(
    queries: torch.Tensor,
    positions: Optional[torch.Tensor],
    store_keys: Optional[torch.Tensor],
    store_values: Optional[torch.Tensor],
    projection_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]],
    similarity_threshold: float = 0.85,
    k: int = 3,
) -> KNNResult:
    """queries [Q, D] CLIP embeddings; positions [Q, 4] normalized box
    coordinates (zeros when None); store_keys / store_values [N, D] (values
    default to the keys); projection_fn(queries, positions) -> [Q, D]."""
    q = l2_normalize(queries.float())
    qn = q.shape[0]
    if projection_fn is not None:
        if positions is None:
            positions = torch.zeros((qn, 4), dtype=torch.float32, device=q.device)
        fallback = l2_normalize(projection_fn(q, positions.float()).float())
        fb_source = SOURCE_PROJECTION
    else:
        fallback, fb_source = q, SOURCE_CLIP
    if store_keys is None or store_keys.shape[0] == 0:
        return KNNResult(fallback,
                         torch.full((qn,), fb_source, dtype=torch.int32, device=q.device),
                         torch.zeros((qn,), dtype=torch.float32, device=q.device))
    if store_values is None:
        store_values = store_keys
    scores, idx = knn_search(q, store_keys, k)
    top1_score, top1_idx = scores[:, 0], idx[:, 0]
    hit = top1_score >= similarity_threshold
    retrieved = store_values[top1_idx.long()].float()
    return KNNResult(
        torch.where(hit[:, None], retrieved, fallback),
        torch.where(hit, SOURCE_KNN, fb_source).to(torch.int32),
        torch.where(hit, top1_score, torch.zeros_like(top1_score)),
    )
