"""Exact inner-product k-NN (counterpart of `dclip_tpu/ops/knn.py:42-56`).

On the JAX side this is an XLA einsum plus `top_k` (no Pallas kernel), so
here it is plain torch: one f32 matmul and `torch.topk` on the device the
tensors live on.
"""
from __future__ import annotations

from typing import Tuple

import torch


def knn_search(queries: torch.Tensor, store_keys: torch.Tensor,
               k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """queries [Q, D], store_keys [N, D] -> (scores [Q, k], indices [Q, k]),
    descending — the contract of `faiss.IndexFlatIP.search`."""
    scores = queries.float() @ store_keys.float().T
    return torch.topk(scores, min(k, store_keys.shape[0]), dim=-1,
                      largest=True, sorted=True)
