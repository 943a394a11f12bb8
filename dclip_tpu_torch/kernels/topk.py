"""Streamed exact top-k on Hopper (K12; counterpart of
`dclip_tpu/kernels/topk.py:84` `topk_streamed`): for queries [Q, D] and a
store [N, D], the k best f32 inner products per query and their row
indices, descending, without the [Q, N] score matrix.

The contract is the TPU kernel's: both operands in f32, k = min(k, N),
scores f32 and indices int32 [Q, k], a tie going to the lower row index
(the order of `jax.lax.top_k` and of the XLA `knn_search`), rows past N
never selected. The scores are 3xTF32 tensor-core products, within 1e-5
of the f32 twin (`csrc/topk.cu`'s header). A search first splits the
queries into their TF32 halves (one small launch), then each round
launches `csrc/topk.cu`'s two kernels: per (query tile, store chunk) a
running top-64 (at most) over the chunk, then a merge of the chunks'
lists per query. Any k: a k over 64 takes ceil(k / 64)
rounds, each a full pass over the store that keeps only the pairs behind
the last one the round before found (the order is strict, so the rounds
partition the ranking). The result does not depend on the chunking: a
repeated search repeats bit for bit.

`topk_streamed_reference` is the plain twin: an f32 matmul (torch's
default "highest" precision: no TF32) and a stable descending sort cut to
k. The wrapper takes it only when its tensors lie on the CPU; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch

from dclip_tpu_torch.kernels._build import check, load_library
from dclip_tpu_torch.kernels.vit_block import _on_cpu, _stream
from dclip_tpu_torch.ops.retrieval import stable_topk

ROUND_K = 64  # pairs a round selects per query (the kernel's list length)
_QUERY_TILE, _ROW_TILE = 64, 128
# At most this many candidates per query for the merge (chunks x k).
_MAX_CANDIDATES = 4096

LAUNCHES: Dict[str, int] = {"topk_streamed": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def topk_streamed_reference(queries: torch.Tensor, store: torch.Tensor,
                            k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    scores = queries.float() @ store.float().T
    return stable_topk(scores, min(k, store.shape[0]))


def chunk_plan(nq: int, n: int, k: int, slots: int) -> Tuple[int, int]:
    """(rows_per_chunk, chunks): chunks of whole 128-row tiles covering the
    store, as many as the card's `slots` (resident blocks) hold at once
    across the query tiles, so the grid runs in one wave with no tail; at
    least one, at most 4096 // k."""
    tiles = -(-n // _ROW_TILE)
    query_tiles = -(-nq // _QUERY_TILE)
    chunks = max(1, min(slots // query_tiles, _MAX_CANDIDATES // k, tiles))
    rows = -(-tiles // chunks) * _ROW_TILE
    return rows, -(-n // rows)


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, k: int) -> int:
    """Resident pass-1 blocks on the whole card for this k."""
    lib = load_library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        check(lib, lib.dclip_topk_blocks_per_sm(k, ctypes.addressof(blocks)),
              "topk_streamed occupancy")
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return max(1, blocks.value) * sms


def _f32_operand(t: torch.Tensor, d8: int) -> torch.Tensor:
    t = t.float()
    if t.shape[1] != d8:  # zero columns add nothing to a dot product
        t = torch.nn.functional.pad(t, (0, d8 - t.shape[1]))
    if not t.is_contiguous() or t.data_ptr() % 16:
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def topk_streamed(queries: torch.Tensor, store: torch.Tensor,
                  k: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] f32, indices [Q, k] int32), descending, k = min(k, N).
    CUDA: any float dtype (computed in f32)."""
    if _on_cpu(queries, store):
        return topk_streamed_reference(queries, store, k)
    if queries.dim() != 2 or store.dim() != 2 or queries.shape[1] != store.shape[1]:
        raise ValueError(f"topk_streamed: needs queries [Q, D] and store [N, D], got "
                         f"{tuple(queries.shape)} and {tuple(store.shape)}")
    (nq, d), n = queries.shape, store.shape[0]
    k = min(k, n)
    dev = queries.device
    out_s = torch.empty((nq, max(k, 0)), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, max(k, 0)), dtype=torch.int32, device=dev)
    if nq == 0 or k <= 0:  # nothing to select: no launch
        return out_s, out_i
    d8 = -(-d // 8) * 8  # whole TF32 k steps
    q, s = _f32_operand(queries, d8), _f32_operand(store, d8)
    lib = load_library()
    # q_big, q_small, their columns padded to 32 (one stage) and in k8-step order
    split = torch.empty((2, nq, -(-d8 // 32) * 32), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        check(lib, lib.dclip_topk_split_tf32(q.data_ptr(), split.data_ptr(), nq, d8, _stream(q)),
              "topk_streamed (query split)")
    for done in range(0, k, ROUND_K):
        kr = min(ROUND_K, k - done)
        rows, chunks = chunk_plan(nq, n, kr, _slots(dev.index, kr))
        part_s = torch.empty((nq, chunks, kr), dtype=torch.float32, device=dev)
        part_i = torch.empty((nq, chunks, kr), dtype=torch.int32, device=dev)
        # The round's bound: each query's last pair of the round before.
        after_s = out_s[:, done - 1].data_ptr() if done else None
        after_i = out_i[:, done - 1].data_ptr() if done else None
        with torch.cuda.device(dev):
            code = lib.dclip_topk_streamed_f32(
                split.data_ptr(), s.data_ptr(), after_s, after_i, part_s.data_ptr(),
                part_i.data_ptr(), out_s[:, done].data_ptr(), out_i[:, done].data_ptr(), k,
                nq, n, d8, kr, rows, chunks, _stream(q))
        check(lib, code, "topk_streamed")
    LAUNCHES["topk_streamed"] += 1
    return out_s, out_i
