"""Caption sequence packing: fewer, denser text-encoder rows.

Counterpart of `dclip_tpu/ops/packing.py`. CLIP pads every caption to 77
tokens, but real captions run ~10-30; packing places several captions'
CONTENT tokens into one 77-token row and encodes the batch in R << B rows.
Per-caption semantics are kept by segment ids (attention within a caption,
causal), per-caption positions (restarting at 0), and an EOS gather in
the original caption order.

The packing is host numpy, copied from the JAX module (which imports
`jax.numpy` at its top, so the port cannot import it): first-fit-
decreasing over content lengths, deterministic, with the row count
bucketed (`packed_rows_bucket`). `packed_attention_bias` is the torch form
of the JAX module's additive packed mask; the text tower takes the segment
ids themselves (in-kernel masks, or the plain path's causal + segment
masks, which allow the same keys).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def packed_attention_bias(segment_ids: torch.Tensor) -> torch.Tensor:
    """[B, S] int segment ids (0 = padding) -> additive [B, 1, S, S] f32.

    Allowed = same segment AND key position <= query position. Padding
    attends padding (0 == 0), which keeps its softmax rows finite."""
    s = segment_ids.shape[-1]
    idx = torch.arange(s, device=segment_ids.device)
    allowed = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (
        idx[None, None, :] <= idx[None, :, None])
    neg = torch.finfo(torch.float32).min
    return torch.where(allowed, 0.0, neg)[:, None].to(torch.float32)


def packed_rows_bucket(min_rows: int, batch: int, n_buckets: int = 4) -> int:
    """Smallest bucket (multiples of batch/n_buckets) covering min_rows —
    bounded distinct R values -> bounded student-step retraces."""
    step = max(batch // n_buckets, 1)
    bucket = ((max(min_rows, 1) + step - 1) // step) * step
    return min(bucket, batch)


def _ffd_place(ids: np.ndarray, mask: np.ndarray, eos_token_id: int):
    """First-fit-decreasing placement for one caption block.

    Returns (placement [B, 2] (row, start), lengths [B], eos_off [B],
    min_rows)."""
    b, s = ids.shape
    lengths = mask.sum(axis=1).astype(np.int64)
    # A caption with no mask would lose its EOS anchor; give it 1 token.
    lengths = np.maximum(lengths, 1)
    eos_off = np.argmax(ids == eos_token_id, axis=1)
    has_eos = (ids == eos_token_id).any(axis=1)
    eos_off = np.where(has_eos, eos_off, lengths - 1)
    # EOS must live inside the copied span.
    lengths = np.maximum(lengths, eos_off + 1)

    order = np.argsort(-lengths, kind="stable")  # FFD: longest first
    row_used: list = []
    placement = np.empty((b, 2), np.int64)  # (row, start) per caption
    for cap in order:
        need = int(lengths[cap])
        for r, used in enumerate(row_used):
            if used + need <= s:
                placement[cap] = (r, used)
                row_used[r] = used + need
                break
        else:
            placement[cap] = (len(row_used), 0)
            row_used.append(need)
    return placement, lengths, eos_off, len(row_used)


def _assemble(ids, lengths, eos_off, placement, rows: int):
    b, s = ids.shape
    packed_ids = np.zeros((rows, s), np.int32)
    segments = np.zeros((rows, s), np.int32)
    positions = np.zeros((rows, s), np.int32)
    eos_rows = np.empty(b, np.int32)
    eos_cols = np.empty(b, np.int32)
    seg_counter = np.zeros(rows, np.int32)
    for cap in range(b):
        r, start = placement[cap]
        n = int(lengths[cap])
        seg_counter[r] += 1
        packed_ids[r, start:start + n] = ids[cap, :n]
        segments[r, start:start + n] = seg_counter[r]
        positions[r, start:start + n] = np.arange(n)
        eos_rows[cap] = r
        eos_cols[cap] = start + int(eos_off[cap])
    return {
        "packed_ids": packed_ids,
        "packed_segments": segments,
        "packed_positions": positions,
        "packed_eos_rows": eos_rows,
        "packed_eos_cols": eos_cols,
    }


def pack_captions(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    eos_token_id: int,
    n_buckets: int = 4,
) -> Dict[str, np.ndarray]:
    """First-fit-decreasing packing of B captions into R rows of width S.

    Returns numpy fields (device transfer is the caller's job):
      packed_ids [R, S] int32        token ids, 0-padded
      packed_segments [R, S] int32   1..k per row, 0 on padding
      packed_positions [R, S] int32  within-caption position index
      packed_eos_rows [B] int32      (row, col) of caption b's EOS token
      packed_eos_cols [B] int32

    Content of caption b = its first `attention_mask[b].sum()` tokens
    (BOS..EOS; CLIP masks cover exactly that span). R is bucketed via
    `packed_rows_bucket`; extra rows are left all-padding.
    """
    ids = np.asarray(input_ids)
    mask = np.asarray(attention_mask)
    placement, lengths, eos_off, min_rows = _ffd_place(ids, mask, eos_token_id)
    rows = packed_rows_bucket(min_rows, ids.shape[0], n_buckets)
    return _assemble(ids, lengths, eos_off, placement, rows)


def pack_captions_sharded(
    input_ids: np.ndarray,
    attention_mask: np.ndarray,
    eos_token_id: int,
    n_shards: int,
    n_buckets: int = 4,
    rows_per_shard: int = 0,
) -> Dict[str, np.ndarray]:
    """`pack_captions` per CONTIGUOUS data shard — the dp-mesh layout.

    Batch sharding over a data axis assigns contiguous row blocks to
    devices; packing the whole batch globally would place caption b's
    content tokens on another device's rows. Instead each of the
    `n_shards` row blocks packs independently into the SAME bucketed row
    count R (the max over shards, so the global [n_shards*R, S] arrays
    shard evenly), and `packed_eos_rows` are SHARD-LOCAL row indices —
    exactly what the shard_map-wrapped packed text forward gathers with.
    The extra field `rows_per_shard` carries R; callers feeding an
    UNSHARDED (global-gather) forward must globalize the rows first
    (`globalize_eos_rows`). With n_shards=1 this is `pack_captions`
    exactly (local == global).

    `rows_per_shard` (the kwarg) forces R when nonzero — multihost callers
    agree on one R across processes via an allgathered max (each process
    packs only its local rows and `put_sharded` assembles the global
    arrays, whose shape must match everywhere).
    """
    ids = np.asarray(input_ids)
    mask = np.asarray(attention_mask)
    b, s = ids.shape
    if b % n_shards != 0:
        raise ValueError(f"batch {b} not divisible by n_shards {n_shards}")
    b_shard = b // n_shards
    placed = [
        _ffd_place(
            ids[i * b_shard:(i + 1) * b_shard],
            mask[i * b_shard:(i + 1) * b_shard],
            eos_token_id,
        )
        for i in range(n_shards)
    ]
    min_rows = max(p[3] for p in placed)
    rows = packed_rows_bucket(min_rows, b_shard, n_buckets)
    if rows_per_shard:
        if rows_per_shard < min_rows:
            raise ValueError(
                f"forced rows_per_shard {rows_per_shard} < required {min_rows}"
            )
        rows = rows_per_shard
    parts = [
        _assemble(
            ids[i * b_shard:(i + 1) * b_shard], lengths, eos_off, placement,
            rows,
        )
        for i, (placement, lengths, eos_off, _) in enumerate(placed)
    ]
    out = {
        k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]
    }
    out["rows_per_shard"] = np.int32(rows)
    return out


def globalize_eos_rows(
    packed: Dict[str, np.ndarray], n_shards: int, first_shard: int = 0
):
    """Convert shard-LOCAL packed_eos_rows to GLOBAL row indices (for an
    unsharded gather, e.g. the XLA module path under GSPMD).

    `first_shard`: global index of this block's first shard — under
    multihost each process packs only its local rows, but the unsharded
    gather indexes the ASSEMBLED global array."""
    rows = int(packed["rows_per_shard"])
    b = packed["packed_eos_rows"].shape[0]
    b_shard = b // n_shards
    offsets = np.repeat(
        (first_shard + np.arange(n_shards, dtype=np.int32)) * rows, b_shard
    )
    out = dict(packed)
    out["packed_eos_rows"] = packed["packed_eos_rows"] + offsets
    return out


def min_rows_sharded(
    input_ids: np.ndarray, attention_mask: np.ndarray, eos_token_id: int,
    n_shards: int,
) -> int:
    """Max over shards of the FFD row count — the quantity multihost
    processes allgather-max so every process forces the same
    `rows_per_shard` into `pack_captions_sharded`."""
    ids = np.asarray(input_ids)
    mask = np.asarray(attention_mask)
    b = ids.shape[0]
    b_shard = b // n_shards
    return max(
        _ffd_place(
            ids[i * b_shard:(i + 1) * b_shard],
            mask[i * b_shard:(i + 1) * b_shard],
            eos_token_id,
        )[3]
        for i in range(n_shards)
    )
