"""Inputs that probe K12's 3xTF32 arithmetic, and a plain emulation of it.

Shared by `test_torch_topk.py` (CPU, against the JAX package) and
`test_torch_cuda.py` (the card); imports neither jax nor the JAX package.

`csrc/topk.cu` splits each f32 operand x into big = tf32(x) (10 mantissa
bits, rounded to nearest with ties away from zero) and small = tf32(x - big)
and sums, per k8 step (8 columns, `kstep_columns`), store_small . q_big,
store_big . q_small and store_big . q_big into one f32 accumulator.
`scores_tf32` repeats that order with f32 matmuls of the same TF32 values;
its `terms` argument drops products, so that a test can show which of them
f32 accuracy needs.
"""
from __future__ import annotations

import numpy as np
import torch

# An entry with mantissa bits 2^-12 and 2^-14 below TF32's 10, exact in
# f32; at D = 512 a row of +-TRAP_C has norm 2^-0.5.
TRAP_C = (1.0 + 2.0**-12 + 2.0**-14) * 2.0**-5
THREE_TERMS = ("small_big", "big_small", "big_big")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the low 13 bits of the f32 magnitude rounded off,
    half away from zero (sign-magnitude, so one integer add does it)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    big = tf32_rna(x)
    return big, tf32_rna(x.float() - big)


def kstep_columns(d: int):
    """The columns of the kernel's k8 steps, in order (`kstep_column` in
    csrc/topk.cu): in each 32-column stage, step kk takes columns
    8 p + 2 kk and 8 p + 2 kk + 1 for p = 0..3; columns past d are zero
    there and left out here."""
    steps = []
    for base in range(0, d, 32):
        for kk in range(4):
            cols = [base + 8 * (p & 3) + 2 * kk + (p >> 2) for p in range(8)]
            if any(c < d for c in cols):
                steps.append(torch.tensor([c for c in cols if c < d]))
    return steps


def scores_tf32(queries: torch.Tensor, store: torch.Tensor, terms=THREE_TERMS) -> torch.Tensor:
    """[Q, N] scores as the kernel sums them: for each k8 step, the chosen
    products (store part first in each name) added in the kernel's order."""
    qb, qs = split_tf32(queries)
    sb, ss = split_tf32(store)
    parts = {"small_big": (qb, ss), "big_small": (qs, sb), "big_big": (qb, sb)}
    acc = torch.zeros((queries.shape[0], store.shape[0]), dtype=torch.float32)
    for cols in kstep_columns(queries.shape[1]):
        for name in terms:
            a, b = parts[name]
            acc = acc + a[:, cols] @ b[:, cols].T
    return acc


def tf32_trap(nq: int = 8, flips: int = 48, extra: int = 200, d: int = 512, seed: int = 0):
    """Queries and store of +-TRAP_C entries, mixed signs. For each query,
    `flips` store rows equal to its signs with f = 0 .. flips - 1 of them
    flipped (score TRAP_C^2 (d - 2 f), well apart), among `extra` rows of
    random signs. One TF32 product, or a 3xTF32 sum without either cross
    term, errs by >= 1e-4 on the top scores at d = 512."""
    rng = np.random.RandomState(seed)
    signs = rng.choice([-1.0, 1.0], size=(nq, d))
    rows = []
    for q in range(nq):
        for f in range(flips):
            r = signs[q].copy()
            r[rng.choice(d, f, replace=False)] *= -1.0
            rows.append(r)
    rows.extend(rng.choice([-1.0, 1.0], size=(extra, d)))
    store = np.asarray(rows)[rng.permutation(len(rows))]
    return (signs * TRAP_C).astype(np.float32), (store * TRAP_C).astype(np.float32)


def near_ties(nq: int = 8, n: int = 5000, d: int = 512, seed: int = 0, family: int = 24):
    """Unit queries and store; per query `family` store rows (1 - delta) q
    whose scores lie 2, 3, 4, 5, 2, ... x 1e-5 apart near 1 (2-5 x K12's
    tolerance), far above the random rows' (~N(0, 1 / d))."""
    rng = np.random.RandomState(seed)

    def unit(*shape):
        x = rng.standard_normal(shape)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q, store = unit(nq, d), unit(n, d)
    gaps = np.resize([2e-5, 3e-5, 4e-5, 5e-5], family - 1)
    scale = 1.0 - np.concatenate([[0.0], np.cumsum(gaps)])
    where = rng.choice(n, nq * family, replace=False).reshape(nq, family)
    for i in range(nq):
        store[where[i]] = scale[:, None] * q[i]
    return q.astype(np.float32), store.astype(np.float32)
