"""K12's plain twin and the port's k-NN search against the JAX package on
the CPU:

- `kernels.topk.topk_streamed` (on CPU tensors: its twin) against the
  Pallas `topk_streamed(interpret=True)` and the XLA `knn_search`, in the
  two cases of `tests/test_kernels.py` (a store that is not a block
  multiple; all-negative scores against padding);
- a store with duplicated rows, and k > N;
- the tie order of `ops.knn.knn_search` and `knn_or_projection`: ties go
  to the lower store index, as `jax.lax.top_k` does;
- the CUDA kernel's 3xTF32 arithmetic, emulated in plain f32 matmuls
  (`topk_cases.scores_tf32`), against the Pallas kernel and the f32 twin at
  D = 512, and on inputs built so that one TF32 product, or a 3xTF32 sum
  without either cross term, misses 1e-5 by 10x: the precision argument of
  `csrc/topk.cu`, checked where there is no card.

Scores: both sides are f32 dot products summed in another order, held at
atol 1e-5 (|score| <= ~30 here); indices exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.kernels import topk_streamed as jax_topk_streamed
from dclip_tpu.ops.knn import knn_or_projection as jax_gate
from dclip_tpu.ops.knn import knn_search as jax_knn_search
from dclip_tpu_torch.kernels import topk as tk
from dclip_tpu_torch.ops import knn
from dclip_tpu_torch.ops.retrieval import stable_topk
from topk_cases import THREE_TERMS, near_ties, scores_tf32, split_tf32, tf32_rna, tf32_trap

SCORE_TOL = dict(rtol=0, atol=1e-5)


def _hold(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **SCORE_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32


@pytest.mark.parametrize("case", ["ragged_store", "negative_scores"])
def test_twin_matches_pallas_and_xla(case):
    """The cases of tests/test_kernels.py:162,175."""
    if case == "ragged_store":
        rng = np.random.RandomState(9)
        q = rng.randn(8, 32).astype(np.float32)
        store = rng.randn(1000, 32).astype(np.float32)
        k, block = 5, 256
    else:
        rng = np.random.RandomState(10)
        q = -np.abs(rng.randn(4, 16)).astype(np.float32)
        store = np.abs(rng.randn(130, 16)).astype(np.float32)
        k, block = 3, 64
    got = tk.topk_streamed(torch.from_numpy(q), torch.from_numpy(store), k)
    _hold(got, jax_topk_streamed(jnp.asarray(q), jnp.asarray(store), k=k, block_n=block,
                                 interpret=True))
    _hold(got, jax_knn_search(jnp.asarray(q), jnp.asarray(store), k=k))
    assert (got[1].numpy() < store.shape[0]).all()


def _duplicated_store(seed=11):
    rng = np.random.RandomState(seed)
    base = rng.standard_normal((40, 16)).astype(np.float32)
    store = np.concatenate([base, base[:10], base[5:15]])  # rows 0-9 twice, 5-9 three times
    queries = np.concatenate([base[:12], rng.standard_normal((3, 16)).astype(np.float32)])
    return queries, store


def test_twin_duplicated_rows_lower_index_first():
    q, store = _duplicated_store()
    got = tk.topk_streamed(torch.from_numpy(q), torch.from_numpy(store), 4)
    _hold(got, jax_topk_streamed(jnp.asarray(q), jnp.asarray(store), k=4, block_n=16,
                                 interpret=True))
    _hold(got, jax_knn_search(jnp.asarray(q), jnp.asarray(store), k=4))
    idx = got[1].numpy()
    np.testing.assert_array_equal(idx[:5, :2], np.stack([np.arange(5), np.arange(5) + 40], 1))
    np.testing.assert_array_equal(idx[5:10, :3], np.stack(
        [np.arange(5, 10), np.arange(45, 50), np.arange(50, 55)], 1))


def test_twin_k_over_n():
    rng = np.random.RandomState(12)
    q = rng.randn(3, 8).astype(np.float32)
    store = rng.randn(2, 8).astype(np.float32)
    got = tk.topk_streamed(torch.from_numpy(q), torch.from_numpy(store), 5)
    assert got[0].shape == (3, 2)
    _hold(got, jax_topk_streamed(jnp.asarray(q), jnp.asarray(store), k=5, block_n=8,
                                 interpret=True))


def _tied_inputs(seed):
    """Scores in {0, .., 3} (integer features), so nearly every row ties."""
    rng = np.random.RandomState(seed)
    n = rng.randint(5, 300)
    q = rng.randint(0, 2, (6, 4)).astype(np.float32)
    store = rng.randint(0, 2, (n, 4)).astype(np.float32)
    return q, store, int(rng.randint(1, 11))


@pytest.mark.parametrize("seed", range(4))
def test_knn_search_tie_order_matches_jax(seed):
    """Fails with `torch.topk`, whose tie order is not `jax.lax.top_k`'s."""
    q, store, k = _tied_inputs(seed)
    got = knn.knn_search(torch.from_numpy(q), torch.from_numpy(store), k)
    _hold(got, jax_knn_search(jnp.asarray(q), jnp.asarray(store), k=k))


def test_knn_or_projection_tie_order_matches_jax():
    """A hit on a duplicated key returns the value stored at the lower
    index, as the JAX gate does."""
    rng = np.random.RandomState(13)
    keys = rng.standard_normal((30, 8)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    keys = np.concatenate([keys[10:], keys[:10], keys[:10]])  # each of 10 keys three times
    values = rng.standard_normal((keys.shape[0], 8)).astype(np.float32)
    queries = np.concatenate([keys[20:30], rng.standard_normal((3, 8))]).astype(np.float32)
    want = jax_gate(queries, None, keys, values, None, 0.85)
    got = knn.knn_or_projection(torch.from_numpy(queries), None, torch.from_numpy(keys),
                                torch.from_numpy(values), None, 0.85)
    np.testing.assert_array_equal(got.source.numpy(), np.asarray(want.source))
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(want.similarity), **SCORE_TOL)
    np.testing.assert_array_equal(got.embeddings.numpy()[:10], values[20:30])
    np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings), **SCORE_TOL)


def test_stable_topk_and_chunk_plan():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = stable_topk(scores, 4)
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0]] and idx.tolist() == [[1, 2, 4, 3]]
    for nq, n, k in ((64, 1_000_000, 10), (2048, 100_000, 3), (7, 1000, 5), (130, 5000, 64),
                     (100_000, 1000, 3)):
        rows, chunks = tk.chunk_plan(nq, n, k, 396)
        assert rows % 128 == 0 and (chunks - 1) * rows < n <= chunks * rows
        assert chunks * k <= 4096 and (chunks == 1 or chunks * -(-nq // 64) <= 396)


def test_knn_search_sharded_names_its_item():
    """`knn_search_sharded` runs (N ranks: tests/test_torch_dp_eval.py). On
    the one-rank mesh it is `knn_search` over the store's valid prefix:
    the rows past `n_valid` never win, and k beyond the valid rows fills
    -inf candidates with the padded rows' indices, as JAX's masked top-k."""
    from dclip_tpu_torch.parallel.mesh import local_mesh

    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
    store = torch.from_numpy(rng.standard_normal((10, 8)).astype(np.float32))
    store[8:] = 10.0  # padding that would win if it were searched
    got = knn.knn_search_sharded(q, store, local_mesh(), k=3, n_valid=8)
    want = knn.knn_search(q, store[:8], 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    scores, idx = knn.knn_search_sharded(q, store, local_mesh(), k=10, n_valid=8)
    assert torch.isinf(scores[:, 8:]).all() and idx[:, 8:].tolist() == [[8, 9]] * 4
    assert torch.equal(idx[:, :8].sort(1).values, torch.arange(8, dtype=idx.dtype).expand(4, 8))


# -- K12's 3xTF32 arithmetic, emulated ------------------------------------------

TF32_TOL = 1e-5  # K12's contract: within 1e-5 * max(1, |twin|) of the f32 twin


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_tf32_rna_rounds_to_nearest_ties_away():
    x = torch.tensor([1 + 2**-11, -(1 + 2**-11), 1 + 2**-12, 1 + 3 * 2**-12, 0.0, -0.0],
                     dtype=torch.float32)
    assert tf32_rna(x).tolist() == [1 + 2**-10, -(1 + 2**-10), 1.0, 1 + 2**-10, 0.0, 0.0]
    v = torch.from_numpy(np.random.RandomState(20).standard_normal(4096).astype(np.float32))
    big, small = split_tf32(v)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((v - big).abs() <= 2.0**-11 * v.abs()).all()
    # What the split drops: x - big - small, under 2^-22 |x|.
    assert ((v.double() - big.double() - small.double()).abs() <= 2.0**-22 * v.abs()).all()


def test_tf32_emulation_matches_pallas_and_twin():
    """The kernel's arithmetic on seeded unit rows at D = 512 (N cut to
    2,000): every score within 1e-5 of the f32 twin, the top-k equal to the
    Pallas kernel's and the twin's."""
    rng = np.random.RandomState(21)
    q, store = _unit(rng, 16, 512), _unit(rng, 2000, 512)
    qt, st = torch.from_numpy(q), torch.from_numpy(store)
    emu = scores_tf32(qt, st)
    twin = qt @ st.T
    assert (emu - twin).abs().max().item() <= TF32_TOL
    got = stable_topk(emu, 10)
    _hold(got, jax_topk_streamed(jnp.asarray(q), jnp.asarray(store), k=10, block_n=512,
                                 interpret=True))
    _hold(got, tk.topk_streamed_reference(qt, st, 10))


@pytest.mark.parametrize("terms,holds", [
    (THREE_TERMS, True),
    (("big_big",), False),
    (("big_small", "big_big"), False),
    (("small_big", "big_big"), False),
], ids=["3xtf32", "one_tf32_product", "no_store_small", "no_query_small"])
def test_tf32_trap_needs_both_cross_terms(terms, holds):
    """On entries with mantissa bits below TF32's, 3xTF32 stays within
    1e-5 of the exact scores; one TF32 product, or either cross term
    missing, errs by >= 1e-4 on the top scores."""
    q, store = (torch.from_numpy(a) for a in tf32_trap())
    exact = q.double() @ store.double().T
    err = (scores_tf32(q, store, terms).double() - exact).abs().max().item()
    if holds:
        assert err <= TF32_TOL, err
        assert (q @ store.T - exact).abs().max().item() <= TF32_TOL  # the f32 twin too
    else:
        assert err >= 1e-4, err


def test_tf32_emulation_orders_near_ties():
    """Scores 2-5x the tolerance apart near 1: the emulated ranking is the
    twin's, index for index."""
    q, store = (torch.from_numpy(a) for a in near_ties(n=3000))
    want_s, want_i = tk.topk_streamed_reference(q, store, 16)
    got_s, got_i = stable_topk(scores_tf32(q, store), 16)
    assert torch.equal(got_i, want_i)
    assert (got_s - want_s).abs().max().item() <= TF32_TOL
    assert ((want_s[:, :-1] - want_s[:, 1:]) > 1.5e-5).all()  # the ties are that near
