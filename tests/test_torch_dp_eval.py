"""Sharded search and eval in the port on N gloo ranks
(tests/torch_dp_worker.py): `knn_search_sharded` over a store padded with
`EmbeddingStore.pad_to_multiple` against JAX's in `shard_map` over N CPU
devices and against the one-rank `knn_search` (padded rows never win);
`retrieval_metrics_sharded` equal to `retrieval_metrics` and to JAX's;
`evaluate_retrieval`, its embeddings and `evaluate_zero_shot` with `mesh=`
over 2 ranks equal to one rank."""
import json

import numpy as np
import pytest
import torch

import torch_dp
import torch_parity

from dclip_tpu_torch.core.config import CLIPConfig
from dclip_tpu_torch.models.weights import state_dict_from_jax

D, Q = 32, 6
# name, store rows, k: a store whose last shard holds padding, k over a
# shard's rows, a store smaller than 2 rows a rank.
KNN_CASES = (("n103_k3", 103, 3), ("n103_k7", 103, 7), ("n5_k3", 5, 3))
MAP_TOL = 1e-6  # as tests/test_torch_retrieval.py: the MAP sums in another order


def _unit(rng, n):
    x = rng.standard_normal((n, D)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    from PIL import Image

    tmp = tmp_path_factory.mktemp("dp_eval")
    rng = np.random.RandomState(11)
    arrays = {"keys103": _unit(rng, 103), "keys5": _unit(rng, 5)}
    arrays["keys103"][60] = arrays["keys103"][10]  # a tie: the lower index first
    queries = _unit(rng, Q)
    queries[0] = arrays["keys103"][10]
    img = rng.standard_normal((7, 8)).astype(np.float32)
    img[4] = img[1]  # duplicated images: stable ranks
    arrays.update(queries=queries, img=img, cap=rng.standard_normal((13, 8)).astype(np.float32),
                  c2i=np.array([0, 0, 1, 1, 2, 3, 3, 4, 4, 5, 6, 6, 1], np.int64))
    np.savez(tmp / "inputs.npz", **arrays)

    cfg = CLIPConfig.tiny_test()
    torch.save(state_dict_from_jax(torch_parity.jax_clip_fan_in(cfg, seed=4), cfg),
               tmp / "clip.pt")
    items = []
    for i in range(7):
        path = str(tmp / f"img{i}.png")
        Image.fromarray((rng.rand(20 + i, 30, 3) * 255).astype("uint8")).save(path)
        items.append({"image_path": path, "image_id": i,
                      "captions": [f"a photo of thing {i}", f"object {i} on a table"][:1 + i % 2]})
    (tmp / "items.json").write_text(json.dumps(items))
    s = cfg.vision.image_size
    np.savez(tmp / "pixels.npz", pixels=rng.standard_normal((11, s, s, 3)).astype(np.float32),
             labels=rng.randint(0, 7, size=11), text=_unit(rng, 7)[:, :cfg.projection_dim])
    spec = {"scenario": "search", "inputs": str(tmp / "inputs.npz"),
            "knn": [{"name": n, "keys": f"keys{rows}", "k": k} for n, rows, k in KNN_CASES]}
    return tmp, arrays, spec, cfg


@pytest.fixture(scope="module", params=[2, 4], ids=["N2", "N4"])
def ranks(request, inputs):
    tmp, _, spec, _ = inputs
    n = request.param
    if n == 2:  # the eval protocol too, on 2 ranks
        spec = dict(spec, eval={"clip": str(tmp / "clip.pt"), "items": str(tmp / "items.json"),
                                "pixels": str(tmp / "pixels.npz")})
    return n, torch_dp.run_ranks(tmp, f"search_{n}", spec, n)


def _jax_knn(keys, queries, n, k):
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from dclip_tpu.ops.knn import knn_search_sharded

    n_valid = keys.shape[0]
    pad = (-n_valid) % n
    padded = np.concatenate([keys, np.zeros((pad, D), np.float32)])
    mesh = Mesh(np.array(jax.devices("cpu")[:n]), ("data",))
    fn = shard_map(lambda q, s: knn_search_sharded(q, s, "data", k, jnp.asarray(n_valid)),
                   mesh=mesh, in_specs=(P(), P("data")), out_specs=P(), check_vma=False)
    scores, idx = jax.jit(fn)(queries, padded)
    return np.asarray(scores), np.asarray(idx)


@pytest.mark.parametrize("case", KNN_CASES, ids=[c[0] for c in KNN_CASES])
def test_knn_search_sharded_matches_jax_and_one_rank(inputs, ranks, case):
    from dclip_tpu_torch.ops.knn import knn_search

    _, arrays, _, _ = inputs
    n, outs = ranks
    name, rows, k = case
    keys, queries = arrays[f"keys{rows}"], arrays["queries"]
    want_s, want_i = _jax_knn(keys, queries, n, k)
    one_s, one_i = knn_search(torch.from_numpy(queries), torch.from_numpy(keys), k)
    for out in outs:
        scores, idx = out[f"knn_{name}"]
        np.testing.assert_array_equal(idx.numpy(), want_i)
        np.testing.assert_allclose(scores.numpy(), want_s, rtol=1e-6, atol=1e-6)
        if k <= rows:  # padded rows never win
            np.testing.assert_array_equal(idx.numpy(), one_i.numpy())
            np.testing.assert_allclose(scores.numpy(), one_s.numpy(), rtol=1e-6, atol=1e-6)
            assert idx.max().item() < rows
    if name == "n103_k3":
        assert outs[0][f"knn_{name}"][1][0, :2].tolist() == [10, 60]


def test_retrieval_metrics_sharded_equal_one_rank_and_jax(inputs, ranks):
    import jax.numpy as jnp

    from dclip_tpu.ops import retrieval as jret
    from dclip_tpu_torch.ops.retrieval import retrieval_metrics

    _, arrays, _, _ = inputs
    n, outs = ranks
    cap, img, c2i = arrays["cap"], arrays["img"], arrays["c2i"]
    one = retrieval_metrics(cap, img, c2i, device="cpu")
    want = jret.retrieval_metrics(jnp.asarray(cap), jnp.asarray(img), jnp.asarray(c2i))
    for out in outs:
        for d in ("t2i", "i2t"):
            for key, v in out["metrics"][d].items():
                assert v.item() == one[d][key].item(), (n, d, key)
                if key == "MAP":
                    assert abs(v.item() - float(want[d][key])) <= MAP_TOL
                else:
                    assert v.item() == float(want[d][key]), (n, d, key)


@pytest.mark.parametrize("ranks", [2], indirect=True, ids=["N2"])
def test_eval_with_a_mesh_equals_one_rank(inputs, ranks):
    """`embed_images` / `embed_captions` (packed per rank) over 2 ranks give
    every row of the one-rank encode; `evaluate_retrieval` and
    `evaluate_zero_shot` give its numbers."""
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.eval.retrieval import embed_captions, embed_images, evaluate_retrieval
    from dclip_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from dclip_tpu_torch.models.clip import CLIPModule

    tmp, _, _, cfg = inputs
    _, outs = ranks
    model = CLIPModule(cfg, device="meta")
    model.load_state_dict(torch.load(tmp / "clip.pt", weights_only=True), strict=True,
                          assign=True)
    model.eval()
    items = json.loads((tmp / "items.json").read_text())
    tok = HashTokenizer(vocab_size=1000, max_length=cfg.text.max_length)
    size = cfg.vision.image_size
    caps = [c for it in items for c in it["captions"]]
    images = embed_images(model, [it["image_path"] for it in items], 4, size)
    captions = embed_captions(model, tok, caps, 4, packed=True)
    retrieval = evaluate_retrieval(model, tok, items, 4, size, packed_captions=True)
    with np.load(tmp / "pixels.npz") as z:
        pixels, labels, text = z["pixels"], z["labels"], z["text"]
    zero_shot = evaluate_zero_shot(
        model, torch.from_numpy(text),
        [(pixels[i:i + 5], labels[i:i + 5]) for i in range(0, len(labels), 5)])
    for out in outs:
        np.testing.assert_allclose(out["images"], images, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["captions"], captions, rtol=1e-5, atol=1e-6)
        assert out["retrieval"] == retrieval
        assert out["zero_shot"] == zero_shot and zero_shot["total"] == 11
