"""The port's retrieval eval against the JAX package on the CPU:

- `ops.retrieval` ranks and metrics on the same similarity, random and
  tie-heavy (quantized scores, a constant block), as in
  `tests/test_retrieval.py:52-92`: ranks exactly; R@k exactly (counts over
  the same N); MAP at 1e-6 (an f32 mean summed in another order);
- `eval.retrieval.evaluate_retrieval` over PNG files in a temporary
  directory (one unreadable: a zero image on both sides), with the tiny
  CLIP's weights bridged from the JAX params: image and caption embeddings
  at atol 1e-4 in f32 (two f32 towers of two layers), identical ranks
  and metrics;
- packed against unpacked caption embeddings (atol 1e-5: the same rows
  summed in other positions), and against the JAX packed encode;
- `preprocess_image` bit-equal to the JAX one, and raising (not zero
  filling) without PIL; `load_eval_items` and the Karpathy builder CLI
  against the JAX ones.
"""
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from dclip_tpu.ops import retrieval as jret
from dclip_tpu_torch.data.tokenizer import HashTokenizer
from dclip_tpu_torch.eval import retrieval as ev
from dclip_tpu_torch.ops import retrieval as ret

import torch_parity

EMB_TOL = dict(rtol=0, atol=1e-4)
MAP_TOL = 1e-6


def _sims(kind, seed=0, n_images=20, caps_per_image=5):
    rng = np.random.RandomState(seed)
    c2i = np.repeat(np.arange(n_images), caps_per_image)
    sim = rng.randn(n_images * caps_per_image, n_images).astype(np.float32)
    if kind == "quantized":  # scores in {-1, -0.5, .., 1}: ties everywhere
        sim = np.clip(np.round(sim * 2) / 2, -1, 1).astype(np.float32)
    elif kind == "constant_block":
        sim[:, 5:12] = 0.25
    return sim, c2i


@pytest.mark.parametrize("kind", ["random", "quantized", "constant_block"])
def test_ranks_match_jax(kind):
    sim, c2i = _sims(kind)
    got_t2i = ret.t2i_ranks(torch.from_numpy(sim), torch.from_numpy(c2i))
    got_i2t = ret.i2t_ranks(torch.from_numpy(sim), torch.from_numpy(c2i), chunk=7)
    np.testing.assert_array_equal(got_t2i.numpy(),
                                  np.asarray(jret.t2i_ranks(jnp.asarray(sim), jnp.asarray(c2i))))
    np.testing.assert_array_equal(
        got_i2t.numpy(), np.asarray(jret.i2t_ranks(jnp.asarray(sim), jnp.asarray(c2i), chunk=7)))
    # and np.argsort(-sim)'s stable order, directly
    want_t2i = [int(np.where(np.argsort(-sim[c], kind="stable") == g)[0][0])
                for c, g in enumerate(c2i)]
    np.testing.assert_array_equal(got_t2i.numpy(), want_t2i)
    assert got_t2i.dtype == torch.int32 and got_i2t.dtype == torch.int32


def _hold_metrics(got, want):
    for d in ("t2i", "i2t"):
        for k in ("R@1", "R@5", "R@10"):
            assert float(got[d][k]) == float(want[d][k]), (d, k)
        assert abs(float(got[d]["MAP"]) - float(want[d]["MAP"])) <= MAP_TOL, d


@pytest.mark.parametrize("kind", ["random", "duplicated_images", "perfect"])
def test_metrics_match_jax(kind):
    rng = np.random.RandomState(1)
    img = rng.randn(20, 8).astype(np.float32)
    cap = rng.randn(100, 8).astype(np.float32)
    c2i = np.repeat(np.arange(20), 5)
    if kind == "duplicated_images":  # equal similarities in whole columns
        img[10:] = img[:10]
    elif kind == "perfect":
        cap = np.repeat(img, 5, axis=0)
    got = ret.retrieval_metrics(cap, img, c2i, device="cpu")
    _hold_metrics(got, jret.retrieval_metrics(jnp.asarray(cap), jnp.asarray(img),
                                              jnp.asarray(c2i)))
    if kind == "perfect":
        assert float(got["t2i"]["R@1"]) == 1.0 and float(got["i2t"]["MAP"]) == 1.0


def test_metrics_default_to_the_card_and_sharded_waits(monkeypatch):
    """Both default to the card; the sharded metrics run (N ranks:
    tests/test_torch_dp_eval.py) and on the one-rank mesh equal the
    unsharded ones, with an i2t chunk that leaves a ragged tail."""
    from dclip_tpu_torch.parallel.mesh import local_mesh

    rng = np.random.RandomState(4)
    img = rng.randn(9, 8).astype(np.float32)
    cap = rng.randn(20, 8).astype(np.float32)
    c2i = np.arange(20) % 9
    got = ret.retrieval_metrics_sharded(cap, img, c2i, local_mesh(), i2t_chunk=4, device="cpu")
    want = ret.retrieval_metrics(cap, img, c2i, device="cpu")
    assert {d: {k: v.item() for k, v in m.items()} for d, m in got.items()} == \
        {d: {k: v.item() for k, v in m.items()} for d, m in want.items()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ret.retrieval_metrics(np.zeros((2, 4)), np.zeros((2, 4)), np.arange(2))
    with pytest.raises(RuntimeError, match="is_available"):
        ret.retrieval_metrics_sharded(cap, img, c2i, local_mesh())


# -- the eval protocol on files, against the JAX package ---------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    jmodel, params = torch_parity.jax_clip(cfg, seed=3)
    return cfg, jmodel, params, torch_parity.port_clip(cfg, params)


@pytest.fixture
def eval_items(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(4)
    items = []
    for i in range(6):
        path = str(tmp_path / f"img{i}.png")
        if i == 4:
            with open(path, "wb") as f:
                f.write(b"not a png")  # unreadable: a zero image on both sides
        else:
            size = (40 + 4 * i, 48)
            Image.fromarray((rng.rand(*size, 3) * 255).astype("uint8")).save(path)
        caps = [f"a photo of thing {i}", f"object number {i} on a table"][: 1 + i % 2]
        items.append({"image_path": path, "image_id": i, "captions": caps})
    items.append({"image_path": str(tmp_path / "img0.png"), "image_id": 9, "captions": []})
    path = tmp_path / "eval.json"
    path.write_text(json.dumps(items))
    return str(path)


def test_evaluate_retrieval_matches_jax(tiny, eval_items):
    from dclip_tpu.eval import retrieval as jev

    cfg, jmodel, params, model = tiny
    items = ev.load_eval_items(eval_items, max_images=10)
    assert items == jev.load_eval_items(eval_items, max_images=10) and len(items) == 6
    tok, jtok = HashTokenizer(1000, cfg.text.max_length), JaxHashTokenizer(1000,
                                                                           cfg.text.max_length)
    size = cfg.vision.image_size
    paths = [it["image_path"] for it in items]
    img = ev.embed_images(model, paths, batch_size=4, image_size=size)
    want_img = jev.embed_images(jmodel, {"params": params}, paths, batch_size=4, image_size=size)
    np.testing.assert_allclose(img, np.asarray(want_img), **EMB_TOL)
    caps = [c for it in items for c in it["captions"]]
    cap = ev.embed_captions(model, tok, caps, batch_size=4)
    np.testing.assert_allclose(cap, np.asarray(jev.embed_captions(
        jmodel, {"params": params}, jtok, caps, batch_size=4)), **EMB_TOL)
    for packed in (False, True):
        got = ev.evaluate_retrieval(model, tok, items, batch_size=4, image_size=size,
                                    packed_captions=packed)
        want = jev.evaluate_retrieval(jmodel, {"params": params}, jtok, items, batch_size=4,
                                      image_size=size, packed_captions=packed)
        _hold_metrics(got, want)
    # The ranks themselves on the JAX side's embeddings: exactly equal.
    c2i = np.asarray([i for i, it in enumerate(items) for _ in it["captions"]])
    sim = ret.similarity_matrix(torch.from_numpy(cap), torch.from_numpy(img))
    jsim = jret.similarity_matrix(jnp.asarray(cap), jnp.asarray(img))
    np.testing.assert_allclose(sim.numpy(), np.asarray(jsim), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ret.i2t_ranks(torch.from_numpy(np.array(jsim)),
                                                torch.from_numpy(c2i)).numpy(),
                                  np.asarray(jret.i2t_ranks(jsim, jnp.asarray(c2i))))


def test_packed_captions_match_unpacked(tiny):
    from dclip_tpu.eval import retrieval as jev

    cfg, jmodel, params, model = tiny
    rng = np.random.RandomState(5)
    words = ["dog", "cat", "red", "car", "on", "a", "the", "sofa", "two", "park"]
    caps = [" ".join(rng.choice(words, rng.randint(1, 9))) for _ in range(11)]
    tok = HashTokenizer(1000, cfg.text.max_length)
    unpacked = ev.embed_captions(model, tok, caps, batch_size=8)
    packed = ev.embed_captions(model, tok, caps, batch_size=8, packed=True)
    np.testing.assert_allclose(packed, unpacked, rtol=0, atol=1e-5)
    want = jev.embed_captions(jmodel, {"params": params}, JaxHashTokenizer(1000,
                                                                           cfg.text.max_length),
                              caps, batch_size=8, packed=True)
    np.testing.assert_allclose(packed, np.asarray(want), **EMB_TOL)


def test_preprocess_image_matches_jax_and_needs_pil(monkeypatch):
    from PIL import Image

    from dclip_tpu.data.pipeline import preprocess_image as jax_preprocess
    from dclip_tpu_torch.data.pipeline import preprocess_image

    im = Image.fromarray((np.random.RandomState(6).rand(30, 45, 3) * 255).astype("uint8"))
    np.testing.assert_array_equal(preprocess_image(im, 24), jax_preprocess(im, 24))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs PIL, which this installation lacks"):
        preprocess_image(im, 24)
    with pytest.raises(ImportError, match="needs PIL, which this installation lacks"):
        ev.embed_images(None, ["any.png"], image_size=24)


def test_karpathy_cli_matches_jax(tmp_path, monkeypatch):
    from dclip_tpu.cli import karpathy as jax_cli
    from dclip_tpu_torch.cli import karpathy as cli

    images = tmp_path / "flickr"
    images.mkdir()
    entries = []
    for i, split in enumerate(["test", "test", "train", "val", "test"]):
        if i != 1:  # one missing image
            (images / f"{i}.jpg").write_bytes(b"x")
        entries.append({"filename": f"{i}.jpg", "imgid": i, "split": split,
                        "sentences": [{"raw": f"caption {i} a"}, {"raw": f"caption {i} b"}]})
    src = tmp_path / "dataset_flickr30k.json"
    src.write_text(json.dumps({"images": entries}))
    monkeypatch.chdir(tmp_path)
    for module, out in ((cli, "port"), (jax_cli, "jax")):
        assert module.main(["--datasets", "flickr30k", "--flickr_dir", str(images),
                            "--karpathy_json", str(src), "--output_dir", out]) == 0
    for split in ("train", "val", "test"):
        port = (tmp_path / "port" / f"flickr30k_{split}.json").read_bytes()
        assert port == (tmp_path / "jax" / f"flickr30k_{split}.json").read_bytes()
    assert len(json.loads((tmp_path / "port" / "flickr30k_test.json").read_text())) == 2
    assert os.path.exists(tmp_path / "port" / "flickr30k_val.json")
