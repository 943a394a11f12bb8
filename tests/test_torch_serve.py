"""The port's serving stack (dclip_tpu_torch.serve, .data, .cli.serve)
against the JAX package's on the CPU at the tiny config: ClipService
encodings, bucket-padding invariance and search, the copied host code
(tokenizers, store, batcher, resize/crop), and the CLI selftest."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.data.tokenizer import CLIPTokenizer as JaxCLIPTokenizer
from dclip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from dclip_tpu.serve import ClipService as JaxClipService
from dclip_tpu_torch.data.tokenizer import CLIPTokenizer, HashTokenizer
from dclip_tpu_torch.serve import ClipService, DynamicBatcher, pad_to_bucket

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXTS = ["a photo of a dog", "two cats", "red car on a street", "a",
         "mountain lake at dawn"]  # n=5 spans chunks 4 + 1 at buckets (1, 2, 4)
# L2-normalized embeddings after a 2-layer tower at f32 (different sum
# orders in the two frameworks).
EMB_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def services():
    cfg = CLIPConfig.tiny_test()
    model, params = torch_parity.jax_clip(cfg, seed=0)
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    jax_tok = JaxHashTokenizer(vocab_size=cfg.text.vocab_size,
                               max_length=cfg.text.max_length)
    jax_svc = JaxClipService(model, {"params": params}, cfg, tokenizer=jax_tok,
                             buckets=(1, 2, 4), index_dim=cfg.projection_dim)
    port_svc = ClipService(torch_parity.port_clip(cfg, params), cfg, tokenizer=tok,
                           buckets=(1, 2, 4), index_dim=cfg.projection_dim, device="cpu")
    return cfg, jax_svc, port_svc


def _images(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (40 + 3 * i, 37, 3), np.uint8) for i in range(n)]


def test_encode_texts_matches_jax_service(services):
    cfg, jax_svc, port_svc = services
    got = port_svc.encode_texts(TEXTS)
    assert got.shape == (5, cfg.projection_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_svc.encode_texts(TEXTS), **EMB_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_encode_images_matches_jax_service(services):
    cfg, jax_svc, port_svc = services
    images = _images(3) + [np.random.RandomState(1).randint(
        0, 256, (cfg.vision.image_size,) * 2 + (3,), np.uint8)]
    got = port_svc.encode_images(images)
    assert got.shape == (4, cfg.projection_dim)
    np.testing.assert_allclose(got, jax_svc.encode_images(images), **EMB_TOL)


def test_padding_invariance_across_buckets(services):
    """A request's embedding does not depend on its batch: 5 items in
    chunks of 4 + 1 equal the items encoded one by one (bucket 1) and as
    a pair padded to 2 rows."""
    _, _, port_svc = services
    batch = port_svc.encode_texts(TEXTS)
    single = np.concatenate([port_svc.encode_texts([t]) for t in TEXTS])
    np.testing.assert_allclose(batch, single, rtol=1e-5, atol=1e-6)
    images = _images(5, seed=2)
    batch = port_svc.encode_images(images)
    single = np.concatenate([port_svc.encode_images([im]) for im in images])
    np.testing.assert_allclose(batch, single, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(port_svc.encode_images(images[:3])[:3], batch[:3],
                               rtol=1e-5, atol=1e-6)


def test_search_matches_jax_service(services):
    cfg, jax_svc, port_svc = services
    images = _images(6, seed=3)
    embs = port_svc.encode_images(images)
    ids = [f"img{i}" for i in range(6)]
    port_svc.add_to_index(ids, embs)
    jax_svc.add_to_index(ids, embs)
    got = port_svc.search_texts(TEXTS, k=3)
    want = jax_svc.search_texts(TEXTS, k=3)
    assert [r[0][0] for r in got] == [r[0][0] for r in want]
    np.testing.assert_allclose([[s for _, s in r] for r in got],
                               [[s for _, s in r] for r in want], **EMB_TOL)
    self_hits = port_svc.search(embs, k=1)
    assert [r[0][0] for r in self_hits] == ids
    assert self_hits[0][0][1] == pytest.approx(1.0, abs=1e-5)
    assert port_svc.search(np.zeros((0, cfg.projection_dim)), k=2) == []


def test_service_refuses_what_is_not_ported():
    """`quantize` other than int8 is a ValueError, as in the JAX service; a
    mesh is a `parallel.mesh.Mesh`, and a bare data size (what the serve
    CLI once passed) is a TypeError."""
    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=0)
    model = torch_parity.port_clip(cfg, params)
    with pytest.raises(ValueError, match="quantize"):
        ClipService(model, cfg, quantize="fp4", device="cpu")
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ClipService(model, cfg, mesh=2, device="cpu")


def test_image_route_follows_the_jax_service(services):
    """K1 / K2 only for a bf16 model on CUDA; f32 and the CPU take the
    module path (`dclip_tpu/serve/service.py:96-118`), where the f32
    service's images equal `CLIPModule.image_features` bit for bit."""
    from dclip_tpu_torch.models.encoding import image_route

    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert image_route(cuda, torch.bfloat16) == "kernels"
    assert {image_route(cuda, torch.float32), image_route(cpu, torch.bfloat16),
            image_route(cpu, torch.float32)} == {"module"}
    cfg, _, port_svc = services
    assert port_svc.image_route == "module"
    u8 = np.random.RandomState(4).randint(0, 256, (3,) + (cfg.vision.image_size,) * 2 + (3,),
                                          np.uint8)
    with torch.no_grad():
        from dclip_tpu_torch.ops.image_ops import normalize

        feats = port_svc.model.image_features(normalize(torch.from_numpy(u8).float() / 255.0))
    want = (feats / feats.norm(dim=-1, keepdim=True)).numpy()
    np.testing.assert_array_equal(port_svc.encode_images(list(u8))[:3], want)


def test_pad_to_bucket():
    assert [pad_to_bucket(n, (1, 4, 16)) for n in (1, 3, 16)] == [1, 4, 16]
    for n in (0, 17):
        with pytest.raises(ValueError):
            pad_to_bucket(n, (1, 4, 16))


def test_tokenizers_match_jax(tmp_path):
    texts = TEXTS + ["the cat and the dog run in the park", "  extra   whitespace \t "]
    a = HashTokenizer(vocab_size=1000, max_length=16).encode_batch(texts)
    b = JaxHashTokenizer(vocab_size=1000, max_length=16).encode_batch(texts)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    import json

    from dclip_tpu_torch.data.tokenizer import bytes_to_unicode

    base = list(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(base + [c + "</w>" for c in base])}
    merges = [("t", "h"), ("th", "e</w>"), ("c", "a"), ("ca", "t</w>")]
    for m in merges:
        vocab.setdefault("".join(m), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    a = CLIPTokenizer.from_pretrained_dir(str(tmp_path), 16).encode_batch(texts)
    b = JaxCLIPTokenizer.from_pretrained_dir(str(tmp_path), 16).encode_batch(texts)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("suffix", [".npz", ".dcs"])
def test_embedding_store_round_trip_and_jax_interop(tmp_path, suffix):
    from dclip_tpu.data.embedding_store import EmbeddingStore as JaxStore
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    rng = np.random.RandomState(4)
    keys = rng.standard_normal((5, 8)).astype(np.float32)
    store = EmbeddingStore(dim=8)
    store.add_batch([f"k{i}" for i in range(5)], keys)
    np.testing.assert_allclose(np.linalg.norm(store.keys, axis=-1), 1.0, rtol=1e-6)
    path = str(tmp_path / f"store{suffix}")
    store.save(path)
    for loaded in (EmbeddingStore.load(path), JaxStore.load(path)):
        assert loaded.ids == store.ids and loaded.dim == 8
        np.testing.assert_array_equal(loaded.keys, store.keys)
    with pytest.raises(ValueError, match="dim"):
        store.add("bad", np.ones(3))


def test_batcher_merges_and_keeps_order():
    with DynamicBatcher(lambda xs: [x * 10 for x in xs], max_batch=4,
                        max_wait_s=0.01) as b:
        assert b.submit_many(list(range(10))) == [x * 10 for x in range(10)]
        s = b.stats()
    assert s["items"] == 10 and s["batches"] >= 3 and s["mean_batch_size"] <= 4


def test_resize_crop_matches_jax_pipeline():
    from PIL import Image

    from dclip_tpu.data.pipeline import resize_crop_uint8 as jax_resize_crop
    from dclip_tpu_torch.data.pipeline import resize_crop_uint8

    for im in _images(3, seed=5):
        pil = Image.fromarray(im)
        np.testing.assert_array_equal(resize_crop_uint8(pil, 32), jax_resize_crop(pil, 32))


def test_cli_selftest_subprocess():
    out = subprocess.run(
        [sys.executable, "-m", "dclip_tpu_torch.cli.serve", "--device", "cpu",
         "--model_preset", "tiny", "--selftest", "--index_dim", "16"],
        capture_output=True, text=True, timeout=240, cwd=REPO,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "SELFTEST OK" in out.stdout
    assert '"id": "probe"' in out.stdout


def test_cli_refuses_export_and_default_cuda_without_card(monkeypatch, tmp_path):
    """An export platform other than cpu / cuda is a ValueError; without a
    card the default device (cuda) raises, with no fall-back to the CPU."""
    from dclip_tpu_torch.cli import serve as cli_serve

    with pytest.raises(ValueError, match="platforms"):
        cli_serve.main(["--device", "cpu", "--model_preset", "tiny", "--export_dir",
                        str(tmp_path / "x"), "--export_platforms", "tpu"])
    assert not (tmp_path / "x").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        cli_serve.main(["--model_preset", "tiny", "--selftest"])


# -- the device-resident index ----------------------------------------------------


def _unit_rows(n, dim, seed):
    v = np.random.RandomState(seed).standard_normal((n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _cpu_service(cfg, **kw):
    _, params = torch_parity.jax_clip(cfg, seed=0)
    return ClipService(torch_parity.port_clip(cfg, params), cfg, buckets=(1, 4),
                       device="cpu", **kw)


def test_search_equals_knn_over_the_store_keys():
    """After each add, `search` returns what `knn_search` gives over the
    store's host keys, equal ids and equal bits; the device keys and the id
    snapshot are built once per add, not per search."""
    from dclip_tpu_torch.ops.knn import knn_search

    cfg = CLIPConfig.tiny_test()
    svc = _cpu_service(cfg, index_dim=cfg.projection_dim)
    queries = _unit_rows(6, cfg.projection_dim, seed=11)
    rows = _unit_rows(30, cfg.projection_dim, seed=12)
    for lo, hi in ((0, 7), (7, 30)):
        svc.add_to_index([f"r{i}" for i in range(lo, hi)], rows[lo:hi])
        assert svc._index_keys is None
        hits = svc.search(queries, k=4)
        keys, ids = svc._index_keys, svc._index_ids
        assert svc.search(queries, k=4) == hits
        assert svc._index_keys is keys and svc._index_ids is ids
        scores, idx = knn_search(torch.from_numpy(queries),
                                 torch.as_tensor(svc._index.keys), 4)
        assert [[i for i, _ in row] for row in hits] == [
            [f"r{j}" for j in row] for row in idx.numpy()]
        assert np.array_equal(np.asarray([[s for _, s in row] for row in hits], np.float32),
                              scores.numpy())


def test_an_add_is_visible_to_the_next_search():
    cfg = CLIPConfig.tiny_test()
    svc = _cpu_service(cfg, index_dim=cfg.projection_dim)
    rows = _unit_rows(4, cfg.projection_dim, seed=13)
    svc.add_to_index(["a", "b", "c"], rows[:3])
    assert [r[0][0] for r in svc.search(rows, k=1)][:3] == ["a", "b", "c"]
    svc.add_to_index(["d"], rows[3:])
    (hits,) = svc.search(rows[3:], k=1)
    assert hits[0][0] == "d" and hits[0][1] == pytest.approx(1.0, abs=1e-6)


def test_search_sees_concurrent_adds():
    """`test_search_sees_concurrent_adds` of `tests/test_serve.py`, ported
    to the device-resident index: one adder and two searchers race; a
    search's device copy built before an add must not hide that add, so
    every add is visible after the race."""
    import sys
    import threading

    cfg = CLIPConfig.tiny_test()
    svc = _cpu_service(cfg, index_dim=cfg.projection_dim)
    vecs = _unit_rows(40, cfg.projection_dim, seed=7)
    errors = []

    def adder():
        try:
            for i in range(40):
                svc.add_to_index([f"v{i}"], vecs[i:i + 1])
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    def searcher():
        try:
            for _ in range(60):
                if svc.index_size:
                    svc.search(vecs[:2], k=1)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=adder)] + [
            threading.Thread(target=searcher) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert svc.index_size == 40
    (hits,) = svc.search(vecs[39:40], k=1)
    assert hits[0][0] == "v39"
    assert [row[0][0] for row in svc.search(vecs, k=1)] == [f"v{i}" for i in range(40)]


def test_device_arrays_equal_the_store_arrays():
    """`device_arrays` gives (keys, values) as f32 tensors on the device;
    a store without explicit values moves one matrix for both; with a
    mesh, this rank's row shard of a store padded to the mesh size
    (`pad_to_multiple`), an uneven split raising."""
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    rows = _unit_rows(5, 8, seed=14)
    store = EmbeddingStore(dim=8)
    store.add_batch([f"k{i}" for i in range(5)], rows)
    keys, values = store.device_arrays("cpu")
    assert keys.dtype == torch.float32 and keys is values
    np.testing.assert_array_equal(keys.numpy(), store.keys)
    np.testing.assert_array_equal(values.numpy(), store.values)
    vals = _unit_rows(5, 8, seed=15) * 3
    store.add_batch(["x"], rows[:1], values=vals[:1])
    keys, values = store.device_arrays(torch.device("cpu"))
    assert keys.shape == values.shape == (6, 8)
    np.testing.assert_array_equal(keys.numpy(), store.keys)
    np.testing.assert_array_equal(values.numpy(), store.values)
    np.testing.assert_array_equal(values.numpy()[5], vals[0])
    loaded = EmbeddingStore.from_arrays(store.keys, store.values, ids=store.ids)
    for got, want in zip(loaded.device_arrays("cpu"), (store.keys, store.values)):
        np.testing.assert_array_equal(got.numpy(), want)
    from dclip_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(ValueError, match="evenly"):
        store.device_arrays("cpu", mesh=Mesh(size=4, rank=0))
    padded = store.pad_to_multiple(4)
    assert len(padded) == 8 and padded.ids[6:] == ["<pad>", "<pad>"]
    assert padded.pad_to_multiple(4) is padded and store.pad_to_multiple(6) is store
    keys, values = padded.device_arrays("cpu", mesh=Mesh(size=4, rank=2))
    np.testing.assert_array_equal(keys.numpy(), store.keys[4:6])
    np.testing.assert_array_equal(values.numpy(), store.values[4:6])
    keys, values = padded.device_arrays("cpu", mesh=Mesh(size=4, rank=3))
    assert not keys.any() and not values.any()  # the sentinels: zero keys and values
    shard, same = EmbeddingStore.from_arrays(rows).device_arrays("cpu", mesh=Mesh(size=5,
                                                                                    rank=1))
    assert shard is same and shard.shape == (1, 8)


def test_build_service_from_student_checkpoint(tmp_path):
    """`--student_checkpoint` (`tests/test_serve.py:449-489`, ported): a
    perturbed text projection saved by the port's `CheckpointManager`
    changes the served text embeddings, which equal those of a service
    given the same weights directly."""
    from dclip_tpu_torch.cli import serve as cli_serve
    from dclip_tpu_torch.cli.common import load_clip
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    flags = ["--device", "cpu", "--model_preset", "tiny", "--seed", "0", "--buckets", "1,4"]
    cfg, model = load_clip("tiny", "random", seed=0, device="cpu")
    sd = model.state_dict()
    sd["text_projection.weight"] = sd["text_projection.weight"] + torch.from_numpy(
        np.random.RandomState(5).randn(*sd["text_projection.weight"].shape).astype(np.float32))
    CheckpointManager(str(tmp_path)).save({"params": sd, "step": 3}, step=3, epoch=0)
    svc = cli_serve.build_service(cli_serve.parse_args(
        flags + ["--student_checkpoint", str(tmp_path)]))
    base = cli_serve.build_service(cli_serve.parse_args(flags))
    texts = ["a dog in the park", "two cats"]
    served, original = svc.encode_texts(texts), base.encode_texts(texts)
    assert served.shape == original.shape
    assert not np.allclose(served, original)
    model.load_state_dict(sd)
    direct = ClipService(model, cfg, tokenizer=base.tokenizer, buckets=(1, 4), device="cpu")
    np.testing.assert_array_equal(served, direct.encode_texts(texts))
