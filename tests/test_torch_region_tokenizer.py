"""The port's region-token path against the JAX package on the CPU:

- `models.projections`: both projection heads on bridged weights
  (`models.weights.projection_state_dict_from_jax`), the port's file
  format round trip;
- `ops.knn.knn_or_projection` with the projection branch: hits,
  projection misses, an empty store, no positions;
- `models.region_tokenizer.RegionTokenizer`: `batch_tokenize` and
  `evaluate_threshold` (one region encode, one gate per threshold);
- `data.index.build_patch_index` on PNGs, an unreadable file among them;
- the three CLIs, `precache` (grid, the port's detector from a state dict
  beside JAX's from msgpack, and an ultralytics checkpoint; with
  --build_index), `build_index` and `tune_gate`, on PNGs in a temporary
  directory beside the JAX CLIs on the same weights.

Tolerances: the tiny CLIP and the projection head are f32 on both sides,
sums in another order: embeddings within 1e-5. Ids, positions, sources,
counts and detection caches from the grid are exact; a detector's boxes
are within 1e-4 pixels.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.models import projections as jproj
from dclip_tpu_torch.data.embedding_store import EmbeddingStore
from dclip_tpu_torch.models import projections as proj
from dclip_tpu_torch.models.region_tokenizer import RegionTokenizer
from dclip_tpu_torch.models.weights import projection_state_dict_from_jax
from dclip_tpu_torch.ops import knn

import torch_parity

EMB_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# -- projection heads ------------------------------------------------------------------


def test_image_projection_matches_jax(tmp_path):
    params = torch_parity.jax_projection_params(16, seed=1, hidden=64)
    rng = np.random.RandomState(2)
    q = rng.standard_normal((7, 16)).astype(np.float32)
    pos = rng.rand(7, 4).astype(np.float32)
    want = jproj.ImageProjectionModule(clip_dim=16, hidden_dim=64).apply({"params": params}, q, pos)
    sd = projection_state_dict_from_jax(params)
    module = proj.ImageProjectionModule(16, hidden_dim=64)
    module.load_state_dict(sd)
    np.testing.assert_allclose(module(_t(q), _t(pos)).detach().numpy(), np.asarray(want),
                               **EMB_TOL)
    fn = proj.projection_apply_fn(proj.ImageProjectionModule(16, 64, device="meta"), sd)
    np.testing.assert_allclose(fn(_t(q), _t(pos)).numpy(), np.asarray(want), **EMB_TOL)
    # The port's file format: a torch.save state dict, checked on load.
    _, fresh = proj.init_image_projection(seed=3, clip_dim=16)
    proj.save_image_projection(str(tmp_path / "p.pt"), fresh)
    module, back = proj.load_image_projection(str(tmp_path / "p.pt"), clip_dim=16)
    assert isinstance(module, proj.ImageProjectionModule)
    assert set(back) == set(fresh) and all(torch.equal(back[k], fresh[k]) for k in fresh)
    assert tuple(back["fc1.weight"].shape) == (1024, 20)
    with pytest.raises(ValueError, match="fc1.weight has shape"):
        proj.load_image_projection(str(tmp_path / "p.pt"), clip_dim=32)


def test_text_projection_matches_jax():
    rng = np.random.RandomState(3)
    params = {"fc1": {"kernel": rng.standard_normal((768, 1024)).astype(np.float32) * 0.03,
                      "bias": rng.standard_normal(1024).astype(np.float32) * 0.1},
              "fc2": {"kernel": rng.standard_normal((1024, 512)).astype(np.float32) * 0.03,
                      "bias": rng.standard_normal(512).astype(np.float32) * 0.1}}
    x = rng.standard_normal((3, 768)).astype(np.float32)
    want = jproj.TextProjectionModule().apply({"params": params}, x)
    module = proj.TextProjectionModule()
    module.load_state_dict(projection_state_dict_from_jax(params))
    np.testing.assert_allclose(module(_t(x)).detach().numpy(), np.asarray(want), **EMB_TOL)


# -- the gate's projection branch -----------------------------------------------------


@pytest.mark.parametrize("case", ["hits_and_projection", "empty_store", "no_positions",
                                  "no_projection"])
def test_knn_or_projection_matches_jax(case):
    from dclip_tpu.ops.knn import knn_or_projection as jax_gate

    d = 16
    params = torch_parity.jax_projection_params(d, seed=4, hidden=32)
    jmod = jproj.ImageProjectionModule(clip_dim=d, hidden_dim=32)
    rng = np.random.RandomState(5)
    keys = rng.standard_normal((20, d)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    values = rng.standard_normal((20, d)).astype(np.float32)
    queries = np.concatenate([keys[:3] + 0.01, rng.standard_normal((5, d))]).astype(np.float32)
    positions = rng.rand(8, 4).astype(np.float32)
    if case == "empty_store":
        keys = values = np.zeros((0, d), np.float32)
    if case == "no_positions":
        positions = None
    jfn = None if case == "no_projection" else (
        lambda q, pos: jmod.apply({"params": params}, q, pos))
    pfn = None if case == "no_projection" else proj.projection_apply_fn(
        proj.ImageProjectionModule(d, 32, device="meta"), projection_state_dict_from_jax(params))
    want = jax_gate(jnp.asarray(queries), None if positions is None else jnp.asarray(positions),
                    jnp.asarray(keys), jnp.asarray(values), jfn, 0.85)
    got = knn.knn_or_projection(_t(queries), _t(positions), _t(keys), _t(values), pfn, 0.85)
    np.testing.assert_array_equal(got.source.numpy(), np.asarray(want.source))
    np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings), **EMB_TOL)
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(want.similarity), **EMB_TOL)
    fallback = knn.SOURCE_CLIP if case == "no_projection" else knn.SOURCE_PROJECTION
    if case == "empty_store":
        assert (got.source.numpy() == fallback).all() and not got.similarity.any()
    else:
        assert (got.source.numpy()[:3] == knn.SOURCE_KNN).all()
        assert (got.source.numpy()[3:] == fallback).all()
    if fallback == knn.SOURCE_PROJECTION:  # the projection rows are unit vectors
        np.testing.assert_allclose(np.linalg.norm(got.embeddings.numpy()[3:], axis=-1), 1.0,
                                   rtol=1e-5)


# -- RegionTokenizer ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    params = torch_parity.jax_clip_fan_in(cfg)
    return cfg, params


def _regions(cfg, seed=6):
    rng = np.random.RandomState(seed)
    images = rng.rand(2, 40, 48, 3).astype(np.float32)
    boxes = np.asarray([[[0, 0, 48, 40], [4, 6, 30, 28], [20, 10, 47, 39]],
                        [[2, 2, 20, 20], [10, 0, 40, 36], [0, 0, 0, 0]]], np.float32)
    mask = np.asarray([[1, 1, 1], [1, 1, 0]], np.float32)
    return images, boxes, mask


def _pair_tokenizers(tiny, threshold):
    """(JAX tokenizer, port tokenizer) over one store: two keys at the
    embeddings of regions [0, 1] and [1, 1] (hits; the other regions' top-1
    similarity stays below 0.945), 30 random ones (misses), and the
    projection head."""
    from dclip_tpu.data.embedding_store import EmbeddingStore as JaxStore
    from dclip_tpu.models.clip import CLIPModule as JaxCLIP
    from dclip_tpu.models.region_tokenizer import RegionTokenizer as JaxTokenizer

    cfg, params = tiny
    d = cfg.projection_dim
    images, boxes, mask = _regions(cfg)
    port_model = torch_parity.port_clip(cfg, params)
    raw = RegionTokenizer(port_model, patch_size=cfg.vision.image_size).batch_tokenize(
        images, boxes, mask).embeddings.reshape(-1, d).numpy()
    rng = np.random.RandomState(9)
    keys = np.concatenate([raw[[1, 4]], rng.standard_normal((30, d))]).astype(np.float32)
    values = rng.standard_normal((32, d)).astype(np.float32)
    pparams = torch_parity.jax_projection_params(d, seed=7)
    jstore, store = JaxStore(dim=d), EmbeddingStore(dim=d)
    for st in (jstore, store):
        st.add_batch([f"k{i}" for i in range(32)], keys, values=values)
    jtok = JaxTokenizer(JaxCLIP(cfg), {"params": params}, store=jstore,
                        projection_params=pparams,
                        projection_module=jproj.ImageProjectionModule(clip_dim=d),
                        similarity_threshold=threshold,
                        patch_size=cfg.vision.image_size)
    ptok = RegionTokenizer(port_model, store=store,
                           projection_params=projection_state_dict_from_jax(pparams),
                           similarity_threshold=threshold, patch_size=cfg.vision.image_size)
    return jtok, ptok, (images, boxes, mask)


def test_batch_tokenize_matches_jax(tiny):
    jtok, ptok, (images, boxes, mask) = _pair_tokenizers(tiny, threshold=0.95)
    want = jtok.batch_tokenize(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(mask))
    got = ptok.batch_tokenize(images, boxes, mask)
    sources = got.source.numpy()
    assert sources.tolist() == [[1, 0, 1], [1, 0, 1]]  # projection misses, the two hits
    # No top-1 similarity sits near the threshold, so the sources are exact.
    top1 = knn.knn_search(ptok._queries(images, boxes, mask)[0], ptok._store_keys,
                          1)[0][:, 0].numpy()
    assert (np.abs(top1 - 0.95) > 1e-3).all()
    for name in ("source", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("embeddings", "similarity", "positions"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   err_msg=name, **EMB_TOL)
    assert not got.embeddings[1, 2].any()


def test_evaluate_threshold_matches_jax(tiny, monkeypatch):
    """One region encode for the whole sweep; every threshold's numbers
    equal JAX's."""
    from dclip_tpu_torch.models import region_tokenizer

    jtok, ptok, (images, boxes, mask) = _pair_tokenizers(tiny, threshold=0.95)
    thresholds = (0.3, 0.5, 0.7, 0.95)
    want = jtok.evaluate_threshold(jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(mask),
                                   thresholds=thresholds)
    calls = []
    real = region_tokenizer.encode_patches
    monkeypatch.setattr(region_tokenizer, "encode_patches",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = ptok.evaluate_threshold(images, boxes, mask, thresholds=thresholds)
    assert len(calls) == 1 and list(got) == list(want) == [0.3, 0.5, 0.7, 0.95]
    for th in want:
        assert got[th]["knn_fraction"] == want[th]["knn_fraction"]
        assert got[th]["fallback_fraction"] == want[th]["fallback_fraction"]
        np.testing.assert_allclose(got[th]["mean_similarity"], want[th]["mean_similarity"],
                                   rtol=1e-5)
    assert got[0.95]["knn_fraction"] == 0.4  # the two planted keys of five valid slots


def test_store_is_copied_to_the_device_once(tiny):
    cfg, params = tiny
    store = EmbeddingStore.from_arrays(np.eye(4, cfg.projection_dim, dtype=np.float32))
    tok = RegionTokenizer(torch_parity.port_clip(cfg, params), store=store,
                          patch_size=cfg.vision.image_size)
    keys = tok._store_keys
    images, boxes, mask = _regions(cfg)
    tok.batch_tokenize(images, boxes, mask)
    tok.evaluate_threshold(images, boxes, mask, thresholds=(0.5,))
    assert tok._store_keys is keys and tok._store_values is keys


# -- the patch index and the CLIs ----------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory, tiny):
    """PNGs of several sizes and one unreadable file, a corpus JSON, an HF
    snapshot of the tiny CLIP, the projection head in the port's format,
    and detector weights: the port's state dict beside the JAX
    msgpack of the same variables, and an ultralytics-named npz."""
    import flax.serialization
    from PIL import Image

    from dclip_tpu.models import detector as jdet
    from dclip_tpu.models.hf_export import save_pretrained
    from dclip_tpu_torch.models.detector_import import expected_manifest
    from dclip_tpu_torch.models.detector import DetectorConfig
    from dclip_tpu_torch.models.weights import detector_state_dict_from_jax

    cfg, params = tiny
    root = tmp_path_factory.mktemp("region_cli")
    (root / "images").mkdir()
    rng = np.random.RandomState(12)
    items = []
    for i in range(5):
        path = root / "images" / f"img{i}.png"
        Image.fromarray((rng.rand(30 + 4 * i, 44 - 3 * i, 3) * 255).astype("uint8")).save(path)
        items.append({"image_path": str(path), "captions": [f"picture {i}"]})
    (root / "images" / "broken.png").write_bytes(b"not an image")  # build_index skips it
    (root / "corpus.json").write_text(json.dumps(items))
    save_pretrained(params, cfg, str(root / "snap"))
    pparams = torch_parity.jax_projection_params(cfg.projection_dim, seed=13)
    proj.save_image_projection(str(root / "proj.pt"), projection_state_dict_from_jax(pparams))
    # --detector flax: the JAX CLI's DetectorConfig(image_size=64).
    jcfg = jdet.DetectorConfig(image_size=64)
    model = jdet.FlaxYOLO(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    drng = np.random.RandomState(14)
    variables = jax.tree_util.tree_map(
        lambda s: (0.5 + drng.rand(*s.shape) if len(s.shape) == 1 else
                   drng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5
                   ).astype(np.float32), shapes)
    (root / "det.msgpack").write_bytes(flax.serialization.to_bytes(variables))
    torch.save(detector_state_dict_from_jax(variables), root / "det.pt")
    # --detector ultralytics: a width-8 checkpoint, architecture from shapes.
    sd = {k: (0.5 + drng.rand(*s) if k.endswith("running_var") else
              0.2 * drng.standard_normal(s) if len(s) == 1 else
              drng.standard_normal(s) * np.prod(s[1:]) ** -0.5).astype(np.float32)
          for k, s in expected_manifest(DetectorConfig(width=8, image_size=64)).items()}
    np.savez(root / "yolo.npz", **sd)
    return root


def _hold_stores(got_path, want_path, exact_positions=True):
    """Ids and dims equal, embeddings within EMB_TOL; positions exact for
    grid boxes, within 1e-6 of the frame for a detector's."""
    a, b = np.load(got_path), np.load(want_path)
    assert json.loads(str(a["ids"])) == json.loads(str(b["ids"]))
    assert int(a["dim"]) == int(b["dim"])
    if exact_positions:
        np.testing.assert_array_equal(a["positions"], b["positions"])
    else:
        np.testing.assert_allclose(a["positions"], b["positions"], rtol=0, atol=1e-6)
    for k in ("keys", "values"):
        np.testing.assert_allclose(a[k], b[k], **EMB_TOL)


def _hold_caches(got_path, want_path, exact=True):
    a, b = np.load(got_path), np.load(want_path)
    assert json.loads(str(a["keys"])) == json.loads(str(b["keys"]))
    np.testing.assert_array_equal(a["counts"], b["counts"])
    for k, tol in (("boxes", dict(rtol=1e-5, atol=1e-4)), ("conf", dict(rtol=1e-6, atol=1e-7))):
        if exact:
            np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_allclose(a[k], b[k], **tol)


def test_build_patch_index_matches_jax(tiny, workspace, tmp_path, capsys):
    from dclip_tpu.data.detection_cache import GridProposalDetector as JaxGrid
    from dclip_tpu.data.index import build_patch_index as jax_build
    from dclip_tpu.models.clip import CLIPModule as JaxCLIP
    from dclip_tpu_torch.data.detection_cache import GridProposalDetector
    from dclip_tpu_torch.data.index import build_patch_index

    cfg, params = tiny
    paths = sorted(str(p) for p in (workspace / "images").iterdir()) + ["missing.png"]
    want = jax_build(paths, JaxCLIP(cfg), {"params": params}, detect_fn=JaxGrid(),
                     image_size=cfg.vision.image_size, batch_size=8,
                     output_path=str(tmp_path / "jax.npz"))
    got = build_patch_index(paths, torch_parity.port_clip(cfg, params),
                            detect_fn=GridProposalDetector(), image_size=cfg.vision.image_size,
                            batch_size=8, output_path=str(tmp_path / "port.npz"))
    assert len(got) == len(want) == 5 * 6
    assert got.ids[:2] == ["img0_patch0", "img0_patch1"]
    assert "Skipping" in capsys.readouterr().out  # the unreadable file
    _hold_stores(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))


@pytest.mark.parametrize("detector", ["grid", "flax", "ultralytics"])
def test_precache_cli_matches_jax(workspace, tmp_path, detector, monkeypatch):
    from dclip_tpu.cli import precache as jax_cli
    from dclip_tpu_torch.cli import precache as cli

    monkeypatch.chdir(tmp_path)
    common = ["--json_file", str(workspace / "corpus.json"), "--detector", detector,
              "--detector_image_size", "64", "--model_preset", "tiny", "--clip_weights",
              str(workspace / "snap"), "--batch_size", "8"]
    if detector != "grid":
        common.append("--build_index")
    ckpt = {"grid": (), "flax": ("det.msgpack", "det.pt"),
            "ultralytics": ("yolo.npz", "yolo.npz")}[detector]
    jax_flags = ["--detector_checkpoint", str(workspace / ckpt[0])] if ckpt else []
    if detector == "flax":
        # The JAX CLI initializes a detector before it reads the checkpoint
        # over it; an un-jitted flax init takes half a minute on the CPU,
        # so the msgpack's own variables stand in for the init here.
        import flax.serialization

        from dclip_tpu.models import detector as jdet

        variables = flax.serialization.msgpack_restore((workspace / "det.msgpack").read_bytes())
        monkeypatch.setattr(jdet.Detector, "initialize",
                            classmethod(lambda cls, cfg, seed=0: cls(cfg, variables)))
    port_flags = ["--detector_checkpoint", str(workspace / ckpt[1])] if ckpt else []
    assert jax_cli.main(common + ["--cache_dir", "jax"] + jax_flags) == 0
    assert cli.main(common + ["--cache_dir", "port", "--device", "cpu"] + port_flags) == 0
    _hold_caches("port/corpus_precache.npz", "jax/corpus_precache.npz",
                 exact=detector == "grid")
    if detector != "grid":
        _hold_stores("port/corpus_patch_index.npz", "jax/corpus_patch_index.npz",
                     exact_positions=False)
    assert np.load("port/corpus_precache.npz")["counts"].sum() > 0


def test_build_index_cli_matches_jax(workspace, tmp_path, capsys):
    from dclip_tpu.cli import build_index as jax_cli
    from dclip_tpu_torch.cli import build_index as cli

    common = ["--image_dir", str(workspace / "images"), "--model_preset", "tiny",
              "--clip_weights", str(workspace / "snap"), "--batch_size", "4",
              "--max_images", "6"]
    assert jax_cli.main(common + ["--output", str(tmp_path / "jax.npz")]) == 0
    want = capsys.readouterr().out
    assert cli.main(common + ["--output", str(tmp_path / "port.npz"), "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got.splitlines()[-1] == want.splitlines()[-1].replace("jax.npz", "port.npz")
    _hold_stores(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))
    assert cli.build_parser().parse_args(["--image_dir", "x"]).model_preset == "vit-b-32"


def test_tune_gate_cli_matches_jax(workspace, tmp_path, capsys):
    from dclip_tpu.cli import precache as jax_precache
    from dclip_tpu.cli import tune_gate as jax_cli
    from dclip_tpu_torch.cli import tune_gate as cli

    assert jax_precache.main(["--json_file", str(workspace / "corpus.json"), "--cache_dir",
                              str(tmp_path), "--build_index", "--model_preset", "tiny",
                              "--clip_weights", str(workspace / "snap"), "--batch_size", "8"]) == 0
    common = ["--json_file", str(workspace / "corpus.json"), "--detection_cache",
              str(tmp_path / "corpus_precache.npz"), "--knn_store",
              str(tmp_path / "corpus_patch_index.npz"), "--model_preset", "tiny",
              "--clip_weights", str(workspace / "snap"), "--image_size", "40",
              "--thresholds", "0.5", "0.9", "0.999", "1.01"]
    capsys.readouterr()
    # The JAX CLI's tokenizer builds a 512-wide projection head whatever the
    # preset, so it cannot load the tiny preset's 16-wide one; the table
    # does not depend on the fallback's embeddings, only on the hits.
    assert jax_cli.main(common) == 0
    want = capsys.readouterr().out
    assert cli.main(common + ["--projection_weights", str(workspace / "proj.pt"),
                              "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    table = [line for line in got.splitlines() if line[:1].isdigit() or "valid patches" in line]
    assert len(table) == 5 and "projection branch enabled" in got
    assert table == [line for line in want.splitlines()
                     if line[:1].isdigit() or "valid patches" in line]
