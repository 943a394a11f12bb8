"""The port's two deployment artifacts on the CPU at the tiny config:

- the serving artifact (dclip_tpu_torch.serve.export, `torch.export`
  programs + params.npz) against the live service it was exported from,
  the JAX package's thresholds for int8, and its refusals;
- the HF snapshot (dclip_tpu_torch.models.hf_export, cli.export_hf)
  against the JAX package's `save_pretrained` on the same weights, the
  `safetensors` package's reader and `transformers.CLIPModel`.
"""
import json
import os

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu_torch.cli import serve as cli_serve
from dclip_tpu_torch.data.tokenizer import HashTokenizer
from dclip_tpu_torch.serve import ClipService
from dclip_tpu_torch.serve.export import FORMAT, export_encoders, load_exported

import torch_parity

BUCKETS = (1, 4)
TEXTS = ["a dog", "two cats", "red car on a street", "a", "mountain lake at dawn"]


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=0)
    model = torch_parity.port_clip(cfg, params)
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    return cfg, params, model, tok


@pytest.fixture(scope="module")
def artifacts(tiny, tmp_path_factory):
    """A float and an int8 artifact of the same model, buckets 1 and 4."""
    cfg, _, model, _ = tiny
    root = tmp_path_factory.mktemp("export")
    out = {}
    for quantize in (None, "int8"):
        d = str(root / str(quantize))
        out[quantize] = (d, export_encoders(model, cfg, d, batch_sizes=BUCKETS,
                                            platforms=("cpu",), quantize=quantize))
    return out


def test_round_trip_matches_the_live_service(tiny, artifacts):
    """The file set is the manifest, params.npz and one program per
    (modality, bucket); the loaded programs give the live f32 service's
    texts and the module route's images within 1e-5, across bucket chunks
    (5 items = 4 + 1)."""
    cfg, _, model, tok = tiny
    d, written = artifacts[None]
    programs = {f"{m}_b{b}.cpu.pt2" for m in ("text", "image") for b in BUCKETS}
    assert set(os.listdir(d)) == {"manifest.json", "params.npz"} | programs
    assert set(written) == {"params.npz"} | programs
    assert written == {n: os.path.getsize(os.path.join(d, n)) for n in written}
    loaded = load_exported(d, device="cpu")
    assert loaded.manifest["format"] == FORMAT and loaded.manifest["quantize"] is None
    assert loaded.text_buckets == loaded.image_buckets == list(BUCKETS)
    svc = ClipService(model, cfg, tokenizer=tok, buckets=BUCKETS, device="cpu")
    ids, mask = tok.encode_batch(TEXTS, max_length=cfg.text.max_length)
    got = loaded.encode_texts_ids(ids, mask)
    assert got.shape == (5, cfg.projection_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, svc.encode_texts(TEXTS), rtol=1e-5, atol=1e-5)
    px = torch_parity.pixels(cfg, 5, seed=4)
    with torch.no_grad():
        want = model.image_features(torch.from_numpy(px))
    want = (want / want.norm(dim=-1, keepdim=True)).numpy()
    np.testing.assert_allclose(loaded.encode_images(px), want, rtol=1e-5, atol=1e-5)
    assert loaded.encode_images(px[:0]).shape == (0, cfg.projection_dim)


def test_quantized_export_smaller_and_faithful(tiny, artifacts):
    """`test_quantized_export_smaller_and_faithful` of `tests/test_serve.py`
    with its thresholds: the int8 params.npz under 0.45 of the float one,
    int8 texts within cosine 0.99 of the float service; and the int8
    programs equal the live int8 service's forward."""
    cfg, _, model, tok = tiny
    (fdir, w_f), (qdir, w_q) = artifacts[None], artifacts["int8"]
    assert w_q["params.npz"] < 0.45 * w_f["params.npz"], (w_q, w_f)
    loaded = load_exported(qdir, device="cpu")
    assert loaded.manifest["quantize"] == "int8"
    ids, mask = tok.encode_batch(TEXTS, max_length=cfg.text.max_length)
    got = loaded.encode_texts_ids(ids, mask)
    float_svc = ClipService(model, cfg, tokenizer=tok, buckets=BUCKETS, device="cpu")
    cos = (got * float_svc.encode_texts(TEXTS)).sum(-1)
    assert cos.min() > 0.99, cos
    int8_svc = ClipService(model, cfg, tokenizer=tok, buckets=BUCKETS, device="cpu",
                           quantize="int8")
    np.testing.assert_allclose(got, int8_svc.encode_texts(TEXTS), rtol=1e-5, atol=1e-5)
    u8 = np.random.RandomState(7).randint(0, 256, (3,) + (cfg.vision.image_size,) * 2 + (3,),
                                          np.uint8)
    from dclip_tpu_torch.ops.image_ops import normalize

    px = normalize(torch.from_numpy(u8).float() / 255.0).numpy()
    np.testing.assert_allclose(loaded.encode_images(px), int8_svc.encode_images(list(u8)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quantize", [None, "int8"])
def test_programs_carry_no_weights(tiny, artifacts, quantize):
    """Weights are an argument: no program lifts state or constants, keeps
    its example inputs, or holds the bytes of a weight."""
    cfg, _, model, _ = tiny
    d, _ = artifacts[quantize]
    row = model.state_dict()["text_model.embeddings.token_embedding.weight"][3].numpy()
    with np.load(os.path.join(d, "params.npz")) as z:
        keys = set(z.files)
        if quantize:
            row = z["text_model//token_embedding//q"][3]
    if quantize:
        assert "text_model//encoder//layers_0//self_attn//q_proj//kernel//scale" in keys
    else:
        assert "text_model.embeddings.token_embedding.weight" in keys
    for name in os.listdir(d):
        if not name.endswith(".pt2"):
            continue
        ep = torch.export.load(os.path.join(d, name))
        assert len(ep.state_dict) == 0 and len(ep.constants) == 0, name
        assert ep.example_inputs is None, name
        with open(os.path.join(d, name), "rb") as f:
            assert row.tobytes() not in f.read(), name


def test_foreign_and_jax_artifacts_are_refused(tiny, tmp_path):
    """A directory without a manifest and a JAX artifact (StableHLO,
    `dclip_tpu.serve.export/2`) are both refused with ValueError."""
    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule
    from dclip_tpu.serve.export import export_encoders as jax_export

    cfg, params, _, _ = tiny
    (tmp_path / "foreign").mkdir()
    (tmp_path / "foreign" / "params.npz").write_bytes(b"")
    with pytest.raises(ValueError, match="not a dclip_tpu_torch export"):
        load_exported(str(tmp_path / "foreign"), device="cpu")
    jdir = str(tmp_path / "jax")
    jax_export(JaxCLIPModule(cfg), {"params": params}, cfg, jdir, batch_sizes=(1,),
               platforms=("cpu",))
    with open(os.path.join(jdir, "manifest.json")) as f:
        assert json.load(f)["format"] == "dclip_tpu.serve.export/2"
    with pytest.raises(ValueError, match="dclip_tpu.serve.export/2"):
        load_exported(jdir, device="cpu")


def test_export_refusals(tiny, tmp_path, artifacts, monkeypatch):
    """`tpu` (or any name but cpu / cuda) raises ValueError; a model whose
    forward reaches the hand-written kernels is refused, not traced as the
    module route; `cuda` without a card raises, as does loading a cpu-only
    artifact on another device type."""
    from dclip_tpu_torch.models.clip import CLIPModule

    cfg, _, model, _ = tiny
    with pytest.raises(ValueError, match="platforms"):
        export_encoders(model, cfg, str(tmp_path / "a"), platforms=("tpu",))
    with pytest.raises(ValueError, match="quantize"):
        export_encoders(model, cfg, str(tmp_path / "a"), platforms=("cpu",), quantize="fp4")
    fused = CLIPModule(cfg, fused_attention=True, device="meta")
    fused.load_state_dict(model.state_dict(), assign=True)
    with pytest.raises(ValueError, match="kernels"):
        export_encoders(fused, cfg, str(tmp_path / "b"), platforms=("cpu",))
    assert not os.path.exists(tmp_path / "a") and not os.path.exists(tmp_path / "b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        export_encoders(model, cfg, str(tmp_path / "c"), platforms=("cpu", "cuda"))
    with pytest.raises(RuntimeError, match="is_available"):
        load_exported(artifacts[None][0])  # default device: cuda


def test_cli_export_dir_and_platforms(tmp_path, capsys):
    """`--export_dir` prints one JSON line {export_dir, written} and writes
    the int8 artifact for `--export_platforms cpu`; a platform other than
    cpu / cuda raises ValueError before any model is built."""
    out = str(tmp_path / "cli")
    assert cli_serve.main(["--device", "cpu", "--model_preset", "tiny", "--buckets", "2",
                           "--quantize", "int8", "--export_dir", out,
                           "--export_platforms", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["export_dir"] == out
    assert set(line["written"]) == {"params.npz", "text_b2.cpu.pt2", "image_b2.cpu.pt2"}
    loaded = load_exported(out, device="cpu")
    assert loaded.manifest["quantize"] == "int8" and loaded.manifest["platforms"] == ["cpu"]
    with pytest.raises(ValueError, match="platforms"):
        cli_serve.main(["--device", "cpu", "--model_preset", "tiny", "--export_dir",
                        str(tmp_path / "t"), "--export_platforms", "tpu"])


# -- the HF snapshot -------------------------------------------------------------


def test_save_pretrained_matches_jax(tiny, tmp_path):
    """Tensor for tensor the JAX package's snapshot of the same weights
    (values and dtypes; `logit_scale` is 0-d where JAX's is (1,)), equal
    config and preprocessor json; the file reads back with the port's
    reader and with the `safetensors` package's."""
    from safetensors.numpy import load_file

    from dclip_tpu.models.hf_export import save_pretrained as jax_save_pretrained
    from dclip_tpu_torch.models.hf_export import load_safetensors, save_pretrained

    cfg, params, model, _ = tiny
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    jax_save_pretrained(params, cfg, str(jdir))
    save_pretrained(model, cfg, str(pdir))
    want = load_file(str(jdir / "model.safetensors"))
    got = load_file(str(pdir / "model.safetensors"))
    mine = load_safetensors(str(pdir / "model.safetensors"))
    assert set(got) == set(want) == set(mine)
    assert got["logit_scale"].shape == () and want["logit_scale"].shape == (1,)
    for k, w in want.items():
        if k == "logit_scale":
            w = w.reshape(())
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
        assert mine[k].dtype == w.dtype and mine[k].tobytes() == w.tobytes(), k
    for name in ("config.json", "preprocessor_config.json"):
        assert json.loads((pdir / name).read_text()) == json.loads((jdir / name).read_text())


def test_snapshot_loads_in_transformers(tiny, tmp_path):
    """`transformers.CLIPModel.from_pretrained` takes the snapshot with no
    missing or unexpected key and computes the port's text features."""
    transformers = pytest.importorskip("transformers")
    from dclip_tpu_torch.models.hf_export import save_pretrained

    cfg, _, model, _ = tiny
    save_pretrained(model, cfg, str(tmp_path))
    hf, info = transformers.CLIPModel.from_pretrained(str(tmp_path),
                                                      output_loading_info=True)
    assert info["missing_keys"] == [] and info["unexpected_keys"] == []
    assert hf.logit_scale.shape == ()
    ids, mask = (torch.from_numpy(a).long() for a in torch_parity.text_batch(cfg, seed=5))
    ids, mask = ids[:4], mask[:4]  # rows with an EOS id: HF pools at the first one too
    with torch.no_grad():
        want = hf.eval().get_text_features(input_ids=ids, attention_mask=mask)
        got = model.get_text_features(ids, mask)
    np.testing.assert_allclose(got.numpy(), torch.as_tensor(want).numpy(), rtol=1e-4, atol=1e-5)


def test_cli_export_hf_from_a_checkpoint(tiny, tmp_path):
    """cli.export_hf: a `CheckpointManager` checkpoint (a trainer state with
    the parameters under "params") -> a snapshot holding those weights;
    the port's loader reads it back bit-equal, `logit_scale` 0-d. Without
    --checkpoint the --clip_weights snapshot is re-exported unchanged."""
    from dclip_tpu_torch.cli import export_hf
    from dclip_tpu_torch.models.hf_export import load_safetensors
    from dclip_tpu_torch.models.weights import load_state_dict_file
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    _, _, model, _ = tiny
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
          for i, (k, v) in enumerate(model.state_dict().items())}
    CheckpointManager(str(tmp_path / "ckpts")).save({"params": sd, "step": 7}, step=7, epoch=0)
    out = tmp_path / "snap"
    assert export_hf.main(["--model_preset", "tiny", "--checkpoint", str(tmp_path / "ckpts"),
                           "--out", str(out)]) == 0
    back = load_state_dict_file(str(out))
    assert set(back) == set(sd) and back["logit_scale"].shape == ()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    again = tmp_path / "again"
    assert export_hf.main(["--model_preset", "tiny", "--clip_weights", str(out),
                           "--out", str(again)]) == 0
    first, second = (load_safetensors(str(p / "model.safetensors")) for p in (out, again))
    assert all(first[k].tobytes() == second[k].tobytes() for k in first)
    with pytest.raises(SystemExit):
        export_hf.main(["--model_preset", "tiny", "--out", str(tmp_path / "none")])
