"""The port's zero-shot eval and both eval CLIs against the JAX package on
the CPU:

- `embed_classnames` (atol 1e-5: two f32 text layers) and
  `evaluate_zero_shot` on the tiny CLIP with bridged weights, a ragged
  tail batch and two identical class prompts (tied logits: both sides
  give the tie to the lower class); a separable case scores 1.0, as in
  `tests/test_zero_shot.py:63`; top-1 / top-5 / total equal exactly;
- the results formats, string for string (`tests/test_zero_shot.py:93`);
- `load_cifar_batches` on tiny CIFAR-10 / CIFAR-100 pickles;
- `zero_shot_eval` and `flickr30k_eval` run as CLIs on both packages from
  one HF snapshot (the JAX exporter's), `--model both`, the custom weights
  from a flax msgpack file on the JAX side and from a port
  `CheckpointManager` checkpoint on the port's (`--device cpu`): the
  results files byte for byte, the retrieval tables line for line.
"""
import json
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer
from dclip_tpu.eval import zero_shot as jzs
from dclip_tpu_torch.data.tokenizer import HashTokenizer
from dclip_tpu_torch.eval import zero_shot as zs
from dclip_tpu_torch.models.encoding import image_forward
from dclip_tpu_torch.models.weights import state_dict_from_jax

import torch_parity

TEXT_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    jmodel, params = torch_parity.jax_clip(cfg, seed=4)
    return cfg, jmodel, params, torch_parity.port_clip(cfg, params)


def test_embed_classnames_and_evaluate_match_jax(tiny):
    cfg, jmodel, params, model = tiny
    names = ["cat", "dog", "red car", "cat", "a tree", "boat", "sofa"]  # "cat" twice: a tie
    tok, jtok = HashTokenizer(1000, cfg.text.max_length), JaxHashTokenizer(1000,
                                                                           cfg.text.max_length)
    text = zs.embed_classnames(model, tok, names, zs.CIFAR_PROMPT)
    jtext = jzs.embed_classnames(jmodel, {"params": params}, jtok, names, jzs.CIFAR_PROMPT)
    np.testing.assert_allclose(text.numpy(), np.asarray(jtext), **TEXT_TOL)
    assert torch.equal(text[0], text[3])
    rng = np.random.RandomState(6)
    s = cfg.vision.image_size
    pixels = rng.standard_normal((19, s, s, 3)).astype(np.float32)
    labels = rng.randint(0, len(names), 19)
    labels[:4] = 3  # the second "cat": never the top-1 of a tie

    def batches():
        for i in range(0, 19, 8):  # 8, 8, 3
            yield pixels[i:i + 8], labels[i:i + 8]

    got = zs.evaluate_zero_shot(model, text, batches(), log_every=0)
    want = jzs.evaluate_zero_shot(jmodel, {"params": params}, jnp.asarray(np.asarray(jtext)),
                                  batches(), log_every=0)
    assert got == want and got["total"] == 19


def test_evaluate_zero_shot_bf16_matches_jax(tiny):
    """A bf16 model: the module path at bf16 on both sides (the JAX
    `zero_shot_logits_forward` runs `get_image_features`), the same top-1 /
    top-5 on the same weights, pixels and class bank."""
    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule
    from dclip_tpu_torch.models.clip import CLIPModule

    cfg = tiny[0]
    params = torch_parity.jax_clip_fan_in(cfg, seed=4)  # features that differ by image
    model = CLIPModule(cfg, dtype=torch.bfloat16, device="meta")
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True, assign=True)
    jmodel = JaxCLIPModule(cfg, dtype=jnp.bfloat16)
    rng = np.random.RandomState(11)
    s = cfg.vision.image_size
    pixels = rng.standard_normal((24, s, s, 3)).astype(np.float32)
    with torch.no_grad():
        feats = model.eval().image_features(torch.from_numpy(pixels)).float()
    # Each class vector: one image's features plus noise, so every image's
    # top-1 is clear of the bf16 rounding of either framework.
    bank = feats[:12] + 0.2 * feats.norm(dim=-1, keepdim=True)[:12] * torch.from_numpy(
        rng.standard_normal((12, cfg.projection_dim)).astype(np.float32)) / 4
    bank = bank / bank.norm(dim=-1, keepdim=True)
    labels = np.concatenate([np.arange(12), rng.randint(0, 12, 12)])

    def batches():
        for i in range(0, 24, 10):
            yield pixels[i:i + 10], labels[i:i + 10]

    got = zs.evaluate_zero_shot(model, bank, batches(), log_every=0)
    want = jzs.evaluate_zero_shot(jmodel, {"params": params}, jnp.asarray(bank.numpy()),
                                  batches(), log_every=0)
    assert got == want and got["total"] == 24 and got["top1"] >= 0.5


def test_evaluate_zero_shot_separable(tiny):
    """Each image's own normalized features as the class bank: top-1 is 1.0."""
    cfg, _, _, model = tiny
    s = cfg.vision.image_size
    pixels = np.random.RandomState(7).standard_normal((10, s, s, 3)).astype(np.float32)
    with torch.no_grad():
        feats = image_forward(model)(torch.from_numpy(pixels))
    text = feats / feats.norm(dim=-1, keepdim=True)
    res = zs.evaluate_zero_shot(model, text, [(pixels[:6], np.arange(6)),
                                              (pixels[6:], np.arange(6, 10))], log_every=0)
    assert res == {"top1": 1.0, "top5": 1.0, "total": 10}


def test_format_functions_match_jax(capsys):
    base, custom = {"top1": 0.9, "top5": 0.99}, {"top1": 0.85, "top5": 0.98}
    assert zs.format_cifar_results(base, custom, base, custom) == \
        jzs.format_cifar_results(base, custom, base, custom)
    assert zs.format_imagenet_results(custom, base) == jzs.format_imagenet_results(custom, base)
    assert zs.format_imagenet_results(custom) == jzs.format_imagenet_results(custom)
    assert "Relative Change: -5.56%" in zs.format_cifar_results(base, custom, base, custom)
    table = {"cifar10": {"base": base, "custom": custom}}
    zs.print_comparison_table(table)
    mine = capsys.readouterr().out
    jzs.print_comparison_table(table)
    assert mine == capsys.readouterr().out


def _cifar(root, dataset, n=10, seed=8):
    rng = np.random.RandomState(seed)
    data = (rng.rand(n, 3072) * 255).astype("uint8")
    if dataset == "cifar10":
        d = root / "cifar-10-batches-py"
        batch, meta = d / "test_batch", d / "batches.meta"
        body = {b"data": data, b"labels": list(rng.randint(0, 10, n))}
        names = {b"label_names": [f"c{i}".encode() for i in range(10)]}
    else:
        d = root / "cifar-100-python"
        batch, meta = d / "test", d / "meta"
        body = {b"data": data, b"fine_labels": list(rng.randint(0, 12, n))}
        names = {b"fine_label_names": [f"class {i}".encode() for i in range(12)]}
    d.mkdir(parents=True, exist_ok=True)
    with open(batch, "wb") as f:
        pickle.dump(body, f)
    with open(meta, "wb") as f:
        pickle.dump(names, f)


@pytest.mark.parametrize("dataset", ["cifar10", "cifar100"])
def test_load_cifar_batches_matches_jax(tmp_path, dataset):
    _cifar(tmp_path, dataset)
    got = zs.load_cifar_batches(str(tmp_path), dataset)
    want = jzs.load_cifar_batches(str(tmp_path), dataset)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[0].shape[1:] == (32, 32, 3)
    a = list(zs.iterate_preprocessed(got[0], got[1], batch_size=4, image_size=24))
    b = list(jzs.iterate_preprocessed(want[0], want[1], batch_size=4, image_size=24))
    assert [x[0].shape[0] for x in a] == [4, 4, 2]
    for (pa, la), (pb, lb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(la, lb)


# -- both CLIs, end to end -------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_workspace(tmp_path_factory):
    """An HF snapshot of the base weights, the custom weights as a flax
    msgpack file and as a port checkpoint, CIFAR-10 pickles, an
    ImageFolder tree and a retrieval eval JSON."""
    import flax.serialization
    from PIL import Image

    from dclip_tpu.models.hf_export import save_pretrained
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    root = tmp_path_factory.mktemp("eval_cli")
    cfg = CLIPConfig.tiny_test()
    _, base = torch_parity.jax_clip(cfg, seed=9)
    _, custom = torch_parity.jax_clip(cfg, seed=10)
    save_pretrained(base, cfg, str(root / "snap"))
    (root / "custom.msgpack").write_bytes(flax.serialization.msgpack_serialize(custom))
    CheckpointManager(str(root / "ckpts")).save(
        {"format": "dclip_tpu_torch.DistillTrainer/1", "step": 3,
         "params": state_dict_from_jax(custom, cfg)}, step=3, epoch=0)
    _cifar(root, "cifar10", n=11)
    rng = np.random.RandomState(11)
    items = []
    for c in ("bird", "cat", "dog"):
        (root / "folder" / c).mkdir(parents=True)
        for i in range(3):
            path = root / "folder" / c / f"{i}.png"
            Image.fromarray((rng.rand(36, 40, 3) * 255).astype("uint8")).save(path)
            items.append({"image_path": str(path), "image_id": len(items),
                          "captions": [f"a {c} number {i}", f"the {c}"]})
    (root / "eval.json").write_text(json.dumps(items))
    return root


@pytest.mark.parametrize("dataset", ["cifar10", "imagenet"])
def test_zero_shot_cli_results_file_matches_jax(cli_workspace, dataset, monkeypatch):
    from dclip_tpu.cli import zero_shot_eval as jax_cli
    from dclip_tpu_torch.cli import zero_shot_eval as cli

    root = cli_workspace
    monkeypatch.chdir(root)
    data = str(root if dataset == "cifar10" else root / "folder")
    common = ["--dataset", dataset, "--data_dir", data, "--model", "both", "--batch_size", "4",
              "--model_preset", "tiny", "--clip_weights", str(root / "snap")]
    assert jax_cli.main(common + ["--checkpoint", str(root / "custom.msgpack"),
                                  "--results_file", f"jax_{dataset}.txt"]) == 0
    ckpt = str(root / "ckpts") if dataset == "cifar10" else \
        str(root / "ckpts" / "ckpt_epoch0.step3.pt")
    assert cli.main(common + ["--checkpoint", ckpt, "--device", "cpu",
                              "--results_file", f"port_{dataset}.txt"]) == 0
    port = (root / f"port_{dataset}.txt").read_bytes()
    assert port == (root / f"jax_{dataset}.txt").read_bytes()
    assert port.startswith(b"Zero-Shot CIFAR Results" if dataset == "cifar10"
                           else b"Zero-Shot ImageNet Results")


def test_flickr30k_cli_table_matches_jax(cli_workspace, monkeypatch, capsys):
    from dclip_tpu.cli import flickr30k_eval as jax_cli
    from dclip_tpu_torch.cli import flickr30k_eval as cli

    root = cli_workspace
    monkeypatch.chdir(root)
    common = ["--dataset_json", "eval.json", "--model", "both", "--batch_size", "4",
              "--model_preset", "tiny", "--clip_weights", str(root / "snap"),
              "--packed_captions"]
    assert jax_cli.main(common + ["--checkpoint", "custom.msgpack"]) == 0
    want = capsys.readouterr().out
    assert cli.main(common + ["--checkpoint", "ckpts", "--device", "cpu"]) == 0
    got = capsys.readouterr().out
    table = [line for line in got.splitlines() if line.startswith(("base", "custom", "Relative"))]
    assert len(table) >= 4
    assert table == [line for line in want.splitlines()
                     if line.startswith(("base", "custom", "Relative"))]
    # A data axis of 2 needs 2 ranks (--multihost): on one process, JAX's
    # ValueError for a one-device machine.
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        cli.main(common + ["--mesh_data", "2", "--device", "cpu"])
    assert not os.path.exists(root / "cifar_zero_shot_results.txt")
