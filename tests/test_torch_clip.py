"""The port's CLIP dual encoder (dclip_tpu_torch.models) against the JAX
package on the CPU: image tower vs `fused_image_features` (Pallas in
interpret mode), text tower vs the Flax module, the weight bridge vs
`hf_export.export_state_dict`, the random-weight rule, the device rules,
and that the port never imports jax."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.kernels.vit_block import fused_image_features as jax_fused_image_features
from dclip_tpu.models.hf_export import export_state_dict
from dclip_tpu_torch.core.device import resolve_device, resolve_dtype
from dclip_tpu_torch.models.clip import CLIPModule
from dclip_tpu_torch.models.weights import random_state_dict, state_dict_from_jax

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Embeddings after a 2-layer tower at f32: the two frameworks sum in
# different orders, a few f32 ulps per layer.
EMB_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    model, params = torch_parity.jax_clip(cfg, seed=0)
    return cfg, model, params, torch_parity.port_clip(cfg, params)


def test_image_tower_matches_jax_fused_image_features(tiny):
    cfg, _, params, port = tiny
    px = torch_parity.pixels(cfg, 4, seed=1)
    want = jax_fused_image_features(cfg, {"params": params}, px, interpret=True)
    with torch.no_grad():
        got = port.get_image_features(torch.from_numpy(px))
    assert got.shape == (4, cfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EMB_TOL)


def test_image_tower_matches_flax_conv_path(tiny):
    """The patch reshape + matmul equals the Flax `nn.Conv` patch embedding
    (the JAX module's own get_image_features)."""
    cfg, model, params, port = tiny
    px = torch_parity.pixels(cfg, 3, seed=2)
    want = model.apply({"params": params}, px, method=model.get_image_features)
    with torch.no_grad():
        got = port.get_image_features(torch.from_numpy(px), port.pack_image_weights())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EMB_TOL)


def test_text_tower_matches_jax(tiny):
    cfg, model, params, port = tiny
    ids, mask = torch_parity.text_batch(cfg, seed=3)
    assert not (ids[-1] == cfg.text.eos_token_id).any()  # last-position pooling row
    want = model.apply({"params": params}, ids, mask, method=model.get_text_features)
    with torch.no_grad():
        got = port.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EMB_TOL)


def test_text_eos_pooling_falls_back_to_last_position(tiny):
    cfg, _, _, port = tiny
    ids, mask = torch_parity.text_batch(cfg, seed=4)
    with torch.no_grad():
        hidden, pooled = port.text_model(torch.from_numpy(ids), torch.from_numpy(mask))
    eos_at = [int(np.argmax(r == cfg.text.eos_token_id)) for r in ids[:-1]]
    for row, col in enumerate(eos_at + [cfg.text.max_length - 1]):
        torch.testing.assert_close(pooled[row], hidden[row, col], rtol=0, atol=0)


@pytest.mark.parametrize("preset", ["tiny", "vit-b-16"])
def test_weight_bridge_matches_hf_export(preset):
    """state_dict_from_jax gives hf_export's key set, shapes and values, and
    that key set is exactly the port module's (so strict loads work)."""
    cfg = CLIPConfig.from_name(preset)
    if preset == "tiny":
        _, params = torch_parity.jax_clip(cfg, seed=6)
    else:  # shapes only at full width: zeros keep it cheap
        import jax

        from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule

        shapes = jax.eval_shape(lambda: JaxCLIPModule(cfg).init(
            jax.random.PRNGKey(0), np.zeros((1, 77), np.int32),
            np.zeros((1, 224, 224, 3), np.float32)))["params"]
        params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    got = state_dict_from_jax(params, cfg)
    want = export_state_dict(params)
    assert set(got) == set(want)
    # hf_export's np.ascontiguousarray lifts the 0-d logit_scale to shape
    # (1,); HF CLIPModel's parameter is 0-d, and so is the port's.
    want["logit_scale"] = want["logit_scale"].reshape(())
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    port_keys = set(CLIPModule(cfg, device="meta").state_dict())
    assert port_keys == set(want)


def test_load_clip_reads_local_hf_weights(tmp_path):
    """An HF snapshot written by the JAX package's exporter, and a torch
    `pytorch_model.bin` with the older `position_ids` buffers, both load
    strictly into the port with the bridge's values."""
    from dclip_tpu.models.hf_export import save_pretrained
    from dclip_tpu_torch.cli.common import load_clip

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=7)
    want = state_dict_from_jax(params, cfg)
    save_pretrained(params, cfg, str(tmp_path / "snap"))
    torch.save({**want, "text_model.embeddings.position_ids": torch.arange(16)[None]},
               str(tmp_path / "pytorch_model.bin"))
    for src in (str(tmp_path / "snap"), str(tmp_path / "pytorch_model.bin")):
        _, model = load_clip("tiny", src, device="cpu")
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k].reshape(want[k].shape), want[k],
                                       rtol=0, atol=0, msg=k)


def test_random_state_dict_value_rule():
    cfg = CLIPConfig.tiny_test()
    sd = random_state_dict(cfg, seed=0)
    assert set(sd) == set(CLIPModule(cfg, device="meta").state_dict())
    ln = [k for k in sd if ("layer_norm" in k or "layrnorm" in k or "layernorm" in k)
          and k.endswith(".weight")]
    assert len(ln) == 2 * 2 + 2 * 2 + 3  # per-layer LN1/LN2, final, pre, post
    for k, v in sd.items():
        assert v.dtype == torch.float32, k
        if k in ln:
            assert torch.equal(v, torch.ones_like(v)), k
        elif k.endswith("bias"):
            assert torch.equal(v, torch.zeros_like(v)), k
    draws = torch.cat([v.reshape(-1) for k, v in sd.items()
                       if k not in ln and not k.endswith("bias")])
    assert abs(draws.std().item() - 0.02) < 0.001 and abs(draws.mean().item()) < 0.001
    again, other = random_state_dict(cfg, seed=0), random_state_dict(cfg, seed=1)
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["visual_projection.weight"], other["visual_projection.weight"])


# Top-level names the port and chip_smoke.py must never import: JAX, its
# libraries, and the JAX package itself (even its JAX-free modules).
_FORBIDDEN = "('jax', 'flax', 'optax', 'dclip_tpu')"


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dclip_tpu_torch\n"
        "for m in pkgutil.walk_packages(dclip_tpu_torch.__path__, 'dclip_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_FORBIDDEN})\n"
        "assert not bad, bad\n"
        "print('modules', len([k for k in sys.modules if k.startswith('dclip_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20


def test_chip_smoke_never_imports_jax():
    """chip_smoke.py, imported without running main, and the port modules
    its phases import, pull in nothing of JAX or the JAX package."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "mod.import_port_modules()\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {_FORBIDDEN})\n"
        "assert not bad, bad\n"
        "print('modules', len([k for k in sys.modules if k.startswith('dclip_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 10


def test_resolve_device_never_falls_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="is_available"):
            resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_resolve_dtype():
    assert resolve_dtype("auto", torch.device("cpu")) == torch.float32
    assert resolve_dtype("auto", torch.device("cuda", 0)) == torch.bfloat16
    assert resolve_dtype("float32", torch.device("cuda", 0)) == torch.float32
    with pytest.raises(ValueError):
        resolve_dtype("float16", torch.device("cpu"))
