"""The port's `CLIPModule` against `transformers.CLIPModel` on the CPU at f32.

Counterpart of `tests/test_clip_parity.py` (which holds the Flax module to
HF through `hf_import`): a random-weight HF CLIP at the tiny size, built
from a config (nothing downloaded); the port loads its state dict as it
is, strict, since it keeps HF's parameter names, and must compute HF's
text features, image features (the module route and the serving route)
and `logits_per_image`.
"""
import numpy as np
import pytest
import torch

from dclip_tpu_torch.core.config import CLIPConfig
from dclip_tpu_torch.models.clip import CLIPModule

transformers = pytest.importorskip("transformers")

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(scope="module")
def models():
    cfg = CLIPConfig.tiny_test()
    hf_cfg = transformers.CLIPConfig(
        text_config=dict(
            vocab_size=cfg.text.vocab_size,
            hidden_size=cfg.text.hidden_size,
            num_hidden_layers=cfg.text.num_layers,
            num_attention_heads=cfg.text.num_heads,
            intermediate_size=cfg.text.mlp_dim,
            max_position_embeddings=cfg.text.max_length,
            eos_token_id=cfg.text.eos_token_id,
            bos_token_id=998,
            pad_token_id=0,
        ),
        vision_config=dict(
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size,
            hidden_size=cfg.vision.hidden_size,
            num_hidden_layers=cfg.vision.num_layers,
            num_attention_heads=cfg.vision.num_heads,
            intermediate_size=cfg.vision.mlp_dim,
        ),
        projection_dim=cfg.projection_dim,
    )
    torch.manual_seed(0)
    hf = transformers.CLIPModel(hf_cfg).eval()
    port = CLIPModule(cfg, device="meta")
    port.load_state_dict(hf.state_dict(), strict=True, assign=True)
    return cfg, hf, port.eval()


def _text_batch(cfg, bs=3):
    rng = np.random.RandomState(0)
    ids = rng.randint(1, cfg.text.vocab_size - 2, size=(bs, cfg.text.max_length))
    lengths = [5, 9, cfg.text.max_length - 1]
    mask = np.zeros_like(ids)
    for i, n in enumerate(lengths):
        ids[i, n] = cfg.text.eos_token_id
        ids[i, n + 1:] = 0
        mask[i, : n + 1] = 1
    return torch.from_numpy(ids).long(), torch.from_numpy(mask).long()


def _pixels(cfg, n, seed):
    """NCHW for HF, and the port's NHWC view of the same values."""
    rng = np.random.RandomState(seed)
    pix = torch.from_numpy(rng.randn(n, 3, cfg.vision.image_size,
                                     cfg.vision.image_size).astype(np.float32))
    return pix, pix.permute(0, 2, 3, 1).contiguous()


def _hf(t):
    """A features tensor from transformers (a tensor, or an output holding one)."""
    return torch.as_tensor(t if isinstance(t, torch.Tensor) else t.pooler_output).numpy()


def test_state_dict_loads_strict_with_hf_names(models):
    _, hf, port = models
    want = hf.state_dict()
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and torch.equal(got[k], v), k


def test_text_features_parity(models):
    cfg, hf, port = models
    ids, mask = _text_batch(cfg)
    with torch.no_grad():
        want = _hf(hf.get_text_features(input_ids=ids, attention_mask=mask))
        got = port.get_text_features(ids, mask).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("route", ["module", "serving"])
def test_image_features_parity(models, route):
    cfg, hf, port = models
    nchw, nhwc = _pixels(cfg, 2, seed=1)
    with torch.no_grad():
        want = _hf(hf.get_image_features(pixel_values=nchw))
        fn = port.image_features if route == "module" else port.get_image_features
        got = fn(nhwc).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_logits_parity(models):
    cfg, hf, port = models
    ids, mask = _text_batch(cfg)
    nchw, nhwc = _pixels(cfg, 3, seed=2)
    with torch.no_grad():
        want = hf(input_ids=ids, attention_mask=mask, pixel_values=nchw).logits_per_image.numpy()
        img = port.image_features(nhwc)
        txt = port.get_text_features(ids, mask)
        img = img / img.norm(dim=-1, keepdim=True)
        txt = txt / txt.norm(dim=-1, keepdim=True)
        got = (port.logit_scale.exp() * img @ txt.t()).numpy()
    np.testing.assert_allclose(got, want, **TOL)
