"""The port's int8 weight-only serving (dclip_tpu_torch.serve.quant and
`ClipService(quantize="int8")`) against the JAX package's on the CPU at
the tiny config, on bridged weights: the quantized tree bit for bit, the
int8 features of both towers, and the int8 service end to end."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.serve import quant as jax_quant
from dclip_tpu_torch.data.tokenizer import HashTokenizer
from dclip_tpu_torch.serve import ClipService, quant

import torch_parity

# L2-normalized f32 embeddings after 2-layer towers: the two frameworks
# sum in different orders.
EMB_ATOL = 1e-5


@pytest.fixture(scope="module")
def bridged():
    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=0)
    return cfg, params, torch_parity.port_clip(cfg, params)


def _leaves(tree):
    return {jax.tree_util.keystr(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _normalized(e):
    e = np.asarray(e, np.float32)
    return e / np.linalg.norm(e, axis=-1, keepdims=True)


@pytest.mark.parametrize("source", ["model", "state_dict"])
def test_quantize_clip_equals_jax_bit_for_bit(bridged, source):
    """Every `q` equal and every `scale` bit-equal, in the Flax layout and
    tree: the port transposes the Linear weights and the patch conv back
    to [in, out] / HWIO before the per-output-channel rule."""
    cfg, params, model = bridged
    want = _leaves(jax_quant.quantize_clip({"params": params}, cfg))
    got = _leaves(quant.quantize_clip(model if source == "model" else model.state_dict(), cfg))
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        assert got[key].tobytes() == w.tobytes(), key
    assert sum(1 for k in got if k.endswith("['q']")) == 2 + 6 * (
        cfg.text.num_layers + cfg.vision.num_layers) + 2


def test_quantized_features_match_jax(bridged):
    """Both towers' int8 features (f32 on the CPU) against JAX's on the same
    weights and inputs; the text batch holds padded rows and a row with no
    EOS id, which pools the last position."""
    cfg, params, model = bridged
    jq = jax_quant.quantize_clip({"params": params}, cfg)
    tq = quant.to_device(quant.quantize_clip(model, cfg), "cpu")
    ids, mask = torch_parity.text_batch(cfg, seed=1)
    assert not (ids[-1] == cfg.text.eos_token_id).any() and (mask == 0).any()
    want = jax_quant.quantized_text_features(cfg, jq, jnp.asarray(ids), jnp.asarray(mask))
    got = quant.quantized_text_features(cfg, tq, torch.from_numpy(ids), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (5, cfg.projection_dim)
    np.testing.assert_allclose(_normalized(got.numpy()), _normalized(want), rtol=0,
                               atol=EMB_ATOL)
    px = torch_parity.pixels(cfg, 3, seed=2)
    want = jax_quant.quantized_image_features(cfg, jq, jnp.asarray(px))
    got = quant.quantized_image_features(cfg, tq, torch.from_numpy(px))
    np.testing.assert_allclose(_normalized(got.numpy()), _normalized(want), rtol=0,
                               atol=EMB_ATOL)


def test_quantized_forward_cosine_parity(bridged):
    """The int8 embeddings stay within cosine 0.99 of the f32 module route
    (the JAX contract, `tests/test_serve.py:346-385`)."""
    cfg, _, model = bridged
    tq = quant.to_device(quant.quantize_clip(model, cfg), "cpu")
    ids, mask = (torch.from_numpy(a) for a in torch_parity.text_batch(cfg, seed=3))
    px = torch.from_numpy(torch_parity.pixels(cfg, 4, seed=3))
    with torch.no_grad():
        pairs = ((model.get_text_features(ids, mask),
                  quant.quantized_text_features(cfg, tq, ids, mask)),
                 (model.image_features(px), quant.quantized_image_features(cfg, tq, px)))
    for want, got in pairs:
        cos = (_normalized(want.numpy()) * _normalized(got.numpy())).sum(-1)
        assert cos.min() > 0.99, cos


def test_quantized_service_end_to_end(bridged):
    """`test_quantized_service_end_to_end` of `tests/test_serve.py`, ported:
    unit-norm embeddings, a search over them, the stats, and `quantize`
    other than int8 refused with ValueError."""
    cfg, _, model = bridged
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    qsvc = ClipService(model, cfg, tokenizer=tok, buckets=(1, 4),
                       index_dim=cfg.projection_dim, quantize="int8", device="cpu")
    assert qsvc.model is None and qsvc.image_route == "int8"
    assert qsvc.params["text_model"]["token_embedding"]["q"].dtype == torch.int8
    texts = ["a dog", "a cat", "an airplane"]
    embs = qsvc.encode_texts(texts)
    assert embs.shape == (3, cfg.projection_dim)
    np.testing.assert_allclose(np.linalg.norm(embs, axis=-1), 1.0, atol=1e-5)
    qsvc.add_to_index(["dog", "cat", "plane"], embs)
    hits = qsvc.search_texts(["a cat"], k=1)
    assert hits[0][0][0] == "cat"
    assert qsvc.stats()["quantize"] == "int8"
    u8 = np.random.RandomState(6).randint(0, 256, (2,) + (cfg.vision.image_size,) * 2 + (3,),
                                          np.uint8)
    images = qsvc.encode_images(list(u8))
    np.testing.assert_allclose(np.linalg.norm(images, axis=-1), 1.0, atol=1e-5)
    with pytest.raises(ValueError, match="quantize"):
        ClipService(model, cfg, quantize="fp4", device="cpu")


def test_int8_tree_is_smaller(bridged):
    """The int8 tree holds under 0.45 of the f32 weights' bytes."""
    cfg, _, model = bridged
    q = quant.quantize_clip(model, cfg)
    f32 = sum(v.numel() * 4 for k, v in model.state_dict().items() if k != "logit_scale")
    assert quant.tree_bytes(q) < 0.45 * f32
    assert quant.tree_bytes(quant.to_device(q, "cpu")) == quant.tree_bytes(q)
