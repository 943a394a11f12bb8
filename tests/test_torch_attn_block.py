"""The port's trainable attention block (dclip_tpu_torch.kernels
.attn_block_trainable, K9) against the JAX package on the CPU: the K9 twin
against `attention_block_trainable(interpret=True)`, forward and all
eleven cotangents, at `tests/test_kernels.py`'s fixture; the image tower
with `fused_trainable_attn_block` against the JAX module with the same
flag, and the text tower unchanged by the flag (its causal mask keeps the
per-op attention)."""
import numpy as np
import pytest
import torch

from dclip_tpu_torch.kernels import attn_block_trainable as ab
from dclip_tpu_torch.kernels import trainable_ops as to
from dclip_tpu_torch.kernels import vit_attention as va
from dclip_tpu_torch.kernels import vit_block as vb

import torch_parity

HEADS = 4
KEYS = ("ln_scale", "ln_bias", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")
# JAX's own tolerances for this kernel (tests/test_kernels.py:722,736).
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _args():
    """tests/test_kernels.py `attn_block_args`: B=3, S=13, D=32, 4 heads,
    weights in the JAX layout ([in, out])."""
    rng = np.random.RandomState(7)
    b, s, d = 3, 13, 32
    x = rng.randn(b, s, d).astype(np.float32)

    def mk(*shape):
        return (rng.randn(*shape) / np.sqrt(shape[0])).astype(np.float32)

    w = dict(ln_scale=(1.0 + 0.1 * rng.randn(d)).astype(np.float32),
             ln_bias=(0.1 * rng.randn(d)).astype(np.float32),
             wq=mk(d, d), bq=mk(d), wk=mk(d, d), bk=mk(d), wv=mk(d, d), bv=mk(d),
             wo=mk(d, d), bo=mk(d))
    return x, w


def _hf(x, w):
    """The port's operands: HF layout ([out, in] matrices)."""
    return [torch.from_numpy(x)] + [
        torch.from_numpy(np.ascontiguousarray(w[k].T if k.startswith("w") else w[k]))
        for k in KEYS]


def _jax_block(x, *ws):
    from dclip_tpu.kernels import attention_block_trainable

    wd = dict(zip(KEYS, ws))
    return attention_block_trainable(
        x, wd["ln_scale"], wd["ln_bias"], wd["wq"], wd["bq"], wd["wk"], wd["bk"], wd["wv"],
        wd["bv"], wd["wo"], wd["bo"], num_heads=HEADS, interpret=True)


def test_forward_matches_pallas_interpret():
    x, w = _args()
    want = _jax_block(x, *(w[k] for k in KEYS))
    got = ab.attention_block_trainable(*_hf(x, w), HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_forward_twin_emits_the_kernels_outputs():
    """o, q, k, v, attn and the stats (m, rinv) of `_fwd_kernel`, in the
    contract of the port's K4."""
    from dclip_tpu.kernels.attn_block_trainable import _fwd_call

    x, w = _args()
    want = _fwd_call(x, tuple(w[k] for k in KEYS), num_heads=HEADS, eps=1e-5, interpret=True)
    got = ab.attention_block_trainable_fwd_reference(*_hf(x, w), HEADS)
    for name, a, b in zip(("o", "q", "k", "v", "attn", "m", "rinv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5,
                                   err_msg=name)
    _, q, k, v, attn, m, r = got
    o4, m4, r4 = va.attention_reference(q, k, v, HEADS, stats=True)
    torch.testing.assert_close((attn, m, r), (o4, m4, r4), rtol=0, atol=0)


def test_all_eleven_cotangents_match_pallas_interpret():
    import jax
    import jax.numpy as jnp

    x, w = _args()
    target = np.random.RandomState(8).randn(*x.shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum((_jax_block(*a) - target) ** 2),
                    argnums=tuple(range(11)))(x, *(w[k] for k in KEYS))
    ts = [t.requires_grad_() for t in _hf(x, w)]
    ((ab.attention_block_trainable(*ts, HEADS) - torch.from_numpy(target)) ** 2).sum().backward()
    for name, t, g in zip(("x",) + KEYS, ts, want):
        got = t.grad.numpy()
        if name.startswith("w"):
            got = got.T
        assert float(np.abs(np.asarray(g)).max()) > 0.0, name
        np.testing.assert_allclose(got, np.asarray(g), err_msg=name, **GRAD_TOL)


def test_backward_twin_is_autograd_of_the_forward_twin():
    x, w = _args()
    ts = [t.double().requires_grad_() for t in _hf(x, w)]
    g = torch.from_numpy(np.random.RandomState(3).randn(*x.shape))
    o, q, k, v, attn, m, r = ab.attention_block_trainable_fwd_reference(*ts, HEADS)
    auto = torch.autograd.grad(o, ts, g)
    det = [t.detach() for t in ts]
    mine = ab.attention_block_trainable_bwd_reference(det[0], g, q.detach(), k.detach(),
                                                      v.detach(), attn.detach(), m.detach(),
                                                      r.detach(), *det[1:], HEADS)
    # The twins run in f32 (gradients up to ~16 here), autograd in f64.
    for name, a, b in zip(("x",) + KEYS, mine, auto):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-5, msg=name)


def test_frozen_inputs_get_no_gradient():
    """The default vision mask: q/k/v/out_proj train, LN1 and the block's
    input (frozen embeddings in the first layer) do not."""
    x, w = _args()
    ts = _hf(x, w)
    for i in range(3, 11):
        ts[i].requires_grad_()
    ab.attention_block_trainable(*ts, HEADS).sum().backward()
    assert all(t.grad is None for t in ts[:3])
    assert all(t.grad is not None for t in ts[3:])


def test_image_tower_with_fused_block_matches_jax_module_and_text_is_unchanged():
    """CLIPModule(fused_trainable_attn_block=True): image features and the
    vision LN1 / attention gradients of the JAX module with the same flag,
    and text features bit-equal to the module without the flag
    (tests/test_kernels.py:771)."""
    import jax
    import jax.numpy as jnp

    from dclip_tpu.core.config import CLIPConfig
    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.weights import state_dict_from_jax

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=1)
    px = torch_parity.pixels(cfg, 2, seed=9)
    jm = JaxCLIPModule(cfg, fused_trainable_attn_block=True, pallas_interpret=True)

    def loss(p):
        out = jm.apply({"params": p}, px, method=jm.get_image_features)
        return jnp.sum(out * out), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    sd = state_dict_from_jax(params, cfg)
    model = CLIPModule(cfg, device="meta", fused_trainable_attn_block=True)
    model.load_state_dict(sd, strict=True, assign=True)
    got = model.image_features(torch.from_numpy(px))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    (got * got).sum().backward()
    grads = state_dict_from_jax(jax.device_get(jgrads), cfg)
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith("vision_model.encoder.") and ("self_attn" in name
                                                         or "layer_norm1" in name):
            assert float(p.grad.abs().max()) > 0.0 or "k_proj.bias" in name, name
            np.testing.assert_allclose(p.grad.numpy(), grads[name].reshape(p.shape).numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            checked += 1
    assert checked == 10 * cfg.vision.num_layers

    plain = CLIPModule(cfg, device="meta")
    plain.load_state_dict(sd, strict=True, assign=True)
    ids, mask = (torch.from_numpy(a) for a in torch_parity.text_batch(cfg, seed=2))
    with torch.no_grad():
        torch.testing.assert_close(model.get_text_features(ids, mask),
                                   plain.get_text_features(ids, mask), rtol=0, atol=0)


def _fake_cuda(*shape, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.zeros(*shape, dtype=dtype, device="cuda")


def test_cuda_tensors_never_fall_back_to_the_twin(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library requested")

    for mod in (to, vb):
        monkeypatch.setattr(mod, "load_library", no_library)
    for name in ("attention_block_trainable_fwd_reference",
                 "attention_block_trainable_bwd_reference"):
        monkeypatch.setattr(ab, name, lambda *a, **k: pytest.fail("twin called"))
    x = _fake_cuda(2, 197, 768)
    f32 = _fake_cuda(768, dtype=torch.float32)
    w = _fake_cuda(768, 768, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        ab.attention_block_trainable(x, f32, f32, w, f32, w, f32, w, f32, w, f32, 12)
