"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card: it is marked `requires_cuda` and skips
elsewhere. This file imports no jax; `tests/conftest.py` does, so on a
machine with a card and no jax it runs without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

`chip_smoke.py` covers the same ground at the serving path's full shapes.
Tolerance, as there: bf16 keeps 8 significant bits and the kernels round
their outputs and bf16 intermediates where the f32 twins do not, so
max |kernel - twin| <= 2^-6 * max(1, max |twin|).
"""
import numpy as np
import pytest
import torch

from dclip_tpu_torch.kernels import vit_block as vb

REL_TOL = 2.0**-6


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these checks on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close_bf16(got, want):
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= REL_TOL * max(1.0, want.float().abs().max().item()), err


def _layer(rng, device, d=768, mlp=3072):
    def w(i, o):
        return torch.from_numpy((rng.standard_normal((i, o)) * i**-0.5).astype(np.float32))

    def f32(n, base=0.0):
        return torch.from_numpy((base + 0.1 * rng.standard_normal(n)).astype(np.float32))

    p = {"ln1_scale": f32(d, 1.0), "ln1_bias": f32(d), "qkv_w": w(d, 3 * d),
         "qkv_b": f32(3 * d), "out_w": w(d, d), "out_b": f32(d),
         "ln2_scale": f32(d, 1.0), "ln2_bias": f32(d), "fc1_w": w(d, mlp),
         "fc1_b": f32(mlp), "fc2_w": w(mlp, d), "fc2_b": f32(d)}
    return {k: (v.bfloat16() if k.endswith("_w") else v).to(device) for k, v in p.items()}


def _bf16(rng, device, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        device, torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s", [(1, 197), (3, 197), (2, 50)])
def test_kernels_match_twins(cuda_device, b, s):
    rng = np.random.RandomState(b * 1000 + s)
    p = _layer(rng, cuda_device)
    x = _bf16(rng, cuda_device, b, s, 768)
    _close_bf16(vb.layernorm(x, p["ln1_scale"], p["ln1_bias"]),
                vb.layernorm_reference(x, p["ln1_scale"], p["ln1_bias"]))
    for w, bias, kw, a in (
        ("qkv_w", "qkv_b", {}, x),
        ("out_w", "out_b", {"residual": x}, x),
        ("fc1_w", "fc1_b", {"gelu": True}, x),
        ("fc2_w", "fc2_b", {"residual": x}, _bf16(rng, cuda_device, b, s, 3072)),
    ):
        _close_bf16(vb.gemm_bias_act_residual(a, p[w], p[bias], **kw),
                    vb.gemm_bias_act_residual_reference(a, p[w], p[bias], **kw))
    qkv = _bf16(rng, cuda_device, b, s, 3 * 768)
    _close_bf16(vb.attention(qkv, 12), vb.attention_reference(qkv, 12))
    _close_bf16(vb.attention_block_fused(x, p, 12), vb.attention_block_reference(x, p, 12))
    _close_bf16(vb.mlp_block_fused(x, p), vb.mlp_block_reference(x, p))


@pytest.mark.requires_cuda
def test_encoder_launch_counts(cuda_device):
    rng = np.random.RandomState(0)
    layers = [_layer(rng, cuda_device) for _ in range(2)]
    x = _bf16(rng, cuda_device, 2, 197, 768)
    vb.reset_launches()
    got = vb.encoder_forward_fused(layers, x, 12)
    want = vb.encoder_forward_reference(layers, x, 12)
    _close_bf16(got, want)
    assert vb.LAUNCHES == {"layernorm": 4, "gemm_bias_act_residual": 8, "attention": 2,
                           "attention_block": 2, "mlp_block": 2, "encoder_forward": 1,
                           "image_features": 0}


@pytest.mark.requires_cuda
def test_kernels_reject_unsupported_inputs(cuda_device):
    x = torch.zeros(2, 197, 768, device=cuda_device)
    scale = torch.ones(768, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        vb.layernorm(x, scale, scale)  # f32 activations
    xb = x.bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        vb.layernorm(xb.transpose(0, 1), scale, scale)
    with pytest.raises(ValueError, match="K % 32"):
        vb.gemm_bias_act_residual(xb[..., :760].contiguous(),
                                  torch.zeros(760, 8, device=cuda_device).bfloat16(),
                                  torch.zeros(8, device=cuda_device))
    with pytest.raises(ValueError, match="head_dim 64"):
        vb.attention(torch.zeros(1, 197, 3 * 768, device=cuda_device).bfloat16(), 8)


@pytest.mark.requires_cuda
def test_image_features_match_f32_twin(cuda_device):
    from dclip_tpu.core.config import CLIPConfig
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.weights import random_state_dict

    cfg = CLIPConfig.vit_b_16()
    model = CLIPModule(cfg, dtype=torch.bfloat16, device="meta")
    model.load_state_dict(random_state_dict(cfg, 0), assign=True)
    model = model.to(cuda_device)
    px = torch.from_numpy(np.random.RandomState(1).standard_normal(
        (3, 224, 224, 3)).astype(np.float32)).to(cuda_device)
    with torch.no_grad():
        got = model.get_image_features(px).float()
        w32 = vb.pack_vision_weights(cfg, model.state_dict(), torch.float32)
        want = vb.fused_image_features_reference(cfg, w32, px)
    cos = torch.nn.functional.cosine_similarity(got, want, dim=-1)
    assert cos.min().item() >= 0.99, cos
