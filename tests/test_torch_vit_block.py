"""The port's fused ViT block wrappers (dclip_tpu_torch.kernels.vit_block)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch twin, so these tests
pin the twins' algebra to the TPU kernels at f32. The CUDA kernels
themselves run only on a card: tests/test_torch_cuda.py holds them
against the twins there (chip_smoke.py covers the same ground at full
width)."""
import numpy as np
import pytest
import torch

from dclip_tpu.kernels import vit_block as jax_vit_block
from dclip_tpu_torch.kernels import _build
from dclip_tpu_torch.kernels import vit_block as vb
from dclip_tpu_torch.models.weights import layer_state_dict_from_jax

import torch_parity


# f32 on both sides; the Pallas kernel and the twin sum in different orders
# (K up to 3072), so a few f32 ulps of the O(1) outputs separate them.
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "d,heads,mlp,s,b",
    [(32, 4, 64, 13, 3), (768, 12, 3072, 197, 2)],
    ids=["tiny", "b16_one_layer"],
)
def test_blocks_match_pallas_interpret(d, heads, mlp, s, b):
    rng = np.random.RandomState(0)
    params = torch_parity.layer_params(rng, d, mlp)
    x = rng.standard_normal((b, s, d)).astype(np.float32)

    want_attn = jax_vit_block.attention_block_fused(x, params, heads, 1e-5, interpret=True)
    want_mlp = jax_vit_block.mlp_block_fused(np.asarray(want_attn), params, 1e-5,
                                             interpret=True)

    p = vb.pack_layer(layer_state_dict_from_jax(params), "", torch.float32)
    got_attn = vb.attention_block_fused(torch.from_numpy(x), p, heads, 1e-5)
    got_mlp = vb.mlp_block_fused(torch.from_numpy(np.asarray(want_attn)), p, 1e-5)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), **BLOCK_TOL)
    np.testing.assert_allclose(got_mlp.numpy(), np.asarray(want_mlp), **BLOCK_TOL)

    layers = [p, p]
    got = vb.encoder_forward_fused(layers, torch.from_numpy(x), heads, 1e-5)
    want = jax_vit_block.encoder_forward_fused(
        {"layers_0": params, "layers_1": params}, x, 2, heads, 1e-5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)


def test_pack_layer_layouts():
    """GEMM weights [in, out] with q|k|v concatenated; f32 LN and biases;
    GEMM weights in the compute dtype."""
    rng = np.random.RandomState(1)
    params = torch_parity.layer_params(rng, 32, 64)
    p = vb.pack_layer(layer_state_dict_from_jax(params), "", torch.bfloat16)
    a = params["self_attn"]
    qkv = np.concatenate([a[n]["kernel"] for n in ("q_proj", "k_proj", "v_proj")], 1)
    np.testing.assert_array_equal(p["qkv_w"].float().numpy(),
                                  torch.from_numpy(qkv).bfloat16().float().numpy())
    assert p["qkv_w"].shape == (32, 96) and p["qkv_w"].dtype == torch.bfloat16
    assert p["fc1_w"].shape == (32, 64) and p["fc2_w"].shape == (64, 32)
    for k in ("ln1_scale", "qkv_b", "out_b", "fc1_b", "fc2_b", "ln2_bias"):
        assert p[k].dtype == torch.float32, k
    np.testing.assert_array_equal(p["ln2_scale"].numpy(), params["layer_norm2"]["scale"])


def test_attention_reference_is_softmax_attention():
    """The log2-domain, normalise-after-PV algebra of the twin equals plain
    softmax(q k^T / sqrt(hd)) v (float64 numpy)."""
    rng = np.random.RandomState(2)
    b, s, heads, hd = 2, 11, 3, 8
    qkv = rng.standard_normal((b, s, 3 * heads * hd)).astype(np.float32)
    got = vb.attention_reference(torch.from_numpy(qkv), heads).numpy()
    q, k, v = (t.reshape(b, s, heads, hd).transpose(0, 2, 1, 3).astype(np.float64)
               for t in np.split(qkv, 3, axis=-1))
    logits = q @ k.transpose(0, 1, 3, 2) / np.sqrt(hd)
    prob = np.exp(logits - logits.max(-1, keepdims=True))
    prob /= prob.sum(-1, keepdims=True)
    want = (prob @ v).transpose(0, 2, 1, 3).reshape(b, s, heads * hd)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("gelu,residual", [(False, False), (False, True),
                                           (True, False), (True, True)])
def test_gemm_reference_epilogues(gelu, residual):
    rng = np.random.RandomState(3)
    a = rng.standard_normal((7, 32)).astype(np.float32)
    w = rng.standard_normal((32, 16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    r = rng.standard_normal((7, 16)).astype(np.float32)
    want = a.astype(np.float64) @ w + bias
    if gelu:
        want = want / (1.0 + np.exp(-1.702 * want))
    if residual:
        want = want + r
    got = vb.gemm_bias_act_residual(
        torch.from_numpy(a), torch.from_numpy(w), torch.from_numpy(bias),
        torch.from_numpy(r) if residual else None, gelu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_cpu_path_counts_no_launches():
    vb.reset_launches()
    rng = np.random.RandomState(4)
    p = vb.pack_layer(layer_state_dict_from_jax(torch_parity.layer_params(rng, 32, 64)),
                      "", torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, 5, 32)).astype(np.float32))
    vb.mlp_block_fused(vb.attention_block_fused(x, p, 4), p)
    assert all(v == 0 for v in vb.LAUNCHES.values()), vb.LAUNCHES


def _fake_cuda(*shape, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.zeros(*shape, dtype=dtype, device="cuda")


def test_cuda_tensor_never_falls_back_to_the_twin(monkeypatch):
    """A CUDA tensor goes to the kernel (here: the library load, which is
    made to raise) or raises on a layout the kernel does not take; the
    twin is never its fallback."""
    def no_library():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(vb, "load_library", no_library)
    for name in ("layernorm_reference", "gemm_bias_act_residual_reference",
                 "attention_reference"):
        monkeypatch.setattr(vb, name, lambda *a, **k: pytest.fail("twin called"))
    x = _fake_cuda(2, 197, 768)
    scale = _fake_cuda(768, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        vb.layernorm(x, scale, scale)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        vb.gemm_bias_act_residual(x, _fake_cuda(768, 2304), _fake_cuda(2304, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="kernel library requested"):
        vb.attention(_fake_cuda(2, 197, 2304), 12)
    with pytest.raises(TypeError, match="bfloat16"):
        vb.layernorm(_fake_cuda(2, 197, 768, dtype=torch.float32), scale, scale)
    with pytest.raises(ValueError, match="head_dim 64"):
        vb.attention(_fake_cuda(2, 197, 3 * 96), 3)


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_source_digest_tracks_sources(tmp_path, monkeypatch):
    """The rebuild stamp changes when any .cu or .cuh source changes."""
    import shutil

    names = sorted(p.rsplit("/", 1)[-1] for p in _build._sources())
    assert names == ["attention.cu", "attention_bwd.cu", "cross_attention.cu", "distill_loss.cu",
                     "gemm.cu", "layernorm.cu", "reduce.cu", "status.cu"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = _build.source_digest()
    assert before == _build.source_digest()
    with open(csrc / "common.cuh", "a") as f:
        f.write("// edit\n")
    assert _build.source_digest() != before
