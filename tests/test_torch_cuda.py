"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card: it is marked `requires_cuda` and skips
elsewhere. This file imports no jax; `tests/conftest.py` does, so on a
machine with a card and no jax it runs without the conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

`chip_smoke.py` covers the same ground at the serving path's and the
training step's full shapes. Tolerance, as there: bf16 keeps 8 significant
bits and the kernels round their outputs and bf16 intermediates where the
f32 twins do not, so max |kernel - twin| <= 2^-6 * max(1, max |twin|) for
forward outputs and 2^-5 * max(1, max |twin|) for gradients (two more
bf16 roundings, and the twin runs from f32 statistics). The distillation
loss computes in f32 on the same inputs as its twin, so it is held to
rtol 1e-5 on its parts and one bf16 ulp (2^-7 * max |twin|) on its
gradients.
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
    from dclip_tpu_torch.core import CLIPConfig
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


# -- the training kernels (K3/K4/K5, K6, K11) ------------------------------------


def _close_rel(got, want, tol=REL_TOL, what=""):
    torch.cuda.synchronize()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert torch.isfinite(got.float()).all(), what
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), (what, err)


def _attn_case(rng, device, b, s, d, masks):
    from dclip_tpu_torch.kernels import vit_attention as va

    qkv = _bf16(rng, device, b, s, 3 * d)
    kw = {}
    if "causal" in masks:
        kw["causal"] = True
    if "pad" in masks:
        lengths = rng.randint(1, s + 1, size=b)
        kw["padding_mask"] = torch.from_numpy(
            (np.arange(s)[None] < lengths[:, None]).astype(np.float32)).to(device)
    if "seg" in masks:
        seg = np.zeros((b, s), np.int32)
        for r in range(b):
            cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
            seg[r] = np.searchsorted(cuts, np.arange(s), side="right") + 1
            seg[r, cuts[-1]:] = 0  # trailing padding segment
        kw["segment_ids"] = torch.from_numpy(seg).to(device)
    return va, qkv, kw


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,d,heads,masks", [
    (2, 197, 768, 12, ()), (3, 77, 512, 8, ("causal", "pad")),
    (3, 77, 512, 8, ("causal", "seg")), (1, 50, 128, 2, ("pad",)),
    (2, 130, 256, 4, ("seg",)),
])
def test_attention_fwd_bwd_match_twins(cuda_device, b, s, d, heads, masks):
    rng = np.random.RandomState(s + d)
    va, qkv, kw = _attn_case(rng, cuda_device, b, s, d, masks)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    va.reset_launches()
    o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
    o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
    _close_rel(o, o_ref, what="o")
    # m: the max of bf16-operand logits (f32 accumulate); rinv from the
    # bf16-rounded P: relative bounds in f32 terms of bf16 inputs.
    _close_rel(m, m_ref, what="m")
    torch.testing.assert_close(r, r_ref, rtol=2.0**-6, atol=0)
    o3 = va.self_attention_fused(q, k, v, heads, **kw)
    torch.testing.assert_close(o3, o, rtol=0, atol=0)  # same kernel, stats off
    g = _bf16(rng, cuda_device, b, s, d)
    grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
    # Held against the f32 twin run from the f32 stats (ROADMAP Queue 3).
    want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
    for name, got_t, want_t in zip(("dq", "dk", "dv"), grads, want):
        _close_rel(got_t, want_t, tol=2.0**-5, what=name)
    assert va.LAUNCHES == {"self_attention_fused": 1, "self_attention_fwd_stats": 1,
                           "self_attention_bwd_stats": 1}


@pytest.mark.requires_cuda
def test_attention_autograd_writes_one_qkv_gradient(cuda_device):
    rng = np.random.RandomState(7)
    va, qkv, kw = _attn_case(rng, cuda_device, 2, 77, 512, ("causal", "seg"))
    qkv.requires_grad_()
    g = _bf16(rng, cuda_device, 2, 77, 512)
    out = va.self_attention_qkv(qkv, 8, **kw)
    out.backward(g)
    ref = qkv.detach().float().requires_grad_()
    want = va.attention_reference(ref[..., :512], ref[..., 512:1024], ref[..., 1024:], 8, **kw)
    want.backward(g.float())
    _close_rel(out, want, what="o")
    _close_rel(qkv.grad, ref.grad, tol=2.0**-5, what="dqkv")
    with torch.no_grad():
        va.reset_launches()
        va.self_attention_qkv(qkv, 8, **kw)
        assert va.LAUNCHES["self_attention_fused"] == 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s", [(2, 197), (1, 50)])
def test_mlp_frozen_fwd_bwd_match_twins(cuda_device, b, s):
    from dclip_tpu_torch.kernels import mlp_frozen as mf

    rng = np.random.RandomState(b * 31 + s)
    lay = _layer(rng, cuda_device)
    p = mf.pack_frozen_mlp(lay["ln2_scale"], lay["ln2_bias"], lay["fc1_w"].t(), lay["fc1_b"],
                           lay["fc2_w"].t(), lay["fc2_b"], torch.bfloat16)
    x = _bf16(rng, cuda_device, b, s, 768)
    g = _bf16(rng, cuda_device, b, s, 768)
    y, a1 = mf.mlp_frozen_fwd(x, p)
    y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p)
    _close_rel(y, y_ref, what="y")
    _close_rel(a1, a1_ref, what="a1")
    _close_rel(y, vb.mlp_block_fused(x, p), tol=0.0, what="y vs the serving block")
    dx = mf.mlp_frozen_bwd(x, g, a1, p)
    _close_rel(dx, mf.mlp_frozen_bwd_reference(x, g, a1_ref, p), tol=2.0**-5, what="dx")
    dh = torch.from_numpy(rng.standard_normal((b, s, 768)).astype(np.float32)).to(cuda_device)
    _close_rel(mf.layernorm_bwd(x, g, dh, p["ln2_scale"]),
               mf.layernorm_bwd_reference(x, g, dh, p["ln2_scale"]), what="ln_bwd")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,d", [(256, 512), (5, 64), (33, 1024)])
def test_distill_loss_matches_twin(cuda_device, b, d):
    from dclip_tpu_torch.kernels import distill_loss as dl

    rng = np.random.RandomState(b + d)
    si, st = _bf16(rng, cuda_device, b, d), _bf16(rng, cuda_device, b, d)
    # Targets correlated with the student rows, so li and lt sit far from 1.
    ti, tt = (x.float() + 0.5 * torch.from_numpy(
        rng.standard_normal((b, d)).astype(np.float32)).to(cuda_device) for x in (si, st))
    parts = dl.distill_loss_fwd(si, st, ti, tt)
    want = dl.distill_loss_fwd_reference(si, st, ti, tt)
    assert want[0] < 0.5 and want[1] < 0.5, want
    # f32 throughout on the same inputs: only the summation order differs.
    torch.testing.assert_close(parts, want, rtol=1e-5, atol=0)
    cts = torch.tensor([0.7, 1.3, 0.9], device=cuda_device)
    for got, want in zip(dl.distill_loss_bwd(si, st, ti, tt, cts),
                         dl.distill_loss_bwd_reference(si, st, ti, tt, cts)):
        # Both round the f32 gradient to bf16 at the end: one ulp at most.
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0**-7 * want.float().abs().max().item(), err


@pytest.mark.requires_cuda
def test_gemm_epilogue_modes(cuda_device):
    rng = np.random.RandomState(11)
    a = _bf16(rng, cuda_device, 3, 70, 256)
    w = _bf16(rng, cuda_device, 256, 136) * 0.1
    bias = torch.from_numpy(rng.standard_normal(136).astype(np.float32)).to(cuda_device)
    aux = _bf16(rng, cuda_device, 3, 70, 136)
    got, pre = vb.gemm_bias_act_residual(a, w, bias, gelu=True, save_preact=True)
    want, want_pre = vb.gemm_bias_act_residual_reference(a, w, bias, gelu=True, save_preact=True)
    _close_rel(got, want, what="gelu")
    _close_rel(pre, want_pre, what="preact")
    _close_rel(vb.gemm_bias_act_residual(a, w, dgelu_of=aux),
               vb.gemm_bias_act_residual_reference(a, w, dgelu_of=aux), what="dgelu")
    f32 = vb.gemm_bias_act_residual(a, w, out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    _close_rel(f32, vb.gemm_bias_act_residual_reference(a, w, out_dtype=torch.float32),
               what="f32 out")


# -- the teacher's cross-attention (K10) and the loader's self-check (K13) --------


def _teacher_sd(rng, d, device):
    """A `cross_modal_attention.*` state dict with 1/sqrt(D) matrices,
    non-zero biases and LN affines (torch nn.MultiheadAttention names)."""
    def n(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))

    sd = {}
    for direction in ("text_to_image", "image_to_text"):
        pre = f"cross_modal_attention.{direction}."
        sd[pre + "in_proj_weight"] = n(3 * d, d, scale=d**-0.5)
        sd[pre + "in_proj_bias"] = n(3 * d, scale=0.1)
        sd[pre + "out_proj.weight"] = n(d, d, scale=d**-0.5)
        sd[pre + "out_proj.bias"] = n(d, scale=0.1)
    for norm in ("norm_text", "norm_image"):
        sd[f"cross_modal_attention.{norm}.weight"] = 1.0 + n(d, scale=0.1)
        sd[f"cross_modal_attention.{norm}.bias"] = n(d, scale=0.1)
    return {k: v.to(device) for k, v in sd.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,t,p,d,heads,masks", [
    (4, 77, 8, 512, 8, "both"), (3, 77, 32, 512, 8, "text"), (2, 5, 3, 256, 4, "image"),
    (2, 20, 77, 768, 8, "none"), (3, 128, 128, 256, 2, "both"),
])
def test_cross_attention_matches_twin(cuda_device, b, t, p, d, heads, masks):
    """K10 against its f32 twin on the same bf16-packed weights: f32 and
    bf16 inputs, single-sided masks, and an image row with no valid box
    (uniform average of the text values, never NaN)."""
    from dclip_tpu_torch.kernels import cross_attention as xa

    rng = np.random.RandomState(t * 7 + p)
    w = xa.pack_cross_attention(_teacher_sd(rng, d, cuda_device), torch.bfloat16)
    # bf16-valued f32 inputs, as the trainer's (bf16 features x 0/1 masks).
    text = _bf16(rng, cuda_device, b, t, d).float()
    image = _bf16(rng, cuda_device, b, p, d).float()
    tmask = torch.from_numpy((np.arange(t)[None] < rng.randint(1, t + 1, (b, 1)))
                             .astype(np.float32)).to(cuda_device)
    imask = torch.from_numpy((rng.rand(b, p) > 0.3).astype(np.float32)).to(cuda_device)
    imask[0] = 0.0
    kw = {"both": (tmask, imask), "text": (tmask, None), "image": (None, imask),
          "none": (None, None)}[masks]
    for dtype in (torch.float32, torch.bfloat16):
        x, y = text.to(dtype), image.to(dtype)
        xa.reset_launches()
        got = xa.cross_attention_fused(w, x, y, *kw, num_heads=heads)
        want = xa.cross_attention_reference(w, x, y, *kw, num_heads=heads)
        assert xa.LAUNCHES == {"cross_attention_core": 1, "add_layernorm_f32": 1,
                               "cross_attention": 1}
        for name, g, r in zip(("text", "image"), got, want):
            assert g.dtype == dtype
            _close_rel(g, r, what=f"{name} {dtype}")


@pytest.mark.requires_cuda
def test_cross_attention_core_all_masked_rows(cuda_device):
    """Rows whose every key is masked average the values, as on the TPU."""
    from dclip_tpu_torch.kernels import cross_attention as xa

    rng = np.random.RandomState(3)
    b, t, p, d = 2, 9, 4, 128
    qkv_t = torch.from_numpy(rng.standard_normal((b, t, 3 * d)).astype(np.float32)).to(cuda_device)
    qkv_i = torch.from_numpy(rng.standard_normal((b, p, 3 * d)).astype(np.float32)).to(cuda_device)
    tmask = torch.ones(b, t, device=cuda_device)
    imask = torch.zeros(b, p, device=cuda_device)
    out_t, out_i = xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, 2)
    v_mean = qkv_i[..., 2 * d:].mean(1, keepdim=True).expand(b, t, d)
    _close_rel(out_t, v_mean, what="uniform average")
    want_t, want_i = xa.cross_attention_core_reference(qkv_t, qkv_i, tmask, imask, 2)
    _close_rel(out_i, want_i, what="image queries")


@pytest.mark.requires_cuda
def test_loader_self_check(cuda_device):
    from dclip_tpu_torch.kernels import _build

    _build.load_library()
    assert _build.SELF_CHECK["max_abs_err"] == 0.0
    x = torch.randn(8, 128, device=cuda_device)
    torch.testing.assert_close(_build.probe_x2(x), 2.0 * x, rtol=0, atol=0)


# -- the trainable blocks (K8, K9), their GEMM modes and row reductions --------------


def _f32(rng, device, *shape, base=0.0, scale=1.0):
    return torch.from_numpy((base + scale * rng.standard_normal(shape)).astype(np.float32)).to(
        device)


def _close_sum(got, want, what=""):
    """f32 sums of the same bf16 products in another order: within 1e-4 of
    the largest |twin|."""
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == torch.float32, what
    err = (got - want.float()).abs().max().item()
    assert err <= 1e-4 * max(1.0, want.float().abs().max().item()), (what, err)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,k,n", [(4928, 512, 2048), (591, 768, 2304), (70, 256, 136)])
def test_gemm_nt_matches_twin(cuda_device, m, k, n):
    from dclip_tpu_torch.kernels import trainable_ops as to

    rng = np.random.RandomState(m + n)
    a = _bf16(rng, cuda_device, m, k)
    w = (_f32(rng, cuda_device, n, k, scale=k**-0.5)).bfloat16()
    bias = _f32(rng, cuda_device, n, scale=0.1)
    res = _bf16(rng, cuda_device, m, n)
    to.reset_launches()
    got, pre = to.gemm_nt(a, w, bias, gelu=True, save_preact=True)
    want, want_pre = to.gemm_nt_reference(a, w, bias, gelu=True, save_preact=True)
    _close_rel(got, want, what="gelu")
    _close_rel(pre, want_pre, what="preact")
    _close_rel(to.gemm_nt(a, w, bias, residual=res),
               to.gemm_nt_reference(a, w, bias, residual=res), what="residual")
    assert to.LAUNCHES["gemm_nt"] == 2


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,p,q", [(4928, 2048, 512), (6304, 768, 768), (1576, 2304, 768),
                                      (37, 24, 136)])
def test_gemm_tn_and_colsum_match_twins(cuda_device, rows, p, q):
    from dclip_tpu_torch.kernels import trainable_ops as to

    rng = np.random.RandomState(rows + p)
    x, y = _bf16(rng, cuda_device, rows, p), _bf16(rng, cuda_device, rows, q)
    got = to.gemm_tn(x, y)
    _close_sum(got, to.gemm_tn_reference(x, y), "gemm_tn")
    assert torch.equal(got, to.gemm_tn(x, y))  # no atomics: the same bits every run
    _close_sum(to.colsum(x), to.colsum_reference(x), "colsum")
    assert torch.equal(to.colsum(y), to.colsum(y))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows,d", [(4928, 512), (6304, 768), (5, 1024)])
def test_layernorm_bwd_wgrad_matches_twin(cuda_device, rows, d):
    from dclip_tpu_torch.kernels import trainable_ops as to

    rng = np.random.RandomState(rows + d)
    x, g = _bf16(rng, cuda_device, rows, d), _bf16(rng, cuda_device, rows, d)
    dh = _f32(rng, cuda_device, rows, d)
    scale = _f32(rng, cuda_device, d, base=1.0, scale=0.1)
    dx, ds, db = to.layernorm_bwd_wgrad(x, g, dh, scale)
    want = to.layernorm_bwd_wgrad_reference(x, g, dh, scale)
    _close_rel(dx, want[0], what="dx")
    _close_sum(ds, want[1], "dscale")
    _close_sum(db, want[2], "dbias")
    none, ds2, db2 = to.layernorm_bwd_wgrad(x, None, dh, scale, need_dx=False)
    assert none is None and torch.equal(ds2, ds) and torch.equal(db2, db)


def _hf_mlp(rng, device, d, mlp):
    return [_f32(rng, device, d, base=1.0, scale=0.1), _f32(rng, device, d, scale=0.1),
            _f32(rng, device, mlp, d, scale=d**-0.5), _f32(rng, device, mlp, scale=0.1),
            _f32(rng, device, d, mlp, scale=mlp**-0.5), _f32(rng, device, d, scale=0.1)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,d,mlp", [(64, 77, 512, 2048), (3, 50, 128, 256)])
def test_mlp_trainable_matches_twin(cuda_device, b, s, d, mlp):
    """K8 forward (y, a1) and all seven gradients against the f32 twins."""
    from dclip_tpu_torch.kernels import mlp_trainable as mt

    rng = np.random.RandomState(b + d)
    weights = _hf_mlp(rng, cuda_device, d, mlp)
    x, g = _bf16(rng, cuda_device, b, s, d), _bf16(rng, cuda_device, b, s, d)
    p = mt.pack_trainable_mlp(*weights, dtype=torch.bfloat16)
    y, a1, h, act = mt.mlp_trainable_fwd(x, p)
    y_ref, a1_ref = mt.mlp_trainable_fwd_reference(x, *weights)
    _close_rel(y, y_ref, what="y")
    _close_rel(a1, a1_ref, what="a1")
    grads = mt.mlp_trainable_bwd(x, g, a1, h, act, p)
    want = mt.mlp_trainable_bwd_reference(x, g, a1_ref, *weights)
    for name, got_t, want_t in zip(("dx", "dln_scale", "dln_bias", "dw1", "db1", "dw2", "db2"),
                                   grads, want):
        _close_rel(got_t, want_t, tol=2.0**-5, what=name)
    # The autograd form: the same gradients, and no weight-gradient launch
    # for frozen weights.
    xs = x.clone().requires_grad_()
    ws = [w.clone().requires_grad_(i >= 2) for i, w in enumerate(weights)]
    mt.reset_launches()
    vb.reset_launches()
    mt.mlp_block_trainable(xs, *ws).backward(g)
    assert mt.LAUNCHES == {"mlp_trainable_fwd": 1, "mlp_trainable_bwd": 1}
    assert ws[0].grad is None and ws[1].grad is None
    _close_rel(xs.grad, want[0], tol=2.0**-5, what="dx (autograd)")
    _close_rel(ws[2].grad, want[3], tol=2.0**-5, what="dw1 (autograd)")


def _hf_attn(rng, device, d):
    out = [_f32(rng, device, d, base=1.0, scale=0.1), _f32(rng, device, d, scale=0.1)]
    for _ in range(4):
        out += [_f32(rng, device, d, d, scale=d**-0.5), _f32(rng, device, d, scale=0.1)]
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,d,heads", [(2, 197, 768, 12), (3, 50, 128, 2)])
def test_attn_block_trainable_matches_twin(cuda_device, b, s, d, heads):
    """K9 forward (o, q, k, v, attn, m, rinv) and all eleven gradients
    against the f32 twins. rinv is held relative to the twin's at 2^-5: the
    kernel's logits come from bf16 q and k, the twin's from f32 ones, and a
    logit's rounding error scales with its size. dbk is 0 in exact
    arithmetic (softmax ignores a per-row shift), so both sides hold
    rounding noise of the row sum there: it is held to 2^-5 of the largest
    |dbq| instead."""
    from dclip_tpu_torch.kernels import attn_block_trainable as ab

    rng = np.random.RandomState(s + d)
    weights = _hf_attn(rng, cuda_device, d)
    x, g = _bf16(rng, cuda_device, b, s, d), _bf16(rng, cuda_device, b, s, d)
    p = ab.pack_trainable_attn(*weights, dtype=torch.bfloat16)
    o, h, qkv, attn, m, r = ab.attention_block_trainable_fwd(x, p, heads)
    want = ab.attention_block_trainable_fwd_reference(x, *weights, heads)
    for name, got_t, want_t in zip(("o", "q", "k", "v", "attn", "m"),
                                   (o, *qkv.split(d, -1), attn, m), want):
        _close_rel(got_t, want_t, what=name)
    torch.testing.assert_close(r, want[6], rtol=2.0**-5, atol=0)
    grads = ab.attention_block_trainable_bwd(x, g, h, qkv, attn, m, r, p, heads)
    wgrads = ab.attention_block_trainable_bwd_reference(x, g, *want[1:], *weights, heads)
    names = ("dx", "dln_scale", "dln_bias", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo",
             "dbo")
    for name, got_t, want_t in zip(names, grads, wgrads):
        if name == "dbk":
            torch.cuda.synchronize()
            err = (got_t - want_t).abs().max().item()
            assert err <= 2.0**-5 * wgrads[4].abs().max().item(), (name, err)
        else:
            _close_rel(got_t, want_t, tol=2.0**-5, what=name)
    # The default vision mask in the first layer: only q/k/v/out_proj train
    # and the input needs no gradient, so no dh product, no LN backward.
    ws = [w.clone().requires_grad_(i >= 2) for i, w in enumerate(weights)]
    vb.reset_launches()
    ab.attention_block_trainable(x, *ws, heads).backward(g)
    assert vb.LAUNCHES["gemm_bias_act_residual"] == 1 and vb.LAUNCHES["layernorm"] == 1
    assert ws[0].grad is None and all(w.grad is not None for w in ws[2:])
