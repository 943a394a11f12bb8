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
    with pytest.raises(ValueError, match="K % 8"):
        vb.gemm_bias_act_residual(xb[..., :764].contiguous(),
                                  torch.zeros(764, 8, device=cuda_device).bfloat16(),
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


def _edge_masks(b, s, masks, device):
    """The masks of `test_attention_forward_edges`: none; causal + key
    padding whose last batch row has no valid key (a fully masked row);
    three segments and trailing padding (segment 0)."""
    if masks == "none":
        return {}
    if masks == "causal_pad":
        lengths = np.maximum(1, (np.arange(b) + 1) * s // b)
        lengths[-1] = 0
        pad = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
        return {"causal": True, "padding_mask": torch.from_numpy(pad).to(device)}
    seg = (np.arange(s) * 3 // max(s, 1) + 1)[None].repeat(b, 0).astype(np.int32)
    seg[:, s - s // 5:] = 0
    seg = torch.from_numpy(seg).to(device)
    if masks == "causal_segments":
        return {"causal": True, "segment_ids": seg}
    return {"segment_ids": seg}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masks", ["none", "causal_pad", "segments"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 77, 197, 257])
def test_attention_forward_edges(cuda_device, s, masks):
    """K3 / K4 (csrc/attention.cu) at every query- and key-tile edge of its
    64-row tiles and 128-row blocks, with each mask; stats on and off."""
    from dclip_tpu_torch.kernels import vit_attention as va

    b, d, heads = 3, 128, 2
    rng = np.random.RandomState(s)
    qkv = _bf16(rng, cuda_device, b, s, 3 * d)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    kw = _edge_masks(b, s, masks, cuda_device)
    o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
    o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
    _close_rel(o, o_ref, what="o")
    _close_rel(m, m_ref, what="m")
    torch.testing.assert_close(r, r_ref, rtol=2.0**-6, atol=0)
    torch.testing.assert_close(va.self_attention_fused(q, k, v, heads, **kw), o, rtol=0, atol=0)
    if masks == "causal_pad":  # the last batch row has no valid key
        assert torch.all(m[-1] == -1e30)
        _close_rel(o[-1], v[-1].float().mean(0, keepdim=True).expand(s, d), what="masked row")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masks", ["none", "causal_pad", "segments", "causal_segments"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 128, 197, 257, 320, 321])
def test_attention_backward_edges(cuda_device, s, masks):
    """K5 (csrc/attention_bwd.cu) at every edge of its 64-row tiles, its
    128-row blocks, its narrow last tile (<= 16 live columns: 1, 65, 197,
    257, 321) and its 4-slot ring (320, 321 refill a slot), with each mask,
    against the f32 twin run from the f32 statistics within 2^-5; two
    calls on the same inputs give the same bits."""
    from dclip_tpu_torch.kernels import vit_attention as va

    b, d, heads = 3, 128, 2
    rng = np.random.RandomState(1000 + s)
    qkv = _bf16(rng, cuda_device, b, s, 3 * d)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    g = _bf16(rng, cuda_device, b, s, d)
    kw = _edge_masks(b, s, masks, cuda_device)
    o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
    o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
    grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
    want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
    for name, got_t, want_t in zip(("dq", "dk", "dv"), grads, want):
        _close_rel(got_t, want_t, tol=2.0**-5, what=name)
    again = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
    for name, x1, x2 in zip(("dq", "dk", "dv"), grads, again):
        assert torch.equal(x1, x2), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("rows", [1, 7, 50435])
@pytest.mark.parametrize("d", [128, 512, 768, 1024, 1152])
def test_layernorm_kernels_edges(cuda_device, d, rows):
    """csrc/layernorm.cu's forward, frozen backward and weight-gradient
    backward against their twins at the exact widths (512, 768, 1024), the
    predicated ones (128; 1152, SigLIP's, five vectors a lane for half the
    lanes), and row counts that leave the last block of 8
    rows ragged; each call twice, the same bits."""
    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import trainable_ops as to

    rng = np.random.RandomState(d * 7 + rows)
    x = (_f32(rng, cuda_device, rows, d, base=0.5, scale=2.0)).bfloat16()
    g = _bf16(rng, cuda_device, rows, d)
    dh = _f32(rng, cuda_device, rows, d)
    scale = _f32(rng, cuda_device, d, base=1.0, scale=0.1)
    bias = _f32(rng, cuda_device, d, scale=0.1)
    calls = {
        "layernorm": (lambda: (vb.layernorm(x, scale, bias),),
                      lambda: (vb.layernorm_reference(x, scale, bias),)),
        "layernorm_bwd": (lambda: (mf.layernorm_bwd(x, g, dh, scale),),
                          lambda: (mf.layernorm_bwd_reference(x, g, dh, scale),)),
        "layernorm_bwd_wgrad": (lambda: to.layernorm_bwd_wgrad(x, g, dh, scale),
                                lambda: to.layernorm_bwd_wgrad_reference(x, g, dh, scale)),
    }
    for name, (kernel, twin) in calls.items():
        got, want = kernel(), twin()
        _close_rel(got[0], want[0], what=name)
        for what, a, w in zip(("dscale", "dbias"), got[1:], want[1:]):
            _close_sum(a, w, f"{name} {what}")
        for x1, x2 in zip(got, kernel()):
            assert torch.equal(x1, x2), name


@pytest.mark.requires_cuda
def test_gemm_runs_as_the_first_cuda_work_of_a_thread(cuda_device):
    """A host thread that has made no CUDA call yet (autograd's backward
    worker when K8's or K9's backward GEMM is its first work) launches the
    TMA GEMM: csrc/gemm.cu makes the context current before it encodes its
    tensor maps."""
    import threading

    rng = np.random.RandomState(11)
    a, w = _bf16(rng, cuda_device, 300, 512), _bf16(rng, cuda_device, 512, 256)
    want = vb.gemm_bias_act_residual_reference(a, w)
    out = []

    def run():
        try:
            out.append(vb.gemm_bias_act_residual(a, w))
        except RuntimeError as e:
            out.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(60)
    assert not t.is_alive() and len(out) == 1
    assert not isinstance(out[0], Exception), out[0]
    _close_bf16(out[0], want)


@pytest.mark.requires_cuda
def test_kernels_are_deterministic(cuda_device):
    """Two launches of each GEMM mode, of the attention forward and of K5 at
    head_dim 64 and 72 give the same bits (no atomics; fit / resume rely on
    it)."""
    from dclip_tpu_torch.kernels import trainable_ops as to
    from dclip_tpu_torch.kernels import vit_attention as va

    rng = np.random.RandomState(3)
    a, w = _bf16(rng, cuda_device, 1000, 768), _bf16(rng, cuda_device, 768, 2304)
    bias = torch.from_numpy(rng.standard_normal(2304).astype(np.float32)).to(cuda_device)
    y = _bf16(rng, cuda_device, 1000, 2304)
    q64, k64, v64 = y[..., :2304].reshape(8, 125, 2304).split(768, -1)
    g64 = _bf16(rng, cuda_device, 8, 125, 768)
    o64, m64, r64 = va.self_attention_fwd_stats(q64, k64, v64, 12, causal=True)
    q72, k72, v72 = _bf16(rng, cuda_device, 4, 300, 3 * 576).split(576, -1)
    g72 = _bf16(rng, cuda_device, 4, 300, 576)
    o72, m72, r72, lo72 = va.self_attention_fwd_stats(q72, k72, v72, 8, residual=True)
    calls = {
        "nn": lambda: vb.gemm_bias_act_residual(a, w, bias, gelu=True, save_preact=True),
        "nt": lambda: to.gemm_nt(a, w.t().contiguous(), bias, residual=y),
        "tn": lambda: to.gemm_tn(a, y),
        "attention": lambda: va.self_attention_fwd_stats(q64, k64, v64, 12, causal=True),
        "attention_bwd_64": lambda: va.self_attention_bwd_stats(
            q64, k64, v64, g64, o64, m64, r64, 12, causal=True),
        "attention_bwd_72": lambda: va.self_attention_bwd_stats(
            q72, k72, v72, g72, o72, m72, r72, 8, o_lo=lo72),
    }
    for name, call in calls.items():
        first, second = call(), call()
        first = first if isinstance(first, tuple) else (first,)
        second = second if isinstance(second, tuple) else (second,)
        for x1, x2 in zip(first, second):
            assert torch.equal(x1, x2), name


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


# Shapes that cross every edge of csrc/gemm.cu's tiles (128 rows; 256
# columns on the wide schedule, 128 on the narrow one) and its K steps of 64
# (TMA zero-fills past M, N and K and clips its stores): each (N, K) pair
# below with each M, on each schedule. N under one narrow tile (8, 24),
# ragged against 128 (136), a multiple of 128 but not of 256 (384), ragged
# against 256 (640) and whole wide tiles (3072); M ragged against 128 on
# both sides of a row block.
GEMM_M = (1, 63, 64, 65, 127, 129, 197, 12608)
GEMM_NK = ((8, 32), (24, 96), (136, 3072), (3072, 96), (384, 160), (640, 64))
GEMM_TILE_N = {"wide": 256, "narrow": 128}


@pytest.fixture(params=sorted(GEMM_TILE_N))
def gemm_schedule(request, monkeypatch):
    """Every NN / NT launch of the test on one schedule, whatever the shape
    rule (`vb.gemm_tile_n`) would choose for it."""
    tile_n = GEMM_TILE_N[request.param]
    monkeypatch.setattr(vb, "gemm_tile_n", lambda m, n, sms: tile_n)
    return request.param


def _gemm_epilogues_match(rng, device, m, n, k):
    """Each NN epilogue (quick-GELU with the pre-activation saved,
    quick-GELU', bias + residual, f32 out) against its twin; 4 launches."""
    a = _bf16(rng, device, m, k)
    w = _bf16(rng, device, k, n) * k**-0.5
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
    aux = _bf16(rng, device, m, n)
    res = _bf16(rng, device, m, n)
    got, pre = vb.gemm_bias_act_residual(a, w, bias, gelu=True, save_preact=True)
    want, want_pre = vb.gemm_bias_act_residual_reference(a, w, bias, gelu=True, save_preact=True)
    _close_rel(got, want, what="gelu")
    _close_rel(pre, want_pre, what="preact")
    _close_rel(vb.gemm_bias_act_residual(a, w, dgelu_of=aux),
               vb.gemm_bias_act_residual_reference(a, w, dgelu_of=aux), what="dgelu")
    _close_rel(vb.gemm_bias_act_residual(a, w, bias, residual=res),
               vb.gemm_bias_act_residual_reference(a, w, bias, residual=res), what="residual")
    f32 = vb.gemm_bias_act_residual(a, w, bias, residual=res, out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    _close_rel(f32, vb.gemm_bias_act_residual_reference(a, w, bias, residual=res,
                                                        out_dtype=torch.float32),
               what="f32 out")


def _gemm_nt_matches(rng, device, m, n, k):
    """The NT mode's epilogues against their twins; 3 launches."""
    from dclip_tpu_torch.kernels import trainable_ops as to

    a = _bf16(rng, device, m, k)
    w = (_f32(rng, device, n, k, scale=k**-0.5)).bfloat16()
    bias = _f32(rng, device, n, scale=0.1)
    res = _bf16(rng, device, m, n)
    got, pre = to.gemm_nt(a, w, bias, gelu=True, save_preact=True)
    want, want_pre = to.gemm_nt_reference(a, w, bias, gelu=True, save_preact=True)
    _close_rel(got, want, what="gelu")
    _close_rel(pre, want_pre, what="preact")
    _close_rel(to.gemm_nt(a, w, bias, residual=res),
               to.gemm_nt_reference(a, w, bias, residual=res), what="residual")
    f32 = to.gemm_nt(a, w, out_dtype=torch.float32)
    _close_rel(f32, to.gemm_nt_reference(a, w, out_dtype=torch.float32), what="f32 out")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("n,k", GEMM_NK)
@pytest.mark.parametrize("m", GEMM_M)
def test_gemm_epilogue_modes(cuda_device, gemm_schedule, m, n, k):
    vb.reset_launches()
    _gemm_epilogues_match(np.random.RandomState(11 + m + n + k), cuda_device, m, n, k)
    assert vb.GEMM_SCHEDULES[gemm_schedule] == 4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("edge", [-1, 0, 1], ids=["below", "at", "over"])
def test_gemm_wave_edges(cuda_device, gemm_schedule, edge):
    """Tile counts just below, at and just over two waves of the card's SMs
    (a persistent block an SM walks the tiles in turn), the last row block
    ragged: every NN epilogue and the NT mode."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n = GEMM_TILE_N[gemm_schedule]  # one column of tiles
    m = 128 * (2 * sms + edge) - 5
    rng = np.random.RandomState(17 + edge)
    vb.reset_launches()
    _gemm_epilogues_match(rng, cuda_device, m, n, 96)
    _gemm_nt_matches(rng, cuda_device, m, n, 96)
    assert vb.GEMM_SCHEDULES[gemm_schedule] == 7


@pytest.mark.requires_cuda
def test_gemm_schedules_wide_for_the_region_encode_narrow_for_bucket_1(cuda_device):
    """The shape rule, through the wrapper: fc2 + residual at the ViT-L/14
    region encode's rows (2,048 crops x 257 tokens) runs wide, and at the
    serving bucket of one image narrow."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(23)
    m, k, n = 2048 * 257, 1024, 1024

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=cuda_device, generator=gen) * scale).bfloat16()

    a, w, res = randn(m, k), randn(k, n, scale=k**-0.5), randn(m, n)
    bias = torch.randn(n, device=cuda_device, generator=gen)
    vb.reset_launches()
    big = vb.gemm_bias_act_residual(a, w, bias, residual=res)
    small = vb.gemm_bias_act_residual(a[:257], w, bias, residual=res[:257])
    assert vb.GEMM_SCHEDULES == {"wide": 1, "narrow": 1}
    for rows in (slice(0, 1024), slice(m - 1029, m)):
        _close_rel(big[rows], vb.gemm_bias_act_residual_reference(a[rows], w, bias,
                                                                  residual=res[rows]))
    _close_rel(small, vb.gemm_bias_act_residual_reference(a[:257], w, bias, residual=res[:257]))


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
                               "cross_attention": 1, "cross_attention_trainable": 0}
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


def _trainable_case(rng, device, b=4, t=77, p=8, d=512, heads=8):
    """Live f32 parameters (by `CrossModalAttention` names), bf16-valued f32
    inputs, the content-token and box masks with a boxless row."""
    sd = _teacher_sd(rng, d, device)
    params = {k[len("cross_modal_attention."):]: v.clone().requires_grad_()
              for k, v in sd.items()}
    text = _bf16(rng, device, b, t, d).float().requires_grad_()
    image = _bf16(rng, device, b, p, d).float().requires_grad_()
    tmask = torch.from_numpy((np.arange(t)[None] < rng.randint(2, t + 1, (b, 1)))
                             .astype(np.float32)).to(device)
    imask = torch.from_numpy((rng.rand(b, p) > 0.3).astype(np.float32)).to(device)
    imask[0] = 0.0
    return params, text, image, tmask, imask


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masks", ["both", "image", "none"])
def test_cross_attention_trainable_matches_twin(cuda_device, masks):
    """Forward: K10 (six launches, one count of the trainable form) against
    the f32 twin on the same live weights. Gradients: the same f32
    recompute on both sides, so they agree to f32 sums (1e-4 relative);
    this holds the saved inputs and the mask completion."""
    from dclip_tpu_torch.kernels import cross_attention as xa

    rng = np.random.RandomState(21)
    params, text, image, tmask, imask = _trainable_case(rng, cuda_device)
    kw = {"both": (tmask, imask), "image": (None, imask), "none": (None, None)}[masks]
    g = (torch.randn_like(text), torch.randn_like(image))
    xa.reset_launches()
    out = xa.cross_attention_trainable(params, text, image, *kw, num_heads=8)
    torch.cuda.synchronize()
    assert xa.LAUNCHES == {"cross_attention_core": 1, "add_layernorm_f32": 1,
                           "cross_attention": 1, "cross_attention_trainable": 1}
    names = list(params)
    grads = torch.autograd.grad(out, [text, image] + [params[n] for n in names], g)

    cpu = {n: v.detach().cpu().requires_grad_() for n, v in params.items()}
    ct, ci = (x.detach().cpu().requires_grad_() for x in (text, image))
    ckw = tuple(None if m is None else m.cpu() for m in kw)
    want = xa.cross_attention_trainable(cpu, ct, ci, *ckw, num_heads=8)
    want_grads = torch.autograd.grad(want, [ct, ci] + [cpu[n] for n in names],
                                     tuple(x.cpu() for x in g))
    for name, a, w in zip(("text", "image"), out, want):
        assert a.dtype == torch.float32
        _close_rel(a, w.to(cuda_device), what=name)
    for name, a, w in zip(["text", "image"] + names, grads, want_grads):
        _close_rel(a, w.to(cuda_device), tol=1e-4, what=f"grad {name}")


@pytest.mark.requires_cuda
def test_cross_attention_trainable_reads_updated_weights(cuda_device):
    """Two Adam steps: after the first, the forward (K10 on a fresh pack)
    equals the twin on the updated weights; a pack made once would not."""
    from dclip_tpu_torch.kernels import cross_attention as xa
    from dclip_tpu_torch.train.optim import make_optimizer

    rng = np.random.RandomState(22)
    params, text, image, tmask, imask = _trainable_case(rng, cuda_device)
    stale = xa.pack_cross_attention(params, torch.bfloat16, prefix="")
    opt = make_optimizer(list(params.values()), 1e-2, kind="adam")
    for step in range(2):
        for v in params.values():
            v.grad = None
        at, ai = xa.cross_attention_trainable(params, text.detach(), image.detach(), tmask,
                                              imask, num_heads=8)
        w32 = xa.pack_cross_attention(params, torch.float32, prefix="")
        want = xa.cross_attention_reference(w32, text.detach(), image.detach(), tmask, imask, 8)
        for name, a, w in zip(("text", "image"), (at, ai), want):
            _close_rel(a, w, what=f"step {step} {name}")
        if step == 1:
            old = xa.cross_attention_fused(stale, text.detach(), image.detach(), tmask, imask, 8)
            torch.cuda.synchronize()
            stale_err = (old[0] - want[0]).abs().max().item()
            assert stale_err > REL_TOL * max(1.0, want[0].abs().max().item()), stale_err
        (at.square().mean() + ai.square().mean()).backward()
        opt.step()


@pytest.mark.requires_cuda
def test_f32_service_takes_the_module_route(cuda_device):
    """An f32 ViT-B/16 `ClipService` on the card serves through the module
    path (the bf16-only block kernels stay out) and equals it."""
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.weights import random_state_dict
    from dclip_tpu_torch.ops.image_ops import normalize
    from dclip_tpu_torch.serve import ClipService

    cfg = CLIPConfig.vit_b_16()
    model = CLIPModule(cfg, dtype=torch.float32, device="meta")
    model.load_state_dict(random_state_dict(cfg, 0), assign=True)
    svc = ClipService(model, cfg, buckets=(1, 4), device=cuda_device)
    assert svc.image_route == "module"
    u8 = np.random.RandomState(5).randint(0, 256, (3, 224, 224, 3), np.uint8)
    vb.reset_launches()
    got = svc.encode_images(list(u8))
    assert set(vb.LAUNCHES.values()) == {0}
    with torch.no_grad():
        px = normalize(torch.from_numpy(u8).to(cuda_device).float() / 255.0)
        want = svc.model.image_features(px)
    want = (want / want.norm(dim=-1, keepdim=True)).cpu().numpy()
    assert got.shape == (3, 512) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


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
@pytest.mark.parametrize("m,k,n", [(4928, 512, 2048), (591, 768, 2304), (70, 256, 136)]
                         + [(m, k, n) for m in GEMM_M for n, k in GEMM_NK])
def test_gemm_nt_matches_twin(cuda_device, gemm_schedule, m, k, n):
    from dclip_tpu_torch.kernels import trainable_ops as to

    to.reset_launches()
    _gemm_nt_matches(np.random.RandomState(m + n), cuda_device, m, n, k)
    assert to.LAUNCHES["gemm_nt"] == 3


@pytest.mark.requires_cuda
@pytest.mark.parametrize("splits", ["one", "several"])
@pytest.mark.parametrize("rows,p,q", [(4928, 2048, 512), (6304, 768, 768), (1576, 2304, 768),
                                      (37, 24, 136), (197, 136, 24), (197, 3072, 768),
                                      (50432, 768, 2304), (50432, 8, 8)])
def test_gemm_tn_and_colsum_match_twins(cuda_device, monkeypatch, rows, p, q, splits):
    """TN over ragged row counts (K of the product), with the rows in one
    split or split over blocks and summed in order by csrc/reduce.cu."""
    from dclip_tpu_torch.kernels import trainable_ops as to

    if splits == "one":
        monkeypatch.setattr(to, "_blocks_wanted", lambda t: 1)
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


# -- K12: the streamed top-k ------------------------------------------------------
#
# Scores within 1e-5 * max(1, |twin|) (f32 sums in another order than the
# twin's matmul); indices equal wherever the twin's neighbouring scores
# differ by more than that; exact ties (duplicated rows score bit for bit
# alike in the kernel) go to the lower row.

TOPK_TOL = 1e-5


def _hold_topk(got, queries, store, k):
    from dclip_tpu_torch.kernels import topk as tk

    gs, gi = got
    ws, wi = tk.topk_streamed_reference(queries, store, k + 1)  # one more: the last gap
    torch.cuda.synchronize()
    k = min(k, store.shape[0])
    assert gs.shape == (queries.shape[0], k) and gs.dtype == torch.float32
    assert gi.shape == gs.shape and gi.dtype == torch.int32
    tol = TOPK_TOL * ws.abs().clamp_min(1.0)
    assert ((gs - ws[:, :k]).abs() <= tol[:, :k]).all()
    gaps = ws[:, :-1] - ws[:, 1:]
    inf = torch.full_like(ws[:, :1], float("inf"))
    before = torch.cat([inf, gaps], 1)[:, :k]
    after = torch.cat([gaps, inf], 1)[:, :k]
    apart = (before > tol[:, :k]) & (after > tol[:, :k])
    assert torch.equal(gi[apart], wi[:, :k][apart])
    tied = gs[:, 1:] == gs[:, :-1]
    assert (gi[:, 1:][tied] > gi[:, :-1][tied]).all()
    assert ((gi >= 0) & (gi < store.shape[0])).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nq,n,d,k", [(7, 1000, 36, 5), (3, 130, 30, 3), (64, 1_000_000, 512, 10),
                                      (130, 5000, 512, 64), (5, 3, 16, 5), (20, 5000, 64, 100),
                                      (9, 3000, 32, 200)],
                         ids=["small", "d_pad", "serving_1m", "k64", "k_over_n", "k100_two_rounds",
                              "k200_four_rounds"])
def test_topk_streamed_matches_twin(cuda_device, nq, n, d, k):
    from dclip_tpu_torch.kernels import topk as tk

    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    q = torch.randn((nq, d), generator=gen, device=cuda_device)
    s = torch.randn((n, d), generator=gen, device=cuda_device)
    q, s = q / q.norm(dim=-1, keepdim=True), s / s.norm(dim=-1, keepdim=True)
    tk.reset_launches()
    got = tk.topk_streamed(q, s, k)
    assert tk.LAUNCHES == {"topk_streamed": 1}
    _hold_topk(got, q, s, k)
    again = tk.topk_streamed(q, s, k)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])  # deterministic


@pytest.mark.requires_cuda
def test_topk_streamed_ties_and_negative_scores(cuda_device):
    """Duplicated rows tie exactly and go to the lower row; all-negative
    scores still beat rows past N (the TPU kernel's padding case)."""
    from dclip_tpu_torch.kernels import topk as tk

    rng = np.random.RandomState(11)
    base = rng.standard_normal((300, 64)).astype(np.float32)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    store = np.concatenate([base, base[:40], base[:40]])  # rows r, r + 300, r + 340 equal
    s = torch.from_numpy(store).to(cuda_device)
    q = torch.from_numpy(base[:40]).to(cuda_device)
    got_s, got_i = tk.topk_streamed(q, s, 4)
    _hold_topk((got_s, got_i), q, s, 4)
    r = torch.arange(40, device=cuda_device, dtype=torch.int32)
    assert torch.equal(got_i[:, :3], torch.stack([r, r + 300, r + 340], 1))
    assert (got_s[:, 0] == got_s[:, 1]).all() and (got_s[:, 1] == got_s[:, 2]).all()

    neg_q = -torch.from_numpy(np.abs(rng.standard_normal((4, 16))).astype(np.float32))
    pos_s = torch.from_numpy(np.abs(rng.standard_normal((130, 16))).astype(np.float32))
    got = tk.topk_streamed(neg_q.to(cuda_device), pos_s.to(cuda_device), 3)
    assert (got[0] < 0).all()
    _hold_topk(got, neg_q.to(cuda_device), pos_s.to(cuda_device), 3)

    # One tie across round bounds (k > 64): 200 equal rows rank in row order.
    same = torch.from_numpy(np.repeat(base[:1], 200, 0)).to(cuda_device)
    got_s, got_i = tk.topk_streamed(q[:3], same, 150)
    assert torch.equal(got_i, torch.arange(150, device=cuda_device, dtype=torch.int32)
                       .expand(3, 150))
    assert (got_s == got_s[:, :1]).all()


@pytest.mark.requires_cuda
def test_topk_streamed_tf32_trap(cuda_device):
    """Entries with mantissa bits below TF32's on both sides: one TF32
    product, or a 3xTF32 sum without either cross term, errs by >= 1e-4
    here (tests/test_torch_topk.py shows it); the kernel stays within 1e-5."""
    from dclip_tpu_torch.kernels import topk as tk
    from topk_cases import tf32_trap

    q, s = (torch.from_numpy(a).to(cuda_device) for a in tf32_trap())
    got = tk.topk_streamed(q, s, 20)
    _hold_topk(got, q, s, 20)
    exact = (q.double() @ s.double().T).topk(20, dim=-1).values
    assert (got[0].double() - exact).abs().max().item() <= TOPK_TOL


@pytest.mark.requires_cuda
def test_topk_streamed_near_ties(cuda_device):
    """Scores 2-5x the tolerance apart: the kernel ranks them as the twin,
    index for index."""
    from dclip_tpu_torch.kernels import topk as tk
    from topk_cases import near_ties

    q, s = (torch.from_numpy(a).to(cuda_device) for a in near_ties())
    got = tk.topk_streamed(q, s, 16)
    _hold_topk(got, q, s, 16)
    assert torch.equal(got[1], tk.topk_streamed_reference(q, s, 16)[1])


@pytest.mark.requires_cuda
@pytest.mark.parametrize("nq,n,d,k", [(5, 1037, 8, 7), (70, 4099, 16, 10), (3, 1153, 30, 5),
                                      (65, 20_001, 512, 12)],
                         ids=["d8", "d16", "d30_padded", "d512"])
def test_topk_streamed_ragged_n(cuda_device, nq, n, d, k):
    """N a multiple neither of the 128-row tile nor of the TMA box, at
    D = 8 (one k8 step), 16, 30 (padded to 32) and 512."""
    from dclip_tpu_torch.kernels import topk as tk

    gen = torch.Generator(device=cuda_device).manual_seed(n + d)
    q = torch.randn((nq, d), generator=gen, device=cuda_device)
    s = torch.randn((n, d), generator=gen, device=cuda_device)
    got = tk.topk_streamed(q, s, k)
    _hold_topk(got, q, s, k)
    assert int(got[1].max()) < n


@pytest.mark.requires_cuda
@pytest.mark.parametrize("k", [10, 100])
def test_topk_streamed_chunk_plans_agree_bitwise(cuda_device, monkeypatch, k):
    """Two different chunk plans (how many store chunks the grid holds)
    give the same scores and indices, bit for bit, in one round and in two."""
    from dclip_tpu_torch.kernels import topk as tk

    gen = torch.Generator(device=cuda_device).manual_seed(k)
    q = torch.randn((70, 512), generator=gen, device=cuda_device)
    s = torch.randn((50_000, 512), generator=gen, device=cuda_device)
    plans, results = [], []
    for slots in (2, 4000):
        monkeypatch.setattr(tk, "_slots", lambda device_index, kr, slots=slots: slots)
        plans.append(tk.chunk_plan(70, 50_000, min(k, tk.ROUND_K), slots))
        results.append(tk.topk_streamed(q, s, k))
    assert plans[0] != plans[1]
    assert torch.equal(results[0][0], results[1][0]) and torch.equal(results[0][1], results[1][1])
    _hold_topk(results[0], q, s, k)


@pytest.mark.requires_cuda
def test_knn_search_launches_k12(cuda_device):
    """The search and the k-NN gate on CUDA tensors go through K12, once
    per call, and agree with their CPU results."""
    from dclip_tpu_torch.kernels import topk as tk
    from dclip_tpu_torch.ops import knn

    rng = np.random.RandomState(12)
    keys = rng.standard_normal((500, 32)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    keys[250] = keys[3]  # a tie at the top for query 0
    queries = np.concatenate([keys[3:4] + 1e-3, rng.standard_normal((6, 32))]).astype(np.float32)
    tk.reset_launches()
    s, i = knn.knn_search(torch.from_numpy(queries).to(cuda_device),
                          torch.from_numpy(keys).to(cuda_device), 5)
    gate = knn.knn_or_projection(torch.from_numpy(queries).to(cuda_device), None,
                                 torch.from_numpy(keys).to(cuda_device),
                                 torch.from_numpy(-keys).to(cuda_device), None, 0.85)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {"topk_streamed": 2}
    cs, ci = knn.knn_search(torch.from_numpy(queries), torch.from_numpy(keys), 5)
    assert torch.equal(i.cpu(), ci) and i[0, 0].item() == 3 and i[0, 1].item() == 250
    torch.testing.assert_close(s.cpu(), cs, rtol=0, atol=TOPK_TOL)
    cgate = knn.knn_or_projection(torch.from_numpy(queries), None, torch.from_numpy(keys),
                                  torch.from_numpy(-keys), None, 0.85)
    assert torch.equal(gate.source.cpu(), cgate.source)
    torch.testing.assert_close(gate.embeddings.cpu(), cgate.embeddings, rtol=0, atol=TOPK_TOL)


# -- K10's core and K11 at the edges of their lane groups, blocks and tiles ------

# (T, P, head_dim, heads): every count in {1, 7, 8, 9, 31, 32, 33, 64, 77,
# 127, 128} on each side, which crosses each softmax lane-group width (1 to
# 32 lanes a row, up to four keys a lane), odd and even counts of the 2 x 2
# logit tiles and two-query output tiles, and the chunking of queries whose
# probabilities exceed 16 KB (127 queries x 33 keys and up), with each
# head_dim the kernel is built for (32, 64, 96, 128).
CORE_EDGES = [(1, 128, 32, 2), (7, 77, 64, 2), (8, 33, 96, 2), (9, 64, 128, 1),
              (31, 32, 32, 4), (32, 31, 64, 2), (33, 9, 96, 1), (64, 8, 128, 2),
              (77, 7, 64, 8), (127, 1, 32, 2), (128, 128, 128, 2), (77, 8, 64, 8),
              (33, 127, 64, 4)]


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masks", ["masked", "none"])
@pytest.mark.parametrize("t,p,hd,heads", CORE_EDGES)
def test_cross_attention_core_edges(cuda_device, t, p, hd, heads, masks):
    """K10's core against its twin; with masks, batch row 0 has no valid
    box and row 1 no valid token, so every query of that row averages the
    other stream's values uniformly."""
    from dclip_tpu_torch.kernels import cross_attention as xa

    rng = np.random.RandomState(1000 * t + p + hd)
    b, d = 3, hd * heads
    qkv_t = torch.from_numpy(rng.standard_normal((b, t, 3 * d)).astype(np.float32)).to(cuda_device)
    qkv_i = torch.from_numpy(rng.standard_normal((b, p, 3 * d)).astype(np.float32)).to(cuda_device)
    tmask = imask = None
    if masks == "masked":
        tmask = torch.from_numpy((rng.rand(b, t) > 0.3).astype(np.float32)).to(cuda_device)
        imask = torch.from_numpy((rng.rand(b, p) > 0.3).astype(np.float32)).to(cuda_device)
        imask[0] = 0.0
        tmask[1] = 0.0
    xa.reset_launches()
    out_t, out_i = xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, heads)
    assert xa.LAUNCHES["cross_attention_core"] == 1
    assert out_t.dtype == out_i.dtype == torch.bfloat16
    want_t, want_i = xa.cross_attention_core_reference(qkv_t, qkv_i, tmask, imask, heads)
    _close_rel(out_t, want_t, what="text queries")
    _close_rel(out_i, want_i, what="image queries")
    if masks == "masked":
        _close_rel(out_t[0], qkv_i[0, :, 2 * d:].mean(0).expand(t, d), what="boxless row")
        _close_rel(out_i[1], qkv_t[1, :, 2 * d:].mean(0).expand(p, d), what="tokenless row")
    again = xa.cross_attention_core(qkv_t, qkv_i, tmask, imask, heads)
    assert torch.equal(again[0], out_t) and torch.equal(again[1], out_i)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("d", [8, 64, 512, 1024])
@pytest.mark.parametrize("b", [1, 5, 31, 32, 33, 63, 64, 65, 256, 257, 4096])
def test_distill_loss_tile_edges(cuda_device, b, d):
    """K11 at batch sizes on each side of its 32-row tiles and 8-row
    gradient blocks, and up to 4,096 rows (128 x 128 tiles, one merge
    block): parts within 1e-5 x max(1, |twin|) (lc is 0 at B = 1),
    gradients within one bf16 ulp of the largest, two calls bit-identical."""
    from dclip_tpu_torch.kernels import distill_loss as dl

    rng = np.random.RandomState(b * 7 + d)
    si, st = _bf16(rng, cuda_device, b, d), _bf16(rng, cuda_device, b, d)
    ti, tt = (x.float() + 0.5 * torch.from_numpy(
        rng.standard_normal((b, d)).astype(np.float32)).to(cuda_device) for x in (si, st))
    dl.reset_launches()
    parts = dl.distill_loss_fwd(si, st, ti, tt, 0.05, 0.7)
    want = dl.distill_loss_fwd_reference(si, st, ti, tt, 0.05, 0.7)
    torch.cuda.synchronize()
    err = (parts - want).abs()
    assert (err <= 1e-5 * want.abs().clamp(min=1.0)).all(), (parts.tolist(), want.tolist())
    cts = torch.tensor([0.7, 1.3, 0.9], device=cuda_device)
    grads = dl.distill_loss_bwd(si, st, ti, tt, cts, 0.05)
    for got, ref in zip(grads, dl.distill_loss_bwd_reference(si, st, ti, tt, cts, 0.05)):
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
        e = (got.float() - ref.float()).abs().max().item()
        assert e <= 2.0**-7 * ref.float().abs().max().item(), e
    assert torch.equal(dl.distill_loss_fwd(si, st, ti, tt, 0.05, 0.7), parts)
    again = dl.distill_loss_bwd(si, st, ti, tt, cts, 0.05)
    assert torch.equal(again[0], grads[0]) and torch.equal(again[1], grads[1])
    assert dl.LAUNCHES == {"distill_loss_fwd": 2, "distill_loss_bwd": 2}


@pytest.mark.requires_cuda
def test_distill_loss_graph_replays_beside_eager_calls(cuda_device):
    """K11 captured into a CUDA graph and replayed on another stream while
    eager calls on other inputs run on the capture stream: the graph has
    tickets and scratch of its own, so both give the bits of a lone call."""
    from dclip_tpu_torch.kernels import distill_loss as dl

    rng = np.random.RandomState(11)
    b, d = 257, 512

    def inputs():
        si, st = _bf16(rng, cuda_device, b, d), _bf16(rng, cuda_device, b, d)
        return si, st, si.float() + 0.5, st.float() - 0.5

    cts = torch.tensor([0.7, 1.3, 0.9], device=cuda_device)

    def call(x):
        return (dl.distill_loss_fwd(*x), *dl.distill_loss_bwd(*x, cts))

    graphed, eager = inputs(), inputs()
    want_graphed, want_eager = call(graphed), call(eager)
    capture, other = torch.cuda.Stream(), torch.cuda.Stream()
    capture.wait_stream(torch.cuda.current_stream())
    other.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(capture):
        call(graphed)  # the capture stream's own tickets exist before the capture
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=capture):
            got_graphed = call(graphed)
    torch.cuda.synchronize()
    for _ in range(10):
        for _ in range(3):
            with torch.cuda.stream(other):
                graph.replay()
            with torch.cuda.stream(capture):
                got_eager = call(eager)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got_graphed, want_graphed))
        assert all(torch.equal(g, w) for g, w in zip(got_eager, want_eager))


# -- the serving deployment path: int8, the exported artifact, the device index --


def _tiny_clip(device, dtype=torch.float32, seed=0):
    from dclip_tpu_torch.core import CLIPConfig
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.weights import random_state_dict

    cfg = CLIPConfig.tiny_test()
    model = CLIPModule(cfg, dtype=dtype, device="meta")
    model.load_state_dict(random_state_dict(cfg, seed), assign=True)
    return cfg, model.to(device).eval()


def _text_inputs(cfg, n, seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, cfg.text.eos_token_id - 2, (n, cfg.text.max_length)).astype(np.int32)
    mask = np.ones_like(ids)
    ids[0, 5] = cfg.text.eos_token_id
    ids[0, 6:], mask[0, 6:] = 0, 0
    return ids, mask


def _cosines(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.requires_cuda
def test_int8_service_launches_no_block_kernel(cuda_device):
    """`ClipService(quantize="int8")` on the card serves both towers from
    the int8 tree (bf16 compute): no K1 / K2 launch, unit-norm embeddings
    within cosine 0.99 of the f32 module route on the same weights."""
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.ops.image_ops import normalize
    from dclip_tpu_torch.serve import ClipService

    cfg, model = _tiny_clip(cuda_device)
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    svc = ClipService(model, cfg, tokenizer=tok, buckets=(1, 4), device=cuda_device,
                      quantize="int8")
    assert svc.params["vision_model"]["patch_embedding"]["q"].device.type == "cuda"
    u8 = np.random.RandomState(8).randint(0, 256, (5,) + (cfg.vision.image_size,) * 2 + (3,),
                                          np.uint8)
    texts = ["a dog", "two cats", "a red car", "x", "y z"]
    vb.reset_launches()
    images, txt = svc.encode_images(list(u8)), svc.encode_texts(texts)
    torch.cuda.synchronize()
    assert set(vb.LAUNCHES.values()) == {0}
    ids, mask = tok.encode_batch(texts, max_length=cfg.text.max_length)
    with torch.no_grad():
        want_i = model.image_features(normalize(
            torch.from_numpy(u8).to(cuda_device).float() / 255.0)).cpu().numpy()
        want_t = model.get_text_features(torch.from_numpy(ids).to(cuda_device),
                                         torch.from_numpy(mask).to(cuda_device)).cpu().numpy()
    for got, want in ((images, want_i), (txt, want_t)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
        assert _cosines(got, want).min() >= 0.99


@pytest.mark.requires_cuda
@pytest.mark.parametrize("quantize", [None, "int8"])
def test_export_round_trip_on_the_card(cuda_device, tmp_path, quantize):
    """`export_encoders(platforms=("cuda",))` and `load_exported(device=
    "cuda")`: the programs carry no weights and give the live service's
    embeddings (the f32 module route within 1e-5; int8 within 1e-3, the
    same bf16 forward), across bucket chunks."""
    from dclip_tpu_torch.serve import ClipService
    from dclip_tpu_torch.serve.export import export_encoders, load_exported

    cfg, model = _tiny_clip(cuda_device)
    written = export_encoders(model, cfg, str(tmp_path), batch_sizes=(1, 4),
                              platforms=("cuda",), quantize=quantize)
    assert set(written) == {"params.npz"} | {f"{m}_b{b}.cuda.pt2" for m in ("text", "image")
                                             for b in (1, 4)}
    ep = torch.export.load(str(tmp_path / "text_b4.cuda.pt2"))
    assert len(ep.state_dict) == 0 and len(ep.constants) == 0
    loaded = load_exported(str(tmp_path), device="cuda")
    svc = ClipService(model, cfg, buckets=(1, 4), device=cuda_device, quantize=quantize)
    assert svc.image_route in ("module", "int8")
    ids, mask = _text_inputs(cfg, 5, seed=9)
    px = np.random.RandomState(9).standard_normal(
        (5, cfg.vision.image_size, cfg.vision.image_size, 3)).astype(np.float32)
    atol = 1e-5 if quantize is None else 1e-3
    np.testing.assert_allclose(loaded.encode_texts_ids(ids, mask),
                               svc._text_batch(ids, mask), rtol=0, atol=atol)
    with torch.inference_mode():
        want = svc._maybe_normalize(svc._image_fn(torch.from_numpy(px).to(cuda_device)))
    np.testing.assert_allclose(loaded.encode_images(px), want.cpu().numpy(), rtol=0, atol=atol)


@pytest.mark.requires_cuda
def test_export_for_cpu_and_cuda_loads_on_both(cuda_device, tmp_path):
    """One artifact traced for both platforms loads on each device, and the
    two agree; a bf16 model (the kernels' route on the card) is refused."""
    from dclip_tpu_torch.serve.export import export_encoders, load_exported

    cfg, model = _tiny_clip(cuda_device)
    export_encoders(model, cfg, str(tmp_path), batch_sizes=(2,), platforms=("cpu", "cuda"))
    on_cpu, on_cuda = (load_exported(str(tmp_path), device=d) for d in ("cpu", "cuda"))
    assert on_cuda.manifest["platforms"] == ["cpu", "cuda"]
    ids, mask = _text_inputs(cfg, 3, seed=10)
    np.testing.assert_allclose(on_cuda.encode_texts_ids(ids, mask),
                               on_cpu.encode_texts_ids(ids, mask), rtol=0, atol=1e-5)
    _, bf16 = _tiny_clip(cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kernels"):
        export_encoders(bf16, cfg, str(tmp_path / "bf16"), platforms=("cuda",))


@pytest.mark.requires_cuda
def test_device_resident_search_is_bit_equal(cuda_device):
    """The service's device-resident index gives the per-call path's results
    bit for bit (K12 over `torch.as_tensor(store.keys)` on the card), one
    K12 launch per search, and sees each add."""
    from dclip_tpu_torch.kernels import topk as tk
    from dclip_tpu_torch.ops.knn import knn_search
    from dclip_tpu_torch.serve import ClipService

    cfg, model = _tiny_clip(cuda_device)
    svc = ClipService(model, cfg, buckets=(1,), index_dim=64, device=cuda_device)
    rng = np.random.RandomState(11)
    rows = rng.standard_normal((3000, 64)).astype(np.float32)
    queries = rng.standard_normal((9, 64)).astype(np.float32)
    for lo, hi in ((0, 2000), (2000, 3000)):
        svc.add_to_index([f"r{i}" for i in range(lo, hi)], rows[lo:hi])
        tk.reset_launches()
        first, again = svc.search(queries, k=7), svc.search(queries, k=7)
        torch.cuda.synchronize()
        assert tk.LAUNCHES["topk_streamed"] == 2 and first == again
        assert svc._index_keys.device.type == "cuda"
        s, i = knn_search(torch.from_numpy(queries).to(cuda_device),
                          torch.as_tensor(svc._index.keys, device=cuda_device), 7)
        assert [[h[0] for h in row] for row in first] == [
            [f"r{j}" for j in row] for row in i.cpu().numpy()]
        assert np.array_equal(np.asarray([[h[1] for h in row] for row in first], np.float32),
                              s.cpu().numpy())


# -- the detector: its f32 pin, and NMS on the card against the CPU -----------------


def _detector_pair(cuda_device, width=16, size=128):
    """The same random detector on the card and on the CPU, and images."""
    from dclip_tpu_torch.models import detector as det

    cfg = det.DetectorConfig(width=width, image_size=size)
    sd = det.random_detector_state_dict(cfg, seed=0)
    images = np.random.RandomState(0).rand(2, size, size, 3).astype(np.float32)
    return cfg, det.Detector(cfg, sd, cuda_device), det.Detector(cfg, sd, "cpu"), images


@pytest.mark.requires_cuda
def test_detector_pins_f32_convolutions(cuda_device):
    """With TF32 on process-wide, the detector's convolutions still run in
    f32: its logits stay within 1e-4 (relative to the largest) of the CPU's,
    ten times closer than the same forward with TF32 allowed, and the flag
    is on again afterwards."""
    _, gpu, cpu, images = _detector_pair(cuda_device)
    want = cpu.logits(images)
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        pinned = gpu.logits(images)
        assert torch.backends.cudnn.allow_tf32 is True
        with torch.inference_mode():
            tf32 = gpu.model(torch.from_numpy(images).to(cuda_device))
    finally:
        torch.backends.cudnn.allow_tf32 = prev

    def rel_err(outs):
        return max((g.cpu() - w).abs().max().item() / w.abs().max().item()
                   for pair, ref in zip(outs, want) for g, w in zip(pair, ref))

    assert rel_err(pinned) <= 1e-4, rel_err(pinned)
    assert rel_err(tf32) >= 10 * rel_err(pinned), (rel_err(tf32), rel_err(pinned))


@pytest.mark.requires_cuda
def test_nms_and_postprocess_on_the_card_equal_the_cpu(cuda_device):
    """Batched class-aware NMS, and postprocess of identical decoded
    candidates: indices, classes, masks, boxes and scores bit-equal."""
    from dclip_tpu_torch.models import detector as det
    from dclip_tpu_torch.ops import nms

    rng = np.random.RandomState(3)
    boxes = rng.rand(4, 256, 4).astype(np.float32) * 100
    boxes[..., 2:] += boxes[..., :2] + 1
    boxes[:, 50:60] = boxes[:, 40:50] + 0.5  # near-duplicates
    scores = rng.rand(4, 256).astype(np.float32)
    scores[:, 100:110] = 0.9  # ties
    classes = rng.randint(0, 5, size=(4, 256))
    want = nms.batched_class_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                 torch.from_numpy(classes), 0.45, 0.25, 32, 612.0)
    got = nms.batched_class_nms(*(torch.from_numpy(a).to(cuda_device)
                                  for a in (boxes, scores, classes)), 0.45, 0.25, 32, 612.0)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    cfg, gpu, cpu, images = _detector_pair(cuda_device)
    with torch.inference_mode():
        cand = det.decode_predictions(cfg, cpu.logits(images))
        want = det.postprocess(cfg, *cand)
        got = det.postprocess(cfg, *(t.to(cuda_device) for t in cand))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert want.mask.sum() > 0


# -- the ViT-L/14 slice: remat on the card, K10 and K11 at the L/14 widths -------------


def _remat_trainer(device, remat, flags):
    """A DistillTrainer on the card at a small config the kernels take
    (head_dim 64 in both towers, 32 in the meta-teacher), its batch's
    targets in the cache, two-step-ready."""
    from dclip_tpu_torch.cli.common import synthetic_distill_batch
    from dclip_tpu_torch.core import CLIPConfig, DistillConfig, TeacherConfig
    from dclip_tpu_torch.core.config import CLIPTextConfig, CLIPVisionConfig
    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig(
        text=CLIPTextConfig(vocab_size=1000, hidden_size=128, num_layers=2, num_heads=2,
                            mlp_dim=512, max_length=16, eos_token_id=999),
        vision=CLIPVisionConfig(image_size=64, patch_size=16, hidden_size=128, num_layers=2,
                                num_heads=2, mlp_dim=512),
        projection_dim=64)
    tcfg = TeacherConfig(embed_dim=64, num_heads=2, max_patches=3, max_text_tokens=16)
    dcfg = DistillConfig(train_batch_size=8, accumulate_grad_batches=1, learning_rate=1e-3,
                         teacher=tcfg, packed_text=True, remat=remat, **flags)
    sd = random_state_dict(cfg, 0)
    batch = synthetic_distill_batch(cfg, tcfg, 8, np.random.RandomState(0))
    batch["index"] = np.arange(8, dtype=np.int64)
    cache = TeacherTargetCache(salt="remat")
    tr = DistillTrainer(dcfg, sd, sd, random_teacher_state_dict(tcfg, 0), cfg, cfg,
                        device=device, teacher_cache=cache)
    targets = np.random.RandomState(1).standard_normal((8, 2, 64)).astype(np.float32)
    cache.put_batch(cache.keys_for(batch), targets / np.linalg.norm(targets, axis=-1,
                                                                    keepdims=True))
    return tr, batch


@pytest.mark.requires_cuda
@pytest.mark.parametrize("flags", [{}, {"fused_text_mlp": True, "fused_attn_block": True}],
                         ids=["default", "fused"])
def test_remat_is_bit_equal_on_the_card(cuda_device, monkeypatch, flags):
    """Two bf16 steps with remat on and off: parameters bit-equal (no kernel
    sums with atomics); every forward kernel of a student layer launches
    twice a step under remat and every backward kernel once; K8 / K9's
    weights are cast once a layer a step either way."""
    from dclip_tpu_torch.kernels import (
        attn_block_trainable,
        mlp_frozen,
        mlp_trainable,
        vit_attention,
    )

    packs = {"n": 0}
    for mod, name in ((attn_block_trainable, "pack_trainable_attn"),
                      (mlp_trainable, "pack_trainable_mlp")):
        real = getattr(mod, name)

        def counted(*a, _real=real, **k):
            packs["n"] += 1
            return _real(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    runs = {}
    for remat in (False, True):
        tr, batch = _remat_trainer(cuda_device, remat, flags)
        packs["n"] = 0
        for mod in (vit_attention, mlp_frozen, mlp_trainable, attn_block_trainable):
            mod.reset_launches()
        for _ in range(2):
            tr.train_step_on_batch(batch)
        torch.cuda.synchronize()
        launches = {**vit_attention.LAUNCHES, **mlp_frozen.LAUNCHES, **mlp_trainable.LAUNCHES,
                    **attn_block_trainable.LAUNCHES}
        runs[remat] = ({n: p.detach().clone() for n, p in tr.student.named_parameters()},
                       launches, packs["n"])
    (p0, l0, n0), (p1, l1, n1) = runs[False], runs[True]
    for name, p in p0.items():
        assert torch.equal(p, p1[name]), name
    fwd = ("self_attention_fwd_stats", "mlp_frozen_fwd", "mlp_trainable_fwd",
           "attn_block_trainable_fwd")
    for name, n in l0.items():
        assert l1[name] == (2 * n if name in fwd else n), (name, n, l1[name])
    assert l0["self_attention_fwd_stats"] > 0 and l0["self_attention_bwd_stats"] > 0
    assert n1 == n0 == (2 * 4 if flags else 0)


@pytest.mark.requires_cuda
def test_k10_at_head_dim_96_and_k11_at_768(cuda_device):
    """The L/14 run's widths: K10 at D=768 with 8 heads of 96 (B=32, 77
    tokens, 8 boxes, masks), K11 at D=768, B=256, against their twins."""
    from dclip_tpu_torch.kernels import cross_attention as xa
    from dclip_tpu_torch.kernels import distill_loss as dl

    rng = np.random.RandomState(768)
    b, t, p, d, heads = 32, 77, 8, 768, 8
    w = xa.pack_cross_attention(_teacher_sd(rng, d, cuda_device), torch.bfloat16)
    tmask = torch.from_numpy((np.arange(t)[None] < rng.randint(2, t + 1, (b, 1)))
                             .astype(np.float32)).to(cuda_device)
    imask = torch.from_numpy((rng.rand(b, p) > 0.25).astype(np.float32)).to(cuda_device)
    imask[:2] = 0.0
    text = _bf16(rng, cuda_device, b, t, d).float() * tmask[..., None]
    image = _bf16(rng, cuda_device, b, p, d).float() * imask[..., None]
    got = xa.cross_attention_fused(w, text, image, tmask, imask, num_heads=heads)
    want = xa.cross_attention_reference(w, text, image, tmask, imask, num_heads=heads)
    for name, g, r in zip(("text", "image"), got, want):
        _close_rel(g, r, what=f"K10 d768 {name}")
    si, st = _bf16(rng, cuda_device, 256, d), _bf16(rng, cuda_device, 256, d)
    ti, tt = (x.float() + 0.5 * torch.from_numpy(
        rng.standard_normal((256, d)).astype(np.float32)).to(cuda_device) for x in (si, st))
    parts = dl.distill_loss_fwd(si, st, ti, tt)
    ref = dl.distill_loss_fwd_reference(si, st, ti, tt)
    torch.cuda.synchronize()
    assert ((parts - ref).abs() <= 1e-5 * ref.abs().clamp(min=1.0)).all()
    cts = torch.tensor([1.0, 1.0, 1.0], device=cuda_device)
    for g, r in zip(dl.distill_loss_bwd(si, st, ti, tt, cts),
                    dl.distill_loss_bwd_reference(si, st, ti, tt, cts)):
        torch.cuda.synchronize()
        assert (g.float() - r.float()).abs().max().item() <= 2.0**-7 * r.float().abs().max().item()


# SigLIP so400m's shapes (16 heads of 72 at width 1152, MLP 4304, tanh-GELU).


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s,d,heads,masks", [
    (2, 729, 1152, 16, ()), (8, 64, 1152, 16, ()), (3, 77, 144, 2, ("causal", "pad")),
    (2, 197, 144, 2, ("seg",)), (3, 65, 144, 2, ()), (2, 17, 144, 2, ()), (1, 1, 72, 1, ()),
])
def test_attention_head_dim_72_matches_twins(cuda_device, b, s, d, heads, masks):
    """K3 / K4 / K5 at head_dim 72 (two swizzled atoms a tile, a fifth k16
    step and an m64n8 product over the tail): SigLIP's vision (S = 729) and
    text (S = 64) shapes unmasked, and every mask at tile edges (65; 17 runs
    the backward's narrow last tile), against the f32 twins within the
    head_dim-64 bounds; the backward twice, the same bits."""
    rng = np.random.RandomState(72 + s + d)
    va, qkv, kw = _attn_case(rng, cuda_device, b, s, d, masks)
    q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    o, m, r = va.self_attention_fwd_stats(q, k, v, heads, **kw)
    o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
    _close_rel(o, o_ref, what="o")
    _close_rel(m, m_ref, what="m")
    torch.testing.assert_close(r, r_ref, rtol=2.0**-6, atol=0)
    torch.testing.assert_close(va.self_attention_fused(q, k, v, heads, **kw), o, rtol=0, atol=0)
    g = _bf16(rng, cuda_device, b, s, d)
    grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
    want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, **kw)
    for name, got_t, want_t in zip(("dq", "dk", "dv"), grads, want):
        _close_rel(got_t, want_t, tol=2.0**-5, what=name)
    again = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, **kw)
    for name, x1, x2 in zip(("dq", "dk", "dv"), grads, again):
        assert torch.equal(x1, x2), name
    # The output's residual: what rounding o to bf16 dropped (at most half an
    # ulp of o), and the backward's delta reads o + o_lo.
    o2, _, _, o_lo = va.self_attention_fwd_stats(q, k, v, heads, residual=True, **kw)
    exact = va.attention_reference(q.float(), k.float(), v.float(), heads, **kw)
    torch.testing.assert_close(o2, o, rtol=0, atol=0)
    assert (o_lo.float().abs() <= 2.0**-8 * o.float().abs()).all()
    _close_rel(o2.float() + o_lo.float(), exact, what="o + o_lo")
    with_lo = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, o_lo=o_lo, **kw)
    want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, o_lo=o_lo, **kw)
    for name, got_t, want_t in zip(("dq", "dk", "dv"), with_lo, want):
        _close_rel(got_t, want_t, tol=2.0**-5, what=name + " with o_lo")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("masks", ["none", "causal_pad", "segments", "causal_segments"])
@pytest.mark.parametrize("s", [255, 257, 513, 729])
def test_attention_backward_head_dim_72_ring_edges(cuda_device, s, masks):
    """K5 at head_dim 72 (csrc/attention_bwd.cu's warp-specialised kernels)
    where its 4-slot ring wraps (4 x 64 +- 1 keys or queries: 4 and 5
    tiles; 8 x 64 + 1: 9) and at SigLIP's S = 729, with each mask, from the
    forward's o and o_lo, against the f32 twin within 2^-5; 24 batch rows of
    2 heads make more work items than a card has SMs, so blocks take two and
    three items in turn (both resident buffers, the ring across items). Two
    calls on the same inputs give the same bits."""
    from dclip_tpu_torch.kernels import vit_attention as va

    b, d, heads = 24, 144, 2
    rng = np.random.RandomState(7200 + s)
    q, k, v = _bf16(rng, cuda_device, b, s, 3 * d).split(d, -1)
    g = _bf16(rng, cuda_device, b, s, d)
    kw = _edge_masks(b, s, masks, cuda_device)
    o, m, r, o_lo = va.self_attention_fwd_stats(q, k, v, heads, residual=True, **kw)
    o_ref, m_ref, r_ref = va.attention_reference(q, k, v, heads, stats=True, **kw)
    grads = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, o_lo=o_lo, **kw)
    want = va.attention_bwd_reference(q, k, v, g, o_ref, m_ref, r_ref, heads, o_lo=o_lo, **kw)
    for name, got_t, want_t in zip(("dq", "dk", "dv"), grads, want):
        _close_rel(got_t, want_t, tol=2.0**-5, what=name)
    again = va.self_attention_bwd_stats(q, k, v, g, o, m, r, heads, o_lo=o_lo, **kw)
    for name, x1, x2 in zip(("dq", "dk", "dv"), grads, again):
        assert torch.equal(x1, x2), name


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m,n,k", [(65, 4304, 1152), (12608, 1152, 4304), (197, 136, 72),
                                   (129, 24, 8), (4096, 1152, 4304)])
def test_gemm_tanh_gelu_and_k_tails(cuda_device, gemm_schedule, m, n, k):
    """The GEMM's tanh-GELU epilogues (with a1 saved; times tanh-GELU') and
    K not a multiple of 32 or 64 (SigLIP's K = 4304, 16 past the last whole
    step of 64; K = 72 and 8), with the quick-GELU forms at the same K, on
    both schedules, against the twins."""
    rng = np.random.RandomState(m + n + k)
    a = _bf16(rng, cuda_device, m, k)
    w = _bf16(rng, cuda_device, k, n) * k**-0.5
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda_device)
    aux = _bf16(rng, cuda_device, m, n)
    for act in ("gelu_pytorch_tanh", "quick_gelu"):
        got, pre = vb.gemm_bias_act_residual(a, w, bias, gelu=True, save_preact=True, act=act)
        want, want_pre = vb.gemm_bias_act_residual_reference(a, w, bias, gelu=True,
                                                             save_preact=True, act=act)
        _close_rel(got, want, what=f"{act} fwd")
        _close_rel(pre, want_pre, what=f"{act} preact")
        _close_rel(vb.gemm_bias_act_residual(a, w, dgelu_of=aux, act=act),
                   vb.gemm_bias_act_residual_reference(a, w, dgelu_of=aux, act=act),
                   what=f"{act}'")
        _close_rel(vb.gemm_bias_act_residual(a, w, bias, gelu=True, act=act),
                   want, what=f"{act} without a1")
    f32 = vb.gemm_bias_act_residual(a, w, out_dtype=torch.float32)
    _close_rel(f32, vb.gemm_bias_act_residual_reference(a, w, out_dtype=torch.float32),
               what="f32 out")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,s", [(2, 729), (1, 64)])
def test_mlp_frozen_at_siglip_widths(cuda_device, b, s):
    """K6 at D = 1152, MLP 4304 with tanh-GELU: the forward with a1, dx
    (tanh-GELU' and K = 4304 into f32, the LayerNorm tail at 1152)."""
    from dclip_tpu_torch.kernels import mlp_frozen as mf

    rng = np.random.RandomState(b * 31 + s)
    lay = _layer(rng, cuda_device, d=1152, mlp=4304)
    p = mf.pack_frozen_mlp(lay["ln2_scale"], lay["ln2_bias"], lay["fc1_w"].t(), lay["fc1_b"],
                           lay["fc2_w"].t(), lay["fc2_b"], torch.bfloat16)
    x = _bf16(rng, cuda_device, b, s, 1152)
    g = _bf16(rng, cuda_device, b, s, 1152)
    act = "gelu_pytorch_tanh"
    y, a1 = mf.mlp_frozen_fwd(x, p, 1e-6, act)
    y_ref, a1_ref = mf.mlp_frozen_fwd_reference(x, p, 1e-6, act)
    _close_rel(y, y_ref, what="y")
    _close_rel(a1, a1_ref, what="a1")
    _close_rel(y, vb.mlp_block_fused(x, p, 1e-6, act), tol=0.0, what="y vs the no-grad block")
    dx = mf.mlp_frozen_bwd(x, g, a1, p, 1e-6, act)
    _close_rel(dx, mf.mlp_frozen_bwd_reference(x, g, a1_ref, p, 1e-6, act), tol=2.0**-5,
               what="dx")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b", [256, 1024, 7])
def test_distill_loss_at_1152(cuda_device, b):
    """K11 at SigLIP's pooled width D = 1152 (its tile kernel's strips past
    48 KB of shared memory), B = 256 a card and 1,024 gathered over four."""
    from dclip_tpu_torch.kernels import distill_loss as dl

    d = 1152
    rng = np.random.RandomState(b + d)
    si, st = _bf16(rng, cuda_device, b, d), _bf16(rng, cuda_device, b, d)
    ti, tt = (x.float() + 0.5 * torch.from_numpy(
        rng.standard_normal((b, d)).astype(np.float32)).to(cuda_device) for x in (si, st))
    torch.testing.assert_close(dl.distill_loss_fwd(si, st, ti, tt),
                               dl.distill_loss_fwd_reference(si, st, ti, tt), rtol=1e-5, atol=0)
    cts = torch.tensor([0.7, 1.3, 0.9], device=cuda_device)
    for got, want in zip(dl.distill_loss_bwd(si, st, ti, tt, cts),
                         dl.distill_loss_bwd_reference(si, st, ti, tt, cts)):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= 2.0**-7 * want.float().abs().max().item(), err
