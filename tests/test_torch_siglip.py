"""The port's SigLIP student (`models.siglip`) against the plain float32
reference `tests/siglip_reference.py` and against `transformers.SiglipModel`,
at a tiny size on the CPU; the kernels' twins at SigLIP's shapes; the
cached distillation step with a SigLIP student; the paths not brought."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import siglip_reference as ref
from dclip_tpu_torch.core.config import CLIPConfig, DistillConfig, TeacherConfig
from dclip_tpu_torch.kernels import mlp_frozen as mf
from dclip_tpu_torch.kernels import vit_attention as va
from dclip_tpu_torch.kernels import vit_block as vb
from dclip_tpu_torch.models.siglip import SiglipModule, dual_encoder_class
from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

CFG = CLIPConfig.from_name("tiny-siglip")
B = 4


def _state_dict(seed=0, std=None):
    """Random weights; `std` redraws every matrix at N(0, std / sqrt(fan_in))
    so that the tiny towers' features and gradients are not all alike."""
    sd = random_state_dict(CFG, seed)
    if std is not None:
        gen = torch.Generator().manual_seed(seed + 1)
        for name, t in sd.items():
            if t.dim() >= 2:
                sd[name] = torch.randn(t.shape, generator=gen) * std / t[0].numel() ** 0.5
            elif name.endswith("bias") and "layer_norm" not in name and "layernorm" not in name:
                sd[name] = 0.1 * torch.randn(t.shape, generator=gen)
    return sd


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    s = CFG.text.max_length
    ids = rng.randint(2, CFG.text.vocab_size, (B, s))
    lengths = rng.randint(3, s, B)
    for r, n in enumerate(lengths):  # SigLIP's processor: </s> (1), padded with 1
        ids[r, n - 1:] = 1
    return {
        "pixel_values": rng.standard_normal((B, 30, 30, 3)).astype(np.float32),
        "input_ids": ids.astype(np.int64),
        "attention_mask": (np.arange(s)[None] < lengths[:, None]).astype(np.int64),
        "index": np.arange(B, dtype=np.int64),
    }


def _targets(seed=0):
    rng = np.random.RandomState(100 + seed)
    return rng.standard_normal((B, 2, CFG.projection_dim)).astype(np.float32)


def _module(sd, **flags):
    model = SiglipModule(CFG, device="meta", **flags)
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    return model


def test_presets_and_aliases():
    so = CLIPConfig.from_name("google/siglip-so400m-patch14-384")
    assert so == CLIPConfig.from_name("siglip-so400m-14-384") and so.family == "siglip"
    for tower in (so.text, so.vision):
        assert (tower.hidden_size, tower.num_layers, tower.num_heads, tower.mlp_dim,
                tower.layer_norm_eps) == (1152, 27, 16, 4304, 1e-6)
    assert so.vision.num_patches == 729 and so.text.max_length == 64
    assert (so.text.vocab_size, so.text.eos_token_id, so.projection_dim) == (32000, 1, 1152)
    assert dual_encoder_class(so) is SiglipModule
    params = sum(t.numel() for t in SiglipModule(so, device="meta").state_dict().values())
    assert 0.87e9 < params < 0.89e9, params


@pytest.mark.parametrize("flags", [
    {}, {"fused_attention": True, "fused_frozen_mlp": True},
    {"fused_attention": True, "fused_frozen_mlp": True, "remat": True},
], ids=["plain", "kernel_twins", "kernel_twins_remat"])
def test_module_matches_reference(flags):
    """Features, DCLIP's loss parts and every trainable leaf's gradient of
    the port's module (f32, the kernels' twins where flagged) against the
    plain reference."""
    sd = _state_dict(std=1.0)
    batch, t = _batch(), torch.from_numpy(_targets())
    pixels, ids = torch.from_numpy(batch["pixel_values"]), torch.from_numpy(batch["input_ids"])
    model = _module(sd, **flags)
    for name, p in model.named_parameters():
        p.requires_grad_(ref.trainable(name))
    if flags.get("fused_frozen_mlp"):
        model.pack_frozen_vision_mlp()
    img, txt = model.image_features(pixels), model.get_text_features(ids)
    parts = ref.dclip_loss(img, txt, t[:, 0], t[:, 1])
    parts["loss"].backward()
    want_parts, want_grads = ref.loss_and_grads(sd, CFG, pixels, ids, t[:, 0], t[:, 1])
    with torch.no_grad():
        p0 = {n: v.float() for n, v in sd.items()}
        torch.testing.assert_close(img, ref.image_features(p0, CFG, pixels), rtol=1e-4,
                                   atol=1e-5)
        torch.testing.assert_close(txt, ref.text_features(p0, CFG, ids), rtol=1e-4, atol=1e-5)
    for k, v in want_parts.items():
        torch.testing.assert_close(parts[k].detach(), v, rtol=1e-5, atol=1e-6)
    got = {n: p.grad for n, p in model.named_parameters() if ref.trainable(n)}
    assert set(got) == set(want_grads)
    assert any("head.attention.in_proj" in n for n in got) and "logit_bias" in got
    for n, g in want_grads.items():
        have = torch.zeros_like(g) if got[n] is None else got[n]
        torch.testing.assert_close(have, g, rtol=1e-4, atol=1e-5 * max(1.0, g.abs().max()),
                                   msg=n)


def test_module_matches_transformers_siglip():
    """`transformers.SiglipModel` from a tiny `SiglipConfig`: its state dict
    loads strict into the port's module, and both towers' features agree."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=CFG.text.vocab_size, hidden_size=32, intermediate_size=40,
                         num_hidden_layers=2, num_attention_heads=4,
                         max_position_embeddings=CFG.text.max_length, layer_norm_eps=1e-6),
        vision_config=dict(hidden_size=32, intermediate_size=40, num_hidden_layers=2,
                           num_attention_heads=4, image_size=30, patch_size=7,
                           layer_norm_eps=1e-6))
    torch.manual_seed(0)
    hf = transformers.SiglipModel(hf_cfg).eval()
    sd = hf.state_dict()
    model = SiglipModule(CFG, device="meta")
    model.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    batch = _batch(3)
    pixels, ids = torch.from_numpy(batch["pixel_values"]), torch.from_numpy(batch["input_ids"])
    with torch.no_grad():
        want_img = hf.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2))
        want_txt = hf.get_text_features(input_ids=ids)
        torch.testing.assert_close(model.image_features(pixels), want_img, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(model.get_text_features(ids), want_txt, rtol=1e-4, atol=1e-5)
        # The tower takes HF's key-padding mask; the features read none, as
        # SigLIP's processor gives none.
        mask = torch.from_numpy(batch["attention_mask"])
        torch.testing.assert_close(model.text_model(ids, mask)[1],
                                   hf.get_text_features(input_ids=ids, attention_mask=mask),
                                   rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(model.get_text_features(ids, mask), want_txt,
                                   rtol=1e-4, atol=1e-5)


def test_kernel_twins_at_siglip_shapes():
    """The twins the CUDA kernels are held to, at SigLIP's new shapes,
    against independent formulas: tanh-GELU and its derivative, the GEMM
    with a K tail, head_dim 72 attention and its backward, LayerNorm and
    K6 at D = 1152, MLP 4304."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(4096, generator=g) * 4
    torch.testing.assert_close(vb.gelu_tanh(x), F.gelu(x, approximate="tanh"))
    xr = x.clone().requires_grad_()
    F.gelu(xr, approximate="tanh").sum().backward()
    torch.testing.assert_close(vb.gelu_tanh_grad(x), xr.grad)
    a, w = torch.randn(9, 4304, generator=g), torch.randn(4304, 24, generator=g)
    pre = torch.randn(9, 24, generator=g)
    torch.testing.assert_close(
        vb.gemm_bias_act_residual(a, w, dgelu_of=pre, act="gelu_pytorch_tanh"),
        (a @ w) * vb.gelu_tanh_grad(pre))
    # Attention at head_dim 72 (2 heads of 72), forward and backward.
    q, k, v = (torch.randn(2, 13, 144, generator=g) for _ in range(3))
    o = va.attention_reference(q, k, v, 2)
    qh, kh, vh = (t.reshape(2, 13, 2, 72).transpose(1, 2) for t in (q, k, v))
    want = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2).reshape(2, 13, 144)
    torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5)
    o, m, r = va.attention_reference(q, k, v, 2, stats=True)
    gout = torch.randn(2, 13, 144, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    (va.attention_reference(*leaves, 2) * gout).sum().backward()
    for got_t, leaf in zip(va.attention_bwd_reference(q, k, v, gout, o, m, r, 2), leaves):
        torch.testing.assert_close(got_t, leaf.grad, rtol=1e-4, atol=1e-5)
    # LayerNorm and the frozen MLP (K6) at 1152 / 4304 with tanh-GELU.
    d, mlp = 1152, 4304
    xs = torch.randn(2, 5, d, generator=g)
    sc, bi = 1 + 0.1 * torch.randn(d, generator=g), 0.1 * torch.randn(d, generator=g)
    torch.testing.assert_close(vb.layernorm_reference(xs, sc, bi, 1e-6),
                               F.layer_norm(xs, (d,), sc, bi, 1e-6))
    w1, w2 = torch.randn(mlp, d, generator=g) * d**-0.5, torch.randn(d, mlp, generator=g) * mlp**-0.5
    b1, b2 = 0.1 * torch.randn(mlp, generator=g), 0.1 * torch.randn(d, generator=g)
    p = mf.pack_frozen_mlp(sc, bi, w1, b1, w2, b2, torch.float32)
    act = "gelu_pytorch_tanh"
    xl = xs.clone().requires_grad_()
    y = xl + F.linear(F.gelu(F.linear(F.layer_norm(xl, (d,), sc, bi, 1e-6), w1, b1),
                             approximate="tanh"), w2, b2)
    gy = torch.randn(2, 5, d, generator=g)
    y.backward(gy)
    got_y, a1 = mf.mlp_frozen_fwd(xs, p, 1e-6, act)
    torch.testing.assert_close(got_y, y.detach(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(mf.mlp_frozen_bwd(xs, gy, a1, p, 1e-6, act), xl.grad, rtol=1e-4,
                               atol=1e-4)


def _trainer(remat=False, **over):
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    teacher = TeacherConfig(embed_dim=CFG.projection_dim, num_heads=4, max_patches=4,
                            max_text_tokens=CFG.text.max_length)
    cfg = DistillConfig(train_batch_size=B, accumulate_grad_batches=2, teacher=teacher,
                        use_pallas=True, compute_dtype="float32", remat=remat, **over)
    sd = _state_dict(std=1.0)
    cache = TeacherTargetCache(salt="test")
    return DistillTrainer(cfg, sd, _state_dict(7), random_teacher_state_dict(teacher, 0), CFG,
                          CFG, device="cpu", teacher_cache=cache), sd


def test_cached_step_matches_reference_with_and_without_remat():
    """`DistillTrainer.train_step_on_batch` with a SigLIP student and
    targets from the cache (the kernels' twins, f32): the loss parts and
    every trainable gradient against the reference; remat on gives the
    same gradients as remat off."""
    batch, t = _batch(1), _targets(1)
    grads = {}
    for remat in (False, True):
        trainer, sd = _trainer(remat)
        trainer.teacher_cache.put_batch(trainer.teacher_cache.keys_for(batch), t)
        metrics = trainer.train_step_on_batch(batch)
        grads[remat] = {n: p.grad.clone() for n, p in trainer.student.named_parameters()
                        if p.requires_grad and p.grad is not None}
    tt = torch.from_numpy(t)
    want_parts, want = ref.loss_and_grads(sd, CFG, torch.from_numpy(batch["pixel_values"]),
                                          torch.from_numpy(batch["input_ids"]), tt[:, 0],
                                          tt[:, 1])
    for k, v in want_parts.items():
        torch.testing.assert_close(metrics[k], v, rtol=1e-5, atol=1e-6)
    assert set(grads[False]) == set(grads[True])
    for n, g in grads[False].items():
        torch.testing.assert_close(g, want[n], rtol=1e-4, atol=1e-5 * max(1.0, want[n].abs().max()),
                                   msg=n)
        torch.testing.assert_close(grads[True][n], g, rtol=0, atol=0, msg=n)
    assert not any(".mlp." in n and n.startswith("vision_model.") for n in grads[False])


def test_paths_not_brought_raise():
    with pytest.raises(ValueError, match="packed text with a bidirectional text tower"):
        _trainer(packed_text=True)
    trainer, _ = _trainer()
    assert not trainer.cfg.packed_text
    with pytest.raises(ValueError, match="uncached distillation step with a SigLIP teacher"):
        trainer.train_step_on_batch(_batch(2))  # no target in the cache
    model = _module(_state_dict())
    with pytest.raises(ValueError, match="serving path"):
        model.get_image_features(torch.zeros(1, 30, 30, 3))
    with pytest.raises(ValueError, match="packed text"):
        model.get_packed_text_features(None, None, None, None, None)
    with pytest.raises(ValueError, match="K8, K9"):
        SiglipModule(CFG, device="meta", fused_trainable_text_mlp=True)
    with pytest.raises(ValueError, match="SigLIP config"):
        SiglipModule(dataclasses.replace(CFG, family="clip"), device="meta")


def test_profile_cli_runs_a_siglip_preset_cache_warm(capsys):
    """`cli.profile` over a SigLIP preset: the cache-warm step alone, the
    uncached rows absent."""
    import json

    from dclip_tpu_torch.cli import profile

    assert profile.main(["--device", "cpu", "--model_preset", "tiny-siglip", "--batch", "2",
                         "--steps", "1", "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["preset"] == "tiny-siglip" and out["images_per_sec_cache_warm"] > 0
    assert out["images_per_sec_uncached"] is None and list(out["phases_ms"]) == [
        "student step (cache-warm)"]


def test_the_model_asks_for_the_attention_residual():
    """o's rounding residual is the model's choice (SigLIP's towers), not
    the head width's: CLIP's layers keep the plain K4 / K5; with it, the
    differentiable form's gradient reads the delta from o + o_lo."""
    from dclip_tpu_torch.models.clip import CLIPModule

    siglip = SiglipModule(CFG, device="meta", fused_attention=True)
    clip = CLIPModule(CLIPConfig.from_name("tiny"), device="meta", fused_attention=True)
    for model, want in ((siglip, True), (clip, False)):
        for tower in (model.text_model, model.vision_model):
            assert {layer.self_attn.residual for layer in tower.encoder.layers} == {want}
    qkv = torch.randn(2, 9, 3 * 32, generator=torch.Generator().manual_seed(5)).bfloat16()
    g = torch.randn(2, 9, 32, generator=torch.Generator().manual_seed(6)).bfloat16()
    grads = []
    for residual in (False, True):
        x = qkv.clone().requires_grad_()
        va.self_attention_qkv(x, 4, residual=residual).backward(g)
        grads.append(x.grad.float())
    q, k, v = (t.float() for t in qkv.split(32, -1))
    x = torch.cat([q, k, v], -1).requires_grad_()
    va.attention_reference(*x.split(32, -1), 4).backward(g.float())
    err = [(gr - x.grad).abs().max().item() for gr in grads]
    assert err[1] <= err[0] + 1e-6 and err[1] < 2e-2, err
