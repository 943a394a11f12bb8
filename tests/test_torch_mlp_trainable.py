"""The port's trainable MLP block (dclip_tpu_torch.kernels.mlp_trainable,
K8) and the GEMM modes and row reductions it adds
(dclip_tpu_torch.kernels.trainable_ops) against the JAX package on the
CPU: the K8 twin against `mlp_block_trainable(interpret=True)`, forward
and all seven cotangents, at `tests/test_kernels.py`'s fixture; the text
tower with `fused_trainable_text_mlp` against the JAX module with the same
flag; and the wrappers' CPU-only dispatch."""
import numpy as np
import pytest
import torch

from dclip_tpu_torch.kernels import mlp_trainable as mt
from dclip_tpu_torch.kernels import trainable_ops as to
from dclip_tpu_torch.kernels import vit_block as vb

import torch_parity

# JAX's own tolerances for this kernel (tests/test_kernels.py:591,602).
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=2e-4)
NAMES = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")


def _args():
    """tests/test_kernels.py `frozen_mlp_args`: B=3, S=16, D=64, mlp 256, in
    the JAX layout (w1 [D, mlp], w2 [mlp, D])."""
    rng = np.random.RandomState(7)
    b, s, d, m = 3, 16, 64, 256
    return (rng.randn(b, s, d).astype(np.float32),
            (1 + 0.1 * rng.randn(d)).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32),
            (rng.randn(d, m) * 0.05).astype(np.float32),
            (0.1 * rng.randn(m)).astype(np.float32),
            (rng.randn(m, d) * 0.05).astype(np.float32),
            (0.1 * rng.randn(d)).astype(np.float32))


def _hf(args):
    """The port's operands: HF layout (fc1.weight [mlp, D], fc2.weight [D, mlp])."""
    x, lns, lnb, w1, b1, w2, b2 = args
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, lns, lnb, w1.T, b1, w2.T, b2)]


def _to_jax_layout(name, t):
    return t.T if name in ("w1", "w2") else t


def test_forward_matches_pallas_interpret():
    from dclip_tpu.kernels.mlp_trainable import mlp_block_trainable

    args = _args()
    want = mlp_block_trainable(*args, interpret=True)
    got = mt.mlp_block_trainable(*_hf(args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)
    y, a1 = mt.mlp_trainable_fwd_reference(*_hf(args))
    torch.testing.assert_close(y, got, rtol=0, atol=0)
    assert a1.shape == (3, 16, 256)


def test_all_seven_cotangents_match_pallas_interpret():
    import jax
    import jax.numpy as jnp

    from dclip_tpu.kernels.mlp_trainable import mlp_block_trainable

    args = _args()
    co = np.random.RandomState(9).randn(*args[0].shape).astype(np.float32)
    want = jax.grad(lambda *a: jnp.sum(mlp_block_trainable(*a, interpret=True) * co),
                    argnums=tuple(range(7)))(*args)
    ts = [t.requires_grad_() for t in _hf(args)]
    (mt.mlp_block_trainable(*ts) * torch.from_numpy(co)).sum().backward()
    for name, t, w in zip(NAMES, ts, want):
        assert float(np.abs(np.asarray(w)).max()) > 0.0, name
        np.testing.assert_allclose(_to_jax_layout(name, t.grad.numpy()), np.asarray(w),
                                   err_msg=name, **GRAD_TOL)


def test_backward_twin_is_autograd_of_the_forward_twin():
    """`mlp_trainable_bwd_reference` == autograd through the f32 forward twin."""
    ts = [t.double().requires_grad_() for t in _hf(_args())]
    g = torch.from_numpy(np.random.RandomState(3).randn(3, 16, 64))
    y, a1 = mt.mlp_trainable_fwd_reference(*ts)
    auto = torch.autograd.grad(y, ts, g)
    mine = mt.mlp_trainable_bwd_reference(*[t.detach() for t in ts[:1]], g, a1.detach(),
                                          *[t.detach() for t in ts[1:]])
    for name, a, b in zip(NAMES, mine, auto):
        torch.testing.assert_close(a.double(), b, rtol=1e-5, atol=1e-6, msg=name)


def test_frozen_weights_get_no_gradient():
    """`ctx.needs_input_grad`: weights that need no gradient get None."""
    ts = _hf(_args())
    ts[0].requires_grad_()
    ts[3].requires_grad_()  # fc1.weight only
    mt.mlp_block_trainable(*ts).sum().backward()
    assert ts[0].grad is not None and ts[3].grad is not None
    assert all(t.grad is None for i, t in enumerate(ts) if i not in (0, 3))


def test_text_tower_with_fused_mlp_matches_jax_module():
    """CLIPModule(fused_trainable_text_mlp=True): text features and the LN2 /
    MLP gradients of the JAX module with the same flag (Pallas in interpret
    mode), on the same weights (tests/test_kernels.py:638)."""
    import jax
    import jax.numpy as jnp

    from dclip_tpu.core.config import CLIPConfig
    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.weights import state_dict_from_jax

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=0)
    ids, mask = torch_parity.text_batch(cfg, seed=4)
    jm = JaxCLIPModule(cfg, fused_trainable_text_mlp=True, pallas_interpret=True)

    def loss(p):
        out = jm.apply({"params": p}, ids, mask, method=jm.get_text_features)
        return jnp.sum(out * out), out

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    model = CLIPModule(cfg, device="meta", fused_trainable_text_mlp=True)
    model.load_state_dict(state_dict_from_jax(params, cfg), strict=True, assign=True)
    assert model.text_model.encoder.layers[0].fused_trainable_mlp
    got = model.get_text_features(torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    (got * got).sum().backward()
    grads = state_dict_from_jax(jax.device_get(jgrads), cfg)
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith("text_model.encoder.") and (".mlp." in name or "layer_norm2" in name):
            assert float(p.grad.abs().max()) > 0.0, name
            np.testing.assert_allclose(p.grad.numpy(), grads[name].reshape(p.shape).numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)
            checked += 1
    assert checked == 6 * cfg.text.num_layers


# -- the GEMM modes and reductions -----------------------------------------------------


def test_trainable_ops_twins():
    """The twins compute in f32: held to f32 rounding of the plain products."""
    rng = np.random.RandomState(1)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    a, w, bias, res, y = t(2, 5, 32), t(24, 32), t(24), t(2, 5, 24), t(2, 5, 16)
    tol = dict(rtol=1e-5, atol=1e-5)
    got, pre = to.gemm_nt(a, w, bias, residual=res, gelu=True, save_preact=True)
    torch.testing.assert_close(pre, a @ w.t() + bias, **tol)
    torch.testing.assert_close(got, vb.quick_gelu(a @ w.t() + bias) + res, **tol)
    torch.testing.assert_close(to.gemm_tn(a, y), torch.einsum("bsp,bsq->pq", a, y), **tol)
    torch.testing.assert_close(to.colsum(a), a.sum((0, 1)), **tol)


def test_layernorm_wgrad_twin_is_autograd():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 5, 48)).requires_grad_()
    scale = torch.from_numpy(1 + 0.1 * rng.randn(48)).requires_grad_()
    bias = torch.from_numpy(0.1 * rng.randn(48)).requires_grad_()
    dh = torch.from_numpy(rng.randn(3, 5, 48))
    g = torch.from_numpy(rng.randn(3, 5, 48))
    (torch.nn.functional.layer_norm(x, (48,), scale, bias, 1e-5) * dh).sum().backward()
    dx, ds, db = to.layernorm_bwd_wgrad(x.detach(), g, dh, scale.detach())
    torch.testing.assert_close(dx, g + x.grad, rtol=1e-5, atol=1e-6)  # the twin runs in f32
    torch.testing.assert_close(ds.double(), scale.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(db.double(), bias.grad, rtol=1e-5, atol=1e-5)
    none, ds2, _ = to.layernorm_bwd_wgrad(x.detach(), None, dh, scale.detach(), need_dx=False)
    assert none is None and torch.equal(ds2, ds)


def _fake_cuda(*shape, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.zeros(*shape, dtype=dtype, device="cuda")


def test_cuda_tensors_never_fall_back_to_the_twin(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library requested")

    for mod in (to, vb):
        monkeypatch.setattr(mod, "load_library", no_library)
    for name in ("gemm_nt_reference", "gemm_tn_reference", "colsum_reference",
                 "layernorm_bwd_wgrad_reference"):
        monkeypatch.setattr(to, name, lambda *a, **k: pytest.fail("twin called"))
    monkeypatch.setattr(to, "_sm_count", lambda index: 132)
    x = _fake_cuda(2, 77, 512)
    f32 = _fake_cuda(512, dtype=torch.float32)
    calls = [
        lambda: to.gemm_nt(x, _fake_cuda(2048, 512), _fake_cuda(2048, dtype=torch.float32)),
        lambda: to.gemm_tn(x, _fake_cuda(2, 77, 2048)),
        lambda: to.colsum(x),
        lambda: to.layernorm_bwd_wgrad(x, x, _fake_cuda(2, 77, 512, dtype=torch.float32), f32),
        lambda: mt.mlp_block_trainable(x, f32, f32, _fake_cuda(2048, 512, dtype=torch.float32),
                                       _fake_cuda(2048, dtype=torch.float32),
                                       _fake_cuda(512, 2048, dtype=torch.float32), f32),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="kernel library requested"):
            call()
