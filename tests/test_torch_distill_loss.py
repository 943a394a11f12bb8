"""The port's distillation losses against the JAX package's, on the CPU:
the fused loss (dclip_tpu_torch.kernels.distill_loss, K11) against the
Pallas kernel in interpret mode (parts, gradients, and each part's own
cotangent), and the plain `ops.losses` against `dclip_tpu.ops.losses`."""
import numpy as np
import pytest
import torch

from dclip_tpu.kernels import distill_loss as jdl
from dclip_tpu.ops import losses as jlosses
from dclip_tpu_torch.kernels import distill_loss as dl
from dclip_tpu_torch.ops import losses

# f32 on both sides: the losses are O(1) sums over B rows of D products,
# the gradients O(1/B); a few ulps apart.
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(b=6, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.standard_normal((b, d)).astype(np.float32) for _ in range(4)]


@pytest.mark.parametrize("b,d,temperature,weight", [(6, 16, 0.05, 1.0), (33, 64, 0.07, 0.5)])
def test_fused_parts_and_grads_match_pallas(b, d, temperature, weight):
    import jax

    x = _inputs(b, d)
    fn = jdl.make_fused_distillation_loss(temperature, weight, interpret=True)
    want = fn(*x)
    t = [torch.from_numpy(a).requires_grad_(i < 2) for i, a in enumerate(x)]
    total, parts = dl.fused_distillation_loss(*t, temperature=temperature,
                                              contrastive_weight=weight)
    for name in dl.PARTS:
        np.testing.assert_allclose(parts[name].item(), float(want[name]), err_msg=name, **TOL)
    # Each part alone, then the total: the cotangent weighting of
    # distill_loss.py:179-186 routes every part's gradient.
    for name in dl.PARTS:
        g_si, g_st = jax.grad(lambda si, st: fn(si, st, x[2], x[3])[name], argnums=(0, 1))(
            x[0], x[1])
        got = torch.autograd.grad(parts[name], t[:2], retain_graph=True)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(g_si), err_msg=name, **TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(g_st), err_msg=name, **TOL)
    assert total is parts["loss"]


def test_plain_losses_match_jax():
    x = _inputs(7, 24, seed=1)
    t = [torch.from_numpy(a) for a in x]
    np.testing.assert_allclose(losses.l2_normalize(t[0]).numpy(),
                               np.asarray(jlosses.l2_normalize(x[0])), **TOL)
    np.testing.assert_allclose(losses.info_nce(t[0], t[1]).item(),
                               float(jlosses.info_nce(x[0], x[1])), **TOL)
    np.testing.assert_allclose(losses.cosine_distillation(t[0], t[2]).item(),
                               float(jlosses.cosine_distillation(x[0], x[2])), **TOL)
    total, parts = losses.distillation_loss(*t, 0.05, 0.7)
    want_total, want = jlosses.distillation_loss(*x, 0.05, 0.7)
    for name in parts:
        np.testing.assert_allclose(parts[name].item(), float(want[name]), err_msg=name, **TOL)


def test_fused_equals_plain_with_gradients():
    """The fused twin and the plain autograd loss agree, gradients included."""
    x = _inputs(9, 32, seed=2)
    a = [torch.from_numpy(v).requires_grad_(i < 2) for i, v in enumerate(x)]
    b = [torch.from_numpy(v).requires_grad_(i < 2) for i, v in enumerate(x)]
    ta, _ = dl.fused_distillation_loss(*a)
    tb, _ = losses.distillation_loss(*b)
    torch.testing.assert_close(ta, tb, **TOL)
    ta.backward()
    tb.backward()
    for u, v in zip(a[:2], b[:2]):
        torch.testing.assert_close(u.grad, v.grad, **TOL)


def test_l2_normalize_zero_row_has_finite_gradient():
    x = torch.zeros(2, 4, requires_grad=True)
    losses.l2_normalize(x).sum().backward()
    assert torch.isfinite(x.grad).all()


def _fake_cuda(*shape, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.zeros(*shape, dtype=dtype, device="cuda")


def test_cuda_tensors_never_fall_back_to_the_twin(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(dl, "load_library", no_library)
    for name in ("distill_loss_fwd_reference", "distill_loss_bwd_reference"):
        monkeypatch.setattr(dl, name, lambda *a, **k: pytest.fail("twin called"))
    s, t = _fake_cuda(256, 512), _fake_cuda(256, 512, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        dl.distill_loss_fwd(s, s, t, t)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        dl.distill_loss_bwd(s, s, t, t, _fake_cuda(3, dtype=torch.float32))
    with pytest.raises(TypeError, match="float32"):
        dl.distill_loss_fwd(s, s, s, s)  # bf16 teacher targets
