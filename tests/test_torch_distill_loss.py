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


# -- the CUDA kernels' tiling (csrc/distill_loss.cu), emulated in numpy ------------

THREADS = 256  # a tile block's threads in csrc/distill_loss.cu


def _merge(m, s, vm, vs):
    """The kernels' `merge_into`, elementwise: m = -inf is the empty pair."""
    with np.errstate(invalid="ignore", over="ignore"):
        mn = np.maximum(m, vm)
        both = s * np.exp(m - mn) + vs * np.exp(vm - mn)
    s = np.where(vm == -np.inf, s, np.where(m == -np.inf, vs, both)).astype(np.float32)
    return np.where(vm == -np.inf, m, np.where(m == -np.inf, vm, mn)).astype(np.float32), s


def _tiled_lse(z):
    """The log-sum-exps of Z's rows and columns as the kernels form them:
    each 32 x 32 tile's (max, sum exp) per row and per column; then, for
    each row, 8 threads each fold the tiles 8 apart in order, and a shuffle
    tree over those threads merges their pairs."""
    b = z.shape[0]
    tile = 32
    nt, r = -(-b // tile), THREADS // tile
    prow = np.zeros((nt, b, 2), np.float32)
    pcol = np.zeros((nt, b, 2), np.float32)
    for bi in range(nt):
        for bj in range(nt):
            rows, cols = slice(bi * tile, (bi + 1) * tile), slice(bj * tile, (bj + 1) * tile)
            zt = z[rows, cols]
            m = zt.max(1)
            prow[bj, rows] = np.stack([m, np.exp(zt - m[:, None]).sum(1)], -1)
            m = zt.max(0)
            pcol[bi, cols] = np.stack([m, np.exp(zt - m[None]).sum(0)], -1)

    def merge(part):
        m = np.full((r, b), -np.inf, np.float32)
        s = np.zeros((r, b), np.float32)
        for p in range(r):
            for k in range(p, nt, r):
                m[p], s[p] = _merge(m[p], s[p], part[k, :, 0], part[k, :, 1])
        o = r // 2
        while o:
            idx = np.arange(r) ^ o
            m, s = _merge(m, s, m[idx], s[idx])
            o //= 2
        return m[0] + np.log(s[0])

    return merge(prow), merge(pcol)


def _emulate(si, st, ti, tt, cts, temperature, weight):
    """The forward's four parts and the backward's (dsi, dst), in f32, in
    the kernels' order: Z from raw dot products scaled by the two inverse
    norms, tile partials merged in order, gradients accumulated over the
    other matrix's 32-row tiles in order, and the chain rule's <g, s^> from
    Z and the cosines (a gradient block holds 64 columns, not the row)."""
    f32 = np.float32

    def inv(x):
        return (1.0 / np.sqrt(np.maximum((x * x).sum(-1), f32(1e-24)))).astype(f32)

    inv_i, inv_t = inv(si), inv(st)
    z = ((si @ st.T) * inv_i[:, None] * inv_t[None] / f32(temperature)).astype(f32)
    lse_row, lse_col = _tiled_lse(z)
    cos_i = (si * ti).sum(-1) * inv_i * inv(ti)
    cos_t = (st * tt).sum(-1) * inv_t * inv(tt)
    li, lt = 1 - cos_i.mean(), 1 - cos_t.mean()
    lc = 0.5 * (lse_row.mean() + lse_col.mean()) - np.diag(z).mean()
    parts = np.array([li, lt, lc, li + lt + weight * lc], f32)
    b = si.shape[0]
    eye = np.eye(b, dtype=f32)
    gz = cts[2] / (2 * b * temperature) * (
        (np.exp(z - lse_row[:, None]) - eye) + (np.exp(z - lse_col[None]) - eye))
    grads = []
    for g_z, z_, other, inv_o, self_, inv_s, teacher, cos, c in (
            (gz, z, st, inv_t, si, inv_i, ti, cos_i, cts[0]),
            (gz.T, z.T, si, inv_i, st, inv_t, tt, cos_t, cts[1])):
        acc = np.zeros_like(self_)
        for k in range(0, b, 32):  # the gradient kernel's tiles of other rows
            acc += (g_z[:, k:k + 32] * inv_o[None, k:k + 32]) @ other[k:k + 32]
        g = acc - (c / b) * teacher * inv(teacher)[:, None]
        dot = temperature * (g_z * z_).sum(-1) - (c / b) * cos
        grads.append((g - dot[:, None] * (self_ * inv_s[:, None])) * inv_s[:, None])
    return parts, grads


@pytest.mark.parametrize("b,d", [(1, 16), (5, 24), (33, 16), (70, 32), (257, 8)])
def test_kernel_tiling_emulation_matches_pallas(b, d):
    """The CUDA kernels' tiling and merge order, emulated, against the
    Pallas kernels (`_run_fwd`, `_run_bwd`, interpret mode) and the twins,
    at B on each side of the 32-row tiles of Z and of the gradient kernel,
    and with more tiles a side (9) than threads fold them (8)."""
    x = _inputs(b, d, seed=b)
    x[2] = x[0] + 0.5 * x[2]  # targets correlated with the student rows
    x[3] = x[1] + 0.5 * x[3]
    cts = np.array([0.7, 1.3, 0.9], np.float32)
    parts, (dsi, dst) = _emulate(*x, cts, 0.05, 0.7)
    want = np.asarray(jdl._run_fwd(*x, 0.05, 0.7, True))
    np.testing.assert_allclose(parts, want, rtol=1e-5, atol=1e-5)
    want_si, want_st = jdl._run_bwd(*x, cts.reshape(1, 3), 0.05, True)
    np.testing.assert_allclose(dsi, np.asarray(want_si), **TOL)
    np.testing.assert_allclose(dst, np.asarray(want_st), **TOL)
    t = [torch.from_numpy(a) for a in x]
    np.testing.assert_allclose(dl.distill_loss_fwd_reference(*t, 0.05, 0.7).numpy(), parts,
                               rtol=1e-5, atol=1e-5)
    for got, ref in zip((dsi, dst), dl.distill_loss_bwd_reference(*t, torch.from_numpy(cts), 0.05)):
        np.testing.assert_allclose(got, ref.numpy(), **TOL)
