"""The port's frozen-weight MLP block (dclip_tpu_torch.kernels.mlp_frozen,
K6) against the JAX package's Pallas pair in interpret mode, on the CPU:
the forward's y and saved pre-activation a1 (`_fwd_save_kernel`), dx
(`_bwd_dx_kernel` through `jax.vjp`), and the weight contract."""
import functools

import numpy as np
import pytest
import torch

from dclip_tpu.kernels import mlp_frozen as jmf
from dclip_tpu_torch.kernels import mlp_frozen as mf
from dclip_tpu_torch.kernels import vit_block as vb

import torch_parity

# f32 on both sides; sums over D and mlp in different orders.
TOL = dict(rtol=1e-5, atol=1e-5)


def _case(b, s, d, mlp, seed=0):
    rng = np.random.RandomState(seed)
    p = torch_parity.layer_params(rng, d, mlp)
    ln, fc1, fc2 = p["layer_norm2"], p["mlp"]["fc1"], p["mlp"]["fc2"]
    jax_args = (ln["scale"], ln["bias"], fc1["kernel"], fc1["bias"], fc2["kernel"], fc2["bias"])
    hf = [torch.from_numpy(np.ascontiguousarray(a)) for a in
          (ln["scale"], ln["bias"], fc1["kernel"].T, fc1["bias"], fc2["kernel"].T, fc2["bias"])]
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    g = rng.standard_normal((b, s, d)).astype(np.float32)
    return x, g, jax_args, hf


def _pallas_fwd_save(x, jax_args, eps=1e-5):
    """`_fwd_save_kernel` called as `_mlp_block_frozen_resident`'s fwd
    calls it, returning (y, a1)."""
    import jax
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    b, s, d = x.shape
    mlp = jax_args[2].shape[1]
    consts = jmf._cast_consts(x, *jax_args)
    a1_spec = pl.BlockSpec((1, s, mlp), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    return pl.pallas_call(
        functools.partial(jmf._fwd_save_kernel, eps, jmf._pick_chunk(mlp)),
        grid=(b,),
        in_specs=[jmf._row_spec(b, s, d)] + jmf._const_specs(consts),
        out_specs=(jmf._row_spec(b, s, d), a1_spec),
        out_shape=(jax.ShapeDtypeStruct((b, s, d), x.dtype),
                   jax.ShapeDtypeStruct((b, s, mlp), x.dtype)),
        interpret=True,
    )(x, *consts)


@pytest.mark.parametrize("b,s,d,mlp", [(3, 13, 32, 64), (2, 197, 768, 3072)],
                         ids=["tiny", "b16_one_layer"])
def test_forward_and_dx_match_pallas(b, s, d, mlp):
    import jax

    x, g, jax_args, hf = _case(b, s, d, mlp)
    want_y, want_a1 = _pallas_fwd_save(x, jax_args)
    p = mf.pack_frozen_mlp(*hf, dtype=torch.float32)
    y, a1 = mf.mlp_frozen_fwd(torch.from_numpy(x), p)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(a1.numpy(), np.asarray(want_a1), **TOL)

    f = lambda x, *w: jmf.mlp_block_frozen(x, *w, interpret=True)  # noqa: E731
    y_j, vjp = jax.vjp(f, x, *jax_args)
    cts = vjp(g)
    assert all(not np.any(np.asarray(c)) for c in cts[1:])  # zero weight cotangents
    tx = torch.from_numpy(x).requires_grad_()
    out = mf.mlp_block_frozen(tx, *hf, packed=p)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(cts[0]), **TOL)


def test_layernorm_bwd_reference_is_autograd():
    """The LN backward row formula equals autograd through F.layer_norm
    (frozen affine) plus the residual gradient."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.standard_normal((5, 48)).astype(np.float64)).requires_grad_()
    scale = torch.from_numpy(1 + 0.1 * rng.standard_normal(48))
    dh = torch.from_numpy(rng.standard_normal((5, 48)))
    g = torch.from_numpy(rng.standard_normal((5, 48)))
    (torch.nn.functional.layer_norm(x, (48,), scale, None, 1e-5) * dh).sum().backward()
    got = mf.layernorm_bwd(x.detach(), g, dh, scale)
    torch.testing.assert_close(got, g + x.grad, rtol=1e-5, atol=1e-6)  # the twin runs in f32


def test_no_grad_call_is_the_serving_block():
    x, _, _, hf = _case(2, 9, 32, 64, seed=1)
    p = mf.pack_frozen_mlp(*hf, dtype=torch.float32)
    with torch.no_grad():
        y = mf.mlp_block_frozen(torch.from_numpy(x), *hf, packed=p)
    torch.testing.assert_close(y, vb.mlp_block_fused(torch.from_numpy(x), p), rtol=0, atol=0)


def test_raises_when_a_weight_requires_grad():
    x, _, _, hf = _case(2, 5, 32, 64, seed=2)
    hf[2].requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        mf.mlp_block_frozen(torch.from_numpy(x).requires_grad_(), *hf)


def test_pack_layouts():
    _, _, jax_args, hf = _case(1, 3, 32, 64, seed=3)
    p = mf.pack_frozen_mlp(*hf, dtype=torch.bfloat16)
    assert p["fc1_w"].shape == (32, 64) and p["fc2_w"].shape == (64, 32)
    assert p["fc1_wt"].shape == (64, 32) and p["fc2_wt"].shape == (32, 64)
    for k in ("fc1_w", "fc2_w", "fc1_wt", "fc2_wt"):
        assert p[k].dtype == torch.bfloat16 and p[k].is_contiguous(), k
    for k in ("ln2_scale", "ln2_bias", "fc1_b", "fc2_b"):
        assert p[k].dtype == torch.float32, k
    np.testing.assert_array_equal(p["fc1_w"].float().numpy(),
                                  torch.from_numpy(jax_args[2]).bfloat16().float().numpy())


def _fake_cuda(*shape, dtype=torch.bfloat16):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return torch.zeros(*shape, dtype=dtype, device="cuda")


def test_cuda_tensors_never_fall_back_to_the_twin(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library requested")

    for mod in (mf, vb):
        monkeypatch.setattr(mod, "load_library", no_library)
    for name in ("layernorm_bwd_reference", "mlp_frozen_fwd_reference", "mlp_frozen_bwd_reference"):
        monkeypatch.setattr(mf, name, lambda *a, **k: pytest.fail("twin called"))
    x = _fake_cuda(2, 197, 768)
    scale = _fake_cuda(768, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        mf.layernorm_bwd(x, x, _fake_cuda(2, 197, 768, dtype=torch.float32), scale)
    p = {"ln2_scale": scale, "ln2_bias": scale, "fc1_w": _fake_cuda(768, 3072),
         "fc1_b": _fake_cuda(3072, dtype=torch.float32), "fc2_w": _fake_cuda(3072, 768),
         "fc2_b": scale, "fc1_wt": _fake_cuda(3072, 768), "fc2_wt": _fake_cuda(768, 3072)}
    with pytest.raises(RuntimeError, match="kernel library requested"):
        mf.mlp_frozen_fwd(x, p)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        mf.mlp_frozen_bwd(x, x, _fake_cuda(2, 197, 3072), p)
