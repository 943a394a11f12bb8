"""The port's fused self-attention (dclip_tpu_torch.kernels.vit_attention,
K3/K4/K5) against the JAX package's Pallas kernels in interpret mode, on
the CPU.

On CPU tensors the wrappers run their plain f32 twins, so these tests pin
the twins' algebra (log2-domain stats, masks, the stats-reusing backward)
to the TPU kernels at f32. The CUDA kernels are held against the twins on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import os
import re

import numpy as np
import pytest
import torch

from dclip_tpu.kernels import vit_attention as jva
from dclip_tpu_torch.kernels import vit_attention as va

# f32 on both sides: a few ulps of O(1) outputs and O(1) gradients
# (different summation orders over S and head_dim).
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, s, d, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(4))
    pad = (np.arange(s)[None] < rng.randint(2, s + 1, size=b)[:, None]).astype(np.float32)
    seg = np.zeros((b, s), np.int32)
    for r in range(b):  # three captions and trailing padding, as packing lays them out
        cuts = np.sort(rng.choice(np.arange(1, s), size=3, replace=False))
        seg[r] = np.searchsorted(cuts, np.arange(s), side="right") + 1
        seg[r, cuts[-1]:] = 0
    return q, k, v, g, pad, seg


MASKS = {
    "none": lambda pad, seg: {},
    "causal_padding": lambda pad, seg: {"causal": True, "padding_mask": pad},
    "causal_segments": lambda pad, seg: {"causal": True, "segment_ids": seg},
    "segments": lambda pad, seg: {"segment_ids": seg},
}


def _torch_kw(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("b,s,d,heads", [(3, 13, 32, 4), (2, 77, 512, 8)], ids=["tiny", "text_b16"])
def test_fwd_stats_match_pallas(mask, b, s, d, heads):
    q, k, v, _, pad, seg = _inputs(b, s, d)
    kw = MASKS[mask](pad, seg)
    want = jva._self_attention_fwd_stats(q, k, v, num_heads=heads, interpret=True, **kw)
    got = va.self_attention_fwd_stats(*(torch.from_numpy(t) for t in (q, k, v)), heads,
                                      **_torch_kw(kw))
    for name, w, g in zip(("o", "m", "rinv"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    fused = jva.self_attention_fused(q, k, v, num_heads=heads, interpret=True, **kw)
    got3 = va.self_attention_fused(*(torch.from_numpy(t) for t in (q, k, v)), heads,
                                   **_torch_kw(kw))
    np.testing.assert_allclose(got3.numpy(), np.asarray(fused), **TOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_grads_match_jax_grad(mask):
    import jax

    q, k, v, g, pad, seg = _inputs(3, 13, 32, seed=1)
    kw = MASKS[mask](pad, seg)

    def f(q, k, v):
        return (jva.self_attention_trainable(q, k, v, 4, interpret=True, **kw) * g).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(q, k, v)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    (va.self_attention_trainable(tq, tk, tv, 4, **_torch_kw(kw)) * torch.from_numpy(g)).sum() \
        .backward()
    for name, w, t in zip(("dq", "dk", "dv"), want, (tq, tk, tv)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_bwd_stats_into_one_buffer_matches_separate_outputs():
    """`out=` writes dq|dk|dv into the thirds of one [B, S, 3D] buffer (the
    autograd path's layout) with the same values as separate outputs."""
    q, k, v, g, pad, _ = _inputs(2, 11, 32, seed=2)
    t = [torch.from_numpy(x) for x in (q, k, v, g)]
    o, m, r = va.self_attention_fwd_stats(*t[:3], 4, padding_mask=torch.from_numpy(pad))
    sep = va.self_attention_bwd_stats(*t, o, m, r, 4, padding_mask=torch.from_numpy(pad))
    buf = torch.empty(2, 11, 96)
    va.self_attention_bwd_stats(*t, o, m, r, 4, padding_mask=torch.from_numpy(pad),
                                out=(buf[..., :32], buf[..., 32:64], buf[..., 64:]))
    torch.testing.assert_close(buf, torch.cat(sep, -1), rtol=0, atol=0)


def test_fully_masked_row_is_finite_and_uniform():
    """A row whose every key is masked keeps the TPU's finite -1e30
    convention: m = -1e30, uniform weights over the row's keys, no NaN."""
    q, k, v, _, _, _ = _inputs(1, 9, 16, seed=3)
    pad = np.zeros((1, 9), np.float32)
    o, m, r = va.self_attention_fwd_stats(*(torch.from_numpy(t) for t in (q, k, v)), 2,
                                          padding_mask=torch.from_numpy(pad))
    assert torch.isfinite(o).all() and torch.isfinite(r).all()
    assert torch.all(m == -1e30)
    torch.testing.assert_close(o, torch.from_numpy(v).mean(1, keepdim=True).expand_as(o),
                               rtol=1e-5, atol=1e-6)
    want = jva._self_attention_fwd_stats(q, q, v, num_heads=2, padding_mask=pad, interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want[0]), **TOL)


def test_no_grad_call_takes_the_stats_free_path(monkeypatch):
    calls = []
    real = va.self_attention_fused
    monkeypatch.setattr(va, "self_attention_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    qkv = torch.randn(2, 7, 48, requires_grad=True)
    with torch.no_grad():
        out = va.self_attention_qkv(qkv, 4, causal=True)
    assert calls == [1] and not out.requires_grad
    out = va.self_attention_qkv(qkv, 4, causal=True)
    assert calls == [1] and out.requires_grad  # autograd: K4 forward, K5 backward


def _fake_cuda(*shape, dtype=torch.bfloat16, thirds=False):
    """A fake CUDA tensor (no card needed); with `thirds`, three [.., D]
    tensors strided like the q|k|v thirds of one [.., 3D] buffer."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        if not thirds:
            return torch.zeros(*shape, dtype=dtype, device="cuda")
        b, s, three_d = shape
        return tuple(torch.empty_strided((b, s, three_d // 3), (s * three_d, three_d, 1),
                                         dtype=dtype, device="cuda") for _ in range(3))


def test_cuda_tensors_never_fall_back_to_the_twin(monkeypatch):
    def no_library():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(va, "load_library", no_library)
    for name in ("attention_reference", "attention_bwd_reference"):
        monkeypatch.setattr(va, name, lambda *a, **k: pytest.fail("twin called"))
    q, k, v = _fake_cuda(2, 77, 3 * 512, thirds=True)
    seg = _fake_cuda(2, 77, dtype=torch.int32)
    for fn in (va.self_attention_fused, va.self_attention_fwd_stats):
        with pytest.raises(RuntimeError, match="kernel library requested"):
            fn(q, k, v, 8, causal=True, segment_ids=seg)
    m = _fake_cuda(2, 77, 8, dtype=torch.float32)
    o = _fake_cuda(2, 77, 512)
    with pytest.raises(RuntimeError, match="kernel library requested"):
        va.self_attention_bwd_stats(q, k, v, o, o, m, m, 8, causal=True)
    with pytest.raises(ValueError, match="head_dim 64"):
        va.self_attention_fused(q, k, v, 4)
    with pytest.raises(TypeError, match="bfloat16"):
        va.self_attention_fused(*(_fake_cuda(2, 77, 512, dtype=torch.float32),) * 3, 8)
    with pytest.raises(ValueError):  # a CPU mask with CUDA activations
        va.self_attention_fused(q, k, v, 8, segment_ids=torch.zeros(2, 77, dtype=torch.int32))


def _edge_masks(b, s, rng):
    """Masks for any S >= 1: causal + key padding whose last batch row has
    no valid key (a fully masked row); three segments and trailing padding."""
    lengths = np.maximum(1, rng.randint(1, s + 1, size=b))
    lengths[-1] = 0
    pad = (np.arange(s)[None] < lengths[:, None]).astype(np.float32)
    seg = (np.arange(s) * 3 // s + 1)[None].repeat(b, 0).astype(np.int32)
    seg[:, s - s // 5:] = 0
    return {"none": {}, "causal_padding": {"causal": True, "padding_mask": pad},
            "causal_segments": {"causal": True, "segment_ids": seg},
            "segments": {"segment_ids": seg}}


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("s", [1, 65, 257])
def test_fwd_stats_match_pallas_at_tile_edges(mask, s):
    """The twin, the yardstick of csrc/attention.cu on the card, against
    `_self_attention_fwd_stats` (interpret mode) at sequence lengths that
    leave the kernel's 64-key tiles and 128-row blocks ragged, head_dim 64
    as the kernel takes it."""
    b, d, heads = 2, 128, 2
    rng = np.random.RandomState(s)
    q, k, v = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(3))
    kw = _edge_masks(b, s, np.random.RandomState(s))[mask]
    want = jva._self_attention_fwd_stats(q, k, v, num_heads=heads, interpret=True, **kw)
    got = va.self_attention_fwd_stats(*(torch.from_numpy(t) for t in (q, k, v)), heads,
                                      **_torch_kw(kw))
    for name, w, g in zip(("o", "m", "rinv"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("s", [1, 65, 257])
def test_bwd_stats_match_pallas_at_tile_edges(mask, s):
    """The backward twin, the yardstick of csrc/attention_bwd.cu on the card,
    against `_self_attention_bwd_stats` (interpret mode) at the same ragged
    sequence lengths, from the same forward output and statistics (the
    Pallas forward's). f32 on both sides: the sums run over S keys or
    queries in other orders, so the gradients (O(1)-O(10) here) agree to
    a few ulps, within TOL."""
    b, d, heads = 2, 128, 2
    rng = np.random.RandomState(100 + s)
    q, k, v, g = (rng.standard_normal((b, s, d)).astype(np.float32) for _ in range(4))
    kw = _edge_masks(b, s, np.random.RandomState(s))[mask]
    o, m, r = (np.array(t) for t in
               jva._self_attention_fwd_stats(q, k, v, num_heads=heads, interpret=True, **kw))
    want = jva._self_attention_bwd_stats(q, k, v, g, o, m, r, num_heads=heads, interpret=True,
                                         **kw)
    got = va.attention_bwd_reference(*(torch.from_numpy(t) for t in (q, k, v, g, o, m, r)),
                                     heads, **_torch_kw(kw))
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), err_msg=name, **TOL)


def test_attention_bwd_kernels_are_counted_by_the_benchmark():
    """Every `__global__` kernel of csrc/attention_bwd.cu (K5) has a name
    holding one of the two attention-backward names by which the SigLIP
    benchmark sums K5's device time (`KERNEL_FAMILIES`), and each of the two
    is there: a kernel renamed outside them would leave its time uncounted
    and the attention roofline reading high."""
    from benchmark.drivers.siglip_distill_step import KERNEL_FAMILIES
    from dclip_tpu_torch.kernels import _build

    with open(os.path.join(_build.CSRC_DIR, "attention_bwd.cu")) as f:
        src = f.read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)
    families = (KERNEL_FAMILIES["attention_dq"], KERNEL_FAMILIES["attention_dkdv"])
    assert len(names) >= 2, names
    for name in names:
        assert any(family in name for family in families), name
    for family in families:
        assert any(family in name for name in names), family
