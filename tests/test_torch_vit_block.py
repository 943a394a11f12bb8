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
                     "gemm.cu", "layernorm.cu", "reduce.cu", "status.cu", "topk.cu"]
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    before = _build.source_digest()
    assert before == _build.source_digest()
    with open(csrc / "common.cuh", "a") as f:
        f.write("// edit\n")
    assert _build.source_digest() != before


# -- the operand contract of the Hopper GEMM and attention (TMA, wgmma) ----------


def _fake_view(shape, *, offset=0, row_pad=0, dtype=torch.bfloat16):
    """A fake CUDA tensor of `shape` whose base lies `offset` elements into
    its storage and whose rows are `row_pad` elements longer than they are
    wide (no card needed)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    ld = shape[-1] + row_pad
    strides, acc = [], 1
    for i, n in enumerate(reversed(shape)):
        strides.append(1 if i == 0 else acc)
        acc *= ld if i == 0 else n
    with FakeTensorMode(allow_non_fake_inputs=True):
        store = torch.empty(acc + offset, dtype=dtype, device="cuda")
        return store.as_strided(tuple(shape), tuple(reversed(strides)), offset)


def _layout_cases():
    """wrapper name -> (module, call(layout)), where layout is "aligned",
    "offset" (a storage offset of one element: a base 2 bytes past 16-byte
    alignment) or "stride" (rows 4 elements longer: not contiguous, and a
    row stride TMA and the 16-byte loads cannot take)."""
    from dclip_tpu_torch.kernels import trainable_ops as to
    from dclip_tpu_torch.kernels import vit_attention as va

    def act(shape, layout):
        return _fake_view(shape, offset=int(layout == "offset"), row_pad=4 * (layout == "stride"))

    f32 = dict(dtype=torch.float32)
    return {
        "gemm_bias_act_residual": (vb, lambda lay: vb.gemm_bias_act_residual(
            act((2, 197, 768), lay), _fake_view((768, 2304)), _fake_view((2304,), **f32))),
        "gemm_nt": (vb, lambda lay: to.gemm_nt(
            _fake_view((394, 768)), act((2304, 768), lay), _fake_view((2304,), **f32))),
        "gemm_tn": (to, lambda lay: to.gemm_tn(act((394, 768), lay), _fake_view((394, 2304)))),
        "attention": (vb, lambda lay: vb.attention(act((2, 197, 2304), lay), 12)),
        "self_attention_fwd_stats": (va, lambda lay: va.self_attention_fwd_stats(
            *(act((2, 77, 512), lay) if lay != "stride" else
              _fake_view((2, 77, 512), row_pad=4) for _ in range(3)), 8, causal=True)),
    }


@pytest.mark.parametrize("layout", ["aligned", "offset", "stride"])
@pytest.mark.parametrize("name", ["gemm_bias_act_residual", "gemm_nt", "gemm_tn", "attention",
                                  "self_attention_fwd_stats"])
def test_cuda_operand_layout_is_checked_before_the_library(monkeypatch, name, layout):
    """csrc/gemm.cu reads its operands by TMA and csrc/attention.cu by
    16-byte copies: a base that is not 16-byte aligned, or a row stride
    that breaks that contract, raises ValueError before the kernel library
    is loaded; a well-formed call reaches the library (stubbed to raise)."""
    module, call = _layout_cases()[name]

    def no_library():
        raise RuntimeError("kernel library requested")

    monkeypatch.setattr(module, "load_library", no_library)
    if layout == "aligned":
        with pytest.raises(RuntimeError, match="kernel library requested"):
            call(layout)
    else:
        with pytest.raises(ValueError, match="aligned|contiguous|row stride"):
            call(layout)


# The main path's GEMM shapes (M rows, N columns) and the tile width the
# schedule rule gives them on the H100's 132 SMs: wide (256) for the teacher
# ViT over 2,048 region crops and the student's frozen MLP (K6) at B=256,
# narrow (128) for the serving buckets, K10's projections and the packed
# text rows.
_SMS = 132
_TILE_CASES = (
    [(f"region_l14_{w}", 2048 * 257, n, 256)
     for w, n in (("qkv", 3072), ("out", 1024), ("fc1", 4096), ("fc2", 1024))]
    + [(f"region_b16_{w}", 2048 * 197, n, 256)
       for w, n in (("qkv", 2304), ("out", 768), ("fc1", 3072), ("fc2", 768))]
    + [(f"k6_l14_n{n}", 256 * 257, n, 256) for n in (4096, 1024)]
    + [(f"k6_b16_n{n}", 256 * 197, n, 256) for n in (3072, 768)]
    + [(f"serve_b16_bucket{b}_n{n}", b * 197, n, 128)
       for b in (1, 4, 16, 64) for n in (2304, 768, 3072)]
    + [(f"serve_l14_bucket{b}_n{n}", b * 257, n, 128) for b in (1, 64) for n in (3072, 4096)]
    + [(f"k10_{w}", m, n, 128) for w, m, n in (("text_qkv", 256 * 77, 1536),
                                                ("image_qkv", 256 * 8, 1536),
                                                ("out", 256 * 77, 512),
                                                ("d768_qkv", 256 * 77, 2304))]
    + [(f"text_packed_n{n}", 64 * 77, n, 128) for n in (1536, 512, 2048)]
)


@pytest.mark.parametrize("m,n,tile", [c[1:] for c in _TILE_CASES],
                         ids=[c[0] for c in _TILE_CASES])
def test_gemm_tile_n_names_the_main_path_shapes(m, n, tile):
    assert vb.gemm_tile_n(m, n, _SMS) == tile


def test_gemm_tile_n_depends_only_on_m_n_and_sms():
    """The rule is a pure function of (M, N, SMs): no K, no dtype, no
    setting. Wide tiles need two row blocks of 128 an SM, so the boundary
    moves with the SM count, and N padded to 256 may waste at most an
    eighth of the columns."""
    import inspect

    assert list(inspect.signature(vb.gemm_tile_n).parameters) == ["m", "n", "sms"]
    for sms in (66, 114, 132):
        edge = 2 * 128 * sms
        assert vb.gemm_tile_n(edge, 1024, sms) == 256
        assert vb.gemm_tile_n(edge - 128, 1024, sms) == 128
        assert vb.gemm_tile_n(edge - 127, 1024, sms) == 256  # the same row blocks
        assert [vb.gemm_tile_n(edge, n, sms) for n in (8, 136, 384, 640, 768, 2304, 2400)] == [
            128, 128, 128, 128, 256, 256, 256]
        assert vb.gemm_tile_n(edge, 1024, sms) == vb.gemm_tile_n(edge, 1024, sms)


def test_gemm_schedules_counter_is_apart_from_launches():
    """`GEMM_SCHEDULES` counts NN / NT launches by schedule beside
    `LAUNCHES` (whose keys the card tests compare whole) and
    `reset_launches` zeroes both."""
    assert set(vb.GEMM_SCHEDULES) == {"wide", "narrow"}
    assert not set(vb.GEMM_SCHEDULES) & set(vb.LAUNCHES)
    vb.GEMM_SCHEDULES["wide"] += 3
    vb.LAUNCHES["layernorm"] += 1
    vb.reset_launches()
    assert vb.GEMM_SCHEDULES == {"wide": 0, "narrow": 0}
    assert all(v == 0 for v in vb.LAUNCHES.values())


def _ragged_mlp_args(rng, k):
    """K8's operands in the JAX layout at hidden width k, mlp 2k."""
    m = 2 * k
    return [(1 + 0.1 * rng.randn(k)).astype(np.float32), (0.1 * rng.randn(k)).astype(np.float32),
            (rng.randn(k, m) * k**-0.5).astype(np.float32), (0.1 * rng.randn(m)).astype(np.float32),
            (rng.randn(m, k) * m**-0.5).astype(np.float32), (0.1 * rng.randn(k)).astype(np.float32)]


@pytest.mark.parametrize("k", [32, 96])
@pytest.mark.parametrize("m", [1, 65, 197])
def test_gemm_twins_match_jax_at_ragged_shapes(m, k):
    """The GEMM's three twins (NN, NT, TN), the kernel's yardsticks on the
    card, against the JAX package's Pallas kernels (interpret mode) at row
    counts and widths that leave csrc/gemm.cu's 128-row tiles (128 or 256
    columns wide) and its K steps of 64 ragged: NN through the frozen ViT
    blocks, NT and TN through K8's forward and its weight gradients,
    composed from the twins alone."""
    import jax
    import jax.numpy as jnp

    from dclip_tpu.kernels.mlp_trainable import mlp_block_trainable
    from dclip_tpu_torch.kernels import trainable_ops as to

    rng = np.random.RandomState(m + k)
    params = torch_parity.layer_params(rng, k, 2 * k)
    x = rng.standard_normal((1, m, k)).astype(np.float32)
    p = vb.pack_layer(layer_state_dict_from_jax(params), "", torch.float32)
    heads = k // 16
    np.testing.assert_allclose(
        vb.attention_block_reference(torch.from_numpy(x), p, heads).numpy(),
        np.asarray(jax_vit_block.attention_block_fused(x, params, heads, 1e-5, interpret=True)),
        **BLOCK_TOL)
    np.testing.assert_allclose(
        vb.mlp_block_reference(torch.from_numpy(x), p).numpy(),
        np.asarray(jax_vit_block.mlp_block_fused(x, params, 1e-5, interpret=True)), **BLOCK_TOL)

    lns, lnb, w1, b1, w2, b2 = _ragged_mlp_args(rng, k)
    g = rng.standard_normal((1, m, k)).astype(np.float32)
    want_y = mlp_block_trainable(x, lns, lnb, w1, b1, w2, b2, interpret=True)
    want_dw1, want_dw2 = jax.grad(
        lambda w1, w2: jnp.sum(mlp_block_trainable(x, lns, lnb, w1, b1, w2, b2,
                                                   interpret=True) * g),
        argnums=(0, 1))(w1, w2)
    t = {n: torch.from_numpy(a) for n, a in
         zip(("x", "g", "lns", "lnb", "b1", "b2"), (x, g, lns, lnb, b1, b2))}
    w1_nk, w2_nk = torch.from_numpy(w1.T.copy()), torch.from_numpy(w2.T.copy())
    h = vb.layernorm_reference(t["x"], t["lns"], t["lnb"])
    act, a1 = to.gemm_nt_reference(h, w1_nk, t["b1"], gelu=True, save_preact=True)
    y = to.gemm_nt_reference(act, w2_nk, t["b2"], residual=t["x"])
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **BLOCK_TOL)
    # dW2 = act^T g and dW1 = h^T da1 ([in, out], the JAX layout), with
    # da1 = (g W2^T) * quick_gelu'(a1) from the NN twin's dgelu epilogue.
    da1 = vb.gemm_bias_act_residual_reference(t["g"], w2_nk, dgelu_of=a1)
    grad_tol = dict(rtol=1e-4, atol=2e-4)  # tests/test_kernels.py's for K8
    np.testing.assert_allclose(to.gemm_tn_reference(act, t["g"]).numpy(),
                               np.asarray(want_dw2), **grad_tol)
    np.testing.assert_allclose(to.gemm_tn_reference(h, da1).numpy(), np.asarray(want_dw1),
                               **grad_tol)


@pytest.mark.parametrize("rows", [1, 13])
@pytest.mark.parametrize("d", [128, 512, 768, 1024])
def test_layernorm_twins_match_jax(d, rows):
    """The LayerNorm twins, the yardsticks of csrc/layernorm.cu on the card
    (forward, frozen backward, and the backward with weight gradients),
    against the JAX package's `_layer_norm` and its VJP, at the kernel's
    widths (512, 768, 1024, and 128 on its predicated path) and row counts
    that are not a multiple of the 8 rows of a block. f32 on both sides:
    sums over D (and over the rows for the weight gradients) in other
    orders, a few ulps of O(1)-O(10) values."""
    import jax
    import jax.numpy as jnp

    from dclip_tpu_torch.kernels import mlp_frozen as mf
    from dclip_tpu_torch.kernels import trainable_ops as to

    rng = np.random.RandomState(d + rows)
    x = (rng.standard_normal((rows, d)) * 2.0 + 0.5).astype(np.float32)
    g = rng.standard_normal((rows, d)).astype(np.float32)
    dh = rng.standard_normal((rows, d)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    eps = 1e-5

    want, vjp = jax.vjp(lambda x, s, b: jax_vit_block._layer_norm(x, s, b, eps), x, scale, bias)
    want_dx, want_ds, want_db = vjp(jnp.asarray(dh))
    t = [torch.from_numpy(a) for a in (x, g, dh, scale, bias)]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(vb.layernorm(t[0], t[3], t[4], eps).numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(mf.layernorm_bwd(t[0], t[1], t[2], t[3], eps).numpy(),
                               g + np.asarray(want_dx), **tol)
    dx, ds, db = to.layernorm_bwd_wgrad(t[0], t[1], t[2], t[3], eps)
    np.testing.assert_allclose(dx.numpy(), g + np.asarray(want_dx), **tol)
    np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=1e-5, atol=1e-4)
