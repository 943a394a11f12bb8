"""The port's meta-teacher cross-attention against the JAX package on the
CPU: the differentiable module (`models.cross_modal.CrossModalAttention`)
vs the Flax module, the fused kernel's plain twin
(`kernels.cross_attention.cross_attention_reference`, K10) vs the Pallas
kernel `cross_attention_fused` in interpret mode, the teacher weight
bridge, and the reference checkpoint's torch `nn.MultiheadAttention`
naming. Weights and inputs come from numpy seeds (`tests/torch_parity.py`).
"""
import numpy as np
import pytest
import torch

from dclip_tpu.kernels.cross_attention import cross_attention_fused as jax_cross_attention_fused
from dclip_tpu.models.cross_modal import CrossModalAttention as JaxCrossModalAttention
from dclip_tpu.models.cross_modal import import_torch_cross_modal
from dclip_tpu_torch.kernels import cross_attention as xa
from dclip_tpu_torch.models.cross_modal import CrossModalAttention
from dclip_tpu_torch.models.weights import random_teacher_state_dict, teacher_state_dict_from_jax

import torch_parity

B, T, P, D, H = 3, 11, 5, 32, 4
# f32 on both sides: the two frameworks sum in different orders.
TOL = dict(rtol=1e-5, atol=1e-5)
PREFIX = "cross_modal_attention."


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    text = rng.standard_normal((B, T, D)).astype(np.float32)
    image = rng.standard_normal((B, P, D)).astype(np.float32)
    tmask = (np.arange(T)[None] < np.array([[T], [4], [1]])).astype(np.float32)
    imask = (rng.rand(B, P) > 0.4).astype(np.float32)
    imask[1] = 0.0  # an image row with no valid box
    imask[0, 0] = 1.0
    return text, image, tmask, imask


MASKS = {"none": (False, False), "both": (True, True), "text_only": (True, False),
         "image_only": (False, True)}


@pytest.fixture(scope="module")
def weights():
    params = torch_parity.jax_teacher_params(D, seed=1)
    sd = teacher_state_dict_from_jax(params)
    module = CrossModalAttention(D, H)
    module.load_state_dict({k[len(PREFIX):]: v for k, v in sd.items()}, strict=True)
    return params, sd, module.eval()


def _masked(masks, tmask, imask):
    use_t, use_i = MASKS[masks]
    return (tmask if use_t else None), (imask if use_i else None)


@pytest.mark.parametrize("masks", list(MASKS))
def test_module_matches_flax(weights, masks):
    params, _, module = weights
    text, image, tmask, imask = _inputs()
    tm, im = _masked(masks, tmask, imask)
    want = JaxCrossModalAttention(D, H).apply({"params": params["cross_modal_attention"]},
                                              text, image, text_mask=tm, image_mask=im)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    with torch.no_grad():
        got = module(torch.from_numpy(text), torch.from_numpy(image), t(tm), t(im))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("masks", list(MASKS))
def test_twin_matches_pallas_kernel_interpret(weights, masks):
    """`cross_attention_reference` (and the wrapper, which takes it for CPU
    tensors) == the Pallas kernel in interpret mode, single-sided masks
    completed with ones on both sides."""
    params, sd, _ = weights
    text, image, tmask, imask = _inputs(seed=2)
    tm, im = _masked(masks, tmask, imask)
    want = jax_cross_attention_fused(params["cross_modal_attention"], text, image, tm, im,
                                     num_heads=H, interpret=True)
    p = xa.pack_cross_attention(sd, torch.float32)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    xa.reset_launches()
    got = xa.cross_attention_fused(p, torch.from_numpy(text), torch.from_numpy(image),
                                   t(tm), t(im), num_heads=H)
    assert all(v == 0 for v in xa.LAUNCHES.values())  # CPU tensors: the twin
    ref = xa.cross_attention_reference(p, torch.from_numpy(text), torch.from_numpy(image),
                                       t(tm), t(im), num_heads=H)
    for g, r, w in zip(got, ref, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_all_invalid_box_row_averages_text_values(weights):
    """With no valid box, every text query attends uniformly over the
    image keys (finite -1e30 logits), as the TPU kernel: finite, and equal
    to the unmasked result of a row whose keys are all equal weight."""
    _, sd, _ = weights
    text, image, tmask, imask = _inputs(seed=3)
    p = xa.pack_cross_attention(sd, torch.float32)
    tt, ii = torch.from_numpy(text), torch.from_numpy(image)
    qkv_t = tt @ p["w_text"] + p["b_text"]
    qkv_i = ii @ p["w_image"] + p["b_image"]
    out_t, _ = xa.cross_attention_core_reference(qkv_t, qkv_i, torch.from_numpy(tmask),
                                                 torch.from_numpy(imask), H)
    v_mean = qkv_i[1, :, 2 * D:].mean(0)
    torch.testing.assert_close(out_t[1], v_mean.expand(T, D), rtol=1e-6, atol=1e-6)


def test_add_layernorm_twin_matches_torch():
    rng = np.random.RandomState(4)
    x, a = (torch.from_numpy(rng.standard_normal((6, D)).astype(np.float32)) for _ in range(2))
    s, b = (torch.from_numpy(rng.standard_normal(D).astype(np.float32)) for _ in range(2))
    torch.testing.assert_close(xa.add_layernorm_reference(x, a, s, b),
                               torch.nn.functional.layer_norm(x + a, (D,), s, b, 1e-5),
                               rtol=1e-5, atol=1e-5)
    y0, y1 = xa.add_layernorm_f32(((x, a), (a, x)), (s, s), (b, b))
    torch.testing.assert_close(y0, y1, rtol=0, atol=0)


def test_cross_attention_core_wrapper_on_cpu_is_the_twin(weights):
    rng = np.random.RandomState(5)
    qkv_t = torch.from_numpy(rng.standard_normal((B, T, 3 * D)).astype(np.float32))
    qkv_i = torch.from_numpy(rng.standard_normal((B, P, 3 * D)).astype(np.float32))
    got = xa.cross_attention_core(qkv_t, qkv_i, None, None, H)
    want = xa.cross_attention_core_reference(qkv_t, qkv_i, None, None, H)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_teacher_state_dict_bridge_round_trip(weights):
    """teacher_state_dict_from_jax is the inverse of the JAX package's
    import_torch_cross_modal, and the packed kernel layout holds the
    projections it names."""
    params, sd, _ = weights
    back = import_torch_cross_modal({k[len(PREFIX):]: v.numpy() for k, v in sd.items()})
    want = params["cross_modal_attention"]
    for direction in ("text_to_image", "image_to_text"):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            for leaf in ("kernel", "bias"):
                np.testing.assert_array_equal(back[direction][proj][leaf],
                                              want[direction][proj][leaf])
    for norm in ("norm_text", "norm_image"):
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(back[norm][leaf], want[norm][leaf])
    p = xa.pack_cross_attention(sd, torch.float32)
    c = want
    np.testing.assert_array_equal(p["w_text"][:, :D].numpy(), c["text_to_image"]["q_proj"]["kernel"])
    np.testing.assert_array_equal(p["w_text"][:, D:2 * D].numpy(),
                                  c["image_to_text"]["k_proj"]["kernel"])
    np.testing.assert_array_equal(p["w_image"][:, 2 * D:].numpy(),
                                  c["text_to_image"]["v_proj"]["kernel"])
    np.testing.assert_array_equal(p["wo_i2t"].numpy(), c["image_to_text"]["out_proj"]["kernel"])


def test_random_teacher_state_dict_equals_bridge_of_jax_random_teacher():
    """The `host_random_variables` rule in the JAX tree's draw order."""
    import jax
    import jax.numpy as jnp

    from dclip_tpu.cli.common import host_random_variables
    from dclip_tpu.core.config import TeacherConfig
    from dclip_tpu.models.teacher import PatchTextAggregation as JaxPatchTextAggregation

    cfg = TeacherConfig(embed_dim=D, num_heads=H)
    model = JaxPatchTextAggregation(cfg)
    for seed in (0, 3):
        variables = host_random_variables(model, lambda: model.init(
            jax.random.PRNGKey(0), jnp.zeros((1, T, D)), jnp.zeros((1, P, D))), seed=seed)
        want = teacher_state_dict_from_jax(jax.device_get(variables["params"]))
        got = random_teacher_state_dict(cfg, seed)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_reference_checkpoint_naming_loads_and_matches_torch_mha():
    """A reference-style module (torch nn.MultiheadAttention + LayerNorm
    under the reference's attribute names) hands its state dict to the
    port as is; without masks the two compute the same."""
    from torch import nn

    class ReferenceCrossModalAttention(nn.Module):
        def __init__(self):
            super().__init__()
            self.text_to_image = nn.MultiheadAttention(D, H, batch_first=True)
            self.image_to_text = nn.MultiheadAttention(D, H, batch_first=True)
            self.norm_text = nn.LayerNorm(D)
            self.norm_image = nn.LayerNorm(D)

        def forward(self, text, image):
            t2i, _ = self.text_to_image(text, image, image, need_weights=False)
            i2t, _ = self.image_to_text(image, text, text, need_weights=False)
            return self.norm_text(text + t2i), self.norm_image(image + i2t)

    torch.manual_seed(0)
    ref = ReferenceCrossModalAttention().eval()
    with torch.no_grad():
        for p in ref.parameters():
            p.add_(0.1 * torch.randn_like(p))
    port = CrossModalAttention(D, H)
    port.load_state_dict(ref.state_dict(), strict=True)
    text, image, _, _ = _inputs(seed=6)
    with torch.no_grad():
        want = ref(torch.from_numpy(text), torch.from_numpy(image))
        got = port(torch.from_numpy(text), torch.from_numpy(image))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# (T, P) key counts from the edges of the CUDA core's lane groups and block
# shapes (1, 7, 8, 9, 31, 32, 33, 64, 77, 127, 128 on each side); D = 32
# with 4 heads keeps the interpret-mode run short.
EDGE_TP = [(1, 9), (7, 128), (8, 33), (9, 1), (31, 32), (32, 31), (33, 8), (64, 7),
           (77, 64), (127, 77), (128, 127)]


@pytest.mark.parametrize("masks", ["both", "none"])
@pytest.mark.parametrize("t,p", EDGE_TP)
def test_twin_matches_pallas_at_edge_key_counts(weights, t, p, masks):
    """The f32 twin on packed f32 weights == `cross_attention_fused`
    (interpret=True) at the key counts the CUDA core's tests use, with a
    batch row that has no valid box and one with no valid token."""
    params, sd, _ = weights
    rng = np.random.RandomState(t * 131 + p)
    text = rng.standard_normal((2, t, D)).astype(np.float32)
    image = rng.standard_normal((2, p, D)).astype(np.float32)
    tm = im = None
    if masks == "both":
        tm = (rng.rand(2, t) > 0.3).astype(np.float32)
        im = (rng.rand(2, p) > 0.3).astype(np.float32)
        im[0] = 0.0
        tm[1] = 0.0
    want = jax_cross_attention_fused(params["cross_modal_attention"], text, image, tm, im,
                                     num_heads=H, interpret=True)
    p32 = xa.pack_cross_attention(sd, torch.float32)
    t_ = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = xa.cross_attention_reference(p32, torch.from_numpy(text), torch.from_numpy(image),
                                       t_(tm), t_(im), num_heads=H)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
