"""The port's teacher targets against the JAX package on the CPU, module by
module and as a whole:

- `ops.image_ops` crop-resize (the triangle-filter weights of
  `jax.image.scale_and_translate`) over up- and down-scaling, fractional,
  degenerate and out-of-frame boxes;
- `ops.aggregation`, masked and unmasked; `ops.knn.knn_or_projection`;
- `models.clip` token and patch features; `models.teacher` encode_tokens,
  encode_patches (the block-kernel path) and its compact form;
- the slice: `DistillTrainer`'s miss-path targets vs the JAX trainer's
  `_teacher_targets`, one uncached step's update vs the JAX
  `train_step_on_batch`, `eval_loss_on_batch` vs the JAX one, and the
  three cache levels.

The JAX trainer runs on a one-device CPU mesh with `use_pallas=True` (its
Pallas kernels in interpret mode) at f32, the port's with the kernels on
(their plain f32 twins on the CPU). Inputs come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig, DistillConfig, MeshConfig, TeacherConfig
from dclip_tpu_torch.models.weights import state_dict_from_jax, teacher_state_dict_from_jax
from dclip_tpu_torch.ops import aggregation, image_ops, knn
from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

import torch_parity

B, P = 4, 3
# Embeddings after the 2-layer towers at f32: a few ulps per layer.
EMB_TOL = dict(rtol=1e-4, atol=1e-5)
AGG_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


# -- crop-resize ---------------------------------------------------------------

BOXES = {
    "fractional_up": [3.2, 4.7, 20.1, 30.3],  # 17 x 26 px -> 24: upscaling
    "full_frame_down": [0.0, 0.0, 36.0, 40.0],  # down-scaling, widened kernel
    "degenerate": [10.0, 10.0, 10.5, 10.2],  # w, h < 1 -> 1
    "zero": [0.0, 0.0, 0.0, 0.0],  # an invalid slot
    "partly_outside": [-5.0, -3.0, 12.0, 8.0],
    "mostly_outside": [30.0, 35.0, 50.0, 60.0],
    "tiny_fractional": [1.5, 2.5, 3.0, 3.1],
}


@pytest.mark.parametrize("out", [24, 16])
@pytest.mark.parametrize("box", list(BOXES))
def test_crop_resize_matches_jax(box, out):
    from dclip_tpu.ops.image_ops import crop_resize as jax_crop_resize

    img = np.random.RandomState(0).rand(40, 36, 3).astype(np.float32)
    b = np.asarray(BOXES[box], np.float32)
    want = jax_crop_resize(jnp.asarray(img), jnp.asarray(b), out)
    got = image_ops.crop_resize(_t(img), _t(b), out)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_batch_crop_resize_normalize_matches_jax():
    """The crops agree at atol 1e-5 in [0, 1] intensities, the unit of
    the crop: XLA's compiled crop differs from its formula by a few 1e-6
    there (ops/image_ops.py), which the normalization's 1 / std (up to
    3.8) magnifies; the normalization itself is the same affine map."""
    from dclip_tpu.ops.image_ops import batch_crop_resize_normalize as jax_batch
    from dclip_tpu.ops.image_ops import normalize as jax_normalize

    rng = np.random.RandomState(1)
    imgs = rng.rand(2, 40, 36, 3).astype(np.float32)
    boxes = np.asarray([list(BOXES.values())[:4], list(BOXES.values())[3:]], np.float32)
    want = np.asarray(jax_batch(imgs, boxes, 24))
    got = image_ops.batch_crop_resize_normalize(_t(imgs), _t(boxes), 24).numpy()
    assert got.shape == (2, 4, 24, 24, 3)
    mean, std = np.asarray(image_ops.CLIP_MEAN), np.asarray(image_ops.CLIP_STD)
    np.testing.assert_allclose(got * std + mean, want * std + mean, rtol=0, atol=1e-5)
    np.testing.assert_allclose(image_ops.normalize(_t(imgs)).numpy(),
                               np.asarray(jax_normalize(imgs)), rtol=0, atol=1e-6)


# -- aggregation ----------------------------------------------------------------


def _agg_inputs():
    rng = np.random.RandomState(2)
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    mask = (np.arange(7)[None] < np.array([[7], [3], [1]])).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_aggregation_matches_jax(masked):
    from dclip_tpu.ops import aggregation as jagg

    x, mask = _agg_inputs()
    m = mask if masked else None
    np.testing.assert_allclose(aggregation.temperature_aggregate(_t(x), 2.0, _t(m)).numpy(),
                               np.asarray(jagg.temperature_aggregate(x, 2.0, m)), **AGG_TOL)
    p = np.random.RandomState(3).standard_normal((3, 4, 8)).astype(np.float32)
    got = aggregation.best_text_similarity(_t(x), _t(p), _t(m))
    want = jagg.best_text_similarity(x, p, m)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **AGG_TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    rng = np.random.RandomState(4)
    boxes = rng.rand(3, 4, 4).astype(np.float32) * 10
    boxes[..., 2:] += boxes[..., :2]
    conf = rng.rand(3, 4).astype(np.float32)
    sims = rng.standard_normal((3, 4)).astype(np.float32)
    sims[1] = 0.0  # a zero-total row: uniform fall-back
    pmask = (rng.rand(3, 4) > 0.3).astype(np.float32) if masked else None
    np.testing.assert_allclose(
        aggregation.patch_weights(_t(boxes), _t(conf), _t(sims), _t(pmask)).numpy(),
        np.asarray(jagg.patch_weights(boxes, conf, sims, pmask)), **AGG_TOL)
    np.testing.assert_allclose(aggregation.fuse_global(_t(x[:, 0]), _t(x[:, 1]), 0.3).numpy(),
                               np.asarray(jagg.fuse_global(x[:, 0], x[:, 1], 0.3)), **AGG_TOL)


# -- k-NN gate --------------------------------------------------------------------


@pytest.mark.parametrize("store", ["hits_and_misses", "empty"])
def test_knn_or_projection_matches_jax(store):
    from dclip_tpu.ops.knn import knn_or_projection as jax_gate

    rng = np.random.RandomState(5)
    keys = rng.standard_normal((20, 8)).astype(np.float32)
    keys /= np.linalg.norm(keys, axis=-1, keepdims=True)
    values = rng.standard_normal((20, 8)).astype(np.float32)
    queries = np.concatenate([keys[:3] + 0.01, rng.standard_normal((4, 8))]).astype(np.float32)
    if store == "empty":
        keys = values = np.zeros((0, 8), np.float32)
    want = jax_gate(queries, None, keys, values, None, 0.85)
    got = knn.knn_or_projection(_t(queries), None, _t(keys), _t(values), None, 0.85)
    np.testing.assert_allclose(got.embeddings.numpy(), np.asarray(want.embeddings), **AGG_TOL)
    np.testing.assert_array_equal(got.source.numpy(), np.asarray(want.source))
    np.testing.assert_allclose(got.similarity.numpy(), np.asarray(want.similarity), **AGG_TOL)
    if store != "empty":
        assert (got.source.numpy()[:3] == knn.SOURCE_KNN).all()
        assert (got.source.numpy()[3:] == knn.SOURCE_CLIP).all()


# -- CLIP token / patch features, the teacher's encoders --------------------------


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    model, params = torch_parity.jax_clip(cfg, seed=0)
    return cfg, model, params


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused_attention"])
def test_encode_tokens_matches_jax(tiny, fused):
    from dclip_tpu.models.teacher import encode_tokens as jax_encode_tokens
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.teacher import encode_tokens

    cfg, model, params = tiny
    ids, mask = torch_parity.text_batch(cfg, seed=3)
    want, want_mask = jax_encode_tokens(model, {"params": params}, ids, mask,
                                        cfg.text.eos_token_id)
    port = CLIPModule(cfg, device="meta", fused_attention=fused)
    port.load_state_dict(state_dict_from_jax(params, cfg), strict=True, assign=True)
    with torch.no_grad():
        got, got_mask = encode_tokens(port.eval(), _t(ids), _t(mask), cfg.text.eos_token_id)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EMB_TOL)


def test_patch_features_match_jax(tiny):
    cfg, model, params = tiny
    port = torch_parity.port_clip(cfg, params)
    px = torch_parity.pixels(cfg, 2, seed=5)
    want = model.apply({"params": params}, px, method=model.get_patch_features)
    with torch.no_grad():
        got = port.get_patch_features(_t(px))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EMB_TOL)


def _region_inputs(cfg, seed=6):
    rng = np.random.RandomState(seed)
    s = cfg.vision.image_size
    images = rng.rand(B, s, s, 3).astype(np.float32)
    boxes = rng.rand(B, P, 4).astype(np.float32) * (s / 2)
    boxes[..., 2:] += boxes[..., :2] + 2
    boxes[0, 1] = [-4.0, 3.5, s + 6.0, s / 3]  # partly outside, downscaled
    mask = np.ones((B, P), np.float32)
    mask[1, 1:] = 0.0
    mask[2] = 0.0  # an image with no valid box
    return images, boxes, mask


def test_encode_patches_matches_jax_block_kernel_path(tiny):
    from dclip_tpu.kernels.vit_block import fused_image_features as jax_fused
    from dclip_tpu.models.teacher import encode_patches as jax_encode_patches
    from dclip_tpu_torch.models.teacher import encode_patches

    cfg, model, params = tiny
    images, boxes, mask = _region_inputs(cfg)
    s = cfg.vision.image_size
    want = jax_encode_patches(model, {"params": params}, images, boxes, mask, s,
                              image_features_fn=lambda v, px: jax_fused(cfg, v, px,
                                                                        interpret=True))
    port = torch_parity.port_clip(cfg, params)
    w = port.pack_image_weights()
    with torch.no_grad():
        got = encode_patches(port, _t(images), _t(boxes), _t(mask), s,
                             lambda px: port.get_image_features(px, w))
    assert got.shape == (B, P, cfg.projection_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **EMB_TOL)
    assert not got[2].any() and not got[1, 1:].any()


@pytest.mark.parametrize("budget", [6, 9, 12])
def test_encode_patches_compact_equals_dense(tiny, budget):
    """Valid slots: 3 + 1 + 0 + 3 = 7; budgets of 9 and 12 cover them (and
    12 = B * P is the dense path); 6 drops the last valid slot."""
    from dclip_tpu.models.teacher import patch_budget as jax_patch_budget
    from dclip_tpu_torch.models.teacher import (
        encode_patches,
        encode_patches_compact,
        patch_budget,
    )

    cfg, _, params = tiny
    images, boxes, mask = _region_inputs(cfg)
    port = torch_parity.port_clip(cfg, params)
    s = cfg.vision.image_size
    with torch.no_grad():
        dense = encode_patches(port, _t(images), _t(boxes), _t(mask), s)
        compact = encode_patches_compact(port, _t(images), _t(boxes), _t(mask), s, budget)
    if budget >= int(mask.sum()):
        np.testing.assert_allclose(compact.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)
    else:
        assert not compact[3, 2].any() and compact[3, 1].any()
    for valid in (0, 1, 7, 9, 12):
        assert patch_budget(valid, B * P) == jax_patch_budget(valid, B * P)


# -- the slice: DistillTrainer's teacher targets and uncached step ----------------


@pytest.fixture(scope="module")
def slice_setup(tiny):
    from dclip_tpu.models.teacher import PatchTextAggregation as JaxPatchTextAggregation
    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu_torch.cli.common import synthetic_distill_batch

    cfg, _, params = tiny
    t = cfg.text.max_length
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=t)
    tparams = torch_parity.jax_teacher_params(cfg.projection_dim, seed=2)
    assert set(tparams["cross_modal_attention"]) == set(JaxPatchTextAggregation(tcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, t, 16)), jnp.zeros((1, P, 16)))["params"]
        ["cross_modal_attention"])
    dcfg = DistillConfig(phase1_epochs=1, train_batch_size=B, learning_rate=1e-3,
                         warmup_steps=1, accumulate_grad_batches=1, teacher=tcfg,
                         student_model="tiny", teacher_clip_model="tiny", use_pallas=True,
                         compute_dtype="float32", packed_text=True, compact_patches=True)
    batch = synthetic_distill_batch(cfg, tcfg, B, np.random.RandomState(7))
    images, boxes, mask = _region_inputs(cfg)
    batch.update(teacher_pixels=images, boxes=boxes, box_mask=mask,
                 index=np.arange(B, dtype=np.int64))
    mesh1 = make_mesh(MeshConfig(data_parallel=1, model_parallel=1),
                      devices=jax.devices("cpu")[:1])
    jt = JaxDistillTrainer(dcfg, {"params": params}, {"params": params}, tparams, cfg, cfg,
                           mesh=mesh1)
    init_state = (jax.device_get(jt.state), jax.tree_util.tree_map(lambda a: a.sharding,
                                                                   jt.state))
    return dict(cfg=cfg, params=params, tparams=tparams, dcfg=dcfg, batch=batch, jt=jt,
                init_state=init_state)


def _port_trainer(s, cache=None, **changes):
    cfg = s["cfg"]
    sd = state_dict_from_jax(s["params"], cfg)
    return DistillTrainer(dataclasses.replace(s["dcfg"], **changes), sd, sd,
                          teacher_state_dict_from_jax(s["tparams"]), cfg, cfg, device="cpu",
                          teacher_cache=cache)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernels", "module"])
def test_miss_path_targets_match_jax_teacher_targets(slice_setup, use_pallas):
    """The compacted miss path (7 valid of 12 slots: budget 9) and the
    plain path both equal the JAX `_teacher_targets`, which encodes every
    slot."""
    s = slice_setup
    jt, batch = s["jt"], s["batch"]
    want = jt._teacher_targets(jt.teacher_clip_variables, jt.teacher_params,
                               jt._device_batch(batch))
    tr = _port_trainer(s, use_pallas=use_pallas)
    assert tr._compact and (tr._xattn is not None) == use_pallas
    device_batch = tr._device_batch(batch, tr._STUDENT_FIELDS + tr._TEACHER_FIELDS)
    got = tr._get_teacher_targets(batch, device_batch)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EMB_TOL)


def test_uncached_step_matches_jax_train_step(slice_setup):
    """One uncached step (teacher targets, then one AdamW update): the loss
    parts and every parameter after the update."""
    s = slice_setup
    jt, cfg = s["jt"], s["cfg"]
    jt.state = jax.device_put(*s["init_state"])
    want = jt.train_step_on_batch(s["batch"])
    params = state_dict_from_jax(jax.device_get(jt.state.params), cfg)
    jt.state = jax.device_put(*s["init_state"])
    tr = _port_trainer(s)
    got = tr.train_step_on_batch(s["batch"])
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert tr.optimizer.count == 1
    for name, p in tr.student.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].reshape(p.shape).numpy(),
                                   err_msg=name, **EMB_TOL)


def test_eval_loss_matches_jax(slice_setup):
    s = slice_setup
    jt = s["jt"]
    jt.state = jax.device_put(*s["init_state"])
    want = jt.eval_loss_on_batch(s["batch"])
    got = _port_trainer(s).eval_loss_on_batch(s["batch"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_knn_gate_targets_match_jax(slice_setup):
    """With a k-NN store the patch embeddings go through the gate first."""
    from dclip_tpu.data.embedding_store import EmbeddingStore as JaxStore
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    s = slice_setup
    cfg = s["cfg"]
    rng = np.random.RandomState(8)
    keys = rng.standard_normal((6, cfg.projection_dim)).astype(np.float32)
    stores = []
    for cls in (JaxStore, EmbeddingStore):
        st = cls(dim=cfg.projection_dim)
        st.add_batch([str(i) for i in range(6)], keys, keys[::-1].copy())
        stores.append(st)
    jt = JaxDistillTrainer(s["dcfg"], {"params": s["params"]}, {"params": s["params"]},
                           s["tparams"], cfg, cfg, mesh=s["jt"].mesh, knn_store=stores[0])
    want = jt._teacher_targets(jt.teacher_clip_variables, jt.teacher_params,
                               jt._device_batch(s["batch"]))
    sd = state_dict_from_jax(s["params"], cfg)
    tr = DistillTrainer(s["dcfg"], sd, sd, teacher_state_dict_from_jax(s["tparams"]), cfg, cfg,
                        device="cpu", knn_store=stores[1])
    got = tr._teacher_targets(tr._device_batch(s["batch"]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EMB_TOL)


def test_projection_gate_step_matches_jax(slice_setup):
    """With `projection_params` and a store that no patch reaches (threshold
    0.999), every valid slot takes the projection head's output (source 1,
    positions = the boxes over the teacher frame): the targets and one
    uncached step's update equal the JAX trainer's."""
    from dclip_tpu.data.embedding_store import EmbeddingStore as JaxStore
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.models.weights import projection_state_dict_from_jax

    s = slice_setup
    cfg = s["cfg"]
    d = cfg.projection_dim
    keys = np.random.RandomState(10).standard_normal((6, d)).astype(np.float32)
    stores = []
    for cls in (JaxStore, EmbeddingStore):
        st = cls(dim=d)
        st.add_batch([str(i) for i in range(6)], keys)
        stores.append(st)
    pparams = torch_parity.jax_projection_params(d, seed=11)
    dcfg = dataclasses.replace(s["dcfg"], teacher=dataclasses.replace(
        s["dcfg"].teacher, similarity_threshold=0.999))
    jt = JaxDistillTrainer(dcfg, {"params": s["params"]}, {"params": s["params"]},
                           s["tparams"], cfg, cfg, mesh=s["jt"].mesh, knn_store=stores[0],
                           projection_params=pparams)
    want_targets = jt._teacher_targets(jt.teacher_clip_variables, jt.teacher_params,
                                       jt._device_batch(s["batch"]))
    want = jt.train_step_on_batch(s["batch"])
    params = state_dict_from_jax(jax.device_get(jt.state.params), cfg)
    sd = state_dict_from_jax(s["params"], cfg)
    tr = DistillTrainer(dcfg, sd, sd, teacher_state_dict_from_jax(s["tparams"]), cfg, cfg,
                        device="cpu", knn_store=stores[1],
                        projection_params=projection_state_dict_from_jax(pparams))
    batch = tr._device_batch(s["batch"])
    for g, w in zip(tr._teacher_targets(batch), want_targets):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **EMB_TOL)
    pe = tr._encode_patches_only(batch)
    frame = batch["teacher_pixels"].shape[1]
    res = knn.knn_or_projection(pe.reshape(-1, d), (batch["boxes"] / frame).reshape(-1, 4),
                                tr._knn_keys, tr._knn_values, tr._projection_fn, 0.999)
    valid = batch["box_mask"].reshape(-1) > 0
    assert (res.source[valid] == knn.SOURCE_PROJECTION).all()
    got = tr.train_step_on_batch(s["batch"])
    for name in want:
        np.testing.assert_allclose(got[name].item(), float(want[name]), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name, p in tr.student.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), params[name].reshape(p.shape).numpy(),
                                   err_msg=name, **EMB_TOL)


def test_three_cache_levels(slice_setup):
    """A miss fills every level; a repeat hits the device full level; the
    same images with resampled captions hit the device patch-embedding
    level, and a second trainer on the same host cache hits the host pe
    level: each gives the targets a cache-less trainer computes."""
    s = slice_setup
    batch = s["batch"]
    resampled = dict(batch, input_ids=np.roll(batch["input_ids"], 1, axis=0),
                     attention_mask=np.roll(batch["attention_mask"], 1, axis=0))
    fresh = _port_trainer(s)
    want = fresh._get_teacher_targets(resampled, fresh._device_batch(resampled))
    cache = TeacherTargetCache()
    tr = _port_trainer(s, cache=cache)
    tr.train_step_on_batch(batch)
    assert len(tr._dev_full) == B and len(tr._dev_pe) == B
    tr.train_step_on_batch(batch)
    assert tr._dev_full.hits == 1 and tr._dev_pe.hits == 0
    got = tr._get_teacher_targets(resampled, tr._device_batch(resampled), probe_full=False)
    assert tr._dev_pe.hits == 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
    other = _port_trainer(s, cache=cache)  # same salt: the same teacher
    got = other._get_teacher_targets(resampled, other._device_batch(resampled),
                                     probe_full=False)
    assert other._dev_pe.hits == 0 and len(other._dev_pe) == B  # host pe hit, promoted
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=1e-7)
