"""The port's meta-teacher training path against the JAX package on the CPU,
at `CLIPConfig.tiny_test()`:

- `kernels.cross_attention_trainable` against the JAX
  `cross_attention_trainable(..., interpret=True)` on the same weights
  (bridged by `models.weights.teacher_state_dict_from_jax`): the forward
  within atol 1e-5, every parameter gradient and both input gradients
  within rtol 1e-4 / atol 1e-6, with both masks, one mask, none, and an
  all-invalid image row (mirrors `tests/test_kernels.py:110`);
- `train.optim.pattern_mask`: the trainable set over the torch names is
  the JAX one over the Flax paths;
- `TeacherTrainer` against the JAX `TeacherTrainer` (one-device CPU mesh,
  `use_pallas=True`, f32, the same CLIP and teacher weights): the loss and
  the parameters after 1 and 2 steps, with gradient accumulation 2, only
  the cross-attention moving, `eval_loss_on_batch`, the k-NN gate, the pe
  cache and its device level (hits equal misses; no region encode on a
  hit), and `fit` + `resume` bit-exact through `CheckpointManager`.

Parameters after the Adam steps are held at rtol 1e-5. The k_proj biases
are the exception: their gradient is zero in exact arithmetic (a key bias
adds the same q . b_k to every logit of a row, and softmax ignores it), so
both frameworks hold rounding noise there, and Adam's normalisation turns
noise into steps of about lr. They are held within 2 lr per step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig, MeshConfig, TeacherConfig, TeacherTrainConfig
from dclip_tpu_torch.kernels import cross_attention as xa
from dclip_tpu_torch.models.weights import state_dict_from_jax, teacher_state_dict_from_jax
from dclip_tpu_torch.train import TeacherTrainer, masked_mean
from dclip_tpu_torch.train.checkpoint import CheckpointManager
from dclip_tpu_torch.train.distill_trainer import TeacherTargetCache

import torch_parity

B, P = 8, 3
LR = 1e-3
FWD_TOL = dict(rtol=0, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_TOL = dict(rtol=1e-5, atol=0)
PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
PREFIX = "cross_modal_attention."


def _t(a):
    return torch.from_numpy(np.array(a))


# -- cross_attention_trainable ---------------------------------------------------------

XB, XT, XP, XD, XH = 3, 7, 5, 16, 4
MASKS = ["both", "text_only", "image_only", "none", "all_invalid_image_row"]


def _xattn_inputs(case, seed=0):
    rng = np.random.RandomState(seed)
    text = rng.standard_normal((XB, XT, XD)).astype(np.float32)
    image = rng.standard_normal((XB, XP, XD)).astype(np.float32)
    tmask = (np.arange(XT)[None] < np.array([[7], [4], [2]])).astype(np.float32)
    imask = (rng.rand(XB, XP) > 0.3).astype(np.float32)
    imask[:, 0] = 1.0
    if case == "all_invalid_image_row":
        imask[1] = 0.0
    masks = {"both": (tmask, imask), "text_only": (tmask, None), "image_only": (None, imask),
             "none": (None, None), "all_invalid_image_row": (tmask, imask)}[case]
    return text, image, masks, rng


@pytest.mark.parametrize("case", MASKS)
def test_cross_attention_trainable_matches_jax(case):
    from dclip_tpu.kernels.cross_attention import cross_attention_trainable as jax_xattn

    text, image, (tm, im), rng = _xattn_inputs(case)
    jparams = torch_parity.jax_teacher_params(XD, seed=3)["cross_modal_attention"]
    g_t = rng.standard_normal(text.shape).astype(np.float32)
    g_i = rng.standard_normal(image.shape).astype(np.float32)
    jm = [None if m is None else jnp.asarray(m) for m in (tm, im)]

    def f(p, t, i):
        return jax_xattn(p, t, i, *jm, num_heads=XH, interpret=True)

    (want_t, want_i), vjp = jax.vjp(f, jparams, jnp.asarray(text), jnp.asarray(image))
    jg_p, jg_t, jg_i = vjp((jnp.asarray(g_t), jnp.asarray(g_i)))

    sd = teacher_state_dict_from_jax({"cross_modal_attention": jparams})
    params = {k[len(PREFIX):]: v.clone().requires_grad_() for k, v in sd.items()}
    t, i = _t(text).requires_grad_(), _t(image).requires_grad_()
    at, ai = xa.cross_attention_trainable(params, t, i, *(None if m is None else _t(m)
                                                         for m in (tm, im)), num_heads=XH)
    np.testing.assert_allclose(at.detach().numpy(), np.asarray(want_t), **FWD_TOL)
    np.testing.assert_allclose(ai.detach().numpy(), np.asarray(want_i), **FWD_TOL)
    names = list(params)
    grads = torch.autograd.grad((at, ai), [t, i] + [params[n] for n in names],
                                (_t(g_t), _t(g_i)))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jg_t), **GRAD_TOL)
    np.testing.assert_allclose(grads[1].numpy(), np.asarray(jg_i), **GRAD_TOL)
    want = teacher_state_dict_from_jax({"cross_modal_attention": jax.device_get(jg_p)})
    assert len(names) == 12
    for name, g in zip(names, grads[2:]):
        np.testing.assert_allclose(g.numpy(), want[PREFIX + name].numpy(), err_msg=name,
                                   **GRAD_TOL)
    if case == "all_invalid_image_row":  # text queries of the boxless row: finite
        assert torch.isfinite(at[1]).all() and torch.isfinite(grads[0]).all()


def test_cross_attention_trainable_packs_live_weights():
    """The forward reads the parameters at call time, and a CPU call counts
    no kernel launch."""
    text, image, (tm, im), _ = _xattn_inputs("both")
    sd = teacher_state_dict_from_jax(torch_parity.jax_teacher_params(XD, seed=3))
    params = {k[len(PREFIX):]: v.clone() for k, v in sd.items()}
    xa.reset_launches()
    before = xa.cross_attention_trainable(params, _t(text), _t(image), _t(tm), _t(im), XH)
    with torch.no_grad():
        params["norm_text.bias"].add_(1.0)
    after = xa.cross_attention_trainable(params, _t(text), _t(image), _t(tm), _t(im), XH)
    torch.testing.assert_close(after[0], before[0] + 1.0, rtol=0, atol=1e-5)
    assert torch.equal(after[1], before[1])
    assert set(xa.LAUNCHES.values()) == {0}


# -- the trainer ---------------------------------------------------------------------


def _batches(cfg, n=2, seed=0):
    """Host batches with captions of several lengths, random boxes, a row
    with no valid box, and per-item ids."""
    rng = np.random.RandomState(seed)
    t, s, eos = cfg.text.max_length, cfg.vision.image_size, cfg.text.eos_token_id
    out = []
    for bi in range(n):
        ids = rng.randint(1, eos - 2, size=(B, t)).astype(np.int32)
        mask = np.zeros((B, t), np.int32)
        for r, length in enumerate(rng.randint(3, t + 1, size=B)):
            ids[r, length - 1] = eos
            ids[r, length:] = 0
            mask[r, :length] = 1
        boxes = rng.rand(B, P, 4).astype(np.float32) * (s / 2)
        boxes[..., 2:] += boxes[..., :2] + 2
        box_mask = (rng.rand(B, P) > 0.25).astype(np.float32)
        box_mask[:, 0] = 1.0
        box_mask[3] = 0.0
        out.append({"input_ids": ids, "attention_mask": mask,
                    "teacher_pixels": rng.rand(B, s, s, 3).astype(np.float32),
                    "boxes": boxes, "box_mask": box_mask,
                    "conf": rng.rand(B, P).astype(np.float32),
                    "index": np.arange(bi * B, (bi + 1) * B, dtype=np.int64)})
    return out


@pytest.fixture(scope="module")
def setup():
    cfg = CLIPConfig.tiny_test()
    params = torch_parity.jax_clip_fan_in(cfg)
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=cfg.text.max_length)
    tcfg_train = TeacherTrainConfig(epochs=2, batch_size=B, learning_rate=LR, teacher=tcfg,
                                    clip_model="tiny", use_pallas=True,
                                    compute_dtype="float32", compact_patches=True)
    tparams = torch_parity.jax_teacher_params(cfg.projection_dim, seed=2)
    return dict(cfg=cfg, params=params, tparams=tparams, tcfg=tcfg_train,
                batches=_batches(cfg))


def _mesh1():
    from dclip_tpu.parallel.mesh import make_mesh

    return make_mesh(MeshConfig(data_parallel=1, model_parallel=1),
                     devices=jax.devices("cpu")[:1])


def _jax_trainer(s, **kw):
    from dclip_tpu.train.teacher_trainer import TeacherTrainer as JaxTeacherTrainer

    cfg = dataclasses.replace(s["tcfg"], **kw.pop("changes", {}))
    return JaxTeacherTrainer(cfg, {"params": s["params"]}, s["cfg"], mesh=_mesh1(),
                             teacher_params=s["tparams"], **kw)


def _port_trainer(s, changes=None, **kw):
    cfg = dataclasses.replace(s["tcfg"], **(changes or {}))
    return TeacherTrainer(cfg, state_dict_from_jax(s["params"], s["cfg"]), s["cfg"],
                          teacher_state_dict_from_jax(s["tparams"]), device="cpu", **kw)


def _assert_params_match(tr, jt, steps, what):
    want = teacher_state_dict_from_jax(jax.device_get(jt.state.params))
    d = tr.cfg.teacher.embed_dim
    for name, p in tr.teacher.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("in_proj_bias"):  # q | k | v: k_proj's bias is noise-driven
            np.testing.assert_array_less(np.abs(got[d:2 * d] - ref[d:2 * d]), 2 * LR * steps)
            got, ref = np.concatenate([got[:d], got[2 * d:]]), np.concatenate([ref[:d],
                                                                               ref[2 * d:]])
        np.testing.assert_allclose(got, ref, err_msg=f"{what}: {name}", **PARAM_TOL)


@pytest.mark.parametrize("accumulate", [1, 2], ids=["accumulate_1", "accumulate_2"])
def test_steps_match_jax(setup, accumulate):
    """Two steps on two batches: the losses and, after each step, every
    parameter; with accumulation 2 the parameters move on the second."""
    changes = {"gradient_accumulation": accumulate}
    jt = _jax_trainer(setup, changes=changes)
    tr = _port_trainer(setup, changes)
    assert tr._frozen_image_features is not None and tr._compact
    start = {n: p.detach().clone() for n, p in tr.teacher.named_parameters()}
    for step, batch in enumerate(setup["batches"], start=1):
        want = jt.train_step_on_batch(batch)
        got = tr.train_step_on_batch(batch)
        assert set(got) == set(want) == {"loss", "contrastive_loss"}
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **LOSS_TOL)
        _assert_params_match(tr, jt, step, f"step {step}")
        moved = any(not torch.equal(p, start[n]) for n, p in tr.teacher.named_parameters())
        assert moved == (step % accumulate == 0)
    assert tr.step == 2 and tr.optimizer.count == 2 // accumulate


def test_trainable_set_matches_jax_pattern_mask(setup):
    """pattern_mask over the torch names marks the parameters the JAX mask
    marks over the Flax paths, mapped through the weight bridge, for the
    default patterns and for narrower ones ("proj" matches every torch
    name, since q / k / v live in `in_proj_*`; "norm" only the LayerNorms)."""
    from dclip_tpu.train.optim import pattern_mask as jax_pattern_mask
    from dclip_tpu_torch.train.optim import pattern_mask

    tparams = setup["tparams"]
    names = list(teacher_state_dict_from_jax(tparams))
    for patterns in (setup["tcfg"].trainable_patterns, ("norm",), ("out_proj", "norm_text")):
        jmask = jax_pattern_mask(tparams, patterns)
        marked = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                        jmask, tparams)
        want = {k for k, v in teacher_state_dict_from_jax(marked).items() if v.all()}
        partial = {k for k, v in teacher_state_dict_from_jax(marked).items()
                   if v.any() and not v.all()}
        got = {k for k, v in pattern_mask(names, patterns).items() if v}
        assert not partial and got == want, patterns
    n_jax = len(jax.tree_util.tree_leaves(tparams))
    assert (len(names), n_jax) == (12, 20)


def test_only_the_cross_attention_moves(setup):
    """Every teacher parameter moves; the CLIP does not (no gradient reaches
    it: its parameters have no .grad)."""
    tr = _port_trainer(setup, {"learning_rate": 1e-2})
    before = {n: p.detach().clone() for n, p in tr.teacher.named_parameters()}
    clip_before = {n: p.detach().clone() for n, p in tr.clip.named_parameters()}
    for batch in setup["batches"]:
        tr.train_step_on_batch(batch)
    assert all(not torch.equal(p, before[n]) for n, p in tr.teacher.named_parameters())
    assert all(torch.equal(p, clip_before[n]) and p.grad is None
               for n, p in tr.clip.named_parameters())


def test_eval_loss_matches_jax(setup):
    jt, tr = _jax_trainer(setup), _port_trainer(setup)
    for batch in setup["batches"]:
        np.testing.assert_allclose(tr.eval_loss_on_batch(batch), jt.eval_loss_on_batch(batch),
                                   **LOSS_TOL)


def test_module_path_matches_kernel_path(setup):
    """With the kernels off the loss runs the module (`PatchTextAggregation`):
    the same loss as the kernel path on the CPU twins."""
    batch = setup["batches"][0]
    a = _port_trainer(setup).eval_loss_on_batch(batch)
    b = _port_trainer(setup, {"use_pallas": False, "compact_patches": False})
    assert b._frozen_image_features is None
    np.testing.assert_allclose(b.eval_loss_on_batch(batch), a, rtol=1e-5)


def test_knn_gate_matches_jax(setup):
    """A store whose keys are near the raw patch embeddings and a
    threshold of -1: every valid slot takes a stored value (`:477`)."""
    from dclip_tpu.data.embedding_store import EmbeddingStore as JaxStore
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    cfg = setup["cfg"]
    batch = setup["batches"][0]
    rng = np.random.RandomState(7)
    keys = rng.standard_normal((10, cfg.projection_dim)).astype(np.float32)
    values = rng.standard_normal((10, cfg.projection_dim)).astype(np.float32)
    stores = []
    for cls in (JaxStore, EmbeddingStore):
        st = cls(dim=cfg.projection_dim)
        st.add_batch([f"s{i}" for i in range(10)], keys, values=values)
        stores.append(st)
    changes = {"teacher": dataclasses.replace(setup["tcfg"].teacher, similarity_threshold=-1.0)}
    jt = _jax_trainer(setup, changes=changes, knn_store=stores[0])
    tr = _port_trainer(setup, changes, knn_store=stores[1])
    want = np.asarray(jt._patch_embeddings(batch, jt._device_batch(batch)))
    got = tr._patch_embeddings(batch, tr._device_batch(batch, tr._LOSS_FIELDS))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    valid = batch["box_mask"] > 0
    dists = np.linalg.norm(got.numpy()[valid][:, None] - values[None], axis=-1)
    assert (dists.min(axis=1) < 1e-5).all() and not got.numpy()[~valid].any()
    np.testing.assert_allclose(tr.eval_loss_on_batch(batch), jt.eval_loss_on_batch(batch),
                               **LOSS_TOL)


def test_projection_gate_matches_jax(setup):
    """With `projection_params` and a threshold no patch reaches, every valid
    slot takes the projection head's output (source 1): the gated patch
    embeddings and one step's update equal the JAX trainer's."""
    from dclip_tpu.data.embedding_store import EmbeddingStore as JaxStore
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.models.weights import projection_state_dict_from_jax

    cfg = setup["cfg"]
    batch = setup["batches"][0]
    keys = np.random.RandomState(8).standard_normal((10, cfg.projection_dim)).astype(np.float32)
    stores = []
    for cls in (JaxStore, EmbeddingStore):
        st = cls(dim=cfg.projection_dim)
        st.add_batch([f"s{i}" for i in range(10)], keys)
        stores.append(st)
    pparams = torch_parity.jax_projection_params(cfg.projection_dim, seed=9)
    changes = {"teacher": dataclasses.replace(setup["tcfg"].teacher, similarity_threshold=1.5)}
    jt = _jax_trainer(setup, changes=changes, knn_store=stores[0], projection_params=pparams)
    tr = _port_trainer(setup, changes, knn_store=stores[1],
                       projection_params=projection_state_dict_from_jax(pparams))
    want = np.asarray(jt._patch_embeddings(batch, jt._device_batch(batch)))
    got = tr._patch_embeddings(batch, tr._device_batch(batch, tr._LOSS_FIELDS))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    valid = batch["box_mask"] > 0
    np.testing.assert_allclose(np.linalg.norm(got.numpy()[valid], axis=-1), 1.0, rtol=1e-5)
    jt.train_step_on_batch(batch)
    tr.train_step_on_batch(batch)
    _assert_params_match(tr, jt, 1, "projection gate")


@pytest.mark.parametrize("device_level", [False, True], ids=["host_only", "device_level"])
def test_pe_cache_hits_equal_misses(setup, monkeypatch, device_level):
    """The pe cache (and its device level in front): the first pass misses
    and fills the levels, the second hits with the same losses and never
    calls the region encode (`:659`, `:1024`); a second trainer on the same
    host cache hits it and promotes to its own device level."""
    import dclip_tpu_torch.train.teacher_trainer as tt

    cache = TeacherTargetCache()
    tr = _port_trainer(setup, {"device_target_cache": device_level}, pe_cache=cache)
    plain = _port_trainer(setup)
    assert cache.salt and (tr._dev_pe is not None) == device_level
    misses = [tr.eval_loss_on_batch(b) for b in setup["batches"]]
    assert len(cache._mem) == 2 * B
    calls = []
    real = tt.budgeted_patch_encode
    monkeypatch.setattr(tt, "budgeted_patch_encode",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    hits = [tr.eval_loss_on_batch(b) for b in setup["batches"]]
    assert not calls and hits == misses
    for b, m in zip(setup["batches"], misses):
        np.testing.assert_allclose(plain.eval_loss_on_batch(b), m, rtol=1e-6)
    calls.clear()  # the cache-less trainer encodes
    if device_level:
        assert tr._dev_pe.hits == 2 and len(tr._dev_pe) == 2 * B
        other = _port_trainer(setup, {"device_target_cache": True}, pe_cache=cache)
        assert [other.eval_loss_on_batch(b) for b in setup["batches"]] == misses
        assert other._dev_pe.hits == 0 and len(other._dev_pe) == 2 * B and not calls


def test_pe_cache_step_matches_jax_pe_cache_step(setup):
    """Two epochs of steps with a pe cache on both sides: epoch 1 is served
    from the caches, and both stay equal."""
    from dclip_tpu.train.distill_trainer import TeacherTargetCache as JaxCache

    jt = _jax_trainer(setup, pe_cache=JaxCache())
    tr = _port_trainer(setup, pe_cache=TeacherTargetCache())
    for step, batch in enumerate(setup["batches"] * 2, start=1):
        want, got = jt.train_step_on_batch(batch), tr.train_step_on_batch(batch)
        np.testing.assert_allclose(got["loss"].item(), float(want["loss"]), **LOSS_TOL)
    assert tr._dev_pe.hits == 2
    # Four Adam steps: the two frameworks' rounding has compounded past
    # rtol 1e-5 in a few elements, so the tolerance of the student's
    # multi-step checks (tests/test_torch_train.py) holds them.
    want = teacher_state_dict_from_jax(jax.device_get(jt.state.params))
    d = tr.cfg.teacher.embed_dim
    for name, p in tr.teacher.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        if name.endswith("in_proj_bias"):
            got, ref = np.delete(got, np.s_[d:2 * d]), np.delete(ref, np.s_[d:2 * d])
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5, err_msg=name)


class _Pipe:
    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch):
        return iter(self.batches)


def test_fit_and_resume_are_bit_exact(setup, tmp_path):
    """fit over 2 epochs with a val pipeline and a checkpoint per epoch; a
    fresh trainer's `resume` restores step, parameters and Adam state bit
    for bit, and its next update equals the uninterrupted trainer's."""
    changes = {"gradient_accumulation": 2}
    tr = _port_trainer(setup, changes, pe_cache=TeacherTargetCache())
    ckpts = CheckpointManager(str(tmp_path), prefix="teacher", save_top_k=0)
    history = tr.fit(_Pipe(setup["batches"]), _Pipe(setup["batches"][:1]), checkpoints=ckpts)
    assert len(history["val_loss"]) == 2 and tr.step == 4
    assert [(e["epoch"], e["step"]) for e in ckpts._index] == [(0, 2), (1, 4)]
    assert all("_val" in e["path"] for e in ckpts._index)
    fresh = _port_trainer(setup, changes)
    assert fresh.resume(ckpts) == 2 and fresh.step == 4
    for (n, a), (_, b) in zip(tr.teacher.named_parameters(), fresh.teacher.named_parameters()):
        assert torch.equal(a, b), n
    mine, theirs = tr.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert (mine["count"], mine["mini_step"]) == (theirs["count"], theirs["mini_step"]) == (2, 0)
    for key in ("mu", "nu", "acc"):
        assert all(torch.equal(a, b) for a, b in zip(mine[key], theirs[key])), key
    for _ in range(2):
        for t in (tr, fresh):
            t.train_step_on_batch(setup["batches"][1])
    for (n, a), (_, b) in zip(tr.teacher.named_parameters(), fresh.teacher.named_parameters()):
        assert torch.equal(a, b), n
    bad = dict(ckpts.restore(), format="dclip_tpu_torch.DistillTrainer/1")
    with pytest.raises(ValueError, match="TeacherTrainer"):
        fresh.load_checkpoint_state(bad)


def test_masked_mean_and_what_waits(setup):
    from dclip_tpu.train.teacher_trainer import masked_mean as jax_masked_mean

    rng = np.random.RandomState(9)
    x = rng.standard_normal((3, 5, 4)).astype(np.float32)
    mask = np.array([[1, 1, 0, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    np.testing.assert_allclose(masked_mean(_t(x), _t(mask)).numpy(),
                               np.asarray(jax_masked_mean(x, mask)), rtol=1e-6)
    from dclip_tpu_torch.models.projections import init_image_projection

    params = init_image_projection(0, setup["cfg"].projection_dim)[1]
    assert _port_trainer(setup, projection_params=params)._projection_fn is not None
    with pytest.raises(ValueError, match="mesh 2x1 needs 2 devices, have 1"):
        _port_trainer(setup, {"mesh": MeshConfig(data_parallel=2)})
    from dclip_tpu_torch.train.preemption import PreemptionGuard

    tr = _port_trainer(setup, {"epochs": 1})
    with PreemptionGuard() as guard:  # a guard that saw no signal changes nothing
        tr.fit(_Pipe(setup["batches"]), preemption=guard)
    assert tr.step == len(setup["batches"]) and not tr.mesh.distributed
    with pytest.raises(RuntimeError, match="cpu"):
        TeacherTrainer(setup["tcfg"], state_dict_from_jax(setup["params"], setup["cfg"]),
                       setup["cfg"])  # the default device is CUDA
