"""The port's cache-warm distillation step (dclip_tpu_torch.train) against
the JAX package's `DistillTrainer` on the CPU, at `CLIPConfig.tiny_test()`.

Both trainers get the same weights (numpy-seeded, through the weight
bridge), the same batches and the same cached teacher targets; the JAX one
runs on a one-device CPU mesh with `use_pallas=True` (its Pallas kernels
in interpret mode) at f32, the port's with the kernels on (their plain f32
twins on the CPU). One JAX trainer serves the module (its state is reset
between cases)."""
import dataclasses

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig, DistillConfig, MeshConfig, TeacherConfig
from dclip_tpu_torch.models.weights import state_dict_from_jax, teacher_state_dict_from_jax
from dclip_tpu_torch.train import optim
from dclip_tpu_torch.train.device_cache import DeviceTargetCache
from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

import torch_parity

B, P = 8, 3
# Loss, gradients and parameters after the steps: f32 on both sides, the
# two frameworks sum in different orders (a few ulps per layer of the
# 2-layer towers), and one AdamW update of lr 1e-3 moves each parameter
# by at most ~1e-3, so its rounding stays far below atol.
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _batches(cfg):
    """Two batches whose captions have the same lengths in another order,
    so both pack into the same row count (one compile per JAX variant)."""
    rng = np.random.RandomState(5)
    t = cfg.text.max_length
    lengths = rng.randint(2, 12, size=B)
    out = []
    for i, order in enumerate((np.arange(B), rng.permutation(B))):
        ids = rng.randint(1, cfg.text.eos_token_id - 2, size=(B, t)).astype(np.int32)
        mask = np.zeros((B, t), np.int32)
        for r, n in enumerate(lengths[order]):
            ids[r, n - 1] = cfg.text.eos_token_id
            ids[r, n:] = 0
            mask[r, :n] = 1
        s = cfg.vision.image_size
        out.append({"pixel_values": rng.standard_normal((B, s, s, 3)).astype(np.float32),
                    "input_ids": ids, "attention_mask": mask,
                    "index": np.arange(B, dtype=np.int64) + 100 * i})
    return out


def _targets(seed=6):
    t = np.random.RandomState(seed).standard_normal((2, B, 2, 16)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from dclip_tpu.models.teacher import PatchTextAggregation
    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu.train.distill_trainer import TeacherTargetCache as JaxCache

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=0)
    t = cfg.text.max_length
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=t)
    tparams = PatchTextAggregation(tcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, t, 16)), jnp.zeros((1, P, 16)))["params"]
    dcfg = DistillConfig(phase1_epochs=1, train_batch_size=B, learning_rate=1e-3,
                         warmup_steps=1, accumulate_grad_batches=2, teacher=tcfg,
                         student_model="tiny", teacher_clip_model="tiny", use_pallas=True,
                         compute_dtype="float32", packed_text=True)
    batches, targets = _batches(cfg), _targets()
    mesh1 = make_mesh(MeshConfig(data_parallel=1, model_parallel=1),
                      devices=jax.devices("cpu")[:1])
    cache = JaxCache()
    jt = JaxDistillTrainer(dcfg, {"params": params}, {"params": params}, tparams, cfg, cfg,
                           mesh=mesh1, teacher_cache=cache)
    for b, tg in zip(batches, targets):
        cache.put_batch(cache.keys_for(b), tg)
    # Host copy of the initial state, and its shardings: putting it back as
    # it was placed keeps the trainer's jitted step from retracing.
    init_state = (jax.device_get(jt.state), jax.tree_util.tree_map(lambda a: a.sharding, jt.state))
    return dict(cfg=cfg, params=params, tparams=tparams, dcfg=dcfg, batches=batches,
                targets=targets, jt=jt, init_state=init_state)


def _port_trainer(setup, **changes):
    cfg = setup["cfg"]
    sd = state_dict_from_jax(setup["params"], cfg)
    cache = TeacherTargetCache()
    tr = DistillTrainer(dataclasses.replace(setup["dcfg"], **changes), sd, sd,
                        teacher_state_dict_from_jax(setup["tparams"]), cfg, cfg, device="cpu",
                        teacher_cache=cache)
    for b, tg in zip(setup["batches"], setup["targets"]):
        cache.put_batch(cache.keys_for(b), tg)
    return tr


def test_trainable_leaf_set_matches_jax_mask(setup):
    """student_trainable_mask over the port's HF names marks exactly the
    leaves the JAX mask marks, mapped through the weight bridge."""
    import jax

    from dclip_tpu.train.optim import student_trainable_mask as jax_mask

    params, cfg = setup["params"], setup["cfg"]
    for extra, freeze_text in (((), False), (("mlp",), False), (("layer_norm",), True)):
        mask = jax_mask(params, extra, freeze_text)
        marked = jax.tree_util.tree_map(
            lambda m, p: np.full(np.shape(p), float(m), np.float32), mask, params)
        want = {k for k, v in state_dict_from_jax(marked, cfg).items()
                if v.reshape(-1)[0].item() == 1.0}
        got = optim.student_trainable_mask(state_dict_from_jax(params, cfg), extra, freeze_text)
        assert {k for k, v in got.items() if v} == want, (extra, freeze_text)
    tr = _port_trainer(setup)
    trainable = {n for n, p in tr.student.named_parameters() if p.requires_grad}
    assert "logit_scale" in trainable and "vision_model.encoder.layers.0.self_attn.q_proj.bias" \
        in trainable
    assert not any(n.startswith("vision_model.") and "proj" not in n for n in trainable)
    assert tr.student.vision_model.encoder.layers[0].fused_frozen_mlp


def _hold_steps_to_jax(setup, jt, init_state, tr):
    """Two steps of the port's trainer `tr` against the JAX trainer `jt`
    from `init_state`: loss parts, every trainable gradient, parameters."""
    import jax

    cfg = setup["cfg"]
    want_grads = []
    for batch in reversed(setup["batches"]):  # the second batch's gradient first
        jt.state = jax.device_put(*init_state)
        jt.train_step_on_batch(batch)
        want_grads.insert(0, jax.device_get(jt.state.opt_state.acc_grads))
    jt.state = jax.device_put(*init_state)
    for step, batch in enumerate(setup["batches"]):
        want = jt.train_step_on_batch(batch)
        got = tr.train_step_on_batch(batch)
        for name in want:
            np.testing.assert_allclose(got[name].item(), float(want[name]), err_msg=name,
                                       **LOSS_TOL)
        grads = state_dict_from_jax(want_grads[step], cfg)
        params = state_dict_from_jax(jax.device_get(jt.state.params), cfg)
        for name, p in tr.student.named_parameters():
            if p.requires_grad:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                np.testing.assert_allclose(g.numpy(), grads[name].reshape(p.shape).numpy(),
                                           err_msg=f"step {step} grad {name}", **GRAD_TOL)
            np.testing.assert_allclose(p.detach().numpy(), params[name].reshape(p.shape).numpy(),
                                       err_msg=f"step {step} param {name}", **PARAM_TOL)
    assert tr.step == 2 and tr.optimizer.count == 1


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_student_steps_match_jax_trainer(setup, packed):
    """One and two student steps with accumulate_grad_batches=2: the loss
    parts, every trainable gradient, and the parameters after each step
    (unchanged after the first, one AdamW update after the second).

    The JAX gradients come from the trainer's own step: with two mini-steps
    per update, the first step from the initial state leaves its raw
    gradient in the MultiSteps accumulator (optax's running mean of one
    value); both steps differentiate at the initial parameters."""
    jt = setup["jt"]
    jt._packed_text = packed
    tr = _port_trainer(setup, packed_text=packed)
    assert ("packed_ids" in jt._maybe_pack_text(setup["batches"][0], {})) == packed
    _hold_steps_to_jax(setup, jt, setup["init_state"], tr)


def test_remat_steps_match_the_jax_remat_trainer(setup):
    """`remat=True` on both sides (JAX: `nn.remat` per encoder layer; the
    port: `torch.utils.checkpoint` per layer), packed text, at the step
    tolerance of the test above."""
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu.train.distill_trainer import TeacherTargetCache as JaxCache

    cfg, params = setup["cfg"], setup["params"]
    mesh1 = make_mesh(MeshConfig(data_parallel=1, model_parallel=1),
                      devices=jax.devices("cpu")[:1])
    cache = JaxCache()
    jt = JaxDistillTrainer(dataclasses.replace(setup["dcfg"], remat=True), {"params": params},
                           {"params": params}, setup["tparams"], cfg, cfg, mesh=mesh1,
                           teacher_cache=cache)
    for b, tg in zip(setup["batches"], setup["targets"]):
        cache.put_batch(cache.keys_for(b), tg)
    assert jt.student.remat
    init_state = (jax.device_get(jt.state), jax.tree_util.tree_map(lambda a: a.sharding, jt.state))
    tr = _port_trainer(setup, remat=True)
    assert tr.student.vision_model.encoder.remat and tr.student.text_model.encoder.remat
    _hold_steps_to_jax(setup, jt, init_state, tr)


def test_cache_miss_raises_not_implemented(setup):
    """A cache miss no longer raises: it computes the teacher targets (those
    of the JAX trainer's miss path, tests/test_torch_teacher.py), with or
    without cache keys; with the k-NN gate's projection head too (its
    numbers against JAX's: tests/test_torch_teacher.py)."""
    cfg = setup["cfg"]
    s = cfg.vision.image_size
    rng = np.random.RandomState(9)
    boxes = rng.rand(B, P, 4).astype(np.float32) * (s / 2)
    boxes[..., 2:] += boxes[..., :2] + 2
    teacher = dict(teacher_pixels=rng.rand(B, s, s, 3).astype(np.float32), boxes=boxes,
                   box_mask=np.ones((B, P), np.float32))
    other = dict(setup["batches"][0], index=np.arange(B, dtype=np.int64) + 7000, **teacher)
    no_ids = {k: v for k, v in other.items() if k != "index"}
    cached = []
    for batch in (other, no_ids):
        tr = _port_trainer(setup)
        metrics = tr.train_step_on_batch(batch)
        assert tr.step == 1 and all(np.isfinite(v.item()) for v in metrics.values())
        cached.append(len(tr.teacher_cache._mem))
    # `other` filled B full targets and B patch-embedding rows (on top of the
    # 2 B rows `_port_trainer` puts); `no_ids` has no keys and put nothing.
    assert cached == [4 * B, 2 * B]
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.models.projections import init_image_projection

    sd = state_dict_from_jax(setup["params"], cfg)
    store = EmbeddingStore.from_arrays(np.eye(3, cfg.projection_dim, dtype=np.float32))
    tr = DistillTrainer(setup["dcfg"], sd, sd, teacher_state_dict_from_jax(setup["tparams"]),
                        cfg, cfg, device="cpu", knn_store=store,
                        projection_params=init_image_projection(0, cfg.projection_dim)[1])
    assert tr._projection_fn is not None
    metrics = tr.train_step_on_batch(no_ids)
    assert tr.step == 1 and all(np.isfinite(v.item()) for v in metrics.values())


@pytest.mark.parametrize("change,error,match", [
    ({"remat": True}, None, None),
    ({"mesh": MeshConfig(data_parallel=2)}, ValueError, "mesh 2x1 needs 2 devices, have 1"),
    ({"mesh": MeshConfig(model_parallel=2)}, ValueError, "mesh 0x2 needs 2 devices, have 1"),
], ids=["remat", "mesh_dp2", "mesh_mp2"])
def test_waiting_options_raise(setup, change, error, match):
    """The K8 / K9 flags and the unfreeze schedule run now
    (tests/test_torch_train_fused.py, tests/test_torch_fit.py), and so
    does `remat` (below). A data axis runs over the ranks of a process
    group (tests/test_torch_dp_train.py), and so does a model axis
    (tests/test_torch_tp_train.py): without one, a mesh of two devices on
    either axis raises JAX's ValueError for a one-device machine."""
    if error is None:
        tr = _port_trainer(setup, **change)
        assert tr.student.vision_model.encoder.remat and tr.student.text_model.encoder.remat
        return
    with pytest.raises(error, match=match):
        _port_trainer(setup, **change)


def _count_layer_forwards(monkeypatch):
    from dclip_tpu_torch.models import clip

    calls = {"n": 0}
    real = clip.EncoderLayer.forward

    def counted(self, *args, **kw):
        calls["n"] += 1
        return real(self, *args, **kw)

    monkeypatch.setattr(clip.EncoderLayer, "forward", counted)
    return calls


@pytest.mark.parametrize("flags", [{}, {"fused_text_mlp": True, "fused_attn_block": True}],
                         ids=["default", "fused"])
def test_remat_keeps_the_numbers_bit_for_bit(setup, flags, monkeypatch):
    """Two steps (one AdamW update) with and without `remat`, through the
    CPU twins of K4 / K5, K6, and with the flags K8 / K9: loss parts,
    gradients and parameters bit-equal. Under remat every layer's forward
    runs twice a step (the backward's recompute), and not under no_grad."""
    cfg = setup["cfg"]
    layers = cfg.vision.num_layers + cfg.text.num_layers
    runs = []
    for remat in (False, True):
        calls = _count_layer_forwards(monkeypatch)
        tr = _port_trainer(setup, remat=remat, **flags)
        metrics = [tr.train_step_on_batch(b) for b in setup["batches"]]
        assert calls["n"] == 2 * layers * (2 if remat else 1)
        runs.append((metrics, {n: (p.detach().clone(), None if p.grad is None else p.grad.clone())
                               for n, p in tr.student.named_parameters()}))
        with torch.no_grad():
            calls["n"] = 0
            tr.student.image_features(torch.from_numpy(setup["batches"][0]["pixel_values"]))
            assert calls["n"] == cfg.vision.num_layers
    (m0, p0), (m1, p1) = runs
    for a, b in zip(m0, m1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for name, (param, grad) in p0.items():
        assert torch.equal(param, p1[name][0]), name
        assert (grad is None and p1[name][1] is None) or torch.equal(grad, p1[name][1]), name


def test_remat_keeps_only_layer_inputs(setup):
    """The activations autograd keeps through the student's forward: with
    remat, only each checkpointed layer's input (and what lies outside the
    layers), a fraction of what it keeps without."""
    batch = setup["batches"][0]
    saved = []
    for remat in (False, True):
        tr = _port_trainer(setup, remat=remat)
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tr.student.image_features(torch.from_numpy(batch["pixel_values"])).sum()
        loss.backward()
        saved.append(sum(nbytes))
    assert saved[1] < 0.5 * saved[0], saved


def test_waiting_entry_points_raise(setup):
    """Checkpoints and resume run (tests/test_torch_fit.py), and so do
    preemption (tests/test_torch_preemption.py) and dp_equivalent
    (tests/test_torch_dp_train.py): a guard that saw no signal changes
    nothing, and `dp_equivalent` takes the data-parallel step on one rank.
    `make_multislice_mesh` runs too (tests/test_torch_tp.py): without a
    process group there is one slice, and it is `make_mesh`'s one-rank
    mesh."""
    from dclip_tpu_torch.parallel.mesh import make_multislice_mesh
    from dclip_tpu_torch.train.preemption import PreemptionGuard

    tr = _port_trainer(setup)
    with PreemptionGuard() as guard:
        assert tr.train_epoch([], preemption=guard) == 0.0
        tr.train_epoch(setup["batches"][:1], preemption=guard)
    assert tr.step == 1 and not guard.requested
    cfg = setup["cfg"]
    sd = state_dict_from_jax(setup["params"], cfg)
    eq = DistillTrainer(setup["dcfg"], sd, sd, teacher_state_dict_from_jax(setup["tparams"]), cfg,
                        cfg, device="cpu", dp_equivalent=True)
    assert eq._dp and not eq.mesh.distributed and eq.is_primary
    assert not _port_trainer(setup, mesh=MeshConfig(data_parallel=-1))._dp
    from dclip_tpu_torch.parallel.mesh import make_mesh

    for config in (MeshConfig(), MeshConfig(data_parallel=1, model_parallel=1)):
        assert make_multislice_mesh(config) == make_mesh(config)
        assert not make_multislice_mesh(config).distributed


def test_fit_runs_the_epochs(setup):
    class Pipe:
        def epoch(self, epoch):
            return iter(setup["batches"])

    tr = _port_trainer(setup, phase1_epochs=2, accumulate_grad_batches=1)
    history = tr.fit(Pipe())
    assert len(history["train_loss"]) == 2 and tr.step == 4
    assert all(np.isfinite(history["train_loss"]))
    assert history["train_loss"][1] < history["train_loss"][0]
    assert tr._dev_full.hits == 2 and len(tr._dev_full) == 2 * B  # epoch 1 hit the device level


def test_masked_adamw_matches_optax():
    """MaskedAdamW == the JAX package's make_optimizer (masked AdamW, clip,
    warmup, MultiSteps) over a few steps, clipping included."""
    import jax.numpy as jnp
    import optax

    from dclip_tpu.train.optim import make_optimizer

    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": ()}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mask = {"a": True, "b": False, "c": True}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (0.01, 3.0, 0.02, 5.0, 0.01, 0.03)]
    tx = make_optimizer(1e-2, mask, warmup_steps=3, grad_clip=0.5, accumulate_steps=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = optim.make_optimizer([tp[k] for k in shapes if mask[k]], 1e-2, warmup_steps=3,
                               grad_clip=0.5, accumulate_steps=2)
    for i, g in enumerate(grads):
        if i == 4:
            g = dict(g, c=np.zeros((), np.float32))  # a leaf the loss did not reach
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k in shapes:
            tp[k].grad = None if (i == 4 and k == "c") else torch.from_numpy(np.asarray(g[k]))
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert opt.count == 3


def test_device_target_cache_roundtrip_and_fifo():
    c = DeviceTargetCache((2, 4), torch.float32, capacity_bytes=6 * 32, device="cpu",
                          min_rows=2, evict=True)
    rows = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    assert c.get(["a"]) is None and c.misses == 1
    c.put(["a", "b", "c"], rows)
    torch.testing.assert_close(c.get(["c", "a"]), rows[[2, 0]])
    c.put(["d", "e", "f", "g"], torch.zeros(4, 2, 4))  # evicts the 1 oldest ("a")
    assert c.get(["a"]) is None and c.evictions == 1 and len(c) == 6
    torch.testing.assert_close(c.get(["b"]), rows[[1]])
    full = DeviceTargetCache((2, 4), torch.float32, 2 * 32, "cpu", min_rows=1)
    full.put(["x", "y", "z"], rows)  # over budget, no eviction: skipped
    assert full.skipped_puts == 1 and len(full) == 0


def test_teacher_target_cache_keys_equal_jax():
    from dclip_tpu.train.distill_trainer import TeacherTargetCache as JaxCache

    batch = _batches(CLIPConfig.tiny_test())[0]
    a, b = TeacherTargetCache(salt="s"), JaxCache(salt="s")
    assert a.keys_for(batch) == b.keys_for(batch)
    assert a.pe_keys_for(batch) == b.pe_keys_for(batch)


def test_resolve_fast_paths():
    from dclip_tpu_torch.core.fast_paths import resolve_fast_paths

    cfg = DistillConfig()
    cuda = resolve_fast_paths(cfg, torch.device("cuda", 0))
    assert (cuda.compute_dtype, cuda.use_pallas, cuda.packed_text, cuda.fused_attn_block) == \
        ("bfloat16", True, True, False)
    cpu = resolve_fast_paths(cfg, torch.device("cpu"))
    assert (cpu.compute_dtype, cpu.use_pallas, cpu.packed_text) == ("float32", False, False)
    explicit = resolve_fast_paths(dataclasses.replace(cfg, use_pallas=False,
                                                      compute_dtype="float32"), "cuda")
    assert (explicit.compute_dtype, explicit.use_pallas) == ("float32", False)


def test_synthetic_distill_batch_equals_jax():
    from dclip_tpu.cli.common import synthetic_distill_batch as jax_batch
    from dclip_tpu_torch.cli.common import synthetic_distill_batch

    for name in ("tiny", "vit-b-16"):
        cfg = CLIPConfig.from_name(name)
        got = synthetic_distill_batch(cfg, TeacherConfig(), 3)
        want = jax_batch(cfg, TeacherConfig(), 3)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_trainable_image_tower_matches_jax_fused_modules(setup):
    """The differentiable image tower (fused attention + frozen-MLP blocks)
    equals the JAX module with the same flags, Pallas in interpret mode."""
    from dclip_tpu.models.clip import CLIPModule as JaxCLIPModule

    cfg, params = setup["cfg"], setup["params"]
    px = torch_parity.pixels(cfg, 3, seed=4)
    jm = JaxCLIPModule(cfg, fused_attention=True, fused_frozen_mlp=True, pallas_interpret=True)
    want = jm.apply({"params": params}, px, method=jm.get_image_features)
    tr = _port_trainer(setup)
    with torch.no_grad():
        got = tr.student.image_features(torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
