"""The port's distillation step in the fused-trainable configuration
(`fused_text_mlp`: K8 in the text tower, `fused_attn_block`: K9 in the
vision tower, beside K6) against the JAX package's `DistillTrainer` with
the same flags, on the CPU at `CLIPConfig.tiny_test()`: the one- and
two-step updates (loss parts, every trainable gradient, the parameters),
as `tests/test_torch_train.py` holds the default configuration. The JAX
trainer runs its Pallas kernels in interpret mode at f32, the port its
plain f32 twins."""
import dataclasses

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig, DistillConfig, MeshConfig, TeacherConfig
from dclip_tpu_torch.models.weights import state_dict_from_jax, teacher_state_dict_from_jax
from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

import torch_parity
from test_torch_train import GRAD_TOL, LOSS_TOL, PARAM_TOL, B, P, _batches, _targets

FUSED = dict(fused_text_mlp=True, fused_attn_block=True)


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from dclip_tpu.models.teacher import PatchTextAggregation
    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu.train.distill_trainer import TeacherTargetCache as JaxCache

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=3)
    t = cfg.text.max_length
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=t)
    tparams = PatchTextAggregation(tcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, t, 16)), jnp.zeros((1, P, 16)))["params"]
    dcfg = DistillConfig(phase1_epochs=1, train_batch_size=B, learning_rate=1e-3,
                         warmup_steps=1, accumulate_grad_batches=2, teacher=tcfg,
                         student_model="tiny", teacher_clip_model="tiny", use_pallas=True,
                         compute_dtype="float32", packed_text=True, **FUSED)
    batches, targets = _batches(cfg), _targets()
    mesh1 = make_mesh(MeshConfig(data_parallel=1, model_parallel=1),
                      devices=jax.devices("cpu")[:1])
    cache = JaxCache()
    jt = JaxDistillTrainer(dcfg, {"params": params}, {"params": params}, tparams, cfg, cfg,
                           mesh=mesh1, teacher_cache=cache)
    for b, tg in zip(batches, targets):
        cache.put_batch(cache.keys_for(b), tg)
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


def test_student_routes_through_k6_k8_and_k9(setup):
    """Every vision layer takes K9 then K6 (its MLP is frozen), every text
    layer its per-op attention then K8, as the JAX student does."""
    jt = setup["jt"]
    assert jt.student.fused_frozen_mlp and jt.student.fused_trainable_text_mlp \
        and jt.student.fused_trainable_attn_block
    student = _port_trainer(setup).student
    for layer in student.vision_model.encoder.layers:
        assert layer.fused_trainable_attn_block and layer.fused_frozen_mlp
        assert not layer.fused_trainable_mlp
    for layer in student.text_model.encoder.layers:
        assert layer.fused_trainable_mlp and not layer.fused_frozen_mlp
        assert layer.self_attn.causal  # so the block kernel never takes it
    plain = _port_trainer(setup, use_pallas=False).student
    assert not any(lay.fused_trainable_attn_block or lay.fused_trainable_mlp
                   for tower in (plain.vision_model, plain.text_model)
                   for lay in tower.encoder.layers)


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "unpacked"])
def test_fused_steps_match_jax_trainer(setup, packed):
    """One and two steps with accumulate_grad_batches=2 in the fused
    configuration: loss parts, every trainable gradient, and the parameters
    after each step (tests/test_torch_train.py's protocol)."""
    import jax

    jt, cfg = setup["jt"], setup["cfg"]
    jt._packed_text = packed
    want_grads = []
    for batch in reversed(setup["batches"]):
        jt.state = jax.device_put(*setup["init_state"])
        jt.train_step_on_batch(batch)
        want_grads.insert(0, jax.device_get(jt.state.opt_state.acc_grads))
    jt.state = jax.device_put(*setup["init_state"])
    tr = _port_trainer(setup, packed_text=packed)
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
