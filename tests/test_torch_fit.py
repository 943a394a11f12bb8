"""The port's epochs: `fit` across the unfreeze schedule, checkpoints and
resume (dclip_tpu_torch.train.{base,checkpoint,distill_trainer}).

`fit` in the fused-trainable configuration (K6, K8, K9), with an
`UnfreezeStage` at epoch 1 and with `unfreeze_text_at_epoch=1`, against
the JAX package's `DistillTrainer.fit` on the same weights and batches at
`CLIPConfig.tiny_test()` (per-epoch losses, final parameters); the
student's routing after the stage; the checkpoint manager's index, names
and retention; and a resume that reproduces the uninterrupted run's next
update bit for bit on the CPU."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import (
    CLIPConfig,
    DistillConfig,
    MeshConfig,
    TeacherConfig,
    UnfreezeStage,
)
from dclip_tpu_torch.models.weights import state_dict_from_jax, teacher_state_dict_from_jax
from dclip_tpu_torch.train.checkpoint import CheckpointManager
from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

import torch_parity
from test_torch_train import LOSS_TOL, PARAM_TOL, B, P, _batches, _targets

# Parameters after four AdamW updates of lr 1e-3 (two after the stage's
# fresh optimizer state). A gradient element at the f32 noise floor (~1e-6
# where its neighbours are ~0.05; its sign set by the summation order)
# still moves its parameter by up to lr through Adam's normalisation, and
# the two frameworks' noise differs. So all but a few isolated elements
# (at most 0.05% of them; 7 of 74,625 at this seed) hold PARAM_TOL, and
# every element lies within 2 lr per update of the JAX one. A wrong mask,
# schedule or optimizer reset moves whole tensors by about lr.
NOISE_SHARE = 5e-4
STAGE = {"unfreeze_schedule": (UnfreezeStage(epoch=1, patterns=("mlp", "layer_norm")),)}
TEXT = {"unfreeze_text_at_epoch": 1}


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from dclip_tpu.models.teacher import PatchTextAggregation

    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=5)
    t = cfg.text.max_length
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=t)
    tparams = PatchTextAggregation(tcfg).init(
        jax.random.PRNGKey(1), jnp.zeros((1, t, 16)), jnp.zeros((1, P, 16)))["params"]
    dcfg = DistillConfig(phase1_epochs=2, train_batch_size=B, learning_rate=1e-3,
                         warmup_steps=1, accumulate_grad_batches=1, teacher=tcfg,
                         student_model="tiny", teacher_clip_model="tiny", use_pallas=True,
                         compute_dtype="float32", packed_text=True, fused_text_mlp=True,
                         fused_attn_block=True)
    return dict(cfg=cfg, params=params, tparams=tparams, dcfg=dcfg, batches=_batches(cfg),
                targets=_targets())


class _Pipe:
    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at

    def epoch(self, epoch):
        if epoch == self.fail_at:
            raise RuntimeError("pipeline failed")
        return iter(self.batches)


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


def _jax_fit(setup, **changes):
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu.train.distill_trainer import TeacherTargetCache as JaxCache

    cfg = setup["cfg"]
    mesh1 = make_mesh(MeshConfig(data_parallel=1, model_parallel=1),
                      devices=jax.devices("cpu")[:1])
    cache = JaxCache()
    jt = JaxDistillTrainer(dataclasses.replace(setup["dcfg"], **changes),
                           {"params": setup["params"]}, {"params": setup["params"]},
                           setup["tparams"], cfg, cfg, mesh=mesh1, teacher_cache=cache)
    for b, tg in zip(setup["batches"], setup["targets"]):
        cache.put_batch(cache.keys_for(b), tg)
    history = jt.fit(_Pipe(setup["batches"]))
    return history, state_dict_from_jax(jax.device_get(jt.state.params), cfg)


@pytest.mark.parametrize("changes", [STAGE, TEXT], ids=["stage_mlp_layer_norm", "text_at_1"])
def test_fit_across_an_unfreeze_stage_matches_jax(setup, changes):
    want_history, want_params = _jax_fit(setup, **changes)
    tr = _port_trainer(setup, **changes)
    history = tr.fit(_Pipe(setup["batches"]))
    np.testing.assert_allclose(history["train_loss"], want_history["train_loss"], **LOSS_TOL)
    off = total = 0
    for name, p in tr.student.named_parameters():
        got, want = p.detach().numpy(), want_params[name].reshape(p.shape).numpy()
        off += int((~np.isclose(got, want, **PARAM_TOL)).sum())
        total += got.size
        assert np.abs(got - want).max() <= 2 * 4 * setup["dcfg"].learning_rate, name
    assert off <= NOISE_SHARE * total, (off, total)
    assert tr.step == 4


def test_routing_and_optimizer_after_the_stage(setup):
    """The stage rebuilds the student: K6 goes off once the vision MLP and
    LN2 train (its backward gives them no gradient), K9 and K8 stay; the
    optimizer starts afresh and the step count stays."""
    tr = _port_trainer(setup, **STAGE)
    vision = lambda: tr.student.vision_model.encoder.layers  # noqa: E731
    tr._on_epoch_start(0)
    assert all(lay.fused_frozen_mlp and lay.fused_trainable_attn_block for lay in vision())
    assert not vision()[0].mlp.fc1.weight.requires_grad
    for batch in setup["batches"]:
        tr.train_step_on_batch(batch)
    assert tr.optimizer.count == 2
    tr._on_epoch_start(1)
    assert all(not lay.fused_frozen_mlp and lay.fused_trainable_attn_block for lay in vision())
    assert all(lay.fused_trainable_mlp for lay in tr.student.text_model.encoder.layers)
    lay0 = vision()[0]
    assert lay0.mlp.fc1.weight.requires_grad and lay0.layer_norm1.weight.requires_grad
    assert tr.optimizer.count == 0 and tr.step == 2
    tr.train_step_on_batch(setup["batches"][0])
    assert float(lay0.mlp.fc1.weight.grad.abs().max()) > 0.0
    assert float(lay0.layer_norm1.weight.grad.abs().max()) > 0.0
    before = [p.detach().clone() for p in tr.student.parameters()]
    tr._on_epoch_start(1)  # the same stage again: nothing rebuilt
    assert all(torch.equal(a, b) for a, b in zip(before, tr.student.parameters()))


def test_resume_reproduces_the_uninterrupted_run(setup, tmp_path):
    """Two epochs with a checkpoint each; a fresh trainer's `resume` replays
    the stage and restores step, parameters and optimizer state bit for
    bit; its next update equals the uninterrupted trainer's."""
    tr = _port_trainer(setup, **STAGE)
    ckpts = CheckpointManager(str(tmp_path), save_top_k=2)
    tr.fit(_Pipe(setup["batches"]), checkpoints=ckpts)
    assert [e["step"] for e in ckpts._index] == [2, 4]
    fresh = _port_trainer(setup, **STAGE)
    assert fresh.resume(ckpts) == 2
    assert fresh.step == tr.step == 4 and set(fresh._unfrozen_extra) == {"mlp", "layer_norm"}
    assert not fresh.student.vision_model.encoder.layers[0].fused_frozen_mlp
    for (n, a), (_, b) in zip(tr.student.named_parameters(), fresh.student.named_parameters()):
        assert torch.equal(a, b) and a.requires_grad == b.requires_grad, n
    mine, theirs = tr.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert (mine["count"], mine["mini_step"]) == (theirs["count"], theirs["mini_step"]) == (2, 0)
    for key in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(mine[key], theirs[key])), key
    for t in (tr, fresh):
        t.train_step_on_batch(setup["batches"][1])
    for (n, a), (_, b) in zip(tr.student.named_parameters(), fresh.student.named_parameters()):
        assert torch.equal(a, b), n
    assert fresh.step == 5


def test_resume_without_checkpoints_starts_at_zero(setup, tmp_path):
    tr = _port_trainer(setup)
    assert tr.resume(CheckpointManager(str(tmp_path))) == 0 and tr.step == 0


def test_fit_saves_an_error_checkpoint_and_reraises(setup, tmp_path):
    tr = _port_trainer(setup)
    ckpts = CheckpointManager(str(tmp_path))
    with pytest.raises(RuntimeError, match="pipeline failed"):
        tr.fit(_Pipe(setup["batches"], fail_at=1), checkpoints=ckpts)
    assert [(e["epoch"], e["tag"], e["step"]) for e in ckpts._index] == [(0, None, 2),
                                                                         (None, "error", 2)]
    assert ckpts.latest()["epoch"] == 0
    state = ckpts.restore()
    assert state["step"] == 2 and state["format"] == "dclip_tpu_torch.DistillTrainer/1"


def test_checkpoint_manager_index_names_and_retention(tmp_path):
    d = str(tmp_path / "ck")
    cm = CheckpointManager(d, prefix="p", save_top_k=2)
    for step, val in enumerate((3.0, 1.0, 2.0, 4.0), start=1):
        cm.save({"w": torch.full((2,), float(step)), "step": step}, step=step, epoch=step - 1,
                metrics={"train_loss": val + 1, "val_loss": val})
    # The two best by val_loss, and the newest (the resume point).
    assert sorted(os.listdir(d)) == ["checkpoints.json", "p_epoch1_val1.0000.step2.pt",
                                     "p_epoch2_val2.0000.step3.pt", "p_epoch3_val4.0000.step4.pt"]
    assert cm.latest()["step"] == 4 and cm.best()["metrics"]["val_loss"] == 1.0
    with open(os.path.join(d, "checkpoints.json")) as f:
        assert len(json.load(f)) == 3
    for kind in ("interrupt", "interrupt", "error"):
        cm.save_interrupt({"step": 9}, 9, kind)
    assert sorted(f for f in os.listdir(d) if ".step9" in f) == ["p.error.step9.pt",
                                                               "p.interrupt.step9.pt"]
    reopened = CheckpointManager(d, prefix="p", save_top_k=2)
    assert reopened.latest()["step"] == 4  # tagged checkpoints are no resume point
    state, step = reopened.restore_latest_or_none()
    assert step == 4 and torch.equal(state["w"], torch.full((2,), 4.0))
    assert CheckpointManager(str(tmp_path / "none")).restore_latest_or_none() is None
