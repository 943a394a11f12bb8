"""The port's data-parallel distillation and teacher steps, N ranks in a gloo
group (tests/torch_dp_worker.py), against the JAX trainers on a mesh of N
CPU devices, at `CLIPConfig.tiny_test()`.

Both sides get the same weights (numpy-seeded, through the weight bridge)
and the same global batch; each port rank takes its rows. The JAX trainers
take their XLA route (`use_pallas=False`) on the mesh, f32; the port's run
with the kernels on (their plain f32 twins on the CPU), so the loss is the
distillation-loss kernel's twin over the gathered batch. Held:
- the first step's loss parts, rtol 1e-5;
- the first step's gradients, summed over the ranks before the optimizer,
  rtol 1e-4 (AdamW normalizes a gradient's scale away, so updated
  parameters could agree while the gradients were N times off);
- the second step's loss, rtol 1e-4, and the trainable parameters after
  two steps within 2 x lr x steps of JAX's (AdamW moves an element by about
  lr a step, and one whose gradient is near zero may move either way);
- every rank's parameters bit-equal to rank 0's.
One spawn of N ranks runs every variant."""
import dataclasses

import numpy as np
import pytest
import torch

from dclip_tpu.core.config import (
    CLIPConfig,
    DistillConfig,
    MeshConfig,
    TeacherConfig,
    TeacherTrainConfig,
)
from dclip_tpu_torch.models.weights import state_dict_from_jax, teacher_state_dict_from_jax

import torch_dp
import torch_parity

B, P, LR = 8, 3, 1e-3
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP2_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 2 * LR * 2

# (name, JAX/port config changes, the batches of the two steps, a teacher cache)
VARIANTS = (
    ("uncached", {}, (0, 1), False),
    # Captions packed per rank, empty box slots (the compaction budget is
    # per rank), and the second step a cache hit on every rank.
    ("packed_compact_cached", {"packed_text": True, "compact_patches": True}, (2, 2), True),
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    cfg = CLIPConfig.tiny_test()
    _, params = torch_parity.jax_clip(cfg, seed=0)
    tparams = torch_parity.jax_teacher_params(cfg.projection_dim, seed=3)
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=cfg.text.max_length)
    batches = [torch_dp.distill_batch(cfg, B, P, 0), torch_dp.distill_batch(cfg, B, P, 1),
               torch_dp.distill_batch(cfg, B, P, 2, sparse=True)]
    torch.save(state_dict_from_jax(params, cfg), tmp / "student.pt")
    torch.save(teacher_state_dict_from_jax(tparams), tmp / "teacher.pt")
    distill_cfg = dict(phase1_epochs=1, train_batch_size=B, learning_rate=LR, warmup_steps=0,
                       accumulate_grad_batches=1, student_model="tiny",
                       teacher_clip_model="tiny", compute_dtype="float32",
                       packed_text=False, compact_patches=False)
    spec = {"scenario": "distill", "student": str(tmp / "student.pt"),
            "teacher": str(tmp / "teacher.pt"), "teacher_cfg": dataclasses.asdict(tcfg),
            "distill_cfg": dict(distill_cfg, use_pallas=True),
            "batches": torch_dp.save_batches(tmp / "batches.npz", batches),
            "variants": [{"name": n, "changes": c, "steps": list(s), "cache": k}
                         for n, c, s, k in VARIANTS]}
    return dict(tmp=tmp, cfg=cfg, params=params, tparams=tparams, tcfg=tcfg,
                batches=batches, distill_cfg=distill_cfg, spec=spec)


@pytest.fixture(scope="module", params=[2, 4], ids=["N2", "N4"])
def ranks(request, setup):
    n = request.param
    return n, torch_dp.run_ranks(setup["tmp"], f"distill_{n}", setup["spec"], n)


def _jax_distill(setup, n, changes, cache):
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = setup["cfg"]
    dcfg = DistillConfig(teacher=setup["tcfg"], use_pallas=False,
                         mesh=MeshConfig(data_parallel=n),
                         **dict(setup["distill_cfg"], **changes))
    mesh = make_mesh(dcfg.mesh, devices=jax.devices("cpu")[:n])
    return DistillTrainer(dcfg, {"params": setup["params"]}, {"params": setup["params"]},
                          setup["tparams"], cfg, cfg, mesh=mesh,
                          teacher_cache=TeacherTargetCache(salt="dp-test") if cache else None)


def _jax_student_grads(jt, batch):
    """(loss, gradient tree) of the JAX trainer's student loss at its
    current parameters, with its own teacher targets for `batch` (JAX
    tests/test_mesh_true_paths.py `_student_grads`)."""
    import jax
    import jax.numpy as jnp

    db = jt._device_batch(batch)
    ti, tt = jt._get_teacher_targets(batch, db)
    sb = jt._maybe_pack_text(dict(batch), {k: db[k] for k in jt._STUDENT_FIELDS})
    ti, tt = (jax.device_put(jnp.asarray(np.asarray(x)), jt._batch_sharding) for x in (ti, tt))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jt._student_loss(p, ti, tt, sb)[0]))(
        jt.state.params)
    return float(loss), jax.device_get(grads)


def _hold(cfg, got, want_loss1, want_grads, want_losses, want_params):
    np.testing.assert_allclose(got["losses"][0], want_loss1, **LOSS_TOL)
    np.testing.assert_allclose(got["losses"][0], want_losses[0], **LOSS_TOL)
    np.testing.assert_allclose(got["losses"][1], want_losses[1], **STEP2_TOL)
    grads = state_dict_from_jax(want_grads, cfg)
    params = state_dict_from_jax(want_params, cfg)
    assert set(got["grads"]) == set(got["params"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), grads[name].reshape(g.shape).numpy(),
                                   err_msg=f"grad {name}", **GRAD_TOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), params[name].reshape(p.shape).numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=f"param {name}")


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_distill_steps_match_jax_mesh(setup, ranks, variant):
    """Two steps of the port's `DistillTrainer` on N gloo ranks against JAX
    `DistillTrainer` on an N-device CPU mesh (module docstring)."""
    import jax

    n, outs = ranks
    name, changes, steps, cache = variant
    jt = _jax_distill(setup, n, changes, cache)
    batches = setup["batches"]
    loss1, grads = _jax_student_grads(jt, batches[steps[0]])
    losses = [float(jt.train_step_on_batch(batches[i])["loss"]) for i in steps]
    _hold(setup["cfg"], outs[0][name], loss1, grads, losses, jax.device_get(jt.state.params))
    assert len({o[name]["digest"] for o in outs}) == 1, "ranks' parameters differ"
    for o in outs[1:]:
        assert o[name]["losses"] == outs[0][name]["losses"]


def test_dp_equivalent_on_one_rank_matches_jax(setup):
    """`dp_equivalent=True` without a process group (the gathered loss and
    the gradient reduction as the identity on one rank) against JAX's
    `dp_equivalent` trainer on one device: the first step's loss and
    gradients, the second step's loss."""
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer as JaxDistillTrainer
    from dclip_tpu_torch.core.config import DistillConfig as PortDistillConfig
    from dclip_tpu_torch.core.config import TeacherConfig as PortTeacherConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    cfg, batches = setup["cfg"], setup["batches"]
    changes = {"packed_text": True}
    dcfg = DistillConfig(teacher=setup["tcfg"], use_pallas=False, mesh=MeshConfig(data_parallel=1),
                         **dict(setup["distill_cfg"], **changes))
    jt = JaxDistillTrainer(dcfg, {"params": setup["params"]}, {"params": setup["params"]},
                           setup["tparams"], cfg, cfg,
                           mesh=make_mesh(dcfg.mesh, devices=jax.devices("cpu")[:1]),
                           dp_equivalent=True)
    assert jt._dp_like
    loss1, grads = _jax_student_grads(jt, batches[0])
    losses = [float(jt.train_step_on_batch(b)["loss"]) for b in batches[:2]]

    sd = state_dict_from_jax(setup["params"], cfg)
    pcfg = PortDistillConfig(teacher=PortTeacherConfig(**dataclasses.asdict(setup["tcfg"])),
                             use_pallas=True, **dict(setup["distill_cfg"], **changes))
    tr = DistillTrainer(pcfg, sd, sd, teacher_state_dict_from_jax(setup["tparams"]), cfg, cfg,
                        device="cpu", dp_equivalent=True)
    assert tr._dp and not tr.mesh.distributed
    got = {"losses": [], "grads": None}
    for b in batches[:2]:
        got["losses"].append(float(tr.train_step_on_batch(b)["loss"]))
        if got["grads"] is None:
            got["grads"] = {k: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                            for k, p in tr.student.named_parameters() if p.requires_grad}
    got["params"] = {k: p.detach() for k, p in tr.student.named_parameters() if p.requires_grad}
    _hold(cfg, got, loss1, grads, losses, jax.device_get(jt.state.params))


def test_teacher_steps_match_jax_mesh(setup):
    """Two steps of the port's `TeacherTrainer` on 2 gloo ranks against JAX
    `TeacherTrainer` at dp=2 (XLA route): the first step's loss and its
    gradients summed over the ranks, the second step's loss, the
    parameters after two steps; both ranks bit-equal. The CLIP weights are
    drawn at N(0, 1/fan_in) (`torch_parity.jax_clip_fan_in`): at 0.02 the
    tiny towers give near-identical crops and the gradients sit at the f32
    noise floor."""
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.teacher_trainer import TeacherTrainer

    cfg, tmp, n = setup["cfg"], setup["tmp"], 2
    params = torch_parity.jax_clip_fan_in(cfg, seed=1)
    torch.save(state_dict_from_jax(params, cfg), tmp / "clip_fan_in.pt")
    train_cfg = dict(batch_size=B, learning_rate=LR, clip_model="tiny", compute_dtype="float32",
                     compact_patches=True)
    spec = {"scenario": "teacher", "clip": str(tmp / "clip_fan_in.pt"),
            "teacher": str(tmp / "teacher.pt"), "teacher_cfg": dataclasses.asdict(setup["tcfg"]),
            "train_cfg": dict(train_cfg, use_pallas=True), "steps": [0, 2],
            "batches": str(tmp / "batches.npz")}
    outs = torch_dp.run_ranks(tmp, "teacher_2", spec, n)

    tcfg = TeacherTrainConfig(teacher=setup["tcfg"], use_pallas=False,
                              mesh=MeshConfig(data_parallel=n), **train_cfg)
    jt = TeacherTrainer(tcfg, {"params": params}, cfg,
                        mesh=make_mesh(tcfg.mesh, devices=jax.devices("cpu")[:n]),
                        teacher_params=setup["tparams"])
    batch = setup["batches"][0]
    db = jt._device_batch(batch)
    pe = jt._patch_embeddings(dict(batch), db)
    loss1, grads = jax.jit(jax.value_and_grad(
        lambda p: jt._loss(p, jt.clip_variables, pe, db)[0]))(jt.state.params)
    losses = [float(jt.train_step_on_batch(setup["batches"][i])["loss"]) for i in (0, 2)]
    want_grads = teacher_state_dict_from_jax(jax.device_get(grads))
    want_params = teacher_state_dict_from_jax(jax.device_get(jt.state.params))
    got = outs[0]
    np.testing.assert_allclose(got["losses"][0], float(loss1), **LOSS_TOL)
    np.testing.assert_allclose(got["losses"], losses, **STEP2_TOL)
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g.numpy(), want_grads[name].reshape(g.shape).numpy(),
                                   err_msg=f"grad {name}", **GRAD_TOL)
    for name, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), want_params[name].reshape(p.shape).numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=f"param {name}")
    assert outs[0]["digest"] == outs[1]["digest"]
