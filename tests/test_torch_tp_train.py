"""The port's tensor-parallel training (`parallel.tp` in both trainers)
over gloo ranks (tests/torch_dp_worker.py) against the JAX trainers on one
CPU device (XLA route), at `CLIPConfig.tiny_test()`, f32.

Both sides get the same weights (numpy-seeded, through the weight bridge)
and the same global batch; each port rank takes its data rows and its
model slices, with the kernels on (their plain f32 twins on the CPU). The
gradient clip is set low enough to engage (held: the global norm is above
it). Held, at mp = 2, mp = 4 and dp 2 x mp 2, as tests/test_torch_dp_train.py
holds the data-parallel step:
- the first step's loss, rtol 1e-5, and the gradients summed over the
  data group and gathered over the model group, rtol 1e-4;
- the clip's global norm over the model group equal to JAX's over the
  whole gradients;
- the second step's loss, rtol 1e-4, and the trainable parameters after
  two steps within 2 x lr x steps of JAX's;
- every rank's gathered parameters bit-equal, and the replicated
  parameters' gradients bit-equal on every rank (the copy / reduce
  collectives leave nothing to all-reduce again over the model group).
Then the teacher step at mp = 2, checkpoints that cross the model-parallel
size, and `train_distill --multihost --mesh_model 2` against one process.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

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
from dclip_tpu_torch.parallel.tp import param_spec

import torch_dp
import torch_parity

B, P, LR, CLIP = 8, 3, 1e-3, 0.05
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
STEP2_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 2 * LR * 2
MESHES = ((1, 2), (1, 4), (2, 2))  # (data_parallel, model_parallel)

# (name, JAX/port config changes, the batches of the two steps, a teacher cache)
VARIANTS = (
    ("uncached", {}, (0, 1), False),
    # Captions packed per data rank (segment masks in the sharded text
    # tower), empty box slots, and the second step a cache hit.
    ("packed_compact_cached", {"packed_text": True, "compact_patches": True}, (2, 2), True),
)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
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
                       packed_text=False, compact_patches=False, gradient_clip_val=CLIP)
    spec = {"scenario": "distill", "student": str(tmp / "student.pt"),
            "teacher": str(tmp / "teacher.pt"), "teacher_cfg": dataclasses.asdict(tcfg),
            "distill_cfg": dict(distill_cfg, use_pallas=True),
            "batches": torch_dp.save_batches(tmp / "batches.npz", batches),
            "variants": [{"name": n, "changes": c, "steps": list(s), "cache": k}
                         for n, c, s, k in VARIANTS]}
    return dict(tmp=tmp, cfg=cfg, params=params, tparams=tparams, tcfg=tcfg,
                batches=batches, distill_cfg=distill_cfg, spec=spec)


def _jax_distill(setup, changes, cache):
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = setup["cfg"]
    dcfg = DistillConfig(teacher=setup["tcfg"], use_pallas=False,
                         mesh=MeshConfig(data_parallel=1),
                         **dict(setup["distill_cfg"], **changes))
    return DistillTrainer(dcfg, {"params": setup["params"]}, {"params": setup["params"]},
                          setup["tparams"], cfg, cfg,
                          mesh=make_mesh(dcfg.mesh, devices=jax.devices("cpu")[:1]),
                          teacher_cache=TeacherTargetCache(salt="dp-test") if cache else None)


def _jax_student_grads(jt, batch):
    """(loss, gradient tree) of the JAX trainer's student loss at its
    current parameters (tests/test_torch_dp_train.py)."""
    import jax
    import jax.numpy as jnp

    db = jt._device_batch(batch)
    ti, tt = jt._get_teacher_targets(batch, db)
    sb = jt._maybe_pack_text(dict(batch), {k: db[k] for k in jt._STUDENT_FIELDS})
    ti, tt = (jax.device_put(jnp.asarray(np.asarray(x)), jt._batch_sharding) for x in (ti, tt))
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jt._student_loss(p, ti, tt, sb)[0]))(
        jt.state.params)
    return float(loss), jax.device_get(grads)


@pytest.fixture(scope="module")
def jax_runs(setup):
    """Per variant: JAX's first loss and gradients, its two step losses and
    its parameters after them."""
    import jax

    out = {}
    for name, changes, steps, cache in VARIANTS:
        jt = _jax_distill(setup, changes, cache)
        loss1, grads = _jax_student_grads(jt, setup["batches"][steps[0]])
        losses = [float(jt.train_step_on_batch(setup["batches"][i])["loss"]) for i in steps]
        out[name] = dict(loss1=loss1, grads=state_dict_from_jax(grads, setup["cfg"]),
                         losses=losses,
                         params=state_dict_from_jax(jax.device_get(jt.state.params),
                                                    setup["cfg"]))
    return out


@pytest.mark.parametrize("dp,mp", MESHES, ids=[f"dp{d}_mp{m}" for d, m in MESHES])
def test_tp_distill_steps_match_jax(setup, jax_runs, dp, mp):
    """Two steps of the port's `DistillTrainer` on dp x mp gloo ranks
    against JAX `DistillTrainer` on one CPU device (module docstring)."""
    outs = torch_dp.run_ranks(setup["tmp"], f"distill_{dp}x{mp}",
                              dict(setup["spec"], mesh=[dp, mp]), dp * mp)
    for name, *_ in VARIANTS:
        want, got = jax_runs[name], outs[0][name]
        np.testing.assert_allclose(got["losses"][0], want["loss1"], **LOSS_TOL)
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], **LOSS_TOL)
        np.testing.assert_allclose(got["losses"][1], want["losses"][1], **STEP2_TOL)
        assert set(got["grads"]) == set(got["params"])  # the trainable names
        norm = np.sqrt(sum(float((want["grads"][n].double() ** 2).sum()) for n in got["grads"]))
        assert norm > CLIP, f"{name}: the clip does not engage (norm {norm})"
        assert all(o[name]["norm"] == got["norm"] for o in outs[1:])
        np.testing.assert_allclose(got["norm"], norm, rtol=1e-5)
        for name_g, g in got["grads"].items():
            np.testing.assert_allclose(g.numpy(), want["grads"][name_g].reshape(g.shape).numpy(),
                                       err_msg=f"{name} grad {name_g}", **GRAD_TOL)
        for name_p, p in got["params"].items():
            np.testing.assert_allclose(p.numpy(), want["params"][name_p].reshape(p.shape).numpy(),
                                       rtol=0, atol=PARAM_ATOL, err_msg=f"{name} param {name_p}")
        assert len({o[name]["whole_digest"] for o in outs}) == 1, "ranks' parameters differ"
        for o in outs[1:]:
            assert o[name]["losses"] == got["losses"]
        for g_name, g in got["shard_grads"].items():
            if param_spec(g_name) is None:
                assert all(torch.equal(o[name]["shard_grads"][g_name], g) for o in outs[1:]), \
                    f"{name}: replicated gradient {g_name} differs across ranks"


def test_tp_teacher_steps_match_jax(setup):
    """Two steps of the port's `TeacherTrainer` on 2 gloo ranks at mp = 2
    (the frozen CLIP sharded, the cross-attention replicated) against JAX
    `TeacherTrainer` on one device (XLA route): the first step's loss and
    gradients, the second step's loss, the parameters after two steps;
    both ranks bit-equal. Fan-in CLIP weights, as
    tests/test_torch_dp_train.py's teacher test."""
    import jax

    from dclip_tpu.parallel.mesh import make_mesh
    from dclip_tpu.train.teacher_trainer import TeacherTrainer

    cfg, tmp = setup["cfg"], setup["tmp"]
    params = torch_parity.jax_clip_fan_in(cfg, seed=1)
    torch.save(state_dict_from_jax(params, cfg), tmp / "clip_fan_in.pt")
    train_cfg = dict(batch_size=B, learning_rate=LR, clip_model="tiny", compute_dtype="float32",
                     compact_patches=True)
    spec = {"scenario": "teacher", "clip": str(tmp / "clip_fan_in.pt"),
            "teacher": str(tmp / "teacher.pt"), "teacher_cfg": dataclasses.asdict(setup["tcfg"]),
            "train_cfg": dict(train_cfg, use_pallas=True), "steps": [0, 2],
            "batches": str(tmp / "batches.npz"), "mesh": [1, 2]}
    outs = torch_dp.run_ranks(tmp, "teacher_mp2", spec, 2)

    tcfg = TeacherTrainConfig(teacher=setup["tcfg"], use_pallas=False,
                              mesh=MeshConfig(data_parallel=1), **train_cfg)
    jt = TeacherTrainer(tcfg, {"params": params}, cfg,
                        mesh=make_mesh(tcfg.mesh, devices=jax.devices("cpu")[:1]),
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


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)], ids=["dp1_mp2", "dp2_mp2"])
def test_checkpoints_cross_the_model_parallel_size(setup, tmp_path, dp, mp):
    """A checkpoint that `fit` writes at mp = 2 (global rank 0, the gathered
    tensors: the file equals every rank's state) restores at mp = 1, and
    one written at mp = 1 restores at mp = 2, to bit-equal parameters and
    moments; the restored trainers' next steps agree at f32 rounding; the
    moments on the mesh are shard-shaped."""
    spec = dict(setup["spec"], scenario="tp_ckpt", mesh=[dp, mp], ckpt_dir=str(tmp_path / "c"),
                variants=[{"name": "ckpt", "changes": {}, "steps": [0, 1], "cache": False}])
    outs = torch_dp.run_ranks(tmp_path, "ckpt", spec, dp * mp)
    assert outs[0]["file"] == {"params": 0.0, "mu": 0.0, "nu": 0.0, "same": True}
    for out in outs:
        for key in ("to_one", "to_mesh"):
            assert out[key] == {"params": 0.0, "mu": 0.0, "nu": 0.0, "same": True}, key
        np.testing.assert_allclose(out["next_losses"][1], out["next_losses"][0], rtol=1e-5)
        assert out["shard_mu"]["text_model.encoder.layers.0.mlp.fc1.weight"] == (64 // mp, 32)
        assert out["shard_mu"]["text_model.encoder.layers.0.layer_norm1.weight"] == (32,)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from PIL import Image

    from dclip_tpu.data.detection_cache import GridProposalDetector, build_cache

    root = tmp_path_factory.mktemp("tp_cli")
    rng = np.random.RandomState(0)
    items = []
    for i in range(8):
        p = str(root / f"img{i}.png")
        Image.fromarray((rng.rand(40, 48, 3) * 255).astype("uint8")).save(p)
        items.append({"image_path": p, "captions": [f"a photo of thing {i}", f"thing {i}"]})
    (root / "c8_train.json").write_text(json.dumps(items))
    build_cache([it["image_path"] for it in items], GridProposalDetector(),
                str(root / "precache.npz"))
    return root


def test_train_distill_mesh_model_matches_one_process(corpus, tmp_path, capsys):
    """`train_distill --multihost --mesh_model 2 --use_pallas` over 2 gloo
    ranks (each reads every row: one data shard; the kernels' twins, the
    whole-block kernels stepped aside) logs the epoch loss of a
    one-process run on the same corpus, both ranks the same; only rank 0
    writes the checkpoint, whose whole tensors equal the one-process run's
    within 2 x lr x steps."""
    from dclip_tpu_torch.cli import train_distill

    common = ["--train_file", str(corpus / "c8_train.json"), "--detection_cache",
              str(corpus / "precache.npz"), "--max_patches", "4", "--teacher_image_size", "32",
              "--model_preset", "tiny", "--device", "cpu", "--learning_rate", str(LR),
              "--phase1_epochs", "1", "--train_batch_size", "4", "--accumulate_grad_batches",
              "1", "--use_pallas"]
    capsys.readouterr()
    assert train_distill.main(common + ["--checkpoint_dir", str(tmp_path / "one")]) == 0
    want = [float(x) for x in re.findall(r"Epoch \d+: train_loss=(\d+\.\d+)",
                                         capsys.readouterr().out)]
    port = torch_dp.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "dclip_tpu_torch.cli.train_distill", "--multihost",
         "--mesh_model", "2", "--checkpoint_dir", str(tmp_path / "two")] + common,
        env=torch_dp.rank_env(port, 2, r), cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = torch_dp.wait_all(procs)
    got = [[float(x) for x in re.findall(r"Epoch \d+: train_loss=(\d+\.\d+)", o)] for o in outs]
    assert len(want) == 1 and got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=2e-4)
    assert "whole-block kernels (K6 frozen MLP, K8, K9) demoted" in outs[0]
    index = {run: json.loads((tmp_path / run / "checkpoints.json").read_text())
             for run in ("one", "two")}
    assert [(e["epoch"], e["step"]) for e in index["two"]] == [(0, 2)]
    assert len(os.listdir(tmp_path / "two")) == 2  # the index and one checkpoint
    one, two = (torch.load(index[run][0]["path"], weights_only=False)["params"]
                for run in ("one", "two"))
    assert {n: t.shape for n, t in two.items()} == {n: t.shape for n, t in one.items()}
    for name, t in two.items():
        np.testing.assert_allclose(t.numpy(), one[name].numpy(), rtol=0, atol=2 * LR * 2,
                                   err_msg=name)
