"""The port's training CLIs fed from disk, on the CPU, beside the JAX CLIs:
a corpus of PNGs in tmp_path with a `GridProposalDetector` npz cache.

- `dclip_tpu_torch.cli.train_teacher --device cpu --model_preset tiny`
  runs 2 epochs; its checkpoints (names up to the extension and the val
  loss digits, index epochs and steps, metric keys) match
  `dclip_tpu.cli.train_teacher`'s run on the same corpus;
  `--resume` with `--epochs 3` runs epoch 2 only.
- `dclip_tpu_torch.cli.train_distill --teacher_checkpoint <that checkpoint>`
  runs an epoch on the restored teacher: its teacher weights are the
  checkpoint's, and its teacher targets equal those of the module path on
  those weights.

Losses are not compared across the packages here: the JAX CLI initialises
the teacher with `jax.random`, which the port does not reproduce. The
trainer tests (tests/test_torch_teacher_train.py) hold the numbers.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

FLAGS = ["--batch_size", "4", "--learning_rate", "1e-3", "--max_patches", "4",
         "--teacher_image_size", "32", "--model_preset", "tiny", "--pe_cache", "memory"]


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    from PIL import Image

    from dclip_tpu.data.detection_cache import GridProposalDetector, build_cache

    root = tmp_path_factory.mktemp("train_cli")
    rng = np.random.RandomState(0)
    items = []
    for i in range(10):
        p = str(root / f"img{i}.png")
        Image.fromarray((rng.rand(40, 48, 3) * 255).astype("uint8")).save(p)
        items.append({"image_path": p, "captions": [f"a photo of thing {i}", f"thing {i}"]})
    (root / "syn_train.json").write_text(json.dumps(items[:8]))
    (root / "syn_val.json").write_text(json.dumps(items[8:]))
    build_cache([it["image_path"] for it in items], GridProposalDetector(),
                str(root / "precache.npz"))
    return root


def _run(main, root, package, extra):
    out = str(root / package)
    argv = ["--train_file", str(root / "syn_train.json"), "--output_path", out + "/teacher",
            "--detection_cache", str(root / "precache.npz")] + FLAGS + extra
    assert main(argv) == 0
    with open(os.path.join(out, "checkpoints.json")) as f:
        return out, json.load(f)


def _shape(index):
    """Each entry's file name with the val loss digits and the extension
    masked, its epoch, step and metric keys."""
    return [(re.sub(r"val\d+\.\d{4}", "val#", os.path.basename(e["path"])).rsplit(".", 1)[0],
             e["epoch"], e["step"], sorted(e["metrics"]), e["tag"]) for e in index]


@pytest.fixture(scope="module")
def teacher_runs(workspace):
    from dclip_tpu.cli import train_teacher as jax_cli
    from dclip_tpu_torch.cli import train_teacher

    port = _run(train_teacher.main, workspace, "port", ["--device", "cpu", "--epochs", "2"])
    jax_run = _run(jax_cli.main, workspace, "jax", ["--epochs", "2", "--mesh_data", "1"])
    return port, jax_run


def test_train_teacher_checkpoints_match_the_jax_cli(teacher_runs):
    (_, index), (_, jax_index) = teacher_runs
    assert _shape(index) == _shape(jax_index)
    assert [e["epoch"] for e in index] == [0, 1] and [e["step"] for e in index] == [2, 4]
    assert all(os.path.exists(e["path"]) and e["path"].endswith(".pt") for e in index)
    state = torch.load(index[-1]["path"], weights_only=True)
    assert state["format"] == "dclip_tpu_torch.TeacherTrainer/1" and state["step"] == 4
    assert len(state["params"]) == 12 and state["optimizer"]["count"] == 4


def test_train_teacher_resume_runs_the_remaining_epoch(teacher_runs, workspace, capsys):
    from dclip_tpu_torch.cli import train_teacher

    (_, index), _ = teacher_runs
    capsys.readouterr()
    _, resumed = _run(train_teacher.main, workspace, "port",
                      ["--device", "cpu", "--epochs", "3", "--resume"])
    printed = capsys.readouterr().out
    assert "Epoch 2:" in printed and "Epoch 0:" not in printed and "Epoch 1:" not in printed
    assert [e["epoch"] for e in resumed] == [0, 1, 2] and resumed[-1]["step"] == 6
    assert "Best model:" in printed


def test_train_distill_reads_the_teacher_checkpoint(teacher_runs, workspace, monkeypatch):
    from dclip_tpu_torch.cli import train_distill
    from dclip_tpu_torch.data.pipeline import MultiModalPipeline
    from dclip_tpu_torch.data.detection_cache import DetectionCache
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.data.corpus import load_corpus
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    (_, index), _ = teacher_runs
    ckpt = index[1]["path"]
    built = []

    class Recording(DistillTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(train_distill, "DistillTrainer", Recording)
    ckpt_dir = str(workspace / "distill_ckpts")
    assert train_distill.main(
        ["--train_file", str(workspace / "syn_train.json"), "--train_batch_size", "4",
         "--phase1_epochs", "1", "--checkpoint_dir", ckpt_dir, "--accumulate_grad_batches", "1",
         "--teacher_checkpoint", ckpt, "--detection_cache", str(workspace / "precache.npz"),
         "--max_patches", "4", "--teacher_image_size", "32", "--model_preset", "tiny",
         "--device", "cpu"]) == 0
    (tr,) = built
    assert tr.step == 2
    assert any(f.startswith("distill_epoch0_train") for f in os.listdir(ckpt_dir))
    saved = torch.load(ckpt, weights_only=True)["params"]
    for name, t in tr.teacher.state_dict().items():
        assert torch.equal(t, saved[name]), name
    # The CLI trainer's targets (kernels off on the CPU: the module path)
    # equal the targets of a trainer given the saved weights directly.
    direct = DistillTrainer(tr.cfg, tr.student.state_dict(), tr.teacher_clip_state_dict, saved,
                            tr.student_config, tr.teacher_clip_config, device="cpu")
    pipe = MultiModalPipeline(load_corpus(str(workspace / "syn_train.json")),
                              HashTokenizer(1000, 16),
                              DetectionCache.load(str(workspace / "precache.npz")),
                              batch_size=4, max_patches=4, image_size=32, teacher_image_size=32)
    batch = next(iter(pipe.epoch(0)))
    assert batch.box_mask.sum() == 16
    got = tr._teacher_targets(tr._device_batch(batch))
    want = direct._teacher_targets(direct._device_batch(batch))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_train_distill_reads_a_reference_pth(tmp_path):
    """A torch state dict of the reference teacher (`cross_modal_attention.*`
    among other keys) loads; one missing a key raises."""
    from dclip_tpu_torch.cli.train_distill import load_teacher_state_dict
    from dclip_tpu_torch.core.config import TeacherConfig
    from dclip_tpu_torch.models.weights import random_teacher_state_dict

    tcfg = TeacherConfig(embed_dim=16, max_patches=4, max_text_tokens=16)
    sd = random_teacher_state_dict(tcfg, seed=5)
    torch.save(dict(sd, **{"image_tokenizer.x": torch.zeros(2)}), tmp_path / "t.pth")
    got = load_teacher_state_dict(str(tmp_path / "t.pth"), tcfg, seed=0)
    assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    sd.pop("cross_modal_attention.norm_text.bias")
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(ValueError, match="norm_text.bias"):
        load_teacher_state_dict(str(tmp_path / "bad.pth"), tcfg, seed=0)


def test_the_waiting_flags_raise(workspace, monkeypatch):
    """`--multihost`, `--mesh_data` and `--mesh_model` run now (2 ranks:
    the test below and tests/test_torch_tp_train.py); what still raises: a
    mesh of more ranks than the one process has, on the data axis or the
    model axis (make_mesh's ValueError, as JAX's on one device), and
    `--multihost` with a partial env triple (the JAX CLI's SystemExit). `--decode_backend native` and
    `--remat` run: both CLIs take the native route (the PNGs here through
    its per-item PIL route; JPEGs: tests/test_torch_cli_e2e.py), and the
    distillation trainer runs with remat."""
    from dclip_tpu_torch.cli import train_distill, train_teacher
    from dclip_tpu_torch.data import pipeline

    base = ["--train_file", str(workspace / "syn_train.json"), "--model_preset", "tiny",
            "--device", "cpu"]
    for flags, error, match in (
            (["--mesh_data", "2"], ValueError, "mesh 2x1 needs 2 devices, have 1"),
            (["--mesh_model", "2"], ValueError, "mesh 0x2 needs 2 devices, have 1")):
        for cli in (train_teacher, train_distill):
            with pytest.raises(error, match=match):
                cli.main(base + flags)
    monkeypatch.setenv("DCLIP_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("DCLIP_NUM_PROCESSES", raising=False)
    monkeypatch.setenv("DCLIP_PROCESS_ID", "0")
    for cli in (train_teacher, train_distill):
        with pytest.raises(SystemExit, match="DCLIP_NUM_PROCESSES"):
            cli.main(base + ["--multihost"])
    monkeypatch.delenv("DCLIP_COORDINATOR")
    backends = []
    real_init = pipeline.MultiModalPipeline.__init__

    def recording(self, *a, **k):
        real_init(self, *a, **k)
        backends.append(self.decode_backend)

    monkeypatch.setattr(pipeline.MultiModalPipeline, "__init__", recording)
    small = ["--max_patches", "4", "--teacher_image_size", "32", "--decode_backend", "native"]
    assert train_teacher.main(base + small + [
        "--epochs", "1", "--batch_size", "4", "--val_file", "",
        "--output_path", str(workspace / "native_teacher" / "teacher")]) == 0
    built = []

    class Recording(train_distill.DistillTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    monkeypatch.setattr(train_distill, "DistillTrainer", Recording)
    assert train_distill.main(base + small + [
        "--remat", "--phase1_epochs", "1", "--train_batch_size", "4",
        "--accumulate_grad_batches", "1", "--checkpoint_dir", str(workspace / "remat_ckpts")]) == 0
    (tr,) = built
    assert tr.cfg.remat and tr.student.vision_model.encoder.remat and tr.step == 2
    assert backends == ["native", "native"]
    assert any(f.startswith("distill_epoch0") for f in os.listdir(workspace / "remat_ckpts"))


@pytest.mark.parametrize("cli_name", ["train_teacher", "train_distill"])
def test_projection_weights_reach_the_gate(workspace, tmp_path, monkeypatch, capsys, cli_name):
    """`--projection_weights` (a port-format `ImageProjectionModule` file)
    with `--knn_store`: the trainer gets the head, and every patch that
    misses the store takes the projection branch (source 1)."""
    import importlib

    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.models.projections import init_image_projection, save_image_projection
    from dclip_tpu_torch.ops import knn

    cli = importlib.import_module(f"dclip_tpu_torch.cli.{cli_name}")
    trainer_name = "TeacherTrainer" if cli_name == "train_teacher" else "DistillTrainer"
    base = getattr(cli, trainer_name)
    built, sources = [], []

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

    real_gate = knn.knn_or_projection

    def recording_gate(*a, **k):
        res = real_gate(*a, **k)
        sources.append(res.source)
        return res

    monkeypatch.setattr(cli, trainer_name, Recording)
    monkeypatch.setattr(knn, "knn_or_projection", recording_gate)
    params = init_image_projection(seed=0, clip_dim=16)[1]
    save_image_projection(str(tmp_path / "proj.pt"), params)
    keys = np.random.RandomState(1).standard_normal((5, 16)).astype(np.float32)
    EmbeddingStore.from_arrays(keys / np.linalg.norm(keys, axis=-1, keepdims=True)).save(
        str(tmp_path / "store.npz"))
    common = ["--train_file", str(workspace / "syn_train.json"), "--detection_cache",
              str(workspace / "precache.npz"), "--max_patches", "4", "--teacher_image_size",
              "32", "--model_preset", "tiny", "--device", "cpu", "--knn_store",
              str(tmp_path / "store.npz"), "--projection_weights", str(tmp_path / "proj.pt")]
    if cli_name == "train_teacher":
        argv = common + ["--output_path", str(tmp_path / "t" / "teacher"), "--epochs", "1",
                         "--batch_size", "4"]
    else:
        argv = common + ["--train_batch_size", "4", "--phase1_epochs", "1",
                         "--checkpoint_dir", str(tmp_path / "d"), "--accumulate_grad_batches",
                         "1"]
    assert cli.main(argv) == 0
    assert "Projection branch enabled" in capsys.readouterr().out
    (tr,) = built
    assert tr._projection_fn is not None and tr.step == 2
    assert all(torch.equal(tr._projection_params[k], params[k]) for k in params)
    assert sources and all((s == knn.SOURCE_PROJECTION).all() for s in sources)


def _epoch_losses(out: str):
    return [float(x) for x in re.findall(r"Epoch \d+: train_loss=(\d+\.\d+)", out)]


def _csv_losses(path):
    import csv

    with open(path) as f:
        return [float(row["train_loss"]) for row in csv.DictReader(f)]


@pytest.mark.parametrize("cli_name", ["train_teacher", "train_distill"])
def test_multihost_clis_match_one_process(workspace, tmp_path, capsys, cli_name):
    """`--multihost` over 2 gloo ranks (the env triple, `--device cpu`):
    each rank reads its half of every global batch, the ranks log the same
    epoch loss, only rank 0 writes checkpoints and the metrics CSV, and the
    losses (the CSV row of step 10, the epoch's mean) equal a one-process
    run's on the same corpus (JAX tests/test_multihost.py:325). A
    `--teacher_cache` / `--pe_cache` path gets one file per rank."""
    import importlib
    import subprocess
    import sys

    from dclip_tpu_torch import native

    import torch_dp

    items = json.loads((workspace / "syn_train.json").read_text())
    items += json.loads((workspace / "syn_val.json").read_text())
    (tmp_path / "c20_train.json").write_text(json.dumps(items * 2))  # 20 items, 10 steps
    common = ["--train_file", str(tmp_path / "c20_train.json"), "--detection_cache",
              str(workspace / "precache.npz"), "--max_patches", "4", "--teacher_image_size",
              "32", "--model_preset", "tiny", "--device", "cpu", "--learning_rate", "1e-3"]
    cache_flag = "--pe_cache" if cli_name == "train_teacher" else "--teacher_cache"

    def argv(run):
        d = tmp_path / run
        out = (["--output_path", str(d / "teacher"), "--epochs", "1", "--batch_size", "2",
                "--val_file", ""] if cli_name == "train_teacher" else
               ["--checkpoint_dir", str(d), "--phase1_epochs", "1", "--train_batch_size", "2",
                "--accumulate_grad_batches", "1"])
        return common + out + [cache_flag, str(tmp_path / f"{run}.cache")]

    cli = importlib.import_module(f"dclip_tpu_torch.cli.{cli_name}")
    capsys.readouterr()
    assert cli.main(argv("one") + ["--metrics_csv", str(tmp_path / "one.csv")]) == 0
    want = _epoch_losses(capsys.readouterr().out)
    port = torch_dp.free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"dclip_tpu_torch.cli.{cli_name}", "--multihost"] + argv("two")
        + ["--metrics_csv", str(tmp_path / f"two_{r}.csv")], env=torch_dp.rank_env(port, 2, r),
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = torch_dp.wait_all(procs)
    got = [_epoch_losses(o) for o in outs]
    assert len(want) == 1 and got[0] == got[1]
    np.testing.assert_allclose(got[0], want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(_csv_losses(tmp_path / "two_0.csv"),
                               _csv_losses(tmp_path / "one.csv"), rtol=1e-5)
    assert not os.path.exists(tmp_path / "two_1.csv")
    with open(tmp_path / "two" / "checkpoints.json") as f:
        index = json.load(f)
    assert [(e["epoch"], e["step"]) for e in index] == [(0, 10)]
    if cli_name == "train_teacher":
        assert "Best model:" in outs[0] and "Best model:" not in outs[1]
    if native.available():
        assert all(os.path.exists(tmp_path / f"two.cache.rank{r}") for r in range(2))
        assert not os.path.exists(tmp_path / "two.cache")


def test_multihost_cli_preemption_lockstep(workspace, tmp_path):
    """SIGTERM to one of 2 `train_distill --multihost` ranks mid-run: the
    guard's agreement stops both at one step boundary (a lone stop would
    hang the other rank in its next collective and time this test out),
    rank 0 writes the one `preempt` checkpoint, and both CLIs exit 0
    (JAX tests/test_multihost.py:252-322)."""
    import signal
    import subprocess
    import sys
    import time

    import torch_dp

    ckpt_dir = tmp_path / "ckpts"
    argv = ["--multihost", "--train_file", str(workspace / "syn_train.json"),
            "--detection_cache", str(workspace / "precache.npz"), "--max_patches", "4",
            "--teacher_image_size", "32", "--model_preset", "tiny", "--device", "cpu",
            "--train_batch_size", "4", "--accumulate_grad_batches", "1",
            "--phase1_epochs", "300", "--checkpoint_dir", str(ckpt_dir)]
    port = torch_dp.free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "dclip_tpu_torch.cli.train_distill"] + argv,
                              env=torch_dp.rank_env(port, 2, r), cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    deadline = time.monotonic() + 240
    while time.monotonic() < deadline and not any(p.poll() is not None for p in procs):
        if ckpt_dir.is_dir() and any(f.endswith(".pt") for f in os.listdir(ckpt_dir)):
            break  # epoch 0 is done: fit is inside the guard on both ranks
        time.sleep(0.05)
    procs[1].send_signal(signal.SIGTERM)
    outs = torch_dp.wait_all(procs)
    for rank, out in enumerate(outs):
        assert "Preempted (SIGTERM)" in out, f"rank {rank}:\n{out[-2000:]}"
    assert _epoch_losses(outs[0]) == _epoch_losses(outs[1]) and len(_epoch_losses(outs[0])) < 300
    preempt = [f for f in os.listdir(ckpt_dir) if ".preempt." in f]
    assert len(preempt) == 1, os.listdir(ckpt_dir)
