"""The port's CLIs chained on the CPU at the tiny preset, the counterpart of
the JAX package's `tests/test_cli_e2e.py` (which is `slow`): build_corpus
-> precache -> train_teacher -> train_distill (`--remat`, `--decode_backend
native`) -> flickr30k_eval -> zero_shot_eval, on copies of the committed
JPEG fixtures (`tests/data/`) under COCO-style annotations."""
import json
import os
import pickle
import shutil

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
JPEGS = ("rgb_640x480.jpg", "rgb_375x500.jpg", "rgb_53x37.jpg", "rgb_224x224.jpg",
         "gray_121x90.jpg", "progressive_300x200.jpg")
MODEL = ["--model_preset", "tiny", "--device", "cpu"]
SMALL = ["--max_patches", "4", "--teacher_image_size", "32"]


@pytest.fixture
def workspace(tmp_path, monkeypatch):
    """12 COCO images (each fixture JPEG twice) with 3 captions each, 2
    annotated images missing on disk, and a CIFAR-10 test batch."""
    coco = tmp_path / "coco"
    coco.mkdir()
    images, annotations = [], []
    for i in range(14):
        name = f"COCO_{i:06d}.jpg"
        images.append({"id": i, "file_name": name})
        annotations += [{"image_id": i, "caption": f"photo {i} of a scene number {j}"}
                        for j in range(3)]
        if i < 12:
            shutil.copy(os.path.join(DATA, JPEGS[i % len(JPEGS)]), coco / name)
    (tmp_path / "captions.json").write_text(json.dumps({"images": images,
                                                        "annotations": annotations}))
    rng = np.random.RandomState(0)
    cdir = tmp_path / "cifar" / "cifar-10-batches-py"
    cdir.mkdir(parents=True)
    with open(cdir / "test_batch", "wb") as f:
        pickle.dump({b"data": (rng.rand(8, 3072) * 255).astype("uint8"),
                     b"labels": list(rng.randint(0, 10, 8))}, f)
    with open(cdir / "batches.meta", "wb") as f:
        pickle.dump({b"label_names": [f"c{i}".encode() for i in range(10)]}, f)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_the_cli_chain_from_jpeg_files(workspace, capsys):
    from dclip_tpu_torch.cli import (
        build_corpus,
        flickr30k_eval,
        precache,
        train_distill,
        train_teacher,
        zero_shot_eval,
    )

    # 1. The corpus: 12 images on disk of 14 annotated, a 10 / 2 split.
    assert build_corpus.main(["--output_dir", "data", "--coco_images", "coco",
                              "--coco_annotations", "captions.json", "--val_fraction",
                              "0.15"]) == 0
    train = json.load(open("data/teacher_train.json"))
    val = json.load(open("data/teacher_val.json"))
    assert (len(train), len(val)) == (10, 2)
    assert all(it["dataset"] == "coco" and len(it["captions"]) == 3 for it in train)

    # 2. Region proposals and the patch index.
    assert precache.main(["--json_file", "data/teacher_train.json", "--cache_dir", "cache",
                          "--build_index", "--batch_size", "16", "--model_preset", "tiny",
                          "--device", "cpu"]) == 0
    assert os.path.exists("cache/teacher_train_precache.npz")
    assert os.path.exists("cache/teacher_train_patch_index.npz")

    # 3. The meta-teacher, from the JPEGs through the native decoder.
    assert train_teacher.main(["--train_file", "data/teacher_train.json", "--epochs", "1",
                               "--batch_size", "5", "--learning_rate", "1e-3",
                               "--output_path", "models/teacher", "--detection_cache",
                               "cache/teacher_train_precache.npz", "--decode_backend", "native"]
                              + SMALL + MODEL) == 0
    teacher = [f for f in os.listdir("models") if f.endswith(".pt")]
    assert len(teacher) == 1 and "val" in teacher[0]

    # 4. Distillation with remat, from the same JPEGs.
    assert train_distill.main(["--train_file", "data/teacher_train.json",
                               "--train_batch_size", "5", "--phase1_epochs", "1",
                               "--checkpoint_dir", "ckpts", "--accumulate_grad_batches", "1",
                               "--teacher_checkpoint", os.path.join("models", teacher[0]),
                               "--detection_cache", "cache/teacher_train_precache.npz",
                               "--decode_backend", "native", "--remat"] + SMALL + MODEL) == 0
    student = [f for f in os.listdir("ckpts") if f.endswith(".pt")]
    assert len(student) == 1

    # 5. Retrieval eval of the base and the distilled student.
    eval_items = [{"image_path": it["image_path"], "image_id": i, "captions": it["captions"]}
                  for i, it in enumerate(train + val)]
    with open("eval.json", "w") as f:
        json.dump(eval_items, f)
    capsys.readouterr()
    assert flickr30k_eval.main(["--dataset_json", "eval.json", "--max_images", "12",
                                "--model", "both", "--checkpoint",
                                os.path.join("ckpts", student[0]), "--batch_size", "12"]
                               + MODEL) == 0
    assert "R@1" in capsys.readouterr().out

    # 6. Zero-shot eval, with the reference's results file.
    assert zero_shot_eval.main(["--dataset", "cifar10", "--data_dir", "cifar", "--model", "both",
                                "--checkpoint", os.path.join("ckpts", student[0]),
                                "--batch_size", "8"] + MODEL) == 0
    body = open("cifar_zero_shot_results.txt").read()
    assert body.startswith("Zero-Shot CIFAR Results")
    assert "Base CLIP Top-1:" in body and "Relative Change:" in body


@pytest.mark.parametrize("decoder", [True, False], ids=["decoder", "no_decoder"])
def test_chip_smoke_files_phase_on_the_cpu(decoder, monkeypatch, capsys):
    """`chip_smoke.py` phase 32 at the tiny preset on the CPU: with the
    decoder, both training CLIs from the fixtures; without it (the card
    machine's case), the clean raise of decode_backend="native"."""
    import importlib.util

    import torch

    from dclip_tpu_torch import native

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.chdir(REPO)  # the phase reads the fixtures by their repository path
    jpeg = {"available": True, "error": None}
    if not decoder:
        jpeg = {"available": False, "error": "jpeg_decode.cc:37: jpeglib.h: No such file"}
        monkeypatch.setattr(native, "_jpeg_lib", None)
        monkeypatch.setattr(native, "_jpeg_error", jpeg["error"])
    monkeypatch.setattr(smoke, "FILES_DEVICE", "cpu")
    monkeypatch.setattr(smoke, "FILES_PRESET", "tiny")
    smoke.files_phase(torch, np, "cpu", jpeg)
    printed = capsys.readouterr().out
    if decoder:
        assert "files: teacher checkpoints" in printed and "files: distill checkpoints" in printed
    else:
        assert "decode_backend='native' raises" in printed and "jpeglib.h" in printed


def test_chip_smoke_dp_phase_on_the_cpu(monkeypatch, capsys):
    """`chip_smoke.py` phase 33 at the tiny preset on the CPU, in a one-rank
    gloo group: the distill step (dp_equivalent) and the teacher step bit
    for bit against the trainers without a group, the sharded search, the
    preempted fit; the group is gone afterwards."""
    import importlib.util

    import torch

    from dclip_tpu_torch.core import CLIPConfig, TeacherConfig
    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in (("DP_DEVICE", "cpu"), ("DP_PRESET", "tiny"), ("DP_B", 8),
                        ("DP_TEACHER_B", 4), ("DP_STEPS", 2), ("DP_SEARCH_N", 101),
                        ("DP_SEARCH_D", 16), ("DP_SEARCH_Q", 4), ("DP_SEARCH_K", 3),
                        ("DP_FIT_B", 4)):
        monkeypatch.setattr(smoke, name, value)
    cfg = CLIPConfig.tiny_test()
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4)
    smoke.dp_phase(torch, np, random_state_dict(cfg, 0), random_teacher_state_dict(tcfg, 0), "cpu")
    printed = capsys.readouterr().out
    for line in ("dp: init_multihost: gloo group of 1", "dp: distill losses, gradients and "
                 "parameters bit-equal", "dp: teacher losses, gradients and parameters bit-equal",
                 "dp: fit_with_preemption returned True at step 2",
                 "dp: the preempt checkpoint's parameters bit-equal"):
        assert line in printed, line
    assert not torch.distributed.is_initialized()


def test_chip_smoke_profile_phase_on_the_cpu(monkeypatch, capsys):
    """`chip_smoke.py` phase 34 on the CPU: the phase profile at the tiny
    preset (twice: the B/16 and the L/14 slots) and the per-op table at
    ViT-B/16 width, B=2, with every check of the phase that holds off the
    card (phases bounded, images/s from the phases, no MFU, a trace file)."""
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name, value in (("PROFILE_DEVICE", "cpu"),
                        ("PROFILE_RUNS", (("tiny", 4, 2), ("tiny", 2, 1))),
                        ("PROFILE_OPS_B", 2), ("PROFILE_OPS_STEPS", 1)):
        monkeypatch.setattr(smoke, name, value)
    launches = smoke.profile_phase(torch, np, "cpu")
    printed = capsys.readouterr().out
    assert set(launches) == {"tiny"}
    for line in ("profile: tiny B=4: phases ms", "profile: tiny B=2: phases ms",
                 "profile: dclip.student_step", "profile: per-op B=2 S=197 D=768",
                 "profile: attn bwd kernel (K5)", "profile: loss tail (K11, [B,proj])",
                 "profile: phase 34"):
        assert line in printed, line


def _smoke_module():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_tp_phase_on_the_cpu(monkeypatch, capsys):
    """`chip_smoke.py` phase 35 at the tiny preset on the CPU: two
    processes of the script in a gloo group, the model axis across them,
    against the same distill and teacher steps in this process without a
    group (features, losses, first-step gradients, parameters within the
    phase's bounds; both ranks' losses equal); each rank holds the kernel
    wrappers on the calls its warm-up steps made, which here run their
    twins on both sides."""
    import torch

    from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict

    smoke = _smoke_module()
    for name, value in (("TP_DEVICE", "cpu"), ("TP_PRESET", "tiny"), ("TP_B", 8),
                        ("TP_TEACHER_B", 4), ("TP_STEPS", 2)):
        monkeypatch.setattr(smoke, name, value)
    cfg, tcfg = smoke._tp_configs("tiny")
    launches, rows = smoke.tp_phase(torch, np, random_state_dict(cfg, 0),
                                    random_teacher_state_dict(tcfg, 0), "cpu")
    printed = capsys.readouterr().out
    assert not any(launches.values())  # the twins run on the CPU
    assert {"gemm_bias_act_residual[tp]", "self_attention_fwd_stats[tp]",
            "self_attention_bwd_stats[tp]", "distill_loss_fwd[tp]"} <= set(rows), sorted(rows)
    assert all(r["max_abs_err"] == 0.0 for r in rows.values())
    for line in ("tp: rank 0 | rank 0: gloo group of 2 on cpu, mesh {'data': 1, 'model': 2}",
                 "tp: rank 1 | rank 1: gloo group of 2 on cpu",
                 "whole-block kernels (K6 frozen MLP, K8, K9) demoted",
                 "tp: distill tiny B=8 mp=2 over gloo: ms per step",
                 "tp: features before training: 4 tensors",
                 "tp: distill gradients of the first step, sharded: ",
                 "tp: distill gradients of the first step, replicated: ",
                 "tp: teacher gradients of the first step, replicated: ",
                 "tp: trainable parameters after 5 distill steps",
                 "tp: teacher parameters after 3 steps", "tp: phase 35"):
        assert line in printed, line
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("too_high", [0.0, 0.02], ids=["pr16_record", "rate_0.02_high"])
def test_hold_profile_allows_the_records_rounding(tmp_path, too_high):
    """Phase 34's rate check on a `cli.profile` record at the CPU's B=2:
    the record of the run that failed under a busy CPU (2.68 images/s
    against a full uncached step of 747.22 ms, where batch / phase is
    2.6766) passes, since the rate and the phase are each rounded to two
    decimals; a rate 0.02 too high still raises."""
    smoke = _smoke_module()
    (tmp_path / "host.pt.trace.json").write_text("{}")
    phases = {"full uncached step": 747.22, "teacher patch encode": 421.07,
              "teacher tail (text+xattn)": 40.4, "student step (cache-warm)": 283.91,
              "residual": 1.84}
    rec = {"preset": "tiny", "backend": "cpu", "phases_ms": phases,
           "images_per_sec_uncached": round(2.68 + too_high, 2),
           "images_per_sec_cache_warm": round(2 / (283.91 / 1e3), 2),
           "mfu_uncached": None, "mfu_uncached_masked_true": None, "mfu_cache_warm": None,
           "mfu_cache_warm_masked_true": None}
    if too_high:
        with pytest.raises(AssertionError, match="images_per_sec_uncached 2.7 != batch / phase"):
            smoke._hold_profile(rec, 2, False, str(tmp_path), "cpu")
    else:
        smoke._hold_profile(rec, 2, False, str(tmp_path), "cpu")


def test_chip_smoke_serve_phase_on_the_cpu(monkeypatch, capsys):
    """`chip_smoke.py` phase 36 at the tiny preset on the CPU: the
    one-process service on the main path, then two processes of the script
    serving it over a gloo group (rank 0 leads, rank 1 follows; the bench
    and the int8 selftest after it), then a one-rank group from the serve
    CLI's `serve_mesh`; every hold of the phase that holds off the card
    (rows, top-k, the int8 selftest, the one-rank group bit-equal)."""
    import torch

    smoke = _smoke_module()
    for name, value in (("SERVE_DEVICE", "cpu"), ("SERVE_PRESET", "tiny"),
                        ("SERVE_INDEX_DIM", 16), ("SERVE_ROWS", 100), ("SERVE_QUERIES", 6),
                        ("SERVE_TEXTS", 9), ("SERVE_IMAGES", 7), ("SERVE_K", 4)):
        monkeypatch.setattr(smoke, name, value)
    launches, rows = smoke.serve_phase(torch, np, "cpu")
    printed = capsys.readouterr().out
    assert not any(launches.values())  # the twins run on the CPU
    assert set(rows) <= {"topk_streamed[serve_dp]"}, sorted(rows)
    for line in ("serve_dp: rank 0 | rank 0: gloo group of 2 on cpu, mesh {'data': 2, "
                 "'model': 1}", "serve_dp: rank 1 | rank 1: gloo group of 2 on cpu",
                 "serve_dp: 9 texts (9, 16): bit-equal to one process",
                 "serve_dp: 7 images (7, 16): bit-equal to one process",
                 "serve_dp: text search: 6 queries x top-4: ids equal True",
                 "serve_dp: bench over 2 ranks through gloo",
                 "serve_dp: a one-rank gloo group (mesh {'data': 1, 'model': 1}, made by "
                 "serve_mesh) against no group: bit-equal", "serve_dp: phase 36"):
        assert line in printed, line
    assert not torch.distributed.is_initialized()


def test_chip_smoke_last_modules_phase_on_the_cpu(monkeypatch, capsys):
    """`chip_smoke.py` phase 37 on the CPU at tiny sizes: the context view
    of the tiny CLIP (its f32 module route) against the CPU reference,
    BERT's `tiny_test` on both of its routes, and the width-8 detector's
    training steps and gradients; every hold of the phase that holds off
    the card."""
    import torch

    smoke = _smoke_module()
    for name, value in (("LAST_DEVICE", "cpu"), ("LAST_PRESET", "tiny"),
                        ("LAST_DTYPE", "float32"), ("CONTEXT_B", 4), ("CONTEXT_REPEATS", 1),
                        ("BERT_PRESET", "tiny_test"), ("BERT_CAPTIONS", 6), ("BERT_T", 16),
                        ("BERT_CLIP_DIM", 16),
                        ("DET_TRAIN_CHANGES", dict(num_classes=3, image_size=64, width=8,
                                                   depth=1, p5_ch=None)),
                        ("DET_TRAIN_B", 2), ("DET_TRAIN_STEPS", 3)):
        monkeypatch.setattr(smoke, name, value)
    launches, rows = smoke.last_modules_phase(torch, np, "cpu")
    printed = capsys.readouterr().out
    assert not any(launches.values()) and rows == {}  # the twins run on the CPU
    for line in ("context: tiny float32 on cpu, 4 images x 8 boxes: views of [32, 32] frames",
                 "context: region encode ", "context: patch view, 2 images (13 valid of 16)",
                 "context: context view, 2 images", "bert: tiny_test (2 layers, 32 wide), 6 "
                 "captions", "bert: [6, 16] features", "det_train: 8-wide depth 1 at 64 px, B=2",
                 "det_train: B=2, 3 Adam(0.002) steps on one batch", "last: phase 37"):
        assert line in printed, line
