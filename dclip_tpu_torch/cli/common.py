"""Shared CLI plumbing (counterpart of `dclip_tpu/cli/common.py`).

Every entry point takes the same flags as the JAX package's:
  --model_preset   vit-b-32 | vit-b-16 | vit-l-14 | tiny
  --clip_weights   local HF snapshot dir / .bin / .safetensors, or 'random'
                   (seeded N(0, 0.02) weights; there is no download path)
  --tokenizer_dir  dir containing vocab.json + merges.txt, or 'hash'
plus `--device` (default `cuda`; `cpu` only when asked for) and, for the
trainers, `--mesh_data` and `--mesh_model`, the (data, model) grid over
the ranks of a process group (`parallel.mesh.make_mesh`; tensor
parallelism over the model axis, `parallel.tp`).
`--multihost` starts one process per card in a `torch.distributed` group
(`init_multihost`). `restore_student_params` reads the port's own
checkpoints; `fit_with_preemption` runs a trainer's `fit` under a SIGTERM
guard.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from dclip_tpu_torch.core.config import CLIPConfig, MeshConfig
from dclip_tpu_torch.core.device import resolve_device, resolve_dtype
from dclip_tpu_torch.models.clip import CLIPModule


def add_model_args(p: argparse.ArgumentParser, default_preset: str = "vit-b-16") -> None:
    p.add_argument("--model_preset", default=default_preset,
                   help="CLIP preset: vit-b-32|vit-b-16|vit-l-14|tiny or HF id alias")
    p.add_argument("--clip_weights", default="random",
                   help="local HF snapshot dir / weight file, or 'random'")
    p.add_argument("--tokenizer_dir", default="hash",
                   help="dir with vocab.json+merges.txt, or 'hash' (test tokenizer)")
    p.add_argument("--seed", type=int, default=42)


def add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")


def add_mesh_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--mesh_data", type=int, default=-1,
                   help="data-parallel mesh size: the ranks of the process group (-1: all "
                        "of them); one process per card, so N > 1 needs --multihost with N "
                        "processes")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="model-parallel mesh size: tensor parallelism over N ranks of the "
                        "process group (--multihost with mesh_data x N processes)")


def mesh_config(args) -> MeshConfig:
    """The `MeshConfig` of the flags; `parallel.mesh.make_mesh` checks it
    against the process group."""
    dp, mp = getattr(args, "mesh_data", -1), getattr(args, "mesh_model", 1)
    return MeshConfig(data_parallel=dp, model_parallel=mp)


def add_multihost_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--multihost", action="store_true",
                   help="one process per card in a torch.distributed group: the "
                        "DCLIP_COORDINATOR / DCLIP_NUM_PROCESSES / DCLIP_PROCESS_ID triple, "
                        "else torchrun's variables; NCCL on cuda, gloo with --device cpu")


def init_multihost(device="cuda", timeout: float = 600.0,
                   backend: Optional[str] = None) -> torch.device:
    """`torch.distributed` init for `--multihost` runs (counterpart of
    `dclip_tpu/cli/common.py:185-210`); returns this process's device.

    The DCLIP_COORDINATOR (host:port) / DCLIP_NUM_PROCESSES /
    DCLIP_PROCESS_ID triple spells out the group and must be set together
    (a partial triple is an explicit error); without it torchrun's
    variables (`env://`). On CUDA the backend is NCCL, after
    `torch.cuda.set_device(local rank)` and the card's context: LOCAL_RANK
    when set, else the process id modulo the visible cards. gloo runs when
    the caller asked for the CPU, or on CUDA when asked for by `backend`:
    gloo takes CUDA tensors through the host, so several ranks can share
    one card (NCCL refuses that); a failed NCCL init raises."""
    import datetime

    import torch.distributed as dist

    coord = os.environ.get("DCLIP_COORDINATOR")
    if coord:
        missing = [k for k in ("DCLIP_NUM_PROCESSES", "DCLIP_PROCESS_ID")
                   if not os.environ.get(k)]
        if missing:
            raise SystemExit(
                "DCLIP_COORDINATOR is set but " + ", ".join(missing)
                + " is not — the multihost env triple (DCLIP_COORDINATOR, "
                "DCLIP_NUM_PROCESSES, DCLIP_PROCESS_ID) must be set together")
    want = torch.device(device)
    if want.type == "cuda":
        resolve_device("cuda")  # raises without a card
        rank = int(os.environ["DCLIP_PROCESS_ID"] if coord else os.environ.get("RANK", "0"))
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
        torch.zeros(1, device=dev)  # the context exists before NCCL's first call
        backend = backend or "nccl"
    elif want.type == "cpu":
        dev, backend = want, "gloo"
    else:
        raise ValueError(f"unsupported device {str(want)!r}; use 'cuda' or 'cpu'")
    kwargs = {"backend": backend, "timeout": datetime.timedelta(seconds=timeout)}
    if coord:
        kwargs.update(init_method=f"tcp://{coord}",
                      world_size=int(os.environ["DCLIP_NUM_PROCESSES"]),
                      rank=int(os.environ["DCLIP_PROCESS_ID"]))
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    return dev


def add_data_args(p: argparse.ArgumentParser) -> None:
    """The pipeline and teacher-shape flags both training CLIs share."""
    p.add_argument("--detection_cache", default=None, help="npz detection cache")
    p.add_argument("--num_workers", type=int, default=0,
                   help="decode worker processes (0 = threads only)")
    p.add_argument("--fast_decode", action="store_true",
                   help="scaled DCT JPEG decode (PIL draft; training only)")
    p.add_argument("--decode_backend", choices=("pil", "native"), default="pil",
                   help="'native' = C++ libjpeg decode + fused resample/normalize (GIL-"
                        "released, so decode threads scale over cores; non-JPEG, CMYK and "
                        "corrupt files take the PIL route per item; a decoder that cannot be "
                        "built raises). 'pil' keeps HF bit-parity")
    p.add_argument("--max_patches", type=int, default=8)
    p.add_argument("--teacher_image_size", type=int, default=224)
    p.add_argument("--compute_dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="auto = bfloat16 on CUDA, float32 on the CPU")
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction, default=None,
                   help="the hand-written kernels on the hot path (auto: on CUDA)")
    p.add_argument("--compact_patches", action=argparse.BooleanOptionalAction, default=None,
                   help="region-encode only valid patch slots (auto: on CUDA)")
    p.add_argument("--projection_weights", default=None,
                   help="ImageProjectionModule weights enabling the projection branch of "
                        "the k-NN gate: a port-format file (models.projections."
                        "save_image_projection, torch.save); flax msgpack is not read")
    p.add_argument("--knn_store", default=None,
                   help="EmbeddingStore (.npz / .dcs) enabling the k-NN gate over patch "
                        "embeddings")
    p.add_argument("--device_target_cache", action=argparse.BooleanOptionalAction,
                   default=None, help="device-resident level 0 over the host cache "
                                      "(default: on whenever there is a host cache)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--metrics_csv", default=None)
    add_multihost_arg(p)


def start_processes(args) -> torch.device:
    """The CLIs' device: with `--multihost`, this rank's after
    `init_multihost`, else `--device`."""
    if args.multihost:
        return init_multihost(args.device)
    return resolve_device(args.device)


def stop_processes(args) -> None:
    """With `--multihost`, destroy the process group `start_processes` made."""
    import torch.distributed as dist

    if args.multihost and dist.is_initialized():
        dist.destroy_process_group()


def load_detection_cache(path):
    from dclip_tpu_torch.data.detection_cache import DetectionCache

    if path and os.path.exists(path):
        return DetectionCache.load(path)
    print("No detection cache: box slots will be empty (masked out)")
    return None


def load_knn_store(path):
    if not (path and os.path.exists(path)):
        return None
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore

    store = EmbeddingStore.load(path)
    print(f"KNN gate enabled: {len(store)} stored embeddings")
    return store


def load_projection_params(path, embed_dim: int):
    """The projection head's state dict from `--projection_weights`, or None
    when the flag is unset or the file is absent (as the JAX CLIs)."""
    if not (path and os.path.exists(path)):
        return None
    from dclip_tpu_torch.models.projections import load_image_projection

    _, params = load_image_projection(path, embed_dim)
    print("Projection branch enabled for the knn gate")
    return params


def make_pipeline(args, path, tokenizer, cache, clip_cfg, batch_size, max_patches, seed,
                  drop_remainder=True, mesh=None):
    """The corpus JSON at `path` as a `data.pipeline.MultiModalPipeline`
    yielding this rank's rows of each global batch of `batch_size`, by its
    data index on `mesh` (`parallel.multihost.process_data_shard`; the
    ranks of one model group read the same rows); a tail batch cannot be
    split across processes, so several drop it."""
    from dclip_tpu_torch.data.corpus import load_corpus
    from dclip_tpu_torch.data.pipeline import MultiModalPipeline
    from dclip_tpu_torch.parallel.multihost import process_data_shard

    shard_index, shard_count = process_data_shard(mesh)
    return MultiModalPipeline(
        load_corpus(path), tokenizer, cache, batch_size=batch_size,
        drop_remainder=drop_remainder or shard_count > 1, max_patches=max_patches,
        image_size=clip_cfg.vision.image_size, teacher_image_size=args.teacher_image_size,
        max_text_tokens=clip_cfg.text.max_length, seed=seed, num_workers=args.num_workers,
        fast_decode=args.fast_decode, decode_backend=args.decode_backend,
        shard_index=shard_index, shard_count=shard_count)


def load_clip_state_dict(preset: str, weights: str, seed: int = 0
                         ) -> Tuple[CLIPConfig, Dict[str, torch.Tensor]]:
    """(config, HF-named f32 CPU state dict) from a preset and a weights
    source: seeded random weights for 'random', else a local file or
    snapshot directory."""
    from dclip_tpu_torch.models.weights import load_state_dict_file, random_state_dict

    cfg = CLIPConfig.from_name(preset)
    return cfg, random_state_dict(cfg, seed) if weights == "random" else \
        load_state_dict_file(weights)


def load_clip(
    preset: str, weights: str, seed: int = 0, compute_dtype: str = "float32",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[CLIPConfig, CLIPModule]:
    """Build a CLIPModule on `device` from a preset and a weights source.

    compute_dtype: "auto" = bfloat16 on CUDA, float32 on the CPU. Params
    are stored float32; the dtype sets the activations (and the image
    tower's packed kernel weights)."""
    device = resolve_device(device)
    cfg, sd = load_clip_state_dict(preset, weights, seed)
    model = CLIPModule(cfg, dtype=resolve_dtype(compute_dtype, device), device="meta")
    model.load_state_dict(sd, strict=True, assign=True)
    return cfg, model.to(device).eval()


def synthetic_distill_batch(clip_cfg, teacher_cfg, batch: int, rng=None):
    """Host-numpy distillation batch with the pipeline's field set and
    shapes, copied from `dclip_tpu/cli/common.py:35-74` (same draws from
    the same RandomState): caption spans of 8-24 tokens (a fixed 6 for
    max_length < 26), pixels, teacher pixels, boxes, conf, box_mask."""
    import numpy as np

    rng = rng or np.random.RandomState(0)
    t = clip_cfg.text.max_length
    s = clip_cfg.vision.image_size
    p = teacher_cfg.max_patches
    ids = rng.randint(1, clip_cfg.text.vocab_size - 2, size=(batch, t)).astype(np.int32)
    mask = np.zeros((batch, t), np.int32)
    lengths = rng.randint(8, 25, size=batch) if t >= 26 else np.full(batch, 6)
    for b in range(batch):
        n = int(lengths[b])
        ids[b, n - 1] = clip_cfg.text.eos_token_id
        ids[b, n:] = 0
        mask[b, :n] = 1
    boxes = rng.rand(batch, p, 4).astype(np.float32) * (s / 2)
    boxes[..., 2:] += boxes[..., :2] + 2
    return {
        "pixel_values": rng.randn(batch, s, s, 3).astype(np.float32) * 0.1,
        "input_ids": ids,
        "attention_mask": mask,
        "teacher_pixels": rng.rand(batch, s, s, 3).astype(np.float32),
        "boxes": boxes,
        "conf": rng.rand(batch, p).astype(np.float32),
        "box_mask": np.ones((batch, p), np.float32),
    }


def load_tokenizer(tokenizer_dir: str, max_length: int = 77):
    if tokenizer_dir == "hash":
        from dclip_tpu_torch.data.tokenizer import HashTokenizer

        return HashTokenizer(vocab_size=1000, max_length=max_length)
    from dclip_tpu_torch.data.tokenizer import CLIPTokenizer

    return CLIPTokenizer.from_pretrained_dir(tokenizer_dir, max_length=max_length)


def restore_student_params(checkpoint: str, template: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """The student CLIP's state dict from a checkpoint of the port's
    `train.checkpoint.CheckpointManager` (counterpart of
    `dclip_tpu/cli/common.py:172-182`, which reads flax msgpack).

    `checkpoint`: a trainer checkpoint file (`checkpoint_state()`, the
    parameters under "params"), a file holding a plain state dict, or a
    checkpoint directory (its latest regular checkpoint). Every tensor of
    `template` (the model's `state_dict()`) must be present with its shape;
    the result has the template's names, dtypes and devices."""
    import os

    from dclip_tpu_torch.train.checkpoint import CheckpointManager, restore_state

    if os.path.isdir(checkpoint):
        state = CheckpointManager(checkpoint).restore()
    else:
        state = restore_state(checkpoint)
    if isinstance(state, dict) and isinstance(state.get("params"), dict):
        state = state["params"]
    missing = sorted(set(template) - set(state))
    extra = sorted(set(state) - set(template))
    if missing or extra:
        raise ValueError(f"{checkpoint}: not a checkpoint of this model: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    out = {}
    for name, t in template.items():
        v = state[name]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{checkpoint}: {name} has shape {tuple(v.shape)}, the model "
                             f"{tuple(t.shape)}")
        out[name] = v.to(dtype=t.dtype, device=t.device)
    return out


def fit_with_preemption(trainer, train_pipe, val_pipe, checkpoints, logger,
                        start_epoch: int = 0) -> bool:
    """Run `trainer.fit` under a `PreemptionGuard`; True if preempted
    (counterpart of `dclip_tpu/cli/common.py:214-233`). A SIGTERM stops
    training at the next step boundary (every rank at the same one), saves
    a tagged `preempt` checkpoint and returns True, so the CLIs exit 0 and
    a later `--resume` restarts from the last epoch checkpoint."""
    from dclip_tpu_torch.train.preemption import Preempted, PreemptionGuard

    try:
        with PreemptionGuard() as guard:
            trainer.fit(train_pipe, val_pipe, checkpoints=checkpoints, logger=logger,
                        start_epoch=start_epoch, preemption=guard)
    except Preempted as e:
        print(f"Preempted (SIGTERM): {e}; state saved, exiting cleanly")
        return True
    return False


def eval_mesh(args):
    """The eval CLIs' mesh: with `--multihost`, every rank of the group
    (`--mesh_data` 1 or -1, or the group's size); without it None for
    `--mesh_data` 1, else `make_mesh`'s ValueError for more ranks than one
    process has."""
    from dclip_tpu_torch.parallel.mesh import make_mesh

    if not args.multihost and args.mesh_data == 1:
        return None
    dp = -1 if args.mesh_data == 1 else args.mesh_data
    return make_mesh(MeshConfig(data_parallel=dp))


def serve_mesh(args):
    """The serve CLI's mesh for `--mesh_data` (not 1; -1 takes every rank):
    over the process group already initialized, else one this call makes
    from the DCLIP env triple or torchrun's variables (`init_multihost` on
    `--device`), else `make_mesh`'s ValueError for more ranks than the one
    process ("mesh 2x1 needs 2 devices, have 1"; -1 is the one-rank mesh).
    Returns (mesh, whether this call made the group)."""
    import torch.distributed as dist

    from dclip_tpu_torch.parallel.mesh import make_mesh

    made = False
    if not dist.is_initialized() and (os.environ.get("DCLIP_COORDINATOR")
                                      or os.environ.get("WORLD_SIZE")):
        init_multihost(args.device)
        made = True
    try:
        return make_mesh(MeshConfig(data_parallel=args.mesh_data)), made
    except BaseException:
        if made:
            dist.destroy_process_group()
        raise


def rank_path(path: str) -> str:
    """`path` for this process: under a process group of several ranks,
    `<path>.rank<r>`, so no two ranks write one file."""
    from dclip_tpu_torch.parallel.multihost import process_data_shard

    rank, world = process_data_shard()
    return path if world == 1 else f"{path}.rank{rank}"
