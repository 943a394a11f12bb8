"""One rank of a multi-process run of the port (tests/test_torch_dp_*.py,
tests/test_torch_tp*.py, tests/test_torch_parallel.py,
tests/test_torch_preemption.py, tests/test_torch_serve_ranks.py).

    DCLIP_COORDINATOR=127.0.0.1:<port> DCLIP_NUM_PROCESSES=N DCLIP_PROCESS_ID=r \\
        python tests/torch_dp_worker.py <spec.json>

The spec names a scenario and its inputs (files written by the test) and
optionally its mesh (`"mesh": [data_parallel, model_parallel]`); the rank
joins a gloo group through the port's `cli.common.init_multihost`, runs the
scenario on its own rows and writes `<out>.rank<r>.pt` (a dict of tensors,
numbers and strings). Imports torch and the port, never JAX.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def params_digest(module) -> str:
    h = hashlib.md5()
    for name, p in module.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def trainable_grads(module, mask) -> dict:
    """The trainable parameters' gradients after a step (zeros where the
    loss never reached one), on the CPU."""
    return {n: (p.grad.detach().clone() if p.grad is not None else torch.zeros_like(p))
            for n, p in module.named_parameters() if mask[n]}


def load_batches(path):
    with np.load(path) as z:
        n = int(z["n_batches"])
        return [{k.split("/", 1)[1]: z[k] for k in z.files if k.startswith(f"{i}/")}
                for i in range(n)]


def mesh_outcomes(configs) -> list:
    """`make_mesh` over the group for each (data_parallel, model_parallel):
    ("ok", data size, data index, model size, model index) or (the
    exception's type name, its message)."""
    from dclip_tpu_torch.core.config import MeshConfig
    from dclip_tpu_torch.parallel.mesh import make_mesh

    out = []
    for dp, mp in configs:
        try:
            m = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
            out.append(("ok", m.size, m.rank, m.model_size, m.model_index))
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def scenario_losses(spec, mesh):
    """The global losses' values and this rank's gradients; `make_mesh`'s
    outcomes over the group."""
    from dclip_tpu_torch.ops.losses import distillation_loss_global, info_nce_global
    from dclip_tpu_torch.parallel.mesh import shard_batch

    with np.load(spec["inputs"]) as z:
        local = shard_batch({k: z[k] for k in z.files}, mesh)
    si, st, ti, tt = (_t(local[k]).requires_grad_(k in ("si", "st"))
                      for k in ("si", "st", "ti", "tt"))
    total, parts = distillation_loss_global(si, st, ti, tt, mesh, temperature=0.05,
                                            contrastive_weight=0.7)
    total.backward()
    out = {"distill_" + k: v.detach() for k, v in parts.items()}
    out.update(distill_dsi=si.grad.clone(), distill_dst=st.grad.clone())
    si.grad = st.grad = None
    loss = info_nce_global(si, st, mesh, temperature=0.05)
    loss.backward()
    out.update(info_nce=loss.detach(), info_nce_dsi=si.grad.clone(),
               info_nce_dst=st.grad.clone(), meshes=mesh_outcomes(spec["meshes"]))
    return out


def _distill_trainer(spec, variant, mesh):
    import dataclasses

    from dclip_tpu_torch.core.config import CLIPConfig, DistillConfig, TeacherConfig
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

    cfg = CLIPConfig.tiny_test()
    sd = torch.load(spec["student"], weights_only=True)
    tsd = torch.load(spec["teacher"], weights_only=True)
    dcfg = DistillConfig(teacher=TeacherConfig(**spec["teacher_cfg"]), **spec["distill_cfg"])
    dcfg = dataclasses.replace(dcfg, **variant.get("changes", {}))
    cache = TeacherTargetCache(salt="dp-test") if variant.get("cache") else None
    return DistillTrainer(dcfg, sd, sd, tsd, cfg, cfg, device="cpu", teacher_cache=cache,
                          mesh=mesh, dp_equivalent=variant.get("dp_equivalent", False))


def scenario_distill(spec, mesh):
    """Per variant: the steps' losses, the reduced gradients of the first
    step and the clip's global norm of them, the trainable parameters after
    the last, every parameter's digest; under tensor parallelism the
    gradients and parameters are gathered whole, and `shard_grads` keeps
    the rank's own."""
    from dclip_tpu_torch.parallel.mesh import shard_batch
    from dclip_tpu_torch.parallel.tp import gather_clip_params

    batches = load_batches(spec["batches"])
    out = {}
    for variant in spec["variants"]:
        tr = _distill_trainer(spec, variant, mesh)
        losses, grads = [], None
        for i in variant["steps"]:
            m = tr.train_step_on_batch(shard_batch(batches[i], mesh))
            losses.append(float(m["loss"]))
            if grads is None:
                grads = trainable_grads(tr.student, tr._trainable_mask)
                norm = float(tr.optimizer._global_norm(tr.optimizer._grads()))
        params = {n: p.detach().clone() for n, p in tr.student.named_parameters()}
        name = variant["name"]
        out[name] = {"losses": losses, "shard_grads": grads,
                     "norm": norm,
                     "grads": gather_clip_params(grads, mesh),
                     "digest": params_digest(tr.student),
                     "whole_digest": hashlib.md5(b"".join(
                         t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                         for t in gather_clip_params(params, mesh).values())).hexdigest(),
                     "params": {n: p for n, p in gather_clip_params(params, mesh).items()
                                if tr._trainable_mask[n]}}
    return out


def scenario_meshes(spec, mesh):
    """`make_mesh`'s outcomes for the spec's (data_parallel, model_parallel)
    pairs, `make_multislice_mesh`'s for its (model_parallel, k, mode)
    triples (the slice of rank r is r // k or r % k), and its default's (a
    slice per host) at model_parallel 2."""
    from dclip_tpu_torch.core.config import MeshConfig
    from dclip_tpu_torch.parallel.mesh import make_multislice_mesh

    slices = []
    for mp, k, mode in spec["multislice"]:
        try:
            m = make_multislice_mesh(
                MeshConfig(model_parallel=mp),
                slice_index_fn=lambda r, k=k, mode=mode: r // k if mode == "div" else r % k)
            slices.append(("ok", m.size, m.rank, m.model_size, m.model_index))
        except ValueError as e:
            slices.append(("ValueError", str(e)))
    node = make_multislice_mesh(MeshConfig(model_parallel=2))  # one host: one slice
    return {"meshes": mesh_outcomes(spec["meshes"]), "multislice": slices,
            "node_multislice": (node.size, node.rank, node.model_size, node.model_index)}


def _state_diffs(a, b) -> dict:
    """The largest |a - b| of two `checkpoint_state()`s' parameters and
    AdamW moments, and whether everything else is equal."""
    def worst(x, y):
        return max(((x[k].float() - y[k].float()).abs().max().item() for k in x), default=0.0)

    oa, ob = a["optimizer"], b["optimizer"]
    same = (set(a["params"]) == set(b["params"]) and a["trainable"] == b["trainable"]
            and a["step"] == b["step"] and oa["count"] == ob["count"]
            and all(x.shape == y.shape for k in ("mu", "nu") for x, y in zip(oa[k], ob[k])))
    return {"params": worst(a["params"], b["params"]), "same": same,
            **{k: worst(dict(enumerate(oa[k])), dict(enumerate(ob[k]))) for k in ("mu", "nu")}}


def scenario_tp_ckpt(spec, mesh):
    """Checkpoints across model-parallel sizes: `fit` over the spec's mesh
    writes the gathered state (global rank 0), which a trainer without a
    group (mp = 1) restores; a state saved at mp = 1 restores on the mesh;
    each then takes one more step on the same batch."""
    from dclip_tpu_torch.parallel.mesh import local_mesh, shard_batch
    from dclip_tpu_torch.train.checkpoint import CheckpointManager

    batches = load_batches(spec["batches"])
    variant = spec["variants"][0]
    first, nxt = variant["steps"]
    out = {}
    tr = _distill_trainer(spec, variant, mesh)
    ckpts = CheckpointManager(spec["ckpt_dir"], prefix="distill")
    tr.fit(_Pipe([shard_batch(batches[first], mesh)]), checkpoints=ckpts)
    state = tr.checkpoint_state()
    if mesh.is_primary:
        out["file"] = _state_diffs(ckpts.restore(), state)
    one = _distill_trainer(spec, variant, local_mesh())
    one.load_checkpoint_state(state)
    out["to_one"] = _state_diffs(state, one.checkpoint_state())

    one = _distill_trainer(spec, variant, local_mesh())
    one.train_step_on_batch(batches[first])
    saved = one.checkpoint_state()
    tr = _distill_trainer(spec, variant, mesh)
    tr.load_checkpoint_state(saved)
    out["to_mesh"] = _state_diffs(saved, tr.checkpoint_state())
    out["next_losses"] = [float(one.train_step_on_batch(batches[nxt])["loss"]),
                          float(tr.train_step_on_batch(shard_batch(batches[nxt], mesh))["loss"])]
    out["shard_mu"] = {n: tuple(t.shape) for n, t in zip(tr._trainable_names(), tr.optimizer.mu)}
    return out


def scenario_tp_forward(spec, mesh):
    """Tensor-parallel CLIP on this rank's slices (`parallel.tp`): image and
    text features of the rank's rows through the module (per-op and fused
    attention) and the region encode's `vit_block` composition, the
    gradient of sum(image features^2) over the rank's rows for every
    parameter (the sharded ones gathered whole, summed over the data
    group), and shard -> gather round trips."""
    from dclip_tpu_torch.core.config import CLIPConfig
    from dclip_tpu_torch.kernels import vit_block
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.parallel.mesh import all_reduce_grads, shard_batch
    from dclip_tpu_torch.parallel.tp import gather_clip_params, shard_clip_params

    cfg = CLIPConfig.tiny_test()
    sd = torch.load(spec["clip"], weights_only=True)
    with np.load(spec["inputs"]) as z:
        local = shard_batch({k: z[k] for k in z.files}, mesh)
    shard = shard_clip_params(sd, mesh)
    out = {"round_trip": all(torch.equal(a, sd[n]) for n, a in
                             gather_clip_params(shard, mesh).items()),
           "shapes": {n: tuple(t.shape) for n, t in shard.items()}}
    for fused in (False, True):
        model = CLIPModule(cfg, device="meta", fused_attention=fused, mesh=mesh)
        model.load_state_dict(shard, strict=True, assign=True)
        with torch.no_grad():
            out[f"img_{fused}"] = model.image_features(_t(local["pixels"]))
            out[f"txt_{fused}"] = model.get_text_features(_t(local["ids"]), _t(local["mask"]))
    packed = vit_block.pack_vision_weights(cfg, shard, torch.float32, mesh)
    out["img_blocks"] = vit_block.fused_image_features(cfg, packed, _t(local["pixels"]))
    out["img_blocks_whole"] = vit_block.fused_image_features(
        cfg, vit_block.pack_vision_weights(cfg, sd, torch.float32, mesh), _t(local["pixels"]))
    model = CLIPModule(cfg, device="meta", fused_attention=True, mesh=mesh)
    model.load_state_dict({n: t.clone() for n, t in shard.items()}, strict=True, assign=True)
    (model.image_features(_t(local["pixels"])) ** 2).sum().backward()
    params = [p for _, p in model.named_parameters()]
    all_reduce_grads(params, mesh)
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters()}
    out["shard_grads"] = grads
    out["grads"] = gather_clip_params(grads, mesh)
    return out


def scenario_teacher(spec, mesh):
    import dataclasses

    from dclip_tpu_torch.core.config import CLIPConfig, TeacherConfig, TeacherTrainConfig
    from dclip_tpu_torch.parallel.mesh import shard_batch
    from dclip_tpu_torch.train import TeacherTrainer

    cfg = CLIPConfig.tiny_test()
    sd = torch.load(spec["clip"], weights_only=True)
    tsd = torch.load(spec["teacher"], weights_only=True)
    tcfg = dataclasses.replace(TeacherTrainConfig(
        teacher=TeacherConfig(**spec["teacher_cfg"]), **spec["train_cfg"]))
    tr = TeacherTrainer(tcfg, sd, cfg, tsd, device="cpu", mesh=mesh)
    batches = load_batches(spec["batches"])
    losses, grads = [], None
    for i in spec["steps"]:
        losses.append(float(tr.train_step_on_batch(shard_batch(batches[i], mesh))["loss"]))
        if grads is None:
            grads = trainable_grads(tr.teacher, tr._mask)
    return {"losses": losses, "grads": grads, "digest": params_digest(tr.teacher),
            "params": {n: p.detach().clone() for n, p in tr.teacher.named_parameters()}}


def scenario_search(spec, mesh):
    """knn_search_sharded over a padded store, retrieval_metrics_sharded,
    evaluate_retrieval and evaluate_zero_shot with the mesh."""
    from dclip_tpu_torch.data.embedding_store import EmbeddingStore
    from dclip_tpu_torch.ops.knn import knn_search_sharded
    from dclip_tpu_torch.ops.retrieval import retrieval_metrics_sharded

    out = {}
    with np.load(spec["inputs"]) as z:
        arrays = {k: z[k] for k in z.files}
    for case in spec["knn"]:
        store = EmbeddingStore.from_arrays(arrays[case["keys"]])
        n_valid = len(store)
        padded = store.pad_to_multiple(mesh.size)
        keys, _ = padded.device_arrays("cpu", mesh)
        scores, idx = knn_search_sharded(_t(arrays["queries"]), keys, mesh, k=case["k"],
                                         n_valid=n_valid)
        out[f"knn_{case['name']}"] = (scores, idx)
    out["metrics"] = retrieval_metrics_sharded(arrays["cap"], arrays["img"], arrays["c2i"],
                                               mesh, i2t_chunk=3, device="cpu")
    if spec.get("eval"):
        out.update(_eval(spec["eval"], mesh))
    return out


def _eval(spec, mesh):
    from dclip_tpu_torch.core.config import CLIPConfig
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.eval.retrieval import embed_captions, embed_images, evaluate_retrieval
    from dclip_tpu_torch.eval.zero_shot import evaluate_zero_shot
    from dclip_tpu_torch.models.clip import CLIPModule

    cfg = CLIPConfig.tiny_test()
    model = CLIPModule(cfg, device="meta")
    model.load_state_dict(torch.load(spec["clip"], weights_only=True), strict=True, assign=True)
    model.eval()
    with open(spec["items"]) as f:
        items = json.load(f)
    tok = HashTokenizer(vocab_size=1000, max_length=cfg.text.max_length)
    size = cfg.vision.image_size
    caps = [c for it in items for c in it["captions"]]
    out = {"images": embed_images(model, [it["image_path"] for it in items], 4, size, mesh=mesh),
           "captions": embed_captions(model, tok, caps, 4, mesh=mesh, packed=True)}
    out["retrieval"] = evaluate_retrieval(model, tok, items, 4, size, mesh=mesh,
                                          packed_captions=True)
    with np.load(spec["pixels"]) as z:
        pixels, labels, text = z["pixels"], z["labels"], z["text"]
    batches = [(pixels[i:i + 5], labels[i:i + 5]) for i in range(0, len(labels), 5)]
    out["zero_shot"] = evaluate_zero_shot(model, torch.from_numpy(text), batches, mesh=mesh)
    return out


class _Pipe:
    """Epochs of in-memory local batches; with `kill_at` this rank sends
    itself SIGTERM when batch `kill_at` of epoch 0 is drawn."""

    def __init__(self, batches, kill_at=None):
        self.batches, self.kill_at = batches, kill_at

    def epoch(self, epoch):
        import signal

        for i, b in enumerate(self.batches):
            if epoch == 0 and i == self.kill_at:
                os.kill(os.getpid(), signal.SIGTERM)
            yield b


def scenario_preempt(spec, mesh):
    """TeacherTrainer.fit under a PreemptionGuard; only rank `kill_rank`
    gets the signal."""
    import dataclasses

    from dclip_tpu_torch.core.config import CLIPConfig, TeacherConfig, TeacherTrainConfig
    from dclip_tpu_torch.parallel.mesh import shard_batch
    from dclip_tpu_torch.train import TeacherTrainer
    from dclip_tpu_torch.train.checkpoint import CheckpointManager
    from dclip_tpu_torch.train.preemption import Preempted, PreemptionGuard

    cfg = CLIPConfig.tiny_test()
    sd = torch.load(spec["clip"], weights_only=True)
    tcfg = dataclasses.replace(TeacherTrainConfig(
        teacher=TeacherConfig(**spec["teacher_cfg"]), **spec["train_cfg"]))
    tr = TeacherTrainer(tcfg, sd, cfg, device="cpu", mesh=mesh)
    batches = [shard_batch(b, mesh) for b in load_batches(spec["batches"])]
    pipe = _Pipe(batches, spec["kill_at"] if mesh.rank == spec["kill_rank"] else None)
    ckpts = CheckpointManager(spec["ckpt_dir"], prefix="teacher", save_top_k=0)
    preempted = False
    with PreemptionGuard(sync_every=spec["sync_every"]) as guard:
        try:
            tr.fit(pipe, checkpoints=ckpts, preemption=guard)
        except Preempted:
            preempted = True
    return {"preempted": preempted, "step": tr.step, "saw_signal": guard.requested,
            "digest": params_digest(tr.teacher)}


def _refusal(fn):
    """(the exception's type name, its message) of fn(), or None."""
    try:
        fn()
    except (TypeError, ValueError) as e:
        return type(e).__name__, str(e)
    return None


def scenario_serve(spec, mesh):
    """`ClipService(mesh=)` on every rank: texts, images, an index and its
    search, the f32 and (`int8`) the int8 service; a follower's model is
    perturbed before each service is built, which must serve global rank
    0's weights anyway. With `refusals`, the services the mesh refuses."""
    from dclip_tpu_torch.core.config import CLIPConfig, MeshConfig
    from dclip_tpu_torch.data.tokenizer import HashTokenizer
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.parallel.mesh import make_mesh
    from dclip_tpu_torch.serve import ClipService

    cfg = CLIPConfig.tiny_test()
    model = CLIPModule(cfg, device="meta")
    model.load_state_dict(torch.load(spec["clip"], weights_only=True), strict=True, assign=True)
    model.eval()
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size, max_length=cfg.text.max_length)
    with np.load(spec["inputs"]) as z:
        arrays = {k: z[k] for k in z.files}
    images = [arrays[f"image{i}"] for i in range(int(arrays["n_images"]))]
    texts = spec["texts"]

    def perturbed():
        if mesh.global_rank:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(1.0)
        return model

    out = {}
    for quantize in [None] + (["int8"] if spec.get("int8") else []):
        svc = ClipService(perturbed(), cfg, tokenizer=tok, buckets=tuple(spec["buckets"]),
                          index_dim=cfg.projection_dim, quantize=quantize, mesh=mesh,
                          device="cpu")
        tag = quantize or "f32"
        out[f"{tag}/texts"] = svc.encode_texts(texts)
        out[f"{tag}/images"] = svc.encode_images(images)
        svc.add_to_index(spec["ids"], arrays["index"])
        out[f"{tag}/search"] = svc.search(arrays["queries"], k=spec["k"])
        out[f"{tag}/search_texts"] = svc.search_texts(texts[:3], k=spec["k"])
        out[f"{tag}/stats"] = svc.stats()
    if spec.get("refusals"):
        out["refusals"] = {
            "buckets": _refusal(lambda: ClipService(model, cfg, buckets=(1, 4), mesh=mesh,
                                                    device="cpu")),
            "model_axis": _refusal(lambda: ClipService(
                model, cfg, buckets=(4, 8), device="cpu",
                mesh=make_mesh(MeshConfig(data_parallel=1, model_parallel=mesh.size)))),
            "int": _refusal(lambda: ClipService(model, cfg, mesh=mesh.size, device="cpu")),
        }
    return out


SCENARIOS = {"losses": scenario_losses, "distill": scenario_distill,
             "teacher": scenario_teacher, "search": scenario_search,
             "preempt": scenario_preempt, "tp_forward": scenario_tp_forward,
             "meshes": scenario_meshes, "tp_ckpt": scenario_tp_ckpt,
             "serve": scenario_serve}


def main() -> int:
    with open(sys.argv[1]) as f:
        spec = json.load(f)
    from dclip_tpu_torch.cli.common import init_multihost
    from dclip_tpu_torch.core.config import MeshConfig
    from dclip_tpu_torch.parallel.mesh import make_mesh

    torch.manual_seed(1234 + int(os.environ["DCLIP_PROCESS_ID"]))  # no rank may depend on it
    init_multihost("cpu", timeout=120)
    try:
        dp, mp = spec.get("mesh", (-1, 1))
        mesh = make_mesh(MeshConfig(data_parallel=dp, model_parallel=mp))
        out = SCENARIOS[spec["scenario"]](spec, mesh)
        torch.save(out, f"{spec['out']}.rank{mesh.global_rank}.pt")
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
