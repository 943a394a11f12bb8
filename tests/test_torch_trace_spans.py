"""The distillation step's profiler ranges on the CPU at the tiny preset
(dclip_tpu_torch.core.metrics.BackwardSpans, DistillTrainer): the
backward's three spans, opened and closed once each on the thread that
runs the backward, in the order loss -> text -> vision, disjoint, each
holding its part's gradient work; the input's `dclip.cache_lookup` and
`dclip.pack_text` at the top of the step, inside none of the ranges the
benchmark's metrics read; no node and no hook in the graph while no
profiler records; the same numbers, bit for bit, with the profiler on and
off; and `device_time_by_range`'s interval arithmetic."""
import numpy as np
import pytest
import torch

from dclip_tpu_torch.cli.common import synthetic_distill_batch
from dclip_tpu_torch.core import metrics
from dclip_tpu_torch.core.config import CLIPConfig, DistillConfig, TeacherConfig
from dclip_tpu_torch.models.weights import random_state_dict, random_teacher_state_dict
from dclip_tpu_torch.parallel.mesh import local_mesh
from dclip_tpu_torch.train import distill_trainer
from dclip_tpu_torch.train.distill_trainer import DistillTrainer, TeacherTargetCache

B, P = 4, 4
SPANS = ("dclip.backward.loss", "dclip.backward.text", "dclip.backward.vision")
METRIC_RANGES = ("dclip.h2d", "dclip.crop", "dclip.region_encode", "dclip.student_step",
                 "dclip.optimizer")
ACCUMULATE = "autograd::engine::evaluate_function: torch::autograd::AccumulateGrad"
# The student's routes on the CPU: plain modules, the kernels' twins with
# packed captions, and the twins under activation recomputation.
ROUTES = {"plain": dict(use_pallas=False, packed_text=False),
          "kernels_packed": dict(use_pallas=True, packed_text=True),
          "remat": dict(use_pallas=True, packed_text=True, remat=True)}


def _trainer(cached=False, **changes):
    cfg = CLIPConfig.tiny_test()
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=cfg.text.max_length)
    dcfg = DistillConfig(train_batch_size=B, learning_rate=1e-3, accumulate_grad_batches=1,
                         teacher=tcfg, student_model="tiny", teacher_clip_model="tiny",
                         compute_dtype="float32", **changes)
    sd = random_state_dict(cfg, 0)
    cache = TeacherTargetCache(salt="spans") if cached else None
    trainer = DistillTrainer(dcfg, sd, sd, random_teacher_state_dict(tcfg, 1), cfg, cfg,
                             device="cpu", teacher_cache=cache, mesh=local_mesh())
    batch = synthetic_distill_batch(cfg, tcfg, B, np.random.RandomState(3))
    batch["index"] = np.arange(B, dtype=np.int64)
    return trainer, batch


def _profiled_steps(trainer, batch, steps=1):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(steps):
            trainer.train_step_on_batch(batch)
    return prof.events()


def _named(events, name):
    return sorted((e for e in events if e.name == name), key=lambda e: e.time_range.start)


def _inside(e, span):
    return (e.thread == span.thread
            and span.time_range.start <= e.time_range.start <= span.time_range.end)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_backward_spans_open_once_in_order_on_the_backward_thread(route):
    """Two traced steps: the first hooks the accumulators, the second reuses
    them."""
    trainer, batch = _trainer(**ROUTES[route])
    events = _profiled_steps(trainer, batch, steps=2)
    found = [_named(events, name) for name in SPANS]
    assert [len(f) for f in found] == [2, 2, 2]
    outers = _named(events, "dclip.backward")
    writes = [e for e in events if e.name == ACCUMULATE]
    assert len(writes) == 2 * sum(len(v) for v in trainer._tower_leaves.values())
    for step, outer in enumerate(outers):
        loss, text, vision = spans = [f[step] for f in found]
        assert len({s.thread for s in spans}) == 1
        assert loss.time_range.end <= text.time_range.start
        assert text.time_range.end <= vision.time_range.start
        # The caller's range holds all three: the idle before and between them.
        assert outer.time_range.start <= loss.time_range.start
        assert vision.time_range.end <= outer.time_range.end
        # Each tower's span holds the writes of exactly its trainable
        # leaves' gradients; the loss's holds the loss's own backward.
        assert [sum(_inside(e, s) for e in writes) for s in spans] == [
            0, len(trainer._tower_leaves["text"]), len(trainer._tower_leaves["vision"])]
        loss_ops = [e.name for e in events if _inside(e, loss)
                    and e.name.startswith("autograd::engine::evaluate_function")]
        assert loss_ops and not any("Embedding" in n or "Index" in n for n in loss_ops)
        # Every backward node but the identities that open the spans lies in one.
        nodes = [e for e in events if e.thread == loss.thread
                 and outer.time_range.start <= e.time_range.start <= outer.time_range.end
                 and e.name.startswith("autograd::engine::evaluate_function")
                 and not e.name.endswith("_OpenSpanBackward")]
        assert nodes and [e.name for e in nodes if not any(_inside(e, s) for s in spans)] == []


@pytest.mark.parametrize("cache", ["none", "device_level", "host_level"])
def test_input_spans_sit_at_the_top_of_the_step(cache):
    cached = cache != "none"
    trainer, batch = _trainer(cached=cached, device_target_cache=cache == "device_level",
                              **ROUTES["kernels_packed"])
    for step in range(2):  # cached: a miss that fills the cache, then a hit
        events = _profiled_steps(trainer, batch)
        names = ("dclip.pack_text",) + (("dclip.cache_lookup",) if cached else ())
        for name in names:
            found = _named(events, name)
            assert len(found) == 1, (step, name)
            for outer in METRIC_RANGES:
                for o in _named(events, outer):
                    assert not (o.time_range.start <= found[0].time_range.start
                                <= o.time_range.end), (step, name, outer)
        if not cached:
            assert not _named(events, "dclip.cache_lookup")


def _graph(loss):
    """Type names of every node reachable from the loss, sorted."""
    seen, todo, out = set(), [loss.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or id(node) in seen:
            continue
        seen.add(id(node))
        out.append(type(node).__name__)
        todo.extend(n for n, _ in node.next_functions)
    return sorted(out)


def _loss_graph(trainer, batch):
    d = trainer._device_batch(batch, trainer._STUDENT_FIELDS)
    d = trainer._maybe_pack_text(batch, d)
    targets = torch.randn(B, trainer.cfg.teacher.embed_dim)
    loss, _ = trainer._student_loss(targets, targets, d)
    return _graph(loss)


def test_without_a_profiler_the_graph_gains_no_node_and_no_hook(monkeypatch):
    trainer, batch = _trainer(**ROUTES["kernels_packed"])
    untraced = _loss_graph(trainer, batch)
    with monkeypatch.context() as m, torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        m.setattr(distill_trainer, "profiling", lambda: False)  # the spans disabled
        disabled = _loss_graph(trainer, batch)
    assert untraced == disabled
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = _loss_graph(trainer, batch)
    added = list(traced)
    for name in untraced:
        added.remove(name)
    assert added == ["_OpenSpanBackward"] * 3

    # The accumulators are hooked once, in the first traced backward, fire
    # in every traced one, and are gone from the first untraced step on.
    hooked, fired = [], []
    own_edge, own_written = torch.autograd.graph.get_gradient_edge, metrics.BackwardSpans._written
    monkeypatch.setattr(torch.autograd.graph, "get_gradient_edge",
                        lambda t: hooked.append(t) or own_edge(t))
    monkeypatch.setattr(metrics.BackwardSpans, "_written",
                        lambda self, name: fired.append(name) or own_written(self, name))
    leaves = sum(len(v) for v in trainer._tower_leaves.values())
    counts = []
    for traced in (False, True, True, False, True):
        if traced:
            _profiled_steps(trainer, batch)
        else:
            trainer.train_step_on_batch(batch)
        counts.append((len(hooked), len(fired)))
    assert counts == [(0, 0), (leaves, leaves), (leaves, 2 * leaves), (leaves, 2 * leaves),
                      (2 * leaves, 3 * leaves)]
    for p in trainer.student.parameters():
        assert p._backward_hooks is None and p._post_accumulate_grad_hooks is None


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_profiled_step_is_bit_equal(route):
    runs = []
    for traced in (False, True):
        trainer, batch = _trainer(**ROUTES[route])
        trainer.train_step_on_batch(batch)  # one update: AdamW's state in play
        if traced:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                parts = trainer.train_step_on_batch(batch)
        else:
            parts = trainer.train_step_on_batch(batch)
        grads = {n: p.grad.clone() for n, p in trainer.student.named_parameters()
                 if p.grad is not None}
        params = {n: p.detach().clone() for n, p in trainer.student.named_parameters()}
        runs.append(({k: v.item() for k, v in parts.items()}, grads, params))
    (parts0, grads0, params0), (parts1, grads1, params1) = runs
    assert parts0 == parts1
    assert grads0.keys() == grads1.keys() and len(grads0) > 0
    for name in grads0:
        assert torch.equal(grads0[name], grads1[name]), name
    for name in params0:
        assert torch.equal(params0[name], params1[name]), name


@pytest.mark.parametrize("ops, spans, busy, unranged", [
    ([], [], 0, 0),
    ([(0, 10)], [], 10, 10),
    ([(0, 10)], [(0, 10)], 10, 0),
    # overlapping streams count once; a range over a gap holds no work
    ([(0, 10), (5, 20), (30, 40)], [(8, 12), (15, 35)], 30, 16),
    ([(0, 4), (6, 10)], [(2, 8)], 8, 4),
    ([(0, 100)], [(10, 20), (15, 30), (50, 60)], 100, 70),
])
def test_busy_and_unranged_from_intervals(ops, spans, busy, unranged):
    assert metrics.busy_and_unranged(ops, spans) == (busy, unranged)


def test_the_hooked_accumulators_keep_no_trainer_alive():
    import gc
    import weakref

    trainer, batch = _trainer(**ROUTES["plain"])
    _profiled_steps(trainer, batch)
    assert trainer._spans._towers  # the accumulators are held between traced steps
    leaf = weakref.ref(trainer._tower_leaves["vision"][0])
    spans = weakref.ref(trainer._spans)
    del trainer
    gc.collect()
    assert leaf() is None and spans() is None
