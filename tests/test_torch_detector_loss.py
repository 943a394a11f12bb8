"""The port's detector training against the JAX package on the CPU, on the
JAX loss test's config (3 classes, 64 px, width 8, depth 1) with the JAX
variables carried across (`models.weights.detector_state_dict_from_jax`):

- the train-mode forward: per-scale logits within 1e-4, and the running
  statistics after it within 1e-6, which holds only with flax's biased
  batch variance (torch's default update, unbiased, is shown to miss);
- the assignment (`fg`, `assigned` equal, `iou_t` and `ciou` close), the
  loss and each part within 1e-5 relative, every parameter gradient
  within 1e-4 relative L2, and the gradient that reaches the box head
  through the IoU in the class target (the full loss's box gradient less
  the same loss's with `iou_t` detached) against JAX's;
- `detection_step` keeps TF32 off for the backward as well as the
  forward;
- an overfit run with `torch.optim.Adam(2e-3)`: the loss halves and the
  mean CIoU at positives exceeds 0.5.

Ties: `jnp.clip` / `jnp.maximum` split the gradient at an exact tie, which
the port's `_clip` reproduces; `ops.nms.iou_matrix` clamps as `torch.clamp`
does (the whole gradient at a tie), and `test_no_tie_at_a_clip_edge` shows
the inputs here put no IoU operand at its clip edge.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.models import detector as jdet
from dclip_tpu.models import detector_loss as jloss
from dclip_tpu_torch.models import detector as det
from dclip_tpu_torch.models import detector_loss as ploss
from dclip_tpu_torch.models.weights import detector_state_dict_from_jax

KW = dict(num_classes=3, image_size=64, width=8, depth=1, max_detections=4, pre_nms_topk=16,
          score_threshold=0.1)
OUT_TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-6, atol=1e-6)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _variables(model, s, seed=0):
    """FlaxYOLO variables from numpy: 1/sqrt(fan_in) kernels, BatchNorm
    scale 1 + N(0, 0.1), bias and mean N(0, 0.1), var in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))))
    rng = np.random.RandomState(seed)

    def fill(path, x):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(x.shape) * np.prod(x.shape[:-1]) ** -0.5).astype(
                np.float32)
        if name == "var":
            return (0.5 + rng.rand(*x.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _batch(s):
    """Two images with a bright box each, and their GT sets (2 slots, the
    second of image 1 padding)."""
    rng = np.random.RandomState(0)
    images = np.asarray(rng.rand(2, s, s, 3), np.float32) * 0.2
    images[0, 8:32, 8:32] = 0.9
    images[1, 24:56, 24:56] = 0.9
    gt = np.asarray([[[8, 8, 32, 32], [36, 4, 60, 30]], [[24, 24, 56, 56], [0, 0, 0, 0]]],
                    np.float32)
    labels = np.asarray([[0, 1], [2, 0]], np.int32)
    mask = np.asarray([[1, 1], [1, 0]], np.float32)
    return images, gt, labels, mask


def _jax_reference(cfg, model, variables, images, gt, labels, mask):
    """JAX in float64 (`jax.enable_x64`): {"total", "parts", "outs", "stats",
    "grads" (wrt params), "box_grads" and "box_grads_detached" (wrt the box
    head outputs, the latter with `iou_t` under `stop_gradient`)}, as numpy.

    The reference runs in f64 because JAX's own f32 train-mode forward
    differs from its f64 value by up to 4e-4 (scale ~3), five times the
    port's f32 error: flax's fast variance E[x^2] - E[x]^2 over XLA's f32
    reductions. The port runs in f32, as it does on the card."""
    real = jloss.assign_targets

    def loss_of_outs(outs, detach):
        def assign(*a, **k):
            fg, assigned, iou_t = real(*a, **k)
            return fg, assigned, jax.lax.stop_gradient(iou_t) if detach else iou_t

        jloss.assign_targets = assign
        try:
            return jloss.detection_loss(cfg, outs, gt, labels, mask)
        finally:
            jloss.assign_targets = real

    def run(variables, images):
        def loss_fn(params):
            outs, mut = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    images, train=True, mutable=["batch_stats"])
            total, parts = loss_of_outs(outs, False)
            return total, (parts, outs, mut["batch_stats"])

        (total, (parts, outs, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            variables["params"])
        box = [jax.grad(lambda o: loss_of_outs(o, d)[0])(outs) for d in (False, True)]
        return dict(total=total, parts=parts, outs=outs, stats=stats, grads=grads,
                    box_grads=[g[0] for g in box[0]], box_grads_detached=[g[0] for g in box[1]])

    with jax.enable_x64(True):
        f64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        out = jax.jit(run)(f64, np.asarray(images, np.float64))
        return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def pair():
    jcfg, pcfg = jloss.DetectorConfig(**KW), det.DetectorConfig(**KW)
    model = jdet.FlaxYOLO(jcfg)
    s = jcfg.image_size
    variables = _variables(model, s)
    images, gt, labels, mask = _batch(s)
    want = _jax_reference(jcfg, model, variables, images, gt, labels, mask)
    return dict(jcfg=jcfg, pcfg=pcfg, model=model, variables=variables, images=images, gt=gt,
                labels=labels, mask=mask, want=want)


def _port_model(pair):
    model = det.YOLO(pair["pcfg"], device="meta")
    model.load_state_dict(detector_state_dict_from_jax(pair["variables"]), strict=True,
                          assign=True)
    return model.train()


def _port_step(pair, detach_iou=False, monkeypatch=None):
    """The port: (model after the step, outs, total, parts, box-head grads)."""
    model = _port_model(pair)
    if detach_iou:
        real = ploss.assign_targets

        def assign(*a, **k):
            fg, assigned, iou_t = real(*a, **k)
            return fg, assigned, iou_t.detach()
        monkeypatch.setattr(ploss, "assign_targets", assign)
    outs = model(_t(pair["images"]))
    for box, _ in outs:
        box.retain_grad()
    total, parts = ploss.detection_loss(pair["pcfg"], outs, _t(pair["gt"]), _t(pair["labels"]),
                                        _t(pair["mask"]))
    total.backward()
    return model, outs, total, parts, [box.grad for box, _ in outs]


def test_train_forward_and_batch_statistics_match_jax(pair):
    model, outs, _, _, _ = _port_step(pair)
    want_outs, want_stats = pair["want"]["outs"], pair["want"]["stats"]
    for (gb, gc), (wb, wc) in zip(outs, want_outs):
        np.testing.assert_allclose(gb.detach().numpy(), np.asarray(wb), **OUT_TOL)
        np.testing.assert_allclose(gc.detach().numpy(), np.asarray(wc), **OUT_TOL)
    got = model.state_dict()
    want = detector_state_dict_from_jax({"params": pair["variables"]["params"],
                                         "batch_stats": want_stats})
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(isinstance(m, det.FlaxBatchNorm2d) for m in model.modules())
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), err_msg=k, **STATS_TOL)


def test_torch_default_batchnorm_update_misses_jax(pair):
    """`nn.BatchNorm2d`'s own train mode (the unbiased variance in the
    running update) misses JAX's running variances by far more than the
    tolerance above, so that test fails if the port falls back to it."""
    model = _port_model(pair)
    for m in model.modules():
        if isinstance(m, det.FlaxBatchNorm2d):
            m.forward = torch.nn.BatchNorm2d.forward.__get__(m)
    with torch.no_grad():
        model(_t(pair["images"]))
    want = detector_state_dict_from_jax({"params": pair["variables"]["params"],
                                         "batch_stats": pair["want"]["stats"]})
    worst = max(np.abs(v.numpy() - want[k].numpy()).max()
                for k, v in model.state_dict().items() if k.endswith("running_var"))
    assert worst > 100 * STATS_TOL["atol"], worst


def test_assignment_and_ciou_match_jax(pair):
    jcfg, pcfg = pair["jcfg"], pair["pcfg"]
    outs = [(b.astype(np.float32), c.astype(np.float32)) for b, c in pair["want"]["outs"]]
    centers, strides = jloss.anchor_points(jcfg)
    box_logits, cls_logits = jloss.flatten_predictions(jcfg, outs)
    pred = jloss.decode_boxes(jcfg, box_logits, centers, strides)
    want = jloss.assign_targets(jcfg, pred, cls_logits, centers, pair["gt"], pair["labels"],
                                pair["mask"])
    p_centers, p_strides = ploss.anchor_points(pcfg)
    np.testing.assert_array_equal(p_centers.numpy(), np.asarray(centers))
    np.testing.assert_array_equal(p_strides.numpy(), np.asarray(strides))
    p_outs = [(_t(b), _t(c)) for b, c in outs]
    p_box, p_cls = ploss.flatten_predictions(pcfg, p_outs)
    p_pred = ploss.decode_boxes(pcfg, p_box, p_centers, p_strides)
    np.testing.assert_allclose(p_pred.numpy(), np.asarray(pred), rtol=1e-5, atol=1e-4)
    # The assigner on JAX's own decoded boxes, so that ties resolve alike.
    fg, assigned, iou_t = ploss.assign_targets(pcfg, _t(pred), p_cls, p_centers, _t(pair["gt"]),
                                               _t(pair["labels"]), _t(pair["mask"]))
    assert float(fg.sum()) > 0
    np.testing.assert_array_equal(fg.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(assigned.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(iou_t.numpy(), np.asarray(want[2]), rtol=1e-6, atol=1e-6)
    tgt = np.take_along_axis(pair["gt"], np.asarray(want[1])[..., None].astype(np.int64), 1)
    np.testing.assert_allclose(ploss.ciou(_t(pred), _t(tgt)).numpy(),
                               np.asarray(jloss.ciou(pred, tgt)), rtol=1e-5, atol=1e-6)
    a = np.asarray([[0.0, 0, 10, 10]], np.float32)
    np.testing.assert_allclose(ploss.ciou(_t(a), _t(a)).numpy(), 1.0, atol=1e-5)
    assert float(ploss.ciou(_t(a), _t(a + 20))[0]) < 0.0


def test_loss_parts_match_jax(pair):
    _, _, total, parts, _ = _port_step(pair)
    want_total, want_parts = pair["want"]["total"], pair["want"]["parts"]
    assert float(parts["num_pos"]) == float(want_parts["num_pos"]) > 0
    np.testing.assert_allclose(total.item(), float(want_total), rtol=LOSS_RTOL)
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss"):
        np.testing.assert_allclose(parts[k].item(), float(want_parts[k]), rtol=LOSS_RTOL,
                                   err_msg=k)


def test_parameter_gradients_match_jax(pair):
    """All parameter gradients together within 1e-4 relative L2 of JAX's;
    each tensor within 4e-4 (the worst, the last neck block's, sit near
    1e-4: BatchNorm over 8 values a channel at stride 32)."""
    model, _, _, _, _ = _port_step(pair)
    want = detector_state_dict_from_jax({"params": pair["want"]["grads"], "batch_stats": {}})
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    assert _rel_l2(np.concatenate([got[k].numpy().ravel() for k in want]),
                   np.concatenate([want[k].numpy().ravel() for k in want])) <= GRAD_RTOL
    errs = {k: _rel_l2(got[k].numpy(), want[k].numpy()) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 4 * GRAD_RTOL, (worst, errs[worst])


def test_gradient_through_the_iou_target_matches_jax(pair, monkeypatch):
    """JAX's `iou_t` carries no `stop_gradient`: the BCE term's gradient
    reaches the predicted boxes through the class target. That part alone
    (the full loss's box-head gradient less the gradient with `iou_t`
    detached) is non-zero and equal on both sides."""
    full = _port_step(pair)[4]
    detached = _port_step(pair, detach_iou=True, monkeypatch=monkeypatch)[4]
    want_full, want_detached = pair["want"]["box_grads"], pair["want"]["box_grads_detached"]
    got = np.concatenate([(g - d).numpy().ravel() for g, d in zip(full, detached)])
    want = np.concatenate([(np.asarray(g) - np.asarray(d)).ravel()
                           for g, d in zip(want_full, want_detached)])
    assert _rel_l2(got, want) <= GRAD_RTOL
    total = sum(float(np.linalg.norm(np.asarray(wg) - np.asarray(wd)))
                for wg, wd in zip(want_full, want_detached))
    assert total > 1e-3 * sum(float(np.linalg.norm(np.asarray(w))) for w in want_full)


def test_no_tie_at_a_clip_edge(pair):
    """The IoU operands that `iou_matrix` clamps and `ciou` clips never sit
    exactly at their edge on these inputs, so the tie rule of the clamp
    does not enter the gradients held above."""
    outs = [(b.astype(np.float32), c.astype(np.float32)) for b, c in pair["want"]["outs"]]
    jcfg = pair["jcfg"]
    centers, strides = jloss.anchor_points(jcfg)
    box_logits, _ = jloss.flatten_predictions(jcfg, outs)
    pred = np.asarray(jloss.decode_boxes(jcfg, box_logits, centers, strides))
    images, slots = np.nonzero(pair["mask"])  # the valid GTs
    gt, pr = pair["gt"][images, slots][:, None], pred[images]  # [V, 1, 4], [V, A, 4]
    rb = np.minimum(gt[..., 2:], pr[..., 2:])
    lt = np.maximum(gt[..., :2], pr[..., :2])
    assert not np.any(rb - lt == 0)
    assert not np.any(pred[..., 2:] - pred[..., :2] == 0)


def test_detection_step_keeps_tf32_off_through_the_backward(pair, monkeypatch):
    """`detection_step` runs the backward inside the f32 block: a hook on a
    convolution's weight gradient (it runs in the backward) sees the cuDNN
    TF32 flag off, and the process's flag is back on after the step."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    model = _port_model(pair)
    seen = []
    model.stem.conv.weight.register_hook(lambda g: seen.append(torch.backends.cudnn.allow_tf32))
    total, parts = ploss.detection_step(model, pair["pcfg"], _t(pair["images"]),
                                        _t(pair["gt"]), _t(pair["labels"]), _t(pair["mask"]))
    assert seen == [False]
    assert torch.backends.cudnn.allow_tf32 is True
    assert not total.requires_grad and float(total) == pytest.approx(float(pair["want"]["total"]),
                                                                     rel=LOSS_RTOL)
    assert model.stem.conv.weight.grad is not None


def test_eval_mode_is_unchanged_by_a_training_step(pair):
    """Eval mode normalizes with the running statistics, which a training
    step updates: the eval forward after a step equals `nn.BatchNorm2d`'s on
    the updated statistics."""
    model = _port_model(pair)
    ploss.detection_step(model, pair["pcfg"], _t(pair["images"]), _t(pair["gt"]),
                         _t(pair["labels"]), _t(pair["mask"]))
    model.eval()
    ref = det.Detector(pair["pcfg"], {k: v.detach() for k, v in model.state_dict().items()},
                       device="cpu")
    with torch.no_grad():
        got = model(_t(pair["images"]))
    for (gb, gc), (wb, wc) in zip(got, ref.logits(pair["images"])):
        np.testing.assert_array_equal(gb.numpy(), wb.numpy())
        np.testing.assert_array_equal(gc.numpy(), wc.numpy())


# The fewest steps that hold: the loss halves within 25, but eval mode's
# running statistics (momentum 0.97) trail the batch's until ~150 steps
# (mean CIoU 0.06 at 125, 0.36 at 150, 0.91 at 175 on this seed).
OVERFIT_STEPS = 175


@pytest.fixture
def one_thread():
    """One intra-op thread: a width-8 net's convolutions run 1.5x faster
    than on eight, which contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_overfit_with_adam(one_thread):
    """The JAX test's overfit run on the port: Adam(2e-3) on two fixed
    images with one box each (the JAX test takes 600 steps); the loss
    halves, and in eval mode the decoded boxes at the positives reach a
    mean CIoU above 0.5."""
    cfg = det.DetectorConfig(**KW)
    model = det.YOLO(cfg)
    model.load_state_dict(det.random_detector_state_dict(cfg, seed=0))
    model.train()
    images, gt, labels, mask = _batch(cfg.image_size)
    gt, labels, mask = _t(gt[:, :1]), _t(labels[:, :1]), _t(mask[:, :1])
    images = _t(images)
    opt = torch.optim.Adam(model.parameters(), lr=2e-3)
    first = None
    for _ in range(OVERFIT_STEPS):
        opt.zero_grad(set_to_none=True)
        total, _ = ploss.detection_step(model, cfg, images, gt, labels, mask)
        opt.step()
        first = float(total) if first is None else first
    assert float(total) < 0.5 * first, (first, float(total))
    model.eval()
    with torch.no_grad():
        outs = model(images)
        centers, strides = ploss.anchor_points(cfg)
        box_logits, cls_logits = ploss.flatten_predictions(cfg, outs)
        pred = ploss.decode_boxes(cfg, box_logits, centers, strides)
        fg, assigned, _ = ploss.assign_targets(cfg, pred, cls_logits, centers, gt, labels, mask)
        tgt = torch.gather(gt, 1, assigned.long()[..., None].expand(*assigned.shape, 4))
        mean_ciou = float((ploss.ciou(pred, tgt) * fg).sum() / fg.sum().clamp(min=1))
    assert mean_ciou > 0.5, mean_ciou
