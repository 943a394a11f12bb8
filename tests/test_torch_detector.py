"""The port's region-proposal stage against the JAX package on the CPU:

- `ops.nms`: `iou_matrix`, `nms` and `batched_class_nms` against the JAX
  ops (and `vmap` of them for a batch) on random boxes with planted score
  ties, near-duplicates, an IoU exactly at the threshold, class-aware
  overlaps and every edge of the output budget. Indices, scores, boxes and
  masks are equal, bit for bit.
- `models.detector`: the module's per-scale logits against `FlaxYOLO` on
  the same variables (`models.weights.detector_state_dict_from_jax`) at
  small geometry (width 8, depth 1 and 2, a `p5_ch` cap, 64-96 px), the
  nearest 2x upsample against `jax.image.resize` and the -inf padded
  max-pool against flax's; decode against JAX's decode; postprocess on the
  same decoded candidates (bit-equal); `detect` and `as_detect_fn` end to
  end.
- `models.detector_import`: a synthetic ultralytics-named state dict built
  from the port's `expected_manifest` through JAX's converter + `FlaxYOLO`
  and through the port's importer + module; the manifests of both
  packages; `infer_config` on every preset; missing and mismatched keys;
  the three file formats.

Tolerances: the networks are f32 on both sides, conv sums in another
order: logits within 1e-5 (|logit| ~ 1); decoded boxes within 1e-4 pixels
(coordinates up to ~100 px, DFL sums of 16 products).
"""
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.models import detector as jdet
from dclip_tpu.ops import nms as jnms
from dclip_tpu_torch.models import detector as det
from dclip_tpu_torch.models import detector_import as imp
from dclip_tpu_torch.models.weights import detector_state_dict_from_jax
from dclip_tpu_torch.ops import nms

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
BOX_TOL = dict(rtol=1e-5, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _hold_nms(got, want):
    """Every field of an NMSResult equal to the JAX one, bit for bit."""
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- NMS ------------------------------------------------------------------------------


def _nms_inputs(seed, n=40):
    """Random boxes with planted score ties, near-duplicates of the best
    boxes and one pair at IoU exactly 0.5."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2).astype(np.float32) * 50
    wh = 2 + rng.rand(n, 2).astype(np.float32) * 30
    boxes = np.concatenate([xy, xy + wh], 1)
    scores = rng.rand(n).astype(np.float32)
    scores[5] = scores[9] = scores[17] = scores.max()  # a three-way tie at the top
    boxes[9] = boxes[5] + 0.5  # a near-duplicate of a tied box
    boxes[20] = boxes[3] + np.asarray([0.2, -0.1, 0.1, 0.3], np.float32)
    boxes[30] = [0, 0, 2, 1]  # IoU with box 31 is exactly 0.5
    boxes[31] = [0, 0, 1, 1]
    scores[30], scores[31] = 0.97, 0.96
    return boxes, scores


def test_iou_matrix_matches_jax():
    boxes, _ = _nms_inputs(0)
    other = boxes[::-1].copy()
    other[0] = [5, 5, 5, 9]  # zero area
    np.testing.assert_array_equal(nms.iou_matrix(_t(boxes), _t(other)).numpy(),
                                  np.asarray(jnms.iou_matrix(jnp.asarray(boxes),
                                                             jnp.asarray(other))))
    assert nms.iou_matrix(_t(boxes[30:31]), _t(boxes[31:32])).item() == 0.5


@pytest.mark.parametrize("budget", [1, 7, 32, 45], ids=lambda b: f"budget{b}")
@pytest.mark.parametrize("iou_threshold,score_threshold",
                         [(0.45, 0.0), (0.5, 0.3), (0.1, 0.6), (0.45, 2.0)],
                         ids=["default", "at_half", "strict", "none_live"])
def test_nms_matches_jax(budget, iou_threshold, score_threshold):
    """One image: budgets below, at and above the survivor count (45 > N =
    40, so padding follows the last pick); no live box at all."""
    boxes, scores = _nms_inputs(1)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), iou_threshold, score_threshold,
                    budget)
    got = nms.nms(_t(boxes), _t(scores), iou_threshold, score_threshold, budget)
    _hold_nms(got, want)
    if score_threshold > 1:
        assert (got.indices == -1).all() and not got.mask.any()


def test_nms_rules():
    """Ties go to the first index; IoU exactly at the threshold keeps the
    box (suppression is strict); the pick suppresses itself; padding after
    the last live box."""
    boxes = np.asarray([[0, 0, 2, 1], [0, 0, 1, 1], [10, 10, 12, 12], [10, 10, 12, 12]],
                       np.float32)
    scores = np.asarray([0.9, 0.8, 0.7, 0.7], np.float32)
    got = nms.nms(_t(boxes), _t(scores), iou_threshold=0.5, max_outputs=5)
    assert got.indices.tolist() == [0, 1, 2, -1, -1]
    assert got.mask.tolist() == [1, 1, 1, 0, 0] and got.scores[3:].eq(0).all()
    assert not got.boxes[3:].any()
    _hold_nms(got, jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 0.0, 5))


@pytest.mark.parametrize("budget", [4, 32])
def test_batched_nms_matches_jax_vmap(budget):
    """A batch of images in one call equals `vmap` of the JAX op; the third
    image has no live box."""
    inputs = [_nms_inputs(s) for s in (2, 3, 4)]
    boxes = np.stack([b for b, _ in inputs])
    scores = np.stack([s for _, s in inputs])
    scores[2] = 0.0
    want = jax.vmap(lambda b, s: jnms.nms(b, s, 0.45, 0.25, budget))(jnp.asarray(boxes),
                                                                     jnp.asarray(scores))
    got = nms.nms(_t(boxes), _t(scores), 0.45, 0.25, budget)
    _hold_nms(got, want)
    assert (got.indices[2] == -1).all()


@pytest.mark.parametrize("batched", [False, True])
def test_class_aware_nms_matches_jax(batched):
    """Identical boxes of different classes both survive; of one class only
    the first does; random classes on the random boxes as well."""
    boxes, scores = _nms_inputs(5)
    classes = np.random.RandomState(5).randint(0, 4, size=len(scores)).astype(np.int32)
    boxes[1], classes[0], classes[1] = boxes[0], 0, 1  # same box, other class
    boxes[2], classes[2] = boxes[0], 0  # same box, same class
    scores[:3] = [1.5, 1.4, 1.3]  # above the planted top ties
    kw = dict(iou_threshold=0.45, score_threshold=0.1, max_outputs=16, class_offset=200.0)
    if batched:
        want = jax.vmap(lambda b, s, c: jnms.batched_class_nms(b, s, c, **kw))(
            jnp.asarray(np.stack([boxes, boxes[::-1]])), jnp.asarray(np.stack([scores, scores[::-1]])),
            jnp.asarray(np.stack([classes, classes[::-1]])))
        got = nms.batched_class_nms(_t(np.stack([boxes, boxes[::-1]])),
                                    _t(np.stack([scores, scores[::-1]])),
                                    _t(np.stack([classes, classes[::-1]])), **kw)
    else:
        want = jnms.batched_class_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      jnp.asarray(classes), **kw)
        got = nms.batched_class_nms(_t(boxes), _t(scores), _t(classes), **kw)
    _hold_nms(got, want)
    first = got.indices[0] if batched else got.indices
    assert first[:2].tolist() == [0, 1] and 2 not in first.tolist()


# -- the detector module --------------------------------------------------------------

CONFIGS = {
    "w8_d1_64px": dict(width=8, depth=1, image_size=64),
    "w8_d2_96px_p5cap": dict(width=8, depth=2, image_size=96, p5_ch=72, num_classes=5,
                             reg_max=8, max_detections=12, pre_nms_topk=40),
}


def _fill_variables(shapes, seed):
    """FlaxYOLO variables from numpy: 1/sqrt(fan_in) kernels, BatchNorm
    scale 1 + N(0, 0.1), bias and mean N(0, 0.1), var in [0.5, 1.5)."""
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(
                np.float32)
        if name == "var":
            return (0.5 + rng.rand(*s.shape)).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module", params=list(CONFIGS))
def pair(request):
    """(JAX config, port config, JAX variables, jitted JAX apply, port
    Detector on the CPU, images)."""
    kw = CONFIGS[request.param]
    jcfg, pcfg = jdet.DetectorConfig(**kw), det.DetectorConfig(**kw)
    model = jdet.FlaxYOLO(jcfg)
    s = jcfg.image_size
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, s, s, 3))))
    variables = _fill_variables(shapes, seed=len(request.param))
    apply = jax.jit(model.apply)
    port = det.Detector(pcfg, detector_state_dict_from_jax(variables), device="cpu")
    images = np.random.RandomState(3).rand(2, s, s, 3).astype(np.float32)
    return dict(jcfg=jcfg, pcfg=pcfg, variables=variables, apply=apply, port=port,
                images=images, jax_outs=apply(variables, images),
                jax_detector=jdet.Detector(jcfg, variables))


def test_state_dict_bridge_covers_the_module(pair):
    sd = detector_state_dict_from_jax(pair["variables"])
    want = det.YOLO(pair["pcfg"], device="meta").state_dict()
    assert set(sd) == set(want)
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in want.items())


def test_logits_match_jax(pair):
    got = pair["port"].logits(pair["images"])
    want = pair["jax_outs"]
    assert len(got) == 3
    for (gb, gc), (wb, wc), stride in zip(got, want, det.STRIDES):
        s = pair["pcfg"].image_size // stride
        assert tuple(gb.shape) == (2, s, s, 4 * pair["pcfg"].reg_max)
        assert tuple(gc.shape) == (2, s, s, pair["pcfg"].num_classes)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **LOGIT_TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **LOGIT_TOL)


def test_decode_and_postprocess_match_jax(pair):
    """Decode of the JAX logits against JAX's decode; postprocess of the
    same decoded candidates bit-equal to JAX's."""
    jcfg, pcfg = pair["jcfg"], pair["pcfg"]
    outs = pair["jax_outs"]
    wb, ws = jax.jit(lambda o: jdet.decode_predictions(jcfg, o))(outs)
    gb, gs = det.decode_predictions(pcfg, [(_t(b), _t(c)) for b, c in outs])
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **BOX_TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-7)
    want = jax.jit(lambda b, sc: jdet.postprocess(jcfg, b, sc))(wb, ws)
    got = det.postprocess(pcfg, _t(wb), _t(ws))
    for name in ("boxes", "scores", "classes", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert got.classes.dtype == torch.int32 and got.mask.sum() > 0


def test_postprocess_ties_and_budget():
    """Planted equal scores across anchors: the candidates keep
    `jax.lax.top_k`'s order (lower anchor first) and NMS picks the same
    boxes; a budget larger than the anchors pads."""
    jcfg = jdet.DetectorConfig(num_classes=3, image_size=64, max_detections=8, pre_nms_topk=10)
    pcfg = det.DetectorConfig(num_classes=3, image_size=64, max_detections=8, pre_nms_topk=10)
    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.rand(2, 84, 2) * 40, 8 + rng.rand(2, 84, 2) * 40], -1)
    boxes[..., 2:] += boxes[..., :2]
    boxes = (boxes - 5).astype(np.float32)  # some edges outside the frame: clipped
    scores = rng.rand(2, 84, 3).astype(np.float32)
    scores[:, 10:30] = 0.95  # ties for every candidate slot
    want = jax.jit(lambda b, sc: jdet.postprocess(jcfg, b, sc))(boxes, scores)
    got = det.postprocess(pcfg, _t(boxes), _t(scores))
    for name in ("boxes", "scores", "classes", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_detect_end_to_end_matches_jax(pair):
    want = pair["jax_detector"].detect(jnp.asarray(pair["images"]))
    got = pair["port"].detect(pair["images"])
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), **BOX_TOL)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6,
                               atol=1e-7)


def test_as_detect_fn_matches_jax(pair):
    """A non-square uint8 image: PIL bilinear resize, / 255, detect, boxes
    back in source pixels."""
    image = (np.random.RandomState(8).rand(50, 70, 3) * 255).astype(np.uint8)
    wb, wc = pair["jax_detector"].as_detect_fn()(image)
    gb, gc = pair["port"].as_detect_fn()(image)
    assert gb.dtype == np.float32 and gb.shape == wb.shape and gc.shape == wc.shape
    np.testing.assert_allclose(gb, wb, **BOX_TOL)
    np.testing.assert_allclose(gc, wc, rtol=1e-6, atol=1e-7)


def test_as_detect_fn_needs_pil(pair, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="needs PIL, which this installation lacks"):
        pair["port"].as_detect_fn()


def test_upsample_and_pool_match_jax():
    """Nearest 2x against `jax.image.resize` "nearest"; the SPPF pool on
    all-negative maps (where zero padding would differ from -inf) against
    flax's "SAME" max-pool."""
    import flax.linen as nn

    x = np.random.RandomState(2).standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = jax.image.resize(x, (2, 10, 14, 3), "nearest")
    got = det._upsample2(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    neg = -np.abs(x) - 1
    want = nn.max_pool(neg, (5, 5), strides=(1, 1), padding="SAME")
    got = torch.nn.functional.max_pool2d(_t(neg).permute(0, 3, 1, 2), 5, 1, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_presets_and_head_widths_match_jax():
    for name in ("v8n", "v8s", "v8m", "v8l", "v8x"):
        j, p = getattr(jdet.DetectorConfig, name)(), getattr(det.DetectorConfig, name)()
        assert dataclasses.asdict(j) == dataclasses.asdict(p)
        assert (j.p5, j.head_box_ch, j.head_cls_ch) == (p.p5, p.head_box_ch, p.head_cls_ch)


def test_initialize_f32_pin_and_device_rules(monkeypatch):
    cfg = det.DetectorConfig(width=8, image_size=64)
    d = det.Detector.initialize(cfg, seed=0, device="cpu")
    again = det.random_detector_state_dict(cfg, seed=0)
    assert all(torch.equal(v, again[k]) for k, v in d.model.state_dict().items())
    out = d.detect(np.random.RandomState(0).rand(1, 64, 64, 3))
    assert tuple(out.boxes.shape) == (1, 32, 4) and tuple(out.mask.shape) == (1, 32)
    assert out.classes.dtype == torch.int32
    prev = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with det.f32_convolutions():
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cpu"):
        det.Detector.initialize(cfg)


def test_f32_pin_holds_across_threads():
    """Two threads' pinned blocks, the second started while the first is
    open: the flag is False inside both and True after both. The module
    lock holds the second block back until the first has restored the
    flag; without it the second saves False and restores False last."""
    prev = torch.backends.cudnn.allow_tf32
    a_open, b_open = threading.Event(), threading.Event()
    seen = []

    def first():
        with det.f32_convolutions():
            a_open.set()
            b_open.wait(0.2)
            seen.append(torch.backends.cudnn.allow_tf32)

    def second():
        a_open.wait()
        with det.f32_convolutions():
            b_open.set()
            time.sleep(0.05)
            seen.append(torch.backends.cudnn.allow_tf32)

    try:
        torch.backends.cudnn.allow_tf32 = True
        threads = [threading.Thread(target=f) for f in (first, second)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == [False, False]
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev


# -- the ultralytics import ------------------------------------------------------------


def _ultralytics_sd(cfg, seed, prefix="model."):
    """An ultralytics-named state dict of the manifest's shapes (OIHW),
    with the keys the import drops (DFL conv, num_batches_tracked)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for key, shape in imp.expected_manifest(cfg).items():
        if key.endswith("running_var"):
            v = 0.5 + rng.rand(*shape)
        elif len(shape) == 4:
            v = rng.standard_normal(shape) * np.prod(shape[1:]) ** -0.5
        else:
            v = 0.1 * rng.standard_normal(shape) + (1.0 if key.endswith("bn.weight") else 0.0)
        sd[prefix + key[len("model."):]] = v.astype(np.float32)
        if key.endswith("running_var"):
            sd[prefix + key[len("model."):-len("running_var")] + "num_batches_tracked"] = \
                np.asarray(7)
    sd[prefix + "22.dfl.conv.weight"] = np.arange(cfg.reg_max, dtype=np.float32).reshape(
        1, cfg.reg_max, 1, 1)
    return sd


def test_import_matches_jax_import(pair):
    """One ultralytics state dict through both importers: the port's import
    equals the bridge of JAX's, and both networks agree on it."""
    from dclip_tpu.models.detector_import import convert_ultralytics_state_dict as jax_convert

    pcfg = pair["pcfg"]
    sd = _ultralytics_sd(pcfg, seed=11)
    variables = jax_convert(pair["jcfg"], sd)
    port_sd = imp.convert_ultralytics_state_dict(pcfg, {"model." + k: v for k, v in sd.items()})
    bridged = detector_state_dict_from_jax(variables)
    assert set(bridged) == set(port_sd)
    for k, v in port_sd.items():
        np.testing.assert_array_equal(v.numpy(), bridged[k].numpy(), err_msg=k)
    want = pair["apply"](variables, pair["images"])
    got = det.Detector(pcfg, port_sd, device="cpu").logits(pair["images"])
    for (gb, gc), (wb, wc) in zip(got, want):
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), **LOGIT_TOL)
        np.testing.assert_allclose(gc.numpy(), np.asarray(wc), **LOGIT_TOL)


@pytest.mark.parametrize("preset", ["v8n", "v8x"])
def test_manifest_matches_jax(preset):
    from dclip_tpu.models.detector_import import expected_manifest as jax_manifest

    cfg = getattr(det.DetectorConfig, preset)()
    assert imp.expected_manifest(cfg) == jax_manifest(getattr(jdet.DetectorConfig, preset)())


@pytest.mark.parametrize("preset", ["v8n", "v8s", "v8m", "v8l", "v8x"])
def test_infer_config_recovers_presets(preset):
    """Shapes alone (zero-stride arrays, no memory) give the preset back."""
    cfg = getattr(det.DetectorConfig, preset)()
    sd = {k: np.broadcast_to(np.float32(0), s) for k, s in imp.expected_manifest(cfg).items()}
    def arch(c):
        return (c.width, c.depth, c.p5, c.reg_max, c.num_classes, c.image_size)

    assert arch(imp.infer_config(sd)) == arch(cfg)
    assert arch(imp.infer_config({"model." + k: v for k, v in sd.items()}, image_size=320)) \
        == arch(dataclasses.replace(cfg, image_size=320))


def test_import_refuses_missing_and_mismatched_keys():
    cfg = det.DetectorConfig(**CONFIGS["w8_d1_64px"])
    sd = _ultralytics_sd(cfg, seed=1)
    missing = dict(sd)
    missing.pop("model.21.m.0.cv2.bn.running_mean")
    with pytest.raises(ValueError, match="missing 1 keys"):
        imp.convert_ultralytics_state_dict(cfg, missing)
    bad = dict(sd, **{"model.22.cv3.1.2.weight": np.zeros((3, 32, 1, 1), np.float32)})
    with pytest.raises(ValueError, match="model.22.cv3.1.2.weight"):
        imp.convert_ultralytics_state_dict(cfg, bad)
    with pytest.raises(ValueError, match="missing"):
        imp.convert_ultralytics_state_dict(dataclasses.replace(cfg, depth=2), sd)


@pytest.mark.parametrize("fmt", ["pt", "npz", "safetensors"])
def test_load_checkpoint_formats(tmp_path, fmt):
    cfg = det.DetectorConfig(**CONFIGS["w8_d1_64px"])
    sd = _ultralytics_sd(cfg, seed=2)
    path = str(tmp_path / f"yolo.{fmt}")
    if fmt == "pt":
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, path)
    elif fmt == "npz":
        np.savez(path, **sd)
    else:
        from dclip_tpu_torch.models.hf_export import save_safetensors

        save_safetensors(path, {k: np.ascontiguousarray(v) for k, v in sd.items()})
    got_cfg, got = imp.load_ultralytics_checkpoint(path, image_size=64)
    assert got_cfg == dataclasses.replace(cfg, p5_ch=cfg.p5)
    want = imp.convert_ultralytics_state_dict(cfg, sd)
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
