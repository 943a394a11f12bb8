"""The port's context view against the JAX package on the CPU:

- `ops.image_ops.black_out_boxes` bit-equal to JAX's, over fractional,
  whole-frame, degenerate, zero and out-of-frame boxes;
- `resize_frames` and `resize_center_crop` (the antialiased bilinear
  resize of `jax.image.resize`) within 1e-5 of JAX's, shrinking and
  growing, with a side that keeps its size;
- `models.teacher.encode_patches_with_context` on `CLIPConfig.tiny_test()`
  in f32 within 1e-5 of JAX's, 3 of 8 slots invalid, through the module
  path and the block-kernel twins (`fused_image_features`' route on the
  CPU), and JAX's property: a whole-frame box gives the all-black
  embedding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dclip_tpu.core.config import CLIPConfig
from dclip_tpu.models import teacher as jteacher
from dclip_tpu.ops import image_ops as jops
from dclip_tpu_torch.models import teacher
from dclip_tpu_torch.ops import image_ops

import torch_parity

PIXEL_TOL = dict(rtol=0, atol=1e-5)
EMB_TOL = dict(rtol=0, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_black_out_boxes_is_bit_equal_to_jax():
    rng = np.random.RandomState(0)
    images = rng.rand(2, 12, 10, 3).astype(np.float32)
    boxes = np.asarray([[[2.0, 2.0, 5.0, 6.0], [0.0, 0.0, 10.0, 12.0], [3.5, 1.2, 7.7, 9.9]],
                        [[0.0, 0.0, 0.0, 0.0], [-4.0, 8.0, 3.0, 20.0], [6.0, 6.0, 6.0, 9.0]]],
                       np.float32)
    got = image_ops.black_out_boxes(_t(images), _t(boxes)).numpy()
    want = np.asarray(jops.black_out_boxes(jnp.asarray(images), jnp.asarray(boxes)))
    assert got.shape == (2, 3, 12, 10, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not got[0, 1].any()  # the whole frame
    np.testing.assert_array_equal(got[1, 0], images[1])  # a zero box: the frame as it is
    np.testing.assert_array_equal(got[1, 2], images[1])  # zero width


@pytest.mark.parametrize("shape, out", [((30, 20), (12, 20)), ((20, 30), (41, 25)),
                                        ((17, 17), (17, 40)), ((9, 14), (9, 14))],
                         ids=["shrink_h", "grow_h_shrink_w", "grow_w", "same"])
def test_resize_frames_matches_jax(shape, out):
    images = np.random.RandomState(1).rand(3, *shape, 3).astype(np.float32)
    got = image_ops.resize_frames(_t(images), *out).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(images), (3, *out, 3), "bilinear"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **PIXEL_TOL)


@pytest.mark.parametrize("shape, size", [((300, 200), 224), ((100, 150), 224),
                                         ((300, 200), 64), ((100, 150), 48)],
                         ids=["300x200_grow", "100x150_grow", "300x200_shrink",
                              "100x150_shrink"])
def test_resize_center_crop_matches_jax(shape, size):
    image = np.random.RandomState(2).rand(*shape, 3).astype(np.float32)
    got = image_ops.resize_center_crop(_t(image), size).numpy()
    want = np.asarray(jops.resize_center_crop(jnp.asarray(image), size))
    assert got.shape == want.shape == (size, size, 3)
    np.testing.assert_allclose(got, want, **PIXEL_TOL)


@pytest.fixture(scope="module")
def tiny():
    cfg = CLIPConfig.tiny_test()
    model, params = torch_parity.jax_clip(cfg, seed=0)
    return cfg, model, params, torch_parity.port_clip(cfg, params)


def _context_inputs(cfg):
    """B = 2 frames of 40 x 36 (resized to the tower's 32: shrinking), 4
    boxes each, 3 of the 8 slots invalid; one box the whole frame."""
    rng = np.random.RandomState(6)
    images = rng.rand(2, 40, 36, 3).astype(np.float32)
    boxes = rng.rand(2, 4, 4).astype(np.float32) * 18
    boxes[..., 2:] += boxes[..., :2] + 3
    boxes[0, 0] = [0.0, 0.0, 36.0, 40.0]
    boxes[1, 3] = [-3.0, 10.5, 50.0, 22.25]
    mask = np.ones((2, 4), np.float32)
    mask[0, 2] = mask[1, 0] = mask[1, 1] = 0.0
    return images, boxes, mask


@pytest.mark.parametrize("route", ["module", "block_twins"])
def test_encode_patches_with_context_matches_jax(tiny, route):
    cfg, model, params, port = tiny
    images, boxes, mask = _context_inputs(cfg)
    s = cfg.vision.image_size
    want_pe, want_ce = jteacher.encode_patches_with_context(model, {"params": params}, images,
                                                            boxes, mask, s)
    fn = None
    if route == "block_twins":
        w = port.pack_image_weights()
        fn = lambda px: port.get_image_features(px, w)  # noqa: E731
    with torch.no_grad():
        pe, ce = teacher.encode_patches_with_context(port, _t(images), _t(boxes), _t(mask), s,
                                                     fn)
    assert pe.shape == ce.shape == (2, 4, cfg.projection_dim)
    np.testing.assert_allclose(pe.numpy(), np.asarray(want_pe), **EMB_TOL)
    np.testing.assert_allclose(ce.numpy(), np.asarray(want_ce), **EMB_TOL)
    invalid = mask == 0
    assert not pe.numpy()[invalid].any() and not ce.numpy()[invalid].any()
    assert np.abs(ce.numpy()[~invalid]).min() > 0


def test_whole_frame_box_gives_the_black_embedding(tiny):
    cfg, _, _, port = tiny
    images, boxes, mask = _context_inputs(cfg)
    s = cfg.vision.image_size
    with torch.no_grad():
        pe, ce = teacher.encode_patches_with_context(port, _t(images), _t(boxes), _t(mask), s)
        black = port.image_features(image_ops.normalize(torch.zeros(1, s, s, 3)))
        want_pe = teacher.encode_patches(port, _t(images), _t(boxes), _t(mask), s)
    np.testing.assert_allclose(ce[0, 0].numpy(), black[0].numpy(), atol=1e-6)
    np.testing.assert_array_equal(pe.numpy(), want_pe.numpy())
    assert not np.allclose(ce[0, 1].numpy(), black[0].numpy(), atol=1e-4)
