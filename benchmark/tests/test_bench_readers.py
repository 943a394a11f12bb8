"""The readers of the backward's and the input's per-layer metrics
(`backward_ms`, `backward_roofline_pct`, `backward_idle_ms`,
`input_idle_ms`) on hand-built summaries: what each sums, its null on a
trace without the ranges that program version added, and the backward's
operations against the frozen counts."""
from __future__ import annotations

import json
import os

import pytest

from conftest import REPO

from benchmark import counts, manifest
from benchmark.frozen import flops

H100 = "NVIDIA H100 80GB HBM3"
SPANS = {"dclip.backward.loss": 0.004, "dclip.backward.text": 0.012,
         "dclip.backward.vision": 0.160}
OLD_RANGES = {"dclip.h2d": 0.05, "dclip.student_step": 0.2, "dclip.optimizer": 0.1,
              "dclip.backward": 1e-5}


def _reader(name):
    return manifest.load_module(os.path.join(REPO, "benchmark", "metrics", name + ".py"), name)


def _shapes(config="vit-b-16"):
    with open(os.path.join(REPO, "benchmark", "configs", config + ".json")) as f:
        return manifest.shapes(json.load(f))


def _summary(ranges, gaps, steps=8, batch=4, tokens=None, device=H100):
    tokens = tokens if tokens is not None else [8, 12, 24, 16] * 2
    return {"ranges_s": dict(ranges), "idle_gaps": [list(g) for g in gaps], "steps": steps,
            "batch": batch, "caption_tokens": tokens, "shapes": _shapes(),
            "device_name": device, "busy_s": 1.0, "window_s": 1.2, "cached": True,
            "images": steps * batch, "pool_batches": len(tokens) // batch}


def test_backward_ms_sums_the_three_spans_a_step():
    read = _reader("backward_ms").read
    assert read(_summary({**OLD_RANGES, **SPANS}, [], steps=8)) == pytest.approx(
        1e3 * 0.176 / 8)
    assert read(_summary({**OLD_RANGES, "dclip.backward.vision": 0.16}, [], steps=4)) == \
        pytest.approx(40.0)


@pytest.mark.parametrize("name", ["backward_ms", "backward_roofline_pct", "backward_idle_ms",
                                  "input_idle_ms"])
def test_every_reader_is_null_without_the_new_spans(name):
    gaps = [["dclip.backward", 0.3], ["dclip.h2d", 0.02], ["dclip.optimizer", 0.2]]
    assert _reader(name).read(_summary(OLD_RANGES, gaps)) is None


@pytest.mark.parametrize("name, gaps, want_ms", [
    ("backward_idle_ms", [["dclip.backward", 0.24], ["dclip.backward.text", 0.04],
                          ["dclip.backward.vision", 0.016], ["dclip.backward.loss", 0.008],
                          ["dclip.h2d", 0.5], ["dclip.optimizer", 0.3]], 38.0),
    ("input_idle_ms", [["dclip.backward", 0.24], ["dclip.cache_lookup", 0.048],
                       ["dclip.pack_text", 0.008], ["dclip.h2d", 0.024],
                       ["(outside every dclip range)", 0.4]], 10.0),
    ("backward_idle_ms", [["dclip.h2d", 0.5], ["dclip.optimizer", 0.3]], 0.0),
    ("input_idle_ms", [["dclip.backward", 0.24], ["dclip.optimizer", 0.3]], 0.0),
])
def test_the_idle_readers_sum_their_named_gaps(name, gaps, want_ms):
    got = _reader(name).read(_summary({**OLD_RANGES, **SPANS}, gaps, steps=8))
    assert got == pytest.approx(want_ms, abs=1e-12)


def test_the_idle_readers_read_with_the_input_spans_alone():
    ranges = {**OLD_RANGES, "dclip.pack_text": 0.001}
    gaps = [["dclip.pack_text", 0.016], ["dclip.backward", 0.08]]
    assert _reader("input_idle_ms").read(_summary(ranges, gaps, steps=8)) == pytest.approx(2.0)
    assert _reader("backward_idle_ms").read(_summary(ranges, gaps, steps=8)) == \
        pytest.approx(10.0)


@pytest.mark.parametrize("config", ["vit-b-16", "vit-l-14"])
def test_the_backward_operations_are_the_masked_step_less_the_forward(config):
    roofline = _reader("backward_roofline_pct")
    shapes = _shapes(config)
    full = [shapes.text.max_length] * 3
    per_image = (flops.student_step_flops_masked(shapes) - flops.vision_forward_flops(shapes)
                 - flops.text_forward_flops(shapes))
    assert roofline.backward_flops(shapes, 3, full) == pytest.approx(3 * per_image, rel=1e-12)
    # At the captions' real lengths the text part is twice their forward.
    short = [8, 12, 24]
    assert roofline.backward_flops(shapes, 0, short) == pytest.approx(
        2.0 * flops.text_tokens_forward_flops(shapes, short), rel=1e-12)
    vision = per_image - 2.0 * flops.text_forward_flops(shapes)
    assert roofline.backward_flops(shapes, 3, short) == pytest.approx(
        3 * vision + 2.0 * flops.text_tokens_forward_flops(shapes, short), rel=1e-12)


def test_backward_roofline_pct_is_the_least_time_over_the_span():
    roofline = _reader("backward_roofline_pct")
    tokens = [8, 12, 24, 16, 9, 9, 9, 9]
    summary = _summary({**OLD_RANGES, **SPANS}, [], steps=8, batch=4, tokens=tokens)
    shapes, peaks = summary["shapes"], flops.card_peaks(H100)
    least = [max(roofline.backward_flops(shapes, 4, t) / peaks.bf16,
                 (2 * (counts.vision_params(shapes) + counts.text_params(shapes))
                  + 4 * roofline.trainable_params(shapes)) / peaks.hbm)
             for t in (tokens[:4], tokens[4:])]
    want = 100.0 * (sum(least) / 2) * 8 / sum(SPANS.values())
    assert roofline.read(summary) == pytest.approx(want, rel=1e-12)
    assert roofline.read(_summary({**OLD_RANGES, **SPANS}, [], device="cpu")) is None


def test_the_trainable_count_is_the_default_masks():
    """The student's trainable elements by the port's own mask at the tiny
    size of the CPU tests."""
    import torch

    from dclip_tpu_torch.core.config import CLIPConfig
    from dclip_tpu_torch.models.weights import random_state_dict
    from dclip_tpu_torch.train.optim import student_trainable_mask

    cfg = CLIPConfig.tiny_test()
    sd = random_state_dict(cfg, 0)
    mask = student_trainable_mask(sd)
    want = sum(int(torch.tensor(sd[n].shape).prod()) for n, on in mask.items() if on)
    v, t = cfg.vision, cfg.text
    shapes = manifest.shapes({
        "text_config": dict(vocab_size=t.vocab_size, hidden_size=t.hidden_size,
                            num_hidden_layers=t.num_layers, num_attention_heads=t.num_heads,
                            intermediate_size=t.mlp_dim, max_position_embeddings=t.max_length,
                            layer_norm_eps=t.layer_norm_eps, eos_token_id=t.eos_token_id),
        "vision_config": dict(image_size=v.image_size, patch_size=v.patch_size,
                              hidden_size=v.hidden_size, num_hidden_layers=v.num_layers,
                              num_attention_heads=v.num_heads, intermediate_size=v.mlp_dim,
                              layer_norm_eps=v.layer_norm_eps),
        "teacher": {}, "projection_dim": cfg.projection_dim, "logit_scale_init_value": 2.6592})
    assert _reader("backward_roofline_pct").trainable_params(shapes) == want
