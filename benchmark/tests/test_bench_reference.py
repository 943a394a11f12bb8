"""The yardstick on the CPU: the plain reference against the port's CPU
path at a tiny size, the weights' names against the port's modules, the
frozen FLOP counts against the port's, the trace arithmetic and the
per-layer readers."""
from __future__ import annotations

import subprocess
import sys

import pytest
import torch

from conftest import REPO, run_cell

from benchmark import counts, manifest, weights
from benchmark.frozen import flops, trace_math
from benchmark.frozen.trace_math import Event


@pytest.mark.parametrize("cell", ["tiny.uncached", "tiny.cached"])
def test_reference_agrees_with_the_port_on_the_cpu(tiny_root, cell, capsys):
    res = run_cell(tiny_root, cell, capsys=capsys)
    assert res["correct"] is True
    assert list(res)[-1] == "checks"
    for name, check in res["checks"].items():
        assert check["value"] <= 1e-5, (name, check)
    assert set(res["metrics"]) == {"train_images_per_s", "peak_mem_gib", "setup_s"}


def test_traced_run_on_the_cpu_reports_no_device_metric(tiny_root, capsys):
    res = run_cell(tiny_root, "tiny.uncached", trace=1, capsys=capsys)
    assert res["correct"] is True and res["metrics"] == {} and "breakdown" not in res


def test_reference_crop_matches_the_port():
    from dclip_tpu_torch.ops.image_ops import batch_crop_resize_normalize

    from benchmark.reference.teacher import crops

    g = torch.Generator().manual_seed(0)
    images = torch.rand(2, 40, 48, 3, generator=g)
    boxes = torch.rand(2, 3, 4, generator=g) * 20
    boxes[..., 2:] += boxes[..., :2] + 1.5
    ours = crops(images, boxes, 24)
    port = batch_crop_resize_normalize(images, boxes, 24).reshape(ours.shape)
    assert torch.allclose(ours, port, atol=1e-5)


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.step, benchmark.reference.teacher, benchmark.weights\n"
            "import benchmark.counts, benchmark.frozen.trace_math, benchmark.frozen.synthetic\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('dclip_tpu_torch', 'dclip_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n" % REPO)
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("config", ["vit-b-16", "vit-l-14"])
def test_weights_and_counts_follow_the_port(config):
    from dclip_tpu_torch.core import flops as port_flops
    from dclip_tpu_torch.core.config import CLIPConfig, TeacherConfig
    from dclip_tpu_torch.models.clip import CLIPModule
    from dclip_tpu_torch.models.teacher import PatchTextAggregation

    cell = manifest.resolve_cell(f"{config}.uncached", REPO)
    shapes = manifest.shapes(cell.config)
    port_cfg = CLIPConfig.from_name(config)
    tc = TeacherConfig(embed_dim=shapes.teacher.embed_dim, max_patches=8)
    model = CLIPModule(port_cfg, device="meta").state_dict()
    assert {n: tuple(s) for n, s, _ in weights.clip_specs(shapes)} == \
        {n: tuple(t.shape) for n, t in model.items()}
    xattn = PatchTextAggregation(tc, device="meta").state_dict()
    assert {n: tuple(s) for n, s, _ in weights.xattn_specs(shapes)} == \
        {n: tuple(t.shape) for n, t in xattn.items()}
    vision = sum(t.numel() for n, t in model.items() if n.startswith("vision_model.")) \
        + model["visual_projection.weight"].numel()
    text = sum(t.numel() for n, t in model.items() if n.startswith("text_model.")) \
        + model["text_projection.weight"].numel()
    assert (counts.vision_params(shapes), counts.text_params(shapes)) == (vision, text)
    for cached in (False, True):
        for frac in (1.0, 0.3):
            ours = flops.distill_step_flops(shapes, shapes, shapes.teacher, 256,
                                            teacher_cached=cached, reference_mask=True,
                                            text_rows_fraction=frac)
            port = port_flops.distill_step_flops(port_cfg, port_cfg, tc, 256,
                                                 teacher_cached=cached, reference_mask=True,
                                                 text_rows_fraction=frac)
            assert ours == port
    assert flops.text_tokens_forward_flops(shapes, [77]) == port_flops.text_forward_flops(port_cfg)
    assert {n: (p.bf16, p.hbm) for n, p in flops.CARD_PEAKS.items()} == \
        {n: (p.bf16, p.hbm) for n, p in port_flops.CARD_PEAKS.items()}


def test_weights_are_the_seeds():
    shapes = manifest.shapes(manifest.resolve_cell("vit-b-16.uncached", REPO).config)
    specs = weights.xattn_specs(shapes)
    a = weights.make(specs, 2 ** 31 + 5, "teacher_xattn", "cpu")
    b = weights.make(specs, 2 ** 31 + 5, "teacher_xattn", "cpu")
    c = weights.make(specs, 2 ** 31 + 6, "teacher_xattn", "cpu")
    name = "cross_modal_attention.text_to_image.in_proj_weight"
    assert torch.equal(a[name], b[name]) and not torch.equal(a[name], c[name])
    assert float(a["cross_modal_attention.norm_text.weight"].min()) == 1.0
    host = weights.make(specs, 2 ** 31 + 5, "teacher_xattn", "cpu", host=True)
    assert all(torch.equal(host[n], a[n]) for n in a)


def _ev(kind, name, start, end):
    return Event(kind, name, int(start * 1000), int(end * 1000))


def test_trace_arithmetic_takes_the_union_and_names_gaps():
    events = [
        _ev("host_range", trace_math.WINDOW_RANGE, 0, 100),
        _ev("host_range", "dclip.student_step", 5, 60),
        _ev("host_range", "dclip.optimizer", 40, 60),
        _ev("device_op", "k1", 10, 30),
        _ev("device_op", "k2", 20, 35),  # overlaps k1: counted once in busy
        _ev("device_op", "k3", 50, 55),  # launched inside the optimizer's range
        _ev("device_op", "k1", 70, 80),  # launched outside every range
        _ev("device_range", "dclip.student_step", 10, 35),
        _ev("device_range", "dclip.optimizer", 50, 55),
    ]
    s = trace_math.summarize(events, steps=1)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["ranges_s"] == pytest.approx({"dclip.student_step": 25e-6, "dclip.optimizer": 5e-6})
    assert s["device_ops"][0] == ["k1", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in s["idle_gaps"])
    assert gaps["dclip.student_step"] == pytest.approx(10e-6)
    assert gaps["dclip.optimizer"] == pytest.approx(15e-6)
    assert gaps[trace_math.NO_RANGE] == pytest.approx(35e-6)
    assert trace_math.summarize([_ev("host_range", "dclip.h2d", 0, 1)], 1) is None


def test_readers_on_a_summary():
    cell = manifest.resolve_cell("vit-b-16.uncached", REPO)
    shapes = manifest.shapes(cell.config)
    summary = {"window_s": 2.0, "busy_s": 1.5, "steps": 4, "images": 1024, "batch": 256,
               "cached": False, "shapes": shapes, "pool_batches": 1,
               "caption_tokens": [16] * 256, "device_name": "NVIDIA H100 80GB HBM3",
               "ranges_s": {"dclip.h2d": 0.1, "dclip.region_encode": 0.8,
                            "dclip.student_step": 0.2, "dclip.optimizer": 0.3}}
    got = {name: reader.read(summary) for name, reader in cell.readers.items()}
    assert got["h2d_ms"] == pytest.approx(25.0) and got["crop_ms"] is None
    assert got["optimizer_ms"] == pytest.approx(75.0)
    assert got["device_idle_pct"] == pytest.approx(25.0)
    peaks = flops.card_peaks("NVIDIA H100 80GB HBM3")
    least = counts.region_encode_least_s(shapes, 2048, peaks)
    assert got["region_encode_roofline_pct"] == pytest.approx(100 * least * 4 / 0.8)
    assert 0 < got["student_forward_roofline_pct"] < 100
    assert 0 < got["train_mfu"] < 100
    other = dict(summary, device_name="NVIDIA A100-SXM4-80GB")
    assert cell.readers["train_mfu"].read(other) is None
