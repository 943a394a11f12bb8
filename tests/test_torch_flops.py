"""The port's FLOP counts and card peaks (`dclip_tpu_torch.core.flops`)
against the JAX package's `dclip_tpu.core.flops`: the five counts give
bit-equal floats over every preset and option, the hand checks of
`tests/test_fast_paths.py` hold on the port, `mfu` has no peak on the CPU
or on a card the table does not name, and the profiling modules import
nothing of JAX."""
import itertools
import os
import subprocess
import sys

import pytest
import torch

from dclip_tpu.core import config as jax_config
from dclip_tpu.core import flops as jax_flops
from dclip_tpu_torch.core import config as port_config
from dclip_tpu_torch.core import flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESETS = ("tiny", "vit-b-32", "vit-b-16", "vit-l-14")
SXM = "NVIDIA H100 80GB HBM3"


def _configs(module, preset):
    cfg = module.CLIPConfig.from_name(preset)
    tcfg = module.TeacherConfig(embed_dim=cfg.projection_dim, num_heads=8, max_patches=8,
                                max_text_tokens=cfg.text.max_length)
    return cfg, tcfg


@pytest.mark.parametrize("preset,cached,masked,text_frac", list(itertools.product(
    PRESETS, (False, True), (False, True), (1.0, 0.25))))
def test_counts_equal_jax_exactly(preset, cached, masked, text_frac):
    jcfg, jt = _configs(jax_config, preset)
    pcfg, pt = _configs(port_config, preset)
    assert flops.vision_forward_flops(pcfg) == jax_flops.vision_forward_flops(jcfg)
    assert flops.vision_forward_flops(pcfg, 336) == jax_flops.vision_forward_flops(jcfg, 336)
    assert flops.text_forward_flops(pcfg) == jax_flops.text_forward_flops(jcfg)
    assert flops.cross_attention_flops(pt) == jax_flops.cross_attention_flops(jt)
    assert flops.student_step_flops_masked(pcfg, text_frac) == \
        jax_flops.student_step_flops_masked(jcfg, text_frac)
    kw = dict(teacher_cached=cached, reference_mask=masked, text_rows_fraction=text_frac)
    assert flops.distill_step_flops(pcfg, pcfg, pt, 256, **kw) == \
        jax_flops.distill_step_flops(jcfg, jcfg, jt, 256, **kw)
    assert flops.distill_step_flops(pcfg, pcfg, pt, 32, n_crops=5, teacher_image_size=336,
                                    **kw) == \
        jax_flops.distill_step_flops(jcfg, jcfg, jt, 32, n_crops=5, teacher_image_size=336,
                                     **kw)


def test_analytic_flops_accounting():
    """The hand checks of tests/test_fast_paths.py::test_analytic_flops_accounting,
    on the port."""
    cfg = port_config.CLIPConfig.vit_b_16()
    v = flops.vision_forward_flops(cfg)
    s, d, m = 197, 768, 3072
    per_layer = 8 * s * d * d + 4 * s * s * d + 4 * s * d * m
    expected = 2 * 196 * (3 * 16 * 16) * d + 12 * per_layer + 2 * d * 512
    assert v == expected
    assert 30e9 < v < 40e9
    t = flops.text_forward_flops(cfg)
    assert 4e9 < t < 8e9
    tc = port_config.TeacherConfig(embed_dim=512, num_heads=8, max_patches=8)
    step = flops.distill_step_flops(cfg, cfg, tc, batch=64)
    per_image = step / 64
    assert 8 * v < per_image < 8 * v + 4 * (v + t)

    masked = flops.student_step_flops_masked(cfg)
    patch_embed = 2 * 196 * (3 * 16 * 16) * d
    attn_dw = 12 * 8 * s * d * d + 2 * d * 512
    assert masked == pytest.approx(2 * v - patch_embed + attn_dw + 3 * t)
    assert 0.7 * 3 * (v + t) < masked < 3 * (v + t)
    step_true = flops.distill_step_flops(cfg, cfg, tc, batch=64, reference_mask=True)
    assert step_true < step
    assert step_true / 64 == pytest.approx(step / 64 - 3 * (v + t) + masked)


def test_mfu_has_no_peak_on_the_cpu_or_an_unnamed_card(monkeypatch):
    assert flops.mfu(1e15, "cpu", "bfloat16") is None
    assert flops.mfu(1e15, torch.device("cpu"), "float32") is None
    with pytest.raises(ValueError, match="cpu"):
        flops.card_peaks("cpu")
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")
    assert flops.mfu(1e15, "cuda", "bfloat16") is None
    with pytest.raises(ValueError, match="NVIDIA A100-SXM4-80GB"):
        flops.card_peaks("cuda")


def test_the_sxm_card_has_the_data_sheet_peaks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: SXM)
    peaks = flops.card_peaks("cuda:0")
    assert (peaks.bf16, peaks.f32, peaks.tf32, peaks.hbm) == (989e12, 67e12, 495e12, 3.35e12)
    assert flops.mfu(989e12, "cuda", "bfloat16") == 1.0
    assert flops.mfu(67e12 / 2, "cuda", "float32") == 0.5
    assert flops.mfu(495e12, "cuda", "tf32") == 1.0
    with pytest.raises(ValueError, match="float16"):
        flops.mfu(1.0, "cuda", "float16")
    # Every part of the table is an H100 and slower than the SXM part in bf16.
    assert all(name.startswith("NVIDIA H100") and p.bf16 <= peaks.bf16
               for name, p in flops.CARD_PEAKS.items())


def test_profiling_modules_never_import_jax():
    code = (
        "import sys\n"
        "import dclip_tpu_torch.core.flops, dclip_tpu_torch.cli.profile\n"
        "import dclip_tpu_torch.cli.profile_ops\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'flax', 'optax', 'dclip_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
