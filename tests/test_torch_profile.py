"""The port's profilers on the CPU at the tiny preset: `cli.profile` beside
the JAX package's on the same arguments (phase names, JSON keys, the phase
bounds of `tests/test_cli_e2e.py`, no MFU without a card, `--trace_dir`'s
trace and range table), and `cli.profile_ops.run_per_op` (the JAX rows in
order, its summary keys, and floors equal to the JAX formulas at the tiny
shapes under the same constants)."""
import contextlib
import glob
import io
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from dclip_tpu.cli import profile as jax_profile
from dclip_tpu.cli.common import synthetic_distill_batch as jax_synthetic_batch
from dclip_tpu.core import config as jax_config
from dclip_tpu.core.flops import text_forward_flops as jax_text_forward_flops
from dclip_tpu.ops.packing import pack_captions as jax_pack_captions
from dclip_tpu_torch.cli import profile, profile_ops
from dclip_tpu_torch.core.config import CLIPConfig
from dclip_tpu_torch.core.flops import CARD_PEAKS

import torch_parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--model_preset", "tiny", "--batch", "4", "--steps", "2"]
PHASES = ("full uncached step", "teacher patch encode", "teacher tail (text+xattn)",
          "student step (cache-warm)", "residual (dispatch/overlap)")
MFU_KEYS = ("mfu_uncached", "mfu_uncached_masked_true", "mfu_cache_warm",
            "mfu_cache_warm_masked_true")
# The summary keys of dclip_tpu/cli/profile_ops.py's JSON line, and its rows'.
PER_OP_KEYS = {"batch", "seq", "hidden", "packed_rows", "rows", "per_layer_composite_ms",
               "per_layer_sum_of_parts_ms", "per_layer_floor_ms", "per_layer_achievable_ms",
               "step_measured_ms", "step_floor_ms", "step_achievable_ms",
               "mfu_true_at_measured", "mfu_true_at_floor", "mfu_true_at_achievable"}
ROW_KEYS = {"op", "measured_ms", "gemm_floor_ms", "hbm_floor_ms", "floor_ms", "x_over_floor",
            "bound"}
# The port kernel's label in place of "(Pallas ...)", and K11 in place of the
# JAX loss row's plain contrastive stand-in.
RENAMED = {"attn fwd kernel (Pallas)": "attn fwd kernel (K4)",
           "attn bwd kernel (Pallas)": "attn bwd kernel (K5)",
           "ln2+mlp fwd (Pallas frozen pair)": "ln2+mlp fwd (K6)",
           "ln2+mlp fwd+dx (Pallas pair)": "ln2+mlp fwd+dx (K6)",
           "loss tail (contrastive, [B,proj])": "loss tail (K11, [B,proj])"}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX profile CLI on ARGS: (table output, JSON record)."""
    table = _run(jax_profile.main, ARGS)
    rec = json.loads(_run(jax_profile.main, ARGS + ["--json"]).strip().splitlines()[-1])
    return table, rec


def _phase_names(table: str):
    return [line[:32].strip() for line in table.splitlines()
            if line[:32].strip() in PHASES]


def test_table_has_the_jax_phases(jax_runs):
    table = _run(profile.main, ARGS + ["--device", "cpu"])
    assert _phase_names(table) == _phase_names(jax_runs[0]) == list(PHASES)
    assert "MFU uncached n/a (true n/a)   cache-warm n/a (true n/a)" in table


def test_json_has_the_jax_keys_and_bounded_phases(jax_runs):
    rec = json.loads(_run(profile.main, ARGS + ["--device", "cpu", "--json"])
                     .strip().splitlines()[-1])
    want = jax_runs[1]
    assert set(rec) == set(want)
    assert list(rec["phases_ms"]) == list(want["phases_ms"]) == list(PHASES)
    assert (rec["preset"], rec["batch"], rec["backend"]) == ("tiny", 4, "cpu")
    assert rec["compute_dtype"] == want["compute_dtype"] == "float32"
    # Off the accelerator both packages resolve the plain paths.
    assert rec["use_pallas"] is want["use_pallas"] is False
    assert rec["packed_text"] is want["packed_text"] is False
    ph = rec["phases_ms"]
    full = ph["full uncached step"]
    assert full > 0
    for phase in PHASES[1:4]:  # tests/test_cli_e2e.py's bound
        assert 0 < ph[phase] < 20 * full, (phase, ph[phase], full)
    for key, phase in (("images_per_sec_uncached", "full uncached step"),
                       ("images_per_sec_cache_warm", "student step (cache-warm)")):
        assert rec[key] == pytest.approx(4 / (ph[phase] / 1e3), rel=2e-2)
    # No card, no peak: no MFU on the CPU (the JAX CLI has none off the TPU).
    assert all(rec[k] is None for k in MFU_KEYS)
    assert all(want[k] is None for k in MFU_KEYS)


def test_trace_dir_writes_a_trace_and_the_range_table(tmp_path):
    out = _run(profile.main, ARGS + ["--device", "cpu", "--json", "--trace_dir",
                                     str(tmp_path)])
    assert glob.glob(str(tmp_path / "*.pt.trace.json"))
    lines = out.strip().splitlines()
    assert json.loads(lines[-1])["trace_dir"] == str(tmp_path)
    assert any(line.startswith("trace: 2 uncached steps; device time not measured")
               for line in lines)
    assert "unranged ms/step: not measured" in lines
    ranges = {line.split()[0]: line.split()[1:] for line in lines if line.startswith("dclip.")}
    names = ("dclip.h2d", "dclip.crop", "dclip.region_encode", "dclip.teacher_text",
             "dclip.cross_attention", "dclip.pack_text", "dclip.student_step", "dclip.backward",
             "dclip.backward.loss", "dclip.backward.text", "dclip.backward.vision",
             "dclip.optimizer")
    for name in names:
        assert ranges[name][:2] == ["not", "measured"], name
        assert float(ranges[name][2]) > 0, name
    # The table runs in the order a step does (`core.metrics.RANGES`); the
    # uncached window looks nothing up in a cache.
    assert [n for n in ranges if n in names] == list(names)
    assert "dclip.cache_lookup" not in ranges


def test_per_op_flag_runs_profile_ops(monkeypatch):
    calls = []
    monkeypatch.setattr(profile_ops, "run_per_op",
                        lambda *a, **kw: calls.append((a, kw)) or 0)
    assert profile.main(["--per_op", "--device", "cpu", "--steps", "3", "--json"]) == 0
    assert calls == [((8, 3, True), {"device": torch.device("cpu")})]


def test_without_a_card_the_cli_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs there")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        profile.main(["--model_preset", "tiny", "--batch", "4", "--steps", "1"])


def _jax_row_names():
    """The row names of dclip_tpu/cli/profile_ops.py, in the order it adds them."""
    src = open(os.path.join(REPO, "dclip_tpu", "cli", "profile_ops.py")).read()
    return re.findall(r'\badd\(\s*f?"([^"]+)"', src)


def _jax_floors(b, r, n_text_params, peak_bf16, hbm_bps):
    """dclip_tpu/cli/profile_ops.py's (GEMM FLOPs, bytes) per row at the tiny
    shapes, converted to ms with the given peaks."""
    cfg = jax_config.CLIPConfig.tiny_test()
    v = cfg.vision
    s = (v.image_size // v.patch_size) ** 2 + 1
    d, h, mlp = v.hidden_size, v.num_heads, v.mlp_dim
    m = b * s
    item = 2
    work = [
        (0.0, 2 * m * d * item),
        (0.0, 5 * m * d * item),
        (6 * 2.0 * m * d * d, 8 * m * d * item + 2 * 3 * d * d * 4),
        (2 * 2.0 * m * d * d, 4 * m * d * item + 2 * d * d * 4),
        (4 * 2.0 * m * d * d, 8 * m * d * item + 4 * d * d * 4),
        (2 * 2.0 * b * s * s * d, 4 * b * s * d * item + 2 * b * s * h * 4),
        (5 * 2.0 * b * s * s * d, 8 * b * s * d * item + 2 * b * s * h * 4),
        (2.0 * m * d * mlp * 2, (2 * m * d + m * mlp) * item + (d * mlp * 2) * 4),
        (2.0 * m * d * mlp * 4, (4 * m * d + 2 * m * mlp) * item + 2 * (d * mlp * 2) * 4),
        (6 * 2.0 * m * d * d + 2 * 2.0 * m * d * d + 4 * 2.0 * m * d * d
         + 7 * 2.0 * b * s * s * d + 2.0 * m * d * mlp * 4,
         (7 + 4 + 2 + 12) * m * d * item + 3 * m * mlp * item),
        (3.0 * jax_text_forward_flops(cfg) * r, 3 * n_text_params * 4),
        (3 * 2.0 * b * b * cfg.projection_dim, 6 * b * cfg.projection_dim * 4),
    ]
    return [(f / peak_bf16 * 1e3, by / hbm_bps * 1e3) for f, by in work]


def test_per_op_rows_keys_and_floors_match_jax(capsys):
    assert profile_ops.run_per_op(4, 2, True, device="cpu", cfg=CLIPConfig.tiny_test()) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # The JAX summary keys, and the device and peaks the floors are taken at.
    assert set(out) == PER_OP_KEYS | {"device", "peaks"}
    ref = CARD_PEAKS[profile_ops.REFERENCE_CARD]
    assert out["peaks"] == {"bf16_flops": ref.bf16, "hbm_bytes_per_s": ref.hbm}
    assert out["device"].startswith("cpu")

    jcfg = jax_config.CLIPConfig.tiny_test()
    tcfg = jax_config.TeacherConfig(embed_dim=jcfg.projection_dim, num_heads=4, max_patches=8,
                                    max_text_tokens=jcfg.text.max_length)
    hb = jax_synthetic_batch(jcfg, tcfg, 4)
    r = jax_pack_captions(hb["input_ids"], hb["attention_mask"],
                          jcfg.text.eos_token_id)["packed_ids"].shape[0]
    assert out["packed_rows"] == r
    assert (out["batch"], out["seq"], out["hidden"]) == (4, 17, 32)
    names = [RENAMED.get(n, n).replace("{R}", str(r)) for n in _jax_row_names()]
    assert len(names) == 12
    assert [row["op"] for row in out["rows"]] == names

    _, params = torch_parity.jax_clip(jcfg, seed=0)
    n_text = sum(x.size for k in ("text_model", "text_projection")
                 for x in jax.tree_util.tree_leaves(params[k]))
    for row, (gf, hf) in zip(out["rows"], _jax_floors(4, r, n_text, ref.bf16, ref.hbm)):
        assert set(row) == ROW_KEYS
        assert row["gemm_floor_ms"] == pytest.approx(gf, rel=1e-12, abs=0), row["op"]
        assert row["hbm_floor_ms"] == pytest.approx(hf, rel=1e-12, abs=0), row["op"]
        assert row["floor_ms"] == max(row["gemm_floor_ms"], row["hbm_floor_ms"])
        assert row["measured_ms"] > 0
        assert row["x_over_floor"] == pytest.approx(row["measured_ms"] / row["floor_ms"])

    rows = out["rows"]
    fl = [max(x["gemm_floor_ms"], x["hbm_floor_ms"]) for x in rows]
    floor_layer = sum(fl[i] for i in (1, 2, 3, 4, 5, 6, 8))
    assert out["per_layer_floor_ms"] == pytest.approx(floor_layer)
    assert out["per_layer_sum_of_parts_ms"] == pytest.approx(
        sum(rows[i]["measured_ms"] for i in (1, 2, 3, 4, 5, 6, 8)))
    assert out["step_floor_ms"] == pytest.approx(2 * floor_layer + fl[10] + fl[11])
    assert out["step_measured_ms"] == pytest.approx(
        2 * rows[9]["measured_ms"] + rows[10]["measured_ms"] + rows[11]["measured_ms"])
    assert all(out[k] is None for k in ("mfu_true_at_measured", "mfu_true_at_floor",
                                         "mfu_true_at_achievable"))
    assert np.isfinite(out["step_achievable_ms"])


def test_per_op_table_names_the_constants(capsys):
    assert profile_ops.run_per_op(4, 1, False, device="cpu", cfg=CLIPConfig.tiny_test()) == 0
    out = capsys.readouterr().out
    assert "cpu (floors at the NVIDIA H100 80GB HBM3's peaks): 989 TFLOP/s bf16, 3.35 TB/s HBM" \
        in out
    assert "host clock, median of 3 windows of 1 calls per row" in out
    assert "attn bwd kernel (K5)" in out and "BELOW" not in out
