"""The SigLIP cell and the data-parallel cell on the CPU: a tiny SigLIP
cell's run against its reference, four gloo ranks of the data-parallel
driver against the reference at the global batch, the six new readers,
SigLIP's weights and counts against the port's module and FLOP counts."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

from conftest import REPO, _dump, make_checkout, run_cell

from benchmark import counts_siglip, manifest
from benchmark.frozen import flops
from benchmark.reference import siglip as ref

TINY_SIGLIP = dict(hidden_size=32, intermediate_size=40, num_hidden_layers=2,
                   num_attention_heads=4)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The tiny checkout plus `tiny-siglip.cached` and `tiny.uncached-dp4`."""
    root = make_checkout(str(tmp_path_factory.mktemp("checkout")))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(REPO, "benchmark", "configs", "siglip-so400m-14-384.json")) as f:
        config = json.load(f)
    config["text_config"].update(TINY_SIGLIP, vocab_size=1000, max_position_embeddings=16)
    config["vision_config"].update(TINY_SIGLIP, image_size=30, patch_size=7)
    config["projection_dim"] = 32
    config["teacher"].update(embed_dim=32, num_heads=4, max_text_tokens=16)
    _dump(config, os.path.join(bench, "configs", "tiny-siglip.json"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest_json = json.load(f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        tiny = json.load(f)
    with open(os.path.join(REPO, "benchmark", "traffic", "uncached-dp4.json")) as f:
        mix = json.load(f)
    _dump(dict(mix, batch=8), os.path.join(bench, "traffic", "tiny-uncached-dp4.json"))
    for name, cfg, traffic, template in (
            ("tiny-siglip.cached", "tiny-siglip", "tiny-cached", "siglip-so400m-14-384.cached"),
            ("tiny.uncached-dp4", "tiny", "tiny-uncached-dp4", "vit-b-16.uncached-dp4")):
        with open(os.path.join(REPO, "benchmark", "workloads", template + ".json")) as f:
            cell = json.load(f)
        cell.update(config=cfg, traffic=traffic, trace_steps=4)
        _dump(cell, os.path.join(bench, "workloads", name + ".json"))
        tiny["workloads"].append({"name": name, "config": cfg, "traffic": traffic,
                                  "chips": cell["chips"], "why": "the CPU tests' size"})
        for metric in tiny["per_layer"]:
            if template in metric.get("workloads", ()):
                metric["workloads"].append(name)
    assert len(tiny["per_layer"]) == len(manifest_json["per_layer"])
    _dump(tiny, os.path.join(root, "BENCHMARK.json"))
    return root


def _pairs(path):
    with open(os.path.join(path, "BENCHMARK.json")) as f:
        return [(w["config"], w["traffic"]) for w in json.load(f)["workloads"]]


def test_each_pair_of_config_and_traffic_is_one_cell(root):
    """A pair of configuration and traffic names one cell: the four-card
    cell runs `vit-b-16` under a traffic of its own, whose parameters are
    the one-card `uncached` mix's, 256 rows a rank."""
    for path in (REPO, root):
        pairs = _pairs(path)
        assert len(pairs) == len(set(pairs)), pairs
    mixes = {}
    for name in ("uncached", "uncached-dp4"):
        with open(os.path.join(REPO, "benchmark", "traffic", name + ".json")) as f:
            mixes[name] = json.load(f)
        mixes[name].pop("what")
    assert mixes["uncached-dp4"] == mixes["uncached"]
    cell = manifest.resolve_cell("vit-b-16.uncached-dp4", REPO)
    assert cell.chips == 4 and cell.traffic["batch"] == 256


def test_siglip_cell_agrees_with_its_reference_on_the_cpu(root, capsys):
    res = run_cell(root, "tiny-siglip.cached", seed=2**33 + 7, capsys=capsys)
    assert res["correct"] is True
    assert set(res["checks"]) == {"loss", "grad", "change", "target"}
    for name, check in res["checks"].items():
        assert check["value"] <= 1e-5, (name, check)
    assert set(res["metrics"]) == {"train_images_per_s", "peak_mem_gib", "setup_s"}


def test_siglip_limit_readings_tell_the_faults(root):
    """The readings the limits come from, on the CPU: the program sits at
    the reference, a half batch far from it."""
    from benchmark.drivers import siglip_distill_step as driver

    cell = manifest.resolve_cell("tiny-siglip.cached", root)
    out = driver.limit_readings(cell, 11, "cpu")
    assert max(out["program"].values()) <= 1e-5
    assert out["half_batch"]["loss"] > 1e-3 and out["half_batch"]["change"] > 1e-3
    assert set(out["float8"]) == set(out["program"])


def test_data_parallel_driver_at_four_gloo_ranks_matches_the_global_reference(root, capsys):
    """Four ranks in a gloo group on the CPU, each with its own 8 rows:
    rank 0's loss parts, gradient, change and targets against the
    reference that follows the first cycle at the global batch of 32."""
    res = run_cell(root, "tiny.uncached-dp4", seed=2**31 + 3, capsys=capsys)
    assert res["correct"] is True and res["device"]["count"] == 4
    for name, check in res["checks"].items():
        assert check["value"] <= 1e-4, (name, check)
    assert res["attempted"] % 4 == 0 and res["attempted"] >= 4


def test_a_failed_worker_fails_the_run(root):
    """A worker rank that dies (here: its cell's file is broken after rank
    0 read it) ends rank 0 with an error instead of a wait."""
    path = os.path.join(root, "benchmark", "workloads", "tiny.uncached-dp4.json")
    code = ("import json, sys; sys.path.insert(0, %r)\n"
            "from benchmark import manifest\n"
            "from benchmark.drivers import distill_step_dp as dp\n"
            "cell = manifest.resolve_cell('tiny.uncached-dp4', %r)\n"
            "json.dump(dict(cell.workload, config='missing'), open(%r, 'w'))\n"
            "dp.run_ranks(cell, 1, 0.1, False, 'cpu', 'gloo', 0.0)\n" % (root, root, path))
    with open(path) as f:
        saved = f.read()
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=root, timeout=240,
                              capture_output=True, text=True)
    finally:
        with open(path, "w") as f:
            f.write(saved)
    assert proc.returncode != 0
    assert "worker rank exited" in proc.stderr


def _summary(**over):
    sh = ref.shapes(json.load(open(os.path.join(REPO, "benchmark", "configs",
                                                "siglip-so400m-14-384.json"))))
    base = dict(steps=4, window_s=6.0, busy_s=5.5, ranges_s={"dclip.map_head": 0.004},
                device_name="NVIDIA H100 80GB HBM3", shapes=sh, batch=256, images=1024,
                remat=True, kernels_s={"attention_fwd": 1.0, "attention_dq": 0.6,
                                       "attention_dkdv": 0.9, "gemm": 1.5, "layernorm": 0.1,
                                       "layernorm_bwd": 0.1})
    base.update(over)
    return base


def _reader(name):
    return manifest.load_module(os.path.join(REPO, "benchmark", "metrics", name + ".py"), name)


def test_siglip_readers():
    s = _summary()
    peaks = flops.card_peaks("NVIDIA H100 80GB HBM3")
    assert _reader("map_head_ms").read(s) == pytest.approx(1.0)
    att = counts_siglip.attention_least_s(s["shapes"], 256, peaks, 2)
    assert _reader("siglip_attention_roofline_pct").read(s) == pytest.approx(
        100 * att * 4 / 2.5)
    mlp = counts_siglip.frozen_mlp_least_s(s["shapes"], 256, peaks, 2)
    assert _reader("siglip_frozen_mlp_roofline_pct").read(s) == pytest.approx(
        100 * mlp * 4 / 1.7)
    mfu = _reader("siglip_train_mfu").read(s)
    assert mfu == pytest.approx(100 * 1024 / 6.0 * counts_siglip.step_flops_per_image(
        s["shapes"]) / 989e12)
    assert 0 < mfu < 100
    # Nothing to read: no range, no kernel families (a program without
    # them), another card.
    assert _reader("map_head_ms").read(_summary(ranges_s={})) is None
    for name in ("siglip_attention_roofline_pct", "siglip_frozen_mlp_roofline_pct"):
        assert _reader(name).read(_summary(kernels_s=None)) is None
        assert _reader(name).read(_summary(device_name="cpu")) is None
    assert _reader("siglip_train_mfu").read(_summary(device_name="cpu")) is None


def test_data_parallel_readers():
    sh = manifest.shapes(json.load(open(os.path.join(REPO, "benchmark", "configs",
                                                     "vit-b-16.json"))))
    s = dict(steps=8, window_s=4.0, ranges_s={"dclip.grad_all_reduce": 0.08},
             device_name="NVIDIA H100 80GB HBM3", shapes=sh, batch=256, images=2048,
             cached=False, caption_tokens=[16] * 1024)
    assert _reader("grad_all_reduce_ms").read(s) == pytest.approx(10.0)
    assert _reader("dp_train_mfu").read(s) == pytest.approx(_reader("train_mfu").read(s))
    assert _reader("grad_all_reduce_ms").read({**s, "ranges_s": {}}) is None
    assert _reader("dp_train_mfu").read({**s, "device_name": "cpu"}) is None


def test_siglip_weights_and_counts_follow_the_port():
    from dclip_tpu_torch.core import flops as port_flops
    from dclip_tpu_torch.core.config import CLIPConfig
    from dclip_tpu_torch.models.siglip import SiglipModule

    cfg = CLIPConfig.from_name("siglip-so400m-14-384")
    sh = ref.shapes(json.load(open(os.path.join(REPO, "benchmark", "configs",
                                                "siglip-so400m-14-384.json"))))
    port = {k: tuple(v.shape) for k, v in SiglipModule(cfg, device="meta").state_dict().items()}
    assert {n: s for n, s, _ in ref.siglip_specs(sh)} == port
    assert counts_siglip.step_flops_per_image(sh) == pytest.approx(
        port_flops.student_step_flops_masked(cfg), rel=1e-12)
    assert counts_siglip.vision_forward_flops(sh) == pytest.approx(
        port_flops.vision_forward_flops(cfg), rel=1e-12)


def test_the_siglip_yardstick_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.counts_siglip, benchmark.reference.siglip\n"
            "from benchmark import manifest\n"
            "for m in ('map_head_ms', 'siglip_attention_roofline_pct', "
            "'siglip_frozen_mlp_roofline_pct', 'siglip_train_mfu', 'grad_all_reduce_ms', "
            "'dp_train_mfu'):\n"
            "    manifest.load_module('%s/benchmark/metrics/' + m + '.py', m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('dclip_tpu_torch', 'dclip_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n" % (REPO, REPO))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_the_reference_departs_only_where_written():
    """SigLIP's reference at a tiny size against transformers' SiglipModel
    on the same weights (the towers' features)."""
    transformers = pytest.importorskip("transformers")
    import torch

    hf_cfg = transformers.SiglipConfig(
        text_config=dict(vocab_size=1000, hidden_size=32, intermediate_size=40,
                         num_hidden_layers=2, num_attention_heads=4, max_position_embeddings=16),
        vision_config=dict(hidden_size=32, intermediate_size=40, num_hidden_layers=2,
                           num_attention_heads=4, image_size=30, patch_size=7))
    torch.manual_seed(1)
    hf = transformers.SiglipModel(hf_cfg).eval()
    sh = SimpleNamespace(
        text=SimpleNamespace(num_layers=2, num_heads=4, layer_norm_eps=1e-6),
        vision=SimpleNamespace(image_size=30, patch_size=7, hidden_size=32, num_layers=2,
                               num_heads=4, layer_norm_eps=1e-6))
    from benchmark.reference.clip import Precision

    p = hf.state_dict()
    pixels = torch.randn(3, 30, 30, 3)
    ids = torch.randint(2, 1000, (3, 16))
    with torch.no_grad():
        torch.testing.assert_close(
            ref.image_features(p, sh, pixels, Precision()),
            hf.get_image_features(pixel_values=pixels.permute(0, 3, 1, 2)), rtol=1e-4,
            atol=1e-5)
        torch.testing.assert_close(ref.text_features(p, sh, ids, Precision()),
                                   hf.get_text_features(input_ids=ids), rtol=1e-4, atol=1e-5)
