"""`correct` comes out false when the timed path is broken underneath, once
for each fault a cell can have, and the control (the reference in float8
in the program's place) fails the cells' limits. Both at the CPU tests'
size; the card-only test runs the control at a cell's own size."""
from __future__ import annotations

import json

import pytest
import torch

from conftest import REPO, run_cell

from benchmark import control, manifest


def _state_unchanged(monkeypatch):
    from dclip_tpu_torch.train import optim

    monkeypatch.setattr(optim.MaskedAdamW, "step", lambda self: False)


def _half_batch(monkeypatch):
    from dclip_tpu_torch.train import distill_trainer

    own = distill_trainer.distillation_loss

    def half(si, st, ti, tt, **kw):
        n = si.shape[0] // 2
        return own(si[:n], st[:n], ti[:n], tt[:n], **kw)

    monkeypatch.setattr(distill_trainer, "distillation_loss", half)


def _swap_rows(t):
    t = t.clone()
    t[[0, 1]] = t[[1, 0]]
    return t


def _altered_teacher(monkeypatch):
    from dclip_tpu_torch.train.distill_trainer import DistillTrainer

    own = DistillTrainer._get_teacher_targets

    def altered(self, *args, **kw):
        img, txt = own(self, *args, **kw)
        return _swap_rows(img), txt

    monkeypatch.setattr(DistillTrainer, "_get_teacher_targets", altered)


def _altered_cache(monkeypatch):
    """The device level alone serves altered rows: every step of a cached
    cell, the compared ones too, is a device-level hit."""
    from dclip_tpu_torch.train.device_cache import DeviceTargetCache

    own = DeviceTargetCache.get

    def dev(self, keys):
        out = own(self, keys)
        return None if out is None else _swap_rows(out)

    monkeypatch.setattr(DeviceTargetCache, "get", dev)


def _accumulator_dropped(monkeypatch):
    """Only the last step of each accumulation cycle reaches the update:
    the accumulator takes each gradient in place of the running mean."""
    from dclip_tpu_torch.train import optim

    own = optim.MaskedAdamW.step

    def step(self):
        if self.acc is not None:
            for a, g in zip(self.acc, self._grads()):
                a.copy_(g)
        return own(self)

    monkeypatch.setattr(optim.MaskedAdamW, "step", step)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "accumulator_dropped": _accumulator_dropped}


@pytest.mark.parametrize("cell", ["tiny.uncached", "tiny.cached"])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "accumulator_dropped",
                                   "altered_answer"])
def test_a_broken_step_is_not_correct(tiny_root, cell, fault, monkeypatch, capsys):
    if fault == "altered_answer":
        (_altered_cache if cell == "tiny.cached" else _altered_teacher)(monkeypatch)
    else:
        FAULTS[fault](monkeypatch)
    res = run_cell(tiny_root, cell, capsys=capsys)
    assert res["correct"] is False
    failed = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert failed, res["checks"]


@pytest.mark.parametrize("cell", ["tiny.uncached", "tiny.cached"])
def test_the_control_fails_the_limits(tiny_root, cell):
    found = manifest.resolve_cell(cell, tiny_root)
    line = control.readings(found, manifest.load_driver(found), 7, torch.device("cpu"))
    limits = found.workload["limits"]
    assert all(v <= limits[k] for k, v in line["program"].items())
    for side in ("float8", "half_batch", "altered"):
        assert any(v > limits[k] for k, v in line[side].items()), (side, line[side])


@pytest.mark.requires_cuda
def test_the_control_fails_on_the_card_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    found = manifest.resolve_cell("vit-l-14.cached", REPO)
    line = control.readings(found, manifest.load_driver(found), 11, torch.device("cuda", 0))
    limits = found.workload["limits"]
    print(json.dumps(line))
    assert all(v <= limits[k] for k, v in line["program"].items())
    for side in ("float8", "half_batch", "altered"):
        assert any(v > limits[k] for k, v in line[side].items()), (side, line[side])

