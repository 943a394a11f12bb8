"""Cooperative preemption in the port (`dclip_tpu_torch.train.preemption`,
`BaseTrainer.fit(preemption=...)`): the cases of the JAX package's
tests/test_preemption.py on the port's `TeacherTrainer` at
`CLIPConfig.tiny_test()` on the CPU, and 2 gloo ranks
(tests/torch_dp_worker.py) where only rank 1 gets SIGTERM and both stop at
the same step."""
import dataclasses
import os
import signal

import pytest
import torch

import torch_dp
import torch_parity

from dclip_tpu_torch.core.config import CLIPConfig, TeacherConfig, TeacherTrainConfig
from dclip_tpu_torch.models.weights import state_dict_from_jax
from dclip_tpu_torch.train import TeacherTrainer
from dclip_tpu_torch.train.checkpoint import CheckpointManager
from dclip_tpu_torch.train.preemption import Preempted, PreemptionGuard

B, P = 4, 2


def test_guard_flag_and_handler_restore():
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    try:
        with PreemptionGuard() as guard:
            assert not guard.requested
            os.kill(os.getpid(), signal.SIGTERM)
            assert guard.requested
            assert guard.should_stop(step=3)  # one process: every step
            assert seen == [signal.SIGTERM]  # the previous handler chained
        os.kill(os.getpid(), signal.SIGTERM)  # restored: only the old handler
        assert seen == [signal.SIGTERM, signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_guard_multiprocess_agreement_is_sticky_and_synced():
    """With several processes the flag is honoured only at sync points,
    through an any() over every process's flag, and stays agreed."""
    calls = []

    def allgather(flag):
        calls.append(flag)
        return [flag, True]  # another process saw the signal

    g = PreemptionGuard(sync_every=4, _allgather=allgather, _process_count=2)
    assert not g.should_stop(step=1)
    assert not g.should_stop(step=3)
    assert calls == []
    assert g.should_stop(step=4)
    assert calls == [False]
    assert g.should_stop(step=5)
    assert calls == [False]


def test_guard_local_flag_ignored_until_sync_point():
    g = PreemptionGuard(sync_every=4, _allgather=lambda f: [f, False], _process_count=2)
    g._flag = True
    assert not g.should_stop(step=2)
    assert g.should_stop(step=4)


def test_guard_without_a_group_is_one_process():
    """No process group: the real process count is 1 and the real gather
    returns this process's flag alone."""
    g = PreemptionGuard()
    assert g._processes() == 1 and list(g._gather(True)) == [True]


@pytest.fixture(scope="module")
def setup():
    cfg = CLIPConfig.tiny_test()
    params = torch_parity.jax_clip_fan_in(cfg)
    tcfg = TeacherConfig(embed_dim=cfg.projection_dim, num_heads=4, max_patches=P,
                         max_text_tokens=cfg.text.max_length)
    train = TeacherTrainConfig(epochs=3, batch_size=B, learning_rate=1e-3, teacher=tcfg,
                               clip_model="tiny", use_pallas=True, compute_dtype="float32")
    return dict(cfg=cfg, sd=state_dict_from_jax(params, cfg), train=train,
                batches=[torch_dp.distill_batch(cfg, B, P, i) for i in range(4)])


def _trainer(s, **changes):
    return TeacherTrainer(dataclasses.replace(s["train"], **changes), s["sd"], s["cfg"],
                          device="cpu")


class _Pipe:
    """Epochs of the batches; at `kill_at` of epoch 0 SIGTERM to this
    process after the batch is yielded (`when="after"`, JAX's
    SignalingPipeline), or the signal and a failed fetch in place of the
    batch (`when="die"`, JAX's DyingWorkersPipeline; `signal=False`: the
    failure alone)."""

    def __init__(self, batches, kill_at=None, when="after", send=True):
        self.batches, self.kill_at, self.when, self.send = batches, kill_at, when, send

    def epoch(self, epoch):
        for i, b in enumerate(self.batches):
            if epoch == 0 and i == self.kill_at and self.when == "die":
                if self.send:
                    os.kill(os.getpid(), signal.SIGTERM)
                raise OSError("worker pool died (simulated group SIGTERM)")
            yield b
            if epoch == 0 and i + 1 == self.kill_at and self.when == "after":
                os.kill(os.getpid(), signal.SIGTERM)


def test_fit_preempted_saves_tagged_checkpoint_and_unwinds(setup, tmp_path):
    """The signal lands after batch 2: batch 3's boundary check stops the
    epoch after 2 steps, the `preempt` checkpoint holds step 2 and the
    parameters of an uninterrupted 2-step run, and resume ignores it."""
    tr = _trainer(setup)
    ckpts = CheckpointManager(str(tmp_path), prefix="teacher")
    with PreemptionGuard() as guard:
        with pytest.raises(Preempted, match="step boundary 2"):
            tr.fit(_Pipe(setup["batches"], kill_at=2), checkpoints=ckpts, preemption=guard)
    assert tr.step == 2
    entries = [e for e in ckpts._index if e.get("tag") == "preempt"]
    assert len(entries) == 1 and entries[0]["step"] == 2 and os.path.exists(entries[0]["path"])
    assert ckpts.latest() is None
    ref = _trainer(setup)
    for b in setup["batches"][:2]:
        ref.train_step_on_batch(b)
    saved = torch.load(entries[0]["path"], weights_only=False)["params"]
    for name, p in ref.teacher.named_parameters():
        assert torch.equal(saved[name], p.detach()), name


def test_group_sigterm_pipeline_death_takes_graceful_path(setup, tmp_path):
    """A pipeline failure after the signal is the preemption (a tagged
    `preempt` checkpoint, `Preempted`); without the signal it stays an
    `error`."""
    tr = _trainer(setup, epochs=2)
    ckpts = CheckpointManager(str(tmp_path), prefix="teacher")
    with PreemptionGuard() as guard:
        with pytest.raises(Preempted, match="pipeline failed"):
            tr.fit(_Pipe(setup["batches"][:3], kill_at=2, when="die"), checkpoints=ckpts,
                   preemption=guard)
    entries = [e for e in ckpts._index if e.get("tag") == "preempt"]
    assert len(entries) == 1 and entries[0]["step"] == 2
    tr2 = _trainer(setup, epochs=2)
    ckpts2 = CheckpointManager(str(tmp_path / "e"), prefix="teacher")
    with PreemptionGuard() as guard2:
        with pytest.raises(OSError):
            tr2.fit(_Pipe(setup["batches"][:3], kill_at=2, when="die", send=False),
                    checkpoints=ckpts2, preemption=guard2)
    assert [e["tag"] for e in ckpts2._index if e.get("tag")] == ["error"]


def test_fit_without_guard_unaffected(setup):
    tr = _trainer(setup, epochs=1)
    history = tr.fit(_Pipe(setup["batches"][:2]), preemption=None)
    assert len(history["train_loss"]) == 1 and tr.step == 2


def test_sigterm_to_one_of_two_ranks_stops_both_at_one_step(setup, tmp_path):
    """Rank 1 alone gets SIGTERM when it draws batch 3 of epoch 0; with
    sync_every=2 the agreement at step boundary 4 stops both ranks there
    (a lone stop would hang rank 0 in the next collective and time out
    here), rank 0 writes the one `preempt` checkpoint, both ranks hold the
    same parameters."""
    batches = [torch_dp.distill_batch(setup["cfg"], 2 * B, P, 10 + i) for i in range(6)]
    torch.save(setup["sd"], tmp_path / "clip.pt")
    ckpt_dir = tmp_path / "ckpts"
    spec = {"scenario": "preempt", "clip": str(tmp_path / "clip.pt"),
            "teacher_cfg": dataclasses.asdict(setup["train"].teacher),
            "train_cfg": {"epochs": 2, "batch_size": 2 * B, "learning_rate": 1e-3,
                          "clip_model": "tiny", "use_pallas": True, "compute_dtype": "float32"},
            "batches": torch_dp.save_batches(tmp_path / "batches.npz", batches),
            "kill_rank": 1, "kill_at": 3, "sync_every": 2, "ckpt_dir": str(ckpt_dir)}
    outs = torch_dp.run_ranks(tmp_path, "preempt", spec, 2)
    assert [o["preempted"] for o in outs] == [True, True]
    assert [o["step"] for o in outs] == [4, 4]
    assert [o["saw_signal"] for o in outs] == [False, True]
    assert outs[0]["digest"] == outs[1]["digest"]
    files = os.listdir(ckpt_dir)
    assert len([f for f in files if ".preempt." in f]) == 1, files
    assert not [f for f in files if f.endswith(".pt") and ".preempt." not in f], files
