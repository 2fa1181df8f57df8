"""Resumable, preemption-safe training in the port: rolling ``_last.pth``
checkpoints, mid-stage resume, the ``_best`` gate, a stage gap, and
``PreemptionGuard`` -- the cases of ``tests/test_resume.py`` and the
segmentation cases of ``tests/test_preemption.py``, on the CPU at width
0.25.  Added: the JAX trainer runs the mid-stage resume once on the same
data and stage configs, and the port's ``_last`` container holds exactly
its fields and its resumed history the same lengths and transitions; a
step from the restored ``_last`` equals the uninterrupted run's next step
bit for bit, and an epoch that stops early closes its prefetch thread.
"""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from ugpg_tpu.data.synthetic import ArrayLoader as JaxArrayLoader
from ugpg_tpu.data.synthetic import disk_dataset as jax_disk_dataset
from ugpg_tpu.train.seg_trainer import UncertaintyGuidedProgressiveTrainer as JaxTrainer
from ugpg_tpu_torch.data.loader import prefetch_to_device
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.io.checkpoint import load_checkpoint, read_checkpoint
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.utils.preemption import PreemptionGuard

W = 0.25
CFGS = {
    1: {"resolution": 16, "epochs_per_stage": 3, "lr": 3e-4},
    2: {"resolution": 32, "epochs_per_stage": 3, "lr": 1e-4},
}
# stage 1 whole, stage 2 stopped after its first epoch
PART = {1: dict(CFGS[1]), 2: {**CFGS[2], "epochs_per_stage": 1}}
# the files of a JAX checkpoint directory -> the keys of the port's container
JAX_FILES = {"variables.msgpack": "model_state_dict", "opt_state.msgpack": "optimizer_state_dict"}


def _history_shape(history):
    return {k: (v if k == "stage_transitions" else len(v)) for k, v in history.items()}


@pytest.fixture(scope="module")
def jax_resume(tmp_path_factory):
    """The JAX trainer's mid-stage resume at width 0.25 on the same data:
    its stage-2 ``_last`` fields (metadata keys and the files beside them,
    under the port's names), the history there, and the resumed history."""
    d = tmp_path_factory.mktemp("jax_resume")
    images, masks = jax_disk_dataset(num_samples=12, image_size=32, seed=3)
    train = JaxArrayLoader(images[:8], masks[:8], batch_size=4)
    val = JaxArrayLoader(images[8:], masks[8:], batch_size=4)
    JaxTrainer(stage_configs=PART, width=W, verbose=False).train_progressive(
        train, val, max_stages=2, save_dir=d, checkpoint_every=1)
    last = d / "ug_pgunet_stage2_last"
    meta = json.loads((last / "metadata.json").read_text())
    files = {p.name for p in last.iterdir()} - {"metadata.json"}
    assert files == set(JAX_FILES)
    resumed = JaxTrainer(stage_configs=CFGS, width=W, verbose=False).train_progressive(
        train, val, max_stages=2, save_dir=d, checkpoint_every=1, resume=True)
    final = json.loads((last / "metadata.json").read_text())
    return {"last_keys": set(meta) | {JAX_FILES[f] for f in files},
            "last_epoch": meta["epoch"], "last_history": _history_shape(meta["history"]),
            "resumed_history": _history_shape(resumed), "final_epoch": final["epoch"]}


@pytest.fixture
def loaders():
    images, masks = disk_dataset(num_samples=12, image_size=32, seed=3)
    return (ArrayLoader(images[:8], masks[:8], batch_size=4),
            ArrayLoader(images[8:], masks[8:], batch_size=4))


def _trainer(cfgs=CFGS):
    return UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, width=W, verbose=False,
                                               device="cpu")


class _KillDuringEpoch:
    """A loader that runs ``action`` when its ``on_epoch``-th epoch starts:
    eviction arriving mid-epoch."""

    def __init__(self, inner, on_epoch: int, action):
        self.inner, self.on_epoch, self.action = inner, on_epoch, action
        self.epochs = 0

    def __iter__(self):
        self.epochs += 1
        if self.epochs == self.on_epoch:
            self.action()
        return iter(self.inner)

    def __len__(self):
        return len(self.inner)


def test_checkpoint_every_writes_last_with_the_jax_schema(tmp_path, loaders, jax_resume):
    train, val = loaders
    tr = _trainer()
    tr.train_progressive(train, val, max_stages=1, save_dir=tmp_path, checkpoint_every=1)
    raw = read_checkpoint(tmp_path / "ug_pgunet_stage1_last.pth")
    assert set(raw) == jax_resume["last_keys"]
    assert raw["epoch"] == 2 and raw["stage"] == 1  # the final epoch's index
    assert set(raw["history"]) == set(jax_resume["last_history"])
    assert len(raw["history"]["train_loss"]) == 3
    assert raw["optimizer_state_dict"]["state"]  # RMSprop's square averages
    stage, sd = load_checkpoint(tmp_path / "ug_pgunet_stage1_last.pth")
    tr.models[1].load_state_dict(sd, strict=True)


def test_mid_stage_resume_continues(tmp_path, loaders, jax_resume):
    train, val = loaders
    _trainer(PART).train_progressive(train, val, max_stages=2, save_dir=tmp_path,
                                     checkpoint_every=1)
    last = read_checkpoint(tmp_path / "ug_pgunet_stage2_last.pth")
    assert set(last) == jax_resume["last_keys"]
    assert last["epoch"] == jax_resume["last_epoch"] == 0
    assert _history_shape(last["history"]) == jax_resume["last_history"]
    t2 = _trainer()
    hist = t2.train_progressive(train, val, max_stages=2, save_dir=tmp_path, checkpoint_every=1,
                                resume=True)
    assert read_checkpoint(tmp_path / "ug_pgunet_stage2_last.pth")["epoch"] == \
        jax_resume["final_epoch"] == 2
    # history restored and extended as the JAX trainer's: 3 (stage 1) + 1
    # (stage 2 before) + 2 more, transitions [0, 3]
    assert _history_shape(hist) == jax_resume["resumed_history"]
    assert len(hist["train_loss"]) == 6 and hist["stage_transitions"] == [0, 3]
    assert 1 in t2.models  # stage 1 restored as the uncertainty source
    best1 = load_checkpoint(tmp_path / "ug_pgunet_stage1_best.pth")[1]
    for key, value in t2.models[1].state_dict().items():
        assert torch.equal(value, best1[key]), key
    rows = (tmp_path / "training_log.csv").read_text().splitlines()[1:]
    assert [tuple(r.split(",")[:2]) for r in rows] == [
        ("1", "1"), ("1", "2"), ("1", "3"), ("2", "1"), ("2", "2"), ("2", "3")]


def test_resume_does_not_overwrite_better_best(tmp_path, loaders):
    train, val = loaders
    _trainer({1: {**CFGS[1], "epochs_per_stage": 2}}).train_progressive(
        train, val, max_stages=1, save_dir=tmp_path, checkpoint_every=1)
    best, last = tmp_path / "ug_pgunet_stage1_best.pth", tmp_path / "ug_pgunet_stage1_last.pth"
    # make the saved best unbeatable, and rewind _last to epoch 0
    for path, key, value in ((best, "val_dice", 0.99), (last, "epoch", 0)):
        raw = read_checkpoint(path)
        raw[key] = value
        torch.save(raw, path)
    fingerprint = best.read_bytes()
    _trainer({1: {**CFGS[1], "epochs_per_stage": 3}}).train_progressive(
        train, val, max_stages=1, save_dir=tmp_path, checkpoint_every=1, resume=True)
    assert best.read_bytes() == fingerprint
    assert read_checkpoint(best)["val_dice"] == 0.99


def test_resume_with_stage_gap_loads_resume_stage_weights(tmp_path, loaders):
    train, val = loaders
    part = {1: {**CFGS[1], "epochs_per_stage": 1}, 2: {**CFGS[2], "epochs_per_stage": 1}}
    _trainer(part).train_progressive(train, val, max_stages=2, save_dir=tmp_path,
                                     checkpoint_every=1)
    cfgs = {**part, 3: {"resolution": 64, "epochs_per_stage": 1, "lr": 1e-4}}
    t2 = _trainer(cfgs)
    t2.train_progressive(train, val, stages=[3], save_dir=tmp_path, checkpoint_every=1,
                         resume=True)
    saved = load_checkpoint(tmp_path / "ug_pgunet_stage2_last.pth")[1]
    key = "inc.conv.conv_op.0.weight"
    assert torch.equal(t2.models[2].state_dict()[key], saved[key])
    assert (tmp_path / "ug_pgunet_stage3_last.pth").exists()


def test_resume_with_nothing_to_resume(tmp_path, loaders):
    train, val = loaders
    hist = _trainer({1: {**CFGS[1], "epochs_per_stage": 1}}).train_progressive(
        train, val, max_stages=1, save_dir=tmp_path, resume=True)
    assert len(hist["train_loss"]) == 1


def test_step_from_restored_last_equals_the_uninterrupted_step(tmp_path, loaders):
    """Weights, BN stats and RMSprop state come back exactly: one more step
    on the same batch gives the same bits as the run that never stopped."""
    train, val = loaders
    cfgs = {1: {**CFGS[1], "epochs_per_stage": 2}}
    t1 = _trainer(cfgs)
    t1.train_progressive(train, val, max_stages=1, save_dir=tmp_path, checkpoint_every=2)
    t2 = _trainer(cfgs)
    assert t2._find_resume_point(tmp_path) == (1, 1)
    t2.setup_optimizer(1)
    t2._restore_last(tmp_path, 1)
    assert t2.history == t1.history
    batch = next(iter(train))
    m1 = t1._get_train_step(1)(batch, t1.pos_weight)
    m2 = t2._get_train_step(1)(batch, t2.pos_weight)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    s1, s2 = t1.models[1].state_dict(), t2.models[1].state_dict()
    for key in s1:
        assert torch.equal(s1[key], s2[key]), key
    o1, o2 = t1.optimizer.state_dict()["state"], t2.optimizer.state_dict()["state"]
    for i in o1:
        for k in o1[i]:
            assert torch.equal(torch.as_tensor(o1[i][k]), torch.as_tensor(o2[i][k])), (i, k)


# ---------------------------------------------------------------- preemption
def test_guard_signal_sets_flag_and_restores_handler():
    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as g:
        assert not g.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        assert g.should_stop() and g.signum == signal.SIGTERM and g.at is not None
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_second_signal_falls_through_to_previous_handler():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        with PreemptionGuard() as g:
            os.kill(os.getpid(), signal.SIGTERM)
            assert g.should_stop() and not hits
            os.kill(os.getpid(), signal.SIGTERM)
            assert hits == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_seg_preempt_saves_last_and_resume_completes(tmp_path, loaders, jax_resume):
    train, val = loaders
    guard = PreemptionGuard().install()
    try:
        killer = _KillDuringEpoch(train, on_epoch=2,
                                  action=lambda: os.kill(os.getpid(), signal.SIGTERM))
        t1 = _trainer()
        hist = t1.train_progressive(killer, val, max_stages=2, save_dir=tmp_path,
                                    preemption=guard)
    finally:
        guard.uninstall()
    # stopped at the end of stage-1 epoch 2 (of 3); stage 2 never entered
    assert t1.preempted and len(hist["train_loss"]) == 2
    raw = read_checkpoint(tmp_path / "ug_pgunet_stage1_last.pth")
    assert set(raw) == jax_resume["last_keys"] and raw["stage"] == 1 and raw["epoch"] == 1
    assert not (tmp_path / "ug_pgunet_stage2_last.pth").exists()
    assert not (tmp_path / "ug_pgunet_stage2_best.pth").exists()

    t2 = _trainer()
    hist2 = t2.train_progressive(train, val, max_stages=2, save_dir=tmp_path,
                                 checkpoint_every=1, resume=True)
    assert not t2.preempted
    assert len(hist2["train_loss"]) == 6  # 2 restored + 1 + 3
    assert hist2["stage_transitions"] == [0, 3]
    assert read_checkpoint(tmp_path / "ug_pgunet_stage2_last.pth")["epoch"] == 2


def test_seg_without_guard_runs_to_completion(tmp_path, loaders):
    train, val = loaders
    tr = _trainer({1: dict(CFGS[1])})
    assert len(tr.train_progressive(train, val, max_stages=1, save_dir=tmp_path)["train_loss"]) == 3
    assert not tr.preempted


def test_an_armed_guard_stops_after_the_first_epoch(tmp_path, loaders):
    train, val = loaders
    guard = PreemptionGuard()
    guard.trigger()
    tr = _trainer()
    tr.train_progressive(train, val, max_stages=2, save_dir=tmp_path, preemption=guard)
    assert tr.preempted and len(tr.history["train_loss"]) == 1
    assert read_checkpoint(tmp_path / "ug_pgunet_stage1_last.pth")["epoch"] == 0


# ---------------------------------------------------------------- early exit closes prefetch
def test_prefetch_closed_early_stops_and_joins_its_producer():
    closed = threading.Event()

    def source():
        try:
            for i in range(100):
                yield (np.full((2,), i, np.float32),)
        finally:
            closed.set()

    before = threading.active_count()
    it = prefetch_to_device(source(), size=2, device="cpu")
    assert int(next(it)[0][0]) == 0
    it.close()
    assert closed.is_set()  # the source was closed in the producer's thread
    assert threading.active_count() == before


def test_train_epoch_that_raises_closes_its_prefetch_thread(loaders):
    train, _ = loaders
    tr = _trainer()
    before = threading.active_count()
    step = tr._get_train_step(1)
    calls = []

    def failing(batch, pos_weight, aug):
        calls.append(1)
        raise KeyboardInterrupt

    tr._train_steps[1] = failing
    with pytest.raises(KeyboardInterrupt):
        tr.train_epoch(train, 1)
    assert calls == [1] and threading.active_count() == before
    tr._train_steps[1] = step
    assert np.isfinite(tr.train_epoch(train, 1)[0])  # the next epoch runs as usual
