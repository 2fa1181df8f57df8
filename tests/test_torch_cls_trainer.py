"""The port's HerlevTrainer and its training command line on the CPU, at
the reference widths with stages 1-2 and a few images: the checkpoints and
log a run writes (read back by the JAX package's importer), the head-only
transfer, a pretrained frozen encoder, a run preempted at stage 2 and
resumed that ends on the same bits as an uninterrupted one, and the
options and flags that are not ported (or are since)."""

import csv
import json
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_herlev_data import write_herlev_tree
from ugpg_tpu.io.torch_import import import_torch_checkpoint
from ugpg_tpu_torch.cli import train_herlev
from ugpg_tpu_torch.data.synthetic import ArrayLoader
from ugpg_tpu_torch.io.checkpoint import (
    full_classifier_state_dict,
    read_checkpoint,
    save_checkpoint,
)
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS
from ugpg_tpu_torch.models.pgunet import PGUNet1
from ugpg_tpu_torch.parallel.mesh import make_mesh
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
from ugpg_tpu_torch.utils.preemption import PreemptionGuard

K = 3


def _config(**kw):
    cfg = create_config()
    cfg.update(num_classes=K, stages=[1, 2], epochs_per_stage=1, verbose=False,
               class_weights=[1.0, 2.0, 0.5])
    cfg.update(kw)
    return cfg


def _loaders(n_train=4, n_val=2, seed=0):
    """Per-stage loaders of a learnable colour task (class = the dominant
    channel) at 32 and 64 px."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, K, n_train + n_val)
    train, val = {}, {}
    for stage, px in ((1, 32), (2, 64)):
        imgs = rng.random((len(labels), px, px, 3)).astype(np.float32) * 0.3
        for i, lab in enumerate(labels):
            imgs[i, :, :, lab] += 0.6
        train[stage] = ArrayLoader(imgs[:n_train], labels[:n_train], batch_size=2)
        val[stage] = ArrayLoader(imgs[n_train:], labels[n_train:], batch_size=2)
    return train, val


def test_train_progressive_writes_checkpoints_and_log(tmp_path):
    train, val = _loaders()
    tr = HerlevTrainer(_config(), device="cpu")
    hist = tr.train_progressive(train, val, str(tmp_path))
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert hist["uncertainty_weights_mean"][0] == 0.0  # stage 1 has no previous stage
    assert 1.0 < hist["uncertainty_weights_mean"][1] <= 2.0
    assert [t["stage"] for t in hist["stage_transitions"]] == [1, 2]
    with open(tmp_path / "training_log.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["stage"], r["epoch"]) for r in rows] == [("1", "1"), ("2", "1")]
    assert list(rows[0]) == ["stage", "epoch", "train_loss", "val_loss", "train_acc", "val_acc",
                             "base_loss", "uncertainty_mean", "lr"]
    assert float(rows[0]["lr"]) == 3e-4 and float(rows[1]["lr"]) == 1e-4
    assert json.loads((tmp_path / "training_history.json").read_text()) == hist
    for stage in (1, 2):
        obj = read_checkpoint(tmp_path / f"herlev_stage{stage}_best.pth")
        assert obj["stage"] == stage and obj["epoch"] == 1 and obj["config"]["num_classes"] == K
        assert {"train_loss", "val_loss", "train_acc", "val_acc",
                "optimizer_state_dict"} <= set(obj)
        assert any(k.startswith("unet.up1.") for k in obj["model_state_dict"])  # full key set
        variables, got = import_torch_checkpoint(str(tmp_path / f"herlev_stage{stage}_best.pth"),
                                                 num_classes=K, task_type="classification")
        assert got == stage
        np.testing.assert_array_equal(
            np.asarray(variables["params"]["fc3"]["kernel"]),
            tr.models[stage].classifier[9].weight.detach().numpy().T)
    tr2 = HerlevTrainer(_config(), device="cpu")
    tr2.load_stage_weights(2, tmp_path / "herlev_stage2_best.pth")
    for key, value in tr.models[2].state_dict().items():
        assert torch.equal(tr2.models[2].state_dict()[key], value), key


def test_head_transfer_copies_exactly_the_fc_tensors():
    tr = HerlevTrainer(_config(), device="cpu")
    with torch.no_grad():
        for p in tr._model(1).parameters():
            p.add_(1.0)
    before = {k: v.clone() for k, v in tr._model(2).state_dict().items()}
    assert tr.transfer_weights(1, 2) == 6
    after, prev = tr.models[2].state_dict(), tr.models[1].state_dict()
    for key, value in after.items():
        if key.startswith("classifier."):
            assert torch.equal(value, prev[key]), key
        else:
            assert torch.equal(value, before[key]), key


def test_pretrained_unet_stays_frozen(tmp_path):
    seg = PGUNet1()
    torch.manual_seed(3)
    for p in seg.parameters():
        torch.nn.init.normal_(p, std=0.05)
    save_checkpoint(tmp_path / "seg.pth", seg.state_dict(), stage=1, epoch=0)
    train, val = _loaders()
    tr = HerlevTrainer(_config(stages=[1], pretrained_unet_paths={1: str(tmp_path / "seg.pth")}),
                       device="cpu")
    head_before = tr.models[1].classifier[3].weight.detach().clone()
    tr.train_progressive(train, val, str(tmp_path / "out"))
    model = tr.models[1]
    for name, p in model.named_parameters():
        if name.startswith("unet."):
            assert not p.requires_grad and p not in tr.optimizer.state
            np.testing.assert_array_equal(p.detach().numpy(),
                                          seg.state_dict()[name[len("unet."):]].numpy(), name)
    assert not torch.equal(model.classifier[3].weight, head_before)


class _StopAtPoll(PreemptionGuard):
    """A guard armed at its ``at``-th poll (one poll per epoch)."""

    def __init__(self, at: int):
        super().__init__()
        self.at, self.polls = at, 0

    def should_stop(self) -> bool:
        self.polls += 1
        if self.polls == self.at:
            self.trigger()
        return super().should_stop()


def test_preempted_and_resumed_run_ends_on_the_same_bits(tmp_path):
    cfg = _config(epochs_per_stage=2, augment=True)  # the generator drives aug + dropout

    def fresh():
        tr = HerlevTrainer(cfg, device="cpu")
        # one stage-1 epoch: its _best is its last state, the uncertainty
        # source the uninterrupted run goes on with
        tr.stage_configs[1]["epochs"] = 1
        return tr

    train, val = _loaders(seed=1)
    whole = fresh()
    ref_hist = whole.train_progressive(train, val, str(tmp_path / "whole"))
    stopped = fresh()
    stopped.train_progressive(train, val, str(tmp_path / "cut"), preemption=_StopAtPoll(2))
    assert stopped.preempted
    last = read_checkpoint(tmp_path / "cut" / "herlev_stage2_last.pth")
    assert last["stage"] == 2 and last["epoch"] == 1 and last["optimizer_state_dict"]["state"]
    assert not (tmp_path / "cut" / "herlev_stage3_best.pth").exists()
    resumed = fresh()
    hist = resumed.train_progressive(train, val, str(tmp_path / "cut"), resume=True)
    assert not resumed.preempted
    for key, value in whole.models[2].state_dict().items():
        assert torch.equal(resumed.models[2].state_dict()[key], value), key
    assert hist["train_loss"] == ref_hist["train_loss"] and len(hist["val_acc"]) == 3
    with open(tmp_path / "cut" / "training_log.csv") as f:
        rows = [(int(r["stage"]), int(r["epoch"])) for r in csv.DictReader(f)]
    assert rows == [(1, 1), (2, 1), (2, 2)]


@pytest.fixture
def one_torch_thread():
    """One torch thread for a test that trains: the suite runs six test
    processes at once, where torch's default of a thread per core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("kwargs", [
    dict(mesh=2), dict(axis_name="data"), dict(checkpoint_backend="msgpack"),
    dict(config=dict(scan_epochs=True)), dict(config=dict(scan_chunk_bytes=1 << 30)),
    dict(config=dict(tb_logdir="tb")), dict(config=dict(remat=True)),
    dict(config=dict(pipeline_unc=1)),
])
def test_trainer_options_outside_the_slice_raise(kwargs, tmp_path, monkeypatch,
                                               one_torch_thread):
    """The config's tb_logdir, remat and pipeline_unc, and the mesh (the CPU
    named twice), ported since, train stages 1-2 (at 8/16 px); beside a mesh
    pipeline_unc raises the JAX package's ValueError and the others build.
    axis_name, ported since, raises JAX's unbound-axis NameError at the
    first train step and validates.  The config's scan_epochs and
    scan_chunk_bytes, ported since, train stages 1-2 (scan_epochs through
    the whole-epoch path).  checkpoint_backend="msgpack", ported since,
    trains stages 1-2 into the JAX package's directories; the orbax
    backends, ported since, write the trained stage's ``_last`` as orbax
    directories that read back as the model's state."""
    config = kwargs.pop("config", {})
    if set(config) & {"tb_logdir", "remat", "pipeline_unc", "scan_epochs",
                      "scan_chunk_bytes"} or set(kwargs) & {"mesh", "axis_name",
                                                            "checkpoint_backend"}:
        config = {k: (str(tmp_path / v) if k == "tb_logdir" else v) for k, v in config.items()}
        if "mesh" in kwargs:
            kwargs["mesh"] = make_mesh(kwargs["mesh"], devices=["cpu"] * kwargs["mesh"])
        train, val = _loaders(n_train=2)
        monkeypatch.setitem(sys.modules, "tensorflow", None)  # TensorBoard's own stub
        monkeypatch.setitem(CLS_STAGE_RESOLUTIONS, 1, 8)  # the steps resize to 8/16 px
        monkeypatch.setitem(CLS_STAGE_RESOLUTIONS, 2, 16)
        tr = HerlevTrainer(_config(**config), device="cpu", **kwargs)
        if "axis_name" in kwargs:
            tr.setup_optimizer_scheduler(1)
            with pytest.raises(NameError, match="unbound axis name: data"):
                tr.train_epoch(train[1], 1)
            assert np.isfinite(tr.validate_epoch(val[1], 1)[0])
            return
        hist = tr.train_progressive(train, val, str(tmp_path / "out"))
        assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
        if "tb_logdir" in config:
            assert list((tmp_path / "tb").glob("events.out.tfevents.*"))
        assert tr.models[2].unet.inc.conv.remat == ("remat" in config)
        assert list(tr._pipelines) == ([2] if "pipeline_unc" in config else [])
        assert ((2, "mesh") in tr._train_steps) == ("mesh" in kwargs)
        assert (list(tr._epochs) == [(2, "train", False), (2, "eval", False)]) == (
            "scan_epochs" in config)
        assert tr.scan_chunk_bytes == config.get("scan_chunk_bytes", 1 << 30)
        msgpack = "checkpoint_backend" in kwargs
        for stage in (1, 2):
            assert (tmp_path / "out" / f"herlev_stage{stage}_best.pth").is_file() != msgpack
            assert (tmp_path / "out" / f"herlev_stage{stage}_best" / "variables.msgpack"
                    ).is_file() == msgpack
        if msgpack:
            want = full_classifier_state_dict(tr.models[2].state_dict(), 2)
            for backend in ("orbax", "orbax-async"):
                assert HerlevTrainer(_config(), device="cpu",
                                     checkpoint_backend=backend).checkpoint_backend == backend
                tr.checkpoint_backend = backend
                last = tr._save(tmp_path / backend, "herlev_stage2_last", 2, 2,
                                history=tr.history)
                got = read_checkpoint(last)  # waits for the async save
                assert sorted(p.name for p in last.iterdir()) == [
                    "metadata.json", "opt_state_orbax", "variables_orbax"]
                assert got["stage"] == 2 and got["epoch"] == 2
                for k, v in want.items():
                    if not k.endswith("num_batches_tracked"):  # flax has no counter
                        assert torch.equal(got["model_state_dict"][k], v), k
        if "mesh" in kwargs:
            return
        mesh = make_mesh(2, devices=["cpu"] * 2)
        if "pipeline_unc" in config:
            with pytest.raises(ValueError, match="mutually exclusive"):
                HerlevTrainer(_config(**config), device="cpu", mesh=mesh)
        else:
            HerlevTrainer(_config(**config), device="cpu", mesh=mesh)
        return


@pytest.mark.parametrize("flags", [
    ["--mesh", "4,2"], ["--scan_epochs"], ["--scan_chunk_mb", "512"], ["--tb_logdir", "tb"],
    ["--remat"], ["--pipeline_unc", "1"], ["--checkpoint_backend", "msgpack"],
    ["--checkpoint_backend", "orbax"], ["--checkpoint_backend", "orbax-async"],
])
def test_command_flags_outside_the_slice_exit_not_ported(flags, tmp_path, capsys, monkeypatch):
    """Exit 2 naming the flag.  Ported since: --tb_logdir, --remat,
    --pipeline_unc, --scan_epochs and --scan_chunk_mb (as the config's
    scan_chunk_bytes; the default 1024 MiB) reach the trainer's config (--pipeline_unc: the train
    loaders drop the ragged final batch), --mesh reaches the trainer (and
    beside --pipeline_unc exits 2 with the JAX package's ValueError);
    under a coordinator --mesh joins the processes first
    (``init_process_group`` records its call here) and, without a process
    count, exits 2 before any rendezvous.  --checkpoint_backend msgpack, orbax and
    orbax-async,
    ported since, reaches the trainer; orbax exits 2 with its reason."""
    if flags[0] in ("--tb_logdir", "--remat", "--pipeline_unc", "--mesh", "--scan_epochs",
                    "--scan_chunk_mb", "--checkpoint_backend"):
        from ugpg_tpu_torch.train import cls_trainer

        seen = {}
        real = cls_trainer.HerlevTrainer

        def trainer(config, **kwargs):
            seen.update(config, **kwargs)
            raise KeyboardInterrupt  # stop before training

        monkeypatch.setattr(cls_trainer, "HerlevTrainer", trainer)
        root = write_herlev_tree(tmp_path / "Herlev")
        argv = ["--data_dir", str(root), "--device", "cpu", "--output_dir", str(tmp_path / "o")]
        with pytest.raises(KeyboardInterrupt):
            train_herlev.cli(argv + flags)
        if flags[0] == "--mesh":
            import torch.distributed as dist

            assert seen["mesh"].shape == {"data": 4, "model": 2}
            joined = []
            monkeypatch.setattr(dist, "init_process_group", lambda **kw: joined.append(kw))
            monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
            monkeypatch.setenv("WORLD_SIZE", "2")
            seen.clear()
            with pytest.raises(KeyboardInterrupt):
                train_herlev.cli(argv + flags)
            assert seen["mesh"].shape == {"data": 4, "model": 2}
            assert [j["init_method"] for j in joined] == ["tcp://localhost:1234"]
            monkeypatch.delenv("WORLD_SIZE")
        else:
            key = flags[0][2:]
            want = {"tb_logdir": "tb", "remat": True, "pipeline_unc": 1, "scan_epochs": True,
                    "checkpoint_backend": flags[-1]}
            assert key == "scan_chunk_mb" or seen[key] == want[key]
            assert seen["scan_chunk_bytes"] == (512 << 20 if key == "scan_chunk_mb" else 1 << 30)
            with pytest.raises(KeyboardInterrupt):
                train_herlev.cli(argv + flags + ["--mesh", "2"])
            assert seen["mesh"].shape == {"data": 2, "model": 1}
            if key != "pipeline_unc":
                return
            monkeypatch.setattr(cls_trainer, "HerlevTrainer", real)
            with pytest.raises(SystemExit) as info:
                train_herlev.cli(argv + flags + ["--mesh", "2"])
            assert info.value.code == 2 and "mutually exclusive" in capsys.readouterr().err
            return
    with pytest.raises(SystemExit) as info:
        train_herlev.cli(["--data_dir", str(tmp_path), "--device", "cpu", *flags])
    err = capsys.readouterr().err
    missing = "no process count" if flags[0] == "--mesh" else "not ported"
    assert info.value.code == 2 and missing in err and flags[0] in err


def test_command_line_trains_stage_1(tmp_path, monkeypatch):
    root = write_herlev_tree(tmp_path / "Herlev")
    out = tmp_path / "out"
    rc = train_herlev.cli(["--data_dir", str(root), "--output_dir", str(out), "--stages", "1",
                           "--epochs", "1", "--batch_size", "4", "--device", "cpu"])
    assert rc == 0
    obj = read_checkpoint(out / "herlev_stage1_best.pth")
    assert obj["config"]["num_classes"] == 7 and len(obj["config"]["class_weights"]) == 7
    assert json.loads((out / "config.json").read_text())["stages"] == [1]
