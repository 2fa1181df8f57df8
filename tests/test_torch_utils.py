"""The port's training utilities against ``ugpg_tpu/utils`` on the CPU; cases
after ``tests/test_utils.py``: the config dataclasses (their defaults equal
JAX's, and a JSON file either package writes loads in the other), ``apply_overrides``,
``StepTimer``, ``annotate`` and ``trace`` (a Chrome trace file that names the
annotated region), ``TBWriter`` (event files, and one warning and no events
without the backend), and the Herlev command line with ``--tb_logdir``,
``--remat`` and ``--pipeline_unc 1``.
"""

import builtins
import dataclasses
import json
import sys
import time

import pytest
import torch

from tests.test_torch_herlev_data import write_herlev_tree
from ugpg_tpu.utils import config as jax_config
from ugpg_tpu_torch.cli import train_herlev
from ugpg_tpu_torch.models import classifier as port_classifier_mod
from ugpg_tpu_torch.utils.config import (
    HerlevTrainConfig,
    SegTrainConfig,
    apply_overrides,
    load_config,
    save_config,
)
from ugpg_tpu_torch.utils.profiling import StepTimer, annotate, trace
from ugpg_tpu_torch.utils.tb import TBWriter


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's tests: the suite runs six test
    processes at once, where torch's default of a thread per core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def test_config_defaults_match_jax():
    for port_cls, jax_cls in ((SegTrainConfig, jax_config.SegTrainConfig),
                              (HerlevTrainConfig, jax_config.HerlevTrainConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    assert SegTrainConfig().stage_configs() == jax_config.SegTrainConfig().stage_configs()
    assert HerlevTrainConfig(binary_classification=True).as_trainer_config()["num_classes"] == 2


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_config_json_loads_in_the_other_package(writer, tmp_path):
    seg = dict(stages=[1, 2], epochs_per_stage=3, bf16=True, pos_weight=4.5)
    herlev = dict(pretrained_unet_paths={2: "/x"}, data_dir="/d", class_weights=[1.0, 2.0])
    save, load = ((save_config, jax_config.load_config) if writer == "port"
                  else (jax_config.save_config, load_config))
    src = {"port": (SegTrainConfig, HerlevTrainConfig),
           "jax": (jax_config.SegTrainConfig, jax_config.HerlevTrainConfig)}[writer]
    for cls, kw, name in ((src[0], seg, "seg.json"), (src[1], herlev, "herlev.json")):
        cfg = cls(**kw)
        back = load(save(cfg, tmp_path / name))
        assert type(back).__name__ == cls.__name__
        assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    # the port's own round trip
    cfg = HerlevTrainConfig(**herlev)
    assert load_config(save_config(cfg, tmp_path / "own.json")) == cfg
    assert json.loads((tmp_path / "own.json").read_text())["__config_class__"] == \
        "HerlevTrainConfig"


def test_apply_overrides():
    cfg = SegTrainConfig()
    out = apply_overrides(cfg, batch_size=16, data_dir=None)
    assert out.batch_size == 16 and out.data_dir == cfg.data_dir
    assert out == jax_config.apply_overrides(cfg, batch_size=16, data_dir=None)


def test_step_timer():
    t = StepTimer()
    for _ in range(5):
        with t:
            time.sleep(0.002)
    s = t.summary()
    assert s["steps"] == 5 and s["mean_s"] >= 0.002 and s["total_s"] >= 0.01
    assert t.ema is not None and StepTimer().summary() == {}


def test_trace_writes_a_chrome_trace_naming_the_annotated_regions(tmp_path):
    with annotate("outside a trace"):  # a no-op region
        pass
    with trace(tmp_path / "trace") as prof:
        with annotate("pipelined_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.loads(files[0].read_text())["traceEvents"]}
    assert "pipelined_step" in names and "aten::mm" in names
    assert any(e.key == "pipelined_step" for e in prof.key_averages())


@pytest.fixture
def no_tensorflow(monkeypatch):
    """TensorBoard without TensorFlow (its own stub, as on a machine that has
    no TensorFlow): importing TensorFlow is most of the writer's import time."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def test_tbwriter_writes_events(tmp_path, no_tensorflow):
    w = TBWriter(tmp_path / "tb")
    assert w.active
    w.scalars(0, **{"stage1/train_loss": 0.5, "stage1/val_dice": 0.25})
    w.close()
    events = list((tmp_path / "tb").glob("events.out.tfevents.*"))
    assert events and events[0].stat().st_size > 0
    assert not TBWriter(None).active


def test_tbwriter_noop_without_backend(monkeypatch, tmp_path):
    """Missing backend -> one warning, no crash, an inert writer."""
    real_import = builtins.__import__

    def no_tb(name, *a, **k):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("no tensorboard here")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_tb)
    with pytest.warns(UserWarning, match="disabled") as record:
        w = TBWriter(tmp_path)
    assert len(record) == 1 and not w.active
    w.scalars(0, loss=1.0)  # no-op, no crash
    w.close()
    assert not list(tmp_path.iterdir())


def test_herlev_command_line_with_the_slice_flags(tmp_path, monkeypatch, capsys, no_tensorflow):
    """``train_herlev --tb_logdir DIR --remat --pipeline_unc 1`` trains stages
    1-2 on the CPU (8/16 px): events written, scalars tagged as JAX tags
    them; on one card ``--pipeline_unc 1`` exits 2 with the JAX package's
    message."""
    monkeypatch.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 1, 8)
    monkeypatch.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 2, 16)
    root = write_herlev_tree(tmp_path / "Herlev")
    out, tb = tmp_path / "out", tmp_path / "tb"
    argv = ["--data_dir", str(root), "--output_dir", str(out), "--stages", "1", "2",
            "--epochs", "1", "--batch_size", "4", "--device", "cpu"]
    assert train_herlev.cli([*argv, "--pipeline_unc", "1", "--remat", "--tb_logdir", str(tb)]) == 0
    assert (out / "herlev_stage2_best.pth").exists()
    events = list(tb.glob("events.out.tfevents.*"))
    assert events and b"stage2/val_acc" in events[0].read_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as info:
        train_herlev.cli([*argv[:-1], "cuda", "--pipeline_unc", "1"])
    err = capsys.readouterr().err
    assert info.value.code == 2 and "n_unc=1 must leave at least one train device out of 1" in err
