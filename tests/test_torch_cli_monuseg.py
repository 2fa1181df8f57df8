"""The port's two MoNuSeg command lines on the CPU (``--device cpu``):
train, preempt with a real SIGTERM (exit 75), resume to the end, then
evaluate at the stage and at native resolution and infer a directory.
The flags of parts not ported yet, which exit 2 with "not ported", are
cases of ``tests/test_torch_port_package.py``.

The commands run the reference's full widths and stage resolutions; here
a bootstrap narrows training (width 0.25, stages at 16 and 32 px) so that
the tiny tree of ``tests/test_torch_aug_trainer.py`` trains in seconds,
and the evaluator's models are narrowed to match.  The evaluator itself is
held against the JAX package in ``tests/test_torch_eval_monuseg.py``.
"""

import csv
import functools
import json
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_aug_trainer import tree  # noqa: F401  (the module-scoped fixture)
from ugpg_tpu_torch import native
from ugpg_tpu_torch.cli import test_monuseg, train_monuseg
from ugpg_tpu_torch.eval import serving
from ugpg_tpu_torch.io.checkpoint import read_checkpoint
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS

ROOT = Path(__file__).resolve().parents[1]
# narrows the commands' models for the CPU: width 0.25, stages at 16/16/32/32 px
BOOTSTRAP = """
import sys
import ugpg_tpu_torch.train.aug_trainer as at
at.DEFAULT_STAGE_CONFIGS = {s: {**c, "resolution": r} for (s, c), r in
                            zip(sorted(at.DEFAULT_STAGE_CONFIGS.items()), (16, 16, 32, 32))}
_init = at.AugMoNuSegTrainer.__init__
def _narrow(self, config=None, **kwargs):
    kwargs.setdefault("width", 0.25)
    _init(self, config, **kwargs)
at.AugMoNuSegTrainer.__init__ = _narrow
"""
RUN = BOOTSTRAP + """
from ugpg_tpu_torch.cli.train_monuseg import cli
sys.exit(cli(sys.argv[1:]))
"""


def _train_argv(tree, out, *extra):
    return ["--data_dir", str(tree), "--output_dir", str(out), "--stages", "1", "2",
            "--epochs", "2", "--batch_size", "1", "--checkpoint_every", "1", "--device", "cpu",
            *extra]


def _start(argv):
    return subprocess.Popen([sys.executable, "-u", "-c", RUN, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_train_preempt_resume_then_evaluate(tree, tmp_path, monkeypatch):  # noqa: F811
    out = tmp_path / "out"
    proc = _start(_train_argv(tree, out))
    log = []
    try:
        for line in proc.stdout:
            log.append(line)
            if line.startswith("Stage 2, Batch"):
                proc.send_signal(signal.SIGTERM)
                break
        log += proc.stdout.readlines()
        rc = proc.wait(timeout=300)
    finally:
        proc.kill()
    text = "".join(log)
    assert rc == 75, text
    assert "Preemption requested" in text
    last = read_checkpoint(out / "ug_pgunet_stage2_last.pth")
    # the stop comes at the end of the epoch the signal arrived in (epoch 0,
    # unless this host is slow enough for it to land in epoch 1)
    assert last["stage"] == 2 and last["epoch"] in (0, 1), text
    assert last["optimizer_state_dict"]["state"]
    assert len(last["history"]["train_loss"]) == 2 + last["epoch"] + 1
    assert not list(out.glob("ug_pgunet_stage3*"))

    proc = _start(_train_argv(tree, out, "--resume"))
    text, _ = proc.communicate(timeout=300)
    assert proc.returncode == 0, text
    assert "Resuming from stage 2" in text
    for stage in (1, 2):
        assert (out / f"ug_pgunet_stage{stage}_best.pth").exists()
    with open(out / "training_log.csv") as f:
        rows = [(r["stage"], r["epoch"]) for r in csv.DictReader(f)]
    assert rows == [("1", "1"), ("1", "2"), ("2", "1"), ("2", "2")]  # none lost, none repeated
    hist = read_checkpoint(out / "ug_pgunet_stage2_last.pth")["history"]
    assert len(hist["train_loss"]) == 4 and hist["stage_transitions"] == [0, 2]
    assert json.loads((out / "config.json").read_text())["resume"] is True

    # evaluation through the command line, at the stage and native resolution;
    # the evaluator builds the reference widths, narrowed here like training
    monkeypatch.setattr(serving, "STAGE_MODELS", {
        s: functools.partial(cls, width=0.25) for s, cls in STAGE_MODELS.items()})
    model = str(out / "ug_pgunet_stage2_best.pth")
    res = tmp_path / "res"
    common = ["--model", model, "--data", str(tree), "--num_images", "2", "--eval_full",
              "--save_uncertainty", "--device", "cpu", "--output_dir", str(res)]
    stage_res = test_monuseg.main(common)
    native_res = test_monuseg.main(common + ["--native_res"])
    infer = test_monuseg.main(["--model", model, "--infer_dir", str(tree / "val" / "images"),
                               "--device", "cpu", "--output_dir", str(tmp_path / "inf")])
    for name, got in (("evaluation_results.json", stage_res),
                      ("evaluation_results_native.json", native_res)):
        saved = json.loads((res / name).read_text())
        assert saved == got["metrics"]
        assert saved["stage"] == 2 and saved["num_samples"] == 2
        assert all(np.isfinite(v) for k, v in saved.items() if k.endswith(("_mean", "_std")))
    assert native_res["metrics"]["native_resolution"]
    unc_maps = sorted(res.glob("uncertainty_*.png"))
    assert len(unc_maps) == 2
    for path in unc_maps:
        assert native.decode_png_gray(path).shape == (64, 64)  # the stage-2 resolution
    assert sorted(infer["inference"]) == ["val_0.tif", "val_1.tif"]
    for stem in ("val_0", "val_1"):
        mask = native.decode_png_gray(tmp_path / "inf" / f"{stem}_mask.png")
        vis = native.decode_png(tmp_path / "inf" / f"{stem}_vis.png")
        assert mask.shape == vis.shape[:2] == (32, 32) and set(np.unique(mask)) <= {0, 255}


def test_cli_exit_code_translates_preemption(monkeypatch):
    class _T:
        def __init__(self, preempted):
            self.preempted = preempted

    monkeypatch.setattr(train_monuseg, "main", lambda argv=None: _T(True))
    assert train_monuseg.cli([]) == 75
    monkeypatch.setattr(train_monuseg, "main", lambda argv=None: _T(False))
    assert train_monuseg.cli([]) == 0


def test_commands_default_to_cuda(monkeypatch, tmp_path):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (train_monuseg.build_argparser(), test_monuseg.build_argparser()):
        assert cmd.get_default("device") == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_monuseg.main(["--model", str(tmp_path / "m.pth"), "--infer", "x.png"])


def test_data_flag_is_used_or_refused(monkeypatch, tmp_path, capsys):
    """A ``--data`` without ``val/`` or ``train/`` exits 2 naming it, never
    evaluating another dataset; without ``--data`` only ``./data/MoNuSeg``,
    ``./MoNuSeg`` and ``~/data/MoNuSeg`` are probed, nothing above the
    working directory."""
    (tmp_path / "data" / "MoNuSeg" / "val").mkdir(parents=True)
    (tmp_path / "empty").mkdir()
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")
    monkeypatch.setenv("HOME", str(tmp_path / "cwd"))
    assert test_monuseg.resolve_dataset_path(None) is None  # ../data/MoNuSeg is not read
    monkeypatch.chdir(tmp_path)
    assert test_monuseg.resolve_dataset_path(None) == "./data/MoNuSeg"
    assert test_monuseg.resolve_dataset_path(str(tmp_path / "data" / "MoNuSeg")) == \
        str(tmp_path / "data" / "MoNuSeg")
    with pytest.raises(SystemExit) as info:
        test_monuseg.main(["--model", "m.pth", "--data", str(tmp_path / "empty"),
                           "--eval_full", "--device", "cpu"])
    assert info.value.code == 2 and "no val/ or train/" in capsys.readouterr().err
