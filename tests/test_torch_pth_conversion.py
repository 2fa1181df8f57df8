"""The port's ``.pth`` conversions (``ugpg_tpu_torch/io/torch_export.py``,
``io/torch_import.py`` and their commands) against the JAX package's
``export_torch_checkpoint`` and ``import_torch_checkpoint``, on the CPU.

* Export: a JAX-written msgpack and orbax directory (segmentation stages 1
  and 4 at width 0.25) give the JAX export's ``.pth``: the same container
  keys and scalars, the same state-dict keys, dtypes and bits (zero int64
  ``num_batches_tracked`` included), loadable strictly by the port's model.
  A stage-2 classifier: the encoder and head bit for bit, the decoder keys
  that pad it to the reference's full ``unet`` key set of equal shapes and
  dtypes (the JAX export draws them from ``jax.random``, the port from
  torch's default initialisation; the reference's forward never reads
  them).  ``raw_state_dict``, the stage override, the unmapped-leaf message
  and ``strict`` as JAX's.
* Import: a reference container (stage 1), a bare state dict (stage 4 by
  the sniff) and a classifier ``.pth`` (stage 2, with the decoder keys the
  import leaves out) written as directories whose ``variables.msgpack``
  bytes equal the JAX import's, whose ``metadata.json`` is equal as JSON,
  and which the JAX package's ``load_checkpoint`` reads with its templates.
  The JAX import builds its template at full width, so these run at full
  width.
* Both commands exit 0 through ``cli``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_models import jax_variables
from ugpg_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from ugpg_tpu.io.checkpoint import save_checkpoint as jax_save_checkpoint
from ugpg_tpu.io.torch_export import convert_variables_to_state_dict
from ugpg_tpu.io.torch_export import export_torch_checkpoint as jax_export
from ugpg_tpu.io.torch_import import import_torch_checkpoint as jax_import
from ugpg_tpu.models.classifier import CLS_STAGE_RESOLUTIONS
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.models.pgunet import STAGE_MODELS as JAX_STAGE_MODELS
from ugpg_tpu.models.pgunet import STAGE_RESOLUTIONS
from ugpg_tpu_torch.cli import export_torch, import_torch
from ugpg_tpu_torch.io.checkpoint import full_classifier_state_dict, read_checkpoint, save_checkpoint
from ugpg_tpu_torch.io.torch_export import (
    convert_state_dict_to_reference,
    export_torch_checkpoint,
)
from ugpg_tpu_torch.io.torch_import import import_torch_checkpoint
from ugpg_tpu_torch.models.blocks import init_parameters
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS

W = 0.25
K = 7  # Herlev classes
SEG_META = {"stage": None, "epoch": 3, "val_dice": 0.625, "train_dice": 0.75,
            "uncertainty_alpha": 0.5, "history": {"train_loss": [0.5, 0.25]}}
CLS_META = {"stage": 2, "epoch": 4, "train_loss": 0.5, "val_loss": 0.625, "train_acc": 0.75,
            "val_acc": 0.875, "config": {"num_classes": K}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def load_pth(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def assert_same_state_dict(got: dict, want: dict, label=""):
    assert set(got) == set(want), (label, sorted(set(got) ^ set(want))[:8])
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, (label, key)
        assert torch.equal(got[key], value), (label, key)


def assert_same_container(got: dict, want: dict):
    assert list(got) == list(want)
    for key, value in want.items():
        if key != "model_state_dict":
            assert type(got[key]) is type(value) and got[key] == value, key


def jax_seg_directory(tmp_path, stage: int, form: str, **extra):
    variables = jax_variables(stage, width=W, seed=stage)
    variables = {**variables, "params": {**variables["params"], **extra}}
    folder = tmp_path / f"jax_{form}_stage{stage}"
    jax_save_checkpoint(folder, variables, metadata={**SEG_META, "stage": stage}, backend=form)
    return folder


# ---------------------------------------------------------------- export
@pytest.mark.parametrize("stage", [1, 4])
@pytest.mark.parametrize("form", ["msgpack", "orbax"])
def test_export_of_a_jax_directory_is_jax_s(form, stage, tmp_path):
    folder = jax_seg_directory(tmp_path, stage, form)
    jax_export(str(folder), str(tmp_path / "jax.pth"))
    assert export_torch_checkpoint(str(folder), str(tmp_path / "port.pth")) == str(
        tmp_path / "port.pth")
    want, got = load_pth(tmp_path / "jax.pth"), load_pth(tmp_path / "port.pth")
    assert_same_container(got, want)
    assert got["stage"] == stage and got["epoch"] == 3 and got["uncertainty_alpha"] == 0.5
    assert_same_state_dict(got["model_state_dict"], want["model_state_dict"])
    tracked = [k for k in got["model_state_dict"] if k.endswith("num_batches_tracked")]
    assert tracked and all(got["model_state_dict"][k].dtype == torch.int64
                           and int(got["model_state_dict"][k]) == 0 for k in tracked)
    STAGE_MODELS[stage](width=W).load_state_dict(got["model_state_dict"], strict=True)


def test_export_of_a_classifier_pads_it_as_jax_s(tmp_path):
    variables = jax_cls_variables(2, num_classes=K, seed=5)
    folder = tmp_path / "herlev_stage2_best"
    jax_save_checkpoint(folder, variables, metadata=CLS_META)
    jax_export(str(folder), str(tmp_path / "jax.pth"), task_type="classification")
    assert export_torch.cli(["--ckpt", str(folder), "--out", str(tmp_path / "port.pth"),
                             "--task", "classification"]) == 0
    want, got = load_pth(tmp_path / "jax.pth"), load_pth(tmp_path / "port.pth")
    assert_same_container(got, want)
    assert got["config"] == {"num_classes": K, "stage": 2, "exported_from": str(folder)}
    gsd, wsd = got["model_state_dict"], want["model_state_dict"]
    trained, _ = convert_variables_to_state_dict(variables)
    assert set(gsd) == set(wsd) and set(trained) < set(gsd)
    for key, value in wsd.items():
        assert gsd[key].dtype == value.dtype and gsd[key].shape == value.shape, key
        if key in trained:
            assert torch.equal(gsd[key], value), key
    model = HerlevClassificationModel(stage=2, num_classes=K)
    model.load_state_dict({k: v for k, v in gsd.items() if k in model.state_dict()}, strict=True)


@pytest.mark.parametrize("case", ["raw", "stage_override", "unmapped", "strict"])
def test_export_options_are_jax_s(case, tmp_path, capsys):
    extra = {"extra": {"kernel": np.ones((2, 3), np.float32)}} if case in (
        "unmapped", "strict") else {}
    folder = jax_seg_directory(tmp_path, 4, "msgpack", **extra)
    kwargs = {"raw": {"raw_state_dict": True}, "stage_override": {"stage": 3},
              "unmapped": {}, "strict": {"strict": True}}[case]
    if case == "strict":
        for export in (jax_export, export_torch_checkpoint):
            with pytest.raises(ValueError, match=r"export: 1 unmapped leaves .*params/extra/kernel"):
                export(str(folder), str(tmp_path / "x.pth"), **kwargs)
        assert not (tmp_path / "x.pth").exists()
        return
    capsys.readouterr()
    jax_export(str(folder), str(tmp_path / "jax.pth"), **kwargs)
    jax_out = capsys.readouterr().out
    export_torch_checkpoint(str(folder), str(tmp_path / "port.pth"), **kwargs)
    port_out = capsys.readouterr().out
    assert port_out == jax_out.replace("jax.pth", "port.pth")
    want, got = load_pth(tmp_path / "jax.pth"), load_pth(tmp_path / "port.pth")
    if case == "raw":
        assert "model_state_dict" not in got
        assert_same_state_dict(got, want)
        return
    assert_same_container(got, want)
    assert_same_state_dict(got["model_state_dict"], want["model_state_dict"])
    assert got["stage"] == (3 if case == "stage_override" else 4)
    if case == "unmapped":
        assert "export: 1 unmapped leaves (examples: ['params/extra/kernel'])" in port_out


def test_export_of_a_pth_keeps_its_keys_and_zeroes_the_counters(tmp_path):
    model = STAGE_MODELS[2](width=W)
    init_parameters(model, torch.Generator().manual_seed(2))
    sd = {k: (torch.tensor(7) if k.endswith("num_batches_tracked") else v)
          for k, v in model.state_dict().items()}
    save_checkpoint(tmp_path / "in.pth", sd, stage=2, epoch=9, val_dice=0.5)
    export_torch_checkpoint(tmp_path / "in.pth", tmp_path / "out.pth")
    got = load_pth(tmp_path / "out.pth")
    assert got["stage"] == 2 and got["epoch"] == 9 and got["val_dice"] == 0.5
    want = {k: (torch.tensor(0) if k.endswith("num_batches_tracked") else v) for k, v in sd.items()}
    assert_same_state_dict(got["model_state_dict"], want)
    ref, skipped = convert_state_dict_to_reference(sd)
    assert not skipped and set(ref) == set(sd)


# ---------------------------------------------------------------- import
def _seeded(model: torch.nn.Module, seed: int) -> dict:
    init_parameters(model, torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = model.state_dict()
    for key, value in sd.items():
        if key.endswith("running_mean"):
            value.copy_(0.1 * torch.randn(value.shape, generator=g))
        elif key.endswith("running_var"):
            value.copy_(1 + 0.2 * torch.rand(value.shape, generator=g))
    return sd


def _jax_template(case: str):
    if case == "classifier":
        res = CLS_STAGE_RESOLUTIONS[2]
        module = JaxClassifier(stage=2, num_classes=K)
    else:
        stage = 1 if case == "container" else 4
        res = STAGE_RESOLUTIONS[stage]
        module = JAX_STAGE_MODELS[stage](num_classes=1)
    return jax.eval_shape(lambda: module.init(jax.random.key(0), jnp.zeros((1, res, res, 3)),
                                              False))


@pytest.mark.parametrize("case", ["container", "raw", "classifier"])
def test_import_writes_the_jax_import_s_directory(case, tmp_path, capsys):
    pth = tmp_path / "in.pth"
    if case == "container":
        sd = _seeded(STAGE_MODELS[1](), 11)
        save_checkpoint(pth, sd, stage=1, epoch=5, val_dice=0.5, train_dice=0.625,
                        uncertainty_alpha=0.75, history={"train_loss": [0.5]})
    elif case == "raw":
        sd = _seeded(STAGE_MODELS[4](), 12)
        torch.save(sd, pth)
    else:
        sd = full_classifier_state_dict(_seeded(HerlevClassificationModel(2, K), 13), 2)
        save_checkpoint(pth, sd, **CLS_META)
    task = "classification" if case == "classifier" else "segmentation"
    classes = K if case == "classifier" else 1
    capsys.readouterr()
    _, jax_stage = jax_import(str(pth), num_classes=classes, task_type=task,
                              output_dir=str(tmp_path / "jax"))
    jax_out = capsys.readouterr().out
    if case == "classifier":
        assert import_torch.cli(["--pth", str(pth), "--out", str(tmp_path / "port"), "--task",
                                 "classification"]) == 0
        got_sd, stage = import_torch_checkpoint(pth, num_classes=K, task_type=task)
    else:
        got_sd, stage = import_torch_checkpoint(pth, num_classes=classes, task_type=task,
                                                output_dir=tmp_path / "port")
    port_out = capsys.readouterr().out
    assert stage == jax_stage == {"container": 1, "raw": 4, "classifier": 2}[case]
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())
    assert (port_dir / "variables.msgpack").read_bytes() == (
        jax_dir / "variables.msgpack").read_bytes()
    meta = json.loads((port_dir / "metadata.json").read_text())
    assert meta == json.loads((jax_dir / "metadata.json").read_text())
    assert meta["stage"] == stage and meta["imported_from"] == str(pth)
    variables, _, _ = jax_load_checkpoint(port_dir, variables_template=_jax_template(case))
    assert jax.tree.structure(variables) == jax.tree.structure(_jax_template(case))
    # the returned state dict is the directory's, read back by the port (which pads a
    # classifier with the decoder keys again)
    back = read_checkpoint(port_dir)["model_state_dict"]
    assert set(got_sd) <= set(back) and (case == "classifier" or set(got_sd) == set(back))
    assert_same_state_dict(got_sd, {k: back[k] for k in got_sd})
    if case == "classifier":  # the decoder keys are left out, as the JAX import skips them
        assert "import: " in port_out and "import: " in jax_out
        assert port_out.split("import: ")[1].split(" ")[0] == jax_out.split(
            "import: ")[1].split(" ")[0]
        assert not any(k.startswith("unet.up") for k in got_sd)


def test_import_fills_keys_the_pth_lacks(tmp_path, capsys):
    sd = _seeded(STAGE_MODELS[1](), 3)
    partial = {k: v for k, v in sd.items() if not k.startswith("outc.")}
    save_checkpoint(tmp_path / "in.pth", partial, stage=1)
    got, stage = import_torch_checkpoint(tmp_path / "in.pth")
    assert stage == 1 and "2 keys of the stage-1 model not in" in capsys.readouterr().out
    for key, value in partial.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value), key
    assert set(got) == set(sd)
    with pytest.raises(ValueError, match="shape mismatch"):
        import_torch_checkpoint(tmp_path / "in.pth", stage=2)
