"""The training half of ``parallel/spatial.py`` (``make_spatial_train_step``,
``make_spatial_eval_step``), ``finetune_native`` and the training commands'
``--mesh`` / ``--native_finetune``, on the CPU: against the JAX package's
spatial steps on its fake CPU devices (``tests/test_spatial_train.py``) and
against the port's own unsharded ``make_seg_train_step`` on the same batch
(the image already at the step's resolution, so its resize is the
identity, and the previous stage at half of it).

PGUNet1/PGUNet2 at width 0.25 on 32 px images, batches of 2 (4 with
``accum_steps=2``), meshes of ``torch.device("cpu", i)``: stage 1 on 2 x 1
(H over ``data``), stage 2 on 2 x 2 with W over ``model`` and the frozen
stage 1 as the uncertainty source, stage 2 on 2 x 1 with ``accum_steps=2``.

Tolerances, as ``tests/test_spatial_train.py:79-101``: metrics rtol 2e-4,
atol 1e-5 (the port's uncertainty source folds BN and JAX's does not, held
to 1e-4 elsewhere); BN running stats rtol 1e-4, atol 1e-6.  The gradients
that flow back through the halos against the unsharded step's: rtol 1e-4
plus 1e-5 x the largest gradient (1e-3 x with ``accum_steps=2``, where a
ReLU or max-pool decision on float32 round-off moves a few gradients, as
``tests/test_torch_train.py::test_accumulated_train_step_matches_jax``
documents for JAX).  With ``accum_steps=2`` the Dice and the accuracy
against JAX take atol 1e-3: two of the batch's 8,192 pixel decisions sit
on float32 noise at a logit of 0 and differ between the two packages'
unsharded steps as well (measured: each package's spatial step equals its
own unsharded one there).
"""

import functools

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tests.test_data_monuseg import write_monuseg_tree
from tests.test_torch_herlev_data import write_herlev_tree
from tests.test_torch_models import jax_variables
from tests.test_torch_train import _capture_grads, _port_model
from ugpg_tpu.parallel.spatial import make_spatial_eval_step as jax_spatial_eval
from ugpg_tpu.parallel.spatial import make_spatial_train_step as jax_spatial_train
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu.train.steps import TrainState
from ugpg_tpu_torch.cli import train_herlev, train_monuseg
from ugpg_tpu_torch.eval import serving
from ugpg_tpu_torch.eval.slide import SlidePredictor
from ugpg_tpu_torch.io.checkpoint import read_checkpoint
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.parallel.mesh import make_mesh
from ugpg_tpu_torch.parallel.spatial import (
    make_spatial_eval_step,
    make_spatial_train_step,
    spatial_predict,
)
from ugpg_tpu_torch.train import aug_trainer, seg_trainer
from ugpg_tpu_torch.train.optim import torch_rmsprop
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.train.steps import METRIC_KEYS, make_seg_eval_step, make_seg_train_step

PX, LR, WD, PW = 32, 3e-4, 1e-4, 5.0
CASES = {  # stage, (data, model), the W axis, accum_steps
    "stage1-2x1": (1, (2, 1), None, 1),
    "stage2-2x2-w": (2, (2, 2), "model", 1),
    "stage2-2x1-accum2": (2, (2, 1), None, 2),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_mesh_of(shape):
    return make_mesh(*shape, devices=[torch.device("cpu", i) for i in range(shape[0] * shape[1])])


def _batch(n, px=PX, seed=0):
    g = np.random.default_rng(seed)
    return (g.random((n, px, px, 3), dtype=np.float32),
            (g.random((n, px, px, 1)) > 0.6).astype(np.float32))


def _case(name):
    stage, shape, w_axis, accum = CASES[name]
    v_prev = jax_variables(1, width=0.25, seed=1)
    v = v_prev if stage == 1 else jax_variables(2, width=0.25, seed=2)
    return stage, shape, w_axis, accum, v, v_prev, _batch(2 * accum, seed=stage + accum)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's spatial train and eval steps on each case, compiled once each."""
    out = {}
    for name in CASES:
        stage, shape, w_axis, accum, v, v_prev, batch = _case(name)
        devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        mesh = JaxMesh(devs, axis_names=("data", "model"))
        tx = optax.chain(_capture_grads(), jax_rmsprop(LR, weight_decay=WD))
        prev_stage = 1 if stage > 1 else None
        step = jax_spatial_train(stage, mesh, tx, w_axis=w_axis, prev_stage=prev_stage,
                                 donate=False, accum_steps=accum)
        prev_v = v_prev if stage > 1 else {}
        new, jm = step(TrainState.create(v, tx), prev_v, batch, PW)
        em = jax_spatial_eval(stage, mesh, w_axis=w_axis, prev_stage=prev_stage)(
            v, prev_v, batch, PW)
        out[name] = jax.device_get((new, jm, em))
    return out


def _assert_metrics(got, want, rtol=2e-4, atol=1e-5):
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=atol,
                                   err_msg=k)


def _assert_stats(got: dict, want: dict):
    for key, value in want.items():
        if "running" in key:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=key)


@pytest.mark.parametrize("case", CASES)
def test_spatial_steps_match_jax_and_the_unsharded_step(case, jax_runs):
    stage, shape, w_axis, accum, v, v_prev, batch = _case(case)
    new, jm, em = jax_runs[case]
    model = _port_model(stage, v)
    prev = _port_model(1, v_prev).eval() if stage > 1 else None
    step = make_spatial_train_step(model, torch_rmsprop(model.parameters(), LR, weight_decay=WD),
                                   stage, port_mesh_of(shape), w_axis=w_axis, prev_model=prev,
                                   accum_steps=accum)
    got = step(batch, PW)
    if stage > 1:
        assert float(got["uncertainty_weight_mean"]) > 0
    if accum == 1:
        _assert_metrics(got, jm)
    else:  # two of the 8,192 decisions sit on float32 noise at a logit of 0 (docstring)
        _assert_metrics({k: v for k, v in got.items() if k not in ("dice", "accuracy")},
                        {k: jm[k] for k in METRIC_KEYS if k not in ("dice", "accuracy")})
        for k in ("dice", "accuracy"):
            np.testing.assert_allclose(float(got[k]), float(jm[k]), atol=1e-3, err_msg=k)
    _assert_stats(model.state_dict(), state_dict_from_jax(new.variables))

    plain = _port_model(stage, v)
    want = make_seg_train_step(plain, torch_rmsprop(plain.parameters(), LR, weight_decay=WD),
                               stage, PX, prev_model=prev, prev_resolution=PX // 2,
                               accum_steps=accum)(batch, PW)
    _assert_metrics(got, want)
    _assert_stats(model.state_dict(), plain.state_dict())
    grads = {n: p.grad for n, p in plain.named_parameters()}
    gmax = max(g.abs().max().item() for g in grads.values())
    for name, p in model.named_parameters():  # the halos' backward
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), rtol=1e-4,
                                   atol=(1e-3 if accum > 1 else 1e-5) * gmax, err_msg=name)

    if accum == 1:  # the eval steps, on the weights before the update
        model = _port_model(stage, v)
        ev = make_spatial_eval_step(model, stage, port_mesh_of(shape), w_axis=w_axis,
                                    prev_model=prev)(batch, PW)
        _assert_metrics(ev, em)
        _assert_metrics(ev, make_seg_eval_step(_port_model(stage, v), stage, PX, prev,
                                               PX // 2)(batch, PW))


def test_spatial_step_refuses_an_indivisible_size():
    model = STAGE_MODELS[2](num_classes=1, width=0.25)
    step = make_spatial_train_step(model, torch_rmsprop(model.parameters(), LR), 2,
                                   port_mesh_of((2, 2)), w_axis="model")
    with pytest.raises(ValueError, match="not divisible"):
        step(_batch(1, px=36), PW)  # stage 2 on 2 x 2: multiples of 8
    with pytest.raises(ValueError, match="accum_steps"):
        make_spatial_train_step(model, torch_rmsprop(model.parameters(), LR), 2,
                                port_mesh_of((2, 1)), accum_steps=0)


def test_spatial_train_step_after_an_inference_forward():
    """The resize bands are cached per shape: made first by the inference
    forward (under inference mode), they still serve the train step's
    autograd."""
    model = STAGE_MODELS[2](num_classes=1, width=0.25)
    mesh = port_mesh_of((2, 1))
    images, masks = _batch(1, px=24, seed=9)
    spatial_predict(model.state_dict(), images, mesh, stage=2)
    step = make_spatial_train_step(model, torch_rmsprop(model.parameters(), LR), 2, mesh,
                                   prev_model=STAGE_MODELS[1](num_classes=1, width=0.25).eval())
    assert np.isfinite(float(step((images, masks), PW)["final_loss"]))


# ---------------------------------------------------------------- finetune_native
def _slides(n, h=40, w=44, seed=1):
    """Learnable slides: the mask is where the red channel is bright."""
    g = np.random.default_rng(seed)
    images = g.random((n, 1, h, w, 3), dtype=np.float32)
    return [(im, (im[..., :1] > 0.6).astype(np.float32)) for im in images]


def _narrow_serving(monkeypatch):
    monkeypatch.setattr(serving, "STAGE_MODELS", {
        s: functools.partial(cls, width=0.25) for s, cls in STAGE_MODELS.items()})


def test_finetune_native_learns_and_its_checkpoint_serves(tmp_path, monkeypatch):
    """Stage 2 on a 2 x 2 grid (W over ``model``) from 40 x 44 slides
    (cropped to 40 x 40): the loss falls over three epochs; the saved
    ``_native.pth`` carries the JAX package's metadata and serves through
    SlidePredictor as the trainer's model does."""
    tr = UncertaintyGuidedProgressiveTrainer(verbose=False, width=0.25, device="cpu",
                                             mesh=port_mesh_of((2, 2)), fused_loss=True)
    slides = _slides(2)
    hist = tr.finetune_native(slides, stage=2, epochs=3, w_axis="model", lr=1e-3,
                              val_loader=slides[:1], save_dir=str(tmp_path))
    assert hist["train_loss"][-1] < hist["train_loss"][0]
    assert len(hist["val_loss"]) == 3 and np.isfinite(hist["val_dice"]).all()
    obj = read_checkpoint(tmp_path / "ug_pgunet_stage2_native.pth")
    assert obj["native_finetune"] is True and obj["stage"] == 2 and obj["epochs"] == 3
    assert obj["history"] == hist and "optimizer_state_dict" in obj
    for key, value in tr.models[2].state_dict().items():
        assert torch.equal(obj["model_state_dict"][key], value), key
    assert tr.optimizer is not None and tr._optimizer_stage == 2
    _narrow_serving(monkeypatch)
    preds, probs, unc = SlidePredictor(str(tmp_path / "ug_pgunet_stage2_native.pth"),
                                       device="cpu")(slides[0][0])
    assert probs.shape == (1, 40, 44, 1) and np.isfinite(probs).all()
    with pytest.raises(ValueError, match="smaller than the grid divisor"):
        tr.finetune_native(_slides(1, h=4, w=44), stage=2, mesh=port_mesh_of((2, 1)))


def test_finetune_native_inherits_the_trainers_dtype(monkeypatch):
    seen = []

    def spy(*args, **kwargs):
        seen.append(kwargs["dtype"])
        return make_spatial_train_step(*args, **kwargs)

    monkeypatch.setattr(seg_trainer, "make_spatial_train_step", spy)
    tr = UncertaintyGuidedProgressiveTrainer(verbose=False, width=0.25, device="cpu",
                                             dtype=torch.bfloat16, mesh=port_mesh_of((2, 1)))
    hist = tr.finetune_native(_slides(1), stage=1)
    tr.finetune_native(_slides(1), stage=1, dtype=None)
    assert seen == [torch.bfloat16, torch.float32] and np.isfinite(hist["train_loss"]).all()
    with pytest.raises(ValueError, match="needs a mesh"):
        UncertaintyGuidedProgressiveTrainer(verbose=False, device="cpu").finetune_native([])


# ---------------------------------------------------------------- the commands
def test_train_monuseg_mesh_native_finetune(tmp_path, monkeypatch):
    """``train_monuseg --mesh 2 --native_finetune 1`` on a tiny tree (width
    0.25, stages at 16 and 32 px, as tests/test_torch_cli_monuseg.py
    narrows the command); the ``_native.pth`` serves through
    SlidePredictor."""
    root = write_monuseg_tree(tmp_path / "MoNuSeg", n_train=4, n_val=2, size=32)
    monkeypatch.setattr(aug_trainer, "DEFAULT_STAGE_CONFIGS", {
        s: {**c, "resolution": r} for (s, c), r in
        zip(sorted(aug_trainer.DEFAULT_STAGE_CONFIGS.items()), (16, 32, 32, 32))})
    init = aug_trainer.AugMoNuSegTrainer.__init__
    monkeypatch.setattr(aug_trainer.AugMoNuSegTrainer, "__init__",
                        lambda self, config=None, **kw: init(self, config, width=0.25, **kw))
    out = tmp_path / "out"
    trainer = train_monuseg.main([
        "--data_dir", str(root), "--output_dir", str(out), "--stages", "1", "2", "--epochs",
        "1", "--batch_size", "2", "--plain", "--device", "cpu", "--mesh", "2",
        "--native_finetune", "1", "--native_size", "32"])
    assert trainer.mesh.shape == {"data": 2, "model": 1}
    assert (1, "mesh") in trainer._train_steps  # stage 2's went with its optimizer
    obj = read_checkpoint(out / "ug_pgunet_stage2_native.pth")
    assert obj["native_finetune"] is True and len(obj["history"]["val_loss"]) == 1
    _narrow_serving(monkeypatch)
    tile = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    _, probs, _ = SlidePredictor(str(out / "ug_pgunet_stage2_native.pth"), device="cpu")(tile)
    assert probs.shape == (1, 32, 32, 1) and np.isfinite(probs).all()


def test_train_herlev_mesh(tmp_path, monkeypatch):
    root = write_herlev_tree(tmp_path / "Herlev")
    monkeypatch.setitem(CLS_STAGE_RESOLUTIONS, 1, 16)
    out = tmp_path / "out"
    trainer = train_herlev.main(["--data_dir", str(root), "--output_dir", str(out), "--stages",
                                 "1", "--epochs", "1", "--batch_size", "4", "--mesh", "2",
                                 "--device", "cpu"])
    assert trainer.mesh.shape == {"data": 2, "model": 1}
    assert (1, "mesh") in trainer._train_steps
    assert np.isfinite(trainer.history["train_loss"]).all()
    assert (out / "herlev_stage1_best.pth").exists()
