"""The port's training path against the JAX package: losses, the nearest
resize, metrics, the uncertainty map and weighting, RMSprop, weight
transfer, the train and eval steps, and the progressive trainer end to end.

Everything runs on the CPU in float32 at width 0.25 (the trainer's
checkpoint test at full width), with inputs from numpy seeds and weights
bridged from the JAX trees (``state_dict_from_jax``).  Tolerances:

* metrics rtol 1e-5 and BN running stats 1e-5: float32 on both sides; the
  JAX BN takes the variance as E[x^2] - E[x]^2, torch in two passes, which
  differ near 1e-6;
* gradients rtol 1e-4 plus atol 1e-5 x the model's largest gradient: the
  convolutions' float32 sums over B*H*W positions run in other orders,
  which leaves up to 2e-6 x max|g| (measured), and the bias of a conv
  followed by BN has a true gradient of 0, so both sides hold only noise;
* parameters after the update elementwise to 1e-5 (1% of RMSprop's first
  step of about 10 lr), except where the gradient RMSprop sees
  (g + wd * p) lies below 1e-5 x max|g|: there the float32 noise above can
  flip its sign, and the first step is then about 2 * 10 * lr apart.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_models import jax_variables
from ugpg_tpu.io.torch_import import convert_torch_state_dict, import_torch_checkpoint
from ugpg_tpu.metrics import segmentation as jax_metrics
from ugpg_tpu.models.pgunet import STAGE_MODELS as JAX_STAGE_MODELS
from ugpg_tpu.ops.losses import bce_with_logits as jax_bce
from ugpg_tpu.ops.resize import resize_nearest as jax_resize_nearest
from ugpg_tpu.progressive.transfer import transfer_weights as jax_transfer
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu.train.steps import TrainState
from ugpg_tpu.train.steps import make_seg_eval_step as jax_eval_step
from ugpg_tpu.train.steps import make_seg_train_step as jax_train_step
from ugpg_tpu.uncertainty import apply_uncertainty_weighted_loss as jax_weighted_loss
from ugpg_tpu.uncertainty import generate_uncertainty_map as jax_unc_map
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.eval.serving import Predictor
from ugpg_tpu_torch.io.checkpoint import load_checkpoint
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.metrics.segmentation import dice_coefficient, get_predictions, pixel_accuracy
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.ops.losses import bce_with_logits
from ugpg_tpu_torch.ops.resize import resize_nearest
from ugpg_tpu_torch.progressive.transfer import transfer_weights
from ugpg_tpu_torch.train.optim import get_learning_rate, set_learning_rate, torch_rmsprop
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.train.steps import METRIC_KEYS, make_seg_eval_step, make_seg_train_step
from ugpg_tpu_torch.uncertainty import apply_uncertainty_weighted_loss, generate_uncertainty_map
from ugpg_tpu_torch.utils.anomaly import TrainingDivergedError

W = 0.25
PW = 5.0
WD = 1e-4
RES = {1: 16, 2: 32}  # quarter-resolution stages, as tests/test_seg_trainer.py
LR = {1: 3e-4, 2: 1e-4}
SMALL_CONFIGS = {
    1: {"resolution": 16, "epochs_per_stage": 2, "lr": 3e-4},
    2: {"resolution": 32, "epochs_per_stage": 1, "lr": 1e-4},
    3: {"resolution": 64, "epochs_per_stage": 1, "lr": 1e-4},
    4: {"resolution": 128, "epochs_per_stage": 1, "lr": 1e-4},
}


def _nchw(a):
    return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _port_model(stage, variables):
    model = STAGE_MODELS[stage](num_classes=1, width=W)
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _jax_module(stage):
    return JAX_STAGE_MODELS[stage](num_classes=1, width=W)


# ---------------------------------------------------------------- pointwise
@pytest.mark.parametrize("pos_weight", [None, PW])
def test_bce_with_logits_matches_jax(pos_weight):
    rs = np.random.default_rng(0)
    x = (rs.standard_normal((2, 9, 11, 1)) * 30).astype(np.float32)  # both tails
    z = (rs.random(x.shape) > 0.5).astype(np.float32)
    got = bce_with_logits(torch.from_numpy(x), torch.from_numpy(z), pos_weight).numpy()
    want = np.asarray(jax_bce(jnp.asarray(x), jnp.asarray(z), pos_weight))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((256, 256), (32, 32)), ((64, 64), (48, 48)),
                                     ((7, 7), (5, 5)), ((5, 5), (7, 7)), ((64, 48), (48, 64))])
def test_resize_nearest_matches_jax(src, dst):
    a = np.random.default_rng(1).random((2, *src, 2)).astype(np.float32)
    got = _nhwc(resize_nearest(_nchw(a), dst))
    np.testing.assert_array_equal(got, np.asarray(jax_resize_nearest(jnp.asarray(a), dst)))


def test_segmentation_metrics_match_jax():
    rs = np.random.default_rng(2)
    logits = rs.standard_normal((3, 16, 16, 1)).astype(np.float32)
    target = (rs.random(logits.shape) > 0.6).astype(np.float32)
    logits[0, 0, 0, 0] = 0.0  # sigmoid exactly 0.5: strict > gives 0
    preds = get_predictions(_nchw(logits))
    want_preds = jax_metrics.get_predictions(jnp.asarray(logits))
    np.testing.assert_array_equal(_nhwc(preds), np.asarray(want_preds))
    assert _nhwc(preds)[0, 0, 0, 0] == 0.0
    t = _nchw(target)
    np.testing.assert_allclose(dice_coefficient(preds, t).item(),
                               float(jax_metrics.dice_coefficient(want_preds, target)), rtol=1e-6)
    np.testing.assert_allclose(pixel_accuracy(preds, t).item(),
                               float(jax_metrics.pixel_accuracy(want_preds, target)), rtol=1e-6)


def test_uncertainty_map_and_weighted_loss_match_jax():
    variables = jax_variables(1, width=W, seed=3)
    x = np.random.default_rng(3).random((2, 32, 32, 3)).astype(np.float32)
    module = _jax_module(1)
    want = np.asarray(jax_unc_map(lambda xp: module.apply(variables, xp, False),
                                  jnp.asarray(x), 16, 32))
    model = _port_model(1, variables).eval()
    got = generate_uncertainty_map(model, _nchw(x), 16, 32)
    assert not got.requires_grad
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-4, atol=1e-5)

    pixel = np.random.default_rng(4).random(want.shape).astype(np.float32)
    for amap in (None, want):
        wf, wb = jax_weighted_loss(jnp.asarray(pixel), None if amap is None else jnp.asarray(amap), 2.0)
        gf, gb = apply_uncertainty_weighted_loss(
            _nchw(pixel), None if amap is None else _nchw(amap), 2.0)
        np.testing.assert_allclose(gf.item(), float(wf), rtol=1e-5)  # float32 means
        np.testing.assert_allclose(gb.item(), float(wb), rtol=1e-5)


# ---------------------------------------------------------------- optimizer, transfer
def test_rmsprop_matches_jax_over_three_steps():
    rs = np.random.default_rng(5)
    params = {"a": rs.standard_normal((3, 4)).astype(np.float32),
              "b": rs.standard_normal(5).astype(np.float32)}
    grads = [{k: rs.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_rmsprop(1e-3, weight_decay=WD)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = torch_rmsprop(tp.values(), 1e-3, weight_decay=WD)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tp.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)
    assert get_learning_rate(opt) == 1e-3
    assert get_learning_rate(set_learning_rate(opt, 5e-4)) == 5e-4


def test_transfer_weights_matches_jax_through_all_stages():
    prev = jax_variables(1, width=W, seed=6)
    for stage in (2, 3, 4):
        cur = jax_variables(stage, width=W, seed=6 + stage)
        want_tree, want_copied = jax_transfer(prev, cur)
        got, copied = transfer_weights(state_dict_from_jax(prev), state_dict_from_jax(cur))
        want = state_dict_from_jax(jax.device_get(want_tree))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)
        assert len(copied) >= len(want_copied) > 0  # + the 0-d num_batches_tracked
        STAGE_MODELS[stage](num_classes=1, width=W).load_state_dict(got, strict=True)
        prev = want_tree


# ---------------------------------------------------------------- train and eval steps
def _capture_grads():
    """An optax stage that keeps the raw gradients as its state."""
    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p),
                                        lambda u, s, p=None: (u, u))


def _batch(n=4, size=40, seed=3):
    return disk_dataset(n, size, seed=seed)  # 40 px: both stages resize


def _run_both(stage, fused, accum_steps=1):
    v_prev = jax_variables(1, width=W, seed=1)
    v = v_prev if stage == 1 else jax_variables(2, width=W, seed=2)
    images, masks = _batch()
    tx = optax.chain(_capture_grads(), jax_rmsprop(LR[stage], weight_decay=WD))
    step = jax_train_step(_jax_module(stage), tx, stage, RES[stage],
                          prev_module=_jax_module(1) if stage > 1 else None,
                          prev_resolution=RES[1], donate=False, fused_loss=fused,
                          accum_steps=accum_steps)
    new, jm = step(TrainState.create(v, tx), v_prev if stage > 1 else {},
                   (jnp.asarray(images), jnp.asarray(masks)), jnp.asarray(PW), jax.random.key(0))

    model = _port_model(stage, v)
    prev = _port_model(1, v_prev) if stage > 1 else None
    opt = torch_rmsprop(model.parameters(), LR[stage], weight_decay=WD)
    port_step = make_seg_train_step(model, opt, stage, RES[stage], prev_model=prev,
                                    prev_resolution=RES[1], fused_loss=fused,
                                    accum_steps=accum_steps)
    tm = port_step((images, masks), PW)
    return v, jax.device_get((new, jm)), model, tm


def _assert_step_matches(v, jax_out, model, tm, noise=1e-5, min_kept=0.99):
    new, jm = jax_out
    assert set(tm) == set(METRIC_KEYS) == set(jm)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)

    before = state_dict_from_jax(v)
    after = state_dict_from_jax(new.variables)
    grads = state_dict_from_jax({"params": new.opt_state[0]})
    gmax = max(g.abs().max().item() for g in grads.values() if g.dim())
    state = model.state_dict()
    kept = total = 0
    for name, p in model.named_parameters():
        g = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=1e-4, atol=noise * gmax, err_msg=name)
        seen = np.abs(g + WD * before[name].numpy())  # what RMSprop divides by
        keep = seen >= noise * gmax
        kept, total = kept + keep.sum(), total + keep.size
        np.testing.assert_allclose(p.detach().numpy()[keep], after[name].numpy()[keep],
                                   rtol=0, atol=1e-5, err_msg=name)
    assert kept > min_kept * total  # the sign-noise rule spares few parameters
    for key in after:
        if "running" in key:
            np.testing.assert_allclose(state[key].numpy(), after[key].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_jax(stage, fused):
    _assert_step_matches(*_run_both(stage, fused))


def test_accumulated_train_step_matches_jax():
    # Noise floor 1e-3 x max|g| here: on the second micro-batch of this
    # batch one kink (a ReLU or max-pool branch decided by float32
    # rounding) moves the JAX step's gradients 4.6e-4 x max|g| away from a
    # float64 evaluation of the same step, while the port's stay within
    # 6e-7 (measured).  A wrong accumulation (no average, lost micro-batch)
    # is off by 100% or more.
    _assert_step_matches(*_run_both(2, True, accum_steps=2), noise=1e-3, min_kept=0.9)


def test_eval_step_matches_jax():
    v_prev, v = jax_variables(1, width=W, seed=1), jax_variables(2, width=W, seed=2)
    images, masks = _batch(seed=4)
    step = jax_eval_step(_jax_module(2), 2, RES[2], prev_module=_jax_module(1),
                         prev_resolution=RES[1])
    jm = jax.device_get(step(v, v_prev, (jnp.asarray(images), jnp.asarray(masks)),
                             jnp.asarray(PW)))
    model, prev = _port_model(2, v), _port_model(1, v_prev)
    tm = make_seg_eval_step(model, 2, RES[2], prev_model=prev, prev_resolution=RES[1])(
        (images, masks), PW)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert not model.training  # eval mode: the running stats were read, not updated
    for key, value in state_dict_from_jax(v).items():
        assert torch.equal(model.state_dict()[key], value), key


def test_step_options_outside_the_slice_raise():
    model = STAGE_MODELS[1](num_classes=1, width=W)
    opt = torch_rmsprop(model.parameters(), 1e-4)
    # external_uncertainty (ported since) takes probs_up as unc=, at the stage's size
    model2 = STAGE_MODELS[2](num_classes=1, width=W)
    step2 = make_seg_train_step(model2, torch_rmsprop(model2.parameters(), 1e-4), 2, 16,
                                external_uncertainty=True)
    with pytest.raises(ValueError, match="pass unc"):
        step2(_batch(n=4), PW)
    with pytest.raises(ValueError, match="at 16x16"):
        step2(_batch(n=4), PW, unc=torch.full((4, 1, 8, 8), 0.5))
    step = make_seg_train_step(model, opt, 1, 16, accum_steps=3)
    with pytest.raises(ValueError, match="divisible"):
        step(_batch(n=4), PW)


# ---------------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def loaders():
    images, masks = disk_dataset(num_samples=16, image_size=32, seed=1)
    return (ArrayLoader(images[:12], masks[:12], batch_size=4, shuffle=True),
            ArrayLoader(images[12:], masks[12:], batch_size=4))


def _trainer(**kwargs):
    return UncertaintyGuidedProgressiveTrainer(verbose=False, device="cpu", **kwargs)


def test_trainer_two_stages_fused(tmp_path, loaders):
    train, val = loaders
    tr = _trainer(stage_configs=SMALL_CONFIGS, width=W, fused_loss=True)
    history = tr.train_progressive(train, val, max_stages=2, save_dir=tmp_path,
                                   checkpoint_every=1)
    assert len(history["train_loss"]) == 3 and history["stage_transitions"] == [0, 2]
    assert all(np.isfinite(history[k]).all() for k in ("train_loss", "val_loss", "base_loss"))
    assert history["uncertainty_weights_mean"][-1] > 0.0
    assert history["uncertainty_weights_mean"][0] == 0.0  # stage 1 has no map
    rows = (tmp_path / "training_log.csv").read_text().splitlines()
    assert rows[0].split(",") == ["stage", "epoch", "train_loss", "val_loss", "train_dice",
                                  "val_dice", "train_acc", "val_acc", "base_loss",
                                  "uncertainty_mean", "lr", "epoch_time_s"]
    assert len(rows) == 4
    for stage in (1, 2):
        path = tmp_path / f"ug_pgunet_stage{stage}_best.pth"
        assert (tmp_path / f"ug_pgunet_stage{stage}_last.pth").exists()
        raw = torch.load(path, map_location="cpu", weights_only=True)
        assert raw["stage"] == stage and {"epoch", "optimizer_state_dict", "val_dice",
                                          "train_dice", "uncertainty_alpha", "history"} <= set(raw)
        got_stage, sd = load_checkpoint(path)
        assert got_stage == stage
        STAGE_MODELS[stage](num_classes=1, width=W).load_state_dict(sd, strict=True)
        # the JAX package reads the same file (import_torch_checkpoint's converter,
        # with a width-0.25 template)
        shapes = jax.eval_shape(lambda: _jax_module(stage).init(
            jax.random.key(0), jnp.zeros((1, 32, 32, 3)), False))
        template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
        variables, skipped = convert_torch_state_dict(torch.load(path, weights_only=False),
                                                      template)
        assert skipped == []
        for key, value in state_dict_from_jax(variables).items():
            if not key.endswith("num_batches_tracked"):  # JAX keeps no such counter
                np.testing.assert_array_equal(value.numpy(), sd[key].numpy(), err_msg=key)
    # a trained stage serves as the uncertainty source
    stats = tr.save_uncertainty_analysis(val, 2, tmp_path)
    assert len(stats) == 1 and 0.0 < stats[0]["uncertainty_mean"] <= 1.0
    assert json.loads((tmp_path / "uncertainty_stats_stage2.json").read_text()) == stats
    tr2 = _trainer(stage_configs=SMALL_CONFIGS, width=W)
    tr2.load_stage_weights(2, tmp_path / "ug_pgunet_stage2_best.pth")
    assert np.isfinite(tr2.validate_epoch(val, 2)[0])


def test_trainer_stage1_learns(tmp_path, loaders):
    train, val = loaders
    cfgs = {1: {"resolution": 32, "epochs_per_stage": 3, "lr": 3e-4}}
    tr = _trainer(stage_configs=cfgs, width=W, fused_loss=True)
    h = tr.train_progressive(train, val, max_stages=1, save_dir=tmp_path)
    assert h["train_dice"][-1] > h["train_dice"][0]
    assert h["train_loss"][-1] < h["train_loss"][0]


def test_trainer_checkpoint_serves_and_imports_at_full_width(tmp_path):
    images, masks = disk_dataset(num_samples=4, image_size=32, seed=2)
    cfgs = {1: {"resolution": 16, "epochs_per_stage": 1, "lr": 3e-4}}
    tr = _trainer(stage_configs=cfgs, fused_loss=True)  # width 1.0
    tr.train_progressive(ArrayLoader(images[:2], masks[:2], batch_size=2),
                         ArrayLoader(images[2:], masks[2:], batch_size=2),
                         max_stages=1, save_dir=tmp_path)
    path = str(tmp_path / "ug_pgunet_stage1_best.pth")
    predictor = Predictor(path, buckets=(2,), dtype=torch.float32, device="cpu")
    preds, probs, unc = predictor(images[2:])
    assert probs.shape == (2, 32, 32, 1) and np.isfinite(probs).all()
    with torch.no_grad():
        want = torch.sigmoid(tr.models[1].eval()(_nchw(images[2:])))
    np.testing.assert_allclose(probs, _nhwc(want), atol=1e-4)
    variables, stage = import_torch_checkpoint(path)
    assert stage == 1
    sd = tr.models[1].state_dict()
    for key, value in state_dict_from_jax(variables).items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(value.numpy(), sd[key].numpy(), err_msg=key)


def test_trainer_nan_guard_saves_and_raises(tmp_path):
    images, masks = disk_dataset(num_samples=4, image_size=16, seed=3)
    images[0, 0, 0, 0] = np.nan
    cfgs = {1: {"resolution": 16, "epochs_per_stage": 2, "lr": 3e-4}}
    tr = _trainer(stage_configs=cfgs, width=W)
    with pytest.raises(TrainingDivergedError) as info:
        tr.train_progressive(ArrayLoader(images, masks, batch_size=4),
                             ArrayLoader(images, masks, batch_size=4), max_stages=1,
                             save_dir=tmp_path)
    assert info.value.stage == 1 and info.value.epoch == 1
    raw = torch.load(tmp_path / "ug_pgunet_stage1_diverged.pth", weights_only=True)
    assert "train_loss" in raw["diverged_metrics"]
