"""The port's augmented train step, AugMoNuSegTrainer and the device
prefetch queue, against the JAX package on the CPU (width 0.25).

Tolerances: train-step metrics rtol 1e-5 and gradients under the rule of
``tests/test_torch_train.py`` with a noise floor of 1e-4 x max|g| (the
augmentation's parameters are JAX's, replayed from its key; see the
test); the trainer's history rtol 1e-4 (one epoch of
stages 1-2 from the same weights and batches, at lr 1e-6: see the test).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from tests.test_data_monuseg import make_xml, write_monuseg_tree
from tests.test_torch_augment import _jax_params
from tests.test_torch_models import jax_variables
from tests.test_torch_train import (
    LR,
    PW,
    RES,
    WD,
    _assert_step_matches,
    _batch,
    _capture_grads,
    _jax_module,
    _port_model,
)
from ugpg_tpu.train.aug_trainer import AugMoNuSegTrainer as JaxAugMoNuSegTrainer
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu.train.steps import TrainState
from ugpg_tpu.train.steps import make_seg_train_step as jax_train_step
from ugpg_tpu_torch.data.loader import DataLoader, prefetch_to_device
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.train.aug_trainer import AugMoNuSegTrainer
from ugpg_tpu_torch.train.optim import torch_rmsprop
from ugpg_tpu_torch.train.steps import make_seg_train_step

W = 0.25


# ---------------------------------------------------------------- the augmented step
@pytest.mark.parametrize("stage,fused,quantize,noise", [(1, False, 0, 1e-4), (2, True, 0, 1e-4),
                                                        (2, True, 8, 1e-3)])
def test_augmented_train_step_matches_jax(stage, fused, quantize, noise):
    v_prev = jax_variables(1, width=W, seed=1)
    v = v_prev if stage == 1 else jax_variables(2, width=W, seed=2)
    images, masks = _batch()
    key = jax.random.key(11)
    tx = optax.chain(_capture_grads(), jax_rmsprop(LR[stage], weight_decay=WD))
    step = jax_train_step(_jax_module(stage), tx, stage, RES[stage],
                          prev_module=_jax_module(1) if stage > 1 else None,
                          prev_resolution=RES[1], donate=False, fused_loss=fused,
                          augment=True, aug_quantize=quantize)
    new, jm = step(TrainState.create(v, tx), v_prev if stage > 1 else {},
                   (jnp.asarray(images), jnp.asarray(masks)), jnp.asarray(PW), key)

    model = _port_model(stage, v)
    prev = _port_model(1, v_prev) if stage > 1 else None
    opt = torch_rmsprop(model.parameters(), LR[stage], weight_decay=WD)
    port_step = make_seg_train_step(model, opt, stage, RES[stage], prev_model=prev,
                                    prev_resolution=RES[1], fused_loss=fused, augment=True,
                                    aug_quantize=quantize)
    tm = port_step((images, masks), PW, _jax_params(key, quantize))
    # noise floor 1e-4 x max|g|: the two packages' augmented inputs differ
    # by up to 1.15e-6 (float32 cos/sin, bilinear taps, the HSV round trip;
    # measured), and through both stages that moved 43 of 147,456 stage-2
    # gradients by up to 2.1e-5 x max|g| (measured).  With 8 grid angles
    # the inputs differ by 3e-7 and the masks not at all, yet 5 of 36,864
    # inc-conv gradients moved 1.6e-4 x max|g|: a ReLU or max-pool branch
    # decided by float32 rounding, as in the accumulated step of
    # tests/test_torch_train.py, which takes 1e-3 for it.  A wrong
    # augmentation (another angle, flip or mask tap) moves them by percents.
    _assert_step_matches(v, jax.device_get((new, jm)), model, tm, noise=noise,
                         min_kept=0.95 if noise < 1e-3 else 0.9)


def test_augmented_step_needs_parameters_and_draws_from_a_generator():
    model = _port_model(1, jax_variables(1, width=W, seed=1))
    opt = torch_rmsprop(model.parameters(), 1e-4)
    step = make_seg_train_step(model, opt, 1, 16, augment=True, accum_steps=2)
    with pytest.raises(ValueError, match="aug"):
        step(_batch(), PW)
    m = step(_batch(), PW, torch.Generator().manual_seed(0))
    assert all(np.isfinite(v.item()) for v in m.values())


# ---------------------------------------------------------------- the trainer
@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """train/aug: 6 PNG patches, val: 2 TIFFs, all 32 px (the stage size, so
    that no host resize stands between the two packages' images)."""
    root = write_monuseg_tree(tmp_path_factory.mktemp("M"), n_train=2, n_val=2, size=32)
    rng = np.random.default_rng(0)
    (root / "train" / "aug" / "images").mkdir(parents=True)
    (root / "train" / "aug" / "annots").mkdir(parents=True)
    for i in range(6):
        img = (rng.random((32, 32, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "train" / "aug" / "images" / f"p{i}.png")
        c = rng.uniform(8, 24, 2)
        poly = [(c[0] + 7 * np.cos(t), c[1] + 6 * np.sin(t)) for t in np.linspace(0, 6, 9)]
        (root / "train" / "aug" / "annots" / f"p{i}.xml").write_text(make_xml([poly]))
    return root


CONFIGS = {1: {"resolution": 32, "epochs_per_stage": 1, "lr": 3e-4},
           2: {"resolution": 32, "epochs_per_stage": 1, "lr": 1e-4}}


def test_aug_trainer_history_matches_jax(tree, tmp_path):
    # lr 1e-6: RMSprop's first step moves every parameter by about 10 lr,
    # whatever its gradient, so a gradient that is float32 noise in both
    # packages (the conv bias before a BN: truly 0) takes a full step of a
    # random sign; at the stage lr (3e-4) that put stage 2's train loss
    # 0.6% apart after three steps (measured), at 1e-6 it stays below 1e-5
    cfgs = {s: {**c, "lr": 1e-6} for s, c in CONFIGS.items()}
    jt = JaxAugMoNuSegTrainer(stage_configs=cfgs, width=W, verbose=False, augment=False,
                              fused_loss=True)
    pt = AugMoNuSegTrainer(stage_configs=cfgs, width=W, verbose=False, augment=False,
                           fused_loss=True, device="cpu")
    for t in (jt, pt):
        t.setup_datasets(str(tree), stages=(1, 2))
    assert pt.pos_weight == pytest.approx(float(jt.pos_weight), rel=1e-6)
    for stage in (1, 2):  # the same initial weights
        pt._model(stage).load_state_dict(state_dict_from_jax(jt._ensure_variables(stage)))
    want = jt.train_progressive(*jt.make_loaders(batch_size=2, num_workers=2),
                                save_dir=str(tmp_path / "jax"), stages=(1, 2))
    got = pt.train_progressive(*pt.make_loaders(batch_size=2, num_workers=2),
                               save_dir=str(tmp_path / "port"), stages=(1, 2))
    assert got["stage_transitions"] == want["stage_transitions"] == [0, 1]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert (tmp_path / "port" / "ug_pgunet_stage2_best.pth").exists()
    assert pt.loader_stats["batches"] == 2 * (3 + 1)  # 3 train and 1 val batch per epoch


def test_aug_trainer_trains_augmented_and_quantized(tree, tmp_path):
    for quantize in (0, 4):
        tr = AugMoNuSegTrainer(stage_configs={2: CONFIGS[2], 1: CONFIGS[1]}, width=W,
                               verbose=False, fused_loss=True, device="cpu",
                               aug_quantize=quantize, in_channels=3)
        assert tr.augment
        tr.setup_datasets(str(tree), stages=(1, 2))
        h = tr.train_progressive(*tr.make_loaders(batch_size=3, num_workers=2),
                                 save_dir=str(tmp_path / str(quantize)), stages=(1, 2))
        assert np.isfinite(h["train_loss"]).all() and h["uncertainty_weights_mean"][1] > 0


def test_in_channels_builds_wider_inputs():
    tr = AugMoNuSegTrainer(width=W, verbose=False, device="cpu", in_channels=4)
    assert tr._model(1).inc.conv.conv_op[0].in_channels == 4


# ---------------------------------------------------------------- prefetch
def test_prefetch_passes_batches_in_order_and_reraises():
    batches = [(np.full((2, 3), i, np.float32),) for i in range(5)]
    stats = {}
    got = list(prefetch_to_device(iter(batches), size=2, device="cpu", stats=stats))
    assert [int(b[0][0, 0]) for b in got] == list(range(5)) and stats["batches"] == 5

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    it = prefetch_to_device(broken(), device="cpu")
    assert int(next(it)[0][0, 0]) == 0
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_loader_drop_last_and_len():
    ds = [(np.zeros(2, np.float32), np.float32(i)) for i in range(5)]
    assert len(DataLoader(ds, batch_size=2)) == 3
    assert len(DataLoader(ds, batch_size=2, drop_last=True)) == 2
    got = list(DataLoader(ds, batch_size=2, drop_last=True, num_workers=1))
    assert [b[1].tolist() for b in got] == [[0.0, 1.0], [2.0, 3.0]]
