"""The uncertainty pipeline over groups of several devices
(``ugpg_tpu_torch/parallel/pipeline.py``: a train mesh and an unc mesh) against
the JAX pipeline on its eight fake CPU devices with ``n_unc=4``, the cases of
``tests/test_pipeline.py``, and against the port's own unsharded fused step.

The port's groups name ``torch.device("cpu", i)``, i < 8, as the JAX package
names its eight host devices: a 4 x 1 train mesh on cpu:0-3 and a 4 x 1 unc
mesh on cpu:4-7, so every conv copies its weights per shard and the producer
keeps one copy of the frozen stage per unc device.  PGUNet1/PGUNet2 at width
0.25 with stages at 16/32 px, the classifier's stages 1-2 at 8/16 px, batches
of 8 (each group's data axis takes 2 rows).  JAX's augmentation keys are
replayed into the parameters the port draws (``tests/test_torch_pipeline.py::
_draws``).  The classification case runs without augmentation and with the
dropout rates at 0, as ``tests/test_torch_pipeline.py`` does: JAX compiles the
Herlev augmentation into both of its programs, and dropout masks cannot match
JAX's bits.  The ``n_model=2`` case lowers the port's column-parallel
threshold to 32 channels (``parallel.mesh._TP_MIN_CHANNELS``), so that width
0.25 has sharded convs.

Tolerances: step-0 metrics rtol 2e-5 (``tests/test_pipeline.py:95-131``);
depth changes nothing (1e-6); the trainers with ``pipeline_unc=4`` against
their plain runs as ``tests/test_pipeline.py:400-495``: stage 1 rtol 1e-6,
stage 2 rtol 1e-3, Dice atol 1e-3, accuracy 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables, port_classifier
from tests.test_torch_models import jax_variables
from tests.test_torch_pipeline import _draws
from tests.test_torch_train import _jax_module, _port_model
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.parallel.pipeline import UncertaintyPipeline as JaxPipeline
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.models import classifier as port_classifier_mod
from ugpg_tpu_torch.parallel import mesh as port_mesh
from ugpg_tpu_torch.parallel.pipeline import UncertaintyPipeline
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
from ugpg_tpu_torch.train.optim import torch_rmsprop
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.train.steps import make_seg_train_step

RES, PREV_RES, BATCH, PW, K_CLS = 32, 16, 8, 5.0, 3
CPU8 = [torch.device("cpu", i) for i in range(8)]
NO_DROPOUT = (0.0, 0.0, 0.0)
SEG_KEYS = ("final_loss", "base_loss", "dice", "accuracy", "uncertainty_weight_mean",
            "uncertainty_weight_std")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seg_batches(n, seed):
    images, masks = disk_dataset(num_samples=BATCH * n, image_size=RES, seed=seed)
    return [(images[i * BATCH:(i + 1) * BATCH], masks[i * BATCH:(i + 1) * BATCH])
            for i in range(n)]


def _port_pipeline(v1, v2, devices=CPU8, n_unc=4, **kw):
    model, prev = _port_model(2, v2), _port_model(1, v1)
    pipe = UncertaintyPipeline(model, prev, torch_rmsprop(model.parameters(), 1e-4,
                                                          weight_decay=1e-4),
                               2, RES, PREV_RES, devices=devices, n_unc=n_unc, **kw)
    pipe.create_state()
    pipe.place_prev()
    return pipe, model


def _assert_metrics(got, want, keys, rtol):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------- against JAX
@pytest.mark.parametrize("augment,accum_steps", [(False, 1), (True, 1), (True, 2)],
                         ids=["plain", "augmented", "accum"])
def test_pipelined_step0_matches_jax_pipeline_on_two_meshes(augment, accum_steps):
    """``test_pipelined_matches_fused_step``, its ``_augmented`` case and
    ``test_pipelined_accum_matches_fused_accum``: step 0 of the port's
    pipeline on a 4 x 1 train mesh and a 4 x 1 unc mesh against JAX's on
    the same split of its eight devices."""
    v1, v2 = jax_variables(1, width=0.25, seed=3), jax_variables(2, width=0.25, seed=4)
    batches = _seg_batches(1, seed=5)
    keys = [jax.random.key(7)]
    jpipe = JaxPipeline(_jax_module(2), _jax_module(1), jax_rmsprop(1e-4, weight_decay=1e-4), 2,
                        RES, PREV_RES, n_unc=4, augment=augment, donate=False,
                        accum_steps=accum_steps)
    _, jm = jpipe.run_epoch(jpipe.create_state(v2), jpipe.place_prev(v1), batches, PW, keys)

    pipe, _ = _port_pipeline(v1, v2, augment=augment, accum_steps=accum_steps)
    assert pipe.train_mesh.shape == dict(jpipe.train_mesh.shape)
    assert pipe.unc_mesh.shape == dict(jpipe.unc_mesh.shape)
    assert not set(pipe.train_mesh.devices.flat) & set(pipe.unc_mesh.devices.flat)
    assert sorted(map(str, pipe._unc)) == [f"cpu:{i}" for i in range(4, 8)]  # a copy each
    tm = pipe.run_epoch(batches, PW, aug=_draws(keys, BATCH, accum_steps) if augment else None)
    assert len(tm) == 1 and float(tm[0]["uncertainty_weight_mean"]) > 0
    _assert_metrics(tm[0], jax.device_get(jm[0]), SEG_KEYS, 2e-5)


def test_cls_pipelined_step0_matches_jax_pipeline_on_two_meshes():
    """``test_cls_pipelined_matches_fused_step`` on the two meshes: the
    per-sample weights from four unc shards, the encoder over four train
    shards, the loss on the gathered logits."""
    res, prev_res = RES // 2, PREV_RES // 2
    v1 = jax_cls_variables(1, K_CLS, seed=1, dropout_rates=NO_DROPOUT)
    v2 = jax_cls_variables(2, K_CLS, seed=2, dropout_rates=NO_DROPOUT)
    rng = np.random.default_rng(11)
    batches = [(rng.random((BATCH, res, res, 3)).astype(np.float32),
                rng.integers(0, K_CLS, BATCH).astype(np.int32))]
    cw = np.array([1.0, 2.0, 0.5], np.float32)
    keys = [jax.random.key(9)]
    common = dict(augment=False, normalize=True, num_classes=K_CLS, n_unc=4,
                  task_type="classification")
    jpipe = JaxPipeline(JaxClassifier(stage=2, num_classes=K_CLS, dropout_rates=NO_DROPOUT),
                        JaxClassifier(stage=1, num_classes=K_CLS, dropout_rates=NO_DROPOUT),
                        jax_rmsprop(1e-4), 2, res, prev_res, donate=False, **common)
    _, jm = jpipe.run_epoch(jpipe.create_state(v2), jpipe.place_prev(v1), batches, cw, keys)

    model = port_classifier(2, v2, K_CLS, dropout_rates=NO_DROPOUT)
    prev = port_classifier(1, v1, K_CLS, dropout_rates=NO_DROPOUT)
    pipe = UncertaintyPipeline(model, prev, torch_rmsprop(model.parameters(), 1e-4), 2, res,
                               prev_res, devices=CPU8, **common)
    tm = pipe.run_epoch(batches, torch.from_numpy(cw))
    want = jax.device_get(jm[0])
    _assert_metrics(tm[0], want, ("final_loss", "base_loss", "uncertainty_weight_mean",
                                  "uncertainty_weight_std"), 2e-5)
    assert int(tm[0]["correct"]) == int(want["correct"]) and int(tm[0]["count"]) == BATCH
    assert float(tm[0]["uncertainty_weight_mean"]) > 1.0  # 1 + alpha A


# ---------------------------------------------------------------- the port alone
def test_pipeline_depth_invariance():
    """``test_pipeline_depth_invariance``: depth 1 and 3 over four batches
    on the two meshes give the same metrics and parameters."""
    v1, v2 = jax_variables(1, width=0.25, seed=5), jax_variables(2, width=0.25, seed=6)
    batches = _seg_batches(4, seed=7)
    runs = []
    for depth in (1, 3):
        pipe, model = _port_pipeline(v1, v2, depth=depth, augment=True, fused_loss=True)
        runs.append((pipe.run_epoch(batches, PW, aug=torch.Generator().manual_seed(0)),
                     model.state_dict()))
    for i in range(4):
        _assert_metrics(runs[1][0][i], runs[0][0][i], SEG_KEYS, 1e-6)
    for k, v in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_run_epoch_rejects_ragged_final_batch():
    """``test_run_epoch_rejects_ragged_final_batch``: a batch of 6 does not
    split over the 4-row data axes; rejected before any step, with JAX's
    message."""
    v1, v2 = jax_variables(1, width=0.25), jax_variables(2, width=0.25)
    pipe, model = _port_pipeline(v1, v2)
    full, = _seg_batches(1, seed=0)
    ragged = (full[0][:6], full[1][:6])  # 6 % 4 != 0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match=r"batch 1 has size 6, which must divide both the "
                                         r"train mesh's data axis \(4\) and the unc group \(4\)"):
        pipe.run_epoch([full, ragged], PW)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    pipe2, _ = _port_pipeline(v1, v2, accum_steps=4)
    with pytest.raises(ValueError, match=r"not divisible into accum_steps=4 micro-batches "
                                         r"per data shard \(4\)"):
        pipe2.run_epoch([full], PW)


def test_model_axis_pipeline_matches_the_unsharded_fused_step(monkeypatch):
    """``n_model=2`` on six devices: a 2 x 2 train mesh with column-parallel
    convs and a 2 x 1 unc mesh; step 0 against the port's unsharded fused
    step (the frozen stage inside) on the same draws."""
    monkeypatch.setattr(port_mesh, "_TP_MIN_CHANNELS", 32)
    v1, v2 = jax_variables(1, width=0.25, seed=8), jax_variables(2, width=0.25, seed=9)
    batches = _seg_batches(1, seed=10)
    pipe, _ = _port_pipeline(v1, v2, devices=CPU8[:6], n_unc=2, n_model=2, augment=True,
                             fused_loss=True)
    assert pipe.train_mesh.shape == {"data": 2, "model": 2}
    assert pipe.unc_mesh.shape == {"data": 2, "model": 1}
    got = pipe.run_epoch(batches, PW, aug=torch.Generator().manual_seed(1))[0]
    model, prev = _port_model(2, v2), _port_model(1, v1)
    step = make_seg_train_step(model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4),
                               2, RES, prev_model=prev, prev_resolution=PREV_RES, augment=True,
                               fused_loss=True)
    want = step(batches[0], PW, torch.Generator().manual_seed(1))
    _assert_metrics(got, want, SEG_KEYS, 2e-5)


# ---------------------------------------------------------------- the trainers
def test_trainer_pipeline_unc_matches_plain_trainer(tmp_path):
    """``tests/test_pipeline.py:400`` with ``pipeline_unc=4`` over eight CPU
    devices (``devices=``), stages at 8/16 px, batches of 8: stage 1 the
    plain path, stage 2 pipelined over the two meshes."""
    cfgs = {1: {"resolution": 8, "epochs_per_stage": 1, "lr": 3e-4},
            2: {"resolution": 16, "epochs_per_stage": 2, "lr": 1e-4}}
    images, masks = disk_dataset(num_samples=16, image_size=16, seed=5)
    train = ArrayLoader(images[:8], masks[:8], batch_size=8)
    val = ArrayLoader(images[8:], masks[8:], batch_size=8)
    hist = []
    for n in (0, 4):
        tr = UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, verbose=False, width=0.25,
                                                 augment=True, fused_loss=True, pipeline_unc=n,
                                                 device="cpu", devices=CPU8 if n else None)
        hist.append(tr.train_progressive(train, val, max_stages=2, save_dir=tmp_path / str(n)))
        if n:
            pipe = tr._pipelines[2]
            assert pipe.train_mesh.shape["data"] == pipe.unc_mesh.shape["data"] == 4
    h0, h1 = hist
    np.testing.assert_allclose(h1["train_loss"][:1], h0["train_loss"][:1], rtol=1e-6)
    np.testing.assert_allclose(h1["train_loss"][1:], h0["train_loss"][1:], rtol=1e-3)
    np.testing.assert_allclose(h1["val_dice"], h0["val_dice"], atol=1e-3)
    assert (tmp_path / "4" / "ug_pgunet_stage2_best.pth").exists()


def test_herlev_trainer_pipeline_unc_matches_plain_trainer(tmp_path):
    """``tests/test_pipeline.py:452`` with ``pipeline_unc=4`` over eight CPU
    devices, stages at 8/16 px, batches of 8, augmentation off (as
    ``tests/test_torch_pipeline.py``'s case)."""
    rng = np.random.default_rng(3)
    labels = rng.integers(0, K_CLS, size=24).astype(np.int64)
    loaders = {}
    for stage, px in ((1, 8), (2, 16)):
        imgs = rng.random((24, px, px, 3)).astype(np.float32) * 0.3
        for i, lab in enumerate(labels):
            imgs[i, :, :, lab % 3] += 0.6
        loaders[stage] = (ArrayLoader(imgs[:16], labels[:16], batch_size=8),
                          ArrayLoader(imgs[16:], labels[16:], batch_size=8))
    hist = []
    for n in (0, 4):
        cfg = create_config()
        cfg.update(num_classes=K_CLS, epochs_per_stage=2, stages=[1, 2], verbose=False,
                   augment=False, pipeline_unc=n)
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 1, 8)
            mp.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 2, 16)
            tr = HerlevTrainer(cfg, device="cpu", devices=CPU8 if n else None)
            hist.append(tr.train_progressive({s: v[0] for s, v in loaders.items()},
                                             {s: v[1] for s, v in loaders.items()},
                                             str(tmp_path / str(n))))
    h0, h1 = hist
    np.testing.assert_allclose(h1["train_loss"][:2], h0["train_loss"][:2], rtol=1e-6)
    np.testing.assert_allclose(h1["train_loss"][2:], h0["train_loss"][2:], rtol=1e-3)
    np.testing.assert_allclose(h1["val_acc"], h0["val_acc"], atol=1e-6)
    assert 1.0 <= h1["uncertainty_weights_mean"][-1] <= 2.0 + 1e-6
    assert (tmp_path / "4" / "herlev_stage2_best.pth").exists()
