"""The port's uncertainty pipeline (``ugpg_tpu_torch/parallel/pipeline.py``) and
the external-uncertainty steps, against ``ugpg_tpu.parallel.pipeline`` on the CPU;
cases after ``tests/test_pipeline.py``.

Sizes: PGUNet1/PGUNet2 at width 0.25 with stages at 16/32 px (the trainers at
8/16 px), the classifier's stages 1-2 at 8/16 px, batches of 4.  JAX's pipeline runs on two of its CPU
devices (``devices=jax.devices()[:2], n_unc=1``); the port's on the CPU named
twice.  Weights cross with ``state_dict_from_jax``.  JAX's augmentation keys are
replayed into the parameters the port draws (``tests/test_torch_augment.py``):
per batch the step's key, or with ``accum_steps=2`` ``split(key, 2)``, one per
micro-batch.  The classification case runs without augmentation (its
producer's augmentation is held to the step's on the same draws); the
classifier's dropout rates are 0: the masks cannot match JAX's bits.

Tolerances: step-0 metrics rtol 2e-5 (``tests/test_pipeline.py:95-131``; float32
on both sides, sums in other orders); depth changes nothing (1e-6, measured
equal); the pipelined step against the port's own fused step on the same draws
1e-6 (the same ops on the same inputs); the trainers with ``pipeline_unc=1``
against their plain runs as ``tests/test_pipeline.py:400-495``: stage 1 rtol
1e-6, stage 2 rtol 1e-3, validation 1e-3 (Dice) and 1e-6 (accuracy).
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables, port_classifier
from tests.test_torch_models import jax_variables
from tests.test_torch_scan_epoch import UPDATE_RTOL, update_gaps
from tests.test_torch_train import _jax_module, _port_model
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.parallel.pipeline import UncertaintyPipeline as JaxPipeline
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu_torch.data.augment import sample_herlev_params
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models import classifier as port_classifier_mod
from ugpg_tpu_torch.parallel.pipeline import (
    UncertaintyPipeline,
    pipeline_devices,
    split_devices,
)
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
from ugpg_tpu_torch.train.optim import torch_rmsprop
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.train.steps import make_cls_train_step, make_seg_train_step

RES, PREV_RES, BATCH, PW, K_CLS = 32, 16, 4, 5.0, 3
CPU2 = [torch.device("cpu")] * 2
NO_DROPOUT = (0.0, 0.0, 0.0)
SEG_KEYS = ("final_loss", "base_loss", "dice", "accuracy", "uncertainty_weight_mean",
            "uncertainty_weight_std")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's tests: the suite runs six test
    processes at once, where torch's default of a thread per core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _monuseg_params(key, b):
    """The parameters ``augment_monuseg_batch(key, ...)`` draws for ``b`` images."""
    k1, k2, k3 = jax.random.split(key, 3)
    kh, kv = jax.random.split(k1)
    p = {"do_h": jax.random.bernoulli(kh, 0.5, (b,)), "do_v": jax.random.bernoulli(kv, 0.5, (b,)),
         "angle": jax.random.uniform(k2, (b,), minval=-90.0, maxval=90.0)}
    kb, kc, ks, khue, kp = jax.random.split(k3, 5)
    for name, k in (("brightness", kb), ("contrast", kc), ("saturation", ks)):
        p[name] = 1.0 + jax.random.uniform(k, (b, 1, 1, 1), minval=-0.2, maxval=0.2)
    p["hue"] = jax.random.uniform(khue, (b, 1, 1), minval=-0.05, maxval=0.05)
    p["apply"] = jax.random.bernoulli(kp, 0.8, (b,))
    return {k: torch.from_numpy(np.array(v).reshape(b)) for k, v in p.items()}


def _draws(keys, b, accum):
    """The port's drawn parameters of each batch from JAX's per-batch keys."""
    out = []
    for key in keys:
        micro = jax.random.split(key, accum) if accum > 1 else [key]
        parts = [_monuseg_params(k, b // accum) for k in micro]
        out.append({n: torch.cat([p[n] for p in parts]) for n in parts[0]})
    return out


def _seg_batches(n, seed):
    images, masks = disk_dataset(num_samples=BATCH * n, image_size=RES, seed=seed)
    return [(images[i * BATCH:(i + 1) * BATCH], masks[i * BATCH:(i + 1) * BATCH])
            for i in range(n)]


def _seg_models(seed):
    v1, v2 = jax_variables(1, width=0.25, seed=seed), jax_variables(2, width=0.25, seed=seed + 1)
    return v1, v2


def _port_seg_pipeline(v1, v2, augment, **kw):
    model, prev = _port_model(2, v2), _port_model(1, v1)
    pipe = UncertaintyPipeline(model, prev, torch_rmsprop(model.parameters(), 1e-4,
                                                          weight_decay=1e-4),
                               2, RES, PREV_RES, devices=CPU2, augment=augment, **kw)
    pipe.create_state()
    pipe.place_prev()
    return pipe, model


def _assert_metrics(got, want, keys, rtol):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------- against JAX
@pytest.mark.parametrize("augment,accum_steps", [(False, 1), (True, 2)])
def test_pipelined_step0_matches_jax_pipeline(augment, accum_steps):
    v1, v2 = _seg_models(seed=3)
    batches = _seg_batches(1, seed=4)
    keys = [jax.random.key(7)]
    jpipe = JaxPipeline(_jax_module(2), _jax_module(1), jax_rmsprop(1e-4, weight_decay=1e-4), 2,
                        RES, PREV_RES, n_unc=1, devices=jax.devices()[:2], augment=augment,
                        donate=False, accum_steps=accum_steps)
    _, jm = jpipe.run_epoch(jpipe.create_state(v2), jpipe.place_prev(v1), batches, PW, keys)

    pipe, _ = _port_seg_pipeline(v1, v2, augment, accum_steps=accum_steps)
    aug = _draws(keys, BATCH, accum_steps) if augment else None
    tm = pipe.run_epoch(batches, PW, aug=aug)
    assert len(tm) == 1 and float(tm[0]["uncertainty_weight_mean"]) > 0
    _assert_metrics(tm[0], jax.device_get(jm[0]), SEG_KEYS, 2e-5)


def test_cls_pipelined_step0_matches_jax_pipeline():
    res, prev_res = RES // 2, PREV_RES // 2
    v1 = jax_cls_variables(1, K_CLS, seed=1, dropout_rates=NO_DROPOUT)
    v2 = jax_cls_variables(2, K_CLS, seed=2, dropout_rates=NO_DROPOUT)
    rng = np.random.default_rng(11)
    batches = [(rng.random((BATCH, res, res, 3)).astype(np.float32),
                rng.integers(0, K_CLS, BATCH).astype(np.int32))]
    cw = np.array([1.0, 2.0, 0.5], np.float32)
    keys = [jax.random.key(9)]
    # augmentation off: JAX compiles the Herlev augmentation into both programs
    # (12 s more on one CPU); the producer's augmentation is held to the step's
    # below and the augmentation itself to JAX's in tests/test_torch_cls_steps.py
    common = dict(augment=False, normalize=True, num_classes=K_CLS, n_unc=1,
                  task_type="classification")
    jpipe = JaxPipeline(JaxClassifier(stage=2, num_classes=K_CLS, dropout_rates=NO_DROPOUT),
                        JaxClassifier(stage=1, num_classes=K_CLS, dropout_rates=NO_DROPOUT),
                        jax_rmsprop(1e-4), 2, res, prev_res, devices=jax.devices()[:2],
                        donate=False, **common)
    _, jm = jpipe.run_epoch(jpipe.create_state(v2), jpipe.place_prev(v1), batches, cw, keys)

    model = port_classifier(2, v2, K_CLS, dropout_rates=NO_DROPOUT)
    prev = port_classifier(1, v1, K_CLS, dropout_rates=NO_DROPOUT)
    pipe = UncertaintyPipeline(model, prev, torch_rmsprop(model.parameters(), 1e-4), 2, res,
                               prev_res, devices=CPU2, **common)
    tm = pipe.run_epoch(batches, torch.from_numpy(cw))
    want = jax.device_get(jm[0])
    _assert_metrics(tm[0], want, ("final_loss", "base_loss", "uncertainty_weight_mean",
                                  "uncertainty_weight_std"), 2e-5)
    assert int(tm[0]["correct"]) == int(want["correct"]) and int(tm[0]["count"]) == BATCH
    assert float(tm[0]["uncertainty_weight_mean"]) > 1.0  # 1 + alpha A


# ---------------------------------------------------------------- the port alone
@pytest.mark.parametrize("fused_loss,accum_steps", [(True, 1), (False, 2)])
def test_pipelined_epoch_equals_the_fused_steps_and_depth_changes_nothing(fused_loss,
                                                                          accum_steps):
    """Three augmented batches: the pipeline at depth 1 and 3, and the
    fused step with the frozen stage inside on the same draws."""
    v1, v2 = _seg_models(seed=5)
    batches = _seg_batches(3, seed=6)
    runs = {}
    for depth in (1, 3):
        pipe, model = _port_seg_pipeline(v1, v2, True, fused_loss=fused_loss, depth=depth,
                                         accum_steps=accum_steps)
        ms = pipe.run_epoch(batches, PW, aug=torch.Generator().manual_seed(0))
        runs[depth] = (ms, model.state_dict())
    model, prev = _port_model(2, v2), _port_model(1, v1)
    step = make_seg_train_step(model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4),
                               2, RES, prev_model=prev, prev_resolution=PREV_RES, augment=True,
                               fused_loss=fused_loss, accum_steps=accum_steps)
    aug = torch.Generator().manual_seed(0)  # the same stream: the plain steps draw in order
    fused = [step(b, PW, aug) for b in batches]
    for i in range(3):
        _assert_metrics(runs[3][0][i], runs[1][0][i], SEG_KEYS, 1e-6)
        _assert_metrics(runs[1][0][i], fused[i], SEG_KEYS, 1e-6)
    for k, v in runs[1][1].items():
        np.testing.assert_allclose(runs[3][1][k].numpy(), v.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_cls_external_step_with_drawn_params_equals_the_plain_step():
    """The classification step's drawn parameters (``aug=``) and
    external weights (``unc=``) reproduce the plain step's own draws and
    frozen forward, dropout on (its masks from the generator alone)."""
    v1, v2 = jax_cls_variables(1, K_CLS, seed=3), jax_cls_variables(2, K_CLS, seed=4)
    rng = np.random.default_rng(12)
    batch = (rng.random((BATCH, RES, RES, 3)).astype(np.float32), rng.integers(0, K_CLS, BATCH))
    out = []
    for piped in (False, True):
        model, prev = port_classifier(2, v2, K_CLS), port_classifier(1, v1, K_CLS)
        opt = torch_rmsprop(model.parameters(), 1e-4)
        g = torch.Generator().manual_seed(5)
        if piped:
            pipe = UncertaintyPipeline(model, prev, opt, 2, RES, PREV_RES, devices=CPU2,
                                       task_type="classification", num_classes=K_CLS,
                                       augment=True, normalize=True, accum_steps=2)
            out.append(pipe.run_epoch([batch], None, aug=g, generator=g)[0])
        else:
            # the plain step draws aug then dropout per micro-batch; give it the
            # pipeline's order: both micro-batches' parameters first
            step = make_cls_train_step(model, opt, 2, RES, K_CLS, prev_model=prev,
                                       prev_resolution=PREV_RES, augment=True, normalize=True,
                                       accum_steps=2)
            parts = [sample_herlev_params(g, 2, RES, RES) for _ in range(2)]
            aug = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
            out.append(step(batch, None, g, aug=aug))
    _assert_metrics(out[1], out[0], ("final_loss", "base_loss", "uncertainty_weight_mean"), 1e-6)


def test_split_devices_and_validation():
    cpu = torch.device("cpu")
    train, unc = split_devices(2, [cpu, torch.device("meta"), cpu, cpu])
    assert len(train) == 2 and len(unc) == 2
    for n_unc, devices in ((4, [cpu] * 4), (0, [cpu] * 4), (1, [cpu])):
        with pytest.raises(ValueError, match="must leave at least one train device"):
            split_devices(n_unc, devices)
    train, unc = pipeline_devices(1, CPU2)  # one device named twice: a 1 x 1 mesh each
    assert (train.shape, unc.shape) == ({"data": 1, "model": 1},) * 2
    assert train.first == unc.first == cpu
    # groups of several devices (distinct or not) and a model axis build meshes, as JAX's
    train, unc = pipeline_devices(2, [cpu, torch.device("meta"), cpu, cpu, cpu], n_model=2)
    assert train.shape == {"data": 1, "model": 2} and unc.shape == {"data": 2, "model": 1}
    assert list(train.devices.flat) == [cpu, torch.device("meta")]
    with pytest.raises(ValueError, match="cannot host a model-axis of 2"):
        pipeline_devices(1, CPU2, n_model=2)
    model, prev = _port_model(2, jax_variables(2, 0.25)), _port_model(1, jax_variables(1, 0.25))
    opt = torch_rmsprop(model.parameters(), 1e-4)
    with pytest.raises(ValueError, match="stages > 1"):
        UncertaintyPipeline(model, prev, opt, 1, RES, PREV_RES, devices=CPU2)
    with pytest.raises(ValueError, match="depth"):
        UncertaintyPipeline(model, prev, opt, 2, RES, PREV_RES, devices=CPU2, depth=0)
    with pytest.raises(ValueError, match="aug_quantize"):
        UncertaintyPipeline(model, prev, opt, 2, RES, PREV_RES, devices=CPU2,
                            task_type="classification", aug_quantize=8)
    pipe = UncertaintyPipeline(model, prev, opt, 2, RES, PREV_RES, devices=CPU2, accum_steps=2)
    assert pipe.run_epoch([], PW) == []  # an empty epoch is a no-op
    full, = _seg_batches(1, seed=0)
    ragged = (full[0][:3], full[1][:3])  # 3 % 2 != 0
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="batch 1 has size 3"):
        pipe.run_epoch([full, ragged], PW)
    for k, v in model.state_dict().items():  # rejected before any step
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------- the trainers
def test_trainer_pipeline_unc_matches_plain_trainer(tmp_path):
    """``pipeline_unc=1`` on the CPU (the CPU twice), stages at 8/16 px:
    stage 1 the plain path,
    stage 2 pipelined with the same augmentation draws, tracking the plain
    trainer (``tests/test_pipeline.py:400``)."""
    cfgs = {1: {"resolution": 8, "epochs_per_stage": 1, "lr": 3e-4},
            2: {"resolution": 16, "epochs_per_stage": 2, "lr": 1e-4}}
    images, masks = disk_dataset(num_samples=12, image_size=16, seed=5)
    train = ArrayLoader(images[:8], masks[:8], batch_size=4)
    val = ArrayLoader(images[8:], masks[8:], batch_size=4)
    hist = []
    for n in (0, 1):
        tr = UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, verbose=False, width=0.25,
                                                 augment=True, fused_loss=True, pipeline_unc=n,
                                                 device="cpu")
        hist.append(tr.train_progressive(train, val, max_stages=2, save_dir=tmp_path / str(n)))
        assert list(tr._pipelines) == ([2] if n else [])
    h0, h1 = hist
    np.testing.assert_allclose(h1["train_loss"][:1], h0["train_loss"][:1], rtol=1e-6)
    np.testing.assert_allclose(h1["train_loss"][1:], h0["train_loss"][1:], rtol=1e-3)
    np.testing.assert_allclose(h1["val_dice"], h0["val_dice"], atol=1e-3)
    assert (tmp_path / "1" / "ug_pgunet_stage2_best.pth").exists()


def test_herlev_trainer_pipeline_unc_matches_plain_trainer(tmp_path):
    """``tests/test_pipeline.py:452`` at 8/16 px, with augmentation off: the plain
    trainer draws each micro-batch's augmentation and dropout from one
    generator in turn, the pipelined epoch the augmentation first, so with
    augmentation on the two runs augment differently by design."""
    rng = np.random.default_rng(3)
    labels = rng.integers(0, K_CLS, size=12).astype(np.int64)
    loaders = {}
    for stage, px in ((1, 8), (2, 16)):
        imgs = rng.random((12, px, px, 3)).astype(np.float32) * 0.3
        for i, lab in enumerate(labels):
            imgs[i, :, :, lab % 3] += 0.6
        loaders[stage] = (ArrayLoader(imgs[:8], labels[:8], batch_size=4),
                          ArrayLoader(imgs[8:], labels[8:], batch_size=4))
    hist = []
    for n in (0, 1):
        cfg = create_config()
        cfg.update(num_classes=K_CLS, epochs_per_stage=2, stages=[1, 2], verbose=False,
                   augment=False, pipeline_unc=n)
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 1, 8)
            mp.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 2, 16)
            tr = HerlevTrainer(cfg, device="cpu")
            hist.append(tr.train_progressive({s: v[0] for s, v in loaders.items()},
                                             {s: v[1] for s, v in loaders.items()},
                                             str(tmp_path / str(n))))
    h0, h1 = hist
    np.testing.assert_allclose(h1["train_loss"][:2], h0["train_loss"][:2], rtol=1e-6)
    np.testing.assert_allclose(h1["train_loss"][2:], h0["train_loss"][2:], rtol=1e-3)
    np.testing.assert_allclose(h1["val_acc"], h0["val_acc"], atol=1e-6)
    assert 1.0 <= h1["uncertainty_weights_mean"][-1] <= 2.0 + 1e-6
    assert (tmp_path / "1" / "herlev_stage2_best.pth").exists()


# ---------------------------------------------------------------- run_epoch_scan
def test_pipelined_scan_matches_jax_pipelined_scan():
    """``run_epoch_scan`` (``tests/test_pipeline.py:212``) against JAX's on two
    of its CPU devices: three batches in one chunk and in chunks of two
    (double-buffered), at a learning rate of 1e-8, so that RMSprop's sign
    noise does not part the trajectories (``tests/test_torch_scan_epoch.py``):
    each chunk's mean metrics rtol 2e-5, the parameters after the epoch
    rtol 1e-4 plus 1e-5 x the tensor's largest magnitude."""
    v1, v2 = _seg_models(seed=9)
    batches = _seg_batches(3, seed=10)
    keys = jax.random.split(jax.random.key(13), 3)
    per = batches[0][0].nbytes + batches[0][1].nbytes
    for chunk, sizes in ((None, [3]), (2 * per, [2])):
        jpipe = JaxPipeline(_jax_module(2), _jax_module(1), jax_rmsprop(1e-8, weight_decay=1e-4),
                            2, RES, PREV_RES, n_unc=1, devices=jax.devices()[:2],
                            augment=True, donate=False)
        state, jparts, jtail = jpipe.run_epoch_scan(
            jpipe.create_state(v2), jpipe.place_prev(v1), batches, PW, keys, chunk_bytes=chunk)
        model, prev = _port_model(2, v2), _port_model(1, v1)
        pipe = UncertaintyPipeline(model, prev, torch_rmsprop(model.parameters(), 1e-8,
                                                              weight_decay=1e-4),
                                   2, RES, PREV_RES, devices=CPU2, augment=True)
        parts, tail = pipe.run_epoch_scan(batches, PW, aug=_draws(keys, BATCH, 1),
                                          chunk_bytes=chunk)
        assert [len(p) for p in parts] == [n for _, n in jparts] == sizes
        assert len(tail) == len(jtail) == 3 - sum(sizes)
        for rows, (jm, _) in zip(parts, jax.device_get(jparts)):
            _assert_metrics(dict(zip(SEG_KEYS, rows.mean(0))), jm, SEG_KEYS, 2e-5)
        after = state_dict_from_jax(jax.device_get(state.variables))
        for name, p in model.named_parameters():
            want = after[name].numpy()
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-4,
                                       atol=1e-5 * float(np.abs(want).max()), err_msg=name)


def test_pipelined_scan_update_matches_jax_at_the_real_learning_rate():
    """The update that the comparison at lr 1e-8 cannot see: one chunk of
    two augmented steps at stage 2's learning rate (1e-4) through both
    pipelines, each parameter's change against JAX's to ``UPDATE_RTOL``
    (``tests/test_torch_scan_epoch.py``); a skipped update and an epoch of
    the first batch only must fail that check."""
    v1, v2 = _seg_models(seed=9)
    batches = _seg_batches(2, seed=10)
    keys = jax.random.split(jax.random.key(13), 2)
    jpipe = JaxPipeline(_jax_module(2), _jax_module(1), jax_rmsprop(1e-4, weight_decay=1e-4),
                        2, RES, PREV_RES, n_unc=1, devices=jax.devices()[:2],
                        augment=True, donate=False)
    state, _, _ = jpipe.run_epoch_scan(jpipe.create_state(v2), jpipe.place_prev(v1), batches,
                                       PW, keys, chunk_bytes=None)

    def run(epoch):
        pipe, model = _port_seg_pipeline(v1, v2, True)
        pipe.run_epoch_scan(epoch, PW, aug=_draws(keys, BATCH, 1)[:len(epoch)])
        return model

    before = state_dict_from_jax(v2)
    gaps = update_gaps(run(batches), before, state.variables)
    assert max(gaps.values()) <= UPDATE_RTOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    for fault in (_port_model(2, v2), run(batches[:1])):
        assert max(update_gaps(fault, before, state.variables).values()) > UPDATE_RTOL


@pytest.mark.parametrize("task", ["segmentation", "classification"])
def test_pipelined_scan_equals_run_epoch_in_chunks_with_a_tail(task):
    """The chunked epoch (two chunks of two, the producer a chunk ahead,
    then a full and a ragged batch per step) is ``run_epoch``'s, bit for
    bit: the same steps on the same draws, in order."""
    if task == "segmentation":
        v1, v2 = _seg_models(seed=5)
        images, masks = disk_dataset(num_samples=BATCH * 5 + 2, image_size=RES, seed=6)
        batches = [(images[i:i + BATCH], masks[i:i + BATCH]) for i in range(0, 5 * BATCH, BATCH)]
        batches.append((images[-2:], masks[-2:]))

        def build():
            return _port_seg_pipeline(v1, v2, True, fused_loss=True)

        weights, keys = PW, SEG_KEYS
    else:
        v1, v2 = jax_cls_variables(1, K_CLS, seed=3), jax_cls_variables(2, K_CLS, seed=4)
        rng = np.random.default_rng(12)
        batches = [(rng.random((n, 16, 16, 3)).astype(np.float32),
                    rng.integers(0, K_CLS, n).astype(np.int64)) for n in (4, 4, 4, 4, 4, 2)]

        def build():
            model, prev = port_classifier(2, v2, K_CLS), port_classifier(1, v1, K_CLS)
            pipe = UncertaintyPipeline(model, prev, torch_rmsprop(model.parameters(), 1e-4), 2,
                                       16, 8, devices=CPU2, task_type="classification",
                                       num_classes=K_CLS, augment=True, normalize=True)
            pipe.create_state()
            pipe.place_prev()
            return pipe, model

        weights = torch.tensor([1.0, 2.0, 0.5])
        keys = ("final_loss", "base_loss", "correct", "count", "uncertainty_weight_mean",
                "uncertainty_weight_std")
    per = batches[0][0].nbytes + batches[0][1].nbytes
    (pipe, model), (pipe_s, model_s) = build(), build()
    want = pipe.run_epoch(batches, weights, aug=torch.Generator().manual_seed(0),
                          generator=torch.Generator().manual_seed(1))
    parts, tail = pipe_s.run_epoch_scan(batches, weights, aug=torch.Generator().manual_seed(0),
                                        generator=torch.Generator().manual_seed(1),
                                        chunk_bytes=2 * per)
    assert [len(p) for p in parts] == [2, 2] and len(tail) == 2
    got = [dict(zip(keys, r)) for p in parts for r in p] + tail
    for g, w in zip(got, want):
        for k in keys:
            assert float(g[k]) == float(w[k]), k
    for (name, a), b in zip(model.state_dict().items(), model_s.state_dict().values()):
        assert torch.equal(a, b), name


def test_trainers_pipeline_unc_with_scan_epochs_match_without(tmp_path):
    """``pipeline_unc=1`` with ``scan_epochs`` (chunks of one batch and a
    ragged tail) trains both trainers' stage 2 as ``pipeline_unc=1``
    alone, bit for bit."""
    cfgs = {1: {"resolution": 8, "epochs_per_stage": 1, "lr": 3e-4},
            2: {"resolution": 16, "epochs_per_stage": 1, "lr": 1e-4}}
    images, masks = disk_dataset(num_samples=10, image_size=16, seed=5)
    batches = [(images[:4], masks[:4]), (images[4:8], masks[4:8]), (images[8:], masks[8:])]
    per = images[:4].nbytes + masks[:4].nbytes
    runs = []
    for scan in (False, True):
        tr = UncertaintyGuidedProgressiveTrainer(stage_configs=cfgs, verbose=False, width=0.25,
                                                 augment=True, fused_loss=True, pipeline_unc=1,
                                                 device="cpu", scan_epochs=scan,
                                                 scan_chunk_bytes=per)
        tr.setup_optimizer(1)
        tr.train_epoch(batches, 1)
        tr.transfer_weights(1, 2)
        tr.setup_optimizer(2)
        runs.append((tr.train_epoch(batches, 2), tr.models[2].state_dict()))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k

    rng = np.random.default_rng(3)
    cls_batches = [(rng.random((n, 16, 16, 3)).astype(np.float32),
                    rng.integers(0, K_CLS, n).astype(np.int64)) for n in (4, 4, 2)]
    out = []
    for scan in (False, True):
        cfg = create_config()
        cfg.update(num_classes=K_CLS, verbose=False, augment=True, pipeline_unc=1,
                   scan_epochs=scan, scan_chunk_bytes=cls_batches[0][0].nbytes)
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 1, 8)
            mp.setitem(port_classifier_mod.CLS_STAGE_RESOLUTIONS, 2, 16)
            tr = HerlevTrainer(cfg, device="cpu")
            tr.setup_optimizer_scheduler(2)
            out.append((tr.train_epoch(cls_batches, 2), tr.models[2].state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k
