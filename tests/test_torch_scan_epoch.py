"""Whole epochs (``scan_epochs``, ``scan_chunk_bytes``) of the port, on the
CPU: the counterpart of ``tests/test_scan_epoch.py``, one test for each of
its tests.

Each test holds the port's whole-epoch path equal to the port's own
per-step path (exactly: the same step function on the same inputs, the
draws in the same order, the metrics reduced as the per-step path reduces
them), and, where the JAX package runs the same configuration on the CPU,
against the JAX package's scan path from the same weights: epoch metrics
to rtol 1e-5, parameters and BN statistics to rtol 1e-4 plus 1e-5 x the
tensor's largest magnitude.  Those comparisons run without augmentation and
dropout (the two packages draw other bits) and at a learning rate of 1e-8:
RMSprop's first steps move every parameter by about 10 x lr whatever the
size of its gradient, so gradients at float32 noise flip the sign of an
update, and after a few steps the packages (and JAX's own loop and scan,
``tests/test_scan_epoch.py``) part by 1e-3 at the stages' learning rates.
At 1e-8 those comparisons cannot see the update itself (an epoch that
did not train would pass them), so one more test holds each parameter's
change over one chunk of two steps, at the stages' own learning rates,
against JAX's change (relative L2 per tensor, ``UPDATE_RTOL``), and plants
two faults it must catch.  Each single update is held against JAX in
``tests/test_torch_train.py`` and ``tests/test_torch_cls_steps.py``.

Width 0.25, stages at 16 and 32 px (the classifier at 16 px), batches of 4
noisy disks with ragged tails.
"""

import copy

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables
from tests.test_torch_models import jax_variables
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.train.cls_trainer import HerlevTrainer as JaxHerlevTrainer
from ugpg_tpu.train.seg_trainer import UncertaintyGuidedProgressiveTrainer as JaxSegTrainer
from ugpg_tpu_torch.data.augment import sample_herlev_params, sample_monuseg_params
from ugpg_tpu_torch.data.synthetic import disk_dataset
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.parallel.mesh import make_mesh, shard_stacked_batch
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
from ugpg_tpu_torch.train.seg_trainer import (
    DEFAULT_STAGE_CONFIGS,
    UncertaintyGuidedProgressiveTrainer,
)
from ugpg_tpu_torch.train.steps import (
    _batch_nbytes,
    draw_cls_epoch,
    draw_seg_epoch,
    plan_epoch_chunks,
    put_stacked,
    scan_usable,
    stack_epoch,
)

W = 0.25
JAX_LR = 1e-8
# the update over two steps at the stages' learning rates against JAX's, per
# parameter tensor (relative L2): measured up to 3.2e-2 (segmentation stage 2,
# the first conv's weight), 6.0e-3 at stage 1, 1.6e-3 for the classifier,
# 1.8e-2 through the pipeline (tests/test_torch_pipeline.py); the planted
# faults give 0.50 (an epoch on half its batches) to 1 (no update) at their
# worst tensor
UPDATE_RTOL = 0.1
NO_DROPOUT = (0.0, 0.0, 0.0)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(lr1=3e-4, lr2=1e-4):
    return {1: {"resolution": 16, "epochs_per_stage": 1, "lr": lr1},
            2: {"resolution": 32, "epochs_per_stage": 1, "lr": lr2}}


def _seg_batches(n_batches=3, batch=4, tail=None, seed=3):
    images, masks = disk_dataset(n_batches * batch + (tail or 0), 32, seed=seed)
    images = images + np.random.default_rng(seed).normal(0, 0.05, images.shape).astype(
        np.float32)
    out = [(images[i * batch:(i + 1) * batch], masks[i * batch:(i + 1) * batch])
           for i in range(n_batches)]
    if tail:
        out.append((images[n_batches * batch:], masks[n_batches * batch:]))
    return out


def _cls_batches(n_batches=3, batch=4, tail=None, seed=0, size=16):
    rs = np.random.default_rng(seed)
    sizes = [batch] * n_batches + ([tail] if tail else [])
    return [(rs.random((b, size, size, 3), dtype=np.float32),
             rs.integers(0, 7, size=(b,)).astype(np.int64)) for b in sizes]


def _seg(scan, chunk=None, cfgs=None, **kw):
    kw.setdefault("augment", True)
    return UncertaintyGuidedProgressiveTrainer(
        stage_configs=cfgs or _cfgs(), verbose=False, seed=0, device="cpu", width=W,
        fused_loss=True, scan_epochs=scan, scan_chunk_bytes=chunk, **kw)


def _seg_epochs(tr, batches, stages=(1, 2), epochs=1):
    """Train and validation epochs per stage, as the JAX test drives them."""
    out = []
    for stage in stages:
        if stage > 1:
            tr.transfer_weights(stage - 1, stage)
        tr.current_stage = stage
        tr.setup_optimizer(stage)
        for _ in range(epochs):
            out.append((tr.train_epoch(batches, stage), tr.validate_epoch(batches, stage)))
    return out


def _assert_same_state(a: torch.nn.Module, b: torch.nn.Module):
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def update_gaps(model, before: dict, jax_variables_after) -> dict:
    """Per parameter, ``|d - d_jax| / |d_jax|`` (L2 norms; 0 where neither
    moved): the port's update over the epoch (after minus ``before``, a
    state dict of the weights both started from) against the JAX
    package's."""
    after = state_dict_from_jax(jax.device_get(jax_variables_after))
    gaps = {}
    for name, p in model.named_parameters():
        want = after[name] - before[name]
        diff = torch.linalg.vector_norm(p.detach() - before[name] - want).item()
        norm = torch.linalg.vector_norm(want).item()
        gaps[name] = diff / norm if norm else diff
    return gaps


def _assert_params_match_jax(model, jax_variables_after, skip=("num_batches_tracked",)):
    after = state_dict_from_jax(jax.device_get(jax_variables_after))
    for name, p in model.state_dict().items():
        if name.endswith(skip):
            continue
        want = after[name].numpy()
        np.testing.assert_allclose(p.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=name)


# ---------------------------------------------------------------- the pieces
def test_draws_follow_the_per_step_order():
    """Counterpart of ``test_split_epoch_keys_matches_sequential_splitting``:
    the epoch's draws are the per-step path's, in its order, and leave the
    generator where the per-step path leaves it."""
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    drawn = draw_seg_epoch(g1, 3, 4, accum_steps=2, aug_quantize=8)
    for s in range(3):
        seq = [sample_monuseg_params(g2, 2, quantize_angles=8) for _ in range(2)]
        for k, v in drawn.items():
            assert torch.equal(v[s], torch.cat([p[k] for p in seq])), k
    assert torch.equal(g1.get_state(), g2.get_state())

    model = HerlevClassificationModel(1, 7)
    g1, g2 = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    aug, drop = draw_cls_epoch(g1, model, 2, 4, 16, 16, augment=True, accum_steps=2)
    for s in range(2):
        micro = [(sample_herlev_params(g2, 2, 16, 16), model.head_masks(2, g2, g2.device))
                 for _ in range(2)]
        for k, v in aug.items():
            assert torch.equal(v[s], torch.cat([a[k] for a, _ in micro])), k
        for j, mask in enumerate(drop):
            assert torch.equal(mask[s], torch.cat([m[j] for _, m in micro]))
    assert torch.equal(g1.get_state(), g2.get_state())


def test_stack_epoch_splits_uniform_prefix_and_tail():
    batches = _seg_batches(n_batches=3, tail=2)
    stacked, tail = stack_epoch(batches)
    assert stacked[0].shape == (3, 4, 32, 32, 3) and stacked[1].shape == (3, 4, 32, 32, 1)
    assert len(tail) == 1 and tail[0][0].shape[0] == 2
    np.testing.assert_array_equal(stacked[0][1], batches[1][0])
    on_device, tail_t = stack_epoch([tuple(torch.from_numpy(x) for x in b) for b in batches])
    assert isinstance(on_device[0], torch.Tensor) and len(tail_t) == 1
    assert torch.equal(on_device[0], torch.from_numpy(stacked[0]))
    # on a mesh axis 1 splits over 'data'; each step's batch is the whole one, in order
    mesh = make_mesh(2, 1, devices=[torch.device("cpu", i) for i in range(2)])
    placed = put_stacked(stacked, mesh)
    assert [tuple(p.shape) for p in placed[0]] == [(3, 2, 32, 32, 3)] * 2
    assert torch.equal(placed[0].step(1), torch.from_numpy(batches[1][0]))
    with pytest.raises(ValueError, match="does not split"):
        shard_stacked_batch(np.zeros((2, 3, 4)), mesh)


def test_scan_usable_checks_before_stacking():
    """From the first batch and the mesh only: a batch that divides the
    ``data`` axis may scan, another may not."""
    mesh = make_mesh(4, 2, devices=["cpu"] * 8)
    ok = (np.zeros((8, 8, 8, 3), np.float32), np.zeros((8, 8, 8, 1), np.float32))
    bad = (np.zeros((3, 8, 8, 3), np.float32), np.zeros((3, 8, 8, 1), np.float32))
    assert scan_usable(ok, None) and scan_usable(bad, None)
    assert scan_usable(ok, mesh)
    assert not scan_usable(bad, mesh)


def test_plan_epoch_chunks_caps_stack_bytes():
    batches = _seg_batches(n_batches=7, tail=2)
    per = _batch_nbytes(batches[0])
    assert plan_epoch_chunks(batches, None) == ([(0, 7)], 7)
    ranges, tail_start = plan_epoch_chunks(batches, 3 * per)
    assert ranges == [(0, 3), (3, 6)] and tail_start == 6
    for a, b in ranges:
        stacked, rest = stack_epoch(batches[a:b])
        assert not rest and sum(x.nbytes for x in stacked) <= 3 * per
    assert plan_epoch_chunks(batches, 1) == ([(i, i + 1) for i in range(7)], 7)
    assert _batch_nbytes(tuple(torch.from_numpy(x) for x in batches[0])) == per


# ---------------------------------------------------------------- segmentation
def test_seg_scan_epoch_matches_loop_with_ragged_tail():
    """Two stages (the uncertainty guidance at stage 2), augmentation, the
    fused loss, two chunks and a ragged tail: the whole-epoch path is the
    per-step path, bit for bit."""
    batches = _seg_batches(n_batches=3, tail=2)
    per = _batch_nbytes(batches[0])
    loop, scan = _seg(False), _seg(True, 2 * per)
    assert _seg_epochs(scan, batches, epochs=2) == _seg_epochs(loop, batches, epochs=2)
    for stage in (1, 2):
        _assert_same_state(scan.models[stage], loop.models[stage])


@pytest.mark.parametrize("stage", [1, 2])
def test_seg_scan_epoch_matches_jax_scan_path(stage):
    """The same epochs through the JAX trainer's scan path (one chunk of
    two steps, then the tail of a full and a ragged batch), from the same
    weights: train and validation metrics, parameters, BN statistics."""
    batches = _seg_batches(n_batches=3, tail=2)
    chunk = 2 * _batch_nbytes(batches[0])
    variables = {s: jax_variables(s, width=W, seed=s) for s in (1, 2)}
    cfgs = _cfgs(JAX_LR, JAX_LR)
    jt = JaxSegTrainer(stage_configs=cfgs, verbose=False, seed=0, width=W, fused_loss=True,
                       scan_epochs=True, scan_chunk_bytes=chunk)
    jt.variables.update(variables)
    jt.current_stage = stage
    jt.setup_optimizer(stage)
    want = (jt.train_epoch(batches, stage), jt.validate_epoch(batches, stage))
    tr = _seg(True, chunk, cfgs, augment=False)
    for s in (1, 2):
        tr._model(s).load_state_dict(state_dict_from_jax(variables[s]))
    tr.current_stage = stage
    tr.setup_optimizer(stage)
    got = (tr.train_epoch(batches, stage), tr.validate_epoch(batches, stage))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    _assert_params_match_jax(tr.models[stage], jt._state.variables)


def test_seg_scan_epoch_under_mesh_matches_loop():
    """On a 2 x 2 mesh of CPU devices the stacked chunks split over
    ``data``: the mesh's whole epochs are its per-step epochs, bit for bit,
    and the unsharded trainer's to float32 rounding."""
    mesh = make_mesh(2, 2, devices=[torch.device("cpu", i) for i in range(4)])
    batches = _seg_batches(n_batches=2, batch=4)
    runs = {}
    for name, scan, m in (("loop", False, mesh), ("scan", True, mesh), ("plain", False, None)):
        tr = _seg(scan, augment=False, mesh=m)
        tr.setup_optimizer(1)
        runs[name] = (tr, tr.train_epoch(batches, 1), tr.validate_epoch(batches, 1))
    assert runs["scan"][1:] == runs["loop"][1:]
    _assert_same_state(runs["scan"][0].models[1], runs["loop"][0].models[1])
    np.testing.assert_allclose(runs["scan"][1], runs["plain"][1], rtol=2e-5, atol=1e-6)


def test_seg_scan_mesh_falls_back_on_indivisible_batch():
    """Batch 3 does not split over 2 data shards: the epoch runs per step
    (unsharded, as the per-step path runs such a batch), not a crash."""
    mesh = make_mesh(2, 2, devices=[torch.device("cpu", i) for i in range(4)])
    batches = _seg_batches(n_batches=2, batch=3)
    got = []
    for scan in (True, False):
        tr = _seg(scan, augment=False, mesh=mesh)
        tr.setup_optimizer(1)
        got.append(tr.train_epoch(batches, 1))
    assert np.isfinite(got[0][0]) and got[0] == got[1]


def test_seg_chunked_scan_matches_unchunked():
    """A chunk cap that splits the epoch into two chunks and a tail gives
    the unbounded epoch's metrics and parameters, bit for bit."""
    batches = _seg_batches(n_batches=4, tail=2)
    per = _batch_nbytes(batches[0])
    one, chunked = _seg(True, None), _seg(True, 2 * per)
    assert _seg_epochs(chunked, batches, (1,)) == _seg_epochs(one, batches, (1,))
    _assert_same_state(chunked.models[1], one.models[1])


def test_seg_scan_chunked_with_tail_fast():
    """One-batch chunks and a ragged tail against the per-step path, and a
    one-batch epoch; the validation set, one chunk with no tail, is
    stacked once per stage and read from its cache after."""
    batches = _seg_batches(n_batches=3, batch=2, tail=1)
    per = _batch_nbytes(batches[0])
    for epoch in (batches, batches[:1]):
        loop, scan = _seg(False), _seg(True, per)
        assert _seg_epochs(scan, epoch, (1,)) == _seg_epochs(loop, epoch, (1,))
        _assert_same_state(scan.models[1], loop.models[1])
    tr = _seg(True)
    val = batches[:3]
    tr.setup_optimizer(1)
    first = tr.validate_epoch(val, 1)
    token, cached = tr._val_stack_cache[1]
    assert token == (id(val), 3) and cached["images"].shape == (3, 2, 32, 32, 3)
    assert tr.validate_epoch(val, 1) == first and tr._val_stack_cache[1][1] is cached


def test_seg_scan_epoch_with_accum_matches_loop():
    """scan_epochs with accum_steps=2: the accumulated step of the per-step
    path, bit for bit; against the JAX scan path from the same weights."""
    batches = _seg_batches(n_batches=2, batch=4)
    runs = []
    for scan in (False, True):
        tr = _seg(scan, accum_steps=2)
        runs.append((tr, _seg_epochs(tr, batches, (1,))))
    assert runs[0][1] == runs[1][1]
    _assert_same_state(runs[0][0].models[1], runs[1][0].models[1])

    v = jax_variables(1, width=W, seed=1)
    jt = JaxSegTrainer(stage_configs=_cfgs(JAX_LR), verbose=False, seed=0, width=W,
                       fused_loss=True, scan_epochs=True, accum_steps=2)
    jt.variables[1] = v
    jt.setup_optimizer(1)
    want = jt.train_epoch(batches, 1)
    tr = _seg(True, cfgs=_cfgs(JAX_LR), augment=False, accum_steps=2)
    tr._model(1).load_state_dict(state_dict_from_jax(v))
    tr.setup_optimizer(1)
    np.testing.assert_allclose(tr.train_epoch(batches, 1), want, rtol=1e-5, atol=1e-7)
    _assert_params_match_jax(tr.models[1], jt._state.variables)


def test_aug_trainer_and_command_line_pass_the_options_through(tmp_path, monkeypatch):
    """``AugMoNuSegTrainer`` takes both options as the JAX one does, with
    JAX's default cap; ``train_monuseg --scan_epochs --scan_chunk_mb``
    reaches the trainer (0 = unbounded)."""
    from ugpg_tpu_torch.cli import train_monuseg
    from ugpg_tpu_torch.train.aug_trainer import AugMoNuSegTrainer

    assert AugMoNuSegTrainer({}, device="cpu").scan_chunk_bytes == 1 << 30
    tr = AugMoNuSegTrainer({}, device="cpu", scan_epochs=True, scan_chunk_bytes=None)
    assert tr.scan_epochs and tr.scan_chunk_bytes is None
    seen = {}

    class Stop(Exception):
        pass

    def record(self, *a, **kw):
        seen.update(scan_epochs=self.scan_epochs, chunk=self.scan_chunk_bytes)
        raise Stop

    monkeypatch.setattr(AugMoNuSegTrainer, "setup_datasets", record)
    for flags, chunk in ((["--scan_chunk_mb", "64"], 64 << 20), (["--scan_chunk_mb", "0"], None),
                         ([], 1 << 30)):
        with pytest.raises(Stop):
            train_monuseg.main(["--data_dir", str(tmp_path), "--output_dir", str(tmp_path),
                                "--device", "cpu", "--scan_epochs", *flags])
        assert seen == {"scan_epochs": True, "chunk": chunk}


# ---------------------------------------------------------------- classification
def _cls(scan, chunk=None, **cfg):
    c = create_config()
    c.update(num_classes=7, epochs_per_stage=1, verbose=False, scan_epochs=scan,
             augment=True, scan_chunk_bytes=chunk)
    c.update(cfg)
    tr = HerlevTrainer(c, seed=0, device="cpu")
    tr.stage_configs[1]["resolution"] = 16
    tr.stage_configs[2]["resolution"] = 16
    return tr


def _cls_epochs(tr, batches, stages=(1, 2), epochs=1):
    out = []
    for stage in stages:
        if stage > 1:
            tr.transfer_weights(stage - 1, stage)
        tr.current_stage = stage
        tr.setup_optimizer_scheduler(stage)
        for _ in range(epochs):
            out.append((tr.train_epoch(batches, stage), tr.validate_epoch(batches, stage)))
    return out


def test_cls_scan_epoch_matches_loop():
    """Two stages, augmentation and dropout drawn before each chunk, a
    ragged tail and a learning-rate change between epochs (the plateau
    scheduler's write): the per-step path, bit for bit."""
    batches = _cls_batches(n_batches=3, tail=2)
    per = _batch_nbytes(batches[0])
    runs = []
    for tr in (_cls(False), _cls(True, 2 * per)):
        out = []
        for stage in (1, 2):
            if stage > 1:
                tr.transfer_weights(1, 2)
            tr.current_stage = stage
            tr.setup_optimizer_scheduler(stage)
            out.append(tr.train_epoch(batches, stage))
            tr._scheduler.patience = -1  # the next step halves the learning rate
            tr._scheduler.step(1.0, tr.optimizer)
            out.append((tr.train_epoch(batches, stage), tr.validate_epoch(batches, stage)))
        runs.append((tr, out))
    assert runs[0][1] == runs[1][1]
    for stage in (1, 2):
        _assert_same_state(runs[0][0].models[stage], runs[1][0].models[stage])


def test_cls_scan_epoch_matches_jax_scan_path():
    """Stage 1 of the Herlev trainers, dropout off in both (their bits
    differ), one chunk of two steps and a tail: the JAX scan path's train
    and validation metrics and parameters, from the same weights."""
    batches = _cls_batches(n_batches=3, tail=2)
    chunk = 2 * _batch_nbytes(batches[0])
    v = jax_cls_variables(1, 7, seed=1, dropout_rates=NO_DROPOUT)
    cfg = create_config()
    cfg.update(num_classes=7, epochs_per_stage=1, verbose=False, scan_epochs=True,
               augment=False, scan_chunk_bytes=chunk)
    jt = JaxHerlevTrainer(cfg, seed=0)
    jt.stage_configs[1].update(resolution=16, lr=JAX_LR)
    jt.modules[1] = JaxClassifier(stage=1, num_classes=7, dropout_rates=NO_DROPOUT)
    jt.variables[1] = v
    jt.current_stage = 1
    jt.setup_optimizer_scheduler(1)
    want = (jt.train_epoch(batches, 1), jt.validate_epoch(batches, 1))

    tr = _cls(True, chunk, augment=False)
    tr.stage_configs[1]["lr"] = JAX_LR
    tr.models[1] = HerlevClassificationModel(1, 7, dropout_rates=NO_DROPOUT)
    tr.models[1].load_state_dict(state_dict_from_jax(v))
    tr.current_stage = 1
    tr.setup_optimizer_scheduler(1)
    got = (tr.train_epoch(batches, 1), tr.validate_epoch(batches, 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    _assert_params_match_jax(tr.models[1], jt._state.variables)


def test_cls_chunked_scan_matches_unchunked():
    batches = _cls_batches(n_batches=4, tail=2)
    per = _batch_nbytes(batches[0])
    one, chunked = _cls(True, None), _cls(True, 2 * per)
    assert _cls_epochs(chunked, batches, (1,)) == _cls_epochs(one, batches, (1,))
    _assert_same_state(chunked.models[1], one.models[1])


def test_cls_scan_epoch_fast():
    """A one-batch epoch, with accum_steps=2: the per-step path's."""
    batches = _cls_batches(n_batches=1, batch=4)
    loop, scan = _cls(False, accum_steps=2), _cls(True, accum_steps=2)
    assert _cls_epochs(scan, batches, (1,)) == _cls_epochs(loop, batches, (1,))
    _assert_same_state(scan.models[1], loop.models[1])


def test_cls_scan_under_mesh_matches_loop():
    """The Herlev trainer on a 2 x 1 mesh of CPU devices: whole epochs are
    its per-step epochs, and a batch of 3 runs per step."""
    mesh = make_mesh(2, 1, devices=[torch.device("cpu", i) for i in range(2)])
    for batches in (_cls_batches(n_batches=2, tail=2), _cls_batches(n_batches=2, batch=3)):
        out = []
        for scan in (False, True):
            c = create_config()
            c.update(num_classes=7, verbose=False, scan_epochs=scan, augment=True)
            tr = HerlevTrainer(c, seed=0, device="cpu", mesh=mesh)
            tr.stage_configs[1]["resolution"] = 16
            tr.setup_optimizer_scheduler(1)
            out.append((tr, tr.train_epoch(batches, 1), tr.validate_epoch(batches, 1)))
        assert out[0][1:] == out[1][1:]
        _assert_same_state(out[0][0].models[1], out[1][0].models[1])


def test_device_constants_are_kept_but_not_under_tracing():
    """The step's constants (resize matrices, the jitter's gray weights) are
    made once per device, so that a captured step copies nothing from the
    host; a trace (``torch.export``'s fake tensors) gets its own each call
    and leaves the kept ones alone."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ugpg_tpu_torch import device as device_mod

    key = ("test", 3)
    first = device_mod.device_constant(key, lambda: (1.0, 2.0, 3.0), "cpu", torch.float32)
    assert device_mod.device_constant(key, lambda: (0.0,), "cpu", torch.float32) is first
    with FakeTensorMode():
        traced = device_mod.device_constant(("test", 4), lambda: (1.0,), "cpu", torch.float32)
    assert ("test", 4) not in {k[0] for k in device_mod._constants}
    assert type(traced).__name__ == "FakeTensor" and torch.equal(first, torch.tensor([1., 2., 3.]))


# ---------------------------------------------------------------- updates at the real rates
def _real_lr_cfgs():
    return {s: {**c, "lr": DEFAULT_STAGE_CONFIGS[s]["lr"]} for s, c in _cfgs().items()}


def _seg_update_run(stage, batches, variables):
    tr = _seg(True, None, _real_lr_cfgs(), augment=False)
    for s in (1, 2):
        tr._model(s).load_state_dict(state_dict_from_jax(variables[s]))
    tr.current_stage = stage
    tr.setup_optimizer(stage)
    tr.train_epoch(batches, stage)
    return tr.models[stage]


def _update_case(kind, stage):
    """(the port's trained model, the starting state, JAX's variables after,
    a run of the port's over the first batch only): one chunk of two steps
    at the stage's learning rate, from the same weights."""
    if kind == "seg":
        batches = _seg_batches(n_batches=2, batch=4)
        variables = {s: jax_variables(s, width=W, seed=s) for s in (1, 2)}
        jt = JaxSegTrainer(stage_configs=_real_lr_cfgs(), verbose=False, seed=0, width=W,
                           fused_loss=True, scan_epochs=True, scan_chunk_bytes=None)
        jt.variables.update(variables)
        jt.current_stage = stage
        jt.setup_optimizer(stage)
        jt.train_epoch(batches, stage)
        return (_seg_update_run(stage, batches, variables),
                state_dict_from_jax(variables[stage]), jt._state.variables,
                _seg_update_run(stage, batches[:1], variables))
    batches = _cls_batches(n_batches=2)
    v = jax_cls_variables(1, 7, seed=1, dropout_rates=NO_DROPOUT)
    cfg = create_config()
    cfg.update(num_classes=7, epochs_per_stage=1, verbose=False, scan_epochs=True,
               augment=False, scan_chunk_bytes=None)
    jt = JaxHerlevTrainer(cfg, seed=0)
    jt.stage_configs[1]["resolution"] = 16
    jt.modules[1] = JaxClassifier(stage=1, num_classes=7, dropout_rates=NO_DROPOUT)
    jt.variables[1] = v
    jt.current_stage = 1
    jt.setup_optimizer_scheduler(1)
    jt.train_epoch(batches, 1)

    def run(epoch):
        tr = _cls(True, None, augment=False)
        tr.models[1] = HerlevClassificationModel(1, 7, dropout_rates=NO_DROPOUT)
        tr.models[1].load_state_dict(state_dict_from_jax(v))
        tr.current_stage = 1
        tr.setup_optimizer_scheduler(1)
        tr.train_epoch(epoch, 1)
        return tr.models[1]

    return run(batches), state_dict_from_jax(v), jt._state.variables, run(batches[:1])


@pytest.mark.parametrize("kind,stage", [("seg", 1), ("seg", 2), ("cls", 1)])
def test_scan_update_matches_jax_update_at_the_real_learning_rate(kind, stage):
    """The update itself, which the comparisons at lr 1e-8 above cannot see
    (they would pass an epoch that did not train): one chunk of two steps
    at the stage's own learning rate (RMSprop 3e-4 / 1e-4, Adam 3e-4), no
    augmentation or dropout, from the same weights as JAX's scan path.
    Each parameter's change is held against JAX's change to a relative L2
    distance of UPDATE_RTOL.  Two planted faults must fail that check: the
    update skipped, and the epoch trained on its first batch only."""
    model, before, jax_after, half = _update_case(kind, stage)
    gaps = update_gaps(model, before, jax_after)
    assert max(gaps.values()) <= UPDATE_RTOL, sorted(gaps.items(), key=lambda kv: -kv[1])[:3]
    skipped = copy.deepcopy(model)
    skipped.load_state_dict(before)
    for fault in (skipped, half):
        assert max(update_gaps(fault, before, jax_after).values()) > UPDATE_RTOL
