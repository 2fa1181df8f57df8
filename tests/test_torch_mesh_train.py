"""Training on a device mesh (``train/steps.py`` with ``mesh=``, cross-replica
BN in ``models/blocks.py``, ``parallel/tensor.py::ReplicaLayout``, both
trainers' ``mesh``, ``shard_model`` and ``axis_name``) against the JAX
package's mesh steps on its fake CPU devices (``tests/test_parallel.py``) and
against the port's own unsharded steps, on the CPU.

The port's meshes name ``torch.device("cpu", i)``, distinct devices, so that
every conv copies its weights to each shard's device and the gradients flow
back through the copies, as they do across cards.  PGUNet1/PGUNet2 at width
0.25 with stages at 16/32 px, the classifier's stage 1 at 16 px; batches of
4 on meshes 2 x 1 and 2 x 2 (``shard_model``).  At width 0.25 no conv
reaches the 256 output channels that shard over ``model``, so the port's
threshold is lowered to 32 here (``parallel.mesh._TP_MIN_CHANNELS``), and
the 2 x 2 cases run column-parallel convs; JAX's threshold stays, which
changes nothing in the function it computes.

The images carry noise on top of the synthetic disks: a flat disk image is
full of exact ties (a max-pool window of equal values, a ReLU input of
exactly 0), and float32 rounding that differs between a shard's conv and
the whole batch's may then route a gradient to another pixel of the tie.

Tolerances (``tests/test_parallel.py:56-124``, ``tests/test_torch_train.py``):
metrics rtol 2e-5; BN running stats 1e-5; gradients rtol 1e-4 plus 1e-5 x
the largest gradient (1e-3 x with ``accum_steps=2``, as
``tests/test_torch_train.py::test_accumulated_train_step_matches_jax``);
parameters after RMSprop's first step within JAX's own bounds (mean |d|
below 1e-4, max below 2e-2: near-zero gradients take a step of either
sign); the trainers' trajectories rtol 2e-2 (segmentation) and 2e-3
(Herlev's epoch), as ``tests/test_parallel.py:271-328``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_classifier import jax_cls_variables, port_classifier
from tests.test_torch_models import jax_variables
from tests.test_torch_train import LR, PW, RES, WD, _capture_grads, _jax_module, _port_model
from ugpg_tpu.models.classifier import HerlevClassificationModel as JaxClassifier
from ugpg_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ugpg_tpu.parallel.mesh import shard_batch as jax_shard_batch
from ugpg_tpu.parallel.mesh import shard_variables as jax_shard_variables
from ugpg_tpu.train.optim import torch_adam as jax_adam
from ugpg_tpu.train.optim import torch_rmsprop as jax_rmsprop
from ugpg_tpu.train.seg_trainer import UncertaintyGuidedProgressiveTrainer as JaxSegTrainer
from ugpg_tpu.train.steps import TrainState
from ugpg_tpu.train.steps import make_cls_train_step as jax_cls_step
from ugpg_tpu.train.steps import make_seg_train_step as jax_seg_step
from ugpg_tpu_torch.data.synthetic import ArrayLoader, disk_dataset
from ugpg_tpu_torch.io.from_jax import state_dict_from_jax
from ugpg_tpu_torch.models.blocks import DoubleConv
from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners
from ugpg_tpu_torch.parallel import mesh as port_mesh
from ugpg_tpu_torch.parallel.mesh import make_mesh, param_shardings
from ugpg_tpu_torch.train.cls_trainer import HerlevTrainer, create_config
from ugpg_tpu_torch.train.optim import torch_adam, torch_rmsprop
from ugpg_tpu_torch.train.seg_trainer import UncertaintyGuidedProgressiveTrainer
from ugpg_tpu_torch.train.steps import (
    CLS_METRIC_KEYS,
    METRIC_KEYS,
    make_cls_eval_step,
    make_cls_train_step,
    make_seg_eval_step,
    make_seg_train_step,
)

K_CLS, CLS_RES = 3, 16
NO_DROPOUT = (0.0, 0.0, 0.0)
SEG_CASES = {"stage1-2x1": (1, (2, 1)), "stage2-2x2": (2, (2, 2))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def column_parallel_at_width_quarter(monkeypatch):
    monkeypatch.setattr(port_mesh, "_TP_MIN_CHANNELS", 32)


def port_mesh_of(shape):
    return make_mesh(*shape, devices=[torch.device("cpu", i) for i in range(shape[0] * shape[1])])


def noisy_disks(n=4, size=40, seed=3):
    images, masks = disk_dataset(n, size, seed=seed)
    noise = np.random.default_rng(seed).standard_normal(images.shape).astype(np.float32)
    return np.clip(images + 0.05 * noise, 0.0, 1.0), masks


def assert_metrics(got, want, keys, rtol):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol, atol=1e-7,
                                   err_msg=k)


def assert_grads(got: dict, want: dict, floor=1e-5):
    """Every gradient of ``got`` (the port's parameters) against ``want``."""
    gmax = max(want[name].abs().max().item() for name in got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4, atol=floor * gmax,
                                   err_msg=name)


def assert_running_stats(got: dict, want: dict):
    for key, value in want.items():
        if "running" in key:
            np.testing.assert_allclose(got[key].numpy(), value.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=key)


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


# ---------------------------------------------------------------- segmentation steps
@pytest.fixture(scope="module")
def jax_seg_runs():
    """JAX's mesh step on each case: (variables, previous stage's, new
    state and metrics), compiled once per case."""
    out = {}
    images, masks = noisy_disks()
    for name, (stage, shape) in SEG_CASES.items():
        v_prev = jax_variables(1, width=0.25, seed=1)
        v = v_prev if stage == 1 else jax_variables(2, width=0.25, seed=2)
        mesh = jax_make_mesh(n_data=shape[0], n_model=shape[1])
        tx = optax.chain(_capture_grads(), jax_rmsprop(LR[stage], weight_decay=WD))
        step = jax_seg_step(_jax_module(stage), tx, stage, RES[stage],
                            prev_module=_jax_module(1) if stage > 1 else None,
                            prev_resolution=RES[1], donate=False)
        new, jm = step(TrainState.create(jax_shard_variables(v, mesh), tx),
                       jax_shard_variables(v_prev, mesh) if stage > 1 else {},
                       jax_shard_batch((images, masks), mesh), jnp.asarray(PW),
                       jax.random.key(0))
        out[name] = (v, v_prev, jax.device_get((new, jm)))
    return out


def _port_seg(stage, v, v_prev, mesh=None, **kw):
    model = _port_model(stage, v)
    prev = _port_model(1, v_prev) if stage > 1 else None
    opt = torch_rmsprop(model.parameters(), LR[stage], weight_decay=WD)
    step = make_seg_train_step(model, opt, stage, RES[stage], prev_model=prev,
                               prev_resolution=RES[1], mesh=mesh, **kw)
    return model, prev, step


@pytest.mark.parametrize("case", SEG_CASES)
def test_seg_mesh_step_matches_jax_and_unsharded(case, jax_seg_runs):
    stage, shape = SEG_CASES[case]
    v, v_prev, (new, jm) = jax_seg_runs[case]
    batch = noisy_disks()
    mesh = port_mesh_of(shape)
    model, _, step = _port_seg(stage, v, v_prev, mesh=mesh)
    tm = step(batch, PW)
    assert set(tm) == set(METRIC_KEYS)
    assert_metrics(tm, jm, METRIC_KEYS, 2e-5)
    assert_grads(grads_of(model), state_dict_from_jax({"params": new.opt_state[0]}))
    after = state_dict_from_jax(new.variables)
    assert_running_stats(model.state_dict(), after)
    for name, p in model.named_parameters():  # JAX's own bounds (tests/test_parallel.py:85-93)
        d = np.abs(p.detach().numpy() - after[name].numpy())
        assert d.mean() < 1e-4 and d.max() < 2e-2, name

    plain, _, plain_step = _port_seg(stage, v, v_prev)
    assert_metrics(tm, plain_step(batch, PW), METRIC_KEYS, 2e-5)
    assert_grads(grads_of(model), grads_of(plain))
    assert_running_stats(model.state_dict(), plain.state_dict())
    if shape[1] > 1:
        # the column-parallel layout survives the update (tests/test_parallel.py:95-124)
        specs = param_shardings(model.state_dict(), mesh)
        assert specs["down4.mpconv.1.conv_op.0.weight"].spec == ("model", None, None, None)
        assert specs["down4.mpconv.1.conv_op.0.bias"].spec == ()
        assert float(tm["uncertainty_weight_mean"]) > 0.5


@pytest.mark.parametrize("case", SEG_CASES)
def test_seg_mesh_step_on_tied_flat_disks_matches_unsharded(case):
    """The flat, noise-free disks (``disk_dataset`` as it is: exact max-pool
    and ReLU ties) against the unsharded step: the loss, the metrics and
    the BN stats as on the noisy images; the gradients per tensor in L2,
    relative to the tensor's norm, within 1e-2 (a tie routed to another
    pixel moves one tensor; measured at most 2.1e-3, a BN shift of the
    2 x 2 case, and 1.8e-6 elsewhere), except the conv biases before a BN,
    whose exact gradient is 0 (BN removes a per-channel shift): there the
    rounding alone, held at 1e-5 x the largest gradient (measured 8.5e-7)."""
    stage, shape = SEG_CASES[case]
    v_prev = jax_variables(1, width=0.25, seed=1)
    v = v_prev if stage == 1 else jax_variables(2, width=0.25, seed=2)
    batch = disk_dataset(4, 40, seed=4)
    model, _, step = _port_seg(stage, v, v_prev, mesh=port_mesh_of(shape))
    plain, _, plain_step = _port_seg(stage, v, v_prev)
    assert_metrics(step(batch, PW), plain_step(batch, PW), METRIC_KEYS, 2e-5)
    assert_running_stats(model.state_dict(), plain.state_dict())
    got, want = grads_of(model), grads_of(plain)
    gmax = max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        diff = got[name] - g
        if name.endswith(("conv_op.0.bias", "conv_op.3.bias")):
            assert diff.abs().max().item() <= 1e-5 * gmax, name
        else:
            assert (diff.norm() / g.norm()).item() <= 1e-2, name


def test_seg_mesh_eval_step_matches_unsharded():
    v_prev, v = jax_variables(1, width=0.25, seed=1), jax_variables(2, width=0.25, seed=2)
    batch = noisy_disks(seed=4)
    model, prev = _port_model(2, v), _port_model(1, v_prev)
    want = make_seg_eval_step(model, 2, RES[2], prev, RES[1])(batch, PW)
    got = make_seg_eval_step(model, 2, RES[2], prev, RES[1], mesh=port_mesh_of((2, 2)))(
        batch, PW)
    assert_metrics(got, want, METRIC_KEYS, 2e-5)
    for key, value in state_dict_from_jax(v).items():  # eval: the running stats are read only
        assert torch.equal(model.state_dict()[key], value), key


def test_fused_loss_on_mesh_matches_plain_loss():
    """fused_loss=True on a 2 x 2 mesh, augmented, accum_steps=2, against the
    plain loss on the same draws (tests/test_parallel.py:330-347)."""
    v_prev, v = jax_variables(1, width=0.25, seed=1), jax_variables(2, width=0.25, seed=2)
    batch = noisy_disks(n=8, seed=5)
    runs = {}
    for fused in (True, False):
        model, _, step = _port_seg(2, v, v_prev, mesh=port_mesh_of((2, 2)), fused_loss=fused,
                                   augment=True, accum_steps=2)
        runs[fused] = (step(batch, PW, torch.Generator().manual_seed(7)), grads_of(model))
    assert_metrics(runs[True][0], runs[False][0], METRIC_KEYS, 1e-5)
    assert_grads(runs[True][1], runs[False][1])
    # and the mesh against the unsharded step on the same draws
    model, _, step = _port_seg(2, v, v_prev, fused_loss=True, augment=True, accum_steps=2)
    assert_metrics(runs[True][0], step(batch, PW, torch.Generator().manual_seed(7)),
                   METRIC_KEYS, 2e-5)
    assert_grads(runs[True][1], grads_of(model), floor=1e-3)


def test_mesh_step_composes_with_remat_bf16_and_external_uncertainty():
    """On a 2 x 2 mesh: remat leaves the metrics, gradients and BN state
    equal bit for bit (the recompute checkpoints the whole grid's block);
    bf16 moves the losses from the unsharded bf16 step by no more than
    bf16 moves them from float32; external_uncertainty with the previous
    stage's probabilities gives the step with the previous stage."""
    v_prev, v = jax_variables(1, width=0.25, seed=1), jax_variables(2, width=0.25, seed=2)
    batch = noisy_disks(n=4, seed=5)
    mesh = port_mesh_of((2, 2))

    def run(mesh=None, remat=False, dtype=torch.float32):
        model, prev, step = _port_seg(2, v, v_prev, mesh=mesh)
        for block in model.modules():
            if isinstance(block, DoubleConv):
                block.remat, block.compute_dtype = remat, dtype
        return step(batch, PW), grads_of(model), model.state_dict(), prev

    plain, grads, state, prev = run(mesh)
    remat, remat_grads, remat_state, _ = run(mesh, remat=True)
    assert all(torch.equal(plain[k], remat[k]) for k in METRIC_KEYS)
    assert all(torch.equal(grads[n], remat_grads[n]) for n in grads)
    assert all(torch.equal(state[k], remat_state[k]) for k in state)

    mesh16, want16 = run(mesh, dtype=torch.bfloat16)[0], run(dtype=torch.bfloat16)[0]
    want32 = run()[0]
    for k in ("final_loss", "base_loss"):
        assert abs(float(mesh16[k]) - float(want16[k])) <= abs(float(want16[k]) - float(want32[k]))

    x = resize_bilinear_align_corners(torch.from_numpy(batch[0]).permute(0, 3, 1, 2),
                                      (RES[2], RES[2]))
    with torch.no_grad():
        probs = resize_bilinear_align_corners(torch.sigmoid(prev(resize_bilinear_align_corners(
            x, (RES[1], RES[1])))), (RES[2], RES[2]))
    model = _port_model(2, v)
    step = make_seg_train_step(model, torch_rmsprop(model.parameters(), LR[2], weight_decay=WD),
                               2, RES[2], external_uncertainty=True, mesh=mesh)
    assert_metrics(step(batch, PW, unc=probs), plain, METRIC_KEYS, 1e-6)
    assert_grads(grads_of(model), grads)


# ---------------------------------------------------------------- classification steps
def _cls_batch():
    g = np.random.default_rng(7)
    labels = g.integers(0, K_CLS, 4)
    images = np.clip(g.random((4, 24, 24, 3), np.float32)
                     + 0.2 * labels[:, None, None, None], 0, 1).astype(np.float32)
    return (images, labels), np.array([1.0, 2.0, 0.5], np.float32)


def test_cls_mesh_step_matches_jax_and_unsharded(monkeypatch):
    """Stage 1 (its 512-channel convs shard over ``model`` at the JAX
    package's own threshold) on 2 x 2 against JAX's mesh step, without
    dropout; then with dropout and augmentation against the unsharded
    step on the same draws."""
    v = jax_cls_variables(1, K_CLS, seed=1, dropout_rates=NO_DROPOUT)
    batch, cw = _cls_batch()
    mesh = jax_make_mesh(n_data=2, n_model=2)
    tx = optax.chain(_capture_grads(), jax_adam(3e-4, weight_decay=WD))
    step = jax_cls_step(JaxClassifier(stage=1, num_classes=K_CLS, dropout_rates=NO_DROPOUT), tx,
                        1, CLS_RES, K_CLS, donate=False, normalize=True)
    new, jm = jax.device_get(step(TrainState.create(jax_shard_variables(v, mesh), tx), {},
                                  jax_shard_batch(batch, mesh), jnp.asarray(cw),
                                  jax.random.key(0)))
    monkeypatch.setattr(port_mesh, "_TP_MIN_CHANNELS", 256)  # the JAX package's threshold

    def port(mesh=None, dropout=NO_DROPOUT, augment=False):
        model = port_classifier(1, v, K_CLS, dropout_rates=dropout)
        opt = torch_adam(model.parameters(), 3e-4, weight_decay=WD)
        s = make_cls_train_step(model, opt, 1, CLS_RES, K_CLS, normalize=True, mesh=mesh,
                                augment=augment)
        return model, s(batch, torch.from_numpy(cw), torch.Generator().manual_seed(3))

    model, tm = port(port_mesh_of((2, 2)))
    assert_metrics(tm, jm, CLS_METRIC_KEYS, 2e-5)
    # floor 2e-5 x max|g| against JAX: on this batch the port's unsharded
    # step sits 1.8e-5 x max|g| from JAX's too (flax's E[x^2] - E[x]^2
    # variance over 512 channels, ROADMAP.md section C); against the
    # unsharded port below the mesh holds 1e-5 (measured 3e-8)
    jax_grads = state_dict_from_jax({"params": new.opt_state[0]})
    assert_grads(grads_of(model), jax_grads, floor=2e-5)
    assert_running_stats(model.state_dict(), state_dict_from_jax(new.variables))
    unsharded, _ = port()
    assert_grads(grads_of(model), grads_of(unsharded))

    meshed, tm = port(port_mesh_of((2, 2)), (0.5, 0.3, 0.2), augment=True)
    plain, want = port(None, (0.5, 0.3, 0.2), augment=True)
    assert_metrics(tm, want, CLS_METRIC_KEYS, 2e-5)
    assert_grads(grads_of(meshed), grads_of(plain))
    assert_running_stats(meshed.state_dict(), plain.state_dict())
    eval_want = make_cls_eval_step(plain, 1, CLS_RES, K_CLS, normalize=True)(batch, cw)
    eval_got = make_cls_eval_step(plain, 1, CLS_RES, K_CLS, normalize=True,
                                  mesh=port_mesh_of((2, 1)))(batch, cw)
    assert_metrics(eval_got, eval_want, CLS_METRIC_KEYS, 2e-5)


# ---------------------------------------------------------------- the trainers
SEG_CONFIGS = {1: {"resolution": 8, "epochs_per_stage": 1, "lr": 3e-4},
               2: {"resolution": 16, "epochs_per_stage": 1, "lr": 1e-4}}


def test_seg_trainer_on_mesh_matches_single_device(tmp_path):
    """Two stages, one epoch each, fused loss and augmentation; batches of 4,
    4 and 2 on a 4 x 1 mesh: the ragged last batch trains unsharded."""
    images, masks = noisy_disks(n=10, size=32, seed=5)
    loader = ArrayLoader(images, masks, batch_size=4)
    hists, trainers = {}, {}
    for name, mesh in (("single", None), ("mesh", port_mesh_of((4, 1)))):
        tr = UncertaintyGuidedProgressiveTrainer(stage_configs=SEG_CONFIGS, seed=3, verbose=False,
                                                 mesh=mesh, device="cpu", width=0.25,
                                                 fused_loss=True, augment=True)
        hists[name] = tr.train_progressive(loader, loader, stages=[1, 2],
                                           save_dir=str(tmp_path / name))
        trainers[name] = tr
    for key in ("train_loss", "val_loss", "train_dice", "val_dice", "uncertainty_weights_mean"):
        np.testing.assert_allclose(hists["single"][key], hists["mesh"][key], rtol=2e-2,
                                   atol=2e-2, err_msg=key)
    assert {2, (2, "mesh")} <= set(trainers["mesh"]._train_steps)  # the ragged batch ran too


def test_cls_trainer_epoch_on_mesh_matches_single_device(monkeypatch):
    monkeypatch.setitem(CLS_STAGE_RESOLUTIONS, 1, CLS_RES)
    cfg = create_config()
    cfg.update(num_classes=K_CLS, epochs_per_stage=1, stages=[1], verbose=False, augment=False)
    g = np.random.default_rng(7)
    lab = g.integers(0, K_CLS, 8).astype(np.int64)
    img = np.clip(g.random((8, 24, 24, 3), np.float32)
                  + 0.2 * lab[:, None, None, None], 0, 1).astype(np.float32)
    results = {}
    for name, mesh in (("single", None), ("mesh", port_mesh_of((2, 2)))):
        tr = HerlevTrainer(cfg, seed=1, mesh=mesh, device="cpu")
        tr.setup_optimizer_scheduler(1)
        results[name] = tr.train_epoch([(img, lab)], 1)
    np.testing.assert_allclose(results["single"][0], results["mesh"][0], rtol=2e-3)
    np.testing.assert_allclose(results["single"][1], results["mesh"][1], rtol=2e-3)
    assert results["single"][2] == results["mesh"][2]  # accuracy


def test_resume_on_mesh_continues_the_run(tmp_path):
    """A mesh run cut after stage 1's first epoch and resumed on the mesh
    ends on the bits of the uninterrupted mesh run."""
    images, masks = noisy_disks(n=4, size=16, seed=6)
    loader = ArrayLoader(images, masks, batch_size=4)
    cfg = {1: {"resolution": 8, "epochs_per_stage": 2, "lr": 3e-4}}

    def trainer(epochs):
        return UncertaintyGuidedProgressiveTrainer(
            stage_configs={1: dict(cfg[1], epochs_per_stage=epochs)}, seed=2, verbose=False,
            mesh=port_mesh_of((2, 1)), device="cpu", width=0.25)

    whole = trainer(2)
    want = whole.train_progressive(loader, loader, stages=[1], save_dir=str(tmp_path / "a"))
    trainer(1).train_progressive(loader, loader, stages=[1], save_dir=str(tmp_path / "b"),
                                 checkpoint_every=1)
    resumed = trainer(2)
    got = resumed.train_progressive(loader, loader, stages=[1], save_dir=str(tmp_path / "b"),
                                    resume=True)
    assert got["train_loss"] == want["train_loss"] and got["val_dice"] == want["val_dice"]
    for key, value in whole.models[1].state_dict().items():
        assert torch.equal(resumed.models[1].state_dict()[key], value), key


def test_axis_name_raises_at_the_train_step_as_jax():
    """JAX's trainers build with axis_name and raise NameError at the first
    train step (no program binds the axis), with or without a mesh, the
    axis on it or not; eval runs.  The port does the same."""
    images, masks = noisy_disks(n=4, size=8, seed=1)
    cfg = {1: {"resolution": 8, "epochs_per_stage": 1, "lr": 3e-4}}
    jt = JaxSegTrainer(stage_configs=cfg, verbose=False, width=0.125, axis_name="data",
                       mesh=jax_make_mesh(n_data=2, n_model=1))
    with pytest.raises(NameError, match="unbound axis name: data"):
        jt.train_epoch([(images, masks)], 1)
    for mesh, axis in ((None, "data"), (port_mesh_of((2, 1)), "data"),
                       (port_mesh_of((2, 1)), "foo")):
        tr = UncertaintyGuidedProgressiveTrainer(stage_configs=cfg, verbose=False, width=0.125,
                                                 axis_name=axis, mesh=mesh, device="cpu")
        with pytest.raises(NameError, match=f"unbound axis name: {axis}"):
            tr.train_epoch([(images, masks)], 1)
        assert np.isfinite(tr.validate_epoch([(images, masks)], 1)[0])
