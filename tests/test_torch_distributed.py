"""Training over several processes (``ugpg_tpu_torch/parallel/distributed.py``):
the JAX package's single-process units of ``ugpg_tpu/parallel/distributed.py``
(``tests/test_parallel.py:153-262``) one for one, with
``torch.distributed.init_process_group`` monkeypatched where those tests
monkeypatch ``jax.distributed.initialize``; then two gloo processes spawned
with ``torch.multiprocessing``, each with a one-device local mesh, against
one process driving the 2 x 1 mesh on the same global batch.

Every spawned group meets through a file under the test's ``tmp_path`` (no
port is fixed) and has a 60 s timeout, so that a missing peer fails the test
instead of hanging it.  This module imports only torch, numpy and the port
at its top, so that a spawned child imports no JAX.

Sizes: PGUNet1/PGUNet2 at width 0.25, stages at 16/32 px (the trainer at
8/16 px); the classifier's stages 1-2 at 8/16 px, three classes; global
batches of 8, 4 a process.  The images carry noise (``tests/
test_torch_mesh_train.py``: exact ties route gradients by rounding).
Tolerances: step-0 metrics, BN running stats and parameters rtol 2e-5
against the one-process mesh step; the parameters after the step bit for bit
equal across the processes.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ugpg_tpu_torch.data.synthetic import disk_dataset
from ugpg_tpu_torch.models.blocks import init_parameters
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS
from ugpg_tpu_torch.parallel import distributed
from ugpg_tpu_torch.parallel.mesh import make_mesh
from ugpg_tpu_torch.train.optim import torch_adam, torch_rmsprop
from ugpg_tpu_torch.train.steps import make_cls_train_step, make_seg_train_step

PW, K_CLS, BATCH = 5.0, 3, 8
TIMEOUT_S = 60


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the suite runs six test processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def no_cluster(monkeypatch):
    """No coordinator or torchrun variables; ``init_process_group`` records
    its arguments instead of meeting anyone."""
    for var in ("UGPG_COORDINATOR_ADDRESS", "WORLD_SIZE", "RANK", "MASTER_ADDR",
                "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.append(kw))
    return called


# ---------------------------------------------------------------- JAX's units
def test_distributed_initialize_noop_single_process(no_cluster):
    distributed.initialize()
    assert no_cluster == []
    assert distributed.is_multi_host() is False


def test_distributed_initialize_forwards_args(no_cluster):
    distributed.initialize("10.0.0.1:1234", num_processes=4, process_id=2)
    assert no_cluster == [{
        "backend": "gloo", "init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2,
        "timeout": datetime.timedelta(seconds=distributed.DEFAULT_TIMEOUT_S)}]
    distributed.initialize("file:///tmp/rdzv", num_processes=2, process_id=0, timeout=7)
    assert no_cluster[1]["init_method"] == "file:///tmp/rdzv"
    assert no_cluster[1]["timeout"] == datetime.timedelta(seconds=7)


def test_distributed_initialize_env_fallback(no_cluster, monkeypatch):
    monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "h0:9999")
    with pytest.raises(ValueError, match="no process count"):  # no rendezvous without one
        distributed.initialize()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    distributed.initialize()
    assert no_cluster and no_cluster[0]["init_method"] == "tcp://h0:9999"
    assert (no_cluster[0]["world_size"], no_cluster[0]["rank"]) == (2, 1)
    # torchrun without the coordinator variable: its MASTER_ADDR / MASTER_PORT
    monkeypatch.delenv("UGPG_COORDINATOR_ADDRESS")
    monkeypatch.setenv("MASTER_ADDR", "h1")
    distributed.initialize()
    assert no_cluster[1]["init_method"] is None and no_cluster[1]["world_size"] == 2


def test_host_batch_slice_arithmetic(monkeypatch):
    assert distributed.host_batch_slice(32) == slice(0, 32)  # one process
    monkeypatch.setattr(distributed, "world_size", lambda: 4)
    for pid in range(4):
        monkeypatch.setattr(distributed, "rank", lambda p=pid: p)
        assert distributed.host_batch_slice(32) == slice(pid * 8, pid * 8 + 8)
    with pytest.raises(ValueError, match="not divisible"):
        distributed.host_batch_slice(10)


def test_initialize_guard_does_not_touch_backend(no_cluster, monkeypatch):
    """With the backend named, ``initialize`` asks nothing of CUDA; with a
    process group already up it is a no-op."""
    def boom():
        raise AssertionError("initialize() touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_available", boom)
    distributed.initialize("10.0.0.2:5555", num_processes=2, process_id=0, backend="gloo")
    assert no_cluster and no_cluster[0]["init_method"] == "tcp://10.0.0.2:5555"
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    no_cluster.clear()
    distributed.initialize("10.0.0.2:5555", num_processes=2, process_id=0)
    assert no_cluster == []


def test_global_batch_assembles_on_fake_mesh():
    mesh = make_mesh(4, 2, devices=[torch.device("cpu", i) for i in range(8)])
    imgs = np.arange(8 * 4 * 4 * 3, dtype=np.float32).reshape(8, 4, 4, 3)
    masks = (imgs[..., :1] > imgs.mean()).astype(np.float32)
    parts = distributed.global_batch((imgs, masks), mesh)
    assert len(parts) == 4  # one part per data row
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy(), imgs)
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(), masks)
    assert parts[0][0].shape[0] == imgs.shape[0] // 4


def test_process_shard_gives_every_process_an_equal_disjoint_share(monkeypatch):
    data = list(range(11))
    assert distributed.process_shard(data) is data
    monkeypatch.setattr(distributed, "world_size", lambda: 3)
    shares = []
    for r in range(3):
        monkeypatch.setattr(distributed, "rank", lambda r=r: r)
        share = distributed.process_shard(data)
        shares.append([share[i] for i in range(len(share))])
    assert shares == [[0, 3, 6], [1, 4, 7], [2, 5, 8]]


def test_parse_mesh_joins_the_processes_first(no_cluster, monkeypatch):
    """``--mesh`` under a coordinator: gloo on the CPU, then this process's
    local mesh (``ugpg_tpu/cli/train_monuseg.py:115-134``)."""
    from ugpg_tpu_torch.cli import parse_mesh

    monkeypatch.setenv("UGPG_COORDINATOR_ADDRESS", "localhost:1234")
    monkeypatch.setenv("WORLD_SIZE", "2")
    mesh = parse_mesh("2", "cpu")
    assert mesh.shape == {"data": 2, "model": 1}
    assert no_cluster[0]["backend"] == "gloo"
    assert no_cluster[0]["init_method"] == "tcp://localhost:1234"
    no_cluster.clear()
    parse_mesh("2", "cpu", join=False)
    assert no_cluster == []


# ---------------------------------------------------------------- two processes
def _spawn(fn, tmp_path, *args):
    """Run ``fn(rank, out_dir, *args)`` in two gloo processes; each saves
    its result under ``tmp_path``; returns them in rank order.  A child that
    fails raises here; children still running after two timeouts are
    killed and the test fails."""
    ctx = mp.spawn(_child, args=(fn, str(tmp_path / "rdzv"), str(tmp_path), args), nprocs=2,
                   join=False)
    deadline = time.monotonic() + 2 * TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"the spawned processes did not finish in {2 * TIMEOUT_S} s")
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]


def _child(rank, fn, rdzv, out_dir, args):
    torch.set_num_threads(1)
    distributed.initialize(f"file://{rdzv}", num_processes=2, process_id=rank, backend="gloo",
                           timeout=TIMEOUT_S)
    try:
        torch.save(fn(rank, out_dir, *args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _noisy(n, size, seed):
    images, masks = disk_dataset(n, size, seed=seed)
    noise = np.random.default_rng(seed).standard_normal(images.shape).astype(np.float32)
    return np.clip(images + 0.05 * noise, 0.0, 1.0), masks


def _seg_models():
    prev = STAGE_MODELS[1](num_classes=1, width=0.25)
    model = STAGE_MODELS[2](num_classes=1, width=0.25)
    init_parameters(prev, torch.Generator().manual_seed(1))
    init_parameters(model, torch.Generator().manual_seed(2))
    return model, prev


def _seg_step(mesh, batch, rows):
    """Step 0 of stage 2 (fused loss, augmentation drawn from seed 3) on
    ``mesh`` over ``batch[rows]``: (metrics, state dict)."""
    model, prev = _seg_models()
    step = make_seg_train_step(model, torch_rmsprop(model.parameters(), 1e-4, weight_decay=1e-4),
                               2, 32, prev_model=prev, prev_resolution=16, augment=True,
                               fused_loss=True, mesh=mesh)
    m = step((batch[0][rows], batch[1][rows]), PW, torch.Generator().manual_seed(3))
    return _result(m, model)


def _seg_worker(rank, out_dir, batch):
    mesh = make_mesh(1, 1, devices=["cpu"])
    return _seg_step(mesh, batch, distributed.host_batch_slice(BATCH))


def _cls_step(mesh, batch, rows):
    """Step 0 of the classifier's stage 2 (augmentation and dropout drawn
    from seed 4, class weights) on ``mesh`` over ``batch[rows]``."""
    prev, model = HerlevClassificationModel(1, K_CLS), HerlevClassificationModel(2, K_CLS)
    init_parameters(prev, torch.Generator().manual_seed(5))
    init_parameters(model, torch.Generator().manual_seed(6))
    step = make_cls_train_step(model, torch_adam(model.parameters(), 1e-4), 2, 16, K_CLS,
                               prev_model=prev, prev_resolution=8, augment=True, normalize=True,
                               mesh=mesh)
    cw = torch.tensor([1.0, 2.0, 0.5])
    m = step((batch[0][rows], batch[1][rows]), cw, torch.Generator().manual_seed(4))
    return _result(m, model)


def _cls_worker(rank, out_dir, batch):
    return _cls_step(make_mesh(1, 1, devices=["cpu"]), batch, distributed.host_batch_slice(BATCH))


def _result(metrics, model):
    """(metrics, state dict after the step, the gradients it stepped on)."""
    return ({k: float(v) for k, v in metrics.items()}, model.state_dict(),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()})


def _assert_step(got, want, keys):
    """Metrics and BN running stats rtol 2e-5; the gradients, which sum the
    shards' parts in another order, rtol 1e-4 plus 1e-5 x the largest (the
    mesh tests' bound; RMSprop's first step then moves a near-zero
    gradient's parameter by a step of its sign, so the parameters are held
    through their gradients)."""
    metrics, state, grads = got
    for k in keys:
        np.testing.assert_allclose(metrics[k], want[0][k], rtol=2e-5, atol=1e-7, err_msg=k)
    for k, v in want[1].items():
        if "running" in k:
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=2e-5, atol=1e-7,
                                       err_msg=k)
    gmax = max(g.abs().max().item() for g in want[2].values())
    for k, g in want[2].items():
        np.testing.assert_allclose(grads[k].numpy(), g.numpy(), rtol=1e-4, atol=1e-5 * gmax,
                                   err_msg=k)


def _one_process_mesh():
    return make_mesh(2, 1, devices=[torch.device("cpu", i) for i in range(2)])


def test_two_processes_train_the_segmentation_step_of_one_process_mesh(tmp_path):
    images, masks = _noisy(BATCH, 32, seed=7)
    batch = (images, masks)
    runs = _spawn(_seg_worker, tmp_path, batch)
    want = _seg_step(_one_process_mesh(), batch, slice(None))
    for r in (0, 1):
        _assert_step(runs[r], want, want[0].keys())
    for k, v in runs[0][1].items():  # the same parameters and stats on both processes
        assert torch.equal(v, runs[1][1][k]), k


def test_two_processes_train_the_classification_step_of_one_process_mesh(tmp_path):
    rng = np.random.default_rng(8)
    batch = (rng.random((BATCH, 16, 16, 3)).astype(np.float32),
             rng.integers(0, K_CLS, BATCH).astype(np.int64))
    runs = _spawn(_cls_worker, tmp_path, batch)
    want = _cls_step(_one_process_mesh(), batch, slice(None))
    for r in (0, 1):
        _assert_step(runs[r], want, want[0].keys())
        assert runs[r][0]["count"] == BATCH
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


TRAINER_CFGS = {1: {"resolution": 8, "epochs_per_stage": 2, "lr": 3e-4},
                2: {"resolution": 16, "epochs_per_stage": 1, "lr": 1e-4}}


def _trainer_batches(part):
    """The loader of process ``part`` (None: the global batches): 16 train
    and 8 validation images, global batches of 8."""
    images, masks = _noisy(24, 16, seed=9)

    def batches(lo, hi):
        out = []
        for start in range(lo, hi, BATCH):
            idx = np.arange(start, start + BATCH)
            if part is not None:
                idx = idx[part * 4:(part + 1) * 4]
            out.append((images[idx], masks[idx]))
        return out

    return batches(0, 16), batches(16, 24)


def _trainer_run(mesh, part, save_dir, epochs):
    from ugpg_tpu_torch.train import seg_trainer

    saved = []
    real = seg_trainer.save_checkpoint
    seg_trainer.save_checkpoint = lambda path, *a, **k: (saved.append(os.path.basename(path)),
                                                         real(path, *a, **k))[1]
    try:
        cfgs = {s: dict(c, epochs_per_stage=epochs) for s, c in TRAINER_CFGS.items()}
        tr = seg_trainer.UncertaintyGuidedProgressiveTrainer(
            stage_configs=cfgs, verbose=False, width=0.25, augment=True, fused_loss=True,
            mesh=mesh, device="cpu")
        train, val = _trainer_batches(part)
        hist = tr.train_progressive(train, val, max_stages=1, save_dir=save_dir,
                                    checkpoint_every=1, resume=epochs > 1)
    finally:
        seg_trainer.save_checkpoint = real
    return hist, tr._model(1).state_dict(), saved


def _trainer_worker(rank, out_dir):
    mesh = make_mesh(1, 1, devices=["cpu"])
    save_dir = os.path.join(out_dir, "run")
    first = _trainer_run(mesh, rank, save_dir, epochs=1)
    resumed = _trainer_run(mesh, rank, save_dir, epochs=2)
    return first, resumed


def test_two_processes_train_an_epoch_and_resume_writing_from_process_0(tmp_path):
    """One stage-1 epoch across two processes, then a resumed second epoch:
    both processes hold the same history and weights, and only process 0
    writes (the log has one row per epoch).  Against one process training
    the 2 x 1 mesh on the global batches, as ``tests/test_torch_mesh_train.py``
    holds the mesh trainers to the unsharded one: the histories rtol 2e-2,
    the weights after RMSprop's steps mean |d| below 1e-4 and max below
    2e-2 (a near-zero gradient takes a step of its sign)."""
    runs = _spawn(_trainer_worker, tmp_path)
    want_first = _trainer_run(_one_process_mesh(), None, str(tmp_path / "one"), epochs=1)
    want = _trainer_run(_one_process_mesh(), None, str(tmp_path / "one"), epochs=2)
    assert runs[0][0][2] and runs[0][1][2] and not runs[1][0][2] and not runs[1][1][2]
    for r in (0, 1):
        for (hist, state, _), (w_hist, w_state, _) in zip(runs[r], (want_first, want)):
            for key in ("train_loss", "val_loss", "train_dice", "val_dice"):
                np.testing.assert_allclose(hist[key], w_hist[key], rtol=2e-2, err_msg=key)
            for k, v in w_state.items():
                d = (state[k].float() - v.float()).abs()
                assert d.mean() < 1e-4 and d.max() < 2e-2, (k, d.mean(), d.max())
    for k, v in runs[0][1][1].items():
        assert torch.equal(v, runs[1][1][1][k]), k
    log = (tmp_path / "run" / "training_log.csv").read_text().splitlines()
    assert len(log) == 3  # the header and one row per epoch


def _finetune(mesh, part, save_dir):
    """``finetune_native`` at stage 2 (fused loss, the frozen stage 1 as
    the uncertainty source), two epochs of one step over 32 x 36 slides,
    validated on them: process ``part``'s slide (None: both, batch 2)."""
    from ugpg_tpu_torch.train import seg_trainer

    saved = []
    real = seg_trainer.save_checkpoint
    seg_trainer.save_checkpoint = lambda path, *a, **k: (saved.append(os.path.basename(path)),
                                                         real(path, *a, **k))[1]
    try:
        tr = seg_trainer.UncertaintyGuidedProgressiveTrainer(verbose=False, width=0.25,
                                                             device="cpu", mesh=mesh,
                                                             fused_loss=True)
        images = np.random.default_rng(11).random((2, 32, 36, 3), dtype=np.float32)
        idx = [0, 1] if part is None else [part]
        slides = [(images[idx], (images[idx][..., :1] > 0.6).astype(np.float32))]
        hist = tr.finetune_native(slides, stage=2, epochs=2, val_loader=slides,
                                  save_dir=save_dir)
    finally:
        seg_trainer.save_checkpoint = real
    return hist, tr.models[2].state_dict(), saved


def _finetune_worker(rank, out_dir):
    return _finetune(make_mesh(1, 1, devices=["cpu"]), rank, out_dir)


def test_two_processes_finetune_native_as_one_process(tmp_path):
    """The spatial step across processes, each on its own slide: the first
    epoch (one step) is one process's step on both slides at rtol 2e-5,
    the second (after RMSprop's first update) within the mesh trainers'
    2e-2; both processes hold the same weights; only process 0 writes the
    ``_native.pth``."""
    runs = _spawn(_finetune_worker, tmp_path)
    want = _finetune(make_mesh(1, 1, devices=["cpu"]), None, str(tmp_path / "one"))
    assert runs[0][2] == ["ug_pgunet_stage2_native.pth"] and runs[1][2] == []
    for hist, _, _ in runs:
        for key in ("train_loss", "train_dice", "val_loss", "val_dice"):
            np.testing.assert_allclose(hist[key][0], want[0][key][0],
                                       rtol=2e-5 if key.startswith("train") else 2e-2,
                                       atol=1e-7, err_msg=key)
            np.testing.assert_allclose(hist[key][1], want[0][key][1], rtol=2e-2, err_msg=key)
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
