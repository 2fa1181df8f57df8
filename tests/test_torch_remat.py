"""``remat=True`` in the port (``models/blocks.py``): every DoubleConv runs under
``torch.utils.checkpoint`` in training and is recomputed in the backward; cases
after ``tests/test_remat.py``.

Contract: the state dict is the same with and without it; the loss, the
gradients and the BN running stats (``num_batches_tracked`` too) are equal bit
for bit, in float32 and in the bf16 compute path, for segmentation and for the
classifier (dropout on, the same generator); the backward runs two more
convolutions per DoubleConv (the recompute), counted by a dispatch mode as
``tests/test_remat.py:100`` counts them in the jaxpr; the recompute leaves the
running stats alone; a train step ends where it ends without it.  The
MoNuSeg command line runs ``--remat`` with ``--pipeline_unc 1``.  Sizes: PGUNet2 at width 0.25 at 32 px, the classifier's stage 1 at 32 px,
batches of 2-4.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tests.test_torch_aug_trainer import tree  # noqa: F401  (the module-scoped fixture)
from ugpg_tpu_torch.cli import train_monuseg
from ugpg_tpu_torch.models.blocks import DoubleConv, init_parameters
from ugpg_tpu_torch.models.classifier import HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import PGUNet2
from ugpg_tpu_torch.train import aug_trainer
from ugpg_tpu_torch.train.optim import torch_rmsprop
from ugpg_tpu_torch.train.steps import make_seg_train_step


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread for this file's tests: the suite runs six test
    processes at once, where torch's default of a thread per core
    oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _pair(make):
    """The same model without and with remat, from one initialisation."""
    plain, remat = make(False), make(True)
    init_parameters(plain, torch.Generator().manual_seed(0))
    with torch.no_grad():  # non-trivial BN stats
        for m in plain.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1, generator=torch.Generator().manual_seed(1))
    remat.load_state_dict(plain.state_dict())
    assert list(plain.state_dict()) == list(remat.state_dict())
    return plain.train(), remat.train()


def _seg_loss(model, x, y):
    return ((torch.sigmoid(model(x)) - y) ** 2).mean()


def _assert_identical(plain, remat, l1, l2):
    assert l1.item() == l2.item()
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert torch.equal(p.grad, q.grad), name
    s1, s2 = plain.state_dict(), remat.state_dict()
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_remat_grads_and_bn_state_identical_seg(dtype):
    plain, remat = _pair(lambda r: PGUNet2(width=0.25, dtype=dtype, remat=r))
    assert all(m.remat for m in remat.modules() if isinstance(m, DoubleConv))
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.random((2, 3, 32, 32), dtype=np.float32))
    y = torch.from_numpy(g.random((2, 1, 32, 32), dtype=np.float32))
    l1, l2 = _seg_loss(plain, x, y), _seg_loss(remat, x, y)
    l1.backward()
    l2.backward()
    _assert_identical(plain, remat, l1, l2)
    assert int(remat.inc.conv.conv_op[1].num_batches_tracked) == 1  # the recompute added none


def test_remat_grads_identical_cls():
    plain, remat = _pair(lambda r: HerlevClassificationModel(1, 7, remat=r))
    x = torch.from_numpy(np.random.default_rng(2).random((2, 3, 32, 32), dtype=np.float32))
    losses = [(m(x, generator=torch.Generator().manual_seed(3)) ** 2).mean()
              for m in (plain, remat)]
    for loss in losses:
        loss.backward()
    _assert_identical(plain, remat, *losses)


class _CountConvs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_blocks_in_backward():
    """The backward of a remat model runs each DoubleConv's two convs again:
    two more convolutions per block (PGUNet2: inc, down3, down4, up1, up2)."""
    plain, remat = _pair(lambda r: PGUNet2(width=0.25, remat=r))
    x, y = torch.rand(2, 3, 32, 32), torch.rand(2, 1, 32, 32)
    counts = {}
    for name, model in (("plain", plain), ("remat", remat)):
        loss = _seg_loss(model, x, y)
        with _CountConvs() as mode:
            loss.backward()
        counts[name] = mode.n
    n_blocks = sum(isinstance(m, DoubleConv) for m in remat.modules())
    assert n_blocks == 5
    assert counts["remat"] == counts["plain"] + 2 * n_blocks, counts
    # no recompute where nothing is trained: eval mode, or no gradients
    with _CountConvs() as mode, torch.no_grad():
        remat(x)
    assert mode.n == 2 * n_blocks


@pytest.mark.parametrize("fused_loss,accum_steps", [(True, 1), (False, 2)])
def test_remat_train_step_equals_the_plain_step(fused_loss, accum_steps):
    """A stage-2 step with the frozen stage 1, augmented: the same metrics,
    parameters and BN state after the update, bit for bit."""
    prev = PGUNet2(width=0.25)  # any frozen source of uncertainty of the right size
    init_parameters(prev, torch.Generator().manual_seed(4))
    images = np.random.default_rng(5).random((4, 40, 40, 3), dtype=np.float32)
    masks = (np.random.default_rng(6).random((4, 40, 40, 1)) > 0.5).astype(np.float32)
    out = []
    for model in _pair(lambda r: PGUNet2(width=0.25, remat=r)):
        step = make_seg_train_step(model, torch_rmsprop(model.parameters(), 1e-4), 2, 32,
                                   prev_model=prev, prev_resolution=32, augment=True,
                                   fused_loss=fused_loss, accum_steps=accum_steps)
        out.append((step((images, masks), 5.0, torch.Generator().manual_seed(7)),
                    model.state_dict()))
    (m1, s1), (m2, s2) = out
    for k in m1:
        assert m1[k].item() == m2[k].item(), k
    for k in s1:
        assert torch.equal(s1[k], s2[k]), k


def test_monuseg_command_line_with_the_slice_flags(tree, tmp_path, monkeypatch,  # noqa: F811
                                                   capsys):
    """``train_monuseg --remat --pipeline_unc 1`` trains stages 1-2 on the CPU
    (width 0.25, 16/32 px, as ``tests/test_torch_cli_monuseg.py`` narrows it):
    remat models, stage 2 pipelined (``--tb_logdir``: the Herlev command's test
    in ``tests/test_torch_utils.py``).  On one card ``--pipeline_unc 1`` exits
    2 with the JAX package's message."""
    made = []
    init = aug_trainer.AugMoNuSegTrainer.__init__

    def narrow(self, config=None, **kwargs):
        init(self, config, width=0.25, **kwargs)
        made.append(self)

    monkeypatch.setattr(aug_trainer, "DEFAULT_STAGE_CONFIGS", {
        s: {**c, "resolution": r}
        for (s, c), r in zip(sorted(aug_trainer.DEFAULT_STAGE_CONFIGS.items()), (16, 32, 32, 32))})
    monkeypatch.setattr(aug_trainer.AugMoNuSegTrainer, "__init__", narrow)
    out = tmp_path / "out"
    argv = ["--data_dir", str(tree), "--output_dir", str(out), "--stages", "1", "2", "--epochs",
            "1", "--batch_size", "2", "--device", "cpu"]
    assert train_monuseg.cli([*argv, "--remat", "--pipeline_unc", "1"]) == 0
    tr, = made
    assert tr.models[2].inc.conv.remat and list(tr._pipelines) == [2]
    assert (out / "ug_pgunet_stage2_best.pth").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as info:
        train_monuseg.cli([*argv[:-1], "cuda", "--pipeline_unc", "1"])
    err = capsys.readouterr().err
    assert info.value.code == 2 and "n_unc=1 must leave at least one train device out of 1" in err
