"""Column-parallel serving of a model's wide convs over one row of a mesh
(``Predictor(mesh=..., shard_model=True)``), and the data-parallel,
optionally column-parallel, forward of the mesh train and eval steps
(``ReplicaLayout``, ``replica_forward``, ``replica_features``).

The layout is the one ``parallel/mesh.py::param_shardings`` gives the
model's state dict over the row (the JAX package hands the same specs to
GSPMD), and each device's weights are its slice from ``shard_variables``:
a conv whose weights shard over ``model`` (at least 256 output channels
that divide) runs on each device's slice of its output channels, the
input copied there, and the slices gather on the row's first device in
channel order: the all-gather GSPMD computes.  Its bias and BN vectors,
which replicate, are cut to the same channels.  Other convs run there
whole.  Per kind of block:

* a BN-folded ``DoubleConv`` (``use_bn=False``) with a sharded conv runs
  both its convs as single ``conv3x3`` launches (the operator), the
  sharded one on slices of the folded weights packed per device;
* a live-BN ``DoubleConv`` (``fold_bn=False``) runs each sharded conv as
  ``F.conv2d``, its BN and its ReLU on the slice, in the block's compute
  dtype;
* an int8 conv (``ops/quant.py::_QConv``) splits the columns of its weight
  matrix, with their scales and biases, and runs ``_conv_i8`` and the
  epilogue per slice: int8 sums are exact, so every int8 point equals the
  unsharded one's.

``column_parallel`` returns a copy of the model that shares its tensors;
the model itself is left as it was (the predictor exports it).

Training on a mesh (``train/steps.py``): a batch splits over the ``data``
axis, shard i on data row i's first device, and the model's blocks run
over the shards in lock-step (``DoubleConv.forward_parts``), so that BN
takes the statistics of the whole batch.  There is one set of parameters,
on the trainer's device: every conv copies its weights to each shard's
device inside the forward (``models/blocks.py::conv_part``), so autograd
sums the replicas' gradients into the one set and one optimizer update
keeps every replica equal; on one device named twice the copy is the
tensor itself.  With ``shard_model`` a conv that ``param_shardings``
shards over ``model`` runs each column slice on the row's device for it,
and the slices gather back (``torch.cat`` of differentiable copies)
before BN, which runs on all the conv's channels.  The layout is
recomputed from the parameters at every step, so no optimizer update can
lose it.
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ugpg_tpu_torch.models.blocks import DoubleConv, conv_part
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, block_double_conv, stage_topology
from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.cuda.double_conv import pack_conv
from ugpg_tpu_torch.ops.quant import _conv_i8, _epilogue, _QConv
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners
from ugpg_tpu_torch.parallel.mesh import (
    Mesh,
    data_axis_size,
    param_shardings,
    shard_variables,
    tp_sharded,
)
from ugpg_tpu_torch.parallel.spatial import GridOps

__all__ = ["column_parallel", "ReplicaLayout", "replica_forward", "replica_features"]

_CL = torch.channels_last


def _column_slices(placed: list[dict], key: str, devices, n_out: int) -> list:
    """[(device, its weight slice or None, its output channels)] of the
    weights ``key`` with ``n_out`` output channels: the row's slices when
    ``shard_variables`` split them, else (None: the whole) on the row's
    first device."""
    if key not in placed[0]:
        return [(devices[0], None, slice(None))]
    size = n_out // len(devices)
    return [(dev, view[key], slice(j * size, (j + 1) * size))
            for j, (dev, view) in enumerate(zip(devices, placed))]


def _gather(outs: list[torch.Tensor], home: torch.device, dim: int) -> torch.Tensor:
    if len(outs) == 1:
        return outs[0]
    return torch.cat([o.to(home, non_blocking=True) for o in outs], dim=dim)


class _ColumnParallelDoubleConv(nn.Module):
    """A ``DoubleConv`` with its sharded convs split over ``devices``
    (``placed``: each device's ``shard_variables`` view, ``prefix``: the
    block's name in the state dict)."""

    def __init__(self, block: DoubleConv, devices, placed: list[dict], prefix: str):
        super().__init__()
        self.use_bn = block.use_bn
        self.compute_dtype = block.compute_dtype
        self.convs = []  # per conv: [(device, weights of its output slice)]
        for slot in (0, 3):
            conv, bn = block.conv_op[slot], block.conv_op[slot + 1]
            self.convs.append([
                (dev, self._slice(conv, bn, conv.weight.to(dev) if w is None else w, cols, dev))
                for dev, w, cols in _column_slices(placed, f"{prefix}.conv_op.{slot}.weight",
                                                   devices, conv.weight.shape[0])])

    def _slice(self, conv, bn, w, cols: slice, dev: torch.device) -> tuple:
        w = w.contiguous()
        b = conv.bias[cols].to(dev)
        if not self.use_bn:
            b = b.float().contiguous()
            return w, b, pack_conv(w), b
        return w, b, *(t[cols].to(dev) for t in (bn.running_mean, bn.running_var, bn.weight,
                                                 bn.bias)), bn.eps

    def _one(self, x: torch.Tensor, weights: tuple) -> torch.Tensor:
        if not self.use_bn:
            return library.conv3x3(x.contiguous(memory_format=_CL), *weights)
        w, b, mean, var, gamma, beta, eps = weights  # the block's eval path, on the slice
        cd = self.compute_dtype
        y = F.conv2d(x.to(cd), w.to(cd), padding=1) + b.to(cd)[:, None, None]
        y = F.batch_norm(y.float(), mean, var, gamma, beta, False, 0.0, eps)
        return F.relu(y.to(cd))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        home = x.device
        for slices in self.convs:
            x = _gather([self._one(x.to(dev, non_blocking=True), w) for dev, w in slices],
                        home, dim=1)
        return x.contiguous(memory_format=_CL) if not self.use_bn else x


class _ColumnParallelQConv(nn.Module):
    """An int8 conv with the columns of its weight matrix split over
    ``devices``, the slices ``shard_variables`` placed."""

    def __init__(self, qconv: _QConv, devices, placed: list[dict], key: str):
        super().__init__()
        self.slices = [
            (dev, w, qconv.scale[cols].to(dev), qconv.bias[cols].to(dev), qconv.recip.to(dev))
            for dev, w, cols in _column_slices(placed, key, devices, qconv.scale.shape[0])]

    def forward(self, xq: torch.Tensor) -> torch.Tensor:
        outs = [_conv_i8(xq.to(dev, non_blocking=True), w,
                         lambda acc, s=s, b=b, r=r: _epilogue(acc, s, b, r))
                for dev, w, s, b, r in self.slices]
        return _gather(outs, xq.device, dim=-1)


def column_parallel(model: nn.Module, devices: Sequence[torch.device]) -> nn.Module:
    """A copy of ``model`` (sharing its tensors) whose DoubleConvs and int8
    convs with weights that ``param_shardings`` shards over a (1, n)
    ``model`` row of ``devices`` run column-parallel over them, the first
    of them the model's own device.  ``model`` is unchanged."""
    devices = [torch.device(d) for d in devices]
    mesh = Mesh([devices], ("data", "model"))
    state = model.state_dict()
    specs = param_shardings(state, mesh)
    sharded = shard_variables({k: t for k, t in state.items() if "model" in specs[k].spec},
                              mesh)
    placed = [sharded[0, j] for j in range(len(devices))]
    tensors = list(model.parameters()) + list(model.buffers())
    twin = copy.deepcopy(model, memo={id(t): t for t in tensors})
    for name, child in list(twin.named_modules()):
        if isinstance(child, DoubleConv) and any(
                f"{name}.conv_op.{slot}.weight" in placed[0] for slot in (0, 3)):
            wrapped = _ColumnParallelDoubleConv(child, devices, placed, name)
        elif isinstance(child, _QConv) and f"{name}.w" in placed[0]:
            wrapped = _ColumnParallelQConv(child, devices, placed, f"{name}.w")
        else:
            continue
        parent, _, attr = name.rpartition(".")
        setattr(twin.get_submodule(parent), attr, wrapped)
    return twin


# ---------------------------------------------------------------- training on a mesh
class ReplicaLayout:
    """Where a data-parallel step runs: batch shard i on ``rows[i][0]``
    (``mesh.py::shard_batch``), ``rows[i]`` the devices of its ``model``
    slices; with ``shard_model`` (and a ``model`` axis) the convs
    ``param_shardings`` shards run column-parallel over the row."""

    def __init__(self, mesh: Mesh, shard_model: bool = True):
        n_data = data_axis_size(mesh)
        n_model = mesh.shape.get("model", 1)
        self.mesh = mesh
        self.rows = [[mesh.device_at(data=i, model=j) for j in range(n_model)]
                     for i in range(n_data)]
        self.n_model = n_model if shard_model else 1

    def conv(self, parts, conv: nn.Conv2d, dtype: torch.dtype):
        """One conv + bias over the shards (``DoubleConv.forward_parts``'s
        ``conv``): whole on each shard's device, or column slices over its
        row, gathered in channel order."""
        n_out = conv.weight.shape[0]
        if not tp_sharded(n_out, self.n_model):
            return [[conv_part(p, conv, dtype) for p in row] for row in parts]
        size = n_out // self.n_model
        out = []
        for (p,), devices in zip(parts, self.rows):
            slices = [conv_part(p.to(dev, non_blocking=True), conv, dtype,
                                slice(j * size, (j + 1) * size))
                      for j, dev in enumerate(devices)]
            out.append([_gather(slices, p.device, dim=1)])
        return out


class _ReplicaOps(GridOps):
    """``stage_topology``'s blocks on shards that split the batch: each
    resize per shard at its own size, as the unsharded model's."""

    def __init__(self, model: nn.Module, layout: ReplicaLayout):
        self.model, self.layout = model, layout

    def dc(self, t, name):
        return block_double_conv(self.model, name).forward_parts(t, self.layout.conv)

    def hw(self, t) -> tuple[int, int]:
        return tuple(t[0][0].shape[2:])

    def resize(self, t, hw):
        return [[resize_bilinear_align_corners(p, hw) for p in row] for row in t]

    def head(self, t, name):
        head = self.model.get_submodule(name)
        return [[head(p) for p in row] for row in t]


def replica_forward(model: nn.Module, parts: list, layout: ReplicaLayout) -> list:
    """A live-BN PGUNet stage on batch shards (one NCHW tensor per data
    row, on its device): the float32 logits per shard.  In train mode BN
    takes the whole batch's statistics; in eval mode each shard its
    running stats."""
    stage = next(s for s, cls in STAGE_MODELS.items() if isinstance(model, cls))
    grid = stage_topology(stage, _ReplicaOps(model, layout), [[p] for p in parts])
    return [row[0] for row in grid]


def replica_features(model: nn.Module, parts: list, layout: ReplicaLayout) -> list:
    """A live-BN ``HerlevClassificationModel``'s pooled encoder features
    (N_i, 512) per batch shard, as ``model.features`` gives them."""
    enc = model.unet
    grid = enc.inc.conv.forward_parts([[p] for p in parts], layout.conv)
    for name in enc.downs:
        grid = block_double_conv(enc, name).forward_parts(
            [[F.max_pool2d(p, 2)] for (p,) in grid], layout.conv)
    return [p.float().mean(dim=(2, 3)) for (p,) in grid]

