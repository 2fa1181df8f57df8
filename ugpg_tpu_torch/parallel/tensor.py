"""Column-parallel serving of a model's wide convs over one row of a mesh
(``Predictor(mesh=..., shard_model=True)``).

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
"""

from __future__ import annotations

import copy
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ugpg_tpu_torch.models.blocks import DoubleConv
from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.cuda.double_conv import pack_conv
from ugpg_tpu_torch.ops.quant import _conv_i8, _epilogue, _QConv
from ugpg_tpu_torch.parallel.mesh import Mesh, param_shardings, shard_variables

__all__ = ["column_parallel"]

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
