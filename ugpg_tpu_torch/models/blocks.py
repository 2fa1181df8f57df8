"""U-Net building blocks (counterpart of ``ugpg_tpu/models/blocks.py``).

Modules are NCHW-logical and keep the reference torch layout's names
(``conv_op.{0,1,3,4}``, ``mpconv.1``, ``conv``), so a ``.pth`` written by
``ugpg-export-torch`` loads with strict ``load_state_dict``.

``use_bn=True``: Conv -> BatchNorm (eps 1e-5) -> ReLU in plain PyTorch,
the layout of the parity tests and of training.  A ``DoubleConv`` whose
``compute_dtype`` is bfloat16 computes as the flax module with
``dtype=bfloat16`` does, over float32 parameters: each conv on bf16
inputs and weights, its bias added in bf16, the BN statistics and the
normalisation in float32 with a bf16 result.  ``use_bn=False``: the
BN-folded inference path (``models/folding.py``); ``DoubleConv`` runs the
double-conv kernels and ``Up`` the 2x upsample kernel, through their
operators (``ops/cuda/library.py``), so that an exported graph calls them
too.  BN slots 1 and 4 then hold ``nn.Identity`` so that the parameter
names do not shift.

``remat=True`` (a ``DoubleConv`` attribute; the stages and the
classifier set it on every block): in training with gradients on, the
block runs under ``torch.utils.checkpoint`` and its internal activations
are recomputed in the backward from the block's input instead of kept, as
``nn.remat`` does in the JAX package.  The recompute uses the same batch
statistics but updates no BN running stat: the first pass updates them
once, the second normalises through copies, so the gradients and the BN
state equal those without ``remat`` bit for bit.

``DoubleConv.forward_parts``: the block over a grid of shards of one
batch (split by batch or by space, on one device or several), as the mesh
steps of ``parallel/`` run it in lock-step: each conv through the caller's
``conv`` (per shard by default; halo-extended or column-parallel there),
and in training BN with the statistics of the whole batch
(``cross_replica_batch_norm``: the JAX package's ``pmean`` over the
model's ``axis_name``, what GSPMD gives its mesh trainers), the running
stats updated once.  ``remat`` then checkpoints the whole grid's block.

``axis_name`` (a ``DoubleConv`` attribute the trainers set): as in the JAX
package, where no program binds the axis, a training forward raises
``NameError`` (JAX's unbound-axis error); eval forwards run.

``DownSample`` and ``UpSample`` are the legacy ``UNet``'s blocks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ugpg_tpu_torch.ops.cuda import library
from ugpg_tpu_torch.ops.cuda.double_conv import pack_double_conv
from ugpg_tpu_torch.ops.resize import upsample2x_bilinear_align_corners
from ugpg_tpu_torch.parallel import distributed

__all__ = ["DoubleConv", "InConv", "Down", "Up", "OutConv", "DownSample", "UpSample",
           "init_parameters", "conv_part", "cross_replica_batch_norm"]

BN_EPS = 1e-5
_PACKED = ("packed_w1", "packed_b1", "packed_w2", "packed_b2")  # DoubleConv.pack's buffers


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default initialisation of every conv and linear layer
    (kaiming-uniform weight, uniform(+-1/sqrt(fan_in)) bias), drawn from
    ``generator``; BN layers keep their ones/zeros."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=5 ** 0.5, generator=generator)
            bound = 1.0 / (m.weight[0].numel() ** 0.5)
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)


def conv_part(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype,
              cols: slice = slice(None)) -> torch.Tensor:
    """``conv``'s 3x3 conv + bias on ``x`` (zero padding 1), as the live-BN
    block computes it in ``dtype``, with its weights copied to ``x``'s
    device (a differentiable copy: their gradients flow back to the
    parameters); ``cols``: only those output channels."""
    dev = x.device
    w, b = conv.weight[cols].to(dev, dtype), conv.bias[cols].to(dev, dtype)
    if dtype == torch.float32:
        return F.conv2d(x, w, b, padding=1)
    return F.conv2d(x, w, padding=1) + b[:, None, None]


def cross_replica_batch_norm(parts: list[torch.Tensor], bn: nn.BatchNorm2d,
                             update_stats: bool = True) -> list[torch.Tensor]:
    """Train-mode BN of float32 NCHW ``parts`` with the statistics of their
    union (the parts may lie on several devices): per part its count, mean
    and centred sum of squares, combined on ``bn``'s device by Chan's
    formula (``M2 = sum M2_i + sum n_i (mean_i - mean)^2``; E[x^2] - E[x]^2
    cancels in float32 at full width).  Each part is normalised by the
    biased variance; the running stats take the unbiased one, once, with
    ``bn``'s momentum (``update_stats=False``: left as they are).

    Over several processes (``parallel/distributed.py``) the union is every
    process's parts: their moments are gathered, differentiably, and
    combined in global part order (process-major, then the local parts),
    so 2 processes of 1 part do the arithmetic of one process of 2.  Every
    process's parts have this one's shapes (the trainers check it)."""
    home = bn.weight.device
    counts = [p.numel() // p.shape[1] for p in parts]
    means = [p.mean(dim=(0, 2, 3)) for p in parts]
    m2s = [(p - m[:, None, None]).square().sum(dim=(0, 2, 3)) for p, m in zip(parts, means)]
    if distributed.world_size() > 1:
        moments = distributed.gather_parts(
            torch.stack([torch.stack([m.to(home), s.to(home)]) for m, s in zip(means, m2s)]))
        moments = moments.flatten(0, 1)  # (P * parts, 2, C) in global order
        counts = counts * distributed.world_size()
        means, m2s = list(moments[:, 0]), list(moments[:, 1])
    n = sum(counts)
    means = [m.to(home) for m in means]
    mean = sum(c * m for c, m in zip(counts, means)) / n
    m2 = sum(s.to(home) + c * (m - mean).square() for c, m, s in zip(counts, means, m2s))
    if update_stats:
        with torch.no_grad():
            bn.running_mean.mul_(1.0 - bn.momentum).add_(bn.momentum * mean)
            bn.running_var.mul_(1.0 - bn.momentum).add_(bn.momentum * m2 / max(n - 1, 1))
            bn.num_batches_tracked.add_(1)
    scale = torch.rsqrt(m2 / n + bn.eps) * bn.weight
    out = []
    for p in parts:
        dev = p.device
        out.append((p - mean.to(dev)[:, None, None]) * scale.to(dev)[:, None, None]
                   + bn.bias.to(dev)[:, None, None])
    return out


def _per_part(parts, conv: nn.Conv2d, dtype: torch.dtype):
    return [[conv_part(p, conv, dtype) for p in row] for row in parts]


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) x 2."""

    def __init__(self, in_channels: int, out_channels: int, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        self.compute_dtype = torch.float32  # bfloat16: the mixed-precision path (use_bn)
        self.remat = False  # recompute the block in the backward (use_bn, training)
        self.axis_name = None  # the JAX module's BN axis (the trainers' axis_name)

        def norm():
            return nn.BatchNorm2d(out_channels, eps=BN_EPS) if use_bn else nn.Identity()

        self.conv_op = nn.Sequential(
            nn.Conv2d(in_channels, out_channels, 3, padding=1),
            norm(),
            nn.ReLU(),
            nn.Conv2d(out_channels, out_channels, 3, padding=1),
            norm(),
            nn.ReLU(),
        )

        for name in _PACKED:
            self.register_buffer(name, None, persistent=False)

    def pack(self) -> None:
        """Keep the kernels' layout of the current weights
        (``pack_double_conv``) in non-persistent buffers, so that a call
        does not repack; the state dict does not change.  A snapshot: call
        again after changing the weights."""
        c1, c2 = self.conv_op[0], self.conv_op[3]
        with torch.no_grad():
            for name, t in zip(_PACKED, pack_double_conv(c1.weight, c1.bias, c2.weight, c2.bias)):
                setattr(self, name, t)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_bn:
            if self.remat and self.training and torch.is_grad_enabled():
                passes = iter((True, False))  # the forward, then the recompute
                return checkpoint(lambda t: self._forward_bn(t, next(passes, False)), x,
                                  use_reentrant=False, preserve_rng_state=False)
            return self._forward_bn(x)
        c1, c2 = self.conv_op[0], self.conv_op[3]
        return library.fused_double_conv(x, c1.weight, c1.bias, c2.weight, c2.bias,
                                         *(getattr(self, n) for n in _PACKED))

    def _check_axis(self) -> None:
        if self.axis_name is not None and self.training:
            raise NameError(
                f"Found an unbound axis name: {self.axis_name}.  A training forward of a "
                "block with axis_name runs where a program binds that axis; no trainer or "
                "mesh step does (the JAX package raises the same)")

    def forward_parts(self, parts: list[list[torch.Tensor]], conv=None,
                      dtype: torch.dtype | None = None, check_axis: bool = True):
        """The live-BN block over a grid of NCHW shards of one batch (rows
        of parts, any devices), in lock-step; returns the grid of outputs.
        ``conv(parts, conv_module, dtype)``: one 3x3 conv + bias over the
        grid (default: ``conv_part`` per shard).  In training, BN takes the
        whole grid's statistics (``cross_replica_batch_norm``), else each
        shard runs the eval path.  ``dtype``: the compute dtype (default
        the block's).  ``check_axis=False``: ``axis_name`` is not looked at
        (the spatial steps, whose JAX counterpart never runs the module)."""
        if check_axis:
            self._check_axis()
        if self.remat and self.training and torch.is_grad_enabled():
            passes = iter((True, False))  # the forward, then the recompute
            shape = [len(row) for row in parts]

            def run(*flat):
                it = iter(flat)
                grid = [[next(it) for _ in range(k)] for k in shape]
                out = self._forward_parts(grid, conv, dtype, next(passes, False))
                return tuple(t for row in out for t in row)

            flat = iter(checkpoint(run, *(t for row in parts for t in row),
                                   use_reentrant=False, preserve_rng_state=False))
            return [[next(flat) for _ in range(k)] for k in shape]
        return self._forward_parts(parts, conv, dtype)

    def _forward_parts(self, parts, conv, dtype, update_stats: bool = True):
        cd = dtype or self.compute_dtype
        conv = conv or _per_part
        x = [[p.to(cd) for p in row] for row in parts]
        for c, bn in ((self.conv_op[0], self.conv_op[1]), (self.conv_op[3], self.conv_op[4])):
            y = [[t.float() for t in row] for row in conv(x, c, cd)]
            if self.training:
                flat = cross_replica_batch_norm([t for row in y for t in row], bn, update_stats)
                it = iter(flat)
                y = [[next(it) for _ in row] for row in y]
            else:
                y = [[F.batch_norm(t, bn.running_mean.to(t.device), bn.running_var.to(t.device),
                                   bn.weight.to(t.device), bn.bias.to(t.device), False, 0.0,
                                   bn.eps) for t in row] for row in y]
            x = [[F.relu(t.to(cd)) for t in row] for row in y]
        return x

    def _forward_bn(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """The live-BN block; ``update_stats=False`` normalises as the
        training forward does but on copies of the running stats, so that
        the module's own stay as they are."""
        self._check_axis()
        cd = self.compute_dtype
        mixed = cd != torch.float32
        if mixed:
            x = x.to(cd)
        for conv, bn in ((self.conv_op[0], self.conv_op[1]), (self.conv_op[3], self.conv_op[4])):
            if mixed:
                x = F.conv2d(x, conv.weight.to(cd), padding=1) + conv.bias.to(cd)[:, None, None]
                y = x.float()
            else:
                y = conv(x)
            if update_stats:
                y = bn(y)
            else:
                y = F.batch_norm(y, bn.running_mean.clone(), bn.running_var.clone(), bn.weight,
                                 bn.bias, bn.training, bn.momentum, bn.eps)
            x = F.relu(y.to(cd))
        return x


class InConv(nn.Module):
    """Entry block: one DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int, use_bn: bool = True):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels, use_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Down(nn.Module):
    """MaxPool(2) -> DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int, use_bn: bool = True):
        super().__init__()
        self.mpconv = nn.Sequential(nn.MaxPool2d(2), DoubleConv(in_channels, out_channels, use_bn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mpconv(x)


class Up(nn.Module):
    """Bilinear 2x upsample (align_corners) -> concat [skip, up] -> DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        self.conv = DoubleConv(in_channels, out_channels, use_bn)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        if self.use_bn:
            x1 = upsample2x_bilinear_align_corners(x1)
        else:
            x1 = library.upsample2x(x1)
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    """1x1 logits head, always computed in float32 (as a matmul, which
    PyTorch runs in full float32 on the GPU by default)."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the weights go to x's device: a sharded forward's shard may lie elsewhere
        w = self.conv.weight.float().flatten(1).to(x.device)  # (K, C)
        y = x.float().permute(0, 2, 3, 1) @ w.t() + self.conv.bias.float().to(x.device)
        return y.permute(0, 3, 1, 2)


class DownSample(nn.Module):
    """Legacy: DoubleConv -> MaxPool(2); returns (before the pool, pooled)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        down = self.conv(x)
        return down, F.max_pool2d(down, 2)


class UpSample(nn.Module):
    """Legacy: ConvTranspose(k 2, stride 2, half the channels) -> concat
    [up, skip] -> DoubleConv."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = nn.ConvTranspose2d(in_channels, in_channels // 2, kernel_size=2, stride=2)
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([self.up(x1), x2], dim=1))
