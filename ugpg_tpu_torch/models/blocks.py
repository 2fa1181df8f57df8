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

__all__ = ["DoubleConv", "InConv", "Down", "Up", "OutConv", "DownSample", "UpSample",
           "init_parameters"]

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


class DoubleConv(nn.Module):
    """(3x3 conv -> BN -> ReLU) x 2."""

    def __init__(self, in_channels: int, out_channels: int, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        self.compute_dtype = torch.float32  # bfloat16: the mixed-precision path (use_bn)
        self.remat = False  # recompute the block in the backward (use_bn, training)

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

    def _forward_bn(self, x: torch.Tensor, update_stats: bool = True) -> torch.Tensor:
        """The live-BN block; ``update_stats=False`` normalises as the
        training forward does but on copies of the running stats, so that
        the module's own stay as they are."""
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
        w = self.conv.weight.float().flatten(1)  # (K, C)
        y = x.float().permute(0, 2, 3, 1) @ w.t() + self.conv.bias.float()
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
