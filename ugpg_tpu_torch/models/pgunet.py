"""Progressive-Growing U-Net stages (counterpart of ``ugpg_tpu/models/pgunet.py``).

Channel widths are inverted against a classic U-Net (stage 1 widest), every
stage keeps a 16x16 bottleneck, and the output is the sum of multi-scale
1x1 heads, each bilinearly upsampled (align_corners=True) to the stage
resolution.  Submodule names (``inc``, ``down1..4``, ``up1..4``,
``outc*``) match across stages and the reference torch layout.

``in_channels`` is the input's channel count (3, RGB, by default).
``dtype`` is the compute dtype of the body; the heads and the summed
logits stay float32.  With ``use_bn=False`` (serving on folded weights)
the body's parameters are cast to ``dtype``, as the kernels take them.
With ``use_bn=True`` (training, live BN) the parameters stay float32 and
every DoubleConv computes in ``dtype``, BN statistics in float32
(``blocks.py``), as the flax stages do.  ``remat=True`` recomputes every
DoubleConv in the backward (``blocks.py``).  Inputs are NCHW; the logits
are (N, num_classes, H, W) float32.

``stage_topology`` is the same walk over blocks that a caller supplies:
the sharded forwards of ``parallel/`` run it on grids of shards.

``UNet`` is the legacy classic U-Net, kept for the reference's API.
"""

from __future__ import annotations

import torch
from torch import nn

from ugpg_tpu_torch.models.blocks import DoubleConv, Down, DownSample, InConv, OutConv, Up, UpSample
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["PGUNet1", "PGUNet2", "PGUNet3", "PGUNet4", "STAGE_BLOCKS", "STAGE_MODELS",
           "STAGE_RESOLUTIONS", "UNet", "stage_topology", "block_double_conv"]

STAGE_RESOLUTIONS = {1: 32, 2: 64, 3: 128, 4: 256}


def _scaled(n: int, width: float) -> int:
    """Scale a reference channel count by the width multiplier (min 8)."""
    return max(8, round(n * width))


class _Stage(nn.Module):
    """Shared constructor: ``_build`` the submodules, then set the body's
    dtype: cast all but the heads to ``dtype`` (``use_bn=False``), or make
    it every DoubleConv's compute dtype (``use_bn=True``), and ``remat``."""

    def __init__(self, num_classes: int = 1, use_bn: bool = True, width: float = 1.0,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.in_channels = in_channels
        c = lambda n: _scaled(n, width)  # noqa: E731
        self._build(c, use_bn, num_classes)
        for name, child in self.named_children():
            if name.startswith("outc"):
                continue
            if not use_bn:
                child.to(dtype)
                continue
            for block in child.modules():
                if isinstance(block, DoubleConv):
                    block.compute_dtype, block.remat = dtype, remat

    def _build(self, c, use_bn: bool, k: int) -> None:
        raise NotImplementedError

    @staticmethod
    def _sum_heads(heads) -> torch.Tensor:
        """Sum of head logits, each upsampled to the last head's size."""
        res = heads[-1].shape[-2:]
        out = None
        for h in heads:
            h = resize_bilinear_align_corners(h, res)
            out = h if out is None else out + h
        return out


class PGUNet1(_Stage):
    """Stage 1, 32px: inc -> down4 -> up1 -> outc."""

    def _build(self, c, ub, k):
        self.inc = InConv(self.in_channels, c(512), ub)
        self.down4 = Down(c(512), c(512), ub)
        self.up1 = Up(2 * c(512), c(256), ub)
        self.outc = OutConv(c(256), k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x.to(self.dtype))
        x2 = self.down4(x1)
        return self.outc(self.up1(x2, x1))


class PGUNet2(_Stage):
    """Stage 2, 64px."""

    def _build(self, c, ub, k):
        self.inc = InConv(self.in_channels, c(256), ub)
        self.down3 = Down(c(256), c(512), ub)
        self.down4 = Down(c(512), c(512), ub)
        self.up1 = Up(2 * c(512), c(256), ub)
        self.up2 = Up(2 * c(256), c(128), ub)
        self.outc1 = OutConv(c(256), k)
        self.outc2 = OutConv(c(128), k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x.to(self.dtype))
        x2 = self.down3(x1)
        x3 = self.down4(x2)
        x4 = self.up1(x3, x2)
        x5 = self.up2(x4, x1)
        return self._sum_heads([self.outc1(x4), self.outc2(x5)])


class PGUNet3(_Stage):
    """Stage 3, 128px."""

    def _build(self, c, ub, k):
        self.inc = InConv(self.in_channels, c(128), ub)
        self.down2 = Down(c(128), c(256), ub)
        self.down3 = Down(c(256), c(512), ub)
        self.down4 = Down(c(512), c(512), ub)
        self.up1 = Up(2 * c(512), c(256), ub)
        self.up2 = Up(2 * c(256), c(128), ub)
        self.up3 = Up(2 * c(128), c(64), ub)
        self.outc1 = OutConv(c(256), k)
        self.outc2 = OutConv(c(128), k)
        self.outc3 = OutConv(c(64), k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x.to(self.dtype))
        x2 = self.down2(x1)
        x3 = self.down3(x2)
        x4 = self.down4(x3)
        x5 = self.up1(x4, x3)
        x6 = self.up2(x5, x2)
        x7 = self.up3(x6, x1)
        return self._sum_heads([self.outc1(x5), self.outc2(x6), self.outc3(x7)])


class PGUNet4(_Stage):
    """Stage 4, 256px."""

    def _build(self, c, ub, k):
        self.inc = InConv(self.in_channels, c(64), ub)
        self.down1 = Down(c(64), c(128), ub)
        self.down2 = Down(c(128), c(256), ub)
        self.down3 = Down(c(256), c(512), ub)
        self.down4 = Down(c(512), c(512), ub)
        self.up1 = Up(2 * c(512), c(256), ub)
        self.up2 = Up(2 * c(256), c(128), ub)
        self.up3 = Up(2 * c(128), c(64), ub)
        self.up4 = Up(2 * c(64), c(64), ub)
        self.outc1 = OutConv(c(256), k)
        self.outc2 = OutConv(c(128), k)
        self.outc3 = OutConv(c(64), k)
        self.outc4 = OutConv(c(64), k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1 = self.inc(x.to(self.dtype))
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x6 = self.up1(x5, x4)
        x7 = self.up2(x6, x3)
        x8 = self.up3(x7, x2)
        x9 = self.up4(x8, x1)
        return self._sum_heads(
            [self.outc1(x6), self.outc2(x7), self.outc3(x8), self.outc4(x9)])


STAGE_MODELS = {1: PGUNet1, 2: PGUNet2, 3: PGUNet3, 4: PGUNet4}

# the child blocks of each stage's model, by name
STAGE_BLOCKS = {
    1: ("inc", "down4", "up1", "outc"),
    2: ("inc", "down3", "down4", "up1", "up2", "outc1", "outc2"),
    3: ("inc", "down2", "down3", "down4", "up1", "up2", "up3", "outc1", "outc2", "outc3"),
    4: ("inc", "down1", "down2", "down3", "down4", "up1", "up2", "up3", "up4", "outc1",
        "outc2", "outc3", "outc4"),
}


def block_double_conv(model: nn.Module, name: str) -> DoubleConv:
    """The DoubleConv of a stage's (or an encoder's) block ``name``."""
    block = model.get_submodule(name)
    return block.mpconv[1] if isinstance(block, Down) else block.conv


def stage_topology(stage: int, ops, x):
    """The stage's forward (the ``PGUNet*.forward`` methods' walk) over
    ``ops``, which supplies ``dc(x, name)`` (the named block's DoubleConv,
    after the max-pool of a ``down`` block: ``pool``), ``up`` (the 2x
    bilinear upsample), ``cat(skip, up)`` and ``heads(features, names)``
    (the 1x1 heads, each upsampled to the last one's size, summed)."""
    dc, pool, up, cat = ops.dc, ops.pool, ops.up, ops.cat
    downs = {1: ("down4",), 2: ("down3", "down4"), 3: ("down2", "down3", "down4"),
             4: ("down1", "down2", "down3", "down4")}.get(stage)
    if downs is None:
        raise ValueError(f"stage must be 1..4, got {stage}")
    skips = [dc(x, "inc")]
    for name in downs:
        skips.append(dc(pool(skips[-1]), name))
    x = skips.pop()
    feats = []
    for i in range(len(downs)):
        x = dc(cat(skips.pop(), up(x)), f"up{i + 1}")
        feats.append(x)
    names = ("outc",) if stage == 1 else tuple(f"outc{i + 1}" for i in range(len(feats)))
    return ops.heads(feats, names)


class UNet(nn.Module):
    """Legacy classic U-Net (64 -> 1024 -> 64 channels, transposed-conv
    upsampling), float32, BN live; input sides divisible by 16."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1):
        super().__init__()
        self.down_convolution_1 = DownSample(in_channels, 64)
        self.down_convolution_2 = DownSample(64, 128)
        self.down_convolution_3 = DownSample(128, 256)
        self.down_convolution_4 = DownSample(256, 512)
        self.bottle_neck = DoubleConv(512, 1024)
        self.up_convolution_1 = UpSample(1024, 512)
        self.up_convolution_2 = UpSample(512, 256)
        self.up_convolution_3 = UpSample(256, 128)
        self.up_convolution_4 = UpSample(128, 64)
        self.out = OutConv(64, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d1, p1 = self.down_convolution_1(x)
        d2, p2 = self.down_convolution_2(p1)
        d3, p3 = self.down_convolution_3(p2)
        d4, p4 = self.down_convolution_4(p3)
        b = self.bottle_neck(p4)
        u1 = self.up_convolution_1(b, d4)
        u2 = self.up_convolution_2(u1, d3)
        u3 = self.up_convolution_3(u2, d2)
        u4 = self.up_convolution_4(u3, d1)
        return self.out(u4)
