"""Progressive-Growing U-Net stages (counterpart of ``ugpg_tpu/models/pgunet.py``).

Channel widths are inverted against a classic U-Net (stage 1 widest), every
stage keeps a 16x16 bottleneck, and the output is the sum of multi-scale
1x1 heads, each bilinearly upsampled (align_corners=True) to the stage
resolution.  Submodule names (``inc``, ``down1..4``, ``up1..4``,
``outc*``) match across stages and the reference torch layout.

``in_channels`` is the input's channel count (3, RGB, by default).
``dtype`` is the compute dtype of the body (bfloat16 for serving); the
heads and the summed logits stay float32.  Inputs are NCHW; the logits
are (N, num_classes, H, W) float32.
"""

from __future__ import annotations

import torch
from torch import nn

from ugpg_tpu_torch.models.blocks import Down, InConv, OutConv, Up
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["PGUNet1", "PGUNet2", "PGUNet3", "PGUNet4", "STAGE_MODELS", "STAGE_RESOLUTIONS"]

STAGE_RESOLUTIONS = {1: 32, 2: 64, 3: 128, 4: 256}


def _scaled(n: int, width: float) -> int:
    """Scale a reference channel count by the width multiplier (min 8)."""
    return max(8, round(n * width))


class _Stage(nn.Module):
    """Shared constructor: ``_build`` the submodules, then cast all but the
    heads to ``dtype``."""

    def __init__(self, num_classes: int = 1, use_bn: bool = True, width: float = 1.0,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.dtype = dtype
        self.in_channels = in_channels
        c = lambda n: _scaled(n, width)  # noqa: E731
        self._build(c, use_bn, num_classes)
        for name, child in self.named_children():
            if not name.startswith("outc"):
                child.to(dtype)

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
