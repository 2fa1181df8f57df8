"""Herlev classification model: a PG-U-Net encoder and an MLP head
(counterpart of ``ugpg_tpu/models/classifier.py``).

The stage's encoder walks down to a 512-channel feature map (``inc`` and
the ``down*`` blocks up to ``down3``, ``_ENCODER_SPECS``), then the head
runs ``GAP -> Dropout(.5) -> Linear(512) -> ReLU -> Dropout(.3) ->
Linear(256) -> ReLU -> Dropout(.2) -> Linear(K)`` in float32.  Names are
the reference's: the encoder under ``unet.`` (``unet.inc.conv.conv_op.N``,
``unet.downX.mpconv.1.conv_op.N``) and the head's Linears as
``classifier.{3,6,9}``; the other slots of ``classifier`` hold no state and
never run (``head`` is the MLP).

``use_bn=True``: the live-BN encoder in plain PyTorch (training, the
parity tests), computing in ``dtype`` over float32 parameters as the
segmentation stages do; ``remat=True`` recomputes each encoder DoubleConv
in the backward (``blocks.py``).  ``use_bn=False``: the BN-folded encoder
(``models/folding.py``) cast to ``dtype``, every DoubleConv on the
double-conv kernels (4 calls per stage-4 forward, 1 at stage 1).  Inputs
are NCHW; the logits (N, K) are float32.

Dropout draws its masks from the ``generator`` given to ``forward`` (the
default generator otherwise): it is active in train mode and, with
``mc_dropout=True``, in eval mode too, where BN keeps its running stats
(the Monte-Carlo setup).  A rate of 0 draws nothing, as in flax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ugpg_tpu_torch.models.blocks import DoubleConv, Down, InConv

__all__ = ["HerlevClassificationModel", "CLS_STAGE_RESOLUTIONS", "ENCODER_SPECS",
           "dropout", "dropout_keep"]

# 224, not 256, at stage 4
CLS_STAGE_RESOLUTIONS = {1: 32, 2: 64, 3: 128, 4: 224}

# inc width and the (name, width) down blocks walked per stage; every stage
# ends at a 512-channel feature map
ENCODER_SPECS = {
    1: (512, ()),
    2: (256, (("down3", 512),)),
    3: (128, (("down2", 256), ("down3", 512))),
    4: (64, (("down1", 128), ("down2", 256), ("down3", 512))),
}
_LINEAR_SLOTS = (3, 6, 9)  # the Linear layers of ``classifier``


def dropout_keep(shape, p: float, generator: torch.Generator | None,
                 device: torch.device) -> torch.Tensor | None:
    """The keep mask ``dropout`` draws for a ``shape`` input at rate ``p``
    (bool), or None where it draws nothing (p = 0 or p >= 1)."""
    if p == 0.0 or p >= 1.0:
        return None
    return torch.rand(shape, generator=generator, device=device) < 1.0 - p


def dropout(h: torch.Tensor, p: float, generator: torch.Generator | None,
            keep: torch.Tensor | None = None) -> torch.Tensor:
    """Keep each value with probability 1 - p and scale it by 1 / (1 - p);
    p = 0 returns ``h`` and draws nothing.  ``keep``: a mask drawn ahead
    (``dropout_keep``), used instead of a draw."""
    if p == 0.0:
        return h
    if p >= 1.0:
        return torch.zeros_like(h)
    if keep is None:
        keep = dropout_keep(h.shape, p, generator, h.device)
    return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))


class _Encoder(nn.Module):
    def __init__(self, stage: int, use_bn: bool, in_channels: int):
        super().__init__()
        inc_width, downs = ENCODER_SPECS[stage]
        self.use_bn = use_bn
        self.inc = InConv(in_channels, inc_width, use_bn)
        self.downs = [name for name, _ in downs]
        prev = inc_width
        for name, width in downs:
            setattr(self, name, Down(prev, width, use_bn))
            prev = width

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_bn:  # the kernels read NHWC memory
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.inc(x)
        for name in self.downs:
            x = getattr(self, name)(x)
        return x


class HerlevClassificationModel(nn.Module):
    """Encoder feature extractor and MLP classification head.

    Example:
        model = HerlevClassificationModel(stage=4, num_classes=7)
        logits = model(images)                 # (N, 3, 224, 224) -> (N, 7)
    """

    def __init__(self, stage: int, num_classes: int = 7, use_bn: bool = True,
                 dtype: torch.dtype = torch.float32,
                 dropout_rates: tuple[float, float, float] = (0.5, 0.3, 0.2),
                 in_channels: int = 3, remat: bool = False):
        super().__init__()
        self.stage = stage
        self.num_classes = num_classes
        self.dtype = dtype
        self.unet = _Encoder(stage, use_bn, in_channels)
        self.dropout_rates = tuple(float(p) for p in dropout_rates)
        widths = (512, 512, 256, num_classes)
        linears = {slot: nn.Linear(widths[i], widths[i + 1])
                   for i, slot in enumerate(_LINEAR_SLOTS)}
        self.classifier = nn.Sequential(*(linears.get(i, nn.Identity()) for i in range(10)))
        if use_bn:
            for block in self.unet.modules():
                if isinstance(block, DoubleConv):
                    block.compute_dtype, block.remat = dtype, remat
        else:
            self.unet.to(dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """The encoder's 512-channel map, globally averaged in float32: (N, 512)."""
        return self.unet(x.to(self.dtype)).float().mean(dim=(2, 3))

    def head(self, h: torch.Tensor, active: bool = False,
             generator: torch.Generator | None = None, keep=None) -> torch.Tensor:
        """The MLP on pooled features; ``active`` turns dropout on.  ``keep``:
        the three dropout masks drawn ahead (``head_masks``) instead of
        drawn here."""
        keep = keep if keep is not None else (None,) * len(_LINEAR_SLOTS)
        for linear, p, mask in zip(_LINEAR_SLOTS, self.dropout_rates, keep):
            if active:
                h = dropout(h, p, generator, mask)
            lin = self.classifier[linear]
            h = F.linear(h, lin.weight.float(), lin.bias.float())
            if linear != _LINEAR_SLOTS[-1]:
                h = F.relu(h)
        return h

    def head_masks(self, batch: int, generator: torch.Generator | None,
                   device: torch.device) -> list:
        """The dropout masks an active ``head`` on ``batch`` rows draws from
        ``generator``, drawn in the same order: the same numbers."""
        widths = (512, 512, 256)  # the head's input to each dropout
        return [dropout_keep((batch, width), p, generator, device)
                for width, p in zip(widths, self.dropout_rates)]

    def forward(self, x: torch.Tensor, mc_dropout: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        return self.head(self.features(x), self.training or mc_dropout, generator)
