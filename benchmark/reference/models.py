"""Plain PyTorch references of the configurations' models, built from a
configuration file's shapes.  Float32 with TF32 off (``exact()``); nothing
here imports the port.

``PGUNet``: a UG-PG-UNet stage.  ``inc`` and the ``down*`` blocks (a 2x
max-pool, then the DoubleConv) walk down, the ``up*`` blocks walk up (a 2x
bilinear upsample with aligned corners, the skip concatenated before it,
then the DoubleConv), each ``outc*`` 1x1 head sits on an up block's
output, and the logits are the heads' sum, each resized (bilinear, aligned
corners) to the last head's size.  A DoubleConv is (3x3 conv, BN, ReLU)
twice; BN runs as BN (eval: running statistics; train: the batch's, the
running ones updated with momentum and the unbiased variance), never
folded.

``HerlevClassifier``: the same encoder (``unet.inc``, ``unet.down*``), a
global average pool, and the MLP ``classifier`` (Dropout, Linear, ReLU,
Dropout, Linear, ReLU, Dropout, Linear in slots 2-9).  ``mc_forward`` runs
the head N times with dropout active, each keep mask drawn from one
generator in the documented order (per pass: the 512, 512 and 256 wide
masks, ``rand < 1 - p``), and returns the mean of the softmax and its
variance (population, averaged over classes).

Parameter and buffer names are the reference checkpoints' names, so one
state dict loads here and into the program alike.

``precision``: what each DoubleConv's convolutions see of their inputs and
weights: ``None`` is float32; ``"bf16"`` rounds both to bfloat16 and back
(the rounding a bf16 body brings, as the comparison's yardstick);
``"fp8"`` rounds both to float8 e4m3 with a per-tensor scale (amax / 448)
and back: the control that computes below the configuration's bf16.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["PGUNet", "HerlevClassifier", "exact", "uncertainty", "build", "set_precision",
           "stated_precision"]

FP8_MAX = 448.0


@contextlib.contextmanager
def exact():
    """Float32 convolutions and matmuls without TF32 inside, restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


@contextlib.contextmanager
def stated_precision(spec: dict):
    """The TF32 settings a configuration states (``cudnn_allow_tf32``,
    ``matmul_allow_tf32``) inside, restored after."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = spec["cudnn_allow_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = spec["matmul_allow_tf32"]
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _round(t: torch.Tensor, precision: str | None) -> torch.Tensor:
    if precision is None:
        return t
    if precision == "bf16":
        return t.to(torch.bfloat16).float()
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = t.abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


class DoubleConv(nn.Module):
    def __init__(self, cin: int, cout: int, eps: float, momentum: float):
        super().__init__()
        self.conv_op = nn.Sequential(
            nn.Conv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout, eps, momentum), nn.ReLU(),
            nn.Conv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout, eps, momentum), nn.ReLU())
        self.precision = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in ((self.conv_op[0], self.conv_op[1]), (self.conv_op[3], self.conv_op[4])):
            w = _round(conv.weight, self.precision)
            x = F.relu(bn(F.conv2d(_round(x, self.precision), w, conv.bias, padding=1)))
        return x


class Block(nn.Module):
    """``inc`` (``.conv``), ``down*`` (``.mpconv``: pool, DoubleConv) or
    ``up*`` (``.conv``, after the upsample and the concatenation)."""

    def __init__(self, kind: str, cin: int, cout: int, eps: float, momentum: float):
        super().__init__()
        self.kind = kind
        dc = DoubleConv(cin, cout, eps, momentum)
        if kind == "down":
            self.mpconv = nn.Sequential(nn.MaxPool2d(2), dc)
        else:
            self.conv = dc

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None) -> torch.Tensor:
        if self.kind == "down":
            return self.mpconv(x)
        if self.kind == "up":
            up = F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=True)
            x = torch.cat([skip, up], dim=1)
        return self.conv(x)


class Head(nn.Module):
    def __init__(self, cin: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, k, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def _kind(name: str) -> str:
    return "down" if name.startswith("down") else "up" if name.startswith("up") else "inc"


def _blocks(module: nn.Module, blocks: dict, eps: float, momentum: float) -> list[str]:
    for name, (cin, cout) in blocks.items():
        setattr(module, name, Block(_kind(name), cin, cout, eps, momentum))
    return list(blocks)


class PGUNet(nn.Module):
    def __init__(self, blocks: dict, heads: dict, num_classes: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.names = _blocks(self, blocks, eps, momentum)
        self.heads = list(heads)
        for name, cin in heads.items():
            setattr(self, name, Head(cin, num_classes))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for name in self.names:
            if _kind(name) != "up":
                x = getattr(self, name)(x)
                skips.append(x)
        x = skips.pop()
        feats = []
        for name in self.names:
            if _kind(name) == "up":
                x = getattr(self, name)(x, skips.pop())
                feats.append(x)
        logits = [getattr(self, h)(f) for h, f in zip(self.heads, feats)]
        size = logits[-1].shape[-2:]
        out = None
        for lg in logits:
            lg = F.interpolate(lg, size=size, mode="bilinear", align_corners=True)
            out = lg if out is None else out + lg
        return out


class _Encoder(nn.Module):
    def __init__(self, blocks: dict, eps: float, momentum: float):
        super().__init__()
        self.names = _blocks(self, blocks, eps, momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.names:
            x = getattr(self, name)(x)
        return x


class HerlevClassifier(nn.Module):
    def __init__(self, blocks: dict, widths: list[int], dropout: list[float],
                 eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.unet = _Encoder(blocks, eps, momentum)
        self.rates = list(dropout)
        self.widths = list(widths)
        layers = [nn.AdaptiveAvgPool2d(1), nn.Flatten()]
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            layers += [nn.Dropout(dropout[i]), nn.Linear(a, b)]
            if i < len(widths) - 2:
                layers.append(nn.ReLU())
        self.classifier = nn.Sequential(*layers)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        return self.unet(x).mean(dim=(2, 3))

    def head(self, h: torch.Tensor, keep: list[torch.Tensor] | None = None) -> torch.Tensor:
        linears = [m for m in self.classifier if isinstance(m, nn.Linear)]
        for i, lin in enumerate(linears):
            if keep is not None:
                h = torch.where(keep[i], h / (1.0 - self.rates[i]), torch.zeros_like(h))
            h = lin(h)
            if i < len(linears) - 1:
                h = F.relu(h)
        return h

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.features(x))

    def masks(self, batch: int, generator: torch.Generator, device) -> list[torch.Tensor]:
        """One pass's keep masks, drawn in head order."""
        return [torch.rand((batch, w), generator=generator, device=device) < 1.0 - p
                for w, p in zip(self.widths, self.rates)]

    def mc_forward(self, x: torch.Tensor, passes: int, seed: int, bucket: int,
                   rows: slice) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean probs, variance averaged over classes) of ``passes`` head
        passes, the masks drawn for a call of ``bucket`` rows and ``rows``
        of them applied to ``x``."""
        feats = self.features(x)
        g = torch.Generator(device=x.device).manual_seed(seed)
        probs = []
        for _ in range(passes):
            keep = [m[rows] for m in self.masks(bucket, g, x.device)]
            probs.append(torch.softmax(self.head(feats, keep), dim=-1))
        stacked = torch.stack(probs)
        return stacked.mean(0), stacked.var(0, correction=0).mean(-1)


def uncertainty(probs: torch.Tensor) -> torch.Tensor:
    """The binary uncertainty map 1 - 2|p - 0.5|."""
    return 1.0 - 2.0 * (probs - 0.5).abs()


def build(config: dict, stage: dict | None = None) -> nn.Module:
    """The reference model of ``config`` (``stage``: a stage description
    with its own ``blocks`` and ``heads``, such as ``train.prev``)."""
    eps, momentum = config["bn_eps"], config["bn_momentum"]
    if config["model"] == "herlev_classifier":
        return HerlevClassifier(config["blocks"], config["head"]["widths"],
                                config["head"]["dropout"], eps, momentum)
    spec = stage or config
    return PGUNet(spec["blocks"], spec["heads"], config["num_classes"], eps, momentum)


def set_precision(model: nn.Module, precision: str | None) -> nn.Module:
    for m in model.modules():
        if isinstance(m, DoubleConv):
            m.precision = precision
    return model
