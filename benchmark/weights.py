"""Seeded weights, made on the device in a few large draws.

The recipe (``chip_smoke.py``'s ``random_checkpoint``, drawn on the device):
convolution and linear weights N(0, 2 / fan_in) (He), BN scales
1 + 0.1 N(0, 1), BN running variances 1 + 0.2 U(0, 1), biases and running
means 0.1 N(0, 1), ``num_batches_tracked`` 0.  One normal and one uniform
draw cover every tensor of the model, in the order of its state dict, so
the same seed and device give the same weights.  The names and shapes are
the reference model's (``benchmark/reference/models.py``), which are the
reference checkpoints' names: the state dict loads into the program and
into the reference alike.
"""

from __future__ import annotations

import math
from pathlib import Path

import torch
from torch import nn

__all__ = ["seeded_state_dict", "write_pth", "sub_seed"]


def sub_seed(seed: int, stream: int) -> int:
    """A seed of its own for each use of the run's ``--seed``."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (1 << 63)


def _kind(key: str, value: torch.Tensor) -> str:
    if key.endswith("num_batches_tracked"):
        return "count"
    if key.endswith("running_var"):
        return "var"
    if key.endswith("weight") and value.dim() > 1:
        return "he"
    if key.endswith("weight"):
        return "scale"
    return "small"  # biases and running means


@torch.no_grad()
def seeded_state_dict(model: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """float32 weights for ``model``'s state dict (its values unused)."""
    shapes = {k: v for k, v in model.state_dict().items()}
    kinds = {k: _kind(k, v) for k, v in shapes.items()}
    n_normal = sum(v.numel() for k, v in shapes.items() if kinds[k] in ("he", "scale", "small"))
    n_uniform = sum(v.numel() for k, v in shapes.items() if kinds[k] == "var")
    g = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out, i, j = {}, 0, 0
    for key, value in shapes.items():
        n, kind = value.numel(), kinds[key]
        if kind == "count":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        if kind == "var":
            out[key] = (1.0 + 0.2 * uniform[j:j + n]).view(value.shape)
            j += n
            continue
        v = normal[i:i + n].view(value.shape)
        i += n
        if kind == "he":
            v = v * math.sqrt(2.0 / (n // value.shape[0]))
        elif kind == "scale":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[key] = v
    return out


def write_pth(path: Path, state_dict: dict, stage: int) -> Path:
    """The state dict as a reference-format checkpoint container."""
    torch.save({"stage": stage, "epoch": 0, "model_state_dict": state_dict}, path)
    return path
