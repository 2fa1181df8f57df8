"""Optimizers of the progressive trainer (counterpart of
``ugpg_tpu/train/optim.py``).

The JAX package re-derives torch's update math in optax; here it is
PyTorch's own ``torch.optim.RMSprop``:

    g <- g + wd * p
    v <- alpha * v + (1 - alpha) * g^2
    p <- p - lr * g / (sqrt(v) + eps)        (alpha 0.99, eps 1e-8)

Adam, ``ReduceLROnPlateau`` and ``freeze_subtrees`` belong to
classification and are not ported yet.
"""

from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["torch_rmsprop", "get_learning_rate", "set_learning_rate"]


def torch_rmsprop(params: Iterable[torch.nn.Parameter], lr: float,
                  weight_decay: float = 0.0) -> torch.optim.RMSprop:
    """RMSprop with the reference's settings: no momentum, not centered."""
    if lr is None:
        raise ValueError("lr must be a number, got None")
    return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                               weight_decay=weight_decay, momentum=0, centered=False)


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer
