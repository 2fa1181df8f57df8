"""Optimizers of the progressive trainers (counterpart of
``ugpg_tpu/train/optim.py``).

The JAX package re-derives torch's update math in optax; here it is
PyTorch's own ``torch.optim.RMSprop`` (segmentation):

    g <- g + wd * p
    v <- alpha * v + (1 - alpha) * g^2
    p <- p - lr * g / (sqrt(v) + eps)        (alpha 0.99, eps 1e-8)

and ``torch.optim.Adam`` (classification), weight decay added to the
gradient (L2), not decoupled:

    g <- g + wd * p
    m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2
    p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

``freeze_subtrees`` keeps named top-level submodules out of the update
(the classifier's encoder ``unet``): they get no gradient and no optimizer
state.  ``ReduceLROnPlateau`` is the JAX package's host-side scheduler
(mode 'min', a relative threshold of 1e-4, no cooldown) acting on a torch
optimizer's learning rate.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import torch
from torch import nn

__all__ = ["torch_rmsprop", "torch_adam", "freeze_subtrees", "ReduceLROnPlateau",
           "get_learning_rate", "set_learning_rate"]


def torch_rmsprop(params: Iterable[torch.nn.Parameter], lr: float,
                  weight_decay: float = 0.0) -> torch.optim.RMSprop:
    """RMSprop with the reference's settings: no momentum, not centered."""
    if lr is None:
        raise ValueError("lr must be a number, got None")
    return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                               weight_decay=weight_decay, momentum=0, centered=False)


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 0.0,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> torch.optim.Adam:
    """Adam with L2 weight decay (not AdamW), no amsgrad."""
    if lr is None:
        raise ValueError("lr must be a number, got None")
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                            amsgrad=False)


def freeze_subtrees(model: nn.Module, frozen_roots: tuple[str, ...]) -> list[nn.Parameter]:
    """Turn off the gradient of every parameter under the named top-level
    submodules, and return the others: the parameters to optimize."""
    trainable = []
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in frozen_roots
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable


@dataclass
class ReduceLROnPlateau:
    """``step(metric, optimizer)`` once per epoch: after more than
    ``patience`` epochs in a row without a relative improvement of
    ``threshold`` below ``best``, multiply the learning rate by ``factor``
    (not below ``min_lr``) and start counting again."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=float("inf"), init=False)
    num_bad_epochs: int = field(default=0, init=False)

    def step(self, metric: float, optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            set_learning_rate(optimizer,
                              max(get_learning_rate(optimizer) * self.factor, self.min_lr))
            self.num_bad_epochs = 0
        return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)
    return optimizer
