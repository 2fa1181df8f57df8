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

``capturable=True`` (a ``scan_epochs`` trainer's choice on a card)
builds torch's capturable variant, which a CUDA graph can replay: its step
count lives on the device and the learning rate is a 0-d float32 tensor
there, which ``set_learning_rate`` writes in place, so a graph that
captured the step sees every change.  That variant rounds otherwise than
the host-float one (RMSprop divides by ``-lr`` before the update; Adam's
bias corrections are float32 tensors), so a trainer uses one variant for
every step, captured or eager.  Other trainers, and every trainer on the
CPU, keep the host-float variant, the one held against the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable

import torch
from torch import nn

__all__ = ["torch_rmsprop", "torch_adam", "freeze_subtrees", "ReduceLROnPlateau",
           "get_learning_rate", "set_learning_rate", "load_optimizer_state"]


def _lr(params: list, lr: float, capturable: bool):
    """(params, lr as the variant takes it: a device tensor when capturable)."""
    if lr is None:
        raise ValueError("lr must be a number, got None")
    params = list(params)
    if not capturable:
        return params, lr
    first = params[0]["params"][0] if isinstance(params[0], dict) else params[0]
    return params, torch.tensor(float(lr), dtype=torch.float32, device=first.device)


def torch_rmsprop(params: Iterable[torch.nn.Parameter], lr: float,
                  weight_decay: float = 0.0, capturable: bool = False) -> torch.optim.RMSprop:
    """RMSprop with the reference's settings: no momentum, not centered."""
    params, lr = _lr(params, lr, capturable)
    return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                               weight_decay=weight_decay, momentum=0, centered=False,
                               capturable=capturable)


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 0.0,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               capturable: bool = False) -> torch.optim.Adam:
    """Adam with L2 weight decay (not AdamW), no amsgrad."""
    params, lr = _lr(params, lr, capturable)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                            amsgrad=False, capturable=capturable)


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
    """Every group's learning rate; a tensor one (capturable) is written in place."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return optimizer


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> torch.optim.Optimizer:
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    variant: a state written by the other one (the card's capturable
    optimizer, resumed on the CPU, or the reverse) gets this optimizer's
    ``capturable``, its learning rate's form and its step counts' device."""
    capturable = [g.get("capturable", False) for g in optimizer.param_groups]
    lr_tensors = [g["lr"] if isinstance(g["lr"], torch.Tensor) else None
                  for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, cap, lr_t in zip(optimizer.param_groups, capturable, lr_tensors):
        group["capturable"] = cap
        lr = float(group["lr"])
        if lr_t is not None:
            group["lr"] = lr_t.fill_(lr)  # the same tensor: a captured graph reads it
        else:
            group["lr"] = lr
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = (st["step"].to(device=p.device, dtype=torch.float32) if cap
                              else st["step"].to(device="cpu", dtype=torch.float32))
    return optimizer
