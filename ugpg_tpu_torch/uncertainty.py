"""Uncertainty maps and the uncertainty-weighted loss (counterpart of
``ugpg_tpu/uncertainty.py``).

* binary uncertainty  A = 1 - 2|P - 0.5|  (1 at P = 0.5, 0 at P in {0, 1})
* the map of a frozen previous stage, and the weighted mean
  ``mean(pixel_loss * (1 + alpha A))`` with the weights detached
* ``UncertaintyGuidedLoss``, the reference's object over those functions
  (both of its call styles), and ``create_uncertainty_weighted_loss_fn``,
  a reduction-free BCE
* classification: the normalised softmax entropy H(p) / log K, the
  per-sample weights ``1 + alpha A`` of a frozen previous stage's logits,
  and Monte-Carlo-dropout mean and variance

Serving computes the same map from logits in one kernel
(``ops/cuda/uncertainty.py::uncertainty_from_logits``); the train step's
fused loss folds the weighting into its own kernels
(``ops/cuda/uncertainty_bce.py``).  Tensors are NCHW.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from ugpg_tpu_torch.ops.cuda.uncertainty_bce import uncertainty_weighted_bce
from ugpg_tpu_torch.ops.losses import bce_with_logits
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners

__all__ = ["binary_uncertainty", "entropy_uncertainty", "mc_dropout_uncertainty",
           "generate_uncertainty_map", "apply_uncertainty_weighted_loss",
           "classification_uncertainty_weights", "UncertaintyGuidedLoss",
           "create_uncertainty_weighted_loss_fn", "shard_loss"]


def binary_uncertainty(probs: torch.Tensor) -> torch.Tensor:
    """A = 1 - 2|P - 0.5| of a probability map."""
    return 1.0 - 2.0 * (probs - 0.5).abs()


def entropy_uncertainty(probs: torch.Tensor, num_classes: int, dim: int = -1) -> torch.Tensor:
    """Normalised softmax entropy H(p) / log K, keeping ``dim`` (size 1)."""
    entropy = -(probs * torch.log(probs + 1e-8)).sum(dim=dim, keepdim=True)
    return entropy / math.log(float(num_classes))


@torch.no_grad()
def mc_dropout_uncertainty(apply_fn: Callable[[torch.Tensor, torch.Generator], torch.Tensor],
                           x: torch.Tensor, generator: torch.Generator, num_samples: int = 8,
                           task_type: str = "segmentation") -> tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo-dropout mean and variance over ``num_samples`` passes of
    ``apply_fn(x, generator) -> logits``, which must run the model with its
    dropout active and its BN in eval mode, drawing the masks from
    ``generator``.  Probabilities are float32 (softmax for classification,
    sigmoid otherwise).  -> (mean, variance): per pixel for segmentation;
    for classification (B, K) and the variance's mean over classes (B,)."""
    probs = []
    for _ in range(num_samples):
        logits = apply_fn(x, generator).float()
        probs.append(torch.softmax(logits, dim=-1) if task_type == "classification"
                     else torch.sigmoid(logits))
    stacked = torch.stack(probs)
    mean, var = stacked.mean(0), stacked.var(0, correction=0)
    if task_type == "classification":
        var = var.mean(-1)
    return mean, var


@torch.no_grad()
def generate_uncertainty_map(prev_apply: Callable[[torch.Tensor], torch.Tensor],
                             x_current: torch.Tensor, prev_resolution: int,
                             current_resolution: int) -> torch.Tensor:
    """Uncertainty map from the frozen previous-stage model: resize the
    input down to ``prev_resolution``, run ``prev_apply`` (which must run
    the model in eval mode) and the sigmoid, resize the probabilities back
    up, take A.  No gradient flows through it."""
    x_prev = resize_bilinear_align_corners(x_current, (prev_resolution, prev_resolution))
    probs = torch.sigmoid(prev_apply(x_prev))
    probs_up = resize_bilinear_align_corners(probs, (current_resolution, current_resolution))
    return binary_uncertainty(probs_up)


def apply_uncertainty_weighted_loss(pixel_loss: torch.Tensor,
                                    uncertainty_map: torch.Tensor | None,
                                    alpha: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    """(final_loss, base_loss): the plain mean at stage 1 (no map), else
    ``mean(pixel_loss * detach(1 + alpha A))``; base_loss is the unweighted
    mean, kept for monitoring."""
    base_loss = pixel_loss.mean()
    if uncertainty_map is None:
        return base_loss, base_loss
    weights = (1.0 + alpha * uncertainty_map).detach()
    return (pixel_loss * weights).mean(), base_loss


@torch.no_grad()
def classification_uncertainty_weights(prev_logits: torch.Tensor, num_classes: int,
                                       alpha: float = 1.0) -> torch.Tensor:
    """Per-sample weights (B,) ``1 + alpha A`` from a frozen previous
    stage's logits: A is the normalised softmax entropy for K > 2, and the
    mean over the logits of ``1 - 2|sigmoid - 0.5|`` for K = 2."""
    if num_classes > 2:
        unc = entropy_uncertainty(torch.softmax(prev_logits, dim=-1), num_classes, dim=-1)
    else:
        unc = binary_uncertainty(torch.sigmoid(prev_logits))
    if unc.dim() > 1:
        unc = unc.mean(dim=tuple(range(1, unc.dim())))
    return 1.0 + alpha * unc


class UncertaintyGuidedLoss:
    """The reference's loss object over the functions above.  Its code
    builds ``UncertaintyGuidedLoss(device)`` and its README
    ``UncertaintyGuidedLoss(task_type='segmentation')``; both work.
    ``device`` is kept for that signature: tensors carry their own."""

    def __init__(self, device=None, task_type: str = "segmentation"):
        if task_type not in ("segmentation", "classification"):
            raise ValueError(f"unknown task_type: {task_type!r}")
        self.device = device
        self.task_type = task_type

    def generate_uncertainty_map(self, input_current: torch.Tensor, prev_apply,
                                 prev_resolution: int, current_resolution: int) -> torch.Tensor:
        """``prev_apply``: the frozen previous-stage model (put in eval mode
        here) or any callable that runs it in eval mode."""
        if isinstance(prev_apply, torch.nn.Module):
            prev_apply.eval()
        return generate_uncertainty_map(prev_apply, input_current, prev_resolution,
                                        current_resolution)

    def apply_uncertainty_weighted_loss(self, loss_fn, output_current, target_current,
                                        uncertainty_map=None, alpha: float = 1.0):
        """``loss_fn(outputs, targets)`` -> the per-pixel loss (no
        reduction).  Returns (final_loss, base_loss), both 0-d tensors."""
        pixel_loss = loss_fn(output_current, target_current)
        return apply_uncertainty_weighted_loss(pixel_loss, uncertainty_map, alpha)


def create_uncertainty_weighted_loss_fn(base_loss_fn=None, pos_weight=None):
    """A per-element loss: ``base_loss_fn`` itself when given, else BCE with
    logits at ``pos_weight``."""
    if base_loss_fn is not None:
        return base_loss_fn
    def loss_fn(outputs, targets):
        return bce_with_logits(outputs, targets, pos_weight)

    return loss_fn


def shard_loss(logits, y, probs_up, unc_map, pos_weight: float, alpha: float, fused: bool):
    """(final, base) means of one batch or shard: the fused kernels with
    ``fused`` (at stage 1, no ``probs_up``: a 0-d p of 0.5 and alpha 0, so
    the kernels read no p), else BCE and the uncertainty-weighted mean."""
    if fused:
        p_arg = probs_up if probs_up is not None else logits.new_full((), 0.5)
        return uncertainty_weighted_bce(logits, y, p_arg, pos_weight,
                                        alpha if probs_up is not None else 0.0)
    return apply_uncertainty_weighted_loss(bce_with_logits(logits, y, pos_weight), unc_map, alpha)
