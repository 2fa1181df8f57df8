"""Loss primitives (counterpart of ``ugpg_tpu/ops/losses.py``).

``bce_with_logits`` is ``nn.BCEWithLogitsLoss(pos_weight=..., reduction=
'none')`` in the stable form the JAX package uses, computed in float32.
``softmax_cross_entropy`` is ``F.cross_entropy(..., reduction='none')`` and
``weighted_cross_entropy_mean`` is ``nn.CrossEntropyLoss(weight=w)``, whose
mean divides by the sum of the selected class weights, not the batch size;
both take the logits in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bce_with_logits", "softmax_cross_entropy", "weighted_cross_entropy_mean"]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) as ``max(x, 0) + log1p(exp(-|x|))`` (the
    ``logaddexp(x, 0)`` form of ``jax.nn.softplus``; no threshold)."""
    return x.clamp_min(0.0) + torch.log1p(torch.exp(-x.abs()))


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float | None = None) -> torch.Tensor:
    """Per-element binary cross entropy from logits (reduction='none'):
    ``(1 - z) x + (1 + (pw - 1) z) softplus(-x)``, float32."""
    x = logits.float()
    z = targets.float()
    sp = _softplus(-x)
    if pos_weight is None:
        return (1.0 - z) * x + sp
    return (1.0 - z) * x + (1.0 + (float(pos_weight) - 1.0) * z) * sp


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy (B,) from logits (B, K) and integer labels (B,)."""
    logz = F.log_softmax(logits.float(), dim=-1)
    return -logz.gather(-1, labels.long()[:, None])[:, 0]


def weighted_cross_entropy_mean(logits: torch.Tensor, labels: torch.Tensor,
                                class_weights: torch.Tensor | None = None) -> torch.Tensor:
    """``CrossEntropyLoss(weight=w)``: ``sum(w_y ce) / sum(w_y)``; the plain
    mean without weights."""
    ce = softmax_cross_entropy(logits, labels)
    if class_weights is None:
        return ce.mean()
    w = torch.as_tensor(class_weights, dtype=torch.float32, device=ce.device)[labels.long()]
    return (w * ce).sum() / w.sum()
