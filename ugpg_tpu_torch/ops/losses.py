"""Loss primitives (counterpart of ``ugpg_tpu/ops/losses.py``).

``bce_with_logits`` is ``nn.BCEWithLogitsLoss(pos_weight=..., reduction=
'none')`` in the stable form the JAX package uses, computed in float32.
The cross-entropy losses of classification are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["bce_with_logits"]


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
