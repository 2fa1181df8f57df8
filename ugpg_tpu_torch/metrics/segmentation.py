"""Training-side segmentation metrics (counterpart of
``ugpg_tpu/metrics/segmentation.py``): sigmoid > threshold predictions,
smooth-1 Dice over per-sample flattened masks, pixel accuracy.  Every
result is a 0-d float32 tensor on the input's device (no host sync).
"""

from __future__ import annotations

import torch

__all__ = ["get_predictions", "dice_coefficient", "pixel_accuracy"]


def get_predictions(logits: torch.Tensor, threshold: float = 0.5) -> torch.Tensor:
    """sigmoid -> strictly greater than ``threshold`` -> {0, 1} float32."""
    return (torch.sigmoid(logits) > threshold).float()


def dice_coefficient(pred: torch.Tensor, target: torch.Tensor,
                     smooth: float = 1.0) -> torch.Tensor:
    """Batch-mean Dice with additive smoothing; (B, ...) binary tensors,
    flattened per sample."""
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    inter = (p * t).sum(1)
    return ((2.0 * inter + smooth) / (p.sum(1) + t.sum(1) + smooth)).mean()


def pixel_accuracy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Share of pixels where ``pred == target``."""
    return (pred == target).float().mean()
