"""Segmentation metrics (counterpart of ``ugpg_tpu/metrics/segmentation.py``).

Training side: sigmoid > threshold predictions, smooth-1 Dice over
per-sample flattened masks, pixel accuracy; each a 0-d float32 tensor on
the input's device (no host sync).  Evaluation side:
``binary_eval_metrics``, per-sample IoU/Dice/accuracy/precision/recall/
specificity from TP/FP/FN/TN counts with ``EPS`` in numerators and
denominators, each a (B,) float32 tensor.
"""

from __future__ import annotations

import torch

__all__ = ["get_predictions", "dice_coefficient", "pixel_accuracy", "binary_eval_metrics", "EPS"]

EPS = 1e-8


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


def binary_eval_metrics(pred: torch.Tensor, target: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-sample metrics of (B, H, W) (or any (B, ...)) binary tensors,
    each of shape (B,).  EPS sits in the numerators too, so an empty
    prediction of an empty target scores 1."""
    b = pred.shape[0]
    p = pred.reshape(b, -1).float()
    t = target.reshape(b, -1).float()
    tp = (p * t).sum(1)
    fp = (p * (1 - t)).sum(1)
    fn = ((1 - p) * t).sum(1)
    tn = ((1 - p) * (1 - t)).sum(1)
    return {
        "iou": (tp + EPS) / (tp + fp + fn + EPS),
        "dice": (2 * tp + EPS) / (2 * tp + fp + fn + EPS),
        "accuracy": (tp + tn + EPS) / (tp + tn + fp + fn + EPS),
        "precision": (tp + EPS) / (tp + fp + EPS),
        "recall": (tp + EPS) / (tp + fn + EPS),
        "specificity": (tn + EPS) / (tn + fp + EPS),
    }
