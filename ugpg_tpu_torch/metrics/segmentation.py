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

__all__ = ["get_predictions", "dice_coefficient", "pixel_accuracy", "binary_eval_metrics", "EPS",
           "grid_metrics"]

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


def _pooled(parts: list, home: torch.device):
    """(mean, std) of the union of equal-sized tensors, from each one's
    mean and centred second moment."""
    means = torch.stack([t.mean().to(home) for t in parts])
    var = torch.stack([t.var(correction=0).to(home) for t in parts])
    mean = means.mean()
    return mean, (var + (means - mean).square()).mean().sqrt()


def grid_metrics(finals, bases, logits, ys, uncs, home: torch.device,
                 batch_split: bool = True) -> dict[str, torch.Tensor]:
    """The six metrics of a batch split into equal shards (lists, one
    entry per shard), on ``home``, as the unsharded step gives them: the
    losses' mean, smooth-1 Dice of per-sample sums (``batch_split``: the
    shards hold other samples; else regions of the same samples, whose
    sums add), pixel accuracy, and the uncertainty map's mean and std."""
    sums = []
    accs = []
    for lg, y in zip(logits, ys):
        preds = get_predictions(lg.detach())
        b = preds.shape[0]
        pf, tf = preds.reshape(b, -1), y.reshape(b, -1).float()
        sums.append([t.to(home) for t in ((pf * tf).sum(1), pf.sum(1), tf.sum(1))])
        accs.append(pixel_accuracy(preds, y).to(home))
    join = torch.cat if batch_split else (lambda ts: torch.stack(ts).sum(0))
    inter, sp, st = (join(list(col)) for col in zip(*sums))
    if uncs is None:
        unc_mean = unc_std = torch.zeros((), dtype=torch.float32, device=home)
    else:
        unc_mean, unc_std = _pooled(uncs, home)
    return {
        "final_loss": torch.stack([f.detach().to(home) for f in finals]).mean(),
        "base_loss": torch.stack([b.detach().to(home) for b in bases]).mean(),
        "dice": ((2.0 * inter + 1.0) / (sp + st + 1.0)).mean(),
        "accuracy": torch.stack(accs).mean(),
        "uncertainty_weight_mean": unc_mean,
        "uncertainty_weight_std": unc_std,
    }
