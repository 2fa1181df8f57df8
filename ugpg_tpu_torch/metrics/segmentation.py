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

from ugpg_tpu_torch.parallel import distributed

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


def grid_metrics(finals, bases, logits, ys, uncs, home: torch.device,
                 batch_split: bool = True) -> dict[str, torch.Tensor]:
    """The six metrics of a batch split into equal shards (lists, one
    entry per shard), on ``home``, as the unsharded step gives them: the
    losses' mean, smooth-1 Dice of per-sample sums (``batch_split``: the
    shards hold other samples; else regions of the same samples, whose
    sums add), pixel accuracy, and the uncertainty map's mean and std
    (pooled from each shard's mean and centred second moment).  Over
    several processes (``parallel/distributed.py``) the batch is every
    process's, and so are the metrics: the shards' numbers are gathered in
    process order and combined as one process combines its shards."""
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
    cols = [torch.stack([f.detach().to(home) for f in finals]),
            torch.stack([b.detach().to(home) for b in bases]), torch.stack(accs), inter, sp, st]
    if uncs is not None:
        cols += [torch.stack([t.mean().to(home) for t in uncs]),
                 torch.stack([t.var(correction=0).to(home) for t in uncs])]
    cols = distributed.gather_rows(*cols)
    finals, bases, accs, inter, sp, st = cols[:6]
    if uncs is None:
        unc_mean = unc_std = torch.zeros((), dtype=torch.float32, device=home)
    else:
        means, var = cols[6:]
        unc_mean = means.mean()
        unc_std = (var + (means - unc_mean).square()).mean().sqrt()
    return {
        "final_loss": finals.mean(),
        "base_loss": bases.mean(),
        "dice": ((2.0 * inter + 1.0) / (sp + st + 1.0)).mean(),
        "accuracy": accs.mean(),
        "uncertainty_weight_mean": unc_mean,
        "uncertainty_weight_std": unc_std,
    }
