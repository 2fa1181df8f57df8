"""Training-divergence detection (counterpart of ``ugpg_tpu/utils/anomaly.py``).

With ``nan_guard`` the trainer checks the epoch-mean losses it has already
read back; on the first NaN/Inf it saves a ``*_diverged`` diagnostic
checkpoint and raises :class:`TrainingDivergedError`, instead of training
on garbage for the rest of the stage.
"""

from __future__ import annotations

import math

__all__ = ["TrainingDivergedError", "nonfinite_metrics"]


class TrainingDivergedError(RuntimeError):
    """An epoch's mean loss is NaN/Inf.  ``stage``, ``epoch`` (1-based),
    ``metrics`` (the non-finite name -> value map) and ``checkpoint`` (the
    diagnostic checkpoint's path, or None)."""

    def __init__(self, stage: int, epoch: int, metrics: dict, checkpoint=None):
        self.stage = stage
        self.epoch = epoch
        self.metrics = dict(metrics)
        self.checkpoint = checkpoint
        names = ", ".join(f"{k}={v!r}" for k, v in self.metrics.items())
        where = f"; diagnostic state saved to {checkpoint}" if checkpoint else ""
        super().__init__(
            f"training diverged at stage {stage}, epoch {epoch}: {names}{where}.  "
            f"Typical causes: learning rate too high, bad/corrupt input batch, "
            f"fp16-style overflow.  Pass nan_guard=False to train through it anyway.")


def nonfinite_metrics(**named: float) -> dict:
    """Subset of ``named`` whose values are NaN/Inf (empty = all finite)."""
    return {k: v for k, v in named.items() if not math.isfinite(float(v))}
