"""Uncertainty maps (counterpart of ``ugpg_tpu/uncertainty.py``).

* binary uncertainty  A = 1 - 2|P - 0.5|  (1 at P = 0.5, 0 at P in {0, 1})

Serving computes the same map from logits in one kernel
(``ops/cuda/uncertainty.py::uncertainty_from_logits``).
"""

from __future__ import annotations

import torch

__all__ = ["binary_uncertainty"]


def binary_uncertainty(probs: torch.Tensor) -> torch.Tensor:
    """A = 1 - 2|P - 0.5| of a probability map."""
    return 1.0 - 2.0 * (probs - 0.5).abs()
