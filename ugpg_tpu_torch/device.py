"""Device resolution for the port's entry points.

The default device is ``cuda``.  Without CUDA and without an explicit
device, entry points raise: the port never carries on silently on the CPU.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise ``RuntimeError`` when CUDA is asked for
    (explicitly or by default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on an NVIDIA GPU by "
            "default; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
