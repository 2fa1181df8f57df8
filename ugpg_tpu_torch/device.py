"""Device resolution for the port's entry points.

The default device is ``cuda``.  Without CUDA and without an explicit
device, entry points raise: the port never carries on silently on the CPU.

``device_constant``: a small constant tensor made once per device and kept,
so that a step copies no host memory to the card after its first call (a
CUDA graph cannot capture such a copy).  While ``torch.export`` or the
compiler traces, it is made afresh each call and not kept: a tensor made
under tracing belongs to that trace only.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["resolve_device", "device_constant"]

_constants: dict[tuple, torch.Tensor] = {}


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


def device_constant(key, make: Callable[[], np.ndarray | tuple], device: torch.device,
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """The tensor of ``make()`` (an array or a tuple of numbers) on ``device``
    in ``dtype``, made at the first call for (``key``, device, dtype) and
    returned from then on.  It is made outside inference mode, so that a
    training step may save it for its backward; callers must not write to it."""
    device = torch.device(device)
    if torch._guards.detect_fake_mode() is not None or torch.compiler.is_compiling():
        return torch.as_tensor(np.asarray(make()), dtype=dtype).to(device)
    full = (key, device, dtype)
    t = _constants.get(full)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(np.asarray(make()), dtype=dtype).to(device)
        t = _constants.setdefault(full, t)
    return t
