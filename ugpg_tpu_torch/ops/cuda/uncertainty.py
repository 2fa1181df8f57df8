"""Uncertainty map from logits, ``A = 1 - 2|sigmoid(x) - 0.5|``.

Counterpart of ``ugpg_tpu/ops/pallas/uncertainty_fused.py::
uncertainty_from_logits``.  ``uncertainty_from_logits`` launches the CUDA
kernel (``csrc/uncertainty.cu``) for a CUDA tensor and takes the plain
version, ``uncertainty_from_logits_reference``, only for a CPU tensor.

The host path is kept short, since at the serving buckets a call's host
work is longer than its kernel: the C entry is bound once, the device
context is entered only when another device is current, and a call
allocates only its output.
"""

from __future__ import annotations

import ctypes

import torch

from ugpg_tpu_torch.ops.cuda import _lib

__all__ = ["uncertainty_from_logits", "uncertainty_from_logits_reference"]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)

_entry = None  # the C entry, bound at the first launch


def uncertainty_from_logits_reference(logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 math, result in ``logits.dtype``."""
    return (1.0 - 2.0 * (torch.sigmoid(logits.float()) - 0.5).abs()).to(logits.dtype)


def _bind():
    global _entry
    _entry = _lib.function("uncertainty", "ugpg_uncertainty_from_logits", _ARGTYPES)
    return _entry


def uncertainty_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Pointwise uncertainty map of float32 or bfloat16 ``logits`` of any
    shape, contiguous or ``channels_last``, in the same dtype and layout."""
    device = logits.device
    if device.type == "cpu":
        return uncertainty_from_logits_reference(logits)
    if device.type != "cuda":
        raise ValueError(f"uncertainty_from_logits: unsupported device {device}")
    code = _lib.dtype_code(logits, "uncertainty_from_logits")
    if not (logits.is_contiguous() or logits.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError("uncertainty_from_logits: logits must be contiguous or channels_last")
    out = torch.empty_like(logits)  # dense input -> same strides
    n = logits.numel()
    if n == 0:
        return out
    rc = _lib.on_device(_entry or _bind(), device, logits.data_ptr(), out.data_ptr(), n, code,
                        _lib.stream(logits))
    _lib.check(rc, "uncertainty", "uncertainty_from_logits")
    _lib.count("uncertainty_from_logits")
    return out
