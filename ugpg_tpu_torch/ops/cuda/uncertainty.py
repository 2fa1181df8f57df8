"""Uncertainty map from logits, ``A = 1 - 2|sigmoid(x) - 0.5|``.

Counterpart of ``ugpg_tpu/ops/pallas/uncertainty_fused.py::
uncertainty_from_logits``.  ``uncertainty_from_logits`` launches the CUDA
kernel (``csrc/uncertainty.cu``) for a CUDA tensor and takes the plain
version, ``uncertainty_from_logits_reference``, only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from ugpg_tpu_torch.ops.cuda import _lib

__all__ = ["uncertainty_from_logits", "uncertainty_from_logits_reference"]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


def uncertainty_from_logits_reference(logits: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: float32 math, result in ``logits.dtype``."""
    return (1.0 - 2.0 * (torch.sigmoid(logits.float()) - 0.5).abs()).to(logits.dtype)


def uncertainty_from_logits(logits: torch.Tensor) -> torch.Tensor:
    """Pointwise uncertainty map of float32 or bfloat16 ``logits`` of any
    shape, in the same dtype and memory layout."""
    if logits.device.type == "cpu":
        return uncertainty_from_logits_reference(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"uncertainty_from_logits: unsupported device {logits.device}")
    code = _lib.dtype_code(logits, "uncertainty_from_logits")
    if not (logits.is_contiguous() or (
            logits.dim() == 4 and logits.is_contiguous(memory_format=torch.channels_last))):
        raise ValueError("uncertainty_from_logits: logits must be contiguous or channels_last")
    out = torch.empty_like(logits)  # dense input -> same strides
    if logits.numel() == 0:
        return out
    fn = _lib.function("uncertainty", "ugpg_uncertainty_from_logits", _ARGTYPES)
    with torch.cuda.device(logits.device):
        rc = fn(logits.data_ptr(), out.data_ptr(), logits.numel(), code, _lib.stream(logits))
    _lib.check(rc, "uncertainty", "uncertainty_from_logits")
    _lib.count("uncertainty_from_logits")
    return out
