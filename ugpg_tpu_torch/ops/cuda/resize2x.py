"""Exact 2x bilinear upsample (``align_corners=True``) of every ``Up`` block.

Counterpart of ``ugpg_tpu/ops/pallas/resize2x.py::upsample2x_pallas``.
``upsample2x`` launches the CUDA kernel (``csrc/upsample2x.cu``) for a
CUDA tensor and takes the plain version, ``upsample2x_reference``, only
for a CPU tensor.  Tensors are NCHW-logical; on the GPU they must be
``torch.channels_last`` in memory (NHWC, as the kernel reads them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ugpg_tpu_torch.ops.cuda import _lib
from ugpg_tpu_torch.ops.resize import _lerp2x_weights

__all__ = ["upsample2x", "upsample2x_reference"]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)


def _lerp_axis(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Double ``dim`` of float32 ``x``: row 2k lerps rows (k-1, k), row 2k+1
    rows (k, k+1); the clamped out-of-range tap has weight 0."""
    size = x.shape[dim]
    even_lo, odd_hi = (torch.from_numpy(w).to(x.device) for w in _lerp2x_weights(size))
    shape = [1] * x.dim()
    shape[dim] = size
    el, oh = even_lo.view(shape), odd_hi.view(shape)
    k = torch.arange(size, device=x.device)
    below = x.index_select(dim, (k - 1).clamp(min=0))
    above = x.index_select(dim, (k + 1).clamp(max=size - 1))
    even = el * below + (1.0 - el) * x
    odd = (1.0 - oh) * x + oh * above
    return torch.stack([even, odd], dim=dim + 1).flatten(dim, dim + 1)


def upsample2x_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: rows then columns, float32 math, result in
    ``x.dtype`` and ``channels_last`` memory."""
    y = _lerp_axis(_lerp_axis(x.float(), 2), 3)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=64)
def _weights(h: int, w: int, device: torch.device) -> torch.Tensor:
    """[even_lo(h) | odd_hi(h) | even_lo(w) | odd_hi(w)] on ``device``."""
    return torch.from_numpy(np.concatenate(_lerp2x_weights(h) + _lerp2x_weights(w))).to(device)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W) in ``x.dtype`` (float32 or bfloat16)."""
    if x.device.type == "cpu":
        return upsample2x_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x: unsupported device {x.device}")
    code = _lib.dtype_code(x, "upsample2x")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("upsample2x: x must be a 4-D channels_last tensor (NHWC memory)")
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    weights = _weights(h, w, x.device)
    fn = _lib.function("upsample2x", "ugpg_upsample2x", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), weights.data_ptr(), n, h, w, c, code,
                _lib.stream(x))
    _lib.check(rc, "upsample2x", "upsample2x")
    _lib.count("upsample2x")
    return out
