"""Exact 2x bilinear upsample (``align_corners=True``) of every ``Up`` block.

Counterpart of ``ugpg_tpu/ops/pallas/resize2x.py::upsample2x_pallas``.
``upsample2x`` launches the CUDA kernel (``csrc/upsample2x.cu``) for a
CUDA tensor and takes the plain version, ``upsample2x_reference``, only
for a CPU tensor.  Tensors are NCHW-logical; on the GPU they must be
``torch.channels_last`` in memory (NHWC, as the kernel reads them).

``upsample2x_bf16_taps`` is the kernel's second instance, for bf16 input:
it rounds as the JAX package's bf16 resize does (each output's two tap
weights rounded to bf16, the H pass rounded to bf16 before the W pass),
which is what the JAX package's int8 forward runs on each Up block.  Its
plain version, ``upsample2x_bf16_taps_reference``, is that bf16 path of
``ops/resize.py``; the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ugpg_tpu_torch.ops.cuda import _lib
from ugpg_tpu_torch.ops.resize import (
    _bilinear_ac_matrix,
    _lerp2x_weights,
    resize_bilinear_align_corners,
)

__all__ = ["upsample2x", "upsample2x_reference", "upsample2x_bf16_taps",
           "upsample2x_bf16_taps_reference"]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 5 + (
    ctypes.c_void_p,)
_TAPS_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p) + (ctypes.c_int,) * 4 + (
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


def upsample2x_bf16_taps_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the bf16 resize of ``ops/resize.py`` (JAX's
    rounding), in ``channels_last`` memory."""
    with torch.no_grad():
        y = resize_bilinear_align_corners(x, (2 * x.shape[2], 2 * x.shape[3]))
    return y.contiguous(memory_format=torch.channels_last)


def _axis_taps(size: int) -> np.ndarray:
    """[even0 | even1 | odd0 | odd1] (4 * size,) float32: output row 2k takes
    even0[k] x row k-1 + even1[k] x row k, row 2k+1 odd0[k] x row k + odd1[k]
    x row k+1, with the bf16 roundings of ``_bilinear_ac_matrix``'s entries
    (a tap that would leave the axis has weight 0)."""
    m = torch.from_numpy(_bilinear_ac_matrix(size, 2 * size)).bfloat16().float().numpy()
    k = np.arange(size)
    lo, hi = np.maximum(k - 1, 0), np.minimum(k + 1, size - 1)
    taps = np.stack([np.where(k > 0, m[2 * k, lo], 0.0), m[2 * k, k],
                     m[2 * k + 1, k], np.where(k < size - 1, m[2 * k + 1, hi], 0.0)])
    rebuilt = np.zeros_like(m)  # the taps hold every nonzero entry of m
    np.add.at(rebuilt, (2 * k, lo), taps[0])
    np.add.at(rebuilt, (2 * k, k), taps[1])
    np.add.at(rebuilt, (2 * k + 1, k), taps[2])
    np.add.at(rebuilt, (2 * k + 1, hi), taps[3])
    assert np.array_equal(rebuilt, m), size
    return taps.astype(np.float32).reshape(-1)


@functools.lru_cache(maxsize=64)
def _tap_weights(h: int, w: int, device: torch.device) -> torch.Tensor:
    """``_axis_taps(h)`` then ``_axis_taps(w)`` on ``device``."""
    return torch.from_numpy(np.concatenate([_axis_taps(h), _axis_taps(w)])).to(device)


def upsample2x_bf16_taps(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) bfloat16 -> (N, C, 2H, 2W) bfloat16 with JAX's bf16
    resize rounding."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"upsample2x_bf16_taps: bfloat16 expected, got {x.dtype}")
    if x.device.type == "cpu":
        return upsample2x_bf16_taps_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"upsample2x_bf16_taps: unsupported device {x.device}")
    if x.dim() != 4 or not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("upsample2x_bf16_taps: x must be a 4-D channels_last tensor "
                         "(NHWC memory)")
    n, c, h, w = x.shape
    out = torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    weights = _tap_weights(h, w, x.device)
    fn = _lib.function("upsample2x", "ugpg_upsample2x_bf16_taps", _TAPS_ARGTYPES)
    rc = _lib.on_device(fn, x.device, x.data_ptr(), out.data_ptr(), weights.data_ptr(), n, h, w,
                        c, _lib.stream(x))
    _lib.check(rc, "upsample2x", "upsample2x_bf16_taps")
    _lib.count("upsample2x_bf16_taps")
    return out
