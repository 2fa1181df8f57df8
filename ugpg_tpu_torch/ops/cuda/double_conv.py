"""Fused DoubleConv on BN-folded weights: (3x3 conv + bias + ReLU) x 2.

Counterpart of ``ugpg_tpu/ops/pallas/double_conv.py::fused_double_conv``.
``fused_double_conv`` launches the CUDA kernel (``csrc/double_conv.cu``)
for CUDA tensors and takes the plain version,
``fused_double_conv_reference``, only for CPU tensors.

Tensors follow PyTorch's conventions: ``x`` is (N, Cin, H, W), stored
``torch.channels_last`` on the GPU (NHWC memory, as the kernel reads it);
weights are ``nn.Conv2d``'s (Cout, Cin, 3, 3).  The middle activation is
rounded to ``x.dtype``; sums are float32.  Any H and W are accepted: the
kernel masks the ragged edge (the JAX kernel's ``tile_h`` divisibility
rule was a TPU constraint).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ugpg_tpu_torch.ops.cuda import _lib

__all__ = ["fused_double_conv", "fused_double_conv_reference"]

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def fused_double_conv_reference(x, w1, b1, w2, b2) -> torch.Tensor:
    """Plain PyTorch version: ``F.conv2d`` twice in float32 with ReLU, the
    middle activation rounded to ``x.dtype``; result in ``x.dtype``."""
    mid = F.relu(F.conv2d(x.float(), w1.float(), b1.float(), padding=1)).to(x.dtype)
    out = F.relu(F.conv2d(mid.float(), w2.float(), b2.float(), padding=1))
    return out.to(x.dtype)


def fused_double_conv(x, w1, b1, w2, b2) -> torch.Tensor:
    """(N, Cin, H, W) -> (N, Cout, H, W) in ``x.dtype`` (float32 or
    bfloat16); ``w1``/``w2`` in ``x.dtype``, any bias dtype."""
    if x.device.type == "cpu":
        return fused_double_conv_reference(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv: unsupported device {x.device}")
    code = _lib.dtype_code(x, "fused_double_conv")
    n, cin, h, w = x.shape
    cm, cout = w1.shape[0], w2.shape[0]
    if tuple(w1.shape) != (cm, cin, 3, 3) or tuple(w2.shape) != (cout, cm, 3, 3):
        raise ValueError(f"fused_double_conv: weights {tuple(w1.shape)}, {tuple(w2.shape)} "
                         f"do not chain from {cin} input channels")
    if tuple(b1.shape) != (cm,) or tuple(b2.shape) != (cout,):
        raise ValueError("fused_double_conv: one bias value per output channel expected")
    if cm % 8 or cout % 8:
        raise ValueError(f"fused_double_conv: channel counts {cm}, {cout} must be multiples of 8")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError("fused_double_conv: all tensors must be on x's device")
    if w1.dtype != x.dtype or w2.dtype != x.dtype:
        raise TypeError(f"fused_double_conv: weights must be {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("fused_double_conv: x must be channels_last (NHWC memory)")
    out = torch.empty((n, cout, h, w), dtype=x.dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    # [tap][in][out] weights, float32 biases: the kernel's layout
    w1k = w1.permute(2, 3, 1, 0).contiguous()
    w2k = w2.permute(2, 3, 1, 0).contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous()
    fn = _lib.function("double_conv", "ugpg_fused_double_conv", _ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), w1k.data_ptr(), b1f.data_ptr(), w2k.data_ptr(), b2f.data_ptr(),
                out.data_ptr(), n, h, w, cin, cm, cout, code, _lib.stream(x))
    _lib.check(rc, "double_conv", "fused_double_conv")
    _lib.count("fused_double_conv")
    return out
