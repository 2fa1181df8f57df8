"""The serving kernels as PyTorch operators, namespace ``ugpg_torch``.

    torch.ops.ugpg_torch.fused_double_conv(x, w1, b1, w2, b2, pw1, pb1, pw2, pb2)
    torch.ops.ugpg_torch.conv3x3(x, w, b, pw, pb)
    torch.ops.ugpg_torch.upsample2x(x)
    torch.ops.ugpg_torch.upsample2x_bf16_taps(x)
    torch.ops.ugpg_torch.uncertainty_from_logits(logits)

``upsample2x_bf16_taps`` is the upsample kernel's bf16 instance that
rounds as the JAX package's bf16 resize (the int8 path's Up blocks).
``conv3x3`` is one launch of the double conv's kernel (one conv + bias +
ReLU), for the spatially sharded and the column-parallel forwards.

Each operator has a ``CUDA`` implementation, the kernel's wrapper in
``ops/cuda/`` (its argument checks, its launch and its count in
``_lib``), a ``CPU`` implementation, the plain PyTorch version, and a fake
implementation that gives the output's shape, dtype and strides without
computing it.  The dispatcher picks the implementation by the tensors'
device, so the eager models and a ``torch.export`` program of them
(``eval/exported.py``) run the same code: an exported graph holds one call
of the operator where the model calls it, never the plain version traced
into its parts, and serves on either device.

The convs and the upsample return ``channels_last`` tensors on every
device, as the kernels write NHWC memory; the uncertainty map keeps its
input's strides.  ``pw1, pb1, pw2, pb2`` are ``pack_double_conv``'s
layouts of the weights, made once by ``DoubleConv.pack`` (``pw, pb``:
``pack_conv``'s, made once by their callers); when they are None the CUDA
implementation packs on the fly and the CPU one does not need them.

The operators are defined with ``torch.library.Library`` and ``impl``: on
the H100 that dispatcher path cost less host time per call than the
``torch.library.custom_op`` decorator (``tools/torch_op_dispatch_cost.py``,
``PERF.md`` section 6).  None has an autograd formula: they serve BN-folded
inference, which runs without gradients.
"""

from __future__ import annotations

import torch

from ugpg_tpu_torch.ops.cuda import double_conv, resize2x, uncertainty

__all__ = ["NAMESPACE", "fused_double_conv", "conv3x3", "upsample2x", "upsample2x_bf16_taps",
           "uncertainty_from_logits"]

NAMESPACE = "ugpg_torch"
_CL = torch.channels_last

_LIB = torch.library.Library(NAMESPACE, "DEF")
_LIB.define("fused_double_conv(Tensor x, Tensor w1, Tensor b1, Tensor w2, Tensor b2, "
            "Tensor? pw1, Tensor? pb1, Tensor? pw2, Tensor? pb2) -> Tensor")
_LIB.define("conv3x3(Tensor x, Tensor w, Tensor b, Tensor? pw, Tensor? pb) -> Tensor")
_LIB.define("upsample2x(Tensor x) -> Tensor")
_LIB.define("upsample2x_bf16_taps(Tensor x) -> Tensor")
_LIB.define("uncertainty_from_logits(Tensor logits) -> Tensor")


# ---------------------------------------------------------------- fused_double_conv
def _double_conv_cuda(x, w1, b1, w2, b2, pw1, pb1, pw2, pb2):
    packed = None if pw1 is None else (pw1, pb1, pw2, pb2)
    return double_conv.fused_double_conv(x, w1, b1, w2, b2, packed=packed)


def _double_conv_cpu(x, w1, b1, w2, b2, pw1, pb1, pw2, pb2):
    out = double_conv.fused_double_conv_reference(x, w1, b1, w2, b2)
    return out.contiguous(memory_format=_CL)


def _double_conv_fake(x, w1, b1, w2, b2, pw1, pb1, pw2, pb2):
    n, _, h, w = x.shape
    return torch.empty((n, w2.shape[0], h, w), dtype=x.dtype, device=x.device, memory_format=_CL)


# ---------------------------------------------------------------- conv3x3
def _conv_cuda(x, w, b, pw, pb):
    return double_conv.conv3x3(x, w, b, packed=None if pw is None else (pw, pb))


def _conv_cpu(x, w, b, pw, pb):
    return double_conv.conv3x3_reference(x, w, b).contiguous(memory_format=_CL)


def _conv_fake(x, w, b, pw, pb):
    n, _, h, wd = x.shape
    return torch.empty((n, w.shape[0], h, wd), dtype=x.dtype, device=x.device, memory_format=_CL)


# ---------------------------------------------------------------- upsample2x
def _upsample_cpu(x):
    return resize2x.upsample2x_reference(x)


def _upsample_fake(x):
    n, c, h, w = x.shape
    return torch.empty((n, c, 2 * h, 2 * w), dtype=x.dtype, device=x.device, memory_format=_CL)


# ---------------------------------------------------------------- uncertainty_from_logits
def _uncertainty_cpu(logits):
    out = torch.empty_like(logits)
    return out.copy_(uncertainty.uncertainty_from_logits_reference(logits))


def _uncertainty_fake(logits):
    return torch.empty_like(logits)


_IMPLS = {
    "fused_double_conv": (_double_conv_cuda, _double_conv_cpu, _double_conv_fake),
    "conv3x3": (_conv_cuda, _conv_cpu, _conv_fake),
    "upsample2x": (lambda x: resize2x.upsample2x(x), _upsample_cpu, _upsample_fake),
    "upsample2x_bf16_taps": (lambda x: resize2x.upsample2x_bf16_taps(x),
                             lambda x: resize2x.upsample2x_bf16_taps_reference(x),
                             _upsample_fake),
    "uncertainty_from_logits": (lambda t: uncertainty.uncertainty_from_logits(t),
                                _uncertainty_cpu, _uncertainty_fake),
}
for _name, (_cuda, _cpu, _fake) in _IMPLS.items():
    _LIB.impl(_name, _cuda, "CUDA")
    _LIB.impl(_name, _cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)

fused_double_conv = torch.ops.ugpg_torch.fused_double_conv.default
conv3x3 = torch.ops.ugpg_torch.conv3x3.default
upsample2x = torch.ops.ugpg_torch.upsample2x.default
upsample2x_bf16_taps = torch.ops.ugpg_torch.upsample2x_bf16_taps.default
uncertainty_from_logits = torch.ops.ugpg_torch.uncertainty_from_logits.default
