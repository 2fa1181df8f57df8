"""Uncertainty-weighted BCE-with-logits loss and its gradient.

Counterpart of ``ugpg_tpu/ops/pallas/uncertainty_fused.py::
uncertainty_weighted_bce``: ``(final, base)`` with

    pixel = (1 - z) x + (1 + (pw - 1) z) softplus(-x)
    final = mean(pixel * (1 + alpha (1 - 2|p - 0.5|))),  base = mean(pixel)

``UncertaintyWeightedBCE`` is the ``torch.autograd.Function``: its forward
and its backward each launch a CUDA kernel (``csrc/uncertainty_bce.cu``)
for CUDA tensors, and take the plain versions below only for CPU tensors.
The gradient flows to the logits only (p, the previous stage's
probabilities, is detached, as in the reference); ``base`` is for
monitoring and carries no gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ugpg_tpu_torch.ops.cuda import _lib
from ugpg_tpu_torch.ops.losses import bce_with_logits

__all__ = [
    "UncertaintyWeightedBCE",
    "uncertainty_weighted_bce",
    "uncertainty_weighted_bce_forward",
    "uncertainty_weighted_bce_backward",
    "uncertainty_weighted_bce_reference",
    "uncertainty_weighted_bce_backward_reference",
]

_P = ctypes.c_void_p
_F = ctypes.c_float
_FWD_ARGTYPES = (_P, _P, _P, ctypes.c_int64, _F, _F, _P, ctypes.c_int, _P, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, ctypes.c_int64, _F, _F, _F, _P, _P)


def _weight(p: torch.Tensor, alpha: float) -> torch.Tensor:
    return 1.0 + alpha * (1.0 - 2.0 * (p - 0.5).abs())


def uncertainty_weighted_bce_reference(x, z, p, pos_weight: float, alpha: float):
    """Plain PyTorch version of the forward: (final, base), float32."""
    pixel = bce_with_logits(x, z, pos_weight)
    return (pixel * _weight(p, alpha)).mean(), pixel.mean()


def uncertainty_weighted_bce_backward_reference(x, z, p, pos_weight: float, alpha: float, g):
    """Plain PyTorch version of the backward, in closed form:
    ``dx = g / N * w * ((1 - z) - (1 + (pw - 1) z) sigmoid(-x))``."""
    dpl = (1.0 - z) - (1.0 + (pos_weight - 1.0) * z) * torch.sigmoid(-x)
    return g * (1.0 / x.numel()) * _weight(p, alpha) * dpl


def _check(what: str, *tensors: torch.Tensor) -> None:
    x = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: float32 expected, got {t.dtype}")
        if t.shape != x.shape:
            raise ValueError(f"{what}: shapes differ, {tuple(t.shape)} vs {tuple(x.shape)}")
        if t.device != x.device:
            raise ValueError(f"{what}: tensors on {t.device} and {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.device.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: the kernel takes contiguous tensors")


def uncertainty_weighted_bce_forward(x, z, p, pos_weight: float, alpha: float):
    """(final, base) of float32 x, z, p of one shape, as two 0-d tensors."""
    _check("uncertainty_weighted_bce_forward", x, z, p)
    if x.device.type == "cpu":
        return uncertainty_weighted_bce_reference(x, z, p, pos_weight, alpha)
    n = x.numel()
    blocks = _lib.function("uncertainty_bce", "ugpg_uncertainty_bce_blocks",
                           (ctypes.c_int64,))(n)
    partials = torch.empty(2 * blocks, dtype=torch.float64, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    fn = _lib.function("uncertainty_bce", "ugpg_uncertainty_bce_forward", _FWD_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), z.data_ptr(), p.data_ptr(), n, pos_weight, alpha,
                partials.data_ptr(), blocks, out.data_ptr(), _lib.stream(x))
    _lib.check(rc, "uncertainty_bce", "uncertainty_weighted_bce_forward")
    _lib.count("uncertainty_weighted_bce_fwd")
    return out[0], out[1]


def uncertainty_weighted_bce_backward(x, z, p, pos_weight: float, alpha: float, g):
    """dx of ``final`` for the upstream gradient ``g`` (a 0-d float32
    tensor on x's device, read by the kernel: no host sync)."""
    _check("uncertainty_weighted_bce_backward", x, z, p)
    if x.device.type == "cpu":
        return uncertainty_weighted_bce_backward_reference(x, z, p, pos_weight, alpha, g)
    dx = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return dx
    g = g.to(device=x.device, dtype=torch.float32).reshape(()).contiguous()
    fn = _lib.function("uncertainty_bce", "ugpg_uncertainty_bce_backward", _BWD_ARGTYPES)
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), z.data_ptr(), p.data_ptr(), g.data_ptr(), n, pos_weight,
                alpha, 1.0 / n, dx.data_ptr(), _lib.stream(x))
    _lib.check(rc, "uncertainty_bce", "uncertainty_weighted_bce_backward")
    _lib.count("uncertainty_weighted_bce_bwd")
    return dx


class UncertaintyWeightedBCE(torch.autograd.Function):
    """(final, base) with the kernels above as forward and backward."""

    @staticmethod
    def forward(ctx, logits, targets, probs_prev, pos_weight, alpha):
        pos_weight, alpha = float(pos_weight), float(alpha)
        x = logits.contiguous()
        z = targets.contiguous()
        p = probs_prev.expand_as(x).contiguous()  # p broadcasts to x
        final, base = uncertainty_weighted_bce_forward(x, z, p, pos_weight, alpha)
        ctx.save_for_backward(x, z, p)
        ctx.pos_weight, ctx.alpha = pos_weight, alpha
        ctx.mark_non_differentiable(base)
        ctx.set_materialize_grads(False)
        return final, base

    @staticmethod
    def backward(ctx, g_final, g_base):
        if g_final is None:
            return None, None, None, None, None
        x, z, p = ctx.saved_tensors
        dx = uncertainty_weighted_bce_backward(x, z, p, ctx.pos_weight, ctx.alpha, g_final)
        return dx, None, None, None, None


def uncertainty_weighted_bce(logits, targets, probs_prev, pos_weight: float, alpha: float):
    """(final_loss, base_loss); ``probs_prev`` broadcasts to ``logits``.
    The gradient flows to ``logits`` only."""
    return UncertaintyWeightedBCE.apply(logits, targets, probs_prev, pos_weight, alpha)
