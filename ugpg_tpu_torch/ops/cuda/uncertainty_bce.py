"""Uncertainty-weighted BCE-with-logits loss and its gradient.

Counterpart of ``ugpg_tpu/ops/pallas/uncertainty_fused.py::
uncertainty_weighted_bce``: ``(final, base)`` with

    pixel = (1 - z) x + (1 + (pw - 1) z) softplus(-x)
    final = mean(pixel * (1 + alpha (1 - 2|p - 0.5|))),  base = mean(pixel)

``UncertaintyWeightedBCE`` is the ``torch.autograd.Function``: its forward
and its backward each launch one CUDA kernel (``csrc/uncertainty_bce.cu``)
for CUDA tensors, and take the plain versions below only for CPU tensors.
The gradient flows to the logits only (p, the previous stage's
probabilities, is detached, as in the reference); ``base`` is for
monitoring and carries no gradient.  p broadcasts to the logits, as in the
JAX function; with ``alpha == 0`` the weight is exactly 1 and p is neither
read nor expanded, so a 0-d p costs nothing.

The host path is kept short, since at the training path's sizes a call's
host work is longer than its kernel: the C entries are bound once, the
forward's workspace (the blocks' partial sums and the ticket that picks the
last block) is allocated and zeroed once per device and stream, and a call
allocates only its output.  Under CUDA graph capture the workspace must
exist already (``prepare_workspace`` on the capture stream, or an eager
call there first): made during capture it would come from the graph's
private pool, and the zeroing would run only at replay.
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
    "prepare_workspace",
]

_P = ctypes.c_void_p
_F = ctypes.c_float
_FWD_ARGTYPES = (_P, _P, _P, ctypes.c_int64, _F, _F, _P, _P, _P)
_BWD_ARGTYPES = (_P, _P, _P, _P, ctypes.c_int64, _F, _F, _F, _P, _P)

_entries = None  # (forward, backward, workspace bytes), bound at the first launch
_workspaces: dict[tuple[int, int], torch.Tensor] = {}  # (device, stream) -> bytes


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


def _bind():
    global _entries
    size = _lib.function("uncertainty_bce", "ugpg_uncertainty_bce_workspace_bytes", ())()
    _entries = (
        _lib.function("uncertainty_bce", "ugpg_uncertainty_bce_forward", _FWD_ARGTYPES),
        _lib.function("uncertainty_bce", "ugpg_uncertainty_bce_backward", _BWD_ARGTYPES),
        size,
    )
    return _entries


def _workspace(device: torch.device, stream: int, size: int) -> torch.Tensor:
    """The forward's workspace on ``stream``, zeroed on that stream the
    first time; the kernel leaves its ticket at 0 again."""
    ws = _workspaces.get((device.index, stream))
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "uncertainty_weighted_bce: no workspace on the capturing stream; call "
                "prepare_workspace on it before the capture")
        ws = _workspaces.setdefault((device.index, stream),
                                    torch.zeros(size, dtype=torch.uint8, device=device))
    return ws


def prepare_workspace(device: torch.device) -> None:
    """Make the forward's workspace for ``device``'s current stream now (it
    is zeroed there), outside any capture."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    _, _, size = _entries or _bind()
    _workspace(device, torch._C._cuda_getCurrentRawStream(device.index), size)


def _broadcasts(shape, to) -> bool:
    return len(shape) <= len(to) and all(a in (1, b) for a, b in zip(reversed(shape),
                                                                       reversed(to)))


def _probs(what: str, p: torch.Tensor, x: torch.Tensor, alpha: float) -> torch.Tensor:
    """p as the kernels take it: as given when ``alpha == 0`` (not read),
    else of x's shape and contiguous (a broadcast p is expanded and copied)."""
    if p.shape != x.shape:
        if not _broadcasts(p.shape, x.shape):
            raise ValueError(f"{what}: p of shape {tuple(p.shape)} does not broadcast to "
                             f"{tuple(x.shape)}")
        return p if alpha == 0.0 else p.expand(x.shape).contiguous()
    return p if alpha == 0.0 or p.is_contiguous() else p.contiguous()


def _check(what: str, x: torch.Tensor, z: torch.Tensor, p: torch.Tensor) -> None:
    for t in (x, z, p):
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: float32 expected, got {t.dtype}")
    device = x.device
    for t in (z, p):
        if t.device != device:
            raise ValueError(f"{what}: tensors on {t.device} and {device}")
    if z.shape != x.shape:
        raise ValueError(f"{what}: shapes differ, {tuple(z.shape)} vs {tuple(x.shape)}")
    if device.type == "cuda":
        if not (x.is_contiguous() and z.is_contiguous()):
            raise ValueError(f"{what}: the kernel takes contiguous tensors")
    elif device.type != "cpu":
        raise ValueError(f"{what}: unsupported device {device}")


def uncertainty_weighted_bce_forward(x, z, p, pos_weight: float, alpha: float):
    """(final, base) of float32 x and z of one shape and p that broadcasts
    to them, as two 0-d tensors; one kernel launch on the card."""
    p = _probs("uncertainty_weighted_bce_forward", p, x, alpha)
    _check("uncertainty_weighted_bce_forward", x, z, p)
    if x.device.type == "cpu":
        return uncertainty_weighted_bce_reference(x, z, p, pos_weight, alpha)
    fwd, _, size = _entries or _bind()
    device = x.device
    out = torch.empty(2, dtype=torch.float32, device=device)
    stream = _lib.stream(x)
    rc = _lib.on_device(fwd, device, x.data_ptr(), z.data_ptr(), p.data_ptr(), x.numel(),
                        pos_weight, alpha, _workspace(device, stream, size).data_ptr(),
                        out.data_ptr(), stream)
    _lib.check(rc, "uncertainty_bce", "uncertainty_weighted_bce_forward")
    _lib.count("uncertainty_weighted_bce_fwd")
    return out.unbind(0)


def uncertainty_weighted_bce_backward(x, z, p, pos_weight: float, alpha: float, g):
    """dx of ``final`` for the upstream gradient ``g`` (one float32 on x's
    device, read by the kernel: no host sync)."""
    p = _probs("uncertainty_weighted_bce_backward", p, x, alpha)
    _check("uncertainty_weighted_bce_backward", x, z, p)
    if x.device.type == "cpu":
        return uncertainty_weighted_bce_backward_reference(x, z, p, pos_weight, alpha, g)
    if g.numel() != 1:
        raise ValueError(f"uncertainty_weighted_bce_backward: g of shape {tuple(g.shape)}, "
                         "one element expected")
    dx = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return dx
    if g.device != x.device or g.dtype != torch.float32:
        g = g.to(device=x.device, dtype=torch.float32)
    _, bwd, _ = _entries or _bind()
    rc = _lib.on_device(bwd, x.device, x.data_ptr(), z.data_ptr(), p.data_ptr(), g.data_ptr(),
                        n, pos_weight, alpha, 1.0 / n, dx.data_ptr(), _lib.stream(x))
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
        p = _probs("uncertainty_weighted_bce", probs_prev, x, alpha)
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
    """(final_loss, base_loss); ``probs_prev`` broadcasts to ``logits`` and
    is not read when ``alpha == 0``.  The gradient flows to ``logits`` only."""
    return UncertaintyWeightedBCE.apply(logits, targets, probs_prev, pos_weight, alpha)
