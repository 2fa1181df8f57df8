"""PyTorch-semantics bilinear resize (``align_corners=True``) as matmuls,
and the legacy ``mode='nearest'`` resize as an index gather.

Counterpart of ``ugpg_tpu/ops/resize.py``: the same two-tap interpolation
matrices (float64 weights rounded to float32), applied per spatial axis in
float32.  Used for the request and training resizes and the multi-scale
head upsampling; it is not a kernel in the JAX package either, so it stays
plain PyTorch.  A bfloat16 tensor (the bf16 training body's Up blocks)
takes the JAX package's bf16 path: weights rounded to bf16, float32 sums,
the result of the first axis rounded to bf16 before the second; its
gradient is the float32 transpose, rounded to bf16 once, as JAX's.

Tensors are NCHW-logical (any memory format).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ugpg_tpu_torch.device import device_constant

__all__ = ["resize_bilinear_align_corners", "resize_nearest", "upsample2x_bilinear_align_corners"]


@functools.lru_cache(maxsize=None)
def _bilinear_ac_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Interpolation matrix W (out_size, in_size) for align_corners=True.

    Row i holds the two-tap weights of output sample i at
    ``src = i * (in-1) / (out-1)``; a size of 1 on either side maps every
    output to input 0 (torch's area_pixel_compute_scale guard).
    """
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if out_size == 1 or in_size == 1:
        w[:, 0] = 1.0
        return w.astype(np.float32)
    src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = src - lo
    rows = np.arange(out_size)
    np.add.at(w, (rows, lo), 1.0 - frac)
    np.add.at(w, (rows, hi), frac)
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lerp2x_weights(size: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row lerp weights of the exact-2x align_corners=True upsample.

    Output row o samples input row ``o * (size-1) / (2*size-1)``, which
    lands between adjacent rows:

    * even rows o=2k:   taps (k-1, k), weight on k-1 is  k/(2*size-1)
    * odd  rows o=2k+1: taps (k, k+1), weight on k+1 is (size-1-k)/(2*size-1)

    k=0 / k=size-1 put weight exactly 0 on the out-of-range tap.
    """
    k = np.arange(size, dtype=np.float64)
    even_lo = (k / (2 * size - 1)).astype(np.float32)
    odd_hi = ((size - 1 - k) / (2 * size - 1)).astype(np.float32)
    return even_lo, odd_hi


@functools.lru_cache(maxsize=None)
def _nearest_indices(in_size: int, out_size: int) -> np.ndarray:
    """Source indices for torch's legacy ``mode='nearest'``: floor(i*in/out),
    in float64 (``F.interpolate`` computes the scale in float32 and can pick
    another source row for some sizes)."""
    scale = in_size / out_size
    idx = np.floor(np.arange(out_size, dtype=np.float64) * scale).astype(np.int64)
    return np.clip(idx, 0, in_size - 1)


def _matrix(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return device_constant(("bilinear_ac", in_size, out_size),
                           lambda: _bilinear_ac_matrix(in_size, out_size), device)


def _indices(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return device_constant(("nearest", in_size, out_size),
                           lambda: _nearest_indices(in_size, out_size), device)


class _ResizeBF16(torch.autograd.Function):
    """The bf16 resize: forward as the JAX package's bf16 path, backward
    its float32 custom VJP."""

    @staticmethod
    def forward(ctx, x, out_h, out_w):
        h, w = x.shape[-2:]
        ctx.hw = (h, w, out_h, out_w)
        y = x.float()
        if out_h != h:
            wh = _matrix(h, out_h, y.device).bfloat16().float()
            y = torch.einsum("oh,nchw->ncow", wh, y)
            if out_w != w:
                y = y.bfloat16().float()
        if out_w != w:
            y = torch.einsum("pw,nchw->nchp", _matrix(w, out_w, y.device).bfloat16().float(), y)
        return y.bfloat16()

    @staticmethod
    def backward(ctx, g):
        h, w, out_h, out_w = ctx.hw
        y = g.float()
        if out_h != h:
            y = torch.einsum("oh,ncow->nchw", _matrix(h, out_h, y.device), y)
        if out_w != w:
            y = torch.einsum("pw,nchp->nchw", _matrix(w, out_w, y.device), y)
        return y.bfloat16(), None, None


def resize_bilinear_align_corners(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW ``x`` to ``size`` (torch align_corners=True),
    float32 math, result in ``x.dtype`` (bfloat16: see the module's
    docstring).  Same size returns ``x``."""
    out_h, out_w = size
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    if x.dtype == torch.bfloat16:
        return _ResizeBF16.apply(x, out_h, out_w)
    y = x.float()
    if out_h != h:
        y = torch.einsum("oh,nchw->ncow", _matrix(h, out_h, y.device), y)
    if out_w != w:
        y = torch.einsum("pw,nchw->nchp", _matrix(w, out_w, y.device), y)
    return y.to(x.dtype)


def upsample2x_bilinear_align_corners(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample (align_corners=True) through the general resize."""
    h, w = x.shape[-2:]
    return resize_bilinear_align_corners(x, (2 * h, 2 * w))


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of NCHW ``x`` to ``size`` (torch legacy 'nearest'),
    by gathering rows and columns.  Same size returns ``x``."""
    out_h, out_w = size
    h, w = x.shape[-2:]
    if (h, w) == (out_h, out_w):
        return x
    if out_h != h:
        x = x.index_select(-2, _indices(h, out_h, x.device))
    if out_w != w:
        x = x.index_select(-1, _indices(w, out_w, x.device))
    return x
