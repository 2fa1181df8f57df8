"""Angle-quantized batched rotation: banded-matmul shears instead of gathers
(counterpart of ``ugpg_tpu/ops/rotate.py``).

The angle is drawn from N grid angles; each grid angle is a constant, so
the warp needs no per-sample index math.  Two formulations:

* ``rotate_fixed``: the Paeth three-shear decomposition.  As inverse maps,
  ``R(t) = Sx(-tan(t/2)) . Sy(sin t) . Sx(-tan(t/2))``; each shear is a
  per-row (or per-column) 1-D interpolation with a row-constant shift, i.e.
  a batched matmul against a constant banded matrix.  Square frames route
  multiples of 90 degrees through exact transposes and flips; every
  intermediate is padded with the extents it needs, so nothing that lands
  inside the output frame is cut.
* ``rotate_fixed_gather``: ``data/augment.py::affine_sample`` at one angle.

``random_rotate_quantized`` draws a grid index per sample, rotates the
whole batch by every grid angle and selects per sample; the angle's
marginal is discrete uniform over the grid instead of continuous.

Tensors are NCHW.  This is the ``aug_quantize=N`` option of the JAX
package, ported as written; it is plain torch, as it is plain XLA there.
"""

from __future__ import annotations

import math

import torch

from ugpg_tpu_torch.data.augment import affine_sample, rotation_matrices

__all__ = ["angle_grid", "rotate_fixed", "rotate_fixed_gather", "rotate_quantized",
           "random_rotate_quantized"]


def angle_grid(max_deg: float, n_angles: int) -> list[float]:
    """Uniform symmetric grid of ``n_angles`` rotation angles (degrees)."""
    if n_angles < 1:
        raise ValueError(f"n_angles must be >= 1, got {n_angles}")
    if n_angles == 1:
        return [0.0]
    step = 2.0 * max_deg / (n_angles - 1)
    return [-max_deg + i * step for i in range(n_angles)]


def _hat_matrix(n_out: int, n_in: int, shifts: torch.Tensor, off_out: float, off_in: float,
                nearest: bool, dtype: torch.dtype) -> torch.Tensor:
    """Constant interpolation matrix M (rows, n_out, n_in): output ``o``
    (center ``off_out``) of row ``r`` samples input coordinate
    ``(o - off_out) + shifts[r] + off_in``; bilinear rows are the hat
    ``max(0, 1 - |d|)``, nearest rows the one-hot of the nearest input (the
    left one of a tie); outside [0, n_in) a row is zero (zero fill)."""
    dev = shifts.device
    o = torch.arange(n_out, dtype=torch.float32, device=dev) - off_out
    i = torch.arange(n_in, dtype=torch.float32, device=dev) - off_in
    src = o[None, :] + shifts.to(torch.float32)[:, None]
    d = i[None, None, :] - src[:, :, None]
    if nearest:
        m = (d.abs() <= 0.5).to(torch.float32)
        m = torch.where(torch.cumsum(m, -1) > 1.0, torch.zeros_like(m), m)
    else:
        m = torch.clamp(1.0 - d.abs(), min=0.0)
    return m.to(dtype)


def _rot90_ccw(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact 90-degree content rotations of an NCHW batch."""
    k %= 4
    if k == 0:
        return x
    if k == 1:  # out[y, x] = in[x, H - 1 - y]
        return x.transpose(2, 3).flip(2)
    if k == 2:
        return x.flip(2, 3)
    return x.transpose(2, 3).flip(3)  # out[y, x] = in[W - 1 - x, y]


def rotate_fixed(x: torch.Tensor, angle_deg: float, nearest: bool = False) -> torch.Tensor:
    """Rotate a (B, C, H, W) batch by a constant angle with the Paeth three
    shears: three matmuls, no gathers.  The composition equals
    ``rotation_matrices(angle_deg)``, so this agrees with ``affine_sample``
    up to 1-D against 2-D interpolation."""
    _, _, h, w = x.shape
    k = int(round(angle_deg / 90.0))
    if k and h == w:  # square: peel exact quarter turns, shear the rest
        x = _rot90_ccw(x, k)
        angle = angle_deg - 90.0 * k
    else:
        angle = angle_deg
    if angle == 0.0:
        return x

    t = math.radians(angle)
    a = -math.tan(t / 2.0)  # x-shear factor (inverse map)
    s = math.sin(t)         # y-shear factor (inverse map)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    # extents, derived backwards from the output frame: pass 3 reads pass
    # 2's output at |x| <= cx + |a| cy, pass 2 reads pass 1's at
    # |y| <= cy + |s| ex3; intermediates grow by whole pixels each side
    ex3 = cx + abs(a) * cy
    ey2 = cy + abs(s) * ex3
    px = math.ceil(ex3 - cx)
    py = math.ceil(ey2 - cy)
    w3, ox3 = w + 2 * px, cx + px
    h2, oy2 = h + 2 * py, cy + py

    dev = x.device
    yc_mid = torch.arange(h2, dtype=torch.float32, device=dev) - oy2
    yc_out = torch.arange(h, dtype=torch.float32, device=dev) - cy
    xc_mid = torch.arange(w3, dtype=torch.float32, device=dev) - ox3

    x_pad = torch.nn.functional.pad(x, (0, 0, py, py))
    m1 = _hat_matrix(w3, w, a * yc_mid, ox3, cx, nearest, x.dtype)     # per row of x_pad
    p1 = torch.einsum("yoi,bcyi->bcyo", m1, x_pad)                     # (B, C, h2, w3)
    m2 = _hat_matrix(h, h2, s * xc_mid, cy, oy2, nearest, x.dtype)     # per column
    p2 = torch.einsum("xoi,bcix->bcox", m2, p1)                        # (B, C, h, w3)
    m3 = _hat_matrix(w, w3, a * yc_out, cx, ox3, nearest, x.dtype)
    return torch.einsum("yoi,bcyi->bcyo", m3, p2)                      # (B, C, h, w)


def rotate_fixed_gather(x: torch.Tensor, angle_deg: float, nearest: bool = False) -> torch.Tensor:
    """Constant-angle rotation through ``affine_sample``."""
    m = rotation_matrices(torch.full((x.shape[0],), angle_deg, dtype=torch.float32,
                                     device=x.device))
    return affine_sample(x, m, "nearest" if nearest else "bilinear")


def rotate_quantized(x: torch.Tensor, angle_index: torch.Tensor, max_deg: float = 90.0,
                     n_angles: int = 15, nearest: bool = False) -> torch.Tensor:
    """Rotate sample b by grid angle ``angle_index[b]`` of
    ``angle_grid(max_deg, n_angles)`` with ``rotate_fixed``: the batch is
    rotated by every grid angle and each sample keeps its own."""
    out = torch.zeros_like(x)
    for n, ang in enumerate(angle_grid(max_deg, n_angles)):
        sel = (angle_index == n)[:, None, None, None]
        out = torch.where(sel, rotate_fixed(x, ang, nearest=nearest), out)
    return out


def random_rotate_quantized(generator: torch.Generator, images: torch.Tensor, masks=None,
                            max_deg: float = 90.0, n_angles: int = 15):
    """The quantized counterpart of ``random_rotate``: per-sample grid
    index drawn uniformly from ``generator``, bilinear images, nearest
    masks."""
    idx = torch.randint(0, n_angles, (images.shape[0],), generator=generator,
                        device=generator.device)
    imgs = rotate_quantized(images, idx, max_deg, n_angles)
    if masks is None:
        return imgs
    return imgs, rotate_quantized(masks, idx, max_deg, n_angles, nearest=True)
