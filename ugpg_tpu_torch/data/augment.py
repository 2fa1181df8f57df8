"""Train augmentation on the device, in torch (counterpart of
``ugpg_tpu/data/augment.py``).

MoNuSeg, per sample and jointly on image and mask: hflip p .5, then vflip
p .5, then a rotation U(-90, 90) degrees about the frame's center
(bilinear image taps, nearest mask taps, zero fill), then colour jitter
with p .8 (brightness, contrast, saturation +-0.2, hue +-0.05,
torchvision's order, the hue through an HSV round trip).
``quantize_angles=N`` draws the angle from N grid angles and rotates with
the Paeth shears of ``ops/rotate.py`` instead.

Herlev, per image: the flips, a rotation U(-15, 15), colour jitter always
(+-0.2 each, hue +-0.1), then torchvision's RandomAffine with translation
U(-0.1, 0.1) of the width and height and scale U(0.9, 1.1) (bilinear,
zero fill), on un-normalised [0, 1] RGB; ``imagenet_normalize`` follows.

Every random op is split in two: ``sample_*`` draws its parameters from an
explicit ``torch.Generator`` (on the device of the batch), and the
matching apply function takes them, so that a test can feed the parameters
the JAX package drew.  Tensors are NCHW: images (B, C, H, W) float32 in
[0, 1], masks (B, 1, H, W).  These are plain torch ops: the JAX package
runs them in XLA, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ugpg_tpu_torch.device import device_constant

__all__ = [
    "affine_sample",
    "rotation_matrices",
    "flip",
    "rotate",
    "jitter",
    "sample_flips",
    "sample_angles",
    "sample_jitter",
    "sample_monuseg_params",
    "apply_monuseg_params",
    "random_flips",
    "random_rotate",
    "random_affine",
    "color_jitter",
    "augment_monuseg_batch",
    "affine_matrices",
    "sample_herlev_params",
    "apply_herlev_params",
    "augment_herlev_batch",
    "imagenet_normalize",
]

_GRAY = (0.299, 0.587, 0.114)


# ---------------------------------------------------------------- geometry
def _uniform(generator: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def rotation_matrices(angles_deg: torch.Tensor) -> torch.Tensor:
    """(B,) angles -> (B, 2, 3) float32 inverse matrices of a
    counter-clockwise rotation of the content: source = M @ [x_out, y_out, 1].
    The radians are float32, as in the JAX package; cos and sin are taken in
    float64 and rounded to float32, so that every device gets the same
    matrix (float32 cos and sin differ by an ulp between the CPU and CUDA,
    which would move nearest mask taps that sit on a half pixel)."""
    rad = torch.deg2rad(angles_deg.to(torch.float32)).double()
    c, s = torch.cos(rad).float(), torch.sin(rad).float()
    z = torch.zeros_like(c)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1)], -2)


def affine_matrices(angles_deg: torch.Tensor, translate: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) float32 inverse matrices of rotate(angle), scale and
    translate (B, 2) in pixels (torchvision's RandomAffine composition):
    output coordinates -> source coordinates.  cos and sin as in
    ``rotation_matrices``."""
    rad = torch.deg2rad(angles_deg.to(torch.float32)).double()
    c, s = torch.cos(rad).float(), torch.sin(rad).float()
    inv = 1.0 / scales.to(torch.float32)
    m00, m01, m10, m11 = c * inv, -s * inv, s * inv, c * inv
    tx, ty = translate[:, 0].to(torch.float32), translate[:, 1].to(torch.float32)
    return torch.stack([torch.stack([m00, m01, -(m00 * tx + m01 * ty)], -1),
                        torch.stack([m10, m11, -(m10 * tx + m11 * ty)], -1)], -2)


def _source_coords(matrices: torch.Tensor, h: int, w: int):
    """Source (ys, xs), each (B, H, W), of every output pixel, coordinates
    centered on the frame's center (PIL's convention)."""
    dev = matrices.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    y_c = torch.arange(h, device=dev, dtype=torch.float32)[:, None] - cy
    x_c = torch.arange(w, device=dev, dtype=torch.float32)[None, :] - cx
    m = matrices.to(torch.float32)[:, :, :, None, None]
    xs = m[:, 0, 0] * x_c + m[:, 0, 1] * y_c + m[:, 0, 2] + cx
    ys = m[:, 1, 0] * x_c + m[:, 1, 1] * y_c + m[:, 1, 2] + cy
    return ys, xs


def _tap(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (B, C, H, W) at integer (yi, xi) (B, H', W'); zero outside."""
    b, c, h, w = img.shape
    valid = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
    flat = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
    v = torch.gather(img.reshape(b, c, h * w), 2, flat.expand(b, c, flat.shape[-1]))
    return v.reshape(b, c, *yi.shape[1:]) * valid[:, None].to(img.dtype)


def affine_sample(img: torch.Tensor, matrices: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """Warp a (B, C, H, W) batch by per-sample *inverse* affine matrices
    (B, 2, 3): bilinear (``floor`` taps) or nearest (``round``, half to
    even) sampling, zero outside the frame."""
    _, _, h, w = img.shape
    ys, xs = _source_coords(matrices, h, w)
    if mode == "nearest":
        return _tap(img, torch.round(ys).long(), torch.round(xs).long())
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy, wx = (ys - y0)[:, None], (xs - x0)[:, None]
    y0, x0 = y0.long(), x0.long()
    top = _tap(img, y0, x0) * (1 - wx) + _tap(img, y0, x0 + 1) * wx
    bot = _tap(img, y0 + 1, x0) * (1 - wx) + _tap(img, y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def flip(x: torch.Tensor, do_h: torch.Tensor, do_v: torch.Tensor) -> torch.Tensor:
    """Per sample: mirror W where ``do_h``, then H where ``do_v``."""
    x = torch.where(do_h[:, None, None, None], x.flip(3), x)
    return torch.where(do_v[:, None, None, None], x.flip(2), x)


def rotate(x: torch.Tensor, angles_deg: torch.Tensor, nearest: bool = False) -> torch.Tensor:
    """Per-sample rotation by ``angles_deg`` (B,), zero fill."""
    return affine_sample(x, rotation_matrices(angles_deg), "nearest" if nearest else "bilinear")


# ---------------------------------------------------------------- colour
def _rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    mx = rgb.amax(1)
    mn = rgb.amin(1)
    diff = mx - mn
    safe = torch.where(diff == 0, torch.ones_like(diff), diff)
    rc, gc, bc = (mx - r) / safe, (mx - g) / safe, (mx - b) / safe
    h = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(diff == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    s = torch.where(mx == 0, torch.zeros_like(mx), diff / torch.where(mx == 0, torch.ones_like(mx), mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = torch.remainder(i.long(), 6)
    # the value of each channel in the six sectors of the hue circle
    table = {0: (v, t, p), 1: (q, v, p), 2: (p, v, t), 3: (p, q, v), 4: (t, p, v), 5: (v, p, q)}
    out = []
    for ch in range(3):
        acc = torch.zeros_like(v)
        for sector, vals in table.items():
            acc = torch.where(i == sector, vals[ch], acc)
        out.append(acc)
    return torch.stack(out, 1)


def jitter(images: torch.Tensor, brightness: torch.Tensor, contrast: torch.Tensor,
           saturation: torch.Tensor, hue: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """torchvision's adjust_brightness, _contrast, _saturation, _hue chain
    with per-sample factors (B,) each (``hue`` an offset), on the samples
    where ``apply``; the others pass unchanged."""
    bf, cf, sf = (f.to(images.dtype)[:, None, None, None] for f in (brightness, contrast,
                                                                     saturation))
    x = images * bf
    weights = device_constant("gray", lambda: _GRAY, images.device, images.dtype)
    gray = torch.einsum("nchw,c->nhw", x, weights)[:, None]
    x = (1.0 - cf) * gray.mean(dim=(1, 2, 3), keepdim=True) + cf * x
    x = (1.0 - sf) * gray + sf * x  # the pre-saturation gray, torchvision's order
    x = x.clamp(0.0, 1.0)
    h, s, v = _rgb_to_hsv(x)
    x = _hsv_to_rgb(torch.remainder(h + hue.to(images.dtype)[:, None, None], 1.0), s, v)
    x = x.clamp(0.0, 1.0)
    return torch.where(apply[:, None, None, None], x, images)


# ---------------------------------------------------------------- sampling
def sample_flips(generator: torch.Generator, batch: int):
    """(do_h, do_v): per-sample Bernoulli(.5) each."""
    return (torch.rand(batch, generator=generator, device=generator.device) < 0.5,
            torch.rand(batch, generator=generator, device=generator.device) < 0.5)


def sample_angles(generator: torch.Generator, batch: int, max_deg: float = 90.0) -> torch.Tensor:
    """Per-sample angles U(-max_deg, max_deg)."""
    return _uniform(generator, batch, -max_deg, max_deg)


def sample_jitter(generator: torch.Generator, batch: int, brightness: float = 0.2,
                  contrast: float = 0.2, saturation: float = 0.2, hue: float = 0.05,
                  prob: float = 1.0) -> dict:
    """Per-sample jitter factors (1 + U(-f, f)), the hue offset U(-hue, hue)
    and ``apply`` with probability ``prob``."""
    return {
        "brightness": 1.0 + _uniform(generator, batch, -brightness, brightness),
        "contrast": 1.0 + _uniform(generator, batch, -contrast, contrast),
        "saturation": 1.0 + _uniform(generator, batch, -saturation, saturation),
        "hue": _uniform(generator, batch, -hue, hue),
        "apply": torch.rand(batch, generator=generator, device=generator.device) < prob,
    }


def sample_monuseg_params(generator: torch.Generator, batch: int, max_deg: float = 90.0,
                          quantize_angles: int = 0) -> dict:
    """Every parameter of one MoNuSeg augmentation of a batch: ``do_h``,
    ``do_v``, ``angle`` (or ``angle_index`` into ``angle_grid`` when
    ``quantize_angles``), and the jitter's (p .8)."""
    do_h, do_v = sample_flips(generator, batch)
    params = {"do_h": do_h, "do_v": do_v}
    if quantize_angles:
        params["angle_index"] = torch.randint(0, quantize_angles, (batch,), generator=generator,
                                              device=generator.device)
    else:
        params["angle"] = sample_angles(generator, batch, max_deg)
    params.update(sample_jitter(generator, batch, 0.2, 0.2, 0.2, 0.05, prob=0.8))
    return params


def apply_monuseg_params(images: torch.Tensor, masks: torch.Tensor, params: dict,
                         max_deg: float = 90.0, quantize_angles: int = 0):
    """The MoNuSeg augmentation of ``sample_monuseg_params``'s draw."""
    images = flip(images, params["do_h"], params["do_v"])
    masks = flip(masks, params["do_h"], params["do_v"])
    if quantize_angles:
        from ugpg_tpu_torch.ops.rotate import rotate_quantized

        images = rotate_quantized(images, params["angle_index"], max_deg, quantize_angles)
        masks = rotate_quantized(masks, params["angle_index"], max_deg, quantize_angles,
                                 nearest=True)
    else:
        images = rotate(images, params["angle"])
        masks = rotate(masks, params["angle"], nearest=True)
    images = jitter(images, params["brightness"], params["contrast"], params["saturation"],
                    params["hue"], params["apply"])
    return images, masks


# ---------------------------------------------------------------- random ops
def random_flips(generator: torch.Generator, images: torch.Tensor, masks=None):
    """Per-sample hflip p .5 then vflip p .5, joint on image and mask."""
    do_h, do_v = sample_flips(generator, images.shape[0])
    if masks is None:
        return flip(images, do_h, do_v)
    return flip(images, do_h, do_v), flip(masks, do_h, do_v)


def random_rotate(generator: torch.Generator, images: torch.Tensor, masks=None,
                  max_deg: float = 90.0):
    """Per-sample rotation U(-max_deg, max_deg): bilinear image, nearest
    mask, zero fill."""
    angles = sample_angles(generator, images.shape[0], max_deg)
    if masks is None:
        return rotate(images, angles)
    return rotate(images, angles), rotate(masks, angles, nearest=True)


def random_affine(generator: torch.Generator, images: torch.Tensor, max_deg: float = 0.0,
                  translate: float = 0.1, scale_range: tuple[float, float] = (0.9, 1.1)
                  ) -> torch.Tensor:
    """torchvision's RandomAffine(degrees, translate, scale) per sample of
    a (B, C, H, W) batch: angle U(-max_deg, max_deg), translation
    U(-translate, translate) of the width and the height, scale
    U(*scale_range); bilinear, zero fill."""
    b, _, h, w = images.shape
    angles = _uniform(generator, b, -max_deg, max_deg)
    t = _uniform(generator, (b, 2), -translate, translate) * torch.tensor(
        [w, h], dtype=torch.float32, device=generator.device)
    scales = _uniform(generator, b, scale_range[0], scale_range[1])
    return affine_sample(images, affine_matrices(angles, t, scales))


def color_jitter(generator: torch.Generator, images: torch.Tensor, brightness: float = 0.2,
                 contrast: float = 0.2, saturation: float = 0.2, hue: float = 0.05,
                 prob: float = 1.0) -> torch.Tensor:
    """The jitter chain with per-sample factors, applied with probability
    ``prob`` per sample."""
    p = sample_jitter(generator, images.shape[0], brightness, contrast, saturation, hue, prob)
    return jitter(images, **p)


def augment_monuseg_batch(generator: torch.Generator, images: torch.Tensor, masks: torch.Tensor,
                          max_deg: float = 90.0, quantize_angles: int = 0):
    """Joint MoNuSeg train augmentation of a batch: hflip p .5, vflip p .5,
    rotation U(-90, 90) (or one of ``quantize_angles`` grid angles), colour
    jitter p .8."""
    params = sample_monuseg_params(generator, images.shape[0], max_deg, quantize_angles)
    return apply_monuseg_params(images, masks, params, max_deg, quantize_angles)


# ---------------------------------------------------------------- Herlev
def sample_herlev_params(generator: torch.Generator, batch: int, height: int,
                         width: int) -> dict:
    """Every parameter of one Herlev augmentation of a batch of
    ``height`` x ``width`` images: ``do_h``, ``do_v``, ``angle`` (+-15),
    the jitter's (always applied) and the affine's ``translate`` (B, 2) in
    pixels and ``scale``."""
    do_h, do_v = sample_flips(generator, batch)
    params = {"do_h": do_h, "do_v": do_v, "angle": sample_angles(generator, batch, 15.0)}
    params.update(sample_jitter(generator, batch, 0.2, 0.2, 0.2, 0.1, prob=1.0))
    frac = _uniform(generator, (batch, 2), -0.1, 0.1)
    params["translate"] = frac * torch.tensor([width, height], dtype=torch.float32,
                                              device=frac.device)
    params["scale"] = _uniform(generator, batch, 0.9, 1.1)
    return params


def apply_herlev_params(images: torch.Tensor, params: dict) -> torch.Tensor:
    """The Herlev augmentation of ``sample_herlev_params``'s draw."""
    images = flip(images, params["do_h"], params["do_v"])
    images = rotate(images, params["angle"])
    images = jitter(images, params["brightness"], params["contrast"], params["saturation"],
                    params["hue"], params["apply"])
    zero = torch.zeros_like(params["scale"])
    return affine_sample(images, affine_matrices(zero, params["translate"], params["scale"]))


def augment_herlev_batch(generator: torch.Generator, images: torch.Tensor) -> torch.Tensor:
    """Herlev train augmentation of a (B, 3, H, W) batch."""
    b, _, h, w = images.shape
    return apply_herlev_params(images, sample_herlev_params(generator, b, h, w))


IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def imagenet_normalize(images: torch.Tensor) -> torch.Tensor:
    """(x - mean) / std per channel of a (B, 3, H, W) batch."""
    mean = device_constant("imagenet_mean", lambda: IMAGENET_MEAN, images.device,
                           images.dtype)[:, None, None]
    std = device_constant("imagenet_std", lambda: IMAGENET_STD, images.device,
                          images.dtype)[:, None, None]
    return (images - mean) / std
