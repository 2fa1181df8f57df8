"""Offline MoNuSeg patch extraction and augmentation (counterpart of
``ugpg_tpu/cli/augment_monuseg.py``).

    python -m ugpg_tpu_torch.cli.augment_monuseg --data_dir DIR [--patch 256] \
        [--stride 128] [--variants 3] [--seed 42] [--split train]

256 x 256 patches at stride 128 from the split's 1000 x 1000 tiles, their
polygons cropped to patch-level XMLs, then ``--variants`` augmented
copies of each patch with HFlip(.5) / VFlip(.5) / RandomRotate90(.5) /
RandomBrightnessContrast(.4) / HueSaturationValue(.3) /
ElasticTransform(alpha 50, sigma 5, .3) / GridDistortion(.3) /
GaussianBlur(.2) / GaussNoise(.2): geometric steps move the polygon
vertices exactly (flips, rot90) or through the displacement field
(elastic, grid), photometric steps touch the image only.  Writes
``{split}/aug/{images,annots}``, which ``AugMoNuSegDataset`` and
``AugMoNuSegTrainer`` read.

The steps draw from one ``np.random.default_rng(seed)`` in the JAX
package's order, so the decisions, polygons and XML are the JAX
pipeline's.  The port has no PIL and no JAX: tiles decode with its own
decoders (``data/monuseg.py::load_rgb``), patches are written by its PNG
writer (``io/png.py``), the blur is Pillow's Gaussian blur bit for bit
(``native/gaussian_blur.cpp``), and the hue/saturation/value step runs
JAX's HSV arithmetic in numpy float32 (within one uint8 level of JAX's,
``tests/test_torch_augment_monuseg.py``).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from ugpg_tpu_torch import native
from ugpg_tpu_torch.data.monuseg import load_rgb
from ugpg_tpu_torch.data.rasterize import parse_polygons
from ugpg_tpu_torch.io.png import write_png

# ---------------------------------------------------------------------------
# patch extraction
# ---------------------------------------------------------------------------

def crop_polygons(polygons, x0: int, y0: int, size: int):
    """Translate polygons into patch coordinates; keep those whose bbox
    intersects the patch (vertices are clipped to the patch)."""
    kept = []
    for poly in polygons:
        shifted = poly - np.array([x0, y0])
        if (
            shifted[:, 0].max() <= 0
            or shifted[:, 1].max() <= 0
            or shifted[:, 0].min() >= size
            or shifted[:, 1].min() >= size
        ):
            continue
        kept.append(np.clip(shifted, 0, size - 1))
    return kept


def extract_patches(image: np.ndarray, polygons, patch: int = 256,
                    stride: int = 128):
    """Yield (patch_image, patch_polygons, (x0, y0)) over a regular grid."""
    h, w = image.shape[:2]
    ys = list(range(0, max(h - patch, 0) + 1, stride)) or [0]
    xs = list(range(0, max(w - patch, 0) + 1, stride)) or [0]
    for y0 in ys:
        for x0 in xs:
            tile = image[y0 : y0 + patch, x0 : x0 + patch]
            if tile.shape[0] != patch or tile.shape[1] != patch:
                continue
            yield tile, crop_polygons(polygons, x0, y0, patch), (x0, y0)


# ---------------------------------------------------------------------------
# augmentations (image + polygon keypoints)
# ---------------------------------------------------------------------------

def _hflip(img, polys, size):
    out = [p.copy() for p in polys]
    for p in out:
        p[:, 0] = size - 1 - p[:, 0]
    return img[:, ::-1], out


def _vflip(img, polys, size):
    out = [p.copy() for p in polys]
    for p in out:
        p[:, 1] = size - 1 - p[:, 1]
    return img[::-1], out


def _rot90(img, polys, size, k: int):
    out = img
    pts = [p.copy() for p in polys]
    for _ in range(k % 4):
        out = np.rot90(out)  # CCW
        for p in pts:
            x = p[:, 0].copy()
            p[:, 0] = p[:, 1]
            p[:, 1] = size - 1 - x
    return out, pts


def _brightness_contrast(img, rng):
    b = 1.0 + rng.uniform(-0.2, 0.2)
    c = 1.0 + rng.uniform(-0.2, 0.2)
    x = img.astype(np.float32)
    mean = x.mean()
    x = (x - mean) * c + mean
    x = x * b
    return np.clip(x, 0, 255).astype(np.uint8)


def _rgb_to_hsv(rgb: np.ndarray):
    """(..., 3) float32 RGB in [0, 1] -> float32 (h, s, v), the arithmetic of
    the JAX package's ``data/augment.py::_rgb_to_hsv``."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn
    safe = np.where(diff == 0, np.float32(1.0), diff)
    rc = (mx - r) / safe
    gc = (mx - g) / safe
    bc = (mx - b) / safe
    h = np.where(mx == r, bc - gc, np.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = np.where(diff == 0, np.float32(0.0), (h / 6.0) % 1.0)
    s = np.where(mx == 0, np.float32(0.0), diff / np.where(mx == 0, np.float32(1.0), mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v) -> np.ndarray:
    """Inverse of ``_rgb_to_hsv``, float32 (``data/augment.py::_hsv_to_rgb``)."""
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    i = i.astype(np.int32) % 6
    conds = [i == k for k in range(6)]
    r = np.select(conds, [v, q, p, p, t, v])
    g = np.select(conds, [t, v, v, q, p, p])
    b = np.select(conds, [p, p, t, v, v, q])
    return np.stack([r, g, b], axis=-1)


def _hsv_shift(img, rng):
    x = img.astype(np.float32) / 255.0
    # hue shift, saturation and value scales in HSV space
    dh = rng.uniform(-0.05, 0.05)
    ds = 1.0 + rng.uniform(-0.2, 0.2)
    dv = 1.0 + rng.uniform(-0.2, 0.2)
    h, s, v = _rgb_to_hsv(x)
    out = _hsv_to_rgb((h + dh) % 1.0, np.clip(s * ds, 0, 1), np.clip(v * dv, 0, 1))
    return (out.clip(0, 1) * 255).astype(np.uint8)


def _gaussian_filter2d(img: np.ndarray, sigma: float, truncate: float = 4.0):
    """Separable Gaussian blur, numerically matching
    scipy.ndimage.gaussian_filter(mode='reflect') for 2-D float64 input, in
    numpy (the JAX package's, ``tests/test_torch_augment_monuseg.py``)."""
    radius = int(truncate * float(sigma) + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    # scipy 'reflect' == np.pad 'symmetric' (edge value repeated)
    out = np.pad(img.astype(np.float64), ((radius, radius), (0, 0)), mode="symmetric")
    out = np.apply_along_axis(np.convolve, 0, out, k, mode="valid")
    out = np.pad(out, ((0, 0), (radius, radius)), mode="symmetric")
    out = np.apply_along_axis(np.convolve, 1, out, k, mode="valid")
    return out


def _smooth_field(rng, size, alpha, sigma):
    dx = _gaussian_filter2d(rng.uniform(-1, 1, (size, size)), sigma) * alpha
    dy = _gaussian_filter2d(rng.uniform(-1, 1, (size, size)), sigma) * alpha
    return dx.astype(np.float32), dy.astype(np.float32)


def _reflect_index(idx: np.ndarray, n: int) -> np.ndarray:
    """Fold integer indices into [0, n) by symmetric reflection
    (scipy mode='reflect': d c b a | a b c d | d c b a)."""
    idx = np.remainder(idx, 2 * n)
    return np.where(idx >= n, 2 * n - 1 - idx, idx)


def _bilinear_sample(plane: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """order=1 map_coordinates with reflect boundaries, in numpy."""
    n0, n1 = plane.shape
    y0 = np.floor(ys)
    x0 = np.floor(xs)
    wy = ys - y0
    wx = xs - x0
    y0i = _reflect_index(y0.astype(np.int64), n0)
    y1i = _reflect_index(y0.astype(np.int64) + 1, n0)
    x0i = _reflect_index(x0.astype(np.int64), n1)
    x1i = _reflect_index(x0.astype(np.int64) + 1, n1)
    p = plane.astype(np.float64)
    top = p[y0i, x0i] * (1 - wx) + p[y0i, x1i] * wx
    bot = p[y1i, x0i] * (1 - wx) + p[y1i, x1i] * wx
    return top * (1 - wy) + bot * wy


def _remap(img, map_x, map_y):
    out = np.empty_like(img)
    for ch in range(img.shape[2]):
        samp = _bilinear_sample(img[..., ch], map_y, map_x)
        if np.issubdtype(img.dtype, np.integer):
            samp = np.rint(samp)
        out[..., ch] = samp.astype(img.dtype)
    return out


def _elastic(img, polys, size, rng, alpha=50.0, sigma=5.0):
    dx, dy = _smooth_field(rng, size, alpha, sigma)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    warped = _remap(img, xx + dx, yy + dy)
    out_polys = []
    for p in polys:
        xi = np.clip(p[:, 0].astype(int), 0, size - 1)
        yi = np.clip(p[:, 1].astype(int), 0, size - 1)
        # keypoints move against the sampling field (albumentations-style)
        moved = np.stack([p[:, 0] - dx[yi, xi], p[:, 1] - dy[yi, xi]], axis=1)
        out_polys.append(np.clip(moved, 0, size - 1))
    return warped, out_polys


def _grid_distortion(img, polys, size, rng, num_steps=5, limit=0.3):
    # per-cell scale factors -> monotone coordinate remap per axis
    def axis_map(n):
        steps = 1.0 + rng.uniform(-limit, limit, num_steps)
        xs = np.linspace(0, size, num_steps + 1)
        pos = [0.0]
        for i in range(num_steps):
            pos.append(pos[-1] + (xs[i + 1] - xs[i]) * steps[i])
        pos = np.asarray(pos) * (size - 1) / max(pos[-1], 1e-6)
        # dense inverse map: for each output coord, source coord
        dense_src = np.interp(np.arange(size), pos, xs[: num_steps + 1] * (size - 1) / size)
        fwd = np.interp(np.arange(size), xs[: num_steps + 1] * (size - 1) / size, pos)
        return dense_src.astype(np.float32), fwd.astype(np.float32)

    src_x, fwd_x = axis_map(size)
    src_y, fwd_y = axis_map(size)
    map_x = np.broadcast_to(src_x, (size, size))
    map_y = np.broadcast_to(src_y[:, None], (size, size))
    warped = _remap(img, map_x, map_y)
    out_polys = []
    for p in polys:
        xi = np.clip(p[:, 0], 0, size - 1)
        yi = np.clip(p[:, 1], 0, size - 1)
        out_polys.append(
            np.stack([np.interp(xi, np.arange(size), fwd_x),
                      np.interp(yi, np.arange(size), fwd_y)], axis=1)
        )
    return warped, out_polys


def _blur(img, rng):
    radius = rng.uniform(0.5, 1.5)
    return native.gaussian_blur(img, radius)  # Pillow's GaussianBlur(radius), bit for bit


def _noise(img, rng):
    sigma = rng.uniform(5, 20)
    x = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def augment_patch(img: np.ndarray, polys, rng: np.random.Generator):
    """One augmented variant (AUGMENTATION.md probability table)."""
    size = img.shape[0]
    if rng.random() < 0.5:
        img, polys = _hflip(img, polys, size)
    if rng.random() < 0.5:
        img, polys = _vflip(img, polys, size)
    if rng.random() < 0.5:
        img, polys = _rot90(img, polys, size, int(rng.integers(1, 4)))
    img = np.ascontiguousarray(img)
    if rng.random() < 0.4:
        img = _brightness_contrast(img, rng)
    if rng.random() < 0.3:
        img = _hsv_shift(img, rng)
    if rng.random() < 0.3:
        img, polys = _elastic(img, polys, size, rng)
    if rng.random() < 0.3:
        img, polys = _grid_distortion(img, polys, size, rng)
    if rng.random() < 0.2:
        img = _blur(img, rng)
    if rng.random() < 0.2:
        img = _noise(img, rng)
    return img, polys


# ---------------------------------------------------------------------------
# XML writing and the pipeline
# ---------------------------------------------------------------------------

def polygons_to_xml(polygons, microns_per_pixel: float = 0.252) -> str:
    regions = []
    for poly in polygons:
        verts = "".join(
            f'<Vertex X="{float(x):.2f}" Y="{float(y):.2f}"/>' for x, y in poly
        )
        regions.append(f"<Region><Vertices>{verts}</Vertices></Region>")
    return (
        f'<?xml version="1.0"?>\n'
        f'<Annotations MicronsPerPixel="{microns_per_pixel}">'
        f"<Annotation><Regions>{''.join(regions)}</Regions></Annotation>"
        f"</Annotations>"
    )


def run_pipeline(
    data_dir: str,
    patch: int = 256,
    stride: int = 128,
    variants: int = 3,
    seed: int = 42,
    split: str = "train",
) -> int:
    """Write patches + augmented variants to {split}/aug/{images,annots}.
    Returns the number of patches written."""
    images_dir = Path(data_dir) / split / "images"
    annots_dir = Path(data_dir) / split / "annots"
    out_img = Path(data_dir) / split / "aug" / "images"
    out_ann = Path(data_dir) / split / "aug" / "annots"
    out_img.mkdir(parents=True, exist_ok=True)
    out_ann.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    written = 0
    t0 = time.perf_counter()
    for name in sorted(os.listdir(images_dir)):
        if not name.lower().endswith((".tif", ".tiff", ".png")):
            continue
        stem = name.rsplit(".", 1)[0]
        xml = annots_dir / f"{stem}.xml"
        if not xml.exists():
            continue
        image = load_rgb(str(images_dir / name))
        polygons = parse_polygons(xml)
        for tile, tile_polys, (x0, y0) in extract_patches(image, polygons, patch, stride):
            base = f"{stem}_{y0}_{x0}"
            write_png(out_img / f"{base}.png", tile)
            (out_ann / f"{base}.xml").write_text(polygons_to_xml(tile_polys))
            written += 1
            for v in range(variants):
                aug_img, aug_polys = augment_patch(tile, tile_polys, rng)
                vbase = f"{base}_aug{v}"
                write_png(out_img / f"{vbase}.png", np.ascontiguousarray(aug_img))
                (out_ann / f"{vbase}.xml").write_text(polygons_to_xml(aug_polys))
                written += 1
    print(f"Wrote {written} patches to {out_img.parent} in {time.perf_counter() - t0:.3f} s")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Offline MoNuSeg patch extraction and augmentation (PyTorch port)")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--patch", type=int, default=256)
    p.add_argument("--stride", type=int, default=128)
    p.add_argument("--variants", type=int, default=3)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--split", default="train")
    args = p.parse_args(argv)
    return run_pipeline(args.data_dir, args.patch, args.stride, args.variants, args.seed,
                        args.split)


def cli(argv=None) -> int:
    """Console entry: 0 after a run (errors raise)."""
    main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
