"""MoNuSeg dataset: TIFF or PNG images + XML polygon annotations ->
(image, mask) (counterpart of ``ugpg_tpu/data/monuseg.py``), without PIL.

* pairs ``{split}/images/*.{tif,tiff,png}`` with ``{split}/annots/*.xml`` by
  basename, warns about and skips orphans, raises when nothing pairs up;
* decodes with the port's C++ decoders (``ugpg_tpu_torch.native``): any
  other extension, or a file outside a decoder's profile, raises;
* rasterizes the XML polygons at full resolution with Pillow's fill
  (``data/rasterize.py``), then resizes: the image by the antialiased
  uint8 bilinear resize of ``F.interpolate`` (within one gray level of
  PIL's ``BILINEAR``), the mask by PIL's ``NEAREST`` index rule, exactly;
* returns a float32 HWC image in [0, 1] and a float32 (H, W, 1) mask.

Train-time augmentation runs on the device (``data/augment.py``), in the
train step; the ``augment`` flag records the intent.
"""

from __future__ import annotations

import functools
import os
import random
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ugpg_tpu_torch import native
from ugpg_tpu_torch.data.rasterize import annotation_info, parse_polygons, rasterize_polygons

__all__ = ["MoNuSegDataset", "AugMoNuSegDataset", "create_train_val_split", "load_rgb",
           "resize_image", "resize_mask"]

_IMG_EXTS = (".tif", ".tiff", ".png")


def load_rgb(img_path: str) -> np.ndarray:
    """Decode a ``.png``, ``.tif``, ``.tiff`` or ``.bmp`` image to (H, W, 3)
    uint8; any other extension raises ``ValueError``."""
    low = str(img_path).lower()
    if low.endswith(".png"):
        return native.decode_png(img_path)
    if low.endswith((".tif", ".tiff")):
        return native.decode_tiff(img_path)
    if low.endswith(".bmp"):
        return native.decode_bmp(img_path)
    raise ValueError(f"{img_path}: no decoder for this extension (the port reads "
                     f"{', '.join(_IMG_EXTS)}, .bmp)")


@functools.lru_cache(maxsize=None)
def _nearest_index(n_in: int, n_out: int) -> np.ndarray:
    """PIL's NEAREST source index of each of ``n_out`` samples: the
    position ``(i + 0.5) * n_in / n_out`` accumulated in float64 one step
    at a time, then truncated, as Pillow's affine scaling does (its
    rounding differs from ``nearest-exact`` at ratios like 1000 -> 300)."""
    scale = n_in / n_out
    idx = np.empty(n_out, np.int64)
    v = scale * 0.5
    for i in range(n_out):
        idx[i] = int(v)
        v += scale
    return idx


def resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """(H, W) array -> (size, size) by PIL's NEAREST rule, exactly."""
    h, w = mask.shape[:2]
    if (h, w) == (size, size):
        return mask
    return mask[_nearest_index(h, size)][:, _nearest_index(w, size)]


def resize_image(image: np.ndarray, size: int | tuple[int, int]) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) uint8, or (h, w, 3) for a
    ``size`` of (h, w): bilinear with antialias on uint8 ``channels_last``
    on the CPU, within one gray level of PIL's ``BILINEAR``."""
    hw = (size, size) if isinstance(size, int) else tuple(size)
    if image.shape[:2] == hw:
        return image
    x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    out = F.interpolate(x.contiguous(memory_format=torch.channels_last), size=hw,
                        mode="bilinear", antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


class MoNuSegDataset:
    """Nuclei segmentation dataset (images + XML polygon annotations)."""

    def __init__(
        self,
        data_dir: str,
        image_size: int = 256,
        split: str = "train",
        transform: bool = True,
        augment: bool = True,
        images_subdir: str = "images",
        annots_subdir: str = "annots",
    ):
        self.data_dir = data_dir
        self.image_size = image_size
        self.split = split
        self.transform = transform
        # augmentation intent; applied on the device by the train step
        self.augment = augment and split == "train"

        self.images_dir = os.path.join(data_dir, split, images_subdir)
        self.annotations_dir = os.path.join(data_dir, split, annots_subdir)

        names = sorted(f for f in os.listdir(self.images_dir) if f.lower().endswith(_IMG_EXTS))
        self.samples: list[tuple[str, str]] = []
        missing = []
        for img_name in names:
            stem = img_name.rsplit(".", 1)[0]
            annot = os.path.join(self.annotations_dir, stem + ".xml")
            if os.path.exists(annot):
                self.samples.append((os.path.join(self.images_dir, img_name), annot))
            else:
                missing.append(img_name)
        if missing:
            print(f"Warning: {len(missing)} images have no matching annotation "
                  f"and will be skipped (examples: {missing[:5]})")
        if not self.samples:
            raise RuntimeError(f"No image-annotation pairs found in "
                               f"{self.images_dir} / {self.annotations_dir}")
        self.image_files = [os.path.basename(p) for p, _ in self.samples]
        self.annotation_files = [os.path.basename(a) for _, a in self.samples]
        print(f"MoNuSeg {split} dataset: {len(self.samples)} samples")

    def __len__(self) -> int:
        return len(self.samples)

    def load_raw(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """Full-resolution (image uint8 HWC, mask uint8 HW)."""
        img_path, annot_path = self.samples[idx]
        img_np = load_rgb(img_path)
        mask = rasterize_polygons(parse_polygons(annot_path), img_np.shape[:2])
        return img_np, mask

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        img_np, mask = self.load_raw(idx)
        if self.transform:
            img_np = resize_image(img_np, self.image_size)
            mask = resize_mask(mask, self.image_size)
        image_f = img_np.astype(np.float32) / 255.0
        mask_f = mask.astype(np.float32)[..., None]
        return image_f, mask_f

    def update_image_size(self, new_size: int):
        """Progressive resolution switching."""
        self.image_size = new_size
        print(f"Updated dataset image size to {new_size}x{new_size}")

    def get_sample_info(self, idx: int) -> dict[str, Any]:
        img_path, annot_path = self.samples[idx]
        h, w = native.image_hw(img_path)
        return {
            "image_file": os.path.basename(img_path),
            "annotation_file": os.path.basename(annot_path),
            "original_size": (w, h),
            **annotation_info(annot_path),
        }


class AugMoNuSegDataset(MoNuSegDataset):
    """Pre-augmented patch dataset reading ``{split}/aug/{images,annots}``;
    ``augment=True`` applies the device augmentation whatever the split."""

    def __init__(self, data_dir: str, image_size: int = 256, split: str = "train",
                 transform: bool = True, augment: bool = True):
        super().__init__(data_dir, image_size=image_size, split=split, transform=transform,
                         augment=False, images_subdir=os.path.join("aug", "images"),
                         annots_subdir=os.path.join("aug", "annots"))
        self.augment = augment


def create_train_val_split(data_dir: str, val_ratio: float = 0.2, seed: int = 42,
                           move: bool = False):
    """One-time seeded split of ``train/`` into ``val/``: ``random.Random(seed)``
    samples the same files as the JAX package's split."""
    train_dir = Path(data_dir) / "train"
    val_dir = Path(data_dir) / "val"
    (val_dir / "images").mkdir(parents=True, exist_ok=True)
    (val_dir / "annots").mkdir(parents=True, exist_ok=True)

    image_files = sorted(f for f in os.listdir(train_dir / "images")
                         if f.lower().endswith(_IMG_EXTS))
    rng = random.Random(seed)
    val_files = rng.sample(image_files, int(len(image_files) * val_ratio))

    op = shutil.move if move else shutil.copy2
    for img_file in val_files:
        annot_file = img_file.rsplit(".", 1)[0] + ".xml"
        op(str(train_dir / "images" / img_file), str(val_dir / "images" / img_file))
        src_annot = train_dir / "annots" / annot_file
        if src_annot.exists():
            op(str(src_annot), str(val_dir / "annots" / annot_file))
    print(f"Train/Val split complete: train={len(os.listdir(train_dir / 'images'))}, "
          f"val={len(os.listdir(val_dir / 'images'))}")
