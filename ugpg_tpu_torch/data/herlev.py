"""Herlev Pap-smear dataset: a folder per class, stratified splits
(counterpart of ``ugpg_tpu/data/herlev.py``), without PIL.

* the fixed 7-class list and the normal / abnormal mapping;
* a pre-split tree (``train/`` and ``val/`` both holding class folders) or
  an in-memory stratified split of the class folders, 70/20/10 by default,
  drawn by ``random.Random(42)`` in the JAX package's call order, so that
  both packages list the same files in every split;
* inverse-frequency class weights, the split manifest JSON, and
  ``create_herlev_splits``, which writes the splits to disk;
* images decoded by the port's C++ (``data/monuseg.py::load_rgb``: ``.bmp``,
  ``.png``, ``.tif``/``.tiff``) and resized by ``data/monuseg.py::resize_image``
  (within one gray level of PIL's ``BILINEAR``); float32 RGB in [0, 1].

A file that cannot be read at all (an ``OSError``) becomes a black image
with the JAX package's printed message, as there; a file that reads but
that a decoder rejects raises ``ValueError`` naming it (the JAX package
hands it to PIL, which the port does not have).  The train step augments
and normalises on the device (``data/augment.py``).
"""

from __future__ import annotations

import json
import os
import random
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ugpg_tpu_torch import native
from ugpg_tpu_torch.data.monuseg import load_rgb, resize_image

__all__ = ["HerlevDataset", "create_herlev_splits", "CLASS_NAMES", "BINARY_MAPPING"]

CLASS_NAMES = [
    "carcinoma_in_situ",
    "light_dysplastic",
    "moderate_dysplastic",
    "normal_columnar",
    "normal_intermediate",
    "normal_superficiel",
    "severe_dysplastic",
]

# normal (0) vs abnormal (1)
BINARY_MAPPING = {
    "carcinoma_in_situ": 1,
    "light_dysplastic": 1,
    "moderate_dysplastic": 1,
    "normal_columnar": 0,
    "normal_intermediate": 0,
    "normal_superficiel": 0,
    "severe_dysplastic": 1,
}

_IMG_EXTS = (".bmp", ".png", ".jpg", ".jpeg", ".tif")


class HerlevDataset:
    """Cervical-cell classification dataset: ``dataset[i]`` is (float32
    (H, W, 3) image in [0, 1], int label)."""

    CLASS_NAMES = CLASS_NAMES
    BINARY_MAPPING = BINARY_MAPPING

    def __init__(
        self,
        data_dir: str,
        image_size=224,
        split: str = "train",
        transform: bool = True,
        augment: bool = True,
        binary_classification: bool = False,
        normalize: bool = True,
        target_split_ratio: Optional[Dict[str, float]] = None,
        verbose: bool = True,
    ):
        self.data_dir = data_dir
        self.image_size = (
            image_size if isinstance(image_size, tuple) else (image_size, image_size)
        )
        self.split = split
        self.transform = transform
        # augmentation and normalisation intent; applied on the device
        self.augment = augment and split == "train"
        self.binary_classification = binary_classification
        self.normalize = normalize

        self.class_to_idx = {c: i for i, c in enumerate(CLASS_NAMES)}
        self.idx_to_class = {i: c for c, i in self.class_to_idx.items()}

        self.samples: list[str] = []
        self.labels: list[int] = []
        self._load(target_split_ratio)

        if verbose:
            print(f"Herlev {split} dataset loaded: {len(self.samples)} samples")
            uniq, counts = np.unique(self.labels, return_counts=True)
            for lab, cnt in zip(uniq, counts):
                print(f"    {self._class_name(int(lab))}: {cnt}")

    # -- loading ----------------------------------------------------------
    def _class_name(self, label: int) -> str:
        if self.binary_classification:
            return "abnormal" if label == 1 else "normal"
        return self.idx_to_class[label]

    def _label_for(self, class_name: str) -> int:
        if self.binary_classification:
            return BINARY_MAPPING[class_name]
        return self.class_to_idx[class_name]

    def _add_class_dir(self, class_dir: str, class_name: str, files=None):
        files = files if files is not None else sorted(
            f for f in os.listdir(class_dir) if f.lower().endswith(_IMG_EXTS)
        )
        for f in files:
            self.samples.append(os.path.join(class_dir, f))
            self.labels.append(self._label_for(class_name))

    def _load(self, ratios: Optional[Dict[str, float]]):
        # pre-split only when BOTH train/ and val/ hold class folders; a raw
        # class tree is stratified for every split (the JAX package's rule)
        def _has_classes(d):
            return os.path.isdir(d) and any(
                os.path.isdir(os.path.join(d, c)) for c in CLASS_NAMES
            )

        presplit = _has_classes(os.path.join(self.data_dir, "train")) and _has_classes(
            os.path.join(self.data_dir, "val")
        )
        split_dir = os.path.join(self.data_dir, self.split)
        if presplit and _has_classes(split_dir):
            for class_name in CLASS_NAMES:
                cdir = os.path.join(split_dir, class_name)
                if os.path.isdir(cdir):
                    self._add_class_dir(cdir, class_name)
            return

        base = None
        if _has_classes(os.path.join(self.data_dir, "train")):
            base = os.path.join(self.data_dir, "train")
        elif _has_classes(self.data_dir):
            base = self.data_dir
        if base is None:
            raise RuntimeError(
                f"Cannot find valid Herlev dataset structure in {self.data_dir}"
            )

        ratios = ratios or {"train": 0.7, "val": 0.2, "test": 0.1}
        rng = random.Random(42)  # one shuffle per class folder, in CLASS_NAMES order
        for class_name in CLASS_NAMES:
            cdir = os.path.join(base, class_name)
            if not os.path.isdir(cdir):
                continue
            files = sorted(
                f for f in os.listdir(cdir) if f.lower().endswith(_IMG_EXTS)
            )
            rng.shuffle(files)
            n = len(files)
            n_train = int(n * ratios["train"])
            n_val = int(n * ratios["val"])
            if self.split == "train":
                chosen = files[:n_train]
            elif self.split == "val":
                chosen = files[n_train : n_train + n_val]
            elif self.split == "test":
                chosen = files[n_train + n_val :]
            else:
                raise ValueError(f"Unknown split: {self.split}")
            self._add_class_dir(cdir, class_name, chosen)

    # -- access -------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, int]:
        path = self.samples[idx]
        label = self.labels[idx]
        try:
            image = load_rgb(path)
        except OSError as e:  # unreadable: the corrupted-image rule
            print(f"Error loading image {path}: {e}")
            image = np.zeros((*self.image_size, 3), np.uint8)
        if self.transform:
            image = resize_image(image, self.image_size)
        return image.astype(np.float32) / 255.0, label

    def get_class_weights(self) -> np.ndarray:
        """Inverse-frequency weights ``total / (K * count)``."""
        n_classes = 2 if self.binary_classification else len(CLASS_NAMES)
        counts = np.bincount(self.labels, minlength=n_classes)
        total = len(self.labels)
        with np.errstate(divide="ignore"):
            w = total / (n_classes * counts)
        return w.astype(np.float32)

    def get_sample_info(self, idx: int) -> dict[str, Any]:
        path = self.samples[idx]
        label = self.labels[idx]
        try:
            h, w = native.image_hw(path)
            original_size = (w, h)
        except (OSError, ValueError):
            original_size = (0, 0)
        return {
            "image_path": path,
            "filename": os.path.basename(path),
            "label": int(label),
            "class_name": self._class_name(label),
            "original_size": original_size,
            "target_size": self.image_size,
        }

    def save_split_info(self, output_dir: str):
        """The split manifest, ``{split}_split_info.json``."""
        os.makedirs(output_dir, exist_ok=True)
        uniq, counts = np.unique(self.labels, return_counts=True)
        dist = {self._class_name(int(lab)): int(cnt) for lab, cnt in zip(uniq, counts)}
        info = {
            "split": self.split,
            "total_samples": len(self.samples),
            "binary_classification": self.binary_classification,
            "class_distribution": dist,
            "samples": [self.get_sample_info(i) for i in range(len(self.samples))],
        }
        out = os.path.join(output_dir, f"{self.split}_split_info.json")
        with open(out, "w") as f:
            json.dump(info, f, indent=2)
        print(f"Split information saved to: {out}")
        return out


def create_herlev_splits(
    data_dir: str,
    output_dir: str,
    split_ratios: Optional[Dict[str, float]] = None,
    copy_files: bool = True,
):
    """Write the stratified splits to ``output_dir/{train,val,test}/<class>/``
    with their manifests."""
    split_ratios = split_ratios or {"train": 0.7, "val": 0.2, "test": 0.1}
    for split in ("train", "val", "test"):
        ds = HerlevDataset(
            data_dir,
            split=split,
            target_split_ratio=split_ratios,
            transform=False,
            verbose=False,
        )
        ds.save_split_info(output_dir)
        if copy_files:
            for i in range(len(ds)):
                info = ds.get_sample_info(i)
                cdir = Path(output_dir) / split / info["class_name"]
                cdir.mkdir(parents=True, exist_ok=True)
                dst = cdir / info["filename"]
                if not dst.exists():
                    shutil.copy2(info["image_path"], dst)
    print(f"Dataset splits created successfully in: {output_dir}")
