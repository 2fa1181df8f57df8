"""Synthetic data (a copy of ``DummyDataset``, ``disk_dataset`` and
``ArrayLoader`` from ``ugpg_tpu/data/synthetic.py``), in numpy.

``DummyDataset`` holds random images and random binary masks (the
reference's demo fixture); ``disk_dataset`` is a learnable task (bright disks on a noisy background,
mask = disk), so a run can show that the loss falls.  Batches are NHWC
numpy arrays, the layout the train and eval steps take.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DummyDataset", "disk_dataset", "ArrayLoader"]


class DummyDataset:
    """Random image/mask pairs: images (S, S, C) float32 in [0, 1), masks
    (S, S, 1) float32 in {0, 1}, drawn from ``seed``."""

    def __init__(self, num_samples: int = 20, image_size: int = 64, in_channels: int = 3,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.images = rng.random((num_samples, image_size, image_size, in_channels)
                                 ).astype(np.float32)
        self.masks = (rng.random((num_samples, image_size, image_size, 1)) > 0.5
                      ).astype(np.float32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        return self.images[idx], self.masks[idx]


def disk_dataset(num_samples: int = 32, image_size: int = 64, in_channels: int = 3,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """(images (N, S, S, C) float32 in [0, 1], masks (N, S, S, 1) float32)."""
    rng = np.random.default_rng(seed)
    images = rng.random((num_samples, image_size, image_size, in_channels)).astype(np.float32) * 0.3
    masks = np.zeros((num_samples, image_size, image_size, 1), np.float32)
    yy, xx = np.mgrid[:image_size, :image_size]
    for i in range(num_samples):
        cy, cx = rng.integers(image_size // 4, 3 * image_size // 4, size=2)
        r = rng.integers(image_size // 8, image_size // 4)
        disk = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        masks[i, disk, 0] = 1.0
        images[i, disk, :] += 0.6
    return images.clip(0, 1), masks


class ArrayLoader:
    """Batched iterator over in-memory numpy arrays (shuffles per epoch)."""

    def __init__(self, *arrays: np.ndarray, batch_size: int = 8, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("arrays differ in length")
        self.arrays = arrays
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._n = n

    def __len__(self):
        if self.drop_last:
            return self._n // self.batch_size
        return (self._n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        idx = np.arange(self._n)
        if self.shuffle:
            self._rng.shuffle(idx)
        end = (self._n // self.batch_size) * self.batch_size if self.drop_last else self._n
        for start in range(0, end, self.batch_size):
            sel = idx[start:start + self.batch_size]
            yield tuple(a[sel] for a in self.arrays)
