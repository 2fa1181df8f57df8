"""AugMoNuSegTrainer: the progressive trainer over the MoNuSeg tree
(counterpart of ``ugpg_tpu/train/aug_trainer.py``).

Per stage it builds an ``AugMoNuSegDataset`` (``train/aug``) and a
``MoNuSegDataset`` (``val``) at the stage's resolution, splits ``train``
80/20 when there is no ``val``, and sets the BCE ``pos_weight`` to
``(1 - r) / r``, r the positive-pixel share of the first stage's training
masks.  ``pos_weight`` is a float the train step takes per call: nothing is
rebuilt when it changes.  Train steps augment on the device
(``augment=True`` by default).

    trainer = AugMoNuSegTrainer(fused_loss=True)
    trainer.setup_datasets(data_dir)
    train_loaders, val_loaders = trainer.make_loaders(batch_size=8, num_workers=4)
    trainer.train_progressive(train_loaders, val_loaders, save_dir=...)
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np

from ugpg_tpu_torch.data.loader import DataLoader
from ugpg_tpu_torch.data.monuseg import AugMoNuSegDataset, MoNuSegDataset, create_train_val_split
from ugpg_tpu_torch.parallel import distributed
from ugpg_tpu_torch.train.seg_trainer import (
    DEFAULT_STAGE_CONFIGS,
    UncertaintyGuidedProgressiveTrainer,
)

__all__ = ["AugMoNuSegTrainer", "compute_pos_weight"]


def compute_pos_weight(dataset, max_samples: int | None = None) -> float:
    """pos_weight = (1 - r) / r over the dataset's masks (1.0 without
    positives)."""
    pos = 0.0
    total = 0.0
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for i in range(n):
        _, mask = dataset[i]
        pos += float(np.sum(mask))
        total += float(mask.size)
    ratio = pos / max(total, 1.0)
    if ratio <= 0.0:
        return 1.0
    return float((1.0 - ratio) / ratio)


class AugMoNuSegTrainer(UncertaintyGuidedProgressiveTrainer):
    """Progressive trainer wired to the augmented MoNuSeg data path."""

    def __init__(self, config: Mapping[str, Any] | None = None, **kwargs):
        config = dict(config or {})
        self.config = config
        kwargs.setdefault("uncertainty_alpha", config.get("uncertainty_alpha", 1.0))
        kwargs.setdefault("augment", True)
        if "stage_configs" not in kwargs and "epochs_per_stage" in config:
            # config["lr"] is None unless overridden: None keeps each stage's
            kwargs["stage_configs"] = {
                s: {**cfg, "epochs_per_stage": config["epochs_per_stage"],
                    "lr": config.get("lr") or cfg["lr"]}
                for s, cfg in DEFAULT_STAGE_CONFIGS.items()
            }
        super().__init__(**kwargs)
        self.train_datasets: dict[int, Any] = {}
        self.val_datasets: dict[int, Any] = {}

    def setup_datasets(self, data_dir: str, stages=(1, 2, 3, 4)):
        """Per-stage AugMoNuSeg train and MoNuSeg val datasets, and the
        automatic pos_weight."""
        # every process decides before process 0 writes the split, then waits for it
        if distributed.agree(not os.path.isdir(os.path.join(data_dir, "val"))):
            if distributed.is_writer():
                print("No val/ split found; creating 80/20 split from train/")
                create_train_val_split(data_dir, val_ratio=0.2, seed=42)
            distributed.barrier()
        for stage in stages:
            res = self.stage_configs[stage]["resolution"]
            self.train_datasets[stage] = AugMoNuSegDataset(data_dir, image_size=res,
                                                           split="train", augment=True)
            self.val_datasets[stage] = MoNuSegDataset(data_dir, image_size=res, split="val",
                                                      augment=False)
        self.pos_weight = compute_pos_weight(self.train_datasets[min(self.train_datasets)])
        print(f"Auto-computed pos_weight: {self.pos_weight:.4f}")
        return self.train_datasets, self.val_datasets

    def make_loaders(self, batch_size: int = 8, num_workers: int = 4):
        """Per-stage loaders: shuffled training batches (seed 42 + stage, as
        the JAX trainer's), validation in order; over several processes
        each loads its own share of the datasets (``process_shard``)."""
        train_loaders = {
            s: DataLoader(distributed.process_shard(ds), batch_size=batch_size, shuffle=True,
                          num_workers=num_workers, seed=42 + s)
            for s, ds in self.train_datasets.items()
        }
        val_loaders = {s: DataLoader(distributed.process_shard(ds), batch_size=batch_size,
                                     num_workers=num_workers)
                       for s, ds in self.val_datasets.items()}
        return train_loaders, val_loaders
