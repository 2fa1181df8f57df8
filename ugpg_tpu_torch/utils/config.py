"""Typed training configuration (counterpart of ``ugpg_tpu/utils/config.py``).

Dataclasses for the two workloads with the reference's defaults,
``apply_overrides`` for command-line values, and JSON ``save_config`` /
``load_config``.  The JSON is the JAX package's: a file either package
writes loads in the other.  ``checkpoint_backend`` names a backend the
port's trainers take: ``msgpack`` (the JAX package's directories, this
config's default as it is the JAX package's), ``orbax``, ``orbax-async``
(its orbax directories) or ``pth``.  The port's trainers and commands
themselves default to ``pth``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

__all__ = ["SegTrainConfig", "HerlevTrainConfig", "apply_overrides", "load_config",
           "save_config"]


@dataclass
class SegTrainConfig:
    """MoNuSeg segmentation training (ref defaults:
    train_aug_monuseg.py:126-162, uncertainty_guided_trainer.py:42-47)."""

    data_dir: str = "./data/MoNuSeg"
    output_dir: str = "./monuseg_outputs"
    stages: list[int] = field(default_factory=lambda: [1, 2, 3, 4])
    epochs_per_stage: int = 50
    batch_size: int = 8
    lr_stage1: float = 3e-4
    lr_later: float = 1e-4
    weight_decay: float = 1e-4
    uncertainty_alpha: float = 1.0
    pos_weight: float | None = None  # None = auto-compute from masks
    num_workers: int = 4
    augment: bool = True
    use_aug_dataset: bool = True
    bf16: bool = False
    fused_loss: bool = False
    # whole-epoch chunks (one CUDA graph replay per step on a card, one
    # metric read per epoch); same trajectory as the per-step path.  The
    # chunk cap is the trainers' scan_chunk_bytes (1 << 30, as in the JAX
    # package, whose config has no field for it either)
    scan_epochs: bool = False
    seed: int = 0
    # distribution + checkpoint backend (exposed as --mesh /
    # --checkpoint_backend on the train CLIs; see cli/train_monuseg.py)
    mesh: str | None = None  # "DATA,MODEL" or "auto"; None = single device
    checkpoint_backend: str = "msgpack"  # msgpack | pth | orbax | orbax-async

    def stage_configs(self) -> dict[int, dict]:
        res = {1: 32, 2: 64, 3: 128, 4: 256}
        return {
            s: {
                "resolution": res[s],
                "epochs_per_stage": self.epochs_per_stage,
                "lr": self.lr_stage1 if s == 1 else self.lr_later,
            }
            for s in (1, 2, 3, 4)
        }


@dataclass
class HerlevTrainConfig:
    """Herlev classification training (ref defaults:
    train_herlev.py:506-548)."""

    data_dir: str = ""
    output_dir: str = "./herlev_outputs"
    binary_classification: bool = False
    num_classes: int = 7
    stages: list[int] = field(default_factory=lambda: [1, 2, 3, 4])
    epochs_per_stage: int = 30
    batch_size: int = 16
    weight_decay: float = 1e-4
    uncertainty_alpha: float = 1.0
    early_stopping_patience: int = 15
    num_workers: int = 4
    log_interval: int = 10
    augment: bool = True
    bf16: bool = False
    scan_epochs: bool = False  # as SegTrainConfig's
    seed: int = 0
    mesh: str | None = None
    checkpoint_backend: str = "msgpack"
    class_weights: list[float] | None = None
    split_ratios: dict[str, float] = field(
        default_factory=lambda: {"train": 0.7, "val": 0.2, "test": 0.1}
    )
    pretrained_unet_paths: dict[int, str] = field(default_factory=dict)

    def as_trainer_config(self) -> dict:
        cfg = dataclasses.asdict(self)
        if self.binary_classification:
            cfg["num_classes"] = 2
        return cfg


def apply_overrides(cfg, **overrides):
    """Return a copy with non-None overrides applied (CLI integration)."""
    updates = {k: v for k, v in overrides.items() if v is not None}
    return dataclasses.replace(cfg, **updates)


def save_config(cfg, path: str | Path) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "__config_class__": type(cfg).__name__,
        **dataclasses.asdict(cfg),
    }
    path.write_text(json.dumps(payload, indent=2, default=str))
    return path


def load_config(path: str | Path):
    data = json.loads(Path(path).read_text())
    cls_name = data.pop("__config_class__", "SegTrainConfig")
    cls = {"SegTrainConfig": SegTrainConfig, "HerlevTrainConfig": HerlevTrainConfig}[
        cls_name
    ]
    known = {f.name for f in dataclasses.fields(cls)}
    kwargs: dict[str, Any] = {k: v for k, v in data.items() if k in known}
    if "stages" in kwargs:
        kwargs["stages"] = [int(s) for s in kwargs["stages"]]
    if "pretrained_unet_paths" in kwargs and kwargs["pretrained_unet_paths"]:
        kwargs["pretrained_unet_paths"] = {
            int(k): v for k, v in kwargs["pretrained_unet_paths"].items()
        }
    return cls(**kwargs)
