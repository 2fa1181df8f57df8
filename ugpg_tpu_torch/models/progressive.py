"""ProgressiveUNet: the user-facing module over the four PG stages
(counterpart of ``ugpg_tpu/models/progressive.py``).

The reference's README API, ``ProgressiveUNet(in_channels=3,
out_channels=1, stage=1)``, with its code's behaviour: ``set_stage``
selects the stage, and ``forward`` resizes the input to the stage's
resolution (bilinear, align_corners) before running it.  The module holds
the stage models, each built at its first use; ``transfer_weights`` is the
name-keyed overlap merge of two stages' state dicts.
``task_type="classification"`` holds the four Herlev classifiers
(``models/classifier.py``) at their resolutions, 224 px at stage 4.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from ugpg_tpu_torch.models.classifier import CLS_STAGE_RESOLUTIONS, HerlevClassificationModel
from ugpg_tpu_torch.models.pgunet import STAGE_MODELS, STAGE_RESOLUTIONS
from ugpg_tpu_torch.ops.resize import resize_bilinear_align_corners
from ugpg_tpu_torch.progressive.transfer import transfer_weights as _transfer

__all__ = ["ProgressiveUNet"]


class ProgressiveUNet(nn.Module):
    """The four stages behind one module.

    Example:
        model = ProgressiveUNet(in_channels=3, out_channels=1, stage=1)
        logits = model(images)                 # NCHW in, stage-resolution logits out
        model.set_stage(2)
    """

    def __init__(self, in_channels: int = 3, out_channels: int | None = None,
                 num_classes: int | None = None, stage: int = 1,
                 task_type: str = "segmentation", dtype: torch.dtype = torch.float32):
        super().__init__()
        if task_type not in ("segmentation", "classification"):
            raise ValueError(f"unknown task_type: {task_type!r}")
        if out_channels is None and num_classes is None:
            out_channels = 1
        self.in_channels = in_channels
        self.num_classes = int(out_channels if out_channels is not None else num_classes)
        self.task_type = task_type
        self.dtype = dtype
        self.stage_resolutions = dict(STAGE_RESOLUTIONS if task_type == "segmentation"
                                      else CLS_STAGE_RESOLUTIONS)
        self.stages = nn.ModuleDict()
        self.current_stage = 1
        self.set_stage(stage)

    def set_stage(self, stage: int) -> None:
        if stage not in (1, 2, 3, 4):
            raise ValueError("Stage must be 1, 2, 3, or 4")
        self.current_stage = stage

    def get_current_resolution(self) -> int:
        return self.stage_resolutions[self.current_stage]

    def module(self, stage: int | None = None) -> nn.Module:
        """The stage's model (the current stage by default), built at first use."""
        key = str(stage or self.current_stage)
        if key not in self.stages:
            if self.task_type == "classification":
                model = HerlevClassificationModel(int(key), self.num_classes, dtype=self.dtype,
                                                  in_channels=self.in_channels)
            else:
                model = STAGE_MODELS[int(key)](num_classes=self.num_classes, dtype=self.dtype,
                                               in_channels=self.in_channels)
            self.stages[key] = model.train(self.training)  # the facade's mode
        return self.stages[key]

    def forward(self, x: torch.Tensor, stage: int | None = None,
                target_resolution: int | None = None) -> torch.Tensor:
        """(N, C, H, W) at any size, resized to the stage's resolution (or
        ``target_resolution``) -> the stage's logits."""
        stage = stage or self.current_stage
        res = target_resolution or self.stage_resolutions[stage]
        return self.module(stage)(resize_bilinear_align_corners(x, (res, res)))

    def transfer_weights(self, prev_stage_state: Mapping[str, torch.Tensor],
                         current_stage_state: Mapping[str, torch.Tensor],
                         stage: int | None = None, verbose: bool = True) -> dict:
        """The current stage's state dict with every overlapping slab of the
        previous stage's copied in (by name)."""
        merged, copied = _transfer(prev_stage_state, current_stage_state)
        if verbose:
            print(f"transfer_weights(stage={stage or self.current_stage}): "
                  f"copied {len(copied)} keys (examples: {copied[:5]})")
        return merged
