"""Reference-format ``.pth`` checkpoints.

The container is the reference trainer's schema ``{stage, epoch,
model_state_dict, optimizer_state_dict, val_dice, train_dice,
uncertainty_alpha, history}``; the reader takes its stage from it, and a
bare state dict is stage 4, as the reference's loader assumes.  The
JAX package reads the same file (its ``io/torch_import.py``).  JAX
msgpack/orbax checkpoint directories are not read here:
``ugpg-export-torch`` converts them to ``.pth``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(path: str | os.PathLike, state_dict: Mapping[str, torch.Tensor],
                    **metadata: Any) -> Path:
    """Write ``{**metadata, 'model_state_dict': state_dict}`` as ``path``
    (tensors moved to the CPU).  ``metadata`` carries the schema's other
    keys: ``stage``, ``epoch``, ``optimizer_state_dict``, ``val_dice``,
    ``train_dice``, ``uncertainty_alpha``, ``history``.  The file appears
    whole or not at all (written beside it, then renamed)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = {**metadata, "model_state_dict": {k: v.detach().cpu() for k, v in state_dict.items()}}
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str | os.PathLike) -> tuple[int, dict[str, torch.Tensor]]:
    """-> (stage, state dict of CPU tensors)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict or a checkpoint container")
    if "model_state_dict" in obj:
        return int(obj.get("stage", 4)), dict(obj["model_state_dict"])
    return 4, dict(obj)
