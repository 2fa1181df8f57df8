"""Reference-format ``.pth`` checkpoints.

The container is the reference trainer's schema ``{stage, epoch,
model_state_dict, optimizer_state_dict, val_dice, train_dice,
uncertainty_alpha, history}``; the reader takes its stage from it, and a
bare state dict is stage 4, as the reference's loader assumes.  The
JAX package reads the same file (its ``io/torch_import.py``).  JAX
msgpack/orbax checkpoint directories are not read here:
``ugpg-export-torch`` converts them to ``.pth``.

A file is written beside its name and renamed into place, so a checkpoint
that exists is whole: ``has_checkpoint`` is the existence of the file (the
JAX package's check that the data of a directory is there).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "read_checkpoint", "container_stage",
           "has_checkpoint", "sniff_stage"]


def _to_cpu(obj):
    """Every tensor of a nested dict/list on the CPU, detached."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str | os.PathLike, state_dict: Mapping[str, torch.Tensor],
                    **metadata: Any) -> Path:
    """Write ``{**metadata, 'model_state_dict': state_dict}`` as ``path``
    (tensors moved to the CPU).  ``metadata`` carries the schema's other
    keys: ``stage``, ``epoch``, ``optimizer_state_dict``, ``val_dice``,
    ``train_dice``, ``uncertainty_alpha``, ``history``.  The file appears
    whole or not at all (written beside it, then renamed)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = _to_cpu({**metadata, "model_state_dict": dict(state_dict)})
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def read_checkpoint(path: str | os.PathLike) -> dict[str, Any]:
    """The whole container as a dict (a bare state dict comes back as
    ``{'model_state_dict': ...}``), tensors on the CPU."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict or a checkpoint container")
    if "model_state_dict" in obj:
        return obj
    return {"model_state_dict": obj}


def container_stage(obj: Mapping[str, Any], default: int = 4) -> int:
    """The stage of a container from ``read_checkpoint``: its ``stage``,
    else ``default`` (the reference assumes a bare state dict is stage 4)."""
    return int(obj["stage"]) if "stage" in obj else default


def load_checkpoint(path: str | os.PathLike) -> tuple[int, dict[str, torch.Tensor]]:
    """-> (stage, state dict of CPU tensors)."""
    obj = read_checkpoint(path)
    return container_stage(obj), dict(obj["model_state_dict"])


def has_checkpoint(path: str | os.PathLike) -> bool:
    """True if ``path`` is a checkpoint file."""
    return Path(path).is_file()


def sniff_stage(path: str | os.PathLike, default: int = 4) -> int:
    """The stage of the checkpoint file ``path`` (see ``container_stage``)."""
    return container_stage(read_checkpoint(path), default)
