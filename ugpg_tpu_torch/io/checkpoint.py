"""Reference-format ``.pth`` checkpoints (read side).

A container ``{stage, model_state_dict, ...}`` (as written by
``ugpg-export-torch``) gives its stage; a bare state dict is stage 4, as
the reference's loader assumes.  JAX msgpack/orbax checkpoint directories
are not read here: ``ugpg-export-torch`` converts them to ``.pth``.
"""

from __future__ import annotations

import os

import torch

__all__ = ["load_checkpoint"]


def load_checkpoint(path: str | os.PathLike) -> tuple[int, dict[str, torch.Tensor]]:
    """-> (stage, state dict of CPU tensors)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict or a checkpoint container")
    if "model_state_dict" in obj:
        return int(obj.get("stage", 4)), dict(obj["model_state_dict"])
    return 4, dict(obj)
