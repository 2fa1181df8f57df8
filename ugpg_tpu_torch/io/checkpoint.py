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

The reference's Herlev classifier holds a whole ``PGUNet{stage}``, so its
``.pth`` carries the decoder's keys too, which its forward never reads.
``full_classifier_state_dict`` writes that key set, the missing blocks
filled from a seeded fresh initialisation of the segmentation stage (the
JAX export does the same); ``classifier_state_dict`` reads it back,
dropping only the ``unet.`` keys of blocks the stage's encoder lacks.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "read_checkpoint", "container_stage",
           "has_checkpoint", "sniff_stage", "classifier_decoder_fill",
           "full_classifier_state_dict", "classifier_state_dict"]


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


def _decoder_blocks(stage: int) -> set[str]:
    """The blocks of ``PGUNet{stage}`` the stage's classifier encoder lacks."""
    from ugpg_tpu_torch.models.classifier import ENCODER_SPECS
    from ugpg_tpu_torch.models.pgunet import STAGE_BLOCKS

    return set(STAGE_BLOCKS[stage]) - {"inc"} - {name for name, _ in ENCODER_SPECS[stage][1]}


def classifier_decoder_fill(stage: int, seed: int = 0) -> dict[str, torch.Tensor]:
    """``unet.``-prefixed CPU tensors of the blocks of ``PGUNet{stage}``
    (one class) that the stage's classifier lacks, from torch's default
    initialisation drawn from ``torch.Generator().manual_seed(seed)``."""
    from ugpg_tpu_torch.models.blocks import init_parameters
    from ugpg_tpu_torch.models.pgunet import STAGE_MODELS

    template = STAGE_MODELS[stage](num_classes=1)
    init_parameters(template, torch.Generator().manual_seed(seed))
    blocks = _decoder_blocks(stage)
    return {f"unet.{k}": v for k, v in template.state_dict().items()
            if k.split(".", 1)[0] in blocks}


def full_classifier_state_dict(state_dict: Mapping[str, torch.Tensor], stage: int,
                               fill: Mapping[str, torch.Tensor] | None = None
                               ) -> dict[str, torch.Tensor]:
    """A classifier's state dict with the reference's full ``unet`` key set:
    ``fill`` (``classifier_decoder_fill(stage)`` when None) adds the keys
    the classifier lacks; its own keys always win."""
    out = dict(fill if fill is not None else classifier_decoder_fill(stage))
    out.update(state_dict)
    return out


def classifier_state_dict(state_dict: Mapping[str, torch.Tensor], stage: int
                          ) -> dict[str, torch.Tensor]:
    """A reference classifier state dict without the ``unet.`` keys of the
    decoder blocks; every other key is kept, so that a strict load still
    raises on anything else missing or unexpected."""
    blocks = _decoder_blocks(stage)
    return {k: v for k, v in state_dict.items()
            if not (k.startswith("unet.") and k.split(".", 2)[1] in blocks)}
