"""Export any checkpoint the port reads as a reference-loadable ``.pth``
(counterpart of ``ugpg_tpu/io/torch_export.py``).

The input is a ``.pth`` (the reference's container or a bare state dict)
or a JAX checkpoint directory (msgpack, orbax or orbax-async; an
orbax-async save in flight is waited for).  A directory's flax tree goes
through the port's weight bridge (``io/from_jax.py``); a ``.pth`` is
already in the reference's names and layout.  The output is the JAX
export's container, written with ``torch.save``:

* segmentation: ``{stage, epoch, model_state_dict, val_dice, train_dice,
  uncertainty_alpha}`` (the reference trainer's best checkpoint without its
  optimizer state);
* classification: ``{stage, epoch, model_state_dict, train_loss, val_loss,
  train_acc, val_acc, config}``, ``config`` = ``{num_classes, stage,
  exported_from}``, which the reference's Herlev evaluator reads;
* ``raw_state_dict=True``: the bare tensor dict (the reference's
  segmentation loader then assumes stage 4).

The stage is the one asked for, else the checkpoint's, else 4.  Every
tensor is float32 and every BN carries a zero int64
``num_batches_tracked``, which torch's strict loading wants and the
reference never reads.  A classifier is padded to the reference's full
``unet`` key set (``io.checkpoint.full_classifier_state_dict``; its own
keys win).  A leaf or key the name table does not map is left out with
the JAX export's message, or raises ``ValueError`` with ``strict``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Mapping

import torch

from ugpg_tpu_torch.io.checkpoint import (
    checkpoint_metadata,
    container_stage,
    full_classifier_state_dict,
    read_checkpoint,
    read_trees,
)
from ugpg_tpu_torch.io.from_jax import jax_leaf, state_dict_from_jax

__all__ = ["convert_state_dict_to_reference", "export_torch_checkpoint"]

_BN_CHILDREN = ("bn1", "bn2")


def convert_state_dict_to_reference(
    state_dict: Mapping[str, Any], task_type: str = "segmentation", stage: int = 4,
) -> tuple[dict[str, torch.Tensor], list[str]]:
    """The reference's state dict of a port state dict: float32 CPU copies
    of every key the name table maps, a zero int64 ``num_batches_tracked``
    for each BN, and for ``task_type="classification"`` the decoder keys of
    ``PGUNet{stage}``.  -> (state dict, the keys left out as unmapped)."""
    if task_type not in ("segmentation", "classification"):
        raise ValueError(f"unknown task_type: {task_type!r}")
    sd: dict[str, torch.Tensor] = {}
    skipped: list[str] = []
    bn_bases = set()
    for name, value in state_dict.items():
        try:
            path = jax_leaf(name)
        except ValueError:
            skipped.append(name)
            continue
        if path is None:  # num_batches_tracked: written anew below
            continue
        sd[name] = torch.as_tensor(value).detach().to("cpu", torch.float32).contiguous().clone()
        if path[-2] in _BN_CHILDREN:
            bn_bases.add(name.rsplit(".", 1)[0])
    for base in bn_bases:
        sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    if task_type == "classification":
        sd = full_classifier_state_dict(sd, stage)
    return sd, skipped


def _float(meta: Mapping[str, Any], key: str, default: float = 0.0) -> float:
    try:
        return float(meta.get(key, default))
    except (TypeError, ValueError):
        return default


def export_torch_checkpoint(
    checkpoint_path: str | os.PathLike,
    out_path: str | os.PathLike,
    task_type: str = "segmentation",
    stage: int | None = None,
    raw_state_dict: bool = False,
    strict: bool = False,
):
    """Write ``checkpoint_path`` as a reference ``.pth`` at ``out_path``
    (the container of the module's docstring); -> ``out_path``."""
    skipped: list[str] = []
    if Path(checkpoint_path).is_dir():
        variables, _ = read_trees(checkpoint_path)
        state_dict = state_dict_from_jax(variables, unmapped=skipped)
        meta = checkpoint_metadata(checkpoint_path)
    else:
        obj = read_checkpoint(checkpoint_path)
        state_dict = obj["model_state_dict"]
        meta = {k: v for k, v in obj.items()
                if k not in ("model_state_dict", "optimizer_state_dict")}
    if stage is None:
        stage = container_stage(meta)

    sd, unmapped = convert_state_dict_to_reference(state_dict, task_type, stage)
    skipped += unmapped
    if skipped:
        msg = f"export: {len(skipped)} unmapped leaves (examples: {skipped[:5]})"
        if strict:
            raise ValueError(msg)
        print(msg)

    if raw_state_dict:
        obj = sd
    elif task_type == "segmentation":
        obj = {
            "stage": stage,
            "epoch": int(_float(meta, "epoch", 0)),
            "model_state_dict": sd,
            "val_dice": _float(meta, "val_dice"),
            "train_dice": _float(meta, "train_dice"),
            "uncertainty_alpha": _float(meta, "uncertainty_alpha", 1.0),
        }
    else:
        obj = {
            "stage": stage,
            "epoch": int(_float(meta, "epoch", 0)),
            "model_state_dict": sd,
            "train_loss": _float(meta, "train_loss"),
            "val_loss": _float(meta, "val_loss"),
            "train_acc": _float(meta, "train_acc"),
            "val_acc": _float(meta, "val_acc"),
            "config": {"num_classes": int(sd["classifier.9.weight"].shape[0]), "stage": stage,
                       "exported_from": str(checkpoint_path)},
        }
    out = Path(out_path)
    tmp = out.with_name(out.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, out)
    if raw_state_dict:
        print(f"exported {checkpoint_path} -> {out_path} (raw state dict)")
    else:
        print(f"exported {checkpoint_path} -> {out_path} (stage {stage}, {task_type})")
    return out_path
