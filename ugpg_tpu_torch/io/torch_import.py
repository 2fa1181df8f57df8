"""Import a reference ``.pth`` as the JAX package's checkpoint directory
(counterpart of ``ugpg_tpu/io/torch_import.py``).

The ``.pth`` is the reference's container (``{'model_state_dict': ...,
'stage': ...}``) or a bare state dict; the stage is the one asked for,
else the container's, else 4, as the reference's loader assumes.  Its
keys are held to the stage's model, built on the ``meta`` device for its
names and shapes only (``PGUNet{stage}``, or the Herlev classifier for
``task_type="classification"``): a key the name table does not map, or
that the model lacks (a classifier ``.pth``'s decoder keys, which the
classifier never reads), is left out and reported; a shape that differs
raises ``ValueError``.  Every value is cast to the model's float32.

With ``output_dir`` the weights are written as the JAX package's default
checkpoint directory (``io.checkpoint.save_checkpoint(...,
backend="msgpack")``): ``variables.msgpack`` with the bytes that the JAX
import writes for the same ``.pth``, and ``metadata.json`` holding the
stage, the container's scalar fields and ``imported_from``.

One difference: where the ``.pth`` lacks a key the model has, the JAX
import keeps its template's ``jax.random`` initialisation, which the port
cannot draw; the port keeps torch's default initialisation drawn from
``torch.Generator().manual_seed(0)`` and says how many keys it filled.
"""

from __future__ import annotations

import os

import torch

from ugpg_tpu_torch.io.checkpoint import read_checkpoint, save_checkpoint
from ugpg_tpu_torch.io.from_jax import jax_leaf

__all__ = ["import_torch_checkpoint"]


def _stage_model(task_type: str, stage: int, num_classes: int) -> torch.nn.Module:
    if task_type == "segmentation":
        from ugpg_tpu_torch.models.pgunet import STAGE_MODELS

        return STAGE_MODELS[stage](num_classes=num_classes)
    if task_type == "classification":
        from ugpg_tpu_torch.models.classifier import HerlevClassificationModel

        return HerlevClassificationModel(stage=stage, num_classes=num_classes)
    raise ValueError(f"unknown task_type: {task_type!r}")


def import_torch_checkpoint(
    pth_path: str | os.PathLike,
    stage: int | None = None,
    num_classes: int = 1,
    task_type: str = "segmentation",
    output_dir: str | os.PathLike | None = None,
) -> tuple[dict[str, torch.Tensor], int]:
    """Read ``pth_path``, hold it to the stage's model and, with
    ``output_dir``, write the JAX package's directory there.  -> (the
    model's state dict of CPU float32 tensors, stage)."""
    obj = read_checkpoint(pth_path)
    meta = {k: v for k, v in obj.items()
            if k != "model_state_dict" and isinstance(v, (int, float, str, bool))}
    if stage is None and "stage" in obj:
        stage = int(obj["stage"])
    stage = stage or 4

    with torch.device("meta"):
        template = _stage_model(task_type, stage, num_classes).state_dict()
    sd: dict[str, torch.Tensor] = {}
    skipped: list[str] = []
    for key, value in obj["model_state_dict"].items():
        try:
            path = jax_leaf(key)
        except ValueError:
            skipped.append(key)
            continue
        if path is None:  # num_batches_tracked
            continue
        if key not in template:
            skipped.append("/".join(path))
            continue
        want = template[key]
        if tuple(value.shape) != tuple(want.shape):
            raise ValueError(f"shape mismatch at {'/'.join(path)}: torch "
                             f"{tuple(value.shape)} vs template {tuple(want.shape)}")
        sd[key] = value.detach().to("cpu", want.dtype).contiguous()
    if skipped:
        print(f"import: {len(skipped)} unmapped keys (examples: {skipped[:5]})")
    missing = [k for k in template if k not in sd and jax_leaf(k) is not None]
    if missing:
        from ugpg_tpu_torch.models.blocks import init_parameters

        model = _stage_model(task_type, stage, num_classes)
        init_parameters(model, torch.Generator().manual_seed(0))
        fresh = model.state_dict()
        sd.update({k: fresh[k] for k in missing})
        print(f"import: {len(missing)} keys of the stage-{stage} model not in {pth_path}, "
              f"kept at their seeded initialisation (examples: {missing[:5]})")
    # the model's order; flax has no num_batches_tracked: 0, as a directory reads back
    sd = {k: sd[k] if k in sd else torch.tensor(0, dtype=torch.int64) for k in template}

    if output_dir:
        save_checkpoint(output_dir, sd, backend="msgpack",
                        **{"stage": stage, **meta, "imported_from": str(pth_path)})
        print(f"imported {pth_path} -> {output_dir} (stage {stage})")
    return sd, stage
