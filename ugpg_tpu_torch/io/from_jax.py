"""Weight bridge: a flax variable tree (numpy leaves) -> the port's state dict.

A copy of the name table in ``ugpg_tpu/io/torch_export.py``, all but the
legacy UNet's bare DoubleConv (the port keeps its own copy and never
imports the JAX package):

    blk/conv/{conv1,bn1,conv2,bn2}/leaf -> blk.conv.conv_op.{0,1,3,4}.*
                                           (blk.mpconv.1.conv_op.* for downX)
    outcX/conv/{kernel,bias}            -> outcX.conv.{weight,bias}
    unet/<any of the above>             -> unet.<...>   (the classifier's encoder)
    fc1/fc2/fc3/{kernel,bias}           -> classifier.{3,6,9}.{weight,bias}

Conv kernels go HWIO -> OIHW, Dense kernels (in, out) -> (out, in); BN
``scale/bias`` -> ``weight/bias`` and ``mean/var`` ->
``running_mean/running_var``; each BN gets a zero int64
``num_batches_tracked`` (strict loading wants the buffer).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax"]

_SLOT_OF = {"conv1": ("0", "conv"), "bn1": ("1", "bn"),
            "conv2": ("3", "conv"), "bn2": ("4", "bn")}
_DOWN_RE = re.compile(r"down\d+$")
_HEAD_OF = {"fc1": "classifier.3", "fc2": "classifier.6", "fc3": "classifier.9"}
_LEAF = {
    ("conv", "params", "kernel"): "weight",
    ("conv", "params", "bias"): "bias",
    ("bn", "params", "scale"): "weight",
    ("bn", "params", "bias"): "bias",
    ("bn", "batch_stats", "mean"): "running_mean",
    ("bn", "batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def state_dict_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Convert ``{'params': ..., 'batch_stats': ...}`` of a PGUNet stage or
    a Herlev classifier to reference-named float32 tensors; raise
    ``ValueError`` on a leaf the table does not map."""
    sd: dict[str, torch.Tensor] = {}
    bn_bases = set()
    unmapped = []
    for path, value in _flatten(variables):
        coll, *scope = path
        arr = np.array(value, dtype=np.float32)  # a writable copy
        prefix = ""
        if scope and scope[0] == "unet":
            prefix, scope = "unet.", scope[1:]
        name = None
        if len(scope) == 2 and scope[0] in _HEAD_OF and coll == "params":
            pname = {"kernel": "weight", "bias": "bias"}.get(scope[1])
            if pname is not None:
                name = f"{_HEAD_OF[scope[0]]}.{pname}"
                arr = arr.T if arr.ndim == 2 else arr
        elif len(scope) == 4 and scope[1] == "conv" and scope[2] in _SLOT_OF:
            block, _, child, leaf = scope
            slot, kind = _SLOT_OF[child]
            pname = _LEAF.get((kind, coll, leaf))
            if pname is not None:
                mid = "mpconv.1" if _DOWN_RE.match(block) else "conv"
                base = f"{prefix}{block}.{mid}.conv_op.{slot}"
                name = f"{base}.{pname}"
                if kind == "bn":
                    bn_bases.add(base)
        elif len(scope) == 3 and scope[1] == "conv":  # OutConv head
            pname = _LEAF.get(("conv", coll, scope[2]))
            if pname is not None:
                name = f"{prefix}{scope[0]}.conv.{pname}"
        if name is None:
            unmapped.append("/".join(path))
            continue
        if arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr))
    if unmapped:
        raise ValueError(f"unmapped variables: {unmapped[:5]}")
    for base in bn_bases:
        sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
