"""Weight bridge between a flax variable tree (numpy leaves) and the port's
state dict, both ways.

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
``jax_variables_from_state_dict`` is the inverse (``num_batches_tracked``
dropped), and ``jax_leaf`` maps one name: the same tables read backwards.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "jax_variables_from_state_dict", "jax_leaf", "to_jax_layout",
           "from_jax_layout"]

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


def from_jax_layout(arr: np.ndarray) -> np.ndarray:
    """A flax leaf in the port's layout: HWIO -> OIHW, (in, out) -> (out,
    in); C-ordered (a copy when the layout changes)."""
    if arr.ndim == 4:
        arr = arr.transpose(3, 2, 0, 1)
    elif arr.ndim == 2:
        arr = arr.T
    return np.ascontiguousarray(arr)


def state_dict_from_jax(variables: Mapping[str, Any],
                        unmapped: list[str] | None = None) -> dict[str, torch.Tensor]:
    """Convert ``{'params': ..., 'batch_stats': ...}`` of a PGUNet stage or
    a Herlev classifier to reference-named float32 tensors.  A leaf the
    table does not map raises ``ValueError``, or, where a list ``unmapped``
    is given, is left out and its path (``params/blk/leaf``) appended."""
    sd: dict[str, torch.Tensor] = {}
    bn_bases = set()
    collect = unmapped is not None
    unmapped = unmapped if collect else []
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
        sd[name] = torch.from_numpy(from_jax_layout(arr))
    if unmapped and not collect:
        raise ValueError(f"unmapped variables: {unmapped[:5]}")
    for base in bn_bases:
        sd[f"{base}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


_CHILD_OF = {slot: child for child, (slot, _) in _SLOT_OF.items()}
_KIND_OF = {slot: kind for _, (slot, kind) in _SLOT_OF.items()}
_FC_OF = {head: fc for fc, head in _HEAD_OF.items()}
_LEAF_OF = {(kind, pname): (coll, leaf) for (kind, coll, leaf), pname in _LEAF.items()}


def jax_leaf(name: str) -> tuple[str, ...] | None:
    """``(collection, *scope, leaf)`` of the port's state-dict ``name`` in
    the flax tree; None for ``num_batches_tracked``, which flax lacks.
    Raises ``ValueError`` on a name the table does not map."""
    parts = name.split(".")
    prefix: tuple = ()
    if parts[0] == "unet":
        prefix, parts = ("unet",), parts[1:]
    if parts[-1] == "num_batches_tracked":
        return None
    key = ".".join(parts[:-1])
    if key in _FC_OF and not prefix:
        return ("params", _FC_OF[key], {"weight": "kernel", "bias": "bias"}[parts[-1]])
    if len(parts) == 5 and parts[1:3] == ["conv", "conv_op"] or \
            len(parts) == 6 and parts[1:4] == ["mpconv", "1", "conv_op"]:
        slot, pname = parts[-2], parts[-1]
        if slot in _CHILD_OF and (_KIND_OF[slot], pname) in _LEAF_OF:
            coll, leaf = _LEAF_OF[(_KIND_OF[slot], pname)]
            return (coll, *prefix, parts[0], "conv", _CHILD_OF[slot], leaf)
    if len(parts) == 3 and parts[1] == "conv" and ("conv", parts[2]) in _LEAF_OF:
        return ("params", *prefix, parts[0], "conv", _LEAF_OF[("conv", parts[2])][1])
    raise ValueError(f"no flax name for {name!r}")


def to_jax_layout(value) -> np.ndarray:
    """A port tensor in flax's layout: OIHW -> HWIO, (out, in) -> (in, out);
    a C-ordered host copy with the tensor's dtype (a tensor is permuted
    where it lives, then copied; a copy even where nothing moved, so that
    the value may change in place after the call)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        t = t.permute(2, 3, 1, 0) if t.dim() == 4 else t.t() if t.dim() == 2 else t
        out = t.contiguous().cpu()
        return (out.clone() if out.data_ptr() == t.data_ptr() else out).numpy()
    arr = np.asarray(value)
    if arr.ndim == 4:
        arr = arr.transpose(2, 3, 1, 0)
    elif arr.ndim == 2:
        arr = arr.T
    return np.array(arr, order="C")


def jax_variables_from_state_dict(state_dict: Mapping[str, Any]) -> dict[str, Any]:
    """``{'params': ..., 'batch_stats': ...}`` (numpy leaves in flax's
    layout) of a PGUNet stage's or a Herlev classifier's state dict: the
    inverse of ``state_dict_from_jax``.  Every key must map (raise
    ``ValueError``); ``num_batches_tracked`` is dropped.  A classifier's
    decoder keys must be dropped first (``io.checkpoint.classifier_state_dict``)."""
    tree: dict[str, Any] = {}
    for name, value in state_dict.items():
        path = jax_leaf(name)
        if path is None:
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_jax_layout(value)
    return tree
