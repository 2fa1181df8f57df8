"""BatchNorm folding for inference (counterpart of ``ugpg_tpu/models/folding.py``).

At eval time ``relu(BN(conv(x)))`` is exactly ``relu(conv'(x))`` with

    w' = w * scale / sqrt(var + eps)        (per output channel)
    b' = (b - mean) * scale / sqrt(var + eps) + bias

On reference-named state dicts: ``conv_op.0`` folds with ``conv_op.1`` and
``conv_op.3`` with ``conv_op.4``; the BN entries are dropped, so the result
loads strictly into a model built with ``use_bn=False``.
"""

from __future__ import annotations

from typing import Mapping

import torch

from ugpg_tpu_torch.models.blocks import BN_EPS

__all__ = ["fold_batchnorm"]

_BN_OF_CONV = {"conv_op.0": "conv_op.1", "conv_op.3": "conv_op.4"}


def fold_batchnorm(state_dict: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Return a new state dict with every BN folded into its conv."""
    bn_prefixes = set()
    out = {}
    for key, value in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        scope, _, slot = prefix.rpartition(".conv_op.")
        conv = f"conv_op.{slot}"
        bn = _BN_OF_CONV.get(conv)
        if not scope or bn is None or f"{scope}.{bn}.weight" not in state_dict:
            out[key] = value
            continue
        bn_prefix = f"{scope}.{bn}"
        bn_prefixes.add(bn_prefix)
        var = state_dict[f"{bn_prefix}.running_var"].float()
        factor = state_dict[f"{bn_prefix}.weight"].float() / torch.sqrt(var + BN_EPS)
        if leaf == "weight":
            out[key] = value.float() * factor[:, None, None, None]
        elif leaf == "bias":
            mean = state_dict[f"{bn_prefix}.running_mean"].float()
            out[key] = (value.float() - mean) * factor + state_dict[f"{bn_prefix}.bias"].float()
        else:
            raise ValueError(f"unexpected conv entry {key!r}")
    return {k: v for k, v in out.items() if k.rpartition(".")[0] not in bn_prefixes}
