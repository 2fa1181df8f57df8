"""Stage-to-stage weight transfer on state dicts (counterpart of
``ugpg_tpu/progressive/transfer.py``).

For every key present in both stages:

* exact shape match  -> a fresh copy (``clone``)
* conv weight (OIHW) -> the overlapping ``[:out, :in]`` slab (the JAX
  package's HWIO ``[..., :in, :out]``), when the kernel sizes agree
* 2-D weight         -> the ``[:a, :b]`` overlap
* 1-D tensor         -> the leading ``[:n]`` (biases, BN weights and running
  stats)

``num_batches_tracked`` is 0-d, so it is an exact match.  Keys in only one
dict, and shapes no case covers, keep the current stage's value.  Because
every stage names its blocks alike (``inc``, ``down4``, ``up1``, ...), deep
layers carry over while new shallow layers keep their fresh values.
"""

from __future__ import annotations

from typing import Mapping

import torch

__all__ = ["transfer_weights"]


def _overlap_copy(prev: torch.Tensor, cur: torch.Tensor) -> torch.Tensor | None:
    """``cur`` with the overlapping slab of ``prev`` copied in; None if no
    case covers the pair."""
    if prev.shape == cur.shape:
        return prev.detach().clone()
    if prev.dim() != cur.dim() or prev.dim() not in (1, 2, 4):
        return None
    if prev.dim() == 4 and prev.shape[2:] != cur.shape[2:]:
        return None
    out = cur.detach().clone()
    slab = tuple(slice(0, min(a, b)) for a, b in zip(prev.shape[:2], cur.shape[:2]))
    out[slab] = prev.detach()[slab].to(out.dtype)
    return out


def transfer_weights(prev_state: Mapping[str, torch.Tensor],
                     cur_state: Mapping[str, torch.Tensor]
                     ) -> tuple[dict[str, torch.Tensor], list[str]]:
    """Merge ``prev_state`` into ``cur_state`` by name -> (merged state
    dict, the keys copied from ``prev_state``)."""
    merged = dict(cur_state)
    copied = []
    for key, prev in prev_state.items():
        cur = merged.get(key)
        if cur is None:
            continue
        new = _overlap_copy(prev, cur)
        if new is not None:
            merged[key] = new
            copied.append(key)
    return merged, copied
