"""Faults planted in the port, for the readings that set the limits and for
the tests that see ``correct`` come out false.  Each ``plant_*`` patches
the program through ``patch`` (``setattr``-like: a pytest ``monkeypatch`` or
``Patches``) and leaves the rest of the run as it is.

* ``altered``: every served image's probabilities shifted by 0.3 at one
  value, where the serving graph produces them.
* ``half``: the serving graph computes the first half of a bucket and
  answers the rest with it.
* ``half_group``: the bucket router computes the first half of a group of
  requests (before padding) and answers the rest with it.
* ``unchanged``: the optimizer's step returns with the state unchanged.
* ``half_batch``: the train step sees the first half of each batch, its
  mean loss taken over that half.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["FAULTS", "Patches", "plant"]


class Patches:
    """``setattr`` that remembers the old values; ``undo`` restores them."""

    def __init__(self):
        self._old = []

    def setattr(self, obj, name: str, value) -> None:
        self._old.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._old:
            obj, name, value = self._old.pop()
            setattr(obj, name, value)


def _serving(patch, fault: str) -> None:
    from ugpg_tpu_torch.eval.serving import Predictor

    graph = Predictor._graph

    def broken(self, x, masks=None, model=None):
        if fault == "half":
            outs = graph(self, x[:max(x.shape[0] // 2, 1)], masks, model)
            return tuple(torch.cat([o, o[:x.shape[0] - o.shape[0]]]) for o in outs)
        outs = list(graph(self, x, masks, model))
        probs = outs[1].clone()
        probs.view(probs.shape[0], -1)[:, 0] += 0.3
        outs[1] = probs
        return tuple(outs)

    patch.setattr(Predictor, "_graph", broken)


def _half_group(patch, fault: str) -> None:
    from ugpg_tpu_torch.eval.exported import _BucketRouter

    run = _BucketRouter._run_padded

    def broken(self, chunk):
        n = chunk.shape[0]
        outs = run(self, chunk[:max(n // 2, 1)])
        return tuple(o[np.arange(n) % len(o)] for o in outs)

    patch.setattr(_BucketRouter, "_run_padded", broken)


def _unchanged(patch, fault: str) -> None:
    patch.setattr(torch.optim.RMSprop, "step", lambda self, closure=None: None)


def _half_batch(patch, fault: str) -> None:
    from ugpg_tpu_torch.train import steps

    nchw = steps._nchw

    def first_half(a, device):
        t = nchw(a, device)
        return t[:t.shape[0] // 2]

    patch.setattr(steps, "_nchw", first_half)


FAULTS = {"altered": _serving, "half": _serving, "half_group": _half_group,
          "unchanged": _unchanged, "half_batch": _half_batch}


def plant(patch, fault: str) -> None:
    FAULTS[fault](patch, fault)
