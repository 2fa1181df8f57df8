"""Optimizers of the progressive trainers (counterpart of
``ugpg_tpu/train/optim.py``).

The JAX package re-derives torch's update math in optax; here it is
PyTorch's own ``torch.optim.RMSprop`` (segmentation):

    g <- g + wd * p
    v <- alpha * v + (1 - alpha) * g^2
    p <- p - lr * g / (sqrt(v) + eps)        (alpha 0.99, eps 1e-8)

and ``torch.optim.Adam`` (classification), weight decay added to the
gradient (L2), not decoupled:

    g <- g + wd * p
    m <- b1 m + (1 - b1) g ;  v <- b2 v + (1 - b2) g^2
    p <- p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)

``freeze_subtrees`` keeps named top-level submodules out of the update
(the classifier's encoder ``unet``): they get no gradient and no optimizer
state.  ``ReduceLROnPlateau`` is the JAX package's host-side scheduler
(mode 'min', a relative threshold of 1e-4, no cooldown) acting on a torch
optimizer's learning rate.

``capturable=True`` (a ``scan_epochs`` trainer's choice on a card)
builds torch's capturable variant, which a CUDA graph can replay: its step
count lives on the device and the learning rate is a 0-d float32 tensor
there, which ``set_learning_rate`` writes in place, so a graph that
captured the step sees every change.  That variant rounds otherwise than
the host-float one (RMSprop divides by ``-lr`` before the update; Adam's
bias corrections are float32 tensors), so a trainer uses one variant for
every step, captured or eager.  Other trainers, and every trainer on the
CPU, keep the host-float variant, the one held against the JAX package.

``optimizer_state_to_jax`` and ``optimizer_state_from_jax`` convert
between a torch optimizer's ``state_dict()`` and the optax state tree of
the JAX package's optimizers (``flax.serialization.to_state_dict``, numpy
leaves), which its msgpack checkpoints hold:

    RMSprop  {count, hyperparams: {lr}, hyperparams_states: {},
              inner_state: {'0': {}, '1': {nu: <params>}, '2': {}}}
    Adam     the same with '1': {count, mu: <params>, nu: <params>}
    frozen   {inner_states: {frozen: {inner_state: {}},
                             train: {inner_state: <Adam's tree>}}}
             (``freeze_subtrees(torch_adam(...), ('unet',))``: ``mu`` and
             ``nu`` hold ``unet: {}``, the masked subtree)

``nu`` is ``square_avg`` / ``exp_avg_sq`` and ``mu`` ``exp_avg``, in
flax's layout (conv OIHW <-> HWIO, dense (out, in) <-> (in, out)); the
int32 ``count`` is torch's per-parameter ``step``; the float32
``hyperparams.lr`` is the param group's learning rate.  Parameters are
named by the port's state-dict names, in the optimizer's order
(``param_names``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["torch_rmsprop", "torch_adam", "freeze_subtrees", "ReduceLROnPlateau",
           "get_learning_rate", "set_learning_rate", "load_optimizer_state", "param_names",
           "optimizer_state_to_jax", "optimizer_state_from_jax", "is_jax_optimizer_state"]


def _lr(params: list, lr: float, capturable: bool):
    """(params, lr as the variant takes it: a device tensor when capturable)."""
    if lr is None:
        raise ValueError("lr must be a number, got None")
    params = list(params)
    if not capturable:
        return params, lr
    first = params[0]["params"][0] if isinstance(params[0], dict) else params[0]
    return params, torch.tensor(float(lr), dtype=torch.float32, device=first.device)


def torch_rmsprop(params: Iterable[torch.nn.Parameter], lr: float,
                  weight_decay: float = 0.0, capturable: bool = False) -> torch.optim.RMSprop:
    """RMSprop with the reference's settings: no momentum, not centered."""
    params, lr = _lr(params, lr, capturable)
    return torch.optim.RMSprop(params, lr=lr, alpha=0.99, eps=1e-8,
                               weight_decay=weight_decay, momentum=0, centered=False,
                               capturable=capturable)


def torch_adam(params: Iterable[torch.nn.Parameter], lr: float, weight_decay: float = 0.0,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               capturable: bool = False) -> torch.optim.Adam:
    """Adam with L2 weight decay (not AdamW), no amsgrad."""
    params, lr = _lr(params, lr, capturable)
    return torch.optim.Adam(params, lr=lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                            amsgrad=False, capturable=capturable)


def freeze_subtrees(model: nn.Module, frozen_roots: tuple[str, ...]) -> list[nn.Parameter]:
    """Turn off the gradient of every parameter under the named top-level
    submodules, and return the others: the parameters to optimize."""
    trainable = []
    for name, p in model.named_parameters():
        frozen = name.split(".", 1)[0] in frozen_roots
        p.requires_grad_(not frozen)
        if not frozen:
            trainable.append(p)
    return trainable


@dataclass
class ReduceLROnPlateau:
    """``step(metric, optimizer)`` once per epoch: after more than
    ``patience`` epochs in a row without a relative improvement of
    ``threshold`` below ``best``, multiply the learning rate by ``factor``
    (not below ``min_lr``) and start counting again."""

    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4
    min_lr: float = 0.0
    best: float = field(default=float("inf"), init=False)
    num_bad_epochs: int = field(default=0, init=False)

    def step(self, metric: float, optimizer: torch.optim.Optimizer) -> torch.optim.Optimizer:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            set_learning_rate(optimizer,
                              max(get_learning_rate(optimizer) * self.factor, self.min_lr))
            self.num_bad_epochs = 0
        return optimizer


def get_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> torch.optim.Optimizer:
    """Every group's learning rate; a tensor one (capturable) is written in place."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(float(lr))
        else:
            group["lr"] = float(lr)
    return optimizer


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict,
                         names: Sequence[str] | None = None,
                         lr: float | None = None) -> torch.optim.Optimizer:
    """``optimizer.load_state_dict(state)``, keeping the optimizer's own
    variant: a state written by the other one (the card's capturable
    optimizer, resumed on the CPU, or the reverse) gets this optimizer's
    ``capturable``, its learning rate's form and its step counts' device.
    An optax tree (a msgpack checkpoint's) is converted first
    (``optimizer_state_from_jax`` with ``names`` and ``lr``)."""
    if is_jax_optimizer_state(state):
        if names is None:
            raise ValueError("an optax optimizer state needs the parameters' names")
        state = optimizer_state_from_jax(state, names, optimizer.state_dict(), lr)
    capturable = [g.get("capturable", False) for g in optimizer.param_groups]
    lr_tensors = [g["lr"] if isinstance(g["lr"], torch.Tensor) else None
                  for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, cap, lr_t in zip(optimizer.param_groups, capturable, lr_tensors):
        group["capturable"] = cap
        lr = float(group["lr"])
        if lr_t is not None:
            group["lr"] = lr_t.fill_(lr)  # the same tensor: a captured graph reads it
        else:
            group["lr"] = lr
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            if "step" in st:
                st["step"] = (st["step"].to(device=p.device, dtype=torch.float32) if cap
                              else st["step"].to(device="cpu", dtype=torch.float32))
    return optimizer


# ---------------------------------------------------------------- optax trees
def param_names(optimizer: torch.optim.Optimizer, model: nn.Module) -> list[str]:
    """The state-dict names of ``optimizer``'s parameters, in its order."""
    by_id = {id(p): name for name, p in model.named_parameters()}
    return [by_id[id(p)] for group in optimizer.param_groups for p in group["params"]]


def is_jax_optimizer_state(state: Any) -> bool:
    """True for an optax state tree, False for a torch ``state_dict()``."""
    return isinstance(state, Mapping) and "param_groups" not in state


def _kind(groups: list) -> str:
    if "betas" in groups[0]:
        return "adam"
    if "alpha" in groups[0]:
        return "rmsprop"
    raise ValueError(f"no optax counterpart for an optimizer with {sorted(groups[0])}")


def _put(tree: dict, path: Sequence[str], value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _get(tree: Mapping, path: Sequence[str]):
    for key in path:
        tree = tree[key]
    return tree


def optimizer_state_to_jax(state: Mapping, names: Sequence[str],
                           params: Mapping[str, Any]) -> dict:
    """The optax tree of torch's ``state`` (an RMSprop's or an Adam's
    ``state_dict()``), its parameters named by ``names`` in order;
    ``params`` is the flax ``params`` collection, which gives the masked
    subtree and the shapes of moments torch has not made yet (zeros, as
    optax's initial state).  The encoder ``unet`` left out of ``names``
    makes the frozen form."""
    from ugpg_tpu_torch.io.from_jax import jax_leaf, to_jax_layout

    groups = state["param_groups"]
    kind = _kind(groups)
    ids = [i for group in groups for i in group["params"]]
    if len(ids) != len(names):
        raise ValueError(f"{len(names)} names for {len(ids)} optimizer parameters")
    missing = set(params) - {jax_leaf(name)[1] for name in names}
    if missing - {"unet"}:
        raise ValueError(f"parameters {sorted(missing)} are neither optimized nor the "
                         "frozen encoder")
    frozen = bool(missing)
    steps = [float(s["step"]) for s in state["state"].values() if "step" in s]
    count = np.asarray(int(steps[0]) if steps else 0, np.int32)
    moments = {"nu": ("square_avg" if kind == "rmsprop" else "exp_avg_sq")}
    if kind == "adam":
        moments["mu"] = "exp_avg"
    inner: dict[str, Any] = {key: ({"unet": {}} if frozen else {}) for key in moments}
    for i, name in zip(ids, names):
        path = jax_leaf(name)[1:]
        held = state["state"].get(i, {})
        for key, torch_key in moments.items():
            value = held.get(torch_key)
            _put(inner[key], path, to_jax_layout(value) if value is not None
                 else np.zeros_like(_get(params, path)))
    if kind == "adam":
        inner["count"] = count
    tree = {"count": count, "hyperparams": {"lr": np.asarray(float(groups[0]["lr"]), np.float32)},
            "hyperparams_states": {}, "inner_state": {"0": {}, "1": inner, "2": {}}}
    if frozen:
        tree = {"inner_states": {"frozen": {"inner_state": {}}, "train": {"inner_state": tree}}}
    return tree


def optimizer_state_from_jax(tree: Mapping, names: Sequence[str], template: Mapping,
                             lr: float | None = None) -> dict:
    """A torch ``state_dict()`` for the optimizer whose own
    ``state_dict()`` is ``template`` (its groups kept, the learning rate
    replaced) from the optax ``tree``, the optimizer's parameters named by
    ``names``.  ``lr``: the learning rate to take when it rounds to the
    tree's float32 one (the exact float a port checkpoint records)."""
    from ugpg_tpu_torch.io.from_jax import from_jax_layout, jax_leaf

    groups = [dict(g) for g in template["param_groups"]]
    kind = _kind(groups)
    if "inner_states" in tree:
        tree = tree["inner_states"]["train"]["inner_state"]
    inner = tree["inner_state"]["1"]
    if ("mu" in inner) != (kind == "adam"):
        raise ValueError(f"the checkpoint's optimizer state is not a {kind} state")
    tree_lr = np.asarray(tree["hyperparams"]["lr"], np.float32)
    if lr is None or np.float32(lr) != tree_lr:
        lr = float(tree_lr)
    for group in groups:
        group["lr"] = lr
    count = int(np.asarray(inner["count"] if kind == "adam" else tree["count"]))
    moments = ({"square_avg": "nu"} if kind == "rmsprop"
               else {"exp_avg": "mu", "exp_avg_sq": "nu"})
    ids = [i for group in groups for i in group["params"]]
    if len(ids) != len(names):
        raise ValueError(f"{len(names)} names for {len(ids)} optimizer parameters")
    out: dict[int, dict] = {}
    for i, name in zip(ids, names):
        path = jax_leaf(name)[1:]
        out[i] = {"step": torch.tensor(float(count), dtype=torch.float32)}
        for torch_key, key in moments.items():
            try:
                value = _get(inner[key], path)
            except (KeyError, TypeError):
                raise ValueError(f"the checkpoint's optimizer state has no {key!r} for "
                                 f"{name} (an encoder frozen in one and not the other?)"
                                 ) from None
            out[i][torch_key] = torch.from_numpy(from_jax_layout(np.array(value)))
    return {"state": out, "param_groups": groups}
