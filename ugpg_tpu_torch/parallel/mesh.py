"""The device mesh and placement on it (counterpart of ``ugpg_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process sees every device and
runs one program on all of them.  The port does the same within a
process.  A ``Mesh`` is a grid of ``torch.device``s inside one process,
with named axes, ``("data", "model")`` from ``make_mesh``; a halo is a copy
of a slab to a neighbour's device, an all-gather a ``torch.cat`` on one
device.  Across processes (``parallel/distributed.py``, over
``torch.distributed``) each process drives its own mesh over its local
devices, and the processes form the outer data axis.

A mesh may name one device more than once, as ``parallel/pipeline.py``'s
device lists may: on one card ``make_mesh(2, devices=["cuda:0"] * 2)`` runs
every shard and replica there, one after another, and on the CPU the
command lines repeat the CPU as often as the mesh asks.

* ``make_mesh``: an (n_data, n_model) mesh over the visible cards, or over
  ``devices``; asking for more than are given raises.
* ``batch_sharding`` and ``replicated``: the two placements of a tensor
  (``Sharding``: the mesh and a spec that names, per dimension, the mesh
  axis it splits over).
* ``shard_batch``: the leading axis split over ``data``, in order, part i
  on data row i's first device.
* ``data_axis_size``: the size of a mesh's ``data`` axis, raising when it
  has none (the first check of every mesh entry point).
* ``param_shardings``: the spec of every tensor of a state dict, by the JAX
  package's rule: a 4-D conv kernel (``weight``, or the int8 ``wq``) with
  at least 256 output channels that divide by the ``model`` axis shards
  them over ``model``; everything else replicates.  The served int8
  model's weight matrix ``w`` (``ops/quant.py::weight_matrix`` of ``wq``)
  shards its columns by the same rule.
* ``shard_variables``: a state dict placed by those specs: every mesh
  position's view, one copy of a replicated tensor per distinct device.
  ``parallel/tensor.py`` serves column-parallel convs from its slices.

Training on a mesh (``train/steps.py``, ``parallel/tensor.py``) keeps one
set of parameters, on the mesh's first device, and broadcasts it inside the
forward: every conv copies its weights to each shard's device (a
differentiable ``.to()``), so autograd sums the replicas' gradients into
that one set, one optimizer update follows, and every replica equals it
by construction; BN's running stats update once, from the whole batch's
statistics (``models/blocks.py::cross_replica_batch_norm``).  The
column-parallel layout of ``param_shardings`` is cut from the parameters
at every step, so no update can lose it.

``shard_stacked_batch``: a stacked chunk of an epoch (S, B, ...) with axis 1,
the per-step batch, split over ``data``, as the whole-epoch path places it
(``train/steps.py::put_stacked``): one ``ShardedStack`` per array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ugpg_tpu_torch.device import resolve_device

__all__ = [
    "Mesh",
    "Sharding",
    "make_mesh",
    "data_axis_size",
    "batch_sharding",
    "replicated",
    "tp_sharded",
    "param_shardings",
    "shard_variables",
    "shard_batch",
    "shard_stacked_batch",
    "ShardedStack",
    "tensor_device",
]

# Conv kernels at least this wide on the output-channel axis shard over 'model'.
_TP_MIN_CHANNELS = 256


class Mesh:
    """A grid of devices with named axes: ``devices`` nested to one level
    per name in ``axis_names``; ``shape`` maps each name to its size.
    Equal (and hashable) by its names and devices."""

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"a {arr.ndim}-D device grid cannot carry axes {self.axis_names}")
        self.devices = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            d = torch.device(arr[idx])
            if d.type == "cuda" and d.index is None:  # the index a tensor there reports
                d = torch.device("cuda", torch.cuda.current_device())
            self.devices[idx] = d
        self.shape = dict(zip(self.axis_names, arr.shape))

    def _key(self):
        return self.axis_names, self.devices.shape, tuple(str(d) for d in self.devices.flat)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(self._key())

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}; {', '.join(str(d) for d in self.devices.flat)})"

    @property
    def first(self) -> torch.device:
        """The device outputs gather to."""
        return self.devices.flat[0]

    def device_at(self, **index: int) -> torch.device:
        """The device at the given axis indices, 0 on every axis not named."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]

    def distinct_devices(self) -> list[torch.device]:
        return list(dict.fromkeys(self.devices.flat))


@dataclass(frozen=True)
class Sharding:
    """A placement on ``mesh``: ``spec[d]`` names the mesh axis dimension d
    splits over, or is None; an empty spec replicates."""

    mesh: Mesh
    spec: tuple = ()


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """(data, model) mesh over ``devices`` (default: the visible cards;
    raises without CUDA).  ``n_data=None`` takes as many as fit.  A list
    may name a device more than once."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    use = n_data * n_model
    if use > len(devices):
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model = {use} devices) exceeds the "
            f"{len(devices)} visible device(s); pass devices= naming a device more than "
            "once to run a mesh on fewer cards")
    if use < 1:
        raise ValueError(f"mesh ({n_data} data x {n_model} model) holds no device")
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[:use]):
        grid.flat[i] = d
    return Mesh(grid, ("data", "model"))


def tensor_device(device) -> torch.device:
    """The device a tensor placed on ``device`` reports (``torch.device(
    "cpu", 1)`` holds tensors on ``cpu``)."""
    return torch.empty(0, device=device).device


def data_axis_size(mesh) -> int:
    """Size of ``mesh``'s 'data' axis; ``ValueError`` when it has none."""
    names = getattr(mesh, "axis_names", ())
    if "data" not in names:
        raise ValueError(f"mesh must have a 'data' axis, got {names}")
    return mesh.shape["data"]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading (batch) axis split over 'data'."""
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def tp_sharded(out_channels: int, n_model: int) -> bool:
    """Whether a conv with ``out_channels`` outputs splits them over a
    ``model`` axis of ``n_model`` devices (the JAX package's rule)."""
    return n_model > 1 and out_channels >= _TP_MIN_CHANNELS and out_channels % n_model == 0


def _tree_map(fn, tree, *rest, path: tuple = ()):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    return fn(path, tree, *rest)


# the output-channel dimension of a conv's weights, by (leaf name, rank): the
# port's (Cout, Cin, kh, kw), the int8 'wq' in the JAX package's (kh, kw,
# Cin, Cout) and the served int8 model's (9 * Cin, Cout) matrix 'w'
_OUT_DIM = {("weight", 4): 0, ("wq", 4): 3, ("w", 2): 1}


def _leaf_spec(path: tuple, leaf, n_model: int) -> tuple:
    shape = tuple(getattr(leaf, "shape", ()))
    name = str(path[-1]).rpartition(".")[2] if path else ""
    out_dim = _OUT_DIM.get((name, len(shape)))
    if out_dim is not None and tp_sharded(shape[out_dim], n_model):
        spec = [None] * len(shape)
        spec[out_dim] = "model"
        return tuple(spec)
    # biases and the other per-channel vectors of sharded convs replicate:
    # each slice's owner takes the matching slice of them
    return ()


def param_shardings(variables: Mapping[str, Any], mesh: Mesh, shard_model: bool = True):
    """The ``Sharding`` of every tensor of a (possibly nested) state dict,
    in its structure."""
    n_model = mesh.shape.get("model", 1) if shard_model else 1
    return _tree_map(lambda path, leaf: Sharding(mesh, _leaf_spec(path, leaf, n_model)),
                     variables)


def shard_variables(variables: Mapping[str, Any], mesh: Mesh, shard_model: bool = True) -> dict:
    """``variables`` placed by ``param_shardings``: {mesh index tuple: the
    state dict that position holds}.  A replicated tensor is the same
    tensor at every position of one device (one copy per distinct device);
    a sharded one holds the position's contiguous slice along its 'model'
    dimension."""
    shardings = param_shardings(variables, mesh, shard_model)
    n_model = mesh.shape.get("model", 1)
    model_dim = mesh.axis_names.index("model") if "model" in mesh.axis_names else None
    placed: dict = {}

    def place(leaf: torch.Tensor, sharding: Sharding, device: torch.device, j: int):
        if "model" not in sharding.spec:
            key = (id(leaf), device)
            if key not in placed:
                placed[key] = leaf.to(device)
            return placed[key]
        key = (id(leaf), device, j)
        if key not in placed:
            dim = sharding.spec.index("model")
            size = leaf.shape[dim] // n_model
            placed[key] = leaf.narrow(dim, j * size, size).to(device).contiguous()
        return placed[key]

    out = {}
    for idx in np.ndindex(mesh.devices.shape):
        device, j = mesh.devices[idx], (idx[model_dim] if model_dim is not None else 0)
        out[idx] = _tree_map(lambda _, leaf, sh: place(leaf, sh, device, j), variables, shardings)
    return out


def shard_batch(batch, mesh: Mesh) -> list:
    """Split the leading axis of every tensor (or numpy array) of ``batch``
    (a tensor, or a tuple, list or dict of them) into ``mesh.shape['data']``
    equal parts, in order: a list of parts, part i on data row i's first
    device.  Raises ``ValueError`` when the axis does not divide."""
    n = mesh.shape["data"]

    def split(t):
        t = torch.as_tensor(t)
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} does not split over {n} data shards")
        rows = t.shape[0] // n
        return [t[i * rows:(i + 1) * rows].to(mesh.device_at(data=i), non_blocking=True)
                for i in range(n)]

    if isinstance(batch, (tuple, list)):
        parts = [split(t) for t in batch]
        return [type(batch)(p[i] for p in parts) for i in range(n)]
    if isinstance(batch, Mapping):
        parts = {k: split(t) for k, t in batch.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(n)]
    return split(batch)


class ShardedStack(list):
    """A stacked array split on axis 1 over a mesh's ``data`` axis: part i
    (S, B / n, ...) on data row i's first device.  ``step(s)``: step s's
    whole batch (B, ...), its parts joined in order on ``home``, the
    mesh's first device, where the mesh steps take their batch."""

    def __init__(self, parts, home: torch.device):
        super().__init__(parts)
        self.home = home

    def step(self, s: int) -> torch.Tensor:
        return torch.cat([p[s].to(self.home) for p in self])


def shard_stacked_batch(batch, mesh: Mesh):
    """A stacked chunk (an array, or a tuple, list or dict of them, each
    (S, B, ...)) with axis 1 split over ``data``: a ``ShardedStack`` per
    array (the JAX package's ``P(None, 'data')`` placement).  Raises
    ``ValueError`` when B does not divide."""
    n = mesh.shape["data"]
    home = tensor_device(mesh.first)

    def split(t):
        t = torch.as_tensor(t)
        if t.shape[1] % n:
            raise ValueError(f"a batch of {t.shape[1]} does not split over {n} data shards")
        rows = t.shape[1] // n
        return ShardedStack([t[:, i * rows:(i + 1) * rows].to(mesh.device_at(data=i))
                             for i in range(n)], home)

    if isinstance(batch, (tuple, list)):
        return type(batch)(split(t) for t in batch)
    if isinstance(batch, Mapping):
        return {k: split(t) for k, t in batch.items()}
    return split(batch)
