"""Training over several processes (counterpart of ``ugpg_tpu/parallel/distributed.py``).

The JAX package's ``initialize`` joins the processes into one JAX runtime,
after which a mesh spans every process's devices and one SPMD program runs
on all of them.  PyTorch has no such program: here each process drives its
own one-process mesh (``parallel/mesh.py``) over its local devices, and the
processes form the outer data axis.  The global step is the unsharded step
on the concatenation of the processes' local batches, in process order
(``global_batch``):

* BN takes the moments of every process's parts (``gather_parts``, a
  differentiable all-gather, in ``models/blocks.py::cross_replica_batch_norm``);
* the gradients are averaged over the processes before the optimizer step
  (``average_gradients``, in the mesh steps of ``train/steps.py`` and
  ``parallel/spatial.py``), so the parameters stay equal on every process;
* the metrics are those of the global batch (``gather_rows`` in
  ``metrics/segmentation.py::grid_metrics`` and the classification steps);
* augmentation parameters and dropout masks are drawn for the global
  batch from every process's generator (seeded alike) and each process
  keeps its rows (``own_rows``);
* process 0 writes the files and the others wait at a barrier
  (``is_writer``, ``barrier``); ``broadcast_module`` makes a model
  process 0's after it is built, transferred or resumed;
* the training commands give each process a disjoint, equal share of the
  datasets (``process_shard``): the global batch is every process's
  loader's batch.

``initialize`` calls ``torch.distributed.init_process_group``: NCCL on the
cards, gloo on the CPU.  NCCL does not run two ranks on one card; gloo
does, staging CUDA tensors through the host.  Every helper is a no-op in
a single process.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multi_host", "host_batch_slice", "global_batch", "world_size",
           "rank", "local_devices", "gather_parts", "gather_rows", "own_rows",
           "average_gradients", "broadcast_module", "agree", "check_same_shape", "barrier",
           "is_writer", "process_shard", "step_mesh"]

DEFAULT_TIMEOUT_S = 300.0


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` with the JAX function's
    fallbacks: the address from the argument or ``UGPG_COORDINATOR_ADDRESS``
    (``host:port`` -> ``tcp://host:port``; an address with a scheme, such as
    ``file://``, as it is), the world size and rank from the arguments or
    torchrun's ``WORLD_SIZE`` / ``RANK``; under torchrun without an address,
    its ``MASTER_ADDR`` / ``MASTER_PORT``.  A no-op when a process group
    already exists, or when neither an address, a process count nor
    torchrun's variables say there are several processes.  ``backend``:
    default NCCL when CUDA is available, else gloo.  ``timeout`` (seconds)
    bounds the rendezvous and every collective, so that a missing peer
    fails instead of hanging."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("UGPG_COORDINATOR_ADDRESS")
    torchrun = "MASTER_ADDR" in os.environ and int(os.environ.get("WORLD_SIZE", "1")) > 1
    if coordinator_address is None and num_processes is None and not torchrun:
        return
    if num_processes is None and "WORLD_SIZE" not in os.environ:
        raise ValueError(
            f"coordinator {coordinator_address!r} given but no process count: pass "
            "num_processes or set WORLD_SIZE (and RANK), as torchrun does")
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank_ = int(process_id if process_id is not None else os.environ.get("RANK", 0))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = None  # torchrun's MASTER_ADDR / MASTER_PORT
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if backend == "nccl":
        torch.cuda.set_device(local_devices()[0])
    dist.init_process_group(backend=backend, init_method=init_method, world_size=world,
                            rank=rank_, timeout=datetime.timedelta(seconds=timeout))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multi_host() -> bool:
    return world_size() > 1


def host_batch_slice(global_batch_size: int) -> slice:
    """This process's contiguous slice of the global batch.  Raises on
    indivisible sizes: flooring would drop the last samples of every
    batch."""
    n = world_size()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes; pad or resize the batch")
    per_host = global_batch_size // n
    start = rank() * per_host
    return slice(start, start + per_host)


def global_batch(local_arrays, mesh):
    """This process's part of the global batch, placed: ``local_arrays``
    (a tensor or numpy array, or a tuple, list or dict of them) is the
    rows ``host_batch_slice`` gives this process, in process order, as
    ``jax.make_array_from_process_local_data`` takes them; the result is
    its split over the local mesh's 'data' axis (``shard_batch``: a list of
    parts, part i on data row i's first device).  The global batch holds
    ``world_size()`` times the local rows."""
    from ugpg_tpu_torch.parallel.mesh import shard_batch

    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))

    if isinstance(local_arrays, (tuple, list)):
        return shard_batch(type(local_arrays)(tensor(a) for a in local_arrays), mesh)
    if isinstance(local_arrays, dict):
        return shard_batch({k: tensor(a) for k, a in local_arrays.items()}, mesh)
    return shard_batch(tensor(local_arrays), mesh)


def step_mesh(mesh, sharded: bool):
    """The mesh a trainer runs a batch on: ``mesh`` when the batch splits
    over it; for one that does not (a ragged tail), none in one process,
    and over several a one-device mesh on ``mesh``'s first device, so that
    BN, the loss and the gradients still span the processes."""
    if sharded or mesh is None:
        return mesh
    if world_size() == 1:
        return None
    from ugpg_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(1, 1, devices=[mesh.first])


def local_devices() -> list[torch.device]:
    """The cards this process drives: the visible ones, split evenly among
    the processes of this host when torchrun's ``LOCAL_RANK`` /
    ``LOCAL_WORLD_SIZE`` say there are several."""
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if local_world <= 1:
        return cards
    per = len(cards) // local_world
    if per == 0:
        raise ValueError(f"{len(cards)} visible card(s) for {local_world} local processes")
    start = int(os.environ.get("LOCAL_RANK", 0)) * per
    return cards[start:start + per]


class _ProcessShard:
    """Process ``rank``'s share of a map-style dataset: items ``rank``,
    ``rank + P``, ... of its first ``(len // P) * P``, so that every process
    holds as many."""

    def __init__(self, dataset, rank_: int, world: int):
        self.dataset, self._rank, self._world = dataset, rank_, world
        self._len = len(dataset) // world

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int):
        if not 0 <= i < self._len:
            raise IndexError(i)
        return self.dataset[i * self._world + self._rank]


def process_shard(dataset):
    """The dataset a process loads: itself in one process, else this
    process's disjoint, equal share (``_ProcessShard``), so that an epoch
    of every process's loader reads the dataset once."""
    if world_size() == 1:
        return dataset
    return _ProcessShard(dataset, rank(), world_size())


def _comm_device(t: torch.Tensor | None = None) -> torch.device:
    """Where a collective's buffer lies: NCCL takes the current card, gloo
    the tensor's own device (CUDA tensors go through the host)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device if t is not None else torch.device("cpu")


class _GatherParts(torch.autograd.Function):
    """All-gather along a new leading axis, in rank order; the backward sums
    every process's gradient of each slot (an all-reduce) and keeps this
    process's slot."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        ctx.device, ctx.rank = t.device, dist.get_rank()
        buf = t.detach().contiguous().to(_comm_device(t))
        out = [torch.empty_like(buf) for _ in range(dist.get_world_size())]
        dist.all_gather(out, buf)
        return torch.stack(out).to(t.device)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        g = grad.contiguous().to(_comm_device(grad))
        dist.all_reduce(g)
        return g[ctx.rank].to(ctx.device)


def gather_parts(t: torch.Tensor) -> torch.Tensor:
    """(P, *t.shape): every process's ``t`` (the same shape on each), in
    rank order, differentiable (the gradient of the slot of process p
    reaches p's ``t``, summed over the processes' losses).  One process:
    ``t[None]``."""
    if world_size() == 1:
        return t[None]
    return _GatherParts.apply(t)


@torch.no_grad()
def gather_rows(*tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Each tensor concatenated along its first axis over the processes, in
    rank order (every process's tensors have these shapes), in one
    collective; not differentiable."""
    if world_size() == 1:
        return tensors
    home = tensors[0].device
    flat = torch.cat([t.detach().to(home, torch.float64).reshape(-1) for t in tensors])
    buf = flat.to(_comm_device(flat))
    out = [torch.empty_like(buf) for _ in range(world_size())]
    dist.all_gather(out, buf)
    parts, offset = [], 0
    for t in tensors:
        n = t.numel()
        parts.append(torch.cat([o[offset:offset + n].reshape(t.shape) for o in out])
                     .to(home, t.dtype))
        offset += n
    return tuple(parts)


def own_rows(t, n_local: int):
    """This process's ``n_local`` rows of ``t`` (a tensor or a dict of
    them) drawn for the global batch."""
    r = rank()
    if isinstance(t, dict):
        return {k: v[r * n_local:(r + 1) * n_local] for k, v in t.items()}
    return t[r * n_local:(r + 1) * n_local]


@torch.no_grad()
def average_gradients(params) -> None:
    """Replace every gradient by its mean over the processes (one
    all-reduce of all of them); the same on every process, so the
    parameters stay equal after the optimizer step."""
    n = world_size()
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    buf = flat.to(_comm_device(flat))
    dist.all_reduce(buf)
    buf = buf.to(flat.device).div_(n)
    offset = 0
    for g in grads:
        g.copy_(buf[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module) -> None:
    """Every parameter and buffer of ``module`` set to process 0's."""
    if world_size() == 1:
        return
    for t in module.state_dict().values():
        buf = t.to(_comm_device(t))
        dist.broadcast(buf, 0)
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)


def agree(flag: bool) -> bool:
    """True on every process when it is true on any (a signal that reached
    one process stops them all at the same epoch)."""
    if world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def check_same_shape(shape) -> None:
    """Raise ``ValueError`` unless every process's batch has ``shape``: the
    processes take the same branch and gather parts of equal sizes, or
    their collectives would not match."""
    if world_size() == 1:
        return
    mine = torch.tensor(list(shape), dtype=torch.int64, device=_comm_device())
    out = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(out, mine)
    shapes = [tuple(o.tolist()) for o in out]
    if len(set(shapes)) > 1:
        raise ValueError(f"the processes' local batches differ in shape: {shapes}; every "
                         "process must feed a batch of the same shape")


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def is_writer() -> bool:
    """Whether this process writes files (process 0)."""
    return rank() == 0
