"""Command lines of the port, and ``parse_mesh``, the ``--mesh`` grammar they share."""

from __future__ import annotations

import os

# why serve --mesh does not run across processes (ROADMAP.md, "Not to port")
SERVE_ACROSS_PROCESSES = (
    "serving across processes has no JAX program to port: under a coordinator JAX's "
    "Predictor fetches outputs sharded over every process's devices with np.asarray "
    "(ugpg_tpu/eval/serving.py:473), which JAX refuses (ROADMAP.md, \"Not to port\"); "
    "serve from one process")


def coordinator_configured() -> bool:
    """Whether this process is one of several: ``UGPG_COORDINATOR_ADDRESS``
    set, or torchrun's ``WORLD_SIZE`` above 1."""
    return bool(os.environ.get("UGPG_COORDINATOR_ADDRESS")) or int(
        os.environ.get("WORLD_SIZE", "1")) > 1


def parse_mesh(spec: str | None, device: str = "cuda", join: bool = True):
    """``'DATA[,MODEL]'`` or ``'auto'`` -> a ``parallel.mesh.Mesh`` (None ->
    None), as ``ugpg_tpu/cli/train_monuseg.py::parse_mesh``.  On ``cuda``
    the mesh takes the visible cards and raises ``ValueError`` when it asks
    for more; on the CPU, which torch counts as one device, it repeats the
    CPU as often as the mesh asks ('auto': once).  A junk spec exits with
    the JAX package's message.

    ``join``: first join the processes (``parallel/distributed.py::
    initialize``: gloo on the CPU, NCCL on the cards; a no-op without a
    coordinator), as the JAX function does.  The mesh is then this
    process's own, over its local cards (``local_devices``), and the
    processes form the outer data axis: ``--mesh 2`` on 3 processes trains
    6-way data-parallel."""
    if not spec:
        return None
    from ugpg_tpu_torch.device import resolve_device
    from ugpg_tpu_torch.parallel import distributed
    from ugpg_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if join:
        distributed.initialize(backend="gloo" if dev.type == "cpu" else None)
    cards = distributed.local_devices() if dev.type == "cuda" else None
    if spec == "auto":
        return make_mesh(devices=[dev] if dev.type == "cpu" else cards)
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        parts = []
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2:
        raise SystemExit(f"--mesh expects DATA[,MODEL] or 'auto', got {spec!r}")
    devices = [dev] * (parts[0] * parts[1]) if dev.type == "cpu" else cards
    return make_mesh(n_data=parts[0], n_model=parts[1], devices=devices)
