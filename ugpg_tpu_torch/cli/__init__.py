"""Command lines of the port, and ``parse_mesh``, the ``--mesh`` grammar they share."""

from __future__ import annotations

import os


def parse_mesh(spec: str | None, device: str = "cuda"):
    """``'DATA[,MODEL]'`` or ``'auto'`` -> a ``parallel.mesh.Mesh`` (None ->
    None), as ``ugpg_tpu/cli/train_monuseg.py::parse_mesh``.  On ``cuda``
    the mesh takes the visible cards and raises ``ValueError`` when it asks
    for more; on the CPU, which torch counts as one device, it repeats the
    CPU as often as the mesh asks ('auto': once).  A junk spec exits with
    the JAX package's message.  Multi-host (``UGPG_COORDINATOR_ADDRESS``
    set, ``parallel/distributed.py``) raises ``NotImplementedError``."""
    if not spec:
        return None
    if os.environ.get("UGPG_COORDINATOR_ADDRESS"):
        raise NotImplementedError(
            "not ported to ugpg_tpu_torch yet: a multi-host --mesh (UGPG_COORDINATOR_ADDRESS "
            "is set; parallel/distributed.py, ROADMAP.md queue A, item 4b.4)")
    from ugpg_tpu_torch.device import resolve_device
    from ugpg_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if spec == "auto":
        return make_mesh(devices=[dev] if dev.type == "cpu" else None)
    try:
        parts = [int(x) for x in spec.split(",")]
    except ValueError:
        parts = []
    if len(parts) == 1:
        parts.append(1)
    if len(parts) != 2:
        raise SystemExit(f"--mesh expects DATA[,MODEL] or 'auto', got {spec!r}")
    devices = [dev] * (parts[0] * parts[1]) if dev.type == "cpu" else None
    return make_mesh(n_data=parts[0], n_model=parts[1], devices=devices)
