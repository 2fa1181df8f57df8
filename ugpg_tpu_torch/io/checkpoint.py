"""Checkpoints: the reference's ``.pth`` files and the JAX package's
checkpoint directories (flax msgpack, orbax and orbax-async), read and
written all.

The container is the reference trainer's schema ``{stage, epoch,
model_state_dict, optimizer_state_dict, val_dice, train_dice,
uncertainty_alpha, history}``; the reader takes its stage from it, and a
bare state dict is stage 4, as the reference's loader assumes.

* ``backend="pth"`` (the default, the reference repo's format): one
  ``torch.save`` file.  The JAX package reads it too (its
  ``io/torch_import.py``).
* ``backend="msgpack"``: the JAX package's default checkpoint
  (``ugpg_tpu/io/checkpoint.py``), a directory holding
  ``variables.msgpack`` (``{'params', 'batch_stats'}`` in flax's layout
  and names, ``io/from_jax.py``), ``opt_state.msgpack`` (the optax state
  tree, ``train/optim.py``) and ``metadata.json`` (every other container
  key, made JSON-plain; the exact learning rate beside the tree's float32
  as ``lr``).  The bytes are flax's for the same tree (``io/msgpack.py``),
  so the JAX package loads the directory with its own templates and its
  trainers resume from it; ``num_batches_tracked``, which flax lacks,
  reads back as 0.
* ``backend="orbax"``: the same trees and ``metadata.json``, the trees as
  orbax PyTree directories ``variables_orbax/`` and ``opt_state_orbax/``
  (``io/orbax.py``: zarr arrays in an OCDBT store, zstd frames), each
  written beside its name and renamed into place when whole.
* ``backend="orbax-async"``: the same files, written by one background
  thread per tree (``"vars"``, ``"opt"``), as the JAX package's
  ``AsyncCheckpointer``s.  ``save_checkpoint`` returns once the trees are
  host copies (a tensor on the card is copied by a blocking ``.cpu()``, so
  the next optimizer step cannot reach the checkpoint); a save waits for
  the previous save of its tree before it replaces the directory;
  ``read_checkpoint`` and ``load_checkpoint`` wait for every save, and so
  does ``wait_for_async_saves()``, which raises a writer's error.

The readers (``read_checkpoint``, ``load_checkpoint``, ``has_checkpoint``,
``sniff_stage``) take any form, by the kind of path; a directory with
``variables_orbax/`` reads as orbax, as the JAX package's loader does.

Each file is written beside its name and renamed into place, so a ``.pth``
that exists is whole; a directory's ``metadata.json`` is removed first and
written last, so a directory that has it and its variables is whole (the
JAX trainers' resume test; an orbax-async save writes ``metadata.json``
before its trees commit, as the JAX package's does).

The reference's Herlev classifier holds a whole ``PGUNet{stage}``, so its
``.pth`` carries the decoder's keys too, which its forward never reads.
``full_classifier_state_dict`` writes that key set, the missing blocks
filled from a seeded fresh initialisation of the segmentation stage (the
JAX export does the same); ``classifier_state_dict`` reads it back,
dropping only the ``unet.`` keys of blocks the stage's encoder lacks.  A
directory holds JAX's key set (the encoder only), and reads back filled as
a ``.pth``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np
import torch

__all__ = ["BACKENDS", "save_checkpoint", "wait_for_async_saves", "load_checkpoint",
           "read_checkpoint", "read_trees", "container_stage", "has_checkpoint", "sniff_stage",
           "latest_checkpoint", "checkpoint_backend_of", "checkpoint_metadata",
           "checkpoint_path", "find_checkpoint", "classifier_decoder_fill",
           "full_classifier_state_dict", "classifier_state_dict"]

BACKENDS = ("pth", "msgpack", "orbax", "orbax-async")
_VARS, _OPT, _META = "variables.msgpack", "opt_state.msgpack", "metadata.json"
_ORBAX_VARS, _ORBAX_OPT = "variables_orbax", "opt_state_orbax"


def _to_cpu(obj):
    """Every tensor of a nested dict/list on the CPU, detached."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _write(path: Path, data: bytes) -> None:
    """``path`` whole or not at all (written beside it, then renamed)."""
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def _json_plain(obj):
    """Metadata as JSON takes it: tensors and arrays as numbers or lists."""
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, (np.ndarray, np.generic)):
        return obj.tolist()
    if isinstance(obj, Mapping):
        return {str(k): _json_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_plain(v) for v in obj]
    return obj


def _is_classifier(state_dict: Mapping[str, Any]) -> bool:
    return any(k.startswith("classifier.") for k in state_dict)


def save_checkpoint(path: str | os.PathLike, state_dict: Mapping[str, torch.Tensor],
                    backend: str = "pth", param_names: Sequence[str] | None = None,
                    **metadata: Any) -> Path:
    """Write ``{**metadata, 'model_state_dict': state_dict}`` as ``path``
    (tensors moved to the CPU).  ``metadata`` carries the schema's other
    keys: ``stage``, ``epoch``, ``optimizer_state_dict``, ``val_dice``,
    ``train_dice``, ``uncertainty_alpha``, ``history``.

    ``backend="pth"``: one file, which appears whole or not at all.
    ``backend="msgpack"``, ``"orbax"``, ``"orbax-async"``: the JAX
    package's directory (see the module's docstring); a torch
    ``optimizer_state_dict`` is converted to the optax tree with
    ``param_names``, the state-dict names of the optimizer's parameters in
    its order (``train.optim.param_names``); an optax tree is written as it
    is."""
    path = Path(path)
    if checkpoint_backend_of(backend) != "pth":
        return _save_directory(path, state_dict, param_names, metadata, backend)
    path.parent.mkdir(parents=True, exist_ok=True)
    obj = _to_cpu({**metadata, "model_state_dict": dict(state_dict)})
    tmp = path.with_name(path.name + f".{os.getpid()}.tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)
    return path


def checkpoint_backend_of(backend: str) -> str:
    """``backend`` if it is one of ``BACKENDS``, else ``ValueError``."""
    if backend in BACKENDS:
        return backend
    raise ValueError(f"unknown checkpoint backend: {backend!r}")


class _AsyncWriter:
    """One background thread that writes one kind of tree; a writer's error
    is raised by the next ``wait``."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(1)
        self._pending: Future | None = None

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def submit(self, target: Path, tree) -> None:
        self.wait()
        old = target.with_name(target.name + ".replaced")
        if target.exists():  # no old tree beside the new metadata; deleted off this thread
            shutil.rmtree(old, ignore_errors=True)
            os.rename(target, old)
        self._pending = self._pool.submit(self._write, target, tree, old)

    @staticmethod
    def _write(target: Path, tree, old: Path) -> None:
        from ugpg_tpu_torch.io import orbax

        shutil.rmtree(old, ignore_errors=True)
        orbax.write_pytree(target, tree)


_writers_lock = threading.Lock()
_WRITERS: dict[str, _AsyncWriter] = {}


def _writer(kind: str) -> _AsyncWriter:
    with _writers_lock:
        return _WRITERS.setdefault(kind, _AsyncWriter())


def wait_for_async_saves() -> None:
    """Block until every orbax-async save has committed; raise the first
    error a writer met."""
    with _writers_lock:
        writers = list(_WRITERS.values())
    errors = []
    for w in writers:
        try:
            w.wait()
        except Exception as e:  # every writer is waited for before one error is raised
            errors.append(e)
    if errors:
        raise errors[0]


def _host_copy(tree):
    """A nested dict of numpy arrays that shares no memory with ``tree``."""
    if isinstance(tree, Mapping):
        return {k: _host_copy(v) for k, v in tree.items()}
    return np.array(tree, order="C")


def _save_directory(path: Path, state_dict, param_names, metadata: dict, backend: str) -> Path:
    from ugpg_tpu_torch.io.from_jax import jax_variables_from_state_dict
    from ugpg_tpu_torch.io.msgpack import to_bytes
    from ugpg_tpu_torch.io.orbax import write_pytree
    from ugpg_tpu_torch.train.optim import is_jax_optimizer_state, optimizer_state_to_jax

    metadata = dict(metadata)
    if _is_classifier(state_dict):
        state_dict = classifier_state_dict(state_dict, container_stage(metadata))
    variables = jax_variables_from_state_dict(state_dict)
    opt = metadata.pop("optimizer_state_dict", None)
    if opt is not None and is_jax_optimizer_state(opt):
        opt = _host_copy(opt)  # a tree given as it is may be changed in place later
    elif opt is not None:
        if param_names is None:
            raise ValueError(f"a {backend} checkpoint of a torch optimizer state needs "
                             "param_names")
        metadata["lr"] = float(opt["param_groups"][0]["lr"])
        opt = optimizer_state_to_jax(opt, param_names, variables["params"])
    path.mkdir(parents=True, exist_ok=True)
    (path / _META).unlink(missing_ok=True)  # the directory is whole again once it is back
    trees = ((path / _ORBAX_VARS, path / _VARS, "vars", variables),
             (path / _ORBAX_OPT, path / _OPT, "opt", opt))
    for folder, file, kind, tree in trees:
        if backend == "msgpack":
            _writer(kind).wait()  # an orbax-async save of this tree must not land after
            shutil.rmtree(folder, ignore_errors=True)
            if tree is not None:
                _write(file, to_bytes(tree))
            else:
                file.unlink(missing_ok=True)
            continue
        file.unlink(missing_ok=True)
        if backend == "orbax-async" and tree is not None:
            _writer(kind).submit(folder, tree)
        else:
            _writer(kind).wait()
            if tree is not None:
                write_pytree(folder, tree)
            else:
                shutil.rmtree(folder, ignore_errors=True)
    _write(path / _META, json.dumps(_json_plain(metadata), indent=2).encode())
    return path


def read_trees(path: str | os.PathLike) -> tuple[dict, Any]:
    """The flax variable tree and the optax tree (None where there is none)
    of a msgpack or orbax checkpoint directory, numpy leaves, read once
    every orbax-async save has committed."""
    from ugpg_tpu_torch.io.msgpack import msgpack_restore
    from ugpg_tpu_torch.io.orbax import read_pytree

    path = Path(path)
    wait_for_async_saves()  # a just-written orbax-async checkpoint must be whole
    if (path / _ORBAX_VARS).is_dir():
        variables = read_pytree(path / _ORBAX_VARS)
        opt = read_pytree(path / _ORBAX_OPT) if (path / _ORBAX_OPT).is_dir() else None
    elif (path / _VARS).is_file():
        variables = msgpack_restore((path / _VARS).read_bytes())
        opt = msgpack_restore((path / _OPT).read_bytes()) if (path / _OPT).is_file() else None
    else:
        raise FileNotFoundError(f"{path}: no {_VARS} and no {_ORBAX_VARS}/, not a checkpoint "
                                "directory")
    return variables, opt


def _read_directory(path: Path) -> dict[str, Any]:
    from ugpg_tpu_torch.io.from_jax import state_dict_from_jax

    variables, opt = read_trees(path)
    obj = {**checkpoint_metadata(path), "model_state_dict": state_dict_from_jax(variables)}
    if _is_classifier(obj["model_state_dict"]):
        obj["model_state_dict"] = full_classifier_state_dict(obj["model_state_dict"],
                                                             container_stage(obj))
    if opt is not None:
        obj["optimizer_state_dict"] = opt
    return obj


def read_checkpoint(path: str | os.PathLike) -> dict[str, Any]:
    """The whole container as a dict (a bare state dict comes back as
    ``{'model_state_dict': ...}``), tensors on the CPU.  ``path`` is a
    ``.pth`` file or a msgpack or orbax directory (read once every
    orbax-async save has committed); a directory's optimizer state is the
    optax tree (``train.optim.load_optimizer_state`` takes it)."""
    if Path(path).is_dir():
        return _read_directory(Path(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a state dict or a checkpoint container")
    if "model_state_dict" in obj:
        return obj
    return {"model_state_dict": obj}


def container_stage(obj: Mapping[str, Any], default: int = 4) -> int:
    """The stage of a container from ``read_checkpoint``: its ``stage``,
    else ``default`` (the reference assumes a bare state dict is stage 4)."""
    return int(obj["stage"]) if "stage" in obj else default


def load_checkpoint(path: str | os.PathLike) -> tuple[int, dict[str, torch.Tensor]]:
    """-> (stage, state dict of CPU tensors)."""
    obj = read_checkpoint(path)
    return container_stage(obj), dict(obj["model_state_dict"])


def has_checkpoint(path: str | os.PathLike) -> bool:
    """True if ``path`` is a checkpoint file or a directory with
    ``variables.msgpack`` or a committed ``variables_orbax/`` (the JAX
    package's test: an orbax-async save still in flight has neither)."""
    path = Path(path)
    return (path.is_file() or (path / _VARS).is_file()
            or (path / _ORBAX_VARS / "_METADATA").is_file())


def sniff_stage(path: str | os.PathLike, default: int = 4) -> int:
    """The stage of the checkpoint ``path`` (see ``container_stage``); a
    directory's from its ``metadata.json`` alone."""
    return container_stage(checkpoint_metadata(path), default)


def checkpoint_path(directory: str | os.PathLike, name: str, backend: str) -> Path:
    """Where a trainer writes checkpoint ``name`` (``ug_pgunet_stage4_best``):
    ``name.pth`` or the directory ``name``."""
    return Path(directory) / (f"{name}.pth" if backend == "pth" else name)


def checkpoint_metadata(path: str | os.PathLike) -> dict[str, Any]:
    """The container without its weights and optimizer state; a
    directory's from its ``metadata.json`` alone."""
    path = Path(path)
    if path.is_dir():
        meta = path / _META
        return json.loads(meta.read_text()) if meta.is_file() else {}
    return {k: v for k, v in read_checkpoint(path).items()
            if k not in ("model_state_dict", "optimizer_state_dict")}


def find_checkpoint(directory: str | os.PathLike, name: str) -> Path | None:
    """The whole checkpoint ``name`` in ``directory`` in either form:
    ``name.pth``, or the directory ``name`` with its ``metadata.json`` and
    committed variables.  Where both are there, the later epoch's (then the
    later written)."""
    pth, folder = checkpoint_path(directory, name, "pth"), checkpoint_path(directory, name,
                                                                            "msgpack")
    found = [p for p in (pth, folder)
             if p.is_file() or (has_checkpoint(p) and (p / _META).is_file())]
    if len(found) < 2:
        return found[0] if found else None

    def written(p: Path) -> tuple[int, int]:
        stamp = p if p.is_file() else p / _META
        return int(checkpoint_metadata(p).get("epoch", -1)), stamp.stat().st_mtime_ns

    return max(found, key=written)


def latest_checkpoint(directory: str | os.PathLike, prefix: str = "") -> Path | None:
    """The most recently written checkpoint (file or directory) under
    ``directory`` whose name starts with ``prefix``; None if there is none."""
    directory = Path(directory)
    if not directory.is_dir():
        return None
    found = [p for p in directory.iterdir()
             if p.name.startswith(prefix) and has_checkpoint(p)
             and (p.suffix == ".pth" or p.is_dir())]
    return max(found, key=lambda p: p.stat().st_mtime) if found else None


def _decoder_blocks(stage: int) -> set[str]:
    """The blocks of ``PGUNet{stage}`` the stage's classifier encoder lacks."""
    from ugpg_tpu_torch.models.classifier import ENCODER_SPECS
    from ugpg_tpu_torch.models.pgunet import STAGE_BLOCKS

    return set(STAGE_BLOCKS[stage]) - {"inc"} - {name for name, _ in ENCODER_SPECS[stage][1]}


def classifier_decoder_fill(stage: int, seed: int = 0) -> dict[str, torch.Tensor]:
    """``unet.``-prefixed CPU tensors of the blocks of ``PGUNet{stage}``
    (one class) that the stage's classifier lacks, from torch's default
    initialisation drawn from ``torch.Generator().manual_seed(seed)``."""
    from ugpg_tpu_torch.models.blocks import init_parameters
    from ugpg_tpu_torch.models.pgunet import STAGE_MODELS

    template = STAGE_MODELS[stage](num_classes=1)
    init_parameters(template, torch.Generator().manual_seed(seed))
    blocks = _decoder_blocks(stage)
    return {f"unet.{k}": v for k, v in template.state_dict().items()
            if k.split(".", 1)[0] in blocks}


def full_classifier_state_dict(state_dict: Mapping[str, torch.Tensor], stage: int,
                               fill: Mapping[str, torch.Tensor] | None = None
                               ) -> dict[str, torch.Tensor]:
    """A classifier's state dict with the reference's full ``unet`` key set:
    ``fill`` (``classifier_decoder_fill(stage)`` when None) adds the keys
    the classifier lacks; its own keys always win."""
    out = dict(fill if fill is not None else classifier_decoder_fill(stage))
    out.update(state_dict)
    return out


def classifier_state_dict(state_dict: Mapping[str, torch.Tensor], stage: int
                          ) -> dict[str, torch.Tensor]:
    """A reference classifier state dict without the ``unet.`` keys of the
    decoder blocks; every other key is kept, so that a strict load still
    raises on anything else missing or unexpected."""
    blocks = _decoder_blocks(stage)
    return {k: v for k, v in state_dict.items()
            if not (k.startswith("unet.") and k.split(".", 2)[1] in blocks)}
