"""Orbax's PyTree checkpoint directory (``orbax.checkpoint.PyTreeCheckpointer``
in orbax-checkpoint 0.11), read and written without orbax or tensorstore.

The directory holds ``_METADATA`` (the tree: each leaf's path, by the repr
of its key tuple, and its kind), ``_CHECKPOINT_METADATA`` (the handler and
the save's timestamps) and an OCDBT database (``io/ocdbt.py``) in which
each array is a zarr v2 array named by its path joined with ``.``: a
``.zarray`` JSON and its chunks (``<name>/0.0...``, ``<name>/0`` for a 0-d
array), each one zstd frame.  A leaf of kind ``"Dict"`` is an empty
subtree (optax's empty states).

``write_pytree`` writes what orbax writes for a tree of ``np.ndarray``
leaves (one chunk an array, zstd level 1, the JAX package saves so), into
``<name>.orbax-checkpoint-tmp`` beside the directory, renamed into place
when whole, as orbax commits.  ``read_pytree`` reads that, any chunking
and either order; a zarr3 directory, a directory without OCDBT, a codec
other than zstd or another handler's directory raises ``ValueError``
naming the field: the JAX package writes none of them.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from ugpg_tpu_torch import native
from ugpg_tpu_torch.io import ocdbt

__all__ = ["read_pytree", "write_pytree", "TMP_SUFFIX", "ZSTD_LEVEL"]

TMP_SUFFIX = ".orbax-checkpoint-tmp"
ZSTD_LEVEL = 1
_METADATA, _CHECKPOINT_METADATA = "_METADATA", "_CHECKPOINT_METADATA"
_HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"
_DICT_KEY = 2  # orbax's KeyType.DICT
_WORKERS = min(8, os.cpu_count() or 1)  # ctypes drops the GIL: frames code in parallel


def _field(directory: Path, name: str, value, expected) -> None:
    if value != expected:
        raise ValueError(f"{directory}: {name}={value!r}; the port reads {expected!r}, the "
                         f"only form the JAX package writes")


# ---------------------------------------------------------------- reading
def _read_array(db: ocdbt.Database, name: str, label: Path) -> np.ndarray:
    z = json.loads(db.read(f"{name}/.zarray"))
    _field(label, f"{name} zarr_format", z.get("zarr_format"), 2)
    _field(label, f"{name} compressor id", (z.get("compressor") or {}).get("id"), "zstd")
    _field(label, f"{name} filters", z.get("filters"), None)
    if z.get("order") not in ("C", "F"):
        raise ValueError(f"{label}: {name} order={z.get('order')!r}; zarr has C and F")
    dtype = np.dtype(z["dtype"])
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [range(math.ceil(s / c)) if c else range(1) for s, c in zip(shape, chunks)]
    chunk_bytes = math.prod(chunks) * dtype.itemsize

    def fill(index: tuple[int, ...]) -> None:
        key = f"{name}/{sep.join(map(str, index)) if index else '0'}"
        if key not in db:  # orbax writes every chunk (store_array_data_equal_to_fill_value)
            raise ValueError(f"{label}: chunk {key} missing")
        chunk = native.zstd_decompress(db.read(key), chunk_bytes).view(dtype).reshape(
            chunks, order=z["order"])
        at = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[at] = chunk[tuple(slice(0, a.stop - a.start) for a in at)]

    indices = list(product(*grid))
    if len(indices) == 1:
        fill(indices[0])
    else:
        with ThreadPoolExecutor(_WORKERS) as pool:
            list(pool.map(fill, indices))
    return out


def read_pytree(directory: str | os.PathLike) -> dict[str, Any]:
    """The nested dict of numpy arrays (0-d arrays kept 0-d) and empty
    dicts that orbax would restore from ``directory`` without a template."""
    directory = Path(directory)
    meta = json.loads((directory / _METADATA).read_text())
    _field(directory, "use_zarr3", meta.get("use_zarr3", False), False)
    _field(directory, "use_ocdbt", meta.get("use_ocdbt", True), True)
    info = directory / _CHECKPOINT_METADATA
    if info.is_file():  # absent in directories of older orbax versions
        handler = json.loads(info.read_text()).get("item_handlers", _HANDLER)
        if not str(handler).endswith("PyTreeCheckpointHandler"):
            raise ValueError(f"{directory}: item_handlers={handler!r}; the port reads "
                             "PyTreeCheckpointHandler's directories, as the JAX package "
                             "writes them")
    db = ocdbt.Database(directory)
    leaves = []
    for entry in meta["tree_metadata"].values():
        path = []
        for key in entry["key_metadata"]:
            _field(directory, "key_type", key["key_type"], _DICT_KEY)
            path.append(str(key["key"]))
        kind = entry["value_metadata"]["value_type"]
        if kind not in ("np.ndarray", "Dict"):
            raise ValueError(f"{directory}: value_type={kind!r} at {tuple(path)}; the port "
                             f"reads 'np.ndarray' and 'Dict', as the JAX package writes them")
        leaves.append((path, kind))
    with ThreadPoolExecutor(_WORKERS) as pool:
        values = list(pool.map(lambda leaf: {} if leaf[1] == "Dict" else
                                _read_array(db, ".".join(leaf[0]), directory), leaves))
    tree: dict[str, Any] = {}
    for (path, _), value in zip(leaves, values):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


# ---------------------------------------------------------------- writing
def _flatten(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    """(path, array or None for an empty dict), by sorted keys as JAX
    flattens a dict."""
    for key in sorted(tree):
        value, path = tree[key], prefix + (str(key),)
        if isinstance(value, Mapping):
            if value:
                yield from _flatten(value, path)
            else:
                yield path, None
        else:
            yield path, np.asarray(value)


def _zarray(array: np.ndarray) -> bytes:
    return json.dumps({"chunks": list(array.shape), "compressor": {"id": "zstd",
                       "level": ZSTD_LEVEL}, "dimension_separator": ".",
                       "dtype": array.dtype.str, "fill_value": None, "filters": None,
                       "order": "C", "shape": list(array.shape), "zarr_format": 2},
                      separators=(",", ":"), sort_keys=True).encode()


def write_pytree(directory: str | os.PathLike, tree: Mapping[str, Any]) -> Path:
    """Write ``tree`` (nested dicts of arrays on the host) as orbax writes it
    in ``directory``, replacing what is there; the directory appears whole
    or not at all."""
    directory = Path(directory)
    started = time.time_ns()
    leaves = list(_flatten(tree))
    arrays = [(p, np.asarray(a, order="C")) for p, a in leaves if a is not None]
    with ThreadPoolExecutor(_WORKERS) as pool:
        frames = list(pool.map(lambda pa: native.zstd_compress(pa[1].reshape(-1).view(np.uint8),
                                                               ZSTD_LEVEL), arrays))
    items = []
    for (path, array), frame in zip(arrays, frames):
        name = ".".join(path)
        items += [(f"{name}/.zarray", _zarray(array)),
                  (f"{name}/{'.'.join('0' * array.ndim) or '0'}", frame)]
    tmp = directory.with_name(directory.name + TMP_SUFFIX)
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    ocdbt.write_database(tmp, items)
    tree_metadata = {
        repr(path): {"key_metadata": [{"key": k, "key_type": _DICT_KEY} for k in path],
                     "value_metadata": {"value_type": "Dict" if a is None else "np.ndarray",
                                        "skip_deserialize": a is None}}
        for path, a in leaves}
    (tmp / _METADATA).write_text(json.dumps({
        "tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (tmp / _CHECKPOINT_METADATA).write_text(json.dumps({
        "item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}}))
    shutil.rmtree(directory, ignore_errors=True)
    os.rename(tmp, directory)
    return directory
