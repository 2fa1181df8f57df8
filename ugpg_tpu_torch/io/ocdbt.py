"""OCDBT, tensorstore's key-value store in files, as orbax checkpoints use it:
read and write, in the standard library, numpy and the port's zstd
(``native/zstd.cpp``).

A database is a directory.  Its ``manifest.ocdbt`` holds the
configuration, a table of data files, the newest versions inline and
references to version-tree nodes for older ones.  A version names the root
of a B-tree.  B-tree nodes and values live in data files (``d/<hex>``); a
leaf holds each value inline or as (data file, offset, length), an interior
node the (data file, offset, length) of each child.  Every manifest and node
file has the same frame: a big-endian magic, the file's length as a
little-endian u64, a version varint (0), a compression varint (0 none,
1 zstd), the body, and the CRC-32C of everything before it as a
little-endian u32.  The bodies store their lists column by column, keys and
paths prefix-compressed.  A data file's path in a node's table is
``base_path + relative_path``, below the base path of the file that holds
the node (empty for the manifest's table).

Orbax writes one database per process under ``ocdbt.process_<N>/`` and
merges them into the directory's own, whose nodes point into the process
databases' data files.  ``write_database`` writes that layout for one
process, with one version; ``Database`` reads any single-manifest database,
whatever its tree's height and however many versions it holds.  Every
field was held to tensorstore's own files in both directions
(``tests/test_torch_orbax_checkpoint.py``).
"""

from __future__ import annotations

import os
import secrets
import struct
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

from ugpg_tpu_torch import native

__all__ = ["Database", "write_database", "MANIFEST", "PROCESS_DIR"]

MANIFEST = "manifest.ocdbt"
PROCESS_DIR = "ocdbt.process_0"
_MANIFEST_MAGIC, _BTREE_MAGIC, _VERSION_MAGIC = 0x0CDB3A2A, 0x0CDB20DE, 0x0CDB1234
_HEADER = 4 + 8  # magic, length; then the version and compression varints

# the configuration orbax gives tensorstore (``ocdbt`` kvstore defaults but
# for max_inline_value_bytes and max_decoded_node_bytes)
_MAX_INLINE_VALUE_BYTES = 1024
_MAX_DECODED_NODE_BYTES = 100_000_000
_VERSION_TREE_ARITY_LOG2 = 4
_NODE_ZSTD_LEVEL = 0  # libzstd's default level, as tensorstore writes nodes


# ---------------------------------------------------------------- encoding
class _Cursor:
    def __init__(self, data: bytes, label: str):
        self.data, self.pos, self.label = data, 0, label

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"{self.label}: truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.label}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"{self.label}: {len(self.data) - self.pos} bytes past the end")


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in values)


def _unframe(data: bytes, magic: int, label: str) -> bytes:
    """The body of a manifest or node file, its frame checked."""
    if len(data) < _HEADER + 2 + 4:
        raise ValueError(f"{label}: truncated")
    found, length = struct.unpack(">I", data[:4])[0], struct.unpack("<Q", data[4:12])[0]
    if found != magic:
        raise ValueError(f"{label}: magic {found:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise ValueError(f"{label}: the header says {length} bytes, the file holds {len(data)}")
    if native.crc32c(memoryview(data)[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"{label}: CRC-32C mismatch")
    cur = _Cursor(data[:-4], label)
    cur.pos = _HEADER
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise ValueError(f"{label}: format version {version}, the reader knows 0")
    if compression == 0:
        return data[cur.pos:-4]
    if compression == 1:
        return bytes(native.zstd_decompress(memoryview(data)[cur.pos:-4]))
    raise ValueError(f"{label}: compression format {compression}, the reader knows 0 and 1 (zstd)")


def _frame(magic: int, body: bytes) -> bytes:
    """A manifest or node file of ``body``, zstd-compressed as tensorstore writes it."""
    payload = bytes(native.zstd_compress(body, _NODE_ZSTD_LEVEL))
    length = _HEADER + 2 + len(payload) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + _varint(0) + _varint(1)
    data = head + payload
    return data + struct.pack("<I", native.crc32c(data))


def _read_paths(cur: _Cursor, base: str) -> list[tuple[str, str]]:
    """A data-file table: each file's path and base path, both below
    ``base``, the base path of the file that holds the table."""
    n = cur.varint()
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix, base_lengths = cur.varints(n), cur.varints(n)
    paths, prev = [], b""
    for p, s, b in zip(prefix, suffix, base_lengths):
        prev = prev[:p] + cur.take(s)
        paths.append((base + prev.decode(), base + prev[:b].decode()))
    return paths


def _write_paths(paths: list[tuple[str, int]]) -> bytes:
    """A data-file table of (path, base_path_length), sorted."""
    raw = [p.encode() for p, _ in paths]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(raw, raw[1:])]
    return (_varint(len(raw)) + _varints(prefix)
            + _varints(len(r) - ([0] + prefix)[i] for i, r in enumerate(raw))
            + _varints(b for _, b in paths)
            + b"".join(r[([0] + prefix)[i]:] for i, r in enumerate(raw)))


def _read_keys(cur: _Cursor, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + cur.take(s)
        keys.append(prev)
    return keys, common


@dataclass(frozen=True)
class _Ref:
    """(data file, offset, length) of a node or an indirect value; ``base``
    is the file's base path, below which a node read from it finds its own
    data files."""
    path: str
    base: str
    offset: int
    length: int

    @classmethod
    def at(cls, file: tuple[str, str], offset: int, length: int) -> "_Ref":
        return cls(file[0], file[1], offset, length)


@dataclass(frozen=True)
class _Version:
    generation: int
    root_height: int
    root: _Ref | None  # None: the empty tree


_NULL = (1 << 64) - 1  # the offset and length of the empty tree's root


# ---------------------------------------------------------------- reading
class Database:
    """A read-only view of the OCDBT database in ``root`` at its newest
    version (or at ``generation``): ``keys()``, ``read(key)``."""

    def __init__(self, root: str | os.PathLike, generation: int | None = None):
        self.root = Path(root)
        label = str(self.root / MANIFEST)
        cur = _Cursor(_unframe((self.root / MANIFEST).read_bytes(), _MANIFEST_MAGIC, label), label)
        cur.take(16)  # the database's uuid
        kind = cur.varint()
        if kind != 0:
            raise ValueError(f"{label}: manifest_kind {kind} (numbered manifests); the "
                             f"reader knows 0, a single manifest, as orbax writes it")
        cur.varint()  # max_inline_value_bytes
        self.max_decoded_node_bytes = cur.varint()
        cur.u8()  # version_tree_arity_log2
        method = cur.varint()
        if method not in (0, 1):
            raise ValueError(f"{label}: compression method {method}; the reader knows "
                             f"0 and 1 (zstd)")
        if method == 1:
            cur.take(4)  # the zstd level, a little-endian i32
        paths = _read_paths(cur, "")
        self.versions = self._read_versions(cur, paths)
        n = cur.varint()  # references to version-tree nodes of older versions
        cur.varints(n)  # the newest generation under each
        refs = list(zip(cur.varints(n), cur.varints(n), cur.varints(n)))
        cur.varints(n)  # num_generations
        cur.take(8 * n)  # commit times
        cur.take(n)  # heights
        cur.end()
        if generation is not None and generation not in {v.generation for v in self.versions}:
            for file_id, offset, length in refs:
                self.versions += self._version_node(_Ref.at(paths[file_id], offset, length))
        found = [v for v in self.versions if generation in (None, v.generation)]
        if not found:
            raise KeyError(f"{self.root}: no generation {generation}")
        self.version = max(found, key=lambda v: v.generation)
        self._values: dict[bytes, bytes | _Ref] = {}
        if self.version.root is not None:
            self._walk(self.version.root, self.version.root_height, b"")

    @staticmethod
    def _read_versions(cur: _Cursor, paths: list[tuple[str, str]]) -> list[_Version]:
        n = cur.varint()
        gens, heights = cur.varints(n), list(cur.take(n))
        files, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
        cur.varints(n)  # num_keys
        cur.varints(n)  # num_tree_bytes
        cur.varints(n)  # num_indirect_value_bytes
        cur.take(8 * n)  # commit times, little-endian u64 ns
        return [_Version(g, h, None if o == _NULL else _Ref.at(paths[f], o, ln))
                for g, h, f, o, ln in zip(gens, heights, files, offsets, lengths)]

    def _version_node(self, ref: _Ref) -> list[_Version]:
        """Every version under a version-tree node."""
        label = f"{self.root / ref.path}@{ref.offset}"
        cur = _Cursor(_unframe(self._read(ref), _VERSION_MAGIC, label), label)
        cur.u8()  # version_tree_arity_log2
        height = cur.u8()
        paths = _read_paths(cur, ref.base)
        if height == 0:
            out = self._read_versions(cur, paths)
            cur.end()
            return out
        n = cur.varint()
        _gens, files, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n), \
            cur.varints(n)
        cur.varints(n)  # num_generations
        cur.take(8 * n)  # commit times
        cur.end()
        return [v for f, o, ln in zip(files, offsets, lengths)
                for v in self._version_node(_Ref.at(paths[f], o, ln))]

    def _read(self, ref: _Ref) -> bytes:
        with open(self.root / ref.path, "rb") as f:
            data = os.pread(f.fileno(), ref.length, ref.offset)
        if len(data) != ref.length:
            raise ValueError(f"{self.root / ref.path}: {ref.length} bytes at {ref.offset} "
                             f"past its end")
        return data

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        label = f"{self.root / ref.path}@{ref.offset}"
        body = _unframe(self._read(ref), _BTREE_MAGIC, label)
        if len(body) > self.max_decoded_node_bytes:
            raise ValueError(f"{label}: {len(body)} bytes decoded, over the configured "
                             f"{self.max_decoded_node_bytes}")
        cur = _Cursor(body, label)
        if cur.u8() != height:
            raise ValueError(f"{label}: a node of the wrong height")
        paths = _read_paths(cur, ref.base)
        n = cur.varint()
        keys, common = _read_keys(cur, n, interior=height > 0)
        if height > 0:
            files, offsets, lengths = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(n)  # num_keys
            cur.varints(n)  # num_tree_bytes
            cur.varints(n)  # num_indirect_value_bytes
            cur.end()
            for key, c, f, o, ln in zip(keys, common, files, offsets, lengths):
                self._walk(_Ref.at(paths[f], o, ln), height - 1, prefix + key[:c])
            return
        lengths, kinds = cur.varints(n), cur.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"{label}: a value kind other than inline (0) or indirect (1)")
        files, offsets = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = {i: _Ref.at(paths[f], o, lengths[i]) for i, f, o in zip(indirect, files, offsets)}
        for i, key in enumerate(keys):
            self._values[prefix + key] = refs[i] if i in refs else cur.take(lengths[i])
        cur.end()

    def keys(self) -> list[str]:
        """Every key, sorted."""
        return sorted(k.decode() for k in self._values)

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._values

    def read(self, key: str) -> bytes:
        value = self._values[key.encode()]
        return self._read(value) if isinstance(value, _Ref) else value


# ---------------------------------------------------------------- writing
def _config(uuid: bytes) -> bytes:
    return (uuid + _varint(0) + _varint(_MAX_INLINE_VALUE_BYTES) + _varint(_MAX_DECODED_NODE_BYTES)
            + bytes([_VERSION_TREE_ARITY_LOG2]) + _varint(1) + struct.pack("<i", _NODE_ZSTD_LEVEL))


def _leaf(items: list[tuple[bytes, memoryview]], table: bytes, offsets: list[int | None]) -> bytes:
    """A leaf node's body: keys sorted, values inline where ``offsets`` is
    None, else indirect in data file 0 of ``table``."""
    keys = [k for k, _ in items]
    prefix = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    starts = [0] + prefix
    indirect = [o for o in offsets if o is not None]
    return (bytes([0]) + table + _varint(len(keys)) + _varints(prefix)
            + _varints(len(k) - s for k, s in zip(keys, starts))
            + b"".join(k[s:] for k, s in zip(keys, starts))
            + _varints(len(v) for _, v in items)
            + _varints(0 if o is None else 1 for o in offsets)
            + _varints(0 for _ in indirect) + _varints(indirect)
            + b"".join(bytes(v) for (_, v), o in zip(items, offsets) if o is None))


def _manifest(path: str, offset: int, length: int, num_keys: int, indirect_bytes: int,
              commit_ns: int) -> bytes:
    body = (_config(secrets.token_bytes(16)) + _write_paths([(path, 0)])
            + _varint(1) + _varint(1) + bytes([0]) + _varint(0) + _varint(offset)
            + _varint(length) + _varint(num_keys) + _varint(length) + _varint(indirect_bytes)
            + struct.pack("<Q", commit_ns) + _varint(0))
    return _frame(_MANIFEST_MAGIC, body)


def write_database(root: str | os.PathLike, items: Iterable[tuple[str, object]]) -> None:
    """Write ``items`` ((key, bytes-like value)) as a new database in
    ``root`` with one version, the layout of one orbax process: the values
    over 1024 bytes and the leaf that holds the rest, in one
    data file of ``ocdbt.process_0/`` with its own manifest, and the
    directory's own manifest and leaf pointing into that file."""
    root = Path(root)
    items = sorted((k.encode(), memoryview(v).cast("B")) for k, v in items)
    if len({k for k, _ in items}) != len(items):
        raise ValueError("write_database: a key given twice")
    name = f"d/{secrets.token_hex(16)}"
    offsets, pos = [], 0
    for _, v in items:
        offsets.append(pos if len(v) > _MAX_INLINE_VALUE_BYTES else None)
        pos += len(v) if len(v) > _MAX_INLINE_VALUE_BYTES else 0
    commit_ns = time.time_ns()

    process = root / PROCESS_DIR
    (process / "d").mkdir(parents=True, exist_ok=True)
    node = _frame(_BTREE_MAGIC, _leaf(items, _write_paths([(name, 0)]), offsets))
    with open(process / name, "wb") as f:
        for (_, v), o in zip(items, offsets):
            if o is not None:
                f.write(v)
        f.write(node)
    (process / MANIFEST).write_bytes(_manifest(name, pos, len(node), len(items), pos, commit_ns))

    (root / "d").mkdir(exist_ok=True)
    merged = f"{PROCESS_DIR}/{name}"
    top = _frame(_BTREE_MAGIC, _leaf(items, _write_paths([(merged, len(PROCESS_DIR) + 1)]),
                                     offsets))
    top_name = f"d/{secrets.token_hex(16)}"
    (root / top_name).write_bytes(top)
    (root / MANIFEST).write_bytes(_manifest(top_name, 0, len(top), len(items), pos, commit_ns))
